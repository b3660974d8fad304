"""Detection workloads (port of ``vqvae2_tpu/detection``): the SSD300 and
Mask R-CNN models, their box machinery, COCO-format data and evaluation, and
drawing."""
