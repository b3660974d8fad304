"""COCO-format detection data (port of ``vqvae2_tpu/detection/data.py``,
numpy and PIL only; every array is bit-equal to the JAX package's): reads a
COCO annotation json and yields fixed-shape padded (image, boxes, labels
[, masks]) batches, degenerate boxes dropped; :func:`make_synthetic_coco`
writes a small seeded set."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class CocoDetectionDataset:
    """Minimal COCO-bbox dataset: (img NHWC float, boxes (M,4) ltrb
    normalized, labels (M,)) with padding to ``max_boxes``."""

    def __init__(self, img_dir: str, ann_file: str, size: int = 300,
                 max_boxes: int = 64, with_masks: bool = False):
        self.img_dir = img_dir
        self.size = size
        self.max_boxes = max_boxes
        self.with_masks = with_masks
        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_img: Dict[int, List] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            self.anns_by_img.setdefault(a["image_id"], []).append(a)
        self.ids = sorted(self.images.keys())
        cats = sorted({c["id"] for c in coco.get("categories", [])})
        # contiguous labels, 0 reserved for background
        self.cat_to_label = {c: i + 1 for i, c in enumerate(cats)}
        self.num_classes = len(cats) + 1
        names = {c["id"]: c.get("name", str(c["id"]))
                 for c in coco.get("categories", [])}
        self.class_names = {self.cat_to_label[c]: names[c] for c in cats}

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int):
        from PIL import Image

        img_id = self.ids[i]
        info = self.images[img_id]
        path = os.path.join(self.img_dir, info["file_name"])
        img = Image.open(path).convert("RGB").resize((self.size, self.size))
        arr = np.asarray(img, np.float32) / 127.5 - 1.0

        w0, h0 = info.get("width", self.size), info.get("height", self.size)
        boxes, labels = [], []
        for a in self.anns_by_img.get(img_id, []):
            x, y, bw, bh = a["bbox"]
            # drop degenerate boxes (reference fashionSSD.py:53-58)
            if bw <= 1 or bh <= 1:
                continue
            boxes.append([x / w0, y / h0, (x + bw) / w0, (y + bh) / h0])
            labels.append(self.cat_to_label[a["category_id"]])

        out_boxes = np.zeros((self.max_boxes, 4), np.float32)
        out_labels = np.zeros((self.max_boxes,), np.int32)
        m = min(len(boxes), self.max_boxes)
        if m:
            out_boxes[:m] = np.clip(np.asarray(boxes[:m], np.float32), 0, 1)
            out_labels[:m] = labels[:m]
        if not self.with_masks:
            return arr, out_boxes, out_labels, img_id

        # rasterize segmentation polygons (reference fashion.py:30-61 builds
        # mask targets from COCO annotations) at the model resolution
        from PIL import Image as PImage, ImageDraw

        out_masks = np.zeros((self.max_boxes, self.size, self.size), np.uint8)
        mi = 0
        for a in self.anns_by_img.get(img_id, []):
            x, y, bw, bh = a["bbox"]
            if bw <= 1 or bh <= 1 or mi >= self.max_boxes:
                continue
            seg = a.get("segmentation")
            canvas = PImage.new("L", (self.size, self.size), 0)
            draw = ImageDraw.Draw(canvas)
            sx, sy = self.size / w0, self.size / h0
            if isinstance(seg, list) and seg:
                for poly in seg:
                    pts = [(poly[i] * sx, poly[i + 1] * sy)
                           for i in range(0, len(poly) - 1, 2)]
                    if len(pts) >= 3:
                        draw.polygon(pts, fill=1)
            else:  # no polygon: fall back to the box as the mask
                draw.rectangle([x * sx, y * sy, (x + bw) * sx, (y + bh) * sy],
                               fill=1)
            out_masks[mi] = np.asarray(canvas, np.uint8)
            mi += 1
        return arr, out_boxes, out_labels, img_id, out_masks

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, with_masks: bool = False) -> Iterator:
        order = (np.random.default_rng(seed).permutation(len(self))
                 if shuffle else np.arange(len(self)))
        end = len(order) - (len(order) % batch_size if drop_last else 0)
        for s in range(0, end, batch_size):
            rows = [self[int(i)] for i in order[s: s + batch_size]]
            out = (np.stack([r[0] for r in rows]),
                   np.stack([r[1] for r in rows]),
                   np.stack([r[2] for r in rows]),
                   [r[3] for r in rows])
            if with_masks:
                assert self.with_masks, "dataset built without with_masks"
                out = out + (np.stack([r[4] for r in rows]),)
            yield out


def make_synthetic_coco(tmpdir: str, n: int = 16, size: int = 300,
                        n_classes: int = 13, seed: int = 0,
                        with_masks: bool = False) -> Tuple[str, str]:
    """Fabricate a tiny COCO-format dataset for smoke runs."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(tmpdir, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    aid = 0
    for i in range(n):
        name = f"{i:06d}.jpg"
        arr = rng.integers(0, 255, size=(size, size, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, name))
        images.append({"id": i, "file_name": name, "width": size,
                       "height": size})
        for _ in range(int(rng.integers(1, 4))):
            lo, hi = max(size // 10, 4), max(size * 2 // 5, 8)
            w, h = rng.integers(lo, hi, 2)
            x = int(rng.integers(0, size - w))
            y = int(rng.integers(0, size - h))
            ann = {
                "id": aid, "image_id": i, "bbox": [x, y, int(w), int(h)],
                "category_id": int(rng.integers(1, n_classes + 1)),
                "iscrowd": 0, "area": int(w * h),
            }
            if with_masks:  # box-shaped polygon
                ann["segmentation"] = [[x, y, x + int(w), y,
                                        x + int(w), y + int(h), x, y + int(h)]]
            annotations.append(ann)
            aid += 1
    ann = {
        "images": images, "annotations": annotations,
        "categories": [{"id": c, "name": f"c{c}"}
                       for c in range(1, n_classes + 1)],
    }
    ann_file = os.path.join(tmpdir, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return img_dir, ann_file
