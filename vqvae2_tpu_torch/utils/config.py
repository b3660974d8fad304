"""Typed configuration presets (port of ``vqvae2_tpu/utils/config.py``).
Each preset is a frozen dataclass whose fields mirror the port's trainer of
that name, with the JAX package's fields and defaults and ``device``
(``"cuda"``).  ``to_args(parser)`` gives the argparse Namespace the trainer
takes, the flags a preset does not carry at the parser's defaults:

    from vqvae2_tpu_torch.utils.config import VQVAEConfig
    from vqvae2_tpu_torch.train import vqvae
    vqvae.train(VQVAEConfig(path="/data/ffhq").to_args(vqvae.build_argparser()))
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional


class _Base:
    def to_args(self, parser: Optional[argparse.ArgumentParser] = None) -> argparse.Namespace:
        """The preset's fields as a Namespace; with ``parser``, on top of the
        parser's defaults for every flag the preset does not carry."""
        base = {} if parser is None else {
            a.dest: a.default for a in parser._actions if a.dest != "help"}
        return argparse.Namespace(**{**base, **dataclasses.asdict(self)})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class VQVAEConfig(_Base):
    """Stage-1 trainer (``train/vqvae.py``)."""

    path: str = ""
    size: int = 256
    epoch: int = 560
    steps: int = 0
    lr: float = 3e-4
    batch_size: int = 128
    sched: str = "cycle"
    channel: int = 128
    n_res_block: int = 2
    n_res_channel: int = 32
    embed_dim: int = 64
    n_embed: int = 512
    seed: int = 0
    synthetic: bool = False
    ckpt_dir: str = "checkpoint/vqvae"
    sample_dir: str = "sample"
    sample_every: int = 100
    log_every: int = 10
    device: str = "cuda"


@dataclass(frozen=True)
class PixelSnailConfig(_Base):
    """Stage-2 prior trainer (``train/pixelsnail.py``)."""

    path: str = "codes.vq2"
    batch: int = 32
    epoch: int = 420
    steps: int = 0
    hier: str = "top"
    lr: float = 3e-4
    n_class: int = 512
    channel: int = 256
    n_res_block: int = 4
    n_res_channel: int = 256
    n_out_res_block: int = 0
    n_cond_res_block: int = 3
    dropout: float = 0.1
    sched: str = "cycle"
    ckpt_dir: str = ""
    resume: bool = False
    seed: int = 0
    log_every: int = 10
    device: str = "cuda"


@dataclass(frozen=True)
class ReidConfig(_Base):
    """ReID + parsing trainer (``train/reid.py``)."""

    path: str = ""
    epoch: int = 200
    steps: int = 0
    batch_size: int = 6
    num_pos: int = 4
    lr_F: float = 0.1
    arch: str = "resnet50"
    seed: int = 0
    synthetic: bool = False
    ckpt_dir: str = ""
    img_h: int = 288
    img_w: int = 144
    log_every: int = 10
    device: str = "cuda"


@dataclass(frozen=True)
class DetectionConfig(_Base):
    """SSD detection trainer (``train/detection.py``)."""

    img_dir: str = ""
    ann_file: str = ""
    size: int = 300
    epoch: int = 26
    steps: int = 0
    batch_size: int = 8
    lr: float = 0.002
    arch: str = "resnet18"
    seed: int = 0
    synthetic: bool = False
    eval: bool = True
    log_every: int = 10
    device: str = "cuda"


PRESETS: Dict[str, Any] = {
    "vqvae_ffhq_256": VQVAEConfig(),
    "pixelsnail_top": PixelSnailConfig(hier="top"),
    "pixelsnail_bottom": PixelSnailConfig(hier="bottom"),
    "reid_sysu": ReidConfig(),
    "ssd_modanet": DetectionConfig(),
}
