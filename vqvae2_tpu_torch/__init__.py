"""vqvae2_tpu_torch — the PyTorch / CUDA port of :mod:`vqvae2_tpu`, for one
NVIDIA Hopper card.

Same sub-packages and module names as the JAX package, so a reader finds the
counterpart of each file:

- :mod:`vqvae2_tpu_torch.ops`    — hand-written CUDA kernels (built at first
  use, see ``ops/_build.py``), each beside its plain PyTorch version
- :mod:`vqvae2_tpu_torch.models` — ``nn.Module`` model zoo, ``(B, H, W, C)``
  at every public function like the JAX package
- :mod:`vqvae2_tpu_torch.data`   — datasets and the code store
- :mod:`vqvae2_tpu_torch.train`  — entry points
- :mod:`vqvae2_tpu_torch.utils`  — checkpoints, import of JAX weights

The package imports ``torch`` and numpy only.  Importing it compiles nothing.
Every entry point takes a ``device`` and defaults to ``"cuda"``: it raises when
that device is absent and uses the CPU only when the caller asks for it.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises ``RuntimeError`` when a CUDA device is asked for (the default) and
    none is present: nothing carries on on the CPU unless the caller said
    ``device="cpu"``.  Under a process group a bare ``cuda`` is the rank's own
    card, ``cuda:LOCAL_RANK`` (``parallel.get_local_rank``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from vqvae2_tpu_torch import parallel

        if dev.index is None and parallel.is_initialized():
            dev = torch.device("cuda", parallel.get_local_rank())
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' (--device cpu) to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} was requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present")
    return dev


def set_reference_precision() -> dict:
    """Make fp32 on the card mean fp32, and make it repeatable, as the JAX
    package computes it.

    * cuDNN runs fp32 convolutions in TF32 by default, which moves encoder
      outputs by about 1e-3 and flips code ids; matmuls are switched too so the
      plain versions of the kernels stay true fp32.
    * cuDNN's default transposed-convolution algorithm sums with atomics: from
      one call to the next the bottom quantizer's input moves by a few 1e-8 and
      a few of a batch's code ids flip at near-ties.  Extraction must write the
      same codes every time, so cuDNN is held to its deterministic algorithms.

    Returns the three flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}
