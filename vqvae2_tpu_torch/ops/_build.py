"""Build-at-first-use for the CUDA sources under ``ops/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  :func:`load_library` compiles
it with ``nvcc`` for ``sm_90a`` into a shared library under ``ops/_built/`` (a
directory git ignores) and loads it with :mod:`ctypes`.  The file name carries
a hash of the source and the flags, so an edit rebuilds and an unchanged source
is compiled once per checkout.  Nothing is built when the package is imported:
the first launch of a kernel builds its library.  A failed build raises.

It also holds the operand layout every kernel of ``csrc`` takes
(:func:`kernel_operands`, :func:`unpad`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_OPS_DIR, "csrc")
BUILD_DIR = os.path.join(_OPS_DIR, "_built")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: Dict[str, ctypes.CDLL] = {}
# name -> {"path", "seconds" (0.0 when the library was already there), "log"}
build_info: Dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises if there is none."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of vqvae2_tpu_torch cannot be built here")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def build(name: str, nvcc: Optional[str] = None) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already there; returns
    the library's path."""
    out = _library_path(name)
    if os.path.exists(out):
        build_info.setdefault(name, {"path": out, "seconds": 0.0, "log": ""})
        return out
    nvcc = nvcc or find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent process sees all or nothing
    build_info[name] = {"path": out, "seconds": seconds, "log": log}
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use."""
    lib = _libraries.get(name)
    if lib is None:
        lib = _libraries[name] = ctypes.CDLL(build(name))
    return lib


def kernel_operands(*tensors: torch.Tensor) -> List[torch.Tensor]:
    """The operands as the kernels take them: contiguous, on a 16-byte
    boundary, with the last (feature) axis zero-padded to a multiple of 4
    (16-byte loads); all of them share the first one's width.  The pad changes
    no dot product, norm or score: each is an fp32 FMA chain over the features
    in order, and an FMA of ``0 * 0`` onto ``s`` gives ``s`` bit for bit.  The
    padded columns of the outputs are sliced off by :func:`unpad`.  Inputs
    that need none of this pass without a copy."""
    pad = -tensors[0].shape[-1] % 4
    out = []
    for t in tensors:
        if pad:
            t = F.pad(t, (0, pad))
        elif not t.is_contiguous() or t.data_ptr() % 16:
            t = t.clone(memory_format=torch.contiguous_format)
        out.append(t)
    return out


def unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    """The first ``d`` feature columns of a kernel output, contiguous."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()
