"""Code store: fixed-record binary file of (top, bottom, label, name) rows —
the bridge from stage 1 (code extraction) to stage 2 (the priors).  Own copy
of ``vqvae2_tpu/data/codestore.py`` with the same on-disk format, so a file
written by either package is read by the other.

Two backends, one on-disk format:

* **native** (``use_native=True``) — the port's own C++ source,
  ``data/csrc/codestore.cpp``: mmap'd reads and a thread-parallel batch
  gather, built with ``g++`` at first use into ``data/_built/`` (git ignores
  it; the file name carries a hash of the source and the flags) and bound via
  ctypes.  A failed build or load raises.
* **numpy** (``use_native=False``) — a structured-dtype ``np.memmap`` with
  identical layout.

Header (56 B): ``8s magic 'VQ2CODES' | i64 version | i64 count | i64 top_h |
i64 top_w | i64 bot_h | i64 bot_w``; then ``count`` packed records of
``int16[top] int16[bottom] int32 label char[64] name``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

MAGIC = b"VQ2CODES"
HEADER = struct.Struct("<8sqqqqqq")  # 56 bytes
NAME_LEN = 64

_DATA_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DATA_DIR, "csrc", "codestore.cpp")
BUILD_DIR = os.path.join(_DATA_DIR, "_built")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the native library of this source and these flags lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + "\0".join(CXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libcodestore_{digest[:16]}.so")


def build() -> str:
    """Compile ``csrc/codestore.cpp`` with ``g++`` unless its library is
    already there; returns the library's path.  Raises if there is no
    compiler or the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH to build the native code store")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the native code store failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent process sees all or nothing
    return out


def _load_native() -> ctypes.CDLL:
    """The native library, built at first use; raises if it cannot be built
    or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.cs_create.restype = ctypes.c_void_p
    lib.cs_create.argtypes = [ctypes.c_char_p] + [ctypes.c_int64] * 4
    lib.cs_append.restype = ctypes.c_int64
    lib.cs_append.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]
    lib.cs_finalize.restype = ctypes.c_int64
    lib.cs_finalize.argtypes = [ctypes.c_void_p]
    lib.cs_open.restype = ctypes.c_void_p
    lib.cs_open.argtypes = [ctypes.c_char_p]
    lib.cs_count.restype = ctypes.c_int64
    lib.cs_count.argtypes = [ctypes.c_void_p]
    lib.cs_shape.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cs_gather.restype = ctypes.c_int64
    lib.cs_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int64]
    lib.cs_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _record_dtype(top_shape, bot_shape) -> np.dtype:
    return np.dtype([
        ("top", "<i2", (int(np.prod(top_shape)),)),
        ("bottom", "<i2", (int(np.prod(bot_shape)),)),
        ("label", "<i4"),
        ("name", f"S{NAME_LEN}"),
    ])


class CodeStoreWriter:
    """Append-only writer."""

    def __init__(self, path: str, top_shape: Tuple[int, int],
                 bot_shape: Tuple[int, int], use_native: bool = True):
        self.path = path
        self.top_shape, self.bot_shape = tuple(top_shape), tuple(bot_shape)
        self._count = 0
        self._lib = _load_native() if use_native else None
        if self._lib is not None:
            self._h = self._lib.cs_create(
                path.encode(), top_shape[0], top_shape[1],
                bot_shape[0], bot_shape[1])
            if not self._h:
                raise OSError(f"cs_create failed for {path}")
        else:
            self._f = open(path, "wb")
            self._f.write(HEADER.pack(MAGIC, 1, 0, top_shape[0], top_shape[1],
                                      bot_shape[0], bot_shape[1]))

    def append(self, tops: np.ndarray, bottoms: np.ndarray,
               labels: np.ndarray, names: Sequence[str]) -> int:
        n = len(tops)
        tops = np.ascontiguousarray(tops, np.int16).reshape(n, -1)
        bottoms = np.ascontiguousarray(bottoms, np.int16).reshape(n, -1)
        labels = np.ascontiguousarray(labels, np.int32).reshape(n)
        name_arr = np.zeros((n,), f"S{NAME_LEN}")
        for i, s in enumerate(names):
            name_arr[i] = s.encode()[: NAME_LEN - 1]
        if self._lib is not None:
            self._count = self._lib.cs_append(
                self._h, n,
                tops.ctypes.data_as(ctypes.c_void_p),
                bottoms.ctypes.data_as(ctypes.c_void_p),
                labels.ctypes.data_as(ctypes.c_void_p),
                name_arr.ctypes.data_as(ctypes.c_void_p))
        else:
            rec = np.empty((n,), _record_dtype(self.top_shape, self.bot_shape))
            rec["top"], rec["bottom"] = tops, bottoms
            rec["label"], rec["name"] = labels, name_arr
            rec.tofile(self._f)
            self._count += n
        return self._count

    def close(self) -> int:
        if self._lib is not None:
            count = self._lib.cs_finalize(self._h)
            self._h = None
        else:
            self._f.seek(0)
            self._f.write(HEADER.pack(MAGIC, 1, self._count,
                                      self.top_shape[0], self.top_shape[1],
                                      self.bot_shape[0], self.bot_shape[1]))
            self._f.close()
            count = self._count
        return count

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class CodeStore:
    """Random-access reader.

    ``store[i]`` → ``(top (Ht,Wt) int16, bottom (Hb,Wb) int16, label, name)``;
    ``store.gather(indices)`` → batched arrays (native thread-parallel path).
    """

    def __init__(self, path: str, use_native: bool = True):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "rb") as f:
            magic, version, count, th, tw, bh, bw = HEADER.unpack(
                f.read(HEADER.size))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a VQ2CODES store")
        self.count = count
        self.top_shape, self.bot_shape = (th, tw), (bh, bw)
        self._lib = _load_native() if use_native else None
        if self._lib is not None:
            self._h = self._lib.cs_open(path.encode())
            if not self._h:
                raise OSError(f"cs_open failed for {path}")
            self.backend = "native"
        else:
            self._mm = np.memmap(path, _record_dtype(self.top_shape, self.bot_shape),
                                 mode="r", offset=HEADER.size, shape=(count,))
            self.backend = "numpy"

    def __len__(self) -> int:
        return self.count

    def gather(self, indices: np.ndarray, with_names: bool = False,
               n_threads: int = 8):
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        th, tw = self.top_shape
        bh, bw = self.bot_shape
        if self._lib is not None:
            tops = np.empty((n, th * tw), np.int16)
            bots = np.empty((n, bh * bw), np.int16)
            labels = np.empty((n,), np.int32)
            names = np.zeros((n,), f"S{NAME_LEN}") if with_names else None
            self._lib.cs_gather(
                self._h, indices.ctypes.data_as(ctypes.c_void_p), n,
                tops.ctypes.data_as(ctypes.c_void_p),
                bots.ctypes.data_as(ctypes.c_void_p),
                labels.ctypes.data_as(ctypes.c_void_p),
                names.ctypes.data_as(ctypes.c_void_p) if with_names else None,
                n_threads)
        else:
            rec = self._mm[indices]
            tops, bots = rec["top"].copy(), rec["bottom"].copy()
            labels = rec["label"].copy()
            names = rec["name"].copy() if with_names else None
        out = (tops.reshape(n, th, tw), bots.reshape(n, bh, bw), labels)
        if with_names:
            out = out + ([x.decode(errors="replace").rstrip("\x00") for x in names],)
        return out

    def __getitem__(self, i: int):
        t, b, l, names = self.gather(np.asarray([i]), with_names=True)
        return t[0], b[0], int(l[0]), names[0]

    def close(self):
        if self._lib is not None and self._h:
            self._lib.cs_close(self._h)
            self._h = None
