"""Weights and state carried across from the JAX package, and to and from the
original PyTorch reference's ``state_dict`` layout.  The inverse of
``vqvae2_tpu/utils/torch_import.py``; all layout maps of the port live here.

* flax ``Conv`` kernel ``(kH, kW, I, O)``          → ``Conv2d`` ``(O, I, kH, kW)``
* flax ``ConvTranspose`` kernel ``(kH, kW, I, O)`` → ``ConvTranspose2d``
  ``(I, O, kH, kW)``, **spatially flipped** (flax's transposed convolution
  correlates with the flipped kernel relative to PyTorch's)
* codebook buffers ``embed`` / ``embed_avg`` stay ``(K, D)``; ``cluster_size``
  as is.  The original reference stores the first two as ``(D, K)``:
  :func:`to_reference_state_dict` / :func:`from_reference_state_dict` transpose.
* flax auto-names (``Conv_k``, ``ResBlock_k``, ``ConvTranspose_k``; call order
  is all ``Conv_k``, then the ``ResBlock_k``, then the ``ConvTranspose_k``) map
  onto the indices of the port's ``blocks`` Sequential, which are the
  reference's.

Inputs are nested dicts of **numpy** arrays (the caller does the
``np.asarray``); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_QUANTIZERS = ("quantize_t", "quantize_b")
_TRANSPOSED_IN_REFERENCE = ("embed", "embed_avg")


def conv_weight(kernel: np.ndarray) -> torch.Tensor:
    """flax ``Conv`` kernel → ``Conv2d`` weight."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1)))


def conv_transpose_weight(kernel: np.ndarray) -> torch.Tensor:
    """flax ``ConvTranspose`` kernel → ``ConvTranspose2d`` weight."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1)))


def _array(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _numbered(params: Mapping[str, Any], prefix: str):
    keys = [k for k in params if k.startswith(prefix + "_")]
    return sorted(keys, key=lambda s: int(s.rsplit("_", 1)[1]))


def _put_conv(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any],
              transposed: bool = False) -> None:
    out[f"{name}.weight"] = (conv_transpose_weight if transposed else conv_weight)(p["kernel"])
    out[f"{name}.bias"] = _array(p["bias"])


def _put_resblock(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    _put_conv(out, f"{name}.conv.1", p["Conv_0"])   # 3x3
    _put_conv(out, f"{name}.conv.3", p["Conv_1"])   # 1x1


def _put_encoder(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    """``blocks`` = conv, ReLU, conv[, ReLU, conv], ResBlocks..., ReLU."""
    convs = _numbered(p, "Conv")
    for i, key in enumerate(convs):
        _put_conv(out, f"{name}.blocks.{2 * i}", p[key])
    first_res = 2 * len(convs) - 1
    for j, key in enumerate(_numbered(p, "ResBlock")):
        _put_resblock(out, f"{name}.blocks.{first_res + j}", p[key])


def _put_decoder(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    """``blocks`` = conv, ResBlocks..., ReLU, tconv[, ReLU, tconv]."""
    _put_conv(out, f"{name}.blocks.0", p["Conv_0"])
    res = _numbered(p, "ResBlock")
    for j, key in enumerate(res):
        _put_resblock(out, f"{name}.blocks.{1 + j}", p[key])
    for t, key in enumerate(_numbered(p, "ConvTranspose")):
        _put_conv(out, f"{name}.blocks.{2 + len(res) + 2 * t}", p[key], transposed=True)


def vqvae_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's VQVAE ``{"params": ..., "vq_stats": ...}`` (nested
    dicts of numpy arrays) as a ``state_dict`` of the port's ``VQVAE``."""
    params, stats = variables["params"], variables["vq_stats"]
    out: Dict[str, torch.Tensor] = {}
    _put_encoder(out, "enc_b", params["enc_b"])
    _put_encoder(out, "enc_t", params["enc_t"])
    _put_conv(out, "quantize_conv_t", params["quantize_conv_t"])
    _put_decoder(out, "dec_t", params["dec_t"])
    _put_conv(out, "quantize_conv_b", params["quantize_conv_b"])
    _put_conv(out, "upsample_t", params["upsample_t"], transposed=True)
    _put_decoder(out, "dec", params["dec"])
    if "dec_ir" in params:
        _put_decoder(out, "dec_ir", params["dec_ir"])
    for q in _QUANTIZERS:
        for buf in ("embed", "cluster_size", "embed_avg"):
            out[f"{q}.{buf}"] = _array(stats[q][buf])
    return out


def _transpose_codebooks(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(state_dict)
    for q in _QUANTIZERS:
        for buf in _TRANSPOSED_IN_REFERENCE:
            out[f"{q}.{buf}"] = out[f"{q}.{buf}"].t().contiguous()
    return out


def to_reference_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` in the original reference's layout: same keys
    (the port names its parameters as the reference does), codebooks ``(D, K)``."""
    return _transpose_codebooks(state_dict)


def from_reference_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference-format ``state_dict`` (codebooks ``(D, K)``; ``upsample_t``
    possibly wrapped in a Sequential as ``upsample_t.0``) as the port's."""
    renamed = {}
    for key, value in state_dict.items():
        if key.startswith("upsample_t.0."):
            key = "upsample_t." + key[len("upsample_t.0."):]
        renamed[key] = torch.as_tensor(value)
    return _transpose_codebooks(renamed)
