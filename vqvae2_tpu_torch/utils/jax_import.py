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

* ``EmbedNet2`` and the modules of the ReID path: :func:`embed_net2_from_jax`
  (flax ``BatchNorm`` ``scale``/``mean``/``var`` -> ``weight``/``running_mean``/
  ``running_var``, Dense ``(I, O)`` -> ``(O, I)``, list-like flax names such as
  ``layer2_0`` -> ``layer2.0``).

* ``PixelSNAIL``: a ``WNConv``'s ``v (kh, kw, I, O)`` → ``(O, I, kh, kw)``; a
  ``WNDense``'s ``v`` stays ``(I, O)`` (the port applies it as ``x @ w``); ``g``
  and ``b`` as they are.  flax wraps a causal convolution's parameters in
  ``WNConv_0``, which the port (``CausalConv`` is a ``WNConv``) does not; flax's
  ``blocks_{b}``, ``res{r}`` and ``out_res_{i}`` are the port's
  ``blocks.{b}``, ``res.{r}`` and ``out_res.{i}``.

* The adaptation models (``EmbedNet``, ``VQVAE_Deep``, ``ModelAdaptive*``):
  :func:`embed_net_from_jax`, :func:`vqvae_deep_from_jax` and
  :func:`adaptive_from_jax`.  A spectral-norm convolution's kernel is in
  ``params`` under ``Conv_0`` (``ConvTranspose_0``), its ``u`` and ``sigma`` in
  ``batch_stats`` under ``SpectralNorm_0`` with the keys ``"Conv_0/kernel/u"``
  and ``"Conv_0/kernel/sigma"``: the port's ``weight``, ``bias``, ``u`` and
  ``sigma``.  ``InstanceNorm``'s ``scale`` is ``weight``; an MLP's
  ``MLP_0/LinearBlock_k/Dense_0`` is ``mlp.blocks.k.dense``.  A reference
  ``VQVAE_Deep`` ``state_dict`` loads through
  :func:`from_reference_deep_state_dict`.

* StarGAN v2 (``ModelStarGAN`` and its modules): :func:`stargan_from_jax`.

* The detection models: :func:`ssd_from_jax` (``SSD300``; an extra block's
  ``Conv_0``/``BatchNorm_0``/``Conv_1``/``BatchNorm_1`` are ``conv1``/``bn1``/
  ``conv2``/``bn2``, ``loc3`` is ``loc.3``) and :func:`maskrcnn_from_jax`
  (``MaskRCNN``; the box head's ``Dense_0``/``Dense_1`` are ``fc0``/``fc1``);
  the ResNet parts as in :func:`embed_net2_from_jax`.

* A reference ``PixelSNAIL`` ``state_dict`` (weight norm's ``weight_v`` /
  ``weight_g``, the causal and gated wrappers' ``.conv`` levels):
  :func:`to_reference_pixelsnail_state_dict` and
  :func:`from_reference_pixelsnail_state_dict`.

Inputs are nested dicts of **numpy** arrays (the caller does the
``np.asarray``); nothing here imports JAX.
"""

from __future__ import annotations

import re
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
    if "bias" in p:
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
    dicts of numpy arrays) as a ``state_dict`` of the port's ``VQVAE``.
    Without ``vq_stats`` (a tree of the parameters alone, an optimizer's
    moments) the codebook buffers are left out."""
    params, stats = variables["params"], variables.get("vq_stats", {})
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
    for q in filter(stats.__contains__, _QUANTIZERS):
        for buf in ("embed", "cluster_size", "embed_avg"):
            out[f"{q}.{buf}"] = _array(stats[q][buf])
    return out


def _put_wn(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any],
            dense: bool = False) -> None:
    """A weight-normalised layer's ``v``, ``g`` and (where it has one) ``b``."""
    p = p.get("WNConv_0", p)
    out[f"{name}.v"] = _array(p["v"]) if dense else conv_weight(p["v"])
    out[f"{name}.g"] = _array(p["g"])
    if "b" in p:
        out[f"{name}.b"] = _array(p["b"])


def _put_gated_res(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    for conv in ("conv1", "conv2", "aux_conv", "condition"):
        if conv in p:
            _put_wn(out, f"{name}.{conv}", p[conv])


def pixelsnail_from_jax(variables: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """The JAX package's PixelSNAIL ``{"params": ...}`` (nested dicts of numpy
    arrays) as a ``state_dict`` of ``model``, the port's ``PixelSNAIL`` of the
    same configuration (it says how many blocks to walk)."""
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    _put_wn(out, "horizontal", params["horizontal"])
    _put_wn(out, "vertical", params["vertical"])
    for b in range(model.n_block):
        bp, name = params[f"blocks_{b}"], f"blocks.{b}"
        for r in range(model.n_res_block):
            _put_gated_res(out, f"{name}.res.{r}", bp[f"res{r}"])
        if model.attention:
            for rb in ("key_resblock", "query_resblock", "out_resblock"):
                _put_gated_res(out, f"{name}.{rb}", bp[rb])
            for dense in ("query", "key", "value"):
                _put_wn(out, f"{name}.causal_attention.{dense}",
                        bp["causal_attention"][dense], dense=True)
        else:
            _put_wn(out, f"{name}.out", bp["out"])
    for i in range(model.n_out_res_block):
        _put_gated_res(out, f"out_res.{i}", params[f"out_res_{i}"])
    if model.cond_resnet is not None:
        cp = params["cond_resnet"]
        _put_wn(out, "cond_resnet.conv_in", cp["conv_in"])
        for i in range(len(model.cond_resnet.res)):
            _put_gated_res(out, f"cond_resnet.res.{i}", cp[f"res{i}"])
    _put_wn(out, "out_conv", params["out_conv"])
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


# ---------------------------------------------------------------------------
# The ReID + parsing path (EmbedNet2, its stems, trunk and parsing head)
# ---------------------------------------------------------------------------

# flax module names whose port counterpart sits in a list or under another name
_REID_RENAMES = (
    (re.compile(r"^(layer[1-4])_(\d+)$"), r"\1.\2"),          # ResNet blocks
    (re.compile(r"^(NL[23])_(\d+)$"), r"\1.\2"),              # non-local blocks of the trunk
    (re.compile(r"^stage(\d+)$"), r"stages.\1"),             # PSP stages
    (re.compile(r"^pd(\d+)_(\d+)$"), r"pd.\1.\2"),           # part descriptors
    (re.compile(r"^clsP(\d+)_(bn|fc)$"), r"clsP_\2.\1"),      # per-part classifiers
    (re.compile(r"^ds_conv$"), "downsample.0"),
    (re.compile(r"^ds_bn$"), "downsample.1"),
    (re.compile(r"^Conv_0$"), "conv"),                        # inside a ConvABN
    (re.compile(r"^InPlaceABN_0$"), "abn"),
)
_REID_LEAVES = {"scale": "weight", "bias": "bias", "weight": "weight",
                "mean": "running_mean", "var": "running_var",
                "running_mean": "running_mean", "running_var": "running_var"}


def _reid_name(path) -> str:
    parts = []
    for name in path:
        for pattern, repl in _REID_RENAMES:
            if pattern.match(name):
                name = pattern.sub(repl, name)
                break
        parts.append(name)
    return ".".join(parts)


def _reid_leaf(name: str, value: np.ndarray) -> torch.Tensor:
    if name == "kernel":
        value = np.asarray(value)
        if value.ndim == 4:
            return conv_weight(value)                  # Conv (kH, kW, I, O) -> (O, I, kH, kW)
        return torch.from_numpy(np.ascontiguousarray(value.T))   # Dense (I, O) -> (O, I)
    return _array(value)


def _walk(tree: Mapping[str, Any], path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, path + (key,))
        else:
            yield path, key, value


def embed_net2_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EmbedNet2`` ``{"params": ..., "batch_stats": ...}``
    (nested dicts of numpy arrays) as a ``state_dict`` of the port's
    ``EmbedNet2``; also any module of its path on its own (``ResNetStem``,
    ``ResNetTrunk``, ``NLTrunk``, ``PartModel`` and its parts, ``InPlaceABN``).

    * Conv kernels ``(kH, kW, I, O)`` -> ``(O, I, kH, kW)``; Dense ``(I, O)`` -> ``(O, I)``
    * flax ``BatchNorm``: ``scale``, ``bias``, ``mean``, ``var`` -> ``weight``,
      ``bias``, ``running_mean``, ``running_var``; ``InPlaceABN`` keeps its names
    * ``layer2_0`` -> ``layer2.0``, ``ds_conv`` / ``ds_bn`` -> ``downsample.0`` /
      ``downsample.1`` (torchvision's names), ``NL3_1`` -> ``NL3.1``,
      ``stage2`` -> ``stages.2``, ``pd3_1`` -> ``pd.3.1``, ``clsP0_bn`` ->
      ``clsP_bn.0``, a ConvABN's ``Conv_0`` / ``InPlaceABN_0`` -> ``conv`` / ``abn``
    """
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf, value in _walk(variables.get(collection, {})):
            name = ".".join(filter(None, (_reid_name(path), _REID_LEAVES.get(leaf, "weight"))))
            out[name] = _reid_leaf(leaf, value)
    return out


# ``EmbedNet`` shares the ReID path's names; its part head's ``local_conv<i>``,
# ``local_bn<i>`` and ``fc<i>`` and its neck's ``bottleneck.bn`` keep theirs.
embed_net_from_jax = embed_net2_from_jax


# ---------------------------------------------------------------------------
# The adaptation models
# ---------------------------------------------------------------------------

def _stage_positions(sizes) -> tuple:
    """Indices in a Sequential of the layers of stages of ``sizes`` layers
    each, one ReLU between two layers of a stage and none between stages;
    and the index after the last stage."""
    positions, pos = [], 0
    for n in sizes:
        positions += [pos + 2 * j for j in range(n)]
        pos += 2 * n - 1
    return positions, pos


# number of convolutions (transposed convolutions) -> their stages, by stride
_ENCODER_STAGES = {2: (2,), 3: (3,), 5: (2, 3), 6: (3, 3)}
_DECODER_STAGES = {1: (1,), 2: (2,), 3: (2, 1), 4: (2, 2)}


def _put_dense(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel"]).T))
    if "bias" in p:
        out[f"{name}.bias"] = _array(p["bias"])


def _put_deep_encoder(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    convs = _numbered(p, "Conv")
    positions, first_res = _stage_positions(_ENCODER_STAGES[len(convs)])
    for pos, key in zip(positions, convs):
        _put_conv(out, f"{name}.blocks.{pos}", p[key])
    for j, key in enumerate(_numbered(p, "ResBlock")):
        _put_resblock(out, f"{name}.blocks.{first_res + j}", p[key])


def _put_deep_decoder(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    _put_conv(out, f"{name}.conv1", p["conv1"])
    for j, key in enumerate(_numbered(p, "ResBlock")):
        _put_resblock(out, f"{name}.blocks.{j}", p[key])
    j = 0
    while f"adain{j}" in p:
        a = p[f"adain{j}"]
        for conv in ("conv1", "conv2"):
            _put_conv(out, f"{name}.blocks.{j}.{conv}", a[conv])
        for norm in ("norm1", "norm2"):
            _put_dense(out, f"{name}.blocks.{j}.{norm}.fc", a[norm]["fc"])
        j += 1
    tconvs = _numbered(p, "ConvTranspose")
    positions, _ = _stage_positions(_DECODER_STAGES[len(tconvs)])
    for pos, key in zip(positions, tconvs):
        _put_conv(out, f"{name}.up_sample.{pos}", p[key], transposed=True)


def vqvae_deep_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``VQVAE_Deep`` ``{"params": ..., "vq_stats": ...}``
    as a ``state_dict`` of the port's: flax's ``Conv_k`` of an encoder onto
    the conv positions of its ``blocks`` (stride 6: ``0, 2, 3, 5, 7``, then
    the residual blocks), ``ConvTranspose_k`` onto those of ``up_sample``,
    ``adain<j>`` onto ``blocks.<j>``.  Without ``vq_stats`` the codebook
    buffers are left out."""
    params, stats = variables["params"], variables.get("vq_stats", {})
    out: Dict[str, torch.Tensor] = {}
    _put_deep_encoder(out, "enc_b", params["enc_b"])
    _put_deep_encoder(out, "enc_t", params["enc_t"])
    _put_deep_decoder(out, "dec_t", params["dec_t"])
    _put_deep_decoder(out, "dec", params["dec"])
    for conv in ("quantize_conv_t", "quantize_conv_b"):
        _put_conv(out, conv, params[conv])
    _put_conv(out, "upsample_t", params["upsample_t"], transposed=True)
    for q in filter(stats.__contains__, _QUANTIZERS):
        for buf in ("embed", "cluster_size", "embed_avg"):
            out[f"{q}.{buf}"] = _array(stats[q][buf])
    return out


def _put_sn(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any],
            st: Mapping[str, Any]) -> None:
    """A spectral-norm convolution: the kernel (and bias) from ``params``,
    ``u`` and ``sigma`` from ``batch_stats``."""
    (layer,) = p.keys()
    _put_conv(out, name, p[layer], transposed=layer.startswith("ConvTranspose"))
    if "SpectralNorm_0" in st:
        sn = st["SpectralNorm_0"]
        out[f"{name}.u"] = _array(sn[f"{layer}/kernel/u"])
        out[f"{name}.sigma"] = _array(sn[f"{layer}/kernel/sigma"])


def _put_residual_block(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any],
                        st: Mapping[str, Any]) -> None:
    for conv in ("conv1", "conv2"):
        _put_sn(out, f"{name}.{conv}", p[conv], st.get(conv, {}))
    for norm in ("in1", "in2"):
        out[f"{name}.{norm}.weight"] = _array(p[norm]["scale"])
        out[f"{name}.{norm}.bias"] = _array(p[norm]["bias"])


def _put_nonlocal(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any],
                  st: Mapping[str, Any]) -> None:
    for conv in ("g", "theta", "phi", "W_conv"):
        _put_conv(out, f"{name}.{conv}", p[conv])
    out[f"{name}.W_bn.weight"] = _array(p["W_bn"]["scale"])
    out[f"{name}.W_bn.bias"] = _array(p["W_bn"]["bias"])
    if "W_bn" in st:
        out[f"{name}.W_bn.running_mean"] = _array(st["W_bn"]["mean"])
        out[f"{name}.W_bn.running_var"] = _array(st["W_bn"]["var"])


def _put_mlp(out: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    for k, key in enumerate(_numbered(p, "LinearBlock")):
        _put_dense(out, f"{name}.blocks.{k}.dense", p[key]["Dense_0"])
        if "prelu_a" in p[key]:
            out[f"{name}.blocks.{k}.prelu_a"] = _array(p[key]["prelu_a"])


def _prefixed(prefix: str, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in tensors.items()}


def adaptive_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ModelAdaptive``, ``ModelAdaptive_Deep`` or
    ``ModelAdaptiveBi_Deep`` ``{"params", "batch_stats", "vq_stats"}`` as a
    ``state_dict`` of the port's model of the same class: ``person_id`` by
    :func:`embed_net_from_jax`, a deep adaptor by
    :func:`vqvae_deep_from_jax`, the classic one by :func:`vqvae_from_jax`,
    ``resblocks1_0`` -> ``resblocks1.0``, ``encoder_s_1`` -> ``encoder_s.1``,
    the discriminator's MLP as ``discriminator.mlp``.  A tree of
    ``params`` alone (an optimizer's moments) maps the parameters alone."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    vq = variables.get("vq_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for key, p in params.items():
        st = stats.get(key, {})
        listed = re.match(r"^(resblocks\d?|encoder_s)_(\d+)$", key)
        name = f"{listed.group(1)}.{listed.group(2)}" if listed else key
        if key == "person_id":
            out.update(_prefixed(key, embed_net_from_jax({"params": p, "batch_stats": st})))
        elif key.startswith("adaptor"):
            sub = {"params": p, "vq_stats": vq.get(key, {})}
            deep = "conv1" in p["dec"]
            out.update(_prefixed(key, vqvae_deep_from_jax(sub) if deep else vqvae_from_jax(sub)))
        elif key.startswith("fusion"):
            _put_nonlocal(out, key, p, st)
        elif key.startswith("resblocks"):
            _put_residual_block(out, name, p, st)
        elif key.startswith("encoder_s"):
            _put_encoder(out, name, p)
        elif key in ("conv1", "conv2"):
            _put_sn(out, key, p, st)
        elif key == "discriminator":
            _put_mlp(out, "discriminator.mlp", p["MLP_0"])
        else:
            raise KeyError(f"no map for the JAX module {key!r}")
    return out


adaptive_deep_from_jax = adaptive_from_jax



# ---------------------------------------------------------------------------
# StarGAN v2
# ---------------------------------------------------------------------------

_STARGAN_RENAMES = [
    (re.compile(r"^(enc_bottleneck|dec_bottleneck|enc|dec|blk|shared)(\d+)$"), r"\1.\2"),
    (re.compile(r"^dom(\d+)_(\d+)$"), r"dom.\1.\2"),
    (re.compile(r"^dom(\d+)_out$"), r"dom_out.\1"),
    (re.compile(r"^dom(\d+)$"), r"dom.\1"),
    (re.compile(r"^Conv_0$"), "conv_in"),
    (re.compile(r"^Conv_1$"), "conv_out"),
    (re.compile(r"^Conv_2$"), "head"),
]


def _stargan_name(path) -> str:
    parts = []
    for name in path:
        for pattern, repl in _STARGAN_RENAMES:
            if pattern.match(name):
                name = pattern.sub(repl, name)
                break
        parts.append(name)
    return ".".join(parts)


def stargan_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ModelStarGAN`` ``{"params", "batch_stats"}`` (or
    one of its modules' ``{"params"}``: ``Generator``, ``MappingNetwork``,
    ``StyleEncoder``, ``DiscriminatorV2``, ``ResBlk``, ``AdainResBlkV2``) as a
    ``state_dict`` of the port's module of the same class: ``person_id`` by
    :func:`embed_net_from_jax`; ``enc0`` -> ``enc.0`` (likewise ``dec``,
    ``enc_bottleneck``, ``dec_bottleneck``, ``blk``, ``shared``),
    ``dom<d>_<i>`` -> ``dom.<d>.<i>``, ``dom<d>_out`` -> ``dom_out.<d>``, a
    style encoder's ``dom<d>`` -> ``dom.<d>``, ``Conv_0`` / ``Conv_1`` /
    ``Conv_2`` -> ``conv_in`` / ``conv_out`` / ``head``; kernels as
    :func:`embed_net_from_jax` lays them out, the instance norms' ``in<k>_scale``
    / ``in<k>_bias`` as they are.  A tree of ``params`` alone (an optimizer's
    moments) maps the parameters alone."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for key, p in params.items():
        if key == "person_id":
            out.update(_prefixed(key, embed_net_from_jax(
                {"params": p, "batch_stats": stats.get(key, {})})))
            continue
        sub = {key: p} if isinstance(p, Mapping) else {}
        if not sub:                       # a module's own leaf (to_rgb_in_scale)
            out[key] = _array(p)
            continue
        for path, leaf, value in _walk(sub):
            name = _stargan_name(path)
            if leaf == "kernel":
                out[f"{name}.weight"] = _reid_leaf(leaf, value)
            else:
                out[f"{name}.{leaf}"] = _array(value)
    return out


def _natural(key: str):
    return [int(t) if t.isdigit() else t for t in key.split(".")]


def from_reference_deep_state_dict(state_dict: Mapping[str, Any],
                                   model) -> Dict[str, torch.Tensor]:
    """A reference ``VQVAE_Deep`` ``state_dict`` as one of ``model`` (the
    port's ``VQVAE_Deep`` of the same configuration), as the JAX package's
    ``import_vqvae_deep`` reads it: the convolutions of an encoder's
    ``blocks`` and of a decoder's ``up_sample`` in the order of their indices
    onto the port's in call order; every other tensor by name (the decoders'
    names are the reference's, an ``upsample_t.0`` wrapper dropped), codebooks
    ``(D, K)`` transposed; tensors the port has no place for (an
    ``AdainResBlk``'s ``conv`` Sequential, which the reference never calls)
    are left out.  Every tensor of ``model`` must be filled."""
    sd = {(("upsample_t." + k[len("upsample_t.0."):]) if k.startswith("upsample_t.0.") else k):
          torch.as_tensor(v) for k, v in state_dict.items()}
    ours = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for prefix in ("enc_b.blocks.", "enc_t.blocks.", "dec_t.up_sample.", "dec.up_sample."):
        theirs = sorted((k for k in sd if k.startswith(prefix) and k.endswith(".weight")
                         and sd[k].ndim == 4), key=_natural)
        mine = sorted((k for k in ours if k.startswith(prefix) and k.endswith(".weight")),
                      key=_natural)
        if len(theirs) != len(mine):
            raise ValueError(f"{prefix}: {len(theirs)} convolutions in the checkpoint, "
                             f"{len(mine)} in the model")
        for t, m in zip(theirs, mine):
            out[m] = sd[t]
            out[m[:-len("weight")] + "bias"] = sd[t[:-len("weight")] + "bias"]
    for k, v in sd.items():
        if k in ours and k not in out and not k.startswith(
                ("enc_b.blocks.", "enc_t.blocks.", "dec_t.up_sample.", "dec.up_sample.")):
            out[k] = v
    out = _transpose_codebooks(out)
    missing = sorted(set(ours) - set(out))
    if missing:
        raise KeyError(f"the checkpoint lacks {missing[:5]}{'...' if len(missing) > 5 else ''}")
    return out


# ---------------------------------------------------------------------------
# The detection models
# ---------------------------------------------------------------------------

_DETECTION_RENAMES = (
    (re.compile(r"^Conv_(\d)$"), lambda m: f"conv{int(m.group(1)) + 1}"),      # extra blocks
    (re.compile(r"^BatchNorm_(\d)$"), lambda m: f"bn{int(m.group(1)) + 1}"),
    (re.compile(r"^Dense_(\d)$"), lambda m: f"fc{m.group(1)}"),                # box head
    (re.compile(r"^(loc|conf)(\d)$"), lambda m: f"{m.group(1)}.{m.group(2)}"),  # SSD heads
)


def _detection_name(path) -> str:
    parts = []
    for name in path:
        for pattern, repl in _DETECTION_RENAMES:
            if pattern.match(name):
                name = pattern.sub(repl, name)
                break
        else:
            name = _reid_name((name,))
        parts.append(name)
    return ".".join(parts)


def _detection_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf, value in _walk(variables.get(collection, {})):
            name = ".".join(filter(None, (_detection_name(path),
                                          _REID_LEAVES.get(leaf, "weight"))))
            out[name] = _reid_leaf(leaf, value)
    return out


def ssd_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``SSD300`` ``{"params", "batch_stats"}`` (nested dicts
    of numpy arrays; or ``params`` alone, an optimizer's moments) as a
    ``state_dict`` of the port's ``SSD300``: the stem and ``layer2_<i>`` /
    ``layer3_<i>`` as :func:`embed_net2_from_jax` maps a ResNet,
    ``extra<k>``'s ``Conv_0``/``BatchNorm_0``/``Conv_1``/``BatchNorm_1`` ->
    ``conv1``/``bn1``/``conv2``/``bn2``, ``loc<i>``/``conf<i>`` ->
    ``loc.<i>``/``conf.<i>``."""
    return _detection_from_jax(variables)


def maskrcnn_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``MaskRCNN`` variables (the union of the trainer's
    two ``init`` calls: the backbone, ``fpn`` and ``rpn`` of the first, the
    ``box_head`` and ``mask_head`` of the second) as a ``state_dict`` of the
    port's ``MaskRCNN``: the ResNet parts as :func:`embed_net2_from_jax` maps
    them, the box head's ``Dense_0``/``Dense_1`` -> ``fc0``/``fc1``, every
    other name as it is."""
    return _detection_from_jax(variables)


# ---------------------------------------------------------------------------
# A reference PixelSNAIL state_dict
# ---------------------------------------------------------------------------

def _pixelsnail_reference_names(model) -> Dict[str, tuple]:
    """{port module path: (reference prefix, dense)} of every weight-normed
    layer of ``model`` (the port's ``PixelSNAIL``).  A reference causal
    convolution wraps a ``WNConv2d`` at ``.conv``, which wraps its ``Conv2d``
    at ``.conv``; ``res.<j>`` is ``resblocks.<j>``; the conditioning net's
    ``conv_in`` and ``res.<j>`` are its ``blocks.0`` and ``blocks.<j + 1>``;
    ``out_res.<j>`` is ``out.<j>``, and ``out_conv`` is ``out.<n + 1>`` after
    the ELU at ``out.<n>``."""
    from vqvae2_tpu_torch.models.pixelsnail import CausalConv, WNConv, WNDense

    n_out = len(model.out_res)
    rules = (
        (re.compile(r"\.res\.(\d+)(?=\.|$)"), r".resblocks.\1"),
        (re.compile(r"^cond_resnet\.conv_in$"), "cond_resnet.blocks.0"),
        (re.compile(r"^cond_resnet\.resblocks\.(\d+)"),
         lambda m: f"cond_resnet.blocks.{int(m.group(1)) + 1}"),
        (re.compile(r"^out_res\.(\d+)"), r"out.\1"),
        (re.compile(r"^out_conv$"), f"out.{n_out + 1}"),
    )
    names = {}
    for path, module in model.named_modules():
        if not isinstance(module, (WNConv, WNDense)):
            continue
        ref = path
        for pattern, repl in rules:
            ref = pattern.sub(repl, ref)
        if isinstance(module, CausalConv):
            ref += ".conv.conv"
        elif isinstance(module, WNConv):
            ref += ".conv"
        names[path] = (ref, isinstance(module, WNDense))
    return names


def to_reference_pixelsnail_state_dict(model) -> Dict[str, torch.Tensor]:
    """The port's ``PixelSNAIL`` ``model`` as a reference ``state_dict``:
    ``weight_v`` ``(O, I, kh, kw)`` (a dense layer's ``(O, I)``, the port's
    ``v`` transposed), ``weight_g`` ``(O, 1, 1, 1)`` (``(O, 1)``) and
    ``bias``."""
    sd = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, (ref, dense) in _pixelsnail_reference_names(model).items():
        v, g = sd[f"{path}.v"], sd[f"{path}.g"]
        out[f"{ref}.weight_v"] = (v.t() if dense else v).contiguous().clone()
        out[f"{ref}.weight_g"] = g.reshape(-1, *([1] * (1 if dense else 3))).clone()
        if f"{path}.b" in sd:
            out[f"{ref}.bias"] = sd[f"{path}.b"].clone()
    return out


def from_reference_pixelsnail_state_dict(state_dict: Mapping[str, Any],
                                         model) -> Dict[str, torch.Tensor]:
    """A reference ``PixelSNAIL`` ``state_dict`` as one of ``model`` (the
    port's ``PixelSNAIL`` of the same configuration), as the JAX package's
    ``import_pixelsnail`` reads it: ``weight_v`` as it is (the reference
    zeroes its causal taps at run time; the port's kernel mask zeroes the
    same taps before the norm), ``weight_g`` flattened; the buffers its
    ``state_dict`` holds are ``model``'s own.  Every
    parameter of ``model`` must be filled."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for path, (ref, dense) in _pixelsnail_reference_names(model).items():
        if f"{ref}.weight_v" not in sd:
            continue
        v = sd[f"{ref}.weight_v"]
        out[f"{path}.v"] = (v.t() if dense else v).contiguous()
        out[f"{path}.g"] = sd[f"{ref}.weight_g"].reshape(-1)
        if f"{ref}.bias" in sd:
            out[f"{path}.b"] = sd[f"{ref}.bias"]
    ours = {k for k, _ in model.named_parameters()}
    missing = sorted(ours - set(out))
    if missing:
        raise KeyError(f"the checkpoint lacks {missing[:5]}{'...' if len(missing) > 5 else ''}")
    return {**{k: v.clone() for k, v in model.state_dict().items() if k not in ours}, **out}
