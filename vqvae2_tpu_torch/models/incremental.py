"""Incremental (cached-decode) PixelSNAIL sampling (port of
``vqvae2_tpu/models/incremental.py``).

The full-forward sampler (``models/sampling.py``) forwards the whole grid at
every step.  Here a step computes the activations at ONE position only and
reads per-layer caches for the rest.

Mechanics
---------
* All weight-normalised kernels are resolved ONCE into plain ``(w, b)`` pairs
  (causal masks folded in): ``w`` is ``(kh, kw, I, O)`` for a convolution and
  ``(I, O)`` for a dense layer, the JAX package's layouts.
* Every intermediate stream (block inputs, causal-conv intermediates, res
  outputs) is cached as a zero-padded ``(B, H+PT, W+PL+PR, C)`` grid;
  activations at raster position ``t`` are functions of cache entries at
  positions ``< t``, so one pass per step fills position ``t`` everywhere and
  then the code at ``t`` is drawn.
* Causal convolutions become window dot products; attention keeps per-block
  K/V caches and does one masked softmax-attend over the prefix.
* The caches are plain tensors written in place; the position is a Python
  integer, and no step reads anything back from the device.

Exactness: teacher-forced incremental logits equal the full forward's — same
parameters, same arithmetic, another schedule.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from vqvae2_tpu_torch.models.pixelsnail import PixelSNAIL, WNConv, WNDense
from vqvae2_tpu_torch.models.sampling import draw_codes, model_device

PT = 4   # top padding rows (max causal kernel height - 1)
PL = 4   # left padding cols
PR = 4   # right padding cols


# ---------------------------------------------------------------------------
# Resolve weight-normalised parameters into plain kernels
# ---------------------------------------------------------------------------

def _wn_conv(conv: WNConv):
    b = conv.b.detach() if conv.b is not None else None
    return conv.weight().detach().permute(2, 3, 1, 0).contiguous(), b


def _wn_dense(dense: WNDense):
    b = dense.b.detach() if dense.b is not None else None
    return dense.weight().detach().contiguous(), b


def resolve_params(model: PixelSNAIL) -> Dict[str, Any]:
    """The model's parameters as plain kernels (weight norm and causal masks
    applied once)."""
    out: Dict[str, Any] = {
        "horizontal": _wn_conv(model.horizontal),
        "vertical": _wn_conv(model.vertical),
        "blocks": [],
        "out_res": [],
        "out_conv": _wn_conv(model.out_conv),
    }
    for block in model.blocks:
        blk: Dict[str, Any] = {"res": []}
        for res in block.res:
            entry = {"conv1": _wn_conv(res.conv1), "conv2": _wn_conv(res.conv2)}
            if res.condition is not None:
                entry["condition"] = _wn_conv(res.condition)
            blk["res"].append(entry)
        if model.attention:
            blk["key_rb"] = {n: _wn_conv(getattr(block.key_resblock, n))
                             for n in ("conv1", "conv2")}
            blk["query_rb"] = {n: _wn_conv(getattr(block.query_resblock, n))
                               for n in ("conv1", "conv2")}
            blk["attn"] = {n: _wn_dense(getattr(block.causal_attention, n))
                           for n in ("query", "key", "value")}
            blk["out_rb"] = {n: _wn_conv(getattr(block.out_resblock, n))
                             for n in ("conv1", "conv2", "aux_conv")}
        else:
            blk["out"] = _wn_conv(block.out)
        out["blocks"].append(blk)
    for res in model.out_res:
        out["out_res"].append({n: _wn_conv(getattr(res, n)) for n in ("conv1", "conv2")})
    return out


# ---------------------------------------------------------------------------
# Per-position primitives
# ---------------------------------------------------------------------------

def _window_dot(cache: torch.Tensor, i: int, j: int, wb, row_off: int, col_off: int,
                pre_elu: bool) -> torch.Tensor:
    """Dot a ``(kh, kw)`` window of ``cache``, ending at the padded position
    derived from ``(i, j)``, with kernel ``w``.  ``row_off``/``col_off`` encode
    the shift semantics (0-centred cols, -1 offsets for the shift_down/right
    streams)."""
    w, b = wb
    kh, kw, cin, cout = w.shape
    rs = i + PT - (kh - 1) + row_off
    cs = j + PL + col_off
    win = cache[:, rs:rs + kh, cs:cs + kw, :]
    if pre_elu:
        win = F.elu(win)
    y = win.reshape(win.shape[0], kh * kw * cin) @ w.reshape(kh * kw * cin, cout)
    return y + b if b is not None else y


def _pix(wb, x: torch.Tensor, pre_elu: bool = False) -> torch.Tensor:
    """1×1 conv applied to a single position vector ``(B, C)``."""
    w, b = wb
    if pre_elu:
        x = F.elu(x)
    y = x @ w[0, 0]
    return y + b if b is not None else y


def _gated_res_pix(rb, x: torch.Tensor, aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GatedResBlock with kernel 1 at one position ``(B, C)``."""
    h = _pix(rb["conv1"], x, pre_elu=True)
    if aux is not None:
        h = h + _pix(rb["aux_conv"], aux, pre_elu=True)
    h = F.elu(h)
    h = _pix(rb["conv2"], h)
    a, g = h.chunk(2, dim=-1)
    return x + a * torch.sigmoid(g)


def _write(cache: torch.Tensor, i: int, j: int, val: torch.Tensor) -> None:
    cache[:, i + PT, j + PL] = val


# ---------------------------------------------------------------------------
# The incremental step
# ---------------------------------------------------------------------------

def _make_caches(model: PixelSNAIL, batch: int, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    h, w = model.shape
    dev = model_device(model)

    def shp(c):
        return torch.zeros((batch, h + PT, w + PL + PR, c), dtype=dtype, device=dev)

    caches: Dict[str, torch.Tensor] = {"x": shp(model.n_class)}
    caches["s0"] = shp(model.channel)
    for b in range(model.n_block):
        for r in range(model.n_res_block):
            caches[f"h{b}_{r}"] = shp(model.res_channel)   # conv1 outputs
            caches[f"t{b}_{r}"] = shp(model.channel)       # res outputs
        caches[f"s{b+1}"] = shp(model.channel)             # block outputs
        if model.attention:
            attn = model.blocks[b].causal_attention
            kv = (batch, attn.n_head, h * w, attn.channel // attn.n_head)
            caches[f"K{b}"] = torch.zeros(kv, dtype=dtype, device=dev)
            caches[f"V{b}"] = torch.zeros(kv, dtype=dtype, device=dev)
    caches["pos"] = torch.arange(h * w, device=dev)
    return caches


def _step_logits(model: PixelSNAIL, pp, caches, i: int, j: int, t: int,
                 cond_grid: Optional[torch.Tensor]) -> torch.Tensor:
    """Compute logits at raster position ``t = (i, j)`` and write all layer
    activations at ``t`` into the caches (in place).  Returns the logits."""
    batch = caches["x"].shape[0]
    kernel = model.kernel_size + (model.kernel_size % 2 == 0)

    # input streams (shift_down(horizontal) + shift_right(vertical)).  The
    # shifts move zeros in, not the convolutions' biases: row 0 gets nothing
    # from the horizontal stream and column 0 nothing from the vertical one.
    horiz = _window_dot(caches["x"], i, j, pp["horizontal"], row_off=-1,
                        col_off=-(kernel // 2), pre_elu=False)
    vert = _window_dot(caches["x"], i, j, pp["vertical"], row_off=0,
                       col_off=-(kernel // 2 - 1) - 1, pre_elu=False)
    s = horiz * float(i > 0) + vert * float(j > 0)
    _write(caches["s0"], i, j, s)

    background = model.background[i, j].to(s.dtype).expand(batch, 2)
    cond = cond_grid[:, i, j] if cond_grid is not None else None

    k2 = model.kernel_size // 2
    for b in range(model.n_block):
        blk = pp["blocks"][b]
        block_in = s
        out = s
        for r in range(model.n_res_block):
            in_cache = caches[f"s{b}"] if r == 0 else caches[f"t{b}_{r-1}"]
            h1 = _window_dot(in_cache, i, j, blk["res"][r]["conv1"],
                             row_off=0, col_off=-k2, pre_elu=True)
            _write(caches[f"h{b}_{r}"], i, j, h1)
            h2 = _window_dot(caches[f"h{b}_{r}"], i, j, blk["res"][r]["conv2"],
                             row_off=0, col_off=-k2, pre_elu=True)
            if cond is not None:
                h2 = h2 + _pix(blk["res"][r]["condition"], cond)
            a, g = h2.chunk(2, dim=-1)
            out = out + a * torch.sigmoid(g)
            _write(caches[f"t{b}_{r}"], i, j, out)

        if model.attention:
            k_cache, v_cache = caches[f"K{b}"], caches[f"V{b}"]
            n_head, dim_head = k_cache.shape[1], k_cache.shape[3]

            key_in = torch.cat([block_in, out, background], dim=-1)
            key_feat = _gated_res_pix(blk["key_rb"], key_in)
            query_in = torch.cat([out, background], dim=-1)
            query_feat = _gated_res_pix(blk["query_rb"], query_in)

            wq, bq = blk["attn"]["query"]
            wk, bk = blk["attn"]["key"]
            wv, bv = blk["attn"]["value"]
            q = (query_feat @ wq + bq).reshape(batch, n_head, dim_head)
            k_t = (key_feat @ wk + bk).reshape(batch, n_head, dim_head)
            v_t = (key_feat @ wv + bv).reshape(batch, n_head, dim_head)

            # attend over the strict prefix (positions < t)
            scores = torch.einsum("bnd,bnld->bnl", q, k_cache) / math.sqrt(dim_head)
            scores = scores.masked_fill(caches["pos"][None, None, :] >= t, -1e4)
            attn = torch.softmax(scores, dim=-1)
            attn_out = torch.einsum("bnl,bnld->bnd", attn, v_cache)
            attn_out = attn_out.reshape(batch, n_head * dim_head)
            attn_out = attn_out * float(t > 0)   # start_mask semantics

            # store this position's K/V for future queries
            k_cache[:, :, t] = k_t
            v_cache[:, :, t] = v_t

            out = _gated_res_pix(blk["out_rb"], out, aux=attn_out)
        else:
            out = _pix(blk["out"], torch.cat([out, background], dim=-1))

        _write(caches[f"s{b+1}"], i, j, out)
        s = out

    for rb in pp["out_res"]:
        s = _gated_res_pix(rb, s)
    return _pix(pp["out_conv"], F.elu(s))


def _write_code(model: PixelSNAIL, caches, i: int, j: int, code: torch.Tensor) -> None:
    onehot = F.one_hot(code.long(), model.n_class).to(caches["x"].dtype)
    _write(caches["x"], i, j, onehot)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

@torch.no_grad()
def sample_prior_incremental(
    model: PixelSNAIL,
    generator: torch.Generator,
    batch: int,
    temperature: float = 1.0,
    condition: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cached-decode sampling over the model's own grid: ``(batch, H, W)``
    int32 codes, the same as :func:`vqvae2_tpu_torch.models.sampling.sample_prior`
    gives for an equally seeded generator (both draw through ``draw_codes``)
    whenever the per-step logits agree."""
    h, w = model.shape
    pp = resolve_params(model)
    cond_grid = model.compute_condition(condition) if condition is not None else None
    caches = _make_caches(model, batch)
    codes = torch.zeros((batch, h, w), dtype=torch.int32, device=model_device(model))
    for t in range(h * w):
        i, j = divmod(t, w)
        logits = _step_logits(model, pp, caches, i, j, t, cond_grid)
        draw = draw_codes(logits, temperature, generator)
        codes[:, i, j] = draw
        _write_code(model, caches, i, j, draw)
    return codes


@torch.no_grad()
def teacher_forced_logits(model: PixelSNAIL, codes: torch.Tensor,
                          condition: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the incremental decoder with the given codes written in (no
    sampling) and return the logits at every position ``(B, H, W, n_class)`` —
    the equivalence probe against the full forward."""
    h, w = model.shape
    batch = codes.shape[0]
    pp = resolve_params(model)
    cond_grid = model.compute_condition(condition) if condition is not None else None
    caches = _make_caches(model, batch)
    logits_all = torch.zeros((batch, h, w, model.n_class), dtype=torch.float32,
                             device=model_device(model))
    for t in range(h * w):
        i, j = divmod(t, w)
        logits_all[:, i, j] = _step_logits(model, pp, caches, i, j, t, cond_grid)
        _write_code(model, caches, i, j, codes[:, i, j])
    return logits_all
