"""Hierarchical VQ-VAE-2 (port of ``vqvae2_tpu/models/vqvae.py``).

Layout: every public function takes and returns what the JAX package does —
images and feature maps ``(B, H, W, C)``, codebooks ``(K, D)``, code ids
``(B, H, W)``.  Inside a module ``x.permute(0, 3, 1, 2)`` is a free NCHW view
of the same memory (``channels_last``) that ``nn.Conv2d`` takes as is, and
permuting the result back gives contiguous ``(B, H, W, C)``, so the quantizer
sees contiguous ``(N, D)`` rows with no copy.

Parameters carry the names of the original PyTorch reference's
``state_dict`` (``enc_b.blocks.0.weight``, ``dec.blocks.1.conv.3.bias``, ...),
so such a checkpoint loads after the codebook buffers are transposed
(``utils/jax_import.py``).  The codebook state (``embed``, ``cluster_size``,
``embed_avg``) lives in buffers, not parameters.

``train=True`` runs the statistics flavour of the quantizer kernel and
updates the three codebook buffers in place (the JAX package threads them
through ``mutable=["vq_stats"]``).  Under a process group the statistics are
those of the global batch: the counts and sums are summed over the ranks
before the EMA step, and the dead-code restart draws from the global rows, so
every rank's codebook takes the single-process step (``parallel``).

``dtype`` is the convolutions' compute type, as in the JAX package
(``models/layers.py``): with ``torch.bfloat16`` every convolution runs in
bf16 while the parameters and codebooks stay fp32, so the quantizers receive
bf16 rows, give ``quantized`` back in bf16 and take ``diff`` in fp32.
``remat=True`` recomputes the encoders' and decoders' activations in the
backward pass (``torch.utils.checkpoint``) instead of keeping them, as
``nn.remat`` does in the JAX package; the quantizers are never recomputed, so
their EMA step runs once a forward.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.models.layers import Conv2d, ConvTranspose2d
from vqvae2_tpu_torch.ops.quantize import (nearest_code, nearest_code_ids,
                                           quantize_lookup)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW convolution to a ``(B, H, W, C)`` tensor."""
    return _to_nhwc(conv(_to_nchw(x)))


class Quantize(nn.Module):
    """EMA vector quantizer.

    ``embed`` is ``(n_embed, dim)`` as in the JAX package (the original
    PyTorch reference stores ``(dim, n_embed)``).  ``restart_threshold > 0``
    re-seeds, at each training call, the codes whose EMA cluster size fell
    below it from rows of the batch (off by default, as in the reference).

    ``perplexity`` holds the code-usage perplexity of the last training call
    (``None`` before one): the counterpart of the JAX module's
    ``sow("intermediates", "perplexity", ...)``."""

    def __init__(self, dim: int, n_embed: int = 512, decay: float = 0.99,
                 eps: float = 1e-5, restart_threshold: float = 0.0):
        super().__init__()
        self.dim, self.n_embed, self.decay, self.eps = dim, n_embed, decay, eps
        self.restart_threshold = restart_threshold
        embed = torch.randn(n_embed, dim)
        self.register_buffer("embed", embed)
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", embed.clone())
        self.perplexity = None

    def forward(
        self, x: torch.Tensor, train: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x`` — ``(..., dim)`` features.  Returns ``(quantized, diff,
        indices)``: straight-through quantized output, commitment loss (mean
        over all elements, in fp32) and int32 code ids of shape
        ``x.shape[:-1]``.  With ``train=True`` the search also returns the
        per-code counts and sums, and the buffers take one EMA step after
        ``quantized`` was looked up in the codebook as it was."""
        flat = x.reshape(-1, self.dim).contiguous()
        indices, quantized, csum, esum = nearest_code(flat, self.embed, with_stats=train)
        if train:
            self._ema_update(flat, par.all_reduce(csum), par.all_reduce(esum))
        indices = indices.reshape(x.shape[:-1])
        quantized = quantized.reshape(x.shape).to(x.dtype)
        diff = par.local_mean(
            torch.square(quantized.detach().to(torch.float32) - x.to(torch.float32)))
        quantized = x + (quantized - x).detach()
        return quantized, diff, indices

    @torch.no_grad()
    def _ema_update(self, flat: torch.Tensor, csum: torch.Tensor, esum: torch.Tensor) -> None:
        """The EMA step of the JAX module (``vqvae2_tpu/models/vqvae.py:83-120``),
        term for term, written into the buffers in place, from the global
        batch's ``csum`` and ``esum``; ``flat`` holds this rank's rows."""
        probs = csum / torch.clamp(torch.sum(csum), min=1.0)
        self.perplexity = torch.exp(-torch.sum(probs * torch.log(torch.clamp(probs, min=1e-10))))
        new_cluster = self.cluster_size * self.decay + (1 - self.decay) * csum
        new_avg = self.embed_avg * self.decay + (1 - self.decay) * esum
        n = torch.sum(new_cluster)
        smoothed = (new_cluster + self.eps) / (n + self.n_embed * self.eps) * n
        new_embed = new_avg / smoothed[:, None]
        if self.restart_threshold > 0:
            # dead-code restart from rows of the global batch, a draw fixed by
            # its content: row arange(K) % N of all ranks' rows in rank order
            dead = new_cluster < self.restart_threshold
            offset, total = par.row_offset(flat.shape[0], flat.device)
            take = torch.arange(self.n_embed, device=flat.device) % total
            repl = par.take_rows(flat, take, offset).to(torch.float32)
            new_embed = torch.where(dead[:, None], repl, new_embed)
            new_avg = torch.where(dead[:, None], repl, new_avg)
            new_cluster = torch.where(dead, torch.ones_like(new_cluster), new_cluster)
        self.cluster_size.copy_(new_cluster)
        self.embed_avg.copy_(new_avg)
        self.embed.copy_(new_embed)

    def embed_code(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook lookup by id, any leading shape."""
        return quantize_lookup(indices, self.embed)

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """Indices-only quantization (same argmax as ``forward``) for callers
        that consume only the integer codes."""
        flat = x.reshape(-1, self.dim).contiguous()
        return nearest_code_ids(flat, self.embed).reshape(x.shape[:-1])


class ResBlock(nn.Module):
    """ReLU → 3×3 → ReLU → 1×1, plus skip.  Works on NCHW views."""

    def __init__(self, in_channel: int, channel: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Sequential(
            nn.ReLU(),
            Conv2d(in_channel, channel, 3, padding=1, dtype=dtype),
            nn.ReLU(inplace=True),
            Conv2d(channel, in_channel, 1, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


class Encoder(nn.Module):
    """Strided convolutional encoder, ``(B, H, W, C)`` in and out.

    ``stride`` ∈ {2, 4}: stride 4 is two 4×4/s2 convolutions, stride 2 is one.
    """

    def __init__(self, in_channel: int, channel: int = 128, n_res_block: int = 2,
                 n_res_channel: int = 32, stride: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        if stride == 4:
            blocks = [
                Conv2d(in_channel, channel // 2, 4, stride=2, padding=1, dtype=dtype),
                nn.ReLU(inplace=True),
                Conv2d(channel // 2, channel, 4, stride=2, padding=1, dtype=dtype),
                nn.ReLU(inplace=True),
                Conv2d(channel, channel, 3, padding=1, dtype=dtype),
            ]
        elif stride == 2:
            blocks = [
                Conv2d(in_channel, channel // 2, 4, stride=2, padding=1, dtype=dtype),
                nn.ReLU(inplace=True),
                Conv2d(channel // 2, channel, 3, padding=1, dtype=dtype),
            ]
        else:
            raise ValueError(f"unsupported stride {stride}")
        blocks += [ResBlock(channel, n_res_channel, dtype) for _ in range(n_res_block)]
        blocks.append(nn.ReLU(inplace=True))
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.blocks, x)


class Decoder(nn.Module):
    """Transposed-convolution decoder, ``(B, H, W, C)`` in and out."""

    def __init__(self, in_channel: int, out_channel: int, channel: int = 128,
                 n_res_block: int = 2, n_res_channel: int = 32, stride: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        blocks = [Conv2d(in_channel, channel, 3, padding=1, dtype=dtype)]
        blocks += [ResBlock(channel, n_res_channel, dtype) for _ in range(n_res_block)]
        blocks.append(nn.ReLU(inplace=True))
        if stride == 4:
            blocks += [
                ConvTranspose2d(channel, channel // 2, 4, stride=2, padding=1, dtype=dtype),
                nn.ReLU(inplace=True),
                ConvTranspose2d(channel // 2, out_channel, 4, stride=2, padding=1, dtype=dtype),
            ]
        elif stride == 2:
            blocks.append(
                ConvTranspose2d(channel, out_channel, 4, stride=2, padding=1, dtype=dtype))
        else:
            raise ValueError(f"unsupported stride {stride}")
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.blocks, x)


class VQVAE(nn.Module):
    """Two-level hierarchical VQ-VAE.

    Defaults are the reference configuration: channel 128, 2 residual blocks
    of 32 channels, code dimension 64, 512 codes.  ``with_ir_head`` adds the
    extra 1-channel decoder head ``dec_ir`` (two residual blocks deeper).
    ``restart_threshold`` goes to both quantizers (see :class:`Quantize`).
    ``dtype`` (the convolutions' compute type) and ``remat`` are the JAX
    module's fields; neither changes the parameters or their names."""

    def __init__(self, in_channel: int = 3, channel: int = 128, n_res_block: int = 2,
                 n_res_channel: int = 32, embed_dim: int = 64, n_embed: int = 512,
                 decay: float = 0.99, with_ir_head: bool = False,
                 restart_threshold: float = 0.0, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = dict(in_channel=in_channel, channel=channel,
                           n_res_block=n_res_block, n_res_channel=n_res_channel,
                           embed_dim=embed_dim, n_embed=n_embed, decay=decay,
                           with_ir_head=with_ir_head, restart_threshold=restart_threshold)
        self.with_ir_head, self.dtype, self.remat = with_ir_head, dtype, remat
        dt = dict(dtype=dtype)
        self.enc_b = Encoder(in_channel, channel, n_res_block, n_res_channel, stride=4, **dt)
        self.enc_t = Encoder(channel, channel, n_res_block, n_res_channel, stride=2, **dt)
        self.quantize_conv_t = Conv2d(channel, embed_dim, 1, **dt)
        self.quantize_t = Quantize(embed_dim, n_embed, decay,
                                   restart_threshold=restart_threshold)
        self.dec_t = Decoder(embed_dim, embed_dim, channel, n_res_block,
                             n_res_channel, stride=2, **dt)
        self.quantize_conv_b = Conv2d(embed_dim + channel, embed_dim, 1, **dt)
        self.quantize_b = Quantize(embed_dim, n_embed, decay,
                                   restart_threshold=restart_threshold)
        self.upsample_t = ConvTranspose2d(embed_dim, embed_dim, 4, stride=2, padding=1, **dt)
        self.dec = Decoder(embed_dim + embed_dim, in_channel, channel, n_res_block,
                           n_res_channel, stride=4, **dt)
        if with_ir_head:
            self.dec_ir = Decoder(embed_dim + embed_dim, 1, channel, n_res_block + 2,
                                  n_res_channel, stride=4, **dt)

    def _coder(self, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """An encoder or decoder, its activations recomputed in the backward
        pass under ``remat`` (only where a backward can follow)."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, x, use_reentrant=False)
        return module(x)

    @staticmethod
    def _check_size(x: torch.Tensor) -> None:
        h, w = x.shape[1:3]
        if h % 8 or w % 8:
            # the stride-2 transposed convolution must exactly invert enc_t's
            # stride 2, so H/4 and W/4 must be even
            raise ValueError(
                f"VQVAE needs image H and W divisible by 8, got {(h, w)}; "
                f"pad or resize the input")

    def forward(self, x: torch.Tensor, train: bool = False):
        """Returns ``(dec, diff)``; ``train=True`` also takes one EMA step of
        both codebooks."""
        quant_t, quant_b, diff, _, _ = self.encode(x, train=train)
        return self.decode(quant_t, quant_b), diff

    def forward_ir(self, x: torch.Tensor, train: bool = False):
        """Forward with the extra IR head: ``(dec, diff, dec_ir)``; needs
        ``with_ir_head=True``."""
        quant_t, quant_b, diff, _, _ = self.encode(x, train=train)
        return (self.decode(quant_t, quant_b), diff,
                self.decode_ir(quant_t, quant_b))

    def _encode_top(self, x: torch.Tensor, train: bool):
        """Shared head of ``encode`` and ``encode_ids``: the top grid is
        quantized fully (``dec_t`` consumes ``quant_t``); returns the top
        results and the input of the bottom quantizer."""
        self._check_size(x)
        enc_b = self._coder(self.enc_b, x)
        enc_t = self._coder(self.enc_t, enc_b)
        qt_in = _conv_nhwc(self.quantize_conv_t, enc_t)
        quant_t, diff_t, id_t = self.quantize_t(qt_in, train=train)
        dec_t = self._coder(self.dec_t, quant_t)
        enc_b = torch.cat([dec_t, enc_b], dim=-1)
        qb_in = _conv_nhwc(self.quantize_conv_b, enc_b)
        return quant_t, diff_t, id_t, qb_in

    def encode(self, x: torch.Tensor, train: bool = False):
        """Returns ``(quant_t, quant_b, diff, id_t, id_b)``, all
        ``(B, H, W, ...)``; ``diff`` is ``diff_t + diff_b``."""
        quant_t, diff_t, id_t, qb_in = self._encode_top(x, train)
        quant_b, diff_b, id_b = self.quantize_b(qb_in, train=train)
        return quant_t, quant_b, diff_t + diff_b, id_t, id_b

    def encode_ids(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Code-extraction path: ``(id_t, id_b)`` only.  Same argmax as
        :meth:`encode`, but the bottom grid, which has four times the rows,
        runs the indices-only kernel."""
        _, _, id_t, qb_in = self._encode_top(x, False)
        return id_t, self.quantize_b.codes(qb_in)

    def _merge(self, quant_t: torch.Tensor, quant_b: torch.Tensor) -> torch.Tensor:
        upsample_t = _conv_nhwc(self.upsample_t, quant_t)
        return torch.cat([upsample_t, quant_b], dim=-1)

    def decode(self, quant_t: torch.Tensor, quant_b: torch.Tensor) -> torch.Tensor:
        return self._coder(self.dec, self._merge(quant_t, quant_b))

    def decode_ir(self, quant_t: torch.Tensor, quant_b: torch.Tensor) -> torch.Tensor:
        """The extra 1-channel IR head."""
        return self._coder(self.dec_ir, self._merge(quant_t, quant_b))

    def decode_code(self, code_t: torch.Tensor, code_b: torch.Tensor) -> torch.Tensor:
        """Reconstruct from integer codes; the looked-up codes are cast to
        the compute type."""
        quant_t = self.quantize_t.embed_code(code_t).to(self.dtype)
        quant_b = self.quantize_b.embed_code(code_b).to(self.dtype)
        return self.decode(quant_t, quant_b)


def build_vqvae(device="cuda", seed: int = 0, **config) -> VQVAE:
    """A ``VQVAE`` in eval mode on ``device`` (default: the card; raises when
    it is absent), its weights drawn from ``seed`` without touching the global
    generator."""
    from vqvae2_tpu_torch import resolve_device

    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = VQVAE(**config)
    return model.to(dev).eval()
