"""Autoregressive sampling for PixelSNAIL priors by full forwards (port of
``vqvae2_tpu/models/sampling.py``).

A raster scan over the grid: one full forward of the model per position, the
logits at that position divided by the temperature, one categorical draw,
written into the grid.  Everything stays on the model's device: the loop reads
nothing back.  The condition features are computed once for all steps.

:func:`draw_codes` is the one place either sampler draws from, so that this
sampler and the incremental one (``models/incremental.py``), given generators
with the same seed, return equal codes whenever their per-step logits agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vqvae2_tpu_torch.models.pixelsnail import PixelSNAIL


def draw_codes(logits: torch.Tensor, temperature: float,
               generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits (B, n_class)`` at the given
    temperature: ``(B,)`` int32."""
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def sample_prior(
    model: PixelSNAIL,
    generator: torch.Generator,
    batch: int,
    shape: Tuple[int, int],
    temperature: float = 1.0,
    condition: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Draw ``(batch, H, W)`` int32 codes from the prior, with a generator on
    the model's device."""
    h, w = shape
    cond_feat = model.compute_condition(condition) if condition is not None else None
    codes = torch.zeros((batch, h, w), dtype=torch.int32, device=model_device(model))
    flat_codes = codes.view(batch, h * w)
    for i in range(h * w):
        logits = model(codes, condition_features=cond_feat)
        step_logits = logits.reshape(batch, h * w, -1)[:, i]
        flat_codes[:, i] = draw_codes(step_logits, temperature, generator)
    return codes
