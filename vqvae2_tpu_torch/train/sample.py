"""Hierarchical generation: sample the top prior → sample the bottom prior
conditioned on the top codes → VQ-VAE ``decode_code`` → PNG grid (port of
``vqvae2_tpu/train/sample.py``).

Each of the three models is rebuilt from the ``config.json`` of its checkpoint
directory and takes its weights from that directory's ``last`` checkpoint (a
``state_dict``, or a dict holding one under ``"model"``).

Run: ``python -m vqvae2_tpu_torch.train.sample out.png --vqvae <dir> --top <dir>
--bottom <dir>``.  The device defaults to ``cuda``; ``--device cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.models.incremental import sample_prior_incremental
from vqvae2_tpu_torch.models.sampling import sample_prior
from vqvae2_tpu_torch.models.vqvae import VQVAE
from vqvae2_tpu_torch.train.pixelsnail import build_model
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.image import save_image


def _load(model: torch.nn.Module, mgr: CheckpointManager, device) -> torch.nn.Module:
    state = mgr.restore("last")
    model.load_state_dict(state.get("model", state))
    return model.to(device).eval()


def _restore_prior(ckpt_dir: str, hier: str, code_hw, device):
    mgr = CheckpointManager(ckpt_dir)
    cfg = mgr.load_config() or {}
    args = argparse.Namespace(**{
        "n_class": cfg.get("n_class", 512), "channel": cfg.get("channel", 256),
        "n_res_block": cfg.get("n_res_block", 4),
        "n_res_channel": cfg.get("n_res_channel", 256),
        "n_out_res_block": cfg.get("n_out_res_block", 0),
        "n_cond_res_block": cfg.get("n_cond_res_block", 3),
        "dropout": cfg.get("dropout", 0.1),
    })
    return _load(build_model(hier, args, code_hw=code_hw), mgr, device)


def _restore_vqvae(ckpt_dir: str, device):
    mgr = CheckpointManager(ckpt_dir)
    cfg = mgr.load_config() or {}
    model = VQVAE(
        channel=cfg.get("channel", 128), n_res_block=cfg.get("n_res_block", 2),
        n_res_channel=cfg.get("n_res_channel", 32),
        embed_dim=cfg.get("embed_dim", 64), n_embed=cfg.get("n_embed", 512),
    )
    return _load(model, mgr, device)


@torch.no_grad()
def main(argv=None):
    """Sample, decode and write the PNG; returns the sampled ``(top, bottom)``
    code grids."""
    p = argparse.ArgumentParser(description="Hierarchical VQ-VAE-2 sampling")
    p.add_argument("filename", help="output PNG")
    p.add_argument("--vqvae", type=str, required=True, help="vqvae ckpt dir")
    p.add_argument("--top", type=str, required=True, help="top prior ckpt dir")
    p.add_argument("--bottom", type=str, required=True, help="bottom prior ckpt dir")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full_forward", action="store_true",
                   help="use the O(HW)-reforward sampler instead of the "
                        "incremental cached decoder")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    set_reference_precision()

    th = args.size // 8
    bh = args.size // 4
    vqvae = _restore_vqvae(args.vqvae, device)
    top_model = _restore_prior(args.top, "top", (th, bh), device)
    bot_model = _restore_prior(args.bottom, "bottom", (th, bh), device)

    # one stream per prior, so neither sampler's draws depend on the other's count
    g_top = torch.Generator(device=device).manual_seed(2 * args.seed)
    g_bot = torch.Generator(device=device).manual_seed(2 * args.seed + 1)
    if args.full_forward:
        top = sample_prior(top_model, g_top, args.batch, (th, th), temperature=args.temp)
        bottom = sample_prior(bot_model, g_bot, args.batch, (bh, bh),
                              temperature=args.temp, condition=top)
    else:
        top = sample_prior_incremental(top_model, g_top, args.batch, temperature=args.temp)
        bottom = sample_prior_incremental(bot_model, g_bot, args.batch,
                                          temperature=args.temp, condition=top)

    decoded = vqvae.decode_code(top, bottom)
    decoded = np.clip(decoded.cpu().numpy(), -1.0, 1.0)
    save_image(decoded, args.filename, nrow=args.batch)
    print(f"wrote {args.filename}")
    return top, bottom


if __name__ == "__main__":
    main()
