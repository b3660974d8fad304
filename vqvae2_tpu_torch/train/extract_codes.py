"""Stage-1→2 bridge: run the VQ-VAE encoder over a dataset and write integer
code ids into the code store (port of ``vqvae2_tpu/train/extract_codes.py``).

The encode runs batch by batch, ids only (the bottom grid goes through the
indices-only kernel); the host streams (top, bottom, label, name) rows into
``CodeStoreWriter``.  Under a process group (``parallel``; ``main`` runs
through ``parallel.launch``) each rank encodes its rows of every batch, the
ids are gathered in row order, and the primary rank writes the store, the
same store one process writes.  No batch is padded: a ragged last batch, even
one shorter than the world, leaves some ranks fewer rows or none, and the
rows written are the images' own.

Run: ``python -m vqvae2_tpu_torch.train.extract_codes <img_dir> --ckpt_dir ...
--name codes.vq2`` (or ``--synthetic --random_init`` for a smoke run).  The
device defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.codestore import CodeStoreWriter
from vqvae2_tpu_torch.data.datasets import (ImageFileDataset, SyntheticImages,
                                            iterate_batches, to_unit_device)
from vqvae2_tpu_torch.models.vqvae import VQVAE, build_vqvae
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager


@torch.no_grad()
def extract(model: VQVAE, dataset, out_path: str, batch_size: int = 64,
            size: int = 256, workers: int = 4, device="cuda") -> int:
    """Encode ``dataset`` with ``model`` on ``device`` and write its code ids
    to ``out_path`` (the primary rank writes); returns the number of rows
    written."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    top_shape = (size // 8, size // 8)
    bot_shape = (size // 4, size // 4)
    writer = CodeStoreWriter(out_path, top_shape, bot_shape) if par.is_primary() else None
    n = 0
    for imgs, labels, paths in iterate_batches(
        dataset, batch_size, shuffle=False, drop_last=False, epochs=1,
        workers=workers,
    ):
        # raw uint8 batches normalize on the device
        id_t, id_b = model.encode_ids(to_unit_device(par.shard_batch(imgs), dev))
        id_t, id_b = par.gather_rows(id_t, len(imgs)), par.gather_rows(id_b, len(imgs))
        n += len(imgs)
        if writer is not None:
            writer.append(id_t.cpu().numpy().astype(np.int16),
                          id_b.cpu().numpy().astype(np.int16), labels, paths)
            if n % (batch_size * 20) < batch_size:
                print(f"extracted {n}", flush=True)
    if writer is not None:
        writer.close()
    par.synchronize()
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="Extract VQ codes into a CodeStore")
    p.add_argument("path", nargs="?", default=None)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--ckpt_name", type=str, default="last")
    p.add_argument("--torch_ckpt", type=str, default="",
                   help="reference PyTorch VQVAE checkpoint (e.g. "
                        "vqvae_560.pt) to load instead of a native ckpt")
    p.add_argument("--name", type=str, default="codes.vq2")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--shapes", type=int, default=0, metavar="N",
                   help="encode N procedural structured images (data/shapes.py) "
                        "— must match the --shapes corpus the VQVAE trained on")
    p.add_argument("--random_init", action="store_true",
                   help="skip checkpoint restore (smoke runs)")
    p.add_argument("--workers", type=int, default=4,
                   help="decode thread pool size; 0 = inline")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    # model config (overridden by the checkpoint's config.json when present)
    p.add_argument("--channel", type=int, default=128)
    p.add_argument("--n_res_block", type=int, default=2)
    p.add_argument("--n_res_channel", type=int, default=32)
    p.add_argument("--embed_dim", type=int, default=64)
    p.add_argument("--n_embed", type=int, default=512)
    args = p.parse_args(argv)

    return par.launch(_extract_main, args, device=args.device)


def _extract_main(args) -> int:
    device = resolve_device(args.device)
    precision = set_reference_precision()
    if par.is_primary():
        print(f"device {device}, world {par.get_world_size()}, reference precision {precision}")

    if args.synthetic:
        dataset = SyntheticImages(n=args.batch_size * 4, size=args.size)
    elif args.shapes:
        from vqvae2_tpu_torch.data.shapes import ShapesDataset

        dataset = ShapesDataset(n=args.shapes, size=args.size, raw=True)
    else:
        dataset = ImageFileDataset(args.path, size=args.size, raw=True)

    cfg = {}
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        cfg = mgr.load_config() or {}
    model = build_vqvae(
        device=device,
        channel=cfg.get("channel", args.channel),
        n_res_block=cfg.get("n_res_block", args.n_res_block),
        n_res_channel=cfg.get("n_res_channel", args.n_res_channel),
        embed_dim=cfg.get("embed_dim", args.embed_dim),
        n_embed=cfg.get("n_embed", args.n_embed),
    )
    if args.torch_ckpt:
        from vqvae2_tpu_torch.utils.jax_import import from_reference_state_dict

        ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
        sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
        model.load_state_dict(from_reference_state_dict(sd))
    elif args.ckpt_dir and not args.random_init:
        state = mgr.restore(args.ckpt_name)
        model.load_state_dict(state.get("model", state))
    par.replicate(model)

    n = extract(model, dataset, args.name, batch_size=args.batch_size,
                size=args.size, workers=args.workers, device=device)
    if par.is_primary():
        print(f"wrote {n} code rows to {args.name}")
    return n


if __name__ == "__main__":
    main()
