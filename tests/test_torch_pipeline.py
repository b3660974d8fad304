"""The two-stage pipeline of the port, end to end on the CPU at toy size (the
counterpart of ``tests/test_pipeline.py::test_two_stage_pipeline``): train
stage 1 for two steps → extract codes from that checkpoint → train the top and
the bottom prior for two steps each on those codes → ``sample.main`` writes a
PNG from the three checkpoints, every step through the command lines a user
would call."""

import os

import numpy as np
from PIL import Image

from vqvae2_tpu_torch.data.codestore import CodeStore
from vqvae2_tpu_torch.train import extract_codes, sample
from vqvae2_tpu_torch.train import pixelsnail as tp
from vqvae2_tpu_torch.train import vqvae as tv

SIZE, N_EMBED = 32, 16


def test_two_stage_pipeline(tmp_path):
    vq_dir, codes = str(tmp_path / "vqvae"), str(tmp_path / "codes.vq2")
    m = tv.main(["--synthetic", "--steps", "2", "--batch_size", "4", "--size", str(SIZE),
                 "--channel", "16", "--n_res_block", "1", "--n_res_channel", "8",
                 "--embed_dim", "8", "--n_embed", str(N_EMBED), "--workers", "0",
                 "--ckpt_dir", vq_dir, "--device", "cpu"])
    assert np.isfinite(m["loss"])

    n = extract_codes.main(["--synthetic", "--ckpt_dir", vq_dir, "--size", str(SIZE),
                            "--batch_size", "4", "--name", codes, "--workers", "0",
                            "--device", "cpu"])
    store = CodeStore(codes)
    assert len(store) == n == 16
    assert store.top_shape == (SIZE // 8, SIZE // 8) and store.bot_shape == (SIZE // 4, SIZE // 4)
    store.close()

    prior = ["--batch", "4", "--steps", "2", "--channel", "16", "--n_res_block", "1",
             "--n_res_channel", "16", "--n_class", str(N_EMBED), "--n_cond_res_block", "1",
             "--log_every", "1", "--device", "cpu"]
    losses = {}
    for hier in ("top", "bottom"):
        losses[hier] = tp.main([codes, "--hier", hier, "--ckpt_dir", str(tmp_path / hier), *prior])
        assert np.isfinite(losses[hier]["loss"]) and 0.0 <= losses[hier]["acc"] <= 1.0
        assert abs(losses[hier]["loss"] - np.log(N_EMBED)) < 1.5

    png = str(tmp_path / "sample.png")
    top, bottom = sample.main([png, "--vqvae", vq_dir, "--top", str(tmp_path / "top"),
                               "--bottom", str(tmp_path / "bottom"), "--size", str(SIZE),
                               "--batch", "2", "--device", "cpu"])
    assert tuple(top.shape) == (2, SIZE // 8, SIZE // 8)
    assert tuple(bottom.shape) == (2, SIZE // 4, SIZE // 4)
    assert int(top.max()) < N_EMBED and int(bottom.max()) < N_EMBED
    assert os.path.exists(png)
    with Image.open(png) as img:
        assert img.size == (2 * (SIZE + 2) + 2, SIZE + 4)
