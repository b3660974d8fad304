"""The port's checkpoints against the JAX package's semantics: periodic, last
and best round-trip; ``restore_latest`` on a fresh directory returns
``(target, None)`` and otherwise prefers the newest periodic checkpoint; both
trainers resume and continue the step count (the counterpart of
``tests/test_resume.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from vqvae2_tpu_torch.data.codestore import CodeStoreWriter
from vqvae2_tpu_torch.train import pixelsnail as tp
from vqvae2_tpu_torch.train import vqvae as tv
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager


def test_restore_latest_fresh_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    target = {"a": torch.zeros(2), "b": 0}
    state, name = mgr.restore_latest(target)
    assert name is None and state is target

    mgr.save_last({"a": torch.ones(2), "b": 7})
    state, name = mgr.restore_latest(target)
    assert name == "last" and state["b"] == 7

    mgr.save_periodic(10, {"a": torch.ones(2), "b": 10})
    state, name = mgr.restore_latest(target)
    assert name == "step_0000010" and state["b"] == 10
    mgr.save_periodic(30, {"a": torch.ones(2), "b": 30})
    assert mgr.latest_step() == 30 and mgr.restore_latest()[1] == "step_0000030"


def test_periodic_last_best_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), config={"channel": 16, "lr": 3e-4})
    state = {"model": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 3}
    mgr.save_periodic(3, state)
    mgr.save_last(state)
    assert mgr.save_best(0.5, state) and not mgr.save_best(0.4, state)
    assert mgr.save_best(0.7, {"model": {"w": torch.zeros(2, 3)}, "step": 4})
    for name in ("step_0000003", "last"):
        got = mgr.restore(name)
        assert got["step"] == 3 and torch.equal(got["model"]["w"], state["model"]["w"])
    assert mgr.restore("best")["step"] == 4
    with open(os.path.join(mgr.directory, "best_metric.json")) as f:
        assert json.load(f) == {"metric": 0.7}
    assert mgr.load_config() == {"channel": 16, "lr": 3e-4}
    assert sorted(os.listdir(mgr.directory)) == [
        "best.pt", "best_metric.json", "config.json", "last.pt", "step_0000003.pt"]
    with pytest.raises(FileNotFoundError):
        mgr.restore("step_0000004")


VQVAE_ARGS = ["--synthetic", "--steps", "4", "--batch_size", "8", "--size", "32",
              "--channel", "16", "--n_res_block", "1", "--n_res_channel", "8",
              "--embed_dim", "8", "--n_embed", "16", "--log_every", "2", "--workers", "0",
              "--device", "cpu"]


def test_vqvae_trainer_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    base = VQVAE_ARGS + ["--ckpt_dir", ckpt, "--resume"]
    m1 = tv.main(base)                  # a fresh directory: --resume starts clean
    assert np.isfinite(m1["loss"])
    first = torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)
    assert first["step"] == 4
    m2 = tv.main(base)
    assert np.isfinite(m2["loss"]) and abs(m2["loss"] - m1["loss"]) < 1.0
    second = torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)
    assert second["step"] == 8                      # the step count continued
    assert not torch.equal(second["model"]["quantize_b.cluster_size"],
                           first["model"]["quantize_b.cluster_size"])
    assert second["optimizer"]["state"][0]["step"] == 8


def test_vqvae_trainer_saves_periodically_and_resumes_from_it(tmp_path):
    """One epoch is one step here (8 shapes images at batch 8): a periodic
    save every ten epochs."""
    ckpt = str(tmp_path / "ckpt")
    argv = [a for a in VQVAE_ARGS if a != "--synthetic"] + ["--shapes", "8", "--ckpt_dir", ckpt]
    args = tv.build_argparser().parse_args(argv + ["--steps", "10"])
    tv.train(args)
    assert sorted(os.listdir(ckpt)) == ["config.json", "last.pt", "step_0000010.pt"]
    os.remove(os.path.join(ckpt, "last.pt"))
    tv.main(argv + ["--steps", "1", "--resume"])
    assert torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)["step"] == 11


def test_pixelsnail_trainer_resume(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "codes.vq2")
    with CodeStoreWriter(path, (4, 4), (8, 8)) as w:
        w.append(rng.integers(0, 16, (32, 4, 4)).astype(np.int16),
                 rng.integers(0, 16, (32, 8, 8)).astype(np.int16),
                 np.zeros(32, np.int32), [f"{i}" for i in range(32)])
    ckpt = str(tmp_path / "ck")
    base = [path, "--steps", "4", "--batch", "8", "--channel", "16", "--n_res_block", "1",
            "--n_res_channel", "16", "--n_class", "16", "--log_every", "2",
            "--ckpt_dir", ckpt, "--device", "cpu", "--hier", "top"]
    m1 = tp.main(base)
    assert np.isfinite(m1["loss"])
    assert torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)["step"] == 4
    m2 = tp.main(base + ["--resume"])
    assert np.isfinite(m2["loss"])
    assert torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)["step"] == 8
