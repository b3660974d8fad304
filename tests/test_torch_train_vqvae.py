"""The port's stage-1 trainer against the JAX package's: the same toy VQ-VAE
(channel 16, one residual block, D = 8, K = 16), its parameters and all three
codebook buffers carried across (``vqvae_from_jax``), a fresh Adam on both
sides, the same numpy batches.  After one and two ``make_train_step`` steps,
and after one step of two microbatches: the metrics, every parameter and
every codebook buffer.  Then the command line: ``main`` writes ``last.pt`` and
``config.json``, and ``extract_codes.main --ckpt_dir`` reads them back.

Tolerance: rtol 1e-4 / atol 1e-5 (fp32 convolutions and sums in another
order; one Adam update moves a parameter by at most the lr, 3e-4).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae2_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae2_tpu.train import vqvae as jtv
from vqvae2_tpu_torch.models import VQVAE
from vqvae2_tpu_torch.train import extract_codes
from vqvae2_tpu_torch.train import vqvae as tv
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import vqvae_from_jax

RTOL, ATOL = 1e-4, 1e-5
CFG = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)
SIZE, BATCH, LR = 16, 4, 3e-4


def host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def jax_start():
    """The JAX model's variables with codebooks at the scale of the encoder's
    outputs (an untrained encoder sends every row to one unit-normal code)."""
    jmodel = JaxVQVAE(**CFG)
    variables = host(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    g = np.random.default_rng(0)
    for q in ("quantize_t", "quantize_b"):
        embed = (0.05 * g.normal(size=(16, 8))).astype(np.float32)
        variables["vq_stats"][q] = {"embed": embed, "embed_avg": embed.copy(),
                                    "cluster_size": g.uniform(size=16).astype(np.float32)}
    return jmodel, variables


def batches(n, shape=(BATCH, SIZE, SIZE, 3)):
    g = np.random.default_rng(1)
    return [g.normal(scale=0.5, size=shape).astype(np.float32) for _ in range(n)]


def port_state():
    _, variables = jax_start()
    model = VQVAE(**CFG)
    model.load_state_dict(vqvae_from_jax(variables))
    return model, tv.create_state(model, schedules.adam(LR))


def jax_state():
    jmodel, variables = jax_start()
    tx = optax.adam(LR)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtv.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           vq_stats=jax.tree_util.tree_map(jnp.asarray, variables["vq_stats"]),
                           opt_state=tx.init(params))
    return jmodel, tx, state


def assert_same_state(model, jstate, what):
    want = vqvae_from_jax(host({"params": jstate.params, "vq_stats": jstate.vq_stats}))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {name}")


def assert_same_metrics(got, want, what):
    assert set(got) == {"loss", "recon_mse", "latent"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_match_jax(steps):
    jmodel, tx, jstate = jax_state()
    jstep = jtv.make_train_step(jmodel, tx)
    model, state = port_state()
    step = tv.make_train_step(model, schedules.adam(LR))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i, x in enumerate(batches(steps)):
        jstate, jm = jstep(jstate, jnp.asarray(x))
        state, m = step(state, torch.from_numpy(x))
        assert_same_metrics(m, jm, f"step {i}")
    assert state.step == int(jstate.step) == steps
    assert_same_state(model, jstate, f"after {steps} steps")
    # every parameter and every buffer moved
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)


def test_grad_accum_matches_the_jax_scan():
    """Two microbatches of two: each takes its own EMA step, the gradients are
    averaged, one Adam update."""
    jmodel, tx, jstate = jax_state()
    model, state = port_state()
    x = batches(1)[0].reshape(2, BATCH // 2, SIZE, SIZE, 3)
    jstate, jm = jtv.make_train_step(jmodel, tx, grad_accum=2)(jstate, jnp.asarray(x))
    state, m = tv.make_train_step(model, schedules.adam(LR), grad_accum=2)(
        state, torch.from_numpy(x))
    assert_same_metrics(m, jm, "grad_accum=2")
    assert state.step == 1
    assert_same_state(model, jstate, "grad_accum=2")


def test_eval_step_leaves_the_codebooks_alone():
    jmodel, _, jstate = jax_state()
    model, state = port_state()
    x = batches(1)[0]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    dec = tv.make_eval_step(model)(state, x)
    want = jtv.make_eval_step(jmodel)(jstate, jnp.asarray(x))
    np.testing.assert_allclose(dec.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_uint8_batches_are_normalised_on_the_device():
    model, state = port_state()
    x = np.random.default_rng(2).integers(0, 256, size=(BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    _, m = tv.make_train_step(model, schedules.adam(LR))(state, x)
    model2, state2 = port_state()
    _, m2 = tv.make_train_step(model2, schedules.adam(LR))(
        state2, torch.from_numpy(x.astype(np.float32) / 127.5 - 1.0))
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(m2[k]), rtol=1e-6)


TINY_ARGS = ["--size", "32", "--batch_size", "4", "--channel", "16", "--n_res_block", "1",
             "--n_res_channel", "8", "--embed_dim", "8", "--n_embed", "16", "--workers", "0",
             "--log_every", "1", "--device", "cpu"]


def test_main_writes_last_and_config_and_extraction_reads_them(tmp_path):
    ckpt = str(tmp_path / "vqvae")
    metrics = tv.main(["--synthetic", "--steps", "2", "--ckpt_dir", ckpt,
                       "--metrics_csv", str(tmp_path / "m.csv"), *TINY_ARGS])
    assert set(metrics) == {"loss", "recon_mse", "latent"} and np.isfinite(metrics["loss"])
    assert sorted(os.listdir(ckpt)) == ["config.json", "last.pt"]
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["channel"] == 16 and cfg["embed_dim"] == 8 and cfg["device"] == "cpu"
    saved = torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)
    assert saved["step"] == 2 and set(saved) == {"model", "optimizer", "step"}
    lines = (tmp_path / "m.csv").read_text().splitlines()
    assert lines[0] == "step,img_per_s,latent,loss,recon_mse" and len(lines) == 3

    out = str(tmp_path / "codes.vq2")
    n = extract_codes.main(["--synthetic", "--ckpt_dir", ckpt, "--size", "32",
                            "--batch_size", "4", "--name", out, "--device", "cpu",
                            "--workers", "0"])
    assert n == 16 and os.path.exists(out)
    # the codebooks extraction used are the trained ones
    model = VQVAE(**CFG)
    model.load_state_dict(saved["model"])
    from vqvae2_tpu_torch.data.codestore import CodeStore
    from vqvae2_tpu_torch.data.datasets import SyntheticImages

    store = CodeStore(out)
    tops, bots, _ = store.gather(np.arange(4))
    store.close()
    imgs = torch.from_numpy(np.stack([SyntheticImages(n=16, size=32)[i][0] for i in range(4)]))
    with torch.no_grad():
        id_t, id_b = model.encode_ids(imgs)
    np.testing.assert_array_equal(tops, id_t.numpy())
    np.testing.assert_array_equal(bots, id_b.numpy())


def test_grad_accum_must_divide_the_batch(tmp_path):
    with pytest.raises(SystemExit, match="not divisible"):
        tv.main(["--synthetic", "--steps", "1", "--grad_accum", "3", *TINY_ARGS])
    metrics = tv.main(["--synthetic", "--steps", "1", "--grad_accum", "2", *TINY_ARGS])
    assert np.isfinite(metrics["loss"])
