"""The port's ReID trainer against ``vqvae2_tpu.train.reid``: the data (SYSU
part-mode items, the identity sampler, ``collate``, the prefetched epoch rows)
bit-equal for one seed; ``make_loss_fn``'s total and every metric; one and two
SGD steps and one step of two microbatches (``grad_accum = 2``) through
``make_train_step``, with the parameter groups' learning rates; and the
command line: ``main(["--synthetic", "--device", "cpu", ...])`` for two steps,
``--bf16`` taken (bf16 model, fp32 losses), the default device refused without
a card.

Model: ``EmbedNet2`` (resnet18) at 128x64, P = K = 2 (12 images a step), seeded
weights carried across by ``embed_net2_from_jax``.  The parsing head's dropout
is replaced by the identity on both sides (flax's ``nn.Dropout`` and the port's
``part_model.dropout``).

Tolerances: the metrics rtol 1e-4 / atol 1e-5.  The second step starts from
the JAX side's state after the first (parameters, statistics, momentum), so
both steps are held from the same start.  A step's change of the parameters
of one learning-rate group, as one vector, within 3e-2 of its norm; each
tensor's change within 1e-1 of its own norm or of the group's mean norm a
tensor, whichever is larger.  Those are loose, and measured: the fp32
gradient of this train-mode network (batch norms over few rows, the PSP 1x1
stage one row an image) is ill-conditioned.  Against a float64 backward of the
port, the port's fp32 gradient is off by 1e-3 to 7e-3 of its norm and the JAX
package's by 1.5e-3 to 1.4e-2, per output of the model; a few tensors of the
trunk (``trunk.layer3.1``, the PSP stages) move by 2e-2 to 1.3e-1 of their own
change with the rounding alone.  The two fp32 steps differ by 1.2e-2 of a
group's change at most.  A wrong term or sign moves a change by its own size.
The batch-norm buffers within 1e-4 of their largest element.
"""

import argparse
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.data import datasets as jds
from vqvae2_tpu.data import sysu as jsysu
from vqvae2_tpu.part.part_model import EmbedNet2 as JEmbedNet2
from vqvae2_tpu.train import reid as jtr
from vqvae2_tpu_torch.data import datasets as tds
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.part import part_model as tp
from vqvae2_tpu_torch.train import reid as ttr
from vqvae2_tpu_torch.utils.jax_import import embed_net2_from_jax

HW = (128, 64)
P, K = 2, 2
LR = 0.1
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
LATER_METRIC_TOL = dict(rtol=1e-3, atol=1e-5)
STEP_RTOL = 3e-2
TENSOR_RTOL = 1e-1
BUFFER_RTOL = 1e-4


def host(tree):
    """numpy copies (the JAX train step donates its state)."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def seeded(shapes, seed):
    """He-scaled kernels, scales 1 +- 0.1 (flax's 0 for the non-local blocks'
    output scale), biases and means +- 0.1, variances in [0.5, 1.5]."""
    g = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(k, "key", str(k)) for k in path]
        leaf = keys[-1]
        if leaf in ("var", "running_var"):
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "running_mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf in ("scale", "weight"):
            return np.zeros(s.shape, np.float32) if "W_bn" in keys else (
                1 + g.normal(0, 0.1, s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt((2.0 if len(s.shape) == 4 else 1.0) / fan)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def sysu_dir(tmp_path_factory):
    return jtr.make_synthetic_sysu(str(tmp_path_factory.mktemp("sysu")), n_ids=3, per_id=4,
                                   h=HW[0], w=HW[1])


def batches(sysu_dir, n, seed=0):
    """``n`` collated P×K batches from one epoch of the port's data."""
    ds = tsysu.SYSUData(sysu_dir, part=True, seed=seed)
    ds.samplize(P, K)
    it = tds.epoch_row_batches(ds, P * K)
    out = [ttr.collate(next(it), HW) for _ in range(n)]
    it.close()
    return out


def test_data_is_the_jax_packages_bit_for_bit(sysu_dir, tmp_path):
    ours = ttr.make_synthetic_sysu(str(tmp_path), n_ids=3, per_id=4, h=HW[0], w=HW[1])
    for name in sorted(os.listdir(sysu_dir)):
        np.testing.assert_array_equal(np.load(os.path.join(ours, name)),
                                      np.load(os.path.join(sysu_dir, name)))
    jd, td = jsysu.SYSUData(sysu_dir, part=True, seed=3), tsysu.SYSUData(sysu_dir, part=True,
                                                                         seed=3)
    for epoch in range(2):
        js, ts = jd.samplize(P, K), td.samplize(P, K)
        np.testing.assert_array_equal(ts.index1, js.index1)
        np.testing.assert_array_equal(ts.index2, js.index2)
        want = [jtr.collate(rows, HW) for rows in jds.epoch_row_batches(jd, P * K)]
        got = [ttr.collate(rows, HW) for rows in tds.epoch_row_batches(td, P * K)]
        assert len(got) == len(want) == len(td) // (P * K)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetch_raises_the_producers_error_and_stops_when_left():
    def boom():
        yield 1
        raise KeyError("producer")

    it = tds.prefetch_iter(boom)
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)
    it = tds.prefetch_iter(lambda: iter(range(100)), depth=1)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()                          # the producer thread is told to stop


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(tp, "dropout", lambda x, *a, **k: x)


@pytest.fixture(scope="module")
def both_models():
    jmod = JEmbedNet2(class_num=3, arch="resnet18")
    probe = jnp.zeros((1, *HW, 3))
    variables = seeded(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), xRGB=probe, xIR=probe, xZ=probe, modal=0, train=True)), 11)
    return jmod, variables


def port_state(variables, steps_per_epoch=10):
    model = ttr.EmbedNet2(class_num=3, arch="resnet18")
    model.load_state_dict(embed_net2_from_jax(variables))
    tx = ttr.make_optimizer(LR, steps_per_epoch)
    return model, tx, ttr.create_state(model, tx)


def jax_state(jmod, variables, steps_per_epoch=10):
    tx = jtr.make_optimizer(LR, steps_per_epoch)
    state = jtr.ReidState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    return tx, state


def assert_same_state(model, before, jvars, jbefore):
    """The change of each group's parameters (as one vector) within
    STEP_RTOL of its norm, every tensor's change within TENSOR_RTOL of its own
    norm or of the group's mean norm a tensor, whichever is larger; the
    buffers within BUFFER_RTOL of their largest element."""
    want = embed_net2_from_jax(host(jvars))
    want_before = embed_net2_from_jax(host(jbefore))
    got = model.state_dict()
    groups = {}
    for name, _ in model.named_parameters():
        d_got = (got[name] - before[name]).double()
        d_want = (want[name] - want_before[name]).double()
        groups.setdefault(ttr.param_group(name), []).append((name, d_got, d_want))
    for group, items in groups.items():
        err = float(sum(torch.sum((a - b) ** 2) for _, a, b in items)) ** 0.5
        norm = float(sum(torch.sum(b ** 2) for _, _, b in items)) ** 0.5
        assert err <= STEP_RTOL * norm, (group, err, norm)
        mean_norm = norm / len(items) ** 0.5
        for name, a, b in items:
            t_err, t_norm = float(torch.linalg.norm(a - b)), float(torch.linalg.norm(b))
            assert t_err <= TENSOR_RTOL * max(t_norm, mean_norm), (name, t_err, t_norm, mean_norm)
    for name, buf in model.named_buffers():
        w = want[name].numpy()
        err = float(np.abs(buf.numpy() - w).max())
        assert err <= BUFFER_RTOL * float(np.abs(w).max()), (name, err)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_momentum(opt_state):
    """The SGD momentum of every parameter, from the traces of the two groups
    of the optax state, as a port ``state_dict``."""
    from flax import traverse_util
    import optax

    merged = {}
    for _, trace in optax.tree_utils.tree_get_all_with_path(opt_state, "trace"):
        for path, leaf in traverse_util.flatten_dict(trace).items():
            if not isinstance(leaf, optax.MaskedNode):
                merged[path] = np.asarray(leaf)
    return embed_net2_from_jax({"params": traverse_util.unflatten_dict(merged)})


def sync(model, optimizer, state):
    """Put the JAX state (parameters, statistics, momentum) into the port's."""
    model.load_state_dict(embed_net2_from_jax(host(
        {"params": state.params, "batch_stats": state.batch_stats})))
    momentum = jax_momentum(state.opt_state)
    for name, p in model.named_parameters():
        optimizer.state[p]["momentum_buffer"] = momentum[name].clone()


def test_loss_metrics_and_two_sgd_steps(sysu_dir, both_models, no_dropout):
    """Two steps; the second from the JAX side's state after the first
    (parameters, statistics and momentum carried across), so each step is
    held from the same start: the second one's Nesterov update has a
    momentum."""
    jmod, variables = both_models
    data = batches(sysu_dir, 2)
    tx, state = jax_state(jmod, variables)
    step = jtr.make_train_step(jmod, tx, K, P, HW)
    model, ttx, tstate = port_state(variables)
    tstep = ttr.make_train_step(model, ttx, K, P, HW)
    for i, batch in enumerate(data):
        if i:
            sync(model, tstate.optimizer, state)
            assert all(float(v.abs().max()) > 0 for v in jax_momentum(state.opt_state).values()
                       if v.ndim > 1)
        jbefore = host({"params": state.params, "batch_stats": state.batch_stats})
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, jm = step(state, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, to_torch(batch))
        assert set(tm) == set(jm) == {"loss", "id", "tri", "part", "unsup", "id_parts", "c2g",
                                      "acc"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC_TOL, err_msg=k)
        jvars = {"params": state.params, "batch_stats": state.batch_stats}
        assert_same_state(model, before, jvars, jbefore)
        assert tstate.step == int(state.step) == i + 1


def test_one_step_of_two_microbatches(sysu_dir, both_models, no_dropout):
    jmod, variables = both_models
    micro = batches(sysu_dir, 2, seed=1)
    tx, state = jax_state(jmod, variables)
    step = jtr.make_train_step(jmod, tx, K, P, HW, grad_accum=2)
    stacked = {k: jnp.asarray(np.stack([b[k] for b in micro])) for k in micro[0]}
    jbefore = host({"params": state.params, "batch_stats": state.batch_stats})
    new, jm = step(state, stacked, jax.random.PRNGKey(0))
    model, ttx, tstate = port_state(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tstate, tm = ttr.make_train_step(model, ttx, K, P, HW, grad_accum=2)(
        tstate, [to_torch(b) for b in micro])
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC_TOL, err_msg=k)
    assert_same_state(model, before, {"params": new.params, "batch_stats": new.batch_stats},
                      jbefore)
    with pytest.raises(ValueError, match="2 microbatches"):
        ttr.make_train_step(model, ttx, K, P, HW, grad_accum=2)(tstate, [to_torch(micro[0])])


def test_parameter_groups_and_their_learning_rates():
    """Only the top-level bottleneck and classifier take the full rate; every
    other parameter (classifierP, clsP_*, pd included) 0.01 of it; both drop
    by 10 at epochs 20, 40, 60, 100 by the updates made before the step."""
    model = ttr.EmbedNet2(class_num=3, arch="resnet18")
    tx = ttr.make_optimizer(0.1, steps_per_epoch=5)
    opt = tx.build(model)
    names = {id(p): n for n, p in model.named_parameters()}
    groups = {g["group"]: {names[id(p)] for p in g["params"]} for g in opt.param_groups}
    assert groups["cls"] == {"bottleneck.weight", "classifier.weight"}
    assert {"classifierP.weight", "clsP_bn.0.weight", "clsP_fc.5.bias", "pd.2.1.weight",
            "part.context_encoding.bottleneck.abn.weight"} <= groups["base"]
    for g in opt.param_groups:
        assert g["momentum"] == 0.9 and g["nesterov"] and g["weight_decay"] == 5e-4
    for step, scale in ((0, 1.0), (99, 1.0), (100, 0.1), (200, 0.01), (500, 1e-4)):
        tx.apply(opt, step)
        lrs = {g["group"]: g["lr"] for g in opt.param_groups}
        assert lrs["cls"] == pytest.approx(0.1 * scale) and lrs["base"] == pytest.approx(
            0.001 * scale)


def test_main_trains_two_steps_on_the_cpu(tmp_path):
    """The command line at a small size: two steps, a validation on a raw
    tree, a part-parsing grid, the metrics and the checkpoints."""
    from PIL import Image

    raw = tmp_path / "SYSU-MM01"                      # cam1..cam6/<id>/<n>.jpg
    (raw / "exp").mkdir(parents=True)
    (raw / "exp" / "test_id.txt").write_text("1,2,3\n")
    g = np.random.default_rng(12)
    for cam in range(1, 7):
        for pid in (1, 2, 3):
            (raw / f"cam{cam}" / f"{pid:04d}").mkdir(parents=True)
            Image.fromarray(g.integers(0, 255, size=(64, 32, 3)).astype(np.uint8)).save(
                raw / f"cam{cam}" / f"{pid:04d}" / "0001.jpg")
    csv, ckpt = str(tmp_path / "m.csv"), str(tmp_path / "ck")
    m = ttr.main(["--synthetic", "--device", "cpu", "--arch", "resnet18", "--img_h", "64",
                  "--img_w", "32", "--batch_size", "2", "--num_pos", "2", "--steps", "2",
                  "--log_every", "1", "--metrics_csv", csv, "--ckpt_dir", ckpt,
                  "--eval_every", "1", "--eval_path", str(raw), "--map_csv",
                  str(tmp_path / "map.csv"), "--sample_dir", str(tmp_path / "s"),
                  "--sample_every", "2"])
    assert np.isfinite(m["loss"]) and 0.0 <= m["mAP"] <= 1.0
    with open(csv) as f:
        assert len(f.read().strip().splitlines()) == 3
    saved = torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)
    assert saved["step"] == 2 and "classifier.weight" in saved["model"]
    assert os.path.exists(os.path.join(ckpt, "best.pt"))
    assert os.path.exists(str(tmp_path / "s" / "part_00002.png"))


def test_bf16_losses_run_in_fp32_on_the_widened_outputs(sysu_dir):
    """``--bf16`` builds EmbedNet2 with bf16 compute; its parsing maps and
    part masks come out bf16 and are widened at the model's boundary, so
    every loss and metric is fp32 and finite, and each parameter gets an fp32
    gradient."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = tp.EmbedNet2(class_num=3, arch="resnet18", dtype=torch.bfloat16)
    batch = to_torch(batches(sysu_dir, 1)[0])
    out = model.train()(xRGB=batch["rgb"], xIR=batch["ir"], xZ=batch["gray"], modal=0,
                        generator=torch.Generator().manual_seed(0))
    assert out[2][0][0].dtype == out[6].dtype == torch.bfloat16
    assert out[0].dtype == out[1].dtype == torch.float32
    total, metrics = ttr.make_loss_fn(model, K, P, HW)(batch, torch.Generator().manual_seed(0))
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v)) for v in metrics.values())
    total.backward()
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters())


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    assert ttr.build_argparser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttr.main(["--synthetic", "--steps", "1", "--ckpt_dir", str(tmp_path / "ck")])
    assert os.listdir(str(tmp_path)) == []
