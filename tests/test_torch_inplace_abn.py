"""The port's in-place activated batch norm (plain PyTorch path, which is what
runs on a CPU tensor) against the JAX package's, on the same numpy inputs made
from a seed: the op on the CPU (its XLA path), the two Pallas kernel bodies in
interpret mode, ``jax.grad`` through the op with the moments as functions of
x, eval mode, bf16 storage, the elu clamp, and the ``InPlaceABN`` / ``ABN``
modules with their running statistics.

Tolerances: forward 1e-5 (fp32, one product and one add in another order);
gradients rtol 2e-4 / atol 2e-5, what the JAX package holds its own vjp to
against autodiff (``tests/test_inplace_abn.py``); bf16 outputs one bf16 step
(2^-8 relative) apart at most, where a rounding of the fp32 result can land on
either side.  The CUDA kernels cannot run here: ``chip_smoke.py`` holds them
against the same plain version on the card.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.models import abn as jabn
from vqvae2_tpu_torch.models.abn import ABN, InPlaceABN
from vqvae2_tpu_torch.ops import inplace_abn as ta
from vqvae2_tpu_torch.utils.jax_import import embed_net2_from_jax

# the JAX package's ops/__init__ re-exports the function under the module's name
ja = importlib.import_module("vqvae2_tpu.ops.inplace_abn")

ACTS = [ta.ACT_LEAKY_RELU, ta.ACT_ELU, ta.ACT_NONE]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _case(shape=(4, 5, 5, 16), seed=0, negative_weights=True):
    g = np.random.default_rng(seed)
    c = shape[-1]
    x = g.normal(loc=0.3, size=shape).astype(np.float32)
    w = g.normal(size=(c,)).astype(np.float32)
    if not negative_weights:
        w = np.abs(w) + 0.5
    b = g.normal(size=(c,)).astype(np.float32)
    return x, w, b


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("activation", ACTS)
def test_forward_matches_the_jax_op(activation):
    x, w, b = _case()
    mean, var = ja.batch_moments(jnp.asarray(x))
    z = ja.inplace_abn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mean, var, 1e-5,
                       activation, 0.01, None, True)
    tm, tv = ta.batch_moments(_t(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(mean), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(var), **TOL)
    ta.reset_counts()
    got = ta.inplace_abn(_t(x), _t(w), _t(b), tm, tv, 1e-5, activation, 0.01, True)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(z), **TOL)
    assert ta.plain_counts == {"abn_forward": 1, "abn_backward": 0}
    assert ta.launch_counts == {"abn_forward": 0, "abn_backward": 0}


def _interpret(fn, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args))


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("m,c", [(37, 16), (1030, 48), (5, 3)])
def test_plain_versions_match_the_interpreted_pallas_kernels(activation, m, c):
    """The plain forward and ``dx`` against ``_fwd_kernel`` / ``_bwd_kernel``
    as Pallas interprets them (M not a multiple of the 1024-row block, C = 3)."""
    g = np.random.default_rng(m + c)
    x = g.normal(size=(m, c)).astype(np.float32)
    mean = g.normal(scale=0.1, size=(c,)).astype(np.float32)
    scale = g.normal(size=(c,)).astype(np.float32)
    shift = g.normal(size=(c,)).astype(np.float32)
    want = _interpret(ja._abn_fwd_launch, jnp.asarray(x), jnp.asarray(mean), jnp.asarray(scale),
                      jnp.asarray(shift), activation, 0.01, jnp.float32)
    z = ta.abn_forward_reference(_t(x), _t(mean), _t(scale), _t(shift), activation, 0.01)
    np.testing.assert_allclose(z.numpy(), want, **TOL)

    dz = g.normal(size=(m, c)).astype(np.float32)
    w_t = (np.abs(scale) + 1e-5).astype(np.float32)
    mul = (w_t * g.uniform(0.5, 2.0, size=(c,))).astype(np.float32)
    dx, edz, eydz = ta.abn_backward_reference(z, _t(dz), _t(shift), _t(w_t), _t(mul), 1.0 / m,
                                              True, activation, 0.01)
    inv = np.float32(1.0 / m)
    want = _interpret(ja._abn_bwd_launch, jnp.asarray(z.numpy()), jnp.asarray(dz),
                      jnp.asarray(shift), jnp.asarray(1.0 / w_t), jnp.asarray(mul),
                      jnp.asarray(edz.numpy() * inv), jnp.asarray(eydz.numpy() * inv),
                      activation, 0.01)
    np.testing.assert_allclose(dx.numpy(), want, **TOL)


def _unfused(x, w, b, mean, var, activation, eps=1e-5, slope=0.01):
    y = (x - mean) * jax.lax.rsqrt(var + eps) * (jnp.abs(w) + eps) + b
    return ja._act_fwd(y, activation, slope)


@pytest.mark.parametrize("activation", ACTS)
def test_gradients_match_jax_grad_through_the_moments(activation):
    """dx, dw, db from the autograd binding (the plain backward on the CPU)
    against ``jax.grad`` of the JAX op and of autodiff through the unfused
    expression with differentiable moments."""
    x, w, b = _case((2, 3, 3, 8), seed=1)

    def jax_loss(fused):
        def loss(x, w, b):
            mean, var = ja.batch_moments(x)
            if fused:
                z = ja.inplace_abn(x, w, b, jax.lax.stop_gradient(mean),
                                   jax.lax.stop_gradient(var), 1e-5, activation, 0.01, None, True)
            else:
                z = _unfused(x, w, b, mean, var, activation)
            return jnp.sum(jnp.sin(z))
        return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))

    xt, wt, bt = (_t(a).clone().requires_grad_() for a in (x, w, b))
    ta.reset_counts()
    mean, var = ta.batch_moments(xt)
    torch.sum(torch.sin(ta.inplace_abn(xt, wt, bt, mean, var, 1e-5, activation))).backward()
    assert ta.plain_counts == {"abn_forward": 1, "abn_backward": 1}
    for want in (jax_loss(True), jax_loss(False)):
        for name, got, exp in zip("xwb", (xt.grad, wt.grad, bt.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp), **GRAD_TOL,
                                       err_msg=f"d{name}")


def test_eval_mode_gradient_has_zero_sums():
    """Eval mode: the moments are constants, ``edz`` and ``eydz`` are zero and
    so are ``dw`` and ``db``."""
    x, w, b = _case((2, 3, 3, 4), seed=2, negative_weights=False)
    g = np.random.default_rng(3)
    mean = g.normal(size=(4,)).astype(np.float32)
    var = g.uniform(0.5, 2.0, size=(4,)).astype(np.float32)

    def loss(x):
        return jnp.sum(jnp.sin(ja.inplace_abn(x, jnp.asarray(w), jnp.asarray(b),
                                              jnp.asarray(mean), jnp.asarray(var), 1e-5,
                                              ta.ACT_LEAKY_RELU, 0.01, None, False)))

    want = jax.grad(loss)(jnp.asarray(x))
    xt, wt, bt = (_t(a).clone().requires_grad_() for a in (x, w, b))
    torch.sum(torch.sin(ta.inplace_abn(xt, wt, bt, _t(mean), _t(var), training=False))).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not wt.grad.any() and not bt.grad.any()
    z2d = _t(x).reshape(-1, 4)
    _, edz, eydz = ta.abn_backward_reference(z2d, z2d, _t(b), _t(w), _t(w), 0.0, False)
    assert not edz.any() and not eydz.any()


@pytest.mark.parametrize("activation", [ta.ACT_LEAKY_RELU, ta.ACT_ELU])
def test_bf16_storage_matches_the_jax_op(activation):
    """bf16 in, fp32 channel math, bf16 out; the gradient sums in fp32 and dx
    back in bf16 — against the JAX op on the same bf16 values."""
    x, w, b = _case((4, 3, 5, 16), seed=4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    mean, var = ja.batch_moments(xb)
    z = ja.inplace_abn(xb, jnp.asarray(w), jnp.asarray(b), mean, var, 1e-5, activation, 0.01,
                       None, True)
    xt = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    tm, tv = ta.batch_moments(xt)
    np.testing.assert_allclose(tm.numpy(), np.asarray(mean), **TOL)
    got = ta.inplace_abn(xt, _t(w), _t(b), tm, tv, 1e-5, activation)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(z.astype(jnp.float32)), **BF16_TOL)

    # the backward from the same stored z and dz: dx in bf16, sums in fp32
    g = np.random.default_rng(5)
    z2d = _t(np.asarray(z.astype(jnp.float32))).reshape(-1, 16).to(torch.bfloat16)
    dz2d = _t(g.normal(size=(60, 16)).astype(np.float32)).to(torch.bfloat16)
    w_t = np.abs(w) + np.float32(1e-5)
    mul = w_t * np.asarray(jax.lax.rsqrt(var + 1e-5))
    inv = np.float32(1.0 / 60)
    dx, edz, eydz = ta.abn_backward_reference(z2d, dz2d, _t(b), _t(w_t), _t(mul), 1.0 / 60,
                                              True, activation)
    assert dx.dtype == torch.bfloat16 and edz.dtype == eydz.dtype == torch.float32
    want = _interpret(ja._abn_bwd_launch, jnp.asarray(z2d.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(dz2d.float().numpy()).astype(jnp.bfloat16), jnp.asarray(b),
                      jnp.asarray(1.0 / w_t), jnp.asarray(mul), jnp.asarray(edz.numpy() * inv),
                      jnp.asarray(eydz.numpy() * inv), activation, 0.01)
    np.testing.assert_allclose(dx.float().numpy(), want.astype(np.float32), **BF16_TOL)


def test_elu_clamp_keeps_the_asymptote_finite():
    """bf16 storage rounds elu outputs near -1 onto -1 exactly, where log1p is
    -inf; the clamp at -1 + 1e-6 gives finite y, dx and sums, as in the JAX
    package."""
    z = torch.tensor([[-1.0, -0.5, 0.25], [-1.0, 2.0, -1.0]], dtype=torch.bfloat16)
    dz = torch.ones_like(z)
    ones = torch.ones(3)
    dx, edz, eydz = ta.abn_backward_reference(z, dz, torch.zeros(3), ones, ones, 0.5, True,
                                              ta.ACT_ELU)
    assert torch.isfinite(dx.float()).all() and torch.isfinite(edz).all()
    assert torch.isfinite(eydz).all()
    y, dy = ta.act_invert(z.float(), dz.float(), ta.ACT_ELU, 0.01)
    jy, jdy = ja._act_invert(jnp.asarray(z.float().numpy()), jnp.asarray(dz.float().numpy()),
                             ta.ACT_ELU, 0.01)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(dy.numpy(), np.asarray(jdy))
    assert float(y[0, 0]) == pytest.approx(np.log1p(np.float32(ta.ELU_CLAMP)), rel=1e-6)


def _flax_vars(module, x, seed):
    v = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    g = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda a: (a + g.normal(scale=0.3, size=a.shape))
                                    .astype(np.float32), v["params"])
    return {"params": params, "batch_stats": v["batch_stats"]}


@pytest.mark.parametrize("activation", ACTS)
def test_inplace_abn_module_and_its_running_stats(activation):
    """Train mode twice (the running statistics with the unbiased
    ``count / (count - 1)``), then eval mode on the moved statistics, against
    the flax module; one gradient of the train-mode output."""
    x = np.random.default_rng(6).normal(loc=2.0, scale=3.0, size=(4, 5, 5, 8)).astype(np.float32)
    jm = jabn.InPlaceABN(num_features=8, activation=activation)
    variables = _flax_vars(jm, x, 7)
    tm = InPlaceABN(8, activation=activation)
    tm.load_state_dict(embed_net2_from_jax(variables))
    xt = _t(x).requires_grad_()
    for _ in range(2):
        z, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        variables = {**variables, **jax.tree_util.tree_map(np.asarray, new)}
        got = tm.train()(xt)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(z), **TOL)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   variables["batch_stats"][name], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.eval()(xt).detach().numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(x), train=False)), **TOL)

    def loss(p):
        z, _ = jm.apply({**variables, "params": p}, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
        return jnp.sum(jnp.cos(z))

    want = jax.grad(loss)(variables["params"])
    tm.train()
    torch.sum(torch.cos(tm(_t(x)))).backward()
    np.testing.assert_allclose(tm.weight.grad.numpy(), np.asarray(want["weight"]), **GRAD_TOL)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(want["bias"]), **GRAD_TOL)


def test_count_of_one_row_divides_by_zero_as_the_jax_package_does():
    """One row a channel (the PSP 1x1 stage at batch 1): ``count - 1 = 0``."""
    x = np.ones((1, 1, 1, 4), np.float32)
    with pytest.raises(ZeroDivisionError):
        jabn.InPlaceABN(4).apply(jabn.InPlaceABN(4).init(jax.random.PRNGKey(0), jnp.asarray(x)),
                                 jnp.asarray(x), train=True, mutable=["batch_stats"])
    with pytest.raises(ZeroDivisionError):
        InPlaceABN(4).train()(_t(x))


@pytest.mark.parametrize("activation", [ta.ACT_LEAKY_RELU, ta.ACT_ELU, ta.ACT_NONE, "relu"])
def test_plain_abn_module(activation):
    """``ABN`` (flax BatchNorm + activation) in train and eval mode."""
    x = np.random.default_rng(8).normal(size=(3, 4, 4, 6)).astype(np.float32)
    jm = jabn.ABN(num_features=6, activation=activation)
    variables = _flax_vars(jm, x, 9)
    tm = ABN(6, activation=activation)
    tm.load_state_dict({f"bn.{k}": v for k, v in embed_net2_from_jax(
        {"params": variables["params"]["BatchNorm_0"],
         "batch_stats": variables["batch_stats"]["BatchNorm_0"]}).items()})
    z, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(tm.train()(_t(x)).detach().numpy(), np.asarray(z), **TOL)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(new["batch_stats"]["BatchNorm_0"]["var"]), rtol=1e-6)
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                    new["batch_stats"])}
    np.testing.assert_allclose(tm.eval()(_t(x)).detach().numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)


def test_the_wrappers_refuse_other_devices_and_activations():
    x = torch.zeros(4, 8)
    v = torch.zeros(8)
    ta.reset_counts()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ta.abn_forward(x.to("meta"), v, v, v)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ta.abn_backward(x.to("meta"), x.to("meta"), v, v, v, 0.25)
    with pytest.raises(ValueError, match="activation"):
        ta.abn_forward(x, v, v, v, activation="gelu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ta._abn_forward_cuda(x, v, v, v, ta.ACT_LEAKY_RELU, 0.01)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ta._abn_backward_cuda(x, x, v, v, v, 0.25, True, ta.ACT_LEAKY_RELU, 0.01)
    assert not any(ta.plain_counts.values()) and not any(ta.launch_counts.values())


@pytest.mark.parametrize("activation", [ta.ACT_LEAKY_RELU, ta.ACT_ELU])
def test_more_channels_than_a_shared_copy_holds_match_the_jax_op(activation):
    """C = 2049, one past what the CUDA kernels stage in shared memory (above
    it they read the channel vectors from global memory; the JAX op takes any
    C): the forward and ``jax.grad`` through the op against the port's plain
    path and its autograd binding.  ``dw`` is a sum over the 48 rows of a
    channel, which cancels in a few of 2049 channels: it is held to GRAD_TOL's
    rtol times the sum of its terms' magnitudes, as ``chip_smoke.py`` holds
    the kernel's sums, and dx, db element by element."""
    x, w, b = _case((3, 4, 4, 2049), seed=5)
    mean, var = ja.batch_moments(jnp.asarray(x))
    z = ja.inplace_abn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mean, var, 1e-5,
                       activation, 0.01, None, True)
    tm, tv = ta.batch_moments(_t(x))
    got = ta.inplace_abn(_t(x), _t(w), _t(b), tm, tv, 1e-5, activation, 0.01, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(z), **TOL)

    def loss(x, w, b):
        mean, var = ja.batch_moments(x)
        z = ja.inplace_abn(x, w, b, jax.lax.stop_gradient(mean), jax.lax.stop_gradient(var),
                           1e-5, activation, 0.01, None, True)
        return jnp.sum(jnp.sin(z))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (_t(a).clone().requires_grad_() for a in (x, w, b))
    ta.reset_counts()
    mean_t, var_t = ta.batch_moments(xt)
    torch.sum(torch.sin(ta.inplace_abn(xt, wt, bt, mean_t, var_t, 1e-5, activation))).backward()
    assert ta.plain_counts == {"abn_forward": 1, "abn_backward": 1}
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]), **GRAD_TOL, err_msg="dx")
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want[2]), **GRAD_TOL, err_msg="db")
    with torch.no_grad():
        z2d = ta.inplace_abn(xt, wt, bt, mean_t, var_t, 1e-5, activation).reshape(-1, 2049)
        y, dy = ta.act_invert(z2d, torch.cos(z2d), activation, 0.01)
        terms = ((y - bt) / (wt.abs() + 1e-5) * dy).abs().sum(0).numpy()
    err = np.abs(wt.grad.numpy() - np.asarray(want[1]))
    assert np.all(err <= GRAD_TOL["rtol"] * terms + GRAD_TOL["atol"]), float(np.max(err / terms))


# ---------------------------------------------------------------------------
# K8's row partition and its fixed summation order
# ---------------------------------------------------------------------------

# chip_smoke.py's bound on the kernel's sums against a float64 sum: each within
# this fraction of the sum of its terms' magnitudes
ABN_SUM_RTOL = 1e-5
PARTITION_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", PARTITION_DTYPES, ids=str)
@pytest.mark.parametrize("c", [3, 48, 256, 2049])
def test_row_partition_covers_each_row_once(c, dtype):
    """Whole tiles of rows dealt to the blocks: every row in exactly one tile
    of exactly one block, no block without a tile, at most
    ``PARTITION_BLOCKS`` of them, each block's tiles in rising order, from one
    row to far beyond one tile; the same again from ``(M, C, dtype)``
    alone."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    tile = max(1, ta.TILE_BYTES // (c * itemsize))
    lanes = ta.summation_lanes(c, dtype)
    for m in sorted({1, 2, 7, max(1, tile - 1), tile, tile + 1, 3 * tile + 5,
                     ta.PARTITION_BLOCKS * tile + 3, 186624}):
        tile_rows, blocks = ta.row_partition(m, c, dtype)
        assert tile_rows * c * itemsize <= max(ta.TILE_BYTES, c * itemsize)
        assert tile_rows == min(tile, m) or (tile_rows % lanes == 0 and tile - lanes < tile_rows)
        assert 1 <= blocks <= ta.PARTITION_BLOCKS
        assert blocks == min(ta.PARTITION_BLOCKS, -(-m // tile_rows))
        per_block = ta.block_tiles(m, tile_rows, blocks)
        assert len(per_block) == blocks and all(len(t) for t in per_block)
        seen = np.zeros(m, np.int64)
        for tiles in per_block:
            assert list(tiles) == sorted(tiles)
            for t in tiles:
                seen[t * tile_rows:min(m, (t + 1) * tile_rows)] += 1
        assert (seen == 1).all()
        ta.row_partition.cache_clear()
        assert ta.row_partition(m, c, dtype) == (tile_rows, blocks)
    assert list(inspect.signature(ta.row_partition).parameters) == ["m", "c", "dtype"]


def _fma32(a, b, acc):
    """float32 fma(a, b, acc): the product is exact in float64."""
    return (a.astype(np.float64) * b + acc).astype(np.float32)


def _emulated_sums(z2d, dz2d, bias_t, weight_t, activation, aligned=True):
    """``(edz, eydz)`` in float32 in K8's order: lane ``l`` of ``L`` taking
    positions ``l, l + L, ...`` of its block's rows, its tiles' rows in order
    (a sum and an FMA a row), the lanes added in order; then 32 groups of
    consecutive blocks, each summed in block order, added in order."""
    m, c = z2d.shape
    tile_rows, blocks = ta.row_partition(m, c, z2d.dtype)
    lanes = ta.summation_lanes(c, z2d.dtype, aligned)
    y, dy = ta.act_invert(z2d.float(), dz2d.float(), activation, 0.01)
    yhat = ((y - bias_t) * (1.0 / weight_t)).numpy()
    dy = dy.numpy()
    parts = np.zeros((2, blocks, c), np.float32)
    for b, tiles in enumerate(ta.block_tiles(m, tile_rows, blocks)):
        se, sy = np.zeros((2, lanes, c), np.float32)
        rows = [row for t in tiles for row in range(t * tile_rows, min(m, (t + 1) * tile_rows))]
        for p, row in enumerate(rows):
            se[p % lanes] += dy[row]
            sy[p % lanes] = _fma32(yhat[row], dy[row], sy[p % lanes])
        for k, s in enumerate((se, sy)):
            parts[k, b] = s[0]
            for lane in range(1, lanes):
                parts[k, b] += s[lane]
    out = []
    for k in range(2):
        groups = [np.zeros(c, np.float32) for _ in range(32)]
        for g in range(32):
            for b in range(g * blocks // 32, (g + 1) * blocks // 32):
                groups[g] += parts[k, b]
        total = groups[0]
        for g in range(1, 32):
            total = total + groups[g]
        out.append(total)
    return out


@pytest.mark.parametrize("activation", [ta.ACT_LEAKY_RELU, ta.ACT_ELU])
@pytest.mark.parametrize("m,c,dtype,aligned,shift", [
    (1, 48, torch.float32, True, 0.0),
    (7, 3, torch.float32, True, 0.0),
    (1031, 48, torch.float32, True, 0.0),
    (513, 256, torch.bfloat16, True, 0.0),
    (1500, 256, torch.float32, True, 0.0),
    (1031, 48, torch.float32, False, 0.0),
    (2000, 3, torch.bfloat16, True, 0.0),
    (4096, 48, torch.bfloat16, True, -40.0),    # every z far below 0: elu on its asymptote -1
], ids=lambda v: str(v))
def test_the_fixed_summation_order_stays_within_abn_sum_rtol_of_float64(
        activation, m, c, dtype, aligned, shift):
    """K8's sums as its kernels order them (the ring route, or the generic
    one where ``aligned`` is off or the rows are no whole vectors), emulated
    in float32, against a float64 sum of the same fp32 terms: within
    ABN_SUM_RTOL of the sum of the terms' magnitudes, the bound chip_smoke.py
    holds the kernel to on the card."""
    g = np.random.default_rng(m * 7 + c)
    w = g.normal(size=(c,)).astype(np.float32)
    w_t = _t(np.abs(w) + np.float32(1e-5))
    b = _t((0.3 * g.normal(size=(c,)) + shift).astype(np.float32))
    x = _t(g.normal(size=(m, c)).astype(np.float32))
    mean, var = ta.batch_moments(x)
    scale = torch.rsqrt(var + 1e-5) * w_t
    z = ta.abn_forward_reference(x.to(dtype), mean, scale, b, activation)
    dz = _t((1e-3 * g.normal(size=(m, c))).astype(np.float32)).to(dtype)
    if shift and activation == ta.ACT_ELU:
        assert float(z.float().max()) == -1.0
    edz, eydz = _emulated_sums(z, dz, b, w_t, activation, aligned)
    assert np.isfinite(edz).all() and np.isfinite(eydz).all()
    # the terms the kernel sums: the fp32 inversion and yhat, widened
    y, dy = ta.act_invert(z.float(), dz.float(), activation, 0.01)
    dy = dy.double()
    prod = ((y - b) * (1.0 / w_t)).double() * dy
    for name, got, terms in (("edz", edz, dy), ("eydz", eydz, prod)):
        err = np.abs(got - terms.sum(0).numpy())
        mag = terms.abs().sum(0).numpy()
        assert np.all(err <= ABN_SUM_RTOL * mag + 1e-30), (name, float(np.max(err / mag)))


def test_both_entries_take_the_partition_and_one_allocation(monkeypatch):
    """The host side of K8 without a card: the two C entries get the
    partition of ``row_partition`` and the caller's stream, and the sums and
    the blocks' partial rows share one allocation laid out as the entry
    expects (edz, eydz, then the scratch)."""
    calls = {}

    class Lib:
        def abn_backward_scratch_bytes(self, c, blocks):
            return 2 * blocks * c * 4

        def abn_backward_sums(self, *args):
            calls["sums"] = args
            return 0

        def abn_backward_dx(self, *args):
            calls["dx"] = args
            return 0

    monkeypatch.setattr(ta, "_library", lambda: Lib())
    m, c = 3000, 256
    z = torch.zeros(m, c)
    v = torch.ones(c)
    edz, eydz = ta._backward_sums_cuda(z, z, v, v, True, ta.ACT_ELU, 0.01, stream=7)
    ta._backward_dx_cuda(z, z, v, v, v, edz, eydz, 1.0 / m, ta.ACT_ELU, 0.01, stream=7)
    tile_rows, blocks = ta.row_partition(m, c, torch.float32)
    assert tile_rows == ta.TILE_BYTES // (4 * c) and blocks == min(ta.PARTITION_BLOCKS,
                                                                   -(-m // tile_rows))
    sums, dx = calls["sums"], calls["dx"]
    assert sums[-3:] == (tile_rows, blocks, 7) and dx[-3:] == (tile_rows, blocks, 7)
    at = sums[4]
    assert (edz.data_ptr(), eydz.data_ptr()) == (at, at + 4 * c) == dx[6:8]
    assert sums[6] == at + 8 * c and sums[7] == 2 * blocks * c * 4
    assert edz.untyped_storage().nbytes() == 8 * c + sums[7]
    ta._backward_sums_cuda(z, z, v, v, False, ta.ACT_ELU, 0.01, stream=7)
    assert calls["sums"][7] == 0 and calls["sums"][12] == 0
