"""The port's PixelSNAIL against the JAX package's, module by module and as a
whole: the parameter tree is the one the JAX module's ``init`` defines, filled
from a numpy seed (``g`` away from the norm, biases away from zero), carried
across through ``pixelsnail_from_jax``, and the same numpy inputs go through
both, in eval mode.  The JAX side runs as compiled programs: op by op, the
first call of each primitive takes several times as long at these sizes.

Tolerance: rtol 2e-4 / atol 2e-5, what the JAX package holds its incremental
decoder to against its own full forward (fp32 convolutions and matrix products
summed in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.models import pixelsnail as jps
from vqvae2_tpu_torch.models import pixelsnail as tps
from vqvae2_tpu_torch.utils import jax_import

RTOL, ATOL = 2e-4, 2e-5

# the tiny configurations of the JAX package's incremental-decoder tests
TOP = dict(shape=(6, 6), n_class=8, channel=16, kernel_size=5, n_block=2, n_res_block=2,
           res_channel=16, dropout=0.0, n_out_res_block=1)
BOTTOM = dict(shape=(8, 8), n_class=8, channel=16, kernel_size=5, n_block=2, n_res_block=2,
              res_channel=16, attention=False, dropout=0.0, n_cond_res_block=1,
              cond_res_channel=16)


def random_variables(module, *args, seed=0, **kw):
    """Numpy values for the tree that ``module.init`` would build (traced for
    its shapes only): ``v`` at variance 1 / fan-in, ``g`` around 1, ``b`` around 0."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kw)
    g = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "v":
            return (g.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        centre = 1.0 if name == "g" else 0.0
        return (centre + 0.1 * g.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def japply(module, variables, *args, method=None, **kw):
    return jax.jit(lambda v, *a, **k: module.apply(v, *a, method=method, **k))(
        as_jax(variables), *args, **kw)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(got: torch.Tensor, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def load_wn(module, params, dense=False):
    """One weight-normalised layer's flax parameters into the port's module."""
    out = {}
    jax_import._put_wn(out, "m", params, dense=dense)
    module.load_state_dict({k[2:]: v for k, v in out.items()})


@functools.lru_cache(maxsize=None)
def make_pair(which):
    cfg = TOP if which == "top" else BOTTOM
    g = np.random.default_rng(1)
    h, w = cfg["shape"]
    codes = g.integers(0, cfg["n_class"], size=(2, h, w)).astype(np.int32)
    cond = (g.integers(0, cfg["n_class"], size=(2, h // 2, w // 2)).astype(np.int32)
            if which == "bottom" else None)
    jmodel = jps.PixelSNAIL(**cfg)
    variables = random_variables(jmodel, jnp.asarray(codes),
        condition=None if cond is None else jnp.asarray(cond))
    model = tps.PixelSNAIL(**cfg).eval()
    model.load_state_dict(jax_import.pixelsnail_from_jax(variables, model))
    return jmodel, variables, model, codes, cond


# -- modules ---------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["plain", "causal-mask"])
def test_wnconv(masked):
    g = np.random.default_rng(2)
    x = g.normal(size=(2, 7, 6, 5)).astype(np.float32)
    mask = tps.causal_kernel_mask(3, 3) if masked else None
    jmod = jps.WNConv(4, (3, 3), padding=((2, 0), (1, 1)), kernel_mask=mask)
    variables = random_variables(jmod, jnp.asarray(x), seed=3)
    mod = tps.WNConv(5, 4, (3, 3), padding=(2, 0, 1, 1), kernel_mask=mask)
    load_wn(mod, variables["params"])
    close(mod(torch.from_numpy(x)), japply(jmod, variables, jnp.asarray(x)))
    if masked:
        # the norm leaves the masked taps out: they may hold anything
        with torch.no_grad():
            before = mod.weight().clone()
            mod.v[:, :, -1, 1:] += 5.0
        assert torch.equal(mod.weight(), before)
        assert bool((before[:, :, -1, 1:] == 0).all())


def test_wnconv_initial_g_is_the_masked_norm():
    mod = tps.CausalConv(3, 4, (3, 3), "causal")
    v = mod.v.detach() * mod.kernel_mask
    torch.testing.assert_close(mod.g.detach(), v.pow(2).sum((1, 2, 3)).sqrt())
    torch.testing.assert_close(mod.weight(), v)        # w == v at the start
    assert "kernel_mask" not in mod.state_dict()       # static, not a weight


def test_wndense():
    g = np.random.default_rng(4)
    x = g.normal(size=(2, 9, 6)).astype(np.float32)
    jmod = jps.WNDense(5)
    variables = random_variables(jmod, jnp.asarray(x), seed=5)
    mod = tps.WNDense(6, 5)
    load_wn(mod, variables["params"], dense=True)
    assert tuple(mod.v.shape) == (6, 5)                # (I, O), applied as x @ w
    close(mod(torch.from_numpy(x)), japply(jmod, variables, jnp.asarray(x)))


@pytest.mark.parametrize("mode,kernel", [("downright", (3, 2)), ("down", (2, 5)),
                                         ("causal", (5, 5))])
def test_causal_conv(mode, kernel):
    g = np.random.default_rng(6)
    x = g.normal(size=(2, 6, 7, 3)).astype(np.float32)
    jmod = jps.CausalConv(4, kernel, mode)
    variables = random_variables(jmod, jnp.asarray(x), seed=7)
    mod = tps.CausalConv(3, 4, kernel, mode)
    load_wn(mod, variables["params"])
    got = mod(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 6, 7, 4)
    close(got, japply(jmod, variables, jnp.asarray(x)))


def test_shifts():
    x = np.random.default_rng(8).normal(size=(2, 4, 5, 3)).astype(np.float32)
    for size in (1, 2):
        close(tps.shift_down(torch.from_numpy(x), size), jps.shift_down(jnp.asarray(x), size))
        close(tps.shift_right(torch.from_numpy(x), size), jps.shift_right(jnp.asarray(x), size))


@pytest.mark.parametrize("branch", ["aux", "condition", "neither"])
def test_gated_res_block(branch):
    g = np.random.default_rng(9)
    x = g.normal(size=(2, 5, 6, 6)).astype(np.float32)
    extra = g.normal(size=(2, 5, 6, 3)).astype(np.float32)
    kw = {"aux": dict(aux_input=jnp.asarray(extra)), "condition": dict(condition=jnp.asarray(extra)),
          "neither": {}}[branch]
    conv = "wnconv2d" if branch == "aux" else "causal"
    jmod = jps.GatedResBlock(8, 3, conv=conv, dropout=0.1)
    variables = random_variables(jmod, jnp.asarray(x), **kw, seed=10)
    mod = tps.GatedResBlock(6, 8, 3, conv=conv, dropout=0.1,
                            aux_channel=3 if branch == "aux" else 0,
                            condition_dim=3 if branch == "condition" else 0).eval()
    out = {}
    jax_import._put_gated_res(out, "m", variables["params"])
    mod.load_state_dict({k[2:]: v for k, v in out.items()})
    tkw = {k: torch.from_numpy(extra) for k in kw}
    close(mod(torch.from_numpy(x), **tkw), japply(jmod, variables, jnp.asarray(x), **kw))


def test_causal_attention():
    g = np.random.default_rng(11)
    query = g.normal(size=(2, 5, 4, 10)).astype(np.float32)
    key = g.normal(size=(2, 5, 4, 18)).astype(np.float32)
    jmod = jps.CausalAttention(16, n_head=4, dropout=0.1)
    variables = random_variables(jmod, jnp.asarray(query), jnp.asarray(key), seed=12)
    mod = tps.CausalAttention(10, 18, 16, n_head=4, dropout=0.1).eval()
    for name in ("query", "key", "value"):
        load_wn(getattr(mod, name), variables["params"][name], dense=True)
    got = mod(torch.from_numpy(query), torch.from_numpy(key))
    close(got, japply(jmod, variables, jnp.asarray(query), jnp.asarray(key)))
    assert bool((got[:, 0, 0] == 0).all())             # the first position attends nothing
    q, k, v = mod.qkv(torch.from_numpy(query), torch.from_numpy(key))
    assert q.shape == k.shape == v.shape == (2, 4, 20, 4) and q.is_contiguous()
    # train mode drops the probabilities, drawing from an explicit generator
    mod.train()
    with pytest.raises(ValueError, match="generator"):
        mod(torch.from_numpy(query), torch.from_numpy(key))
    a, b, c = (mod(torch.from_numpy(query), torch.from_numpy(key),
                   generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.allclose(a, got)


def test_background():
    for hw in ((6, 6), (5, 8), (32, 32)):
        np.testing.assert_array_equal(tps._background(*hw), jps._background(*hw))
    model = tps.PixelSNAIL(**TOP)
    np.testing.assert_array_equal(model.background.numpy(), jps._background(6, 6))
    assert "background" not in model.state_dict()


# -- the whole model -------------------------------------------------------------

@pytest.mark.parametrize("which", ["top", "bottom"])
def test_logits(which):
    jmodel, variables, model, codes, cond = make_pair(which)
    want = japply(jmodel, variables, jnp.asarray(codes),
                        condition=None if cond is None else jnp.asarray(cond))
    with torch.no_grad():
        got = model(torch.from_numpy(codes),
                    condition=None if cond is None else torch.from_numpy(cond))
    assert tuple(got.shape) == codes.shape + (8,)
    close(got, want, which)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


def test_the_state_dict_is_covered_exactly():
    for which in ("top", "bottom"):
        _, variables, model, _, _ = make_pair(which)
        carried = jax_import.pixelsnail_from_jax(variables, model)
        assert set(carried) == set(model.state_dict())
        n_leaves = len(jax.tree_util.tree_leaves(variables))
        assert len(carried) == n_leaves


def test_compute_condition_and_cached_features():
    jmodel, variables, model, codes, cond = make_pair("bottom")
    want = japply(jmodel, variables, jnp.asarray(cond), method=jmodel.compute_condition)
    with torch.no_grad():
        feat = model.compute_condition(torch.from_numpy(cond))
        direct = model(torch.from_numpy(codes), condition=torch.from_numpy(cond))
        cached = model(torch.from_numpy(codes), condition_features=feat)
    assert tuple(feat.shape) == (2, 8, 8, 16)
    close(feat, want)                     # the 2x nearest upsample included
    assert torch.equal(direct, cached)


def test_a_smaller_grid_crops_background_and_condition():
    jmodel, variables, model, codes, cond = make_pair("bottom")
    want = japply(jmodel, variables, jnp.asarray(codes[:, :5, :6]), condition=jnp.asarray(cond))
    with torch.no_grad():
        got = model(torch.from_numpy(codes[:, :5, :6]), condition=torch.from_numpy(cond))
    close(got, want)


@pytest.mark.parametrize("which", ["top", "bottom"])
def test_model_causality(which):
    """Changing the codes at raster positions >= t leaves the logits at
    positions <= t unchanged."""
    _, _, model, codes, cond = make_pair(which)
    h, w = codes.shape[1:]
    t = (h // 2) * w + 2
    changed = codes.copy().reshape(2, -1)
    changed[:, t:] = (changed[:, t:] + 3) % 8
    cond_t = None if cond is None else torch.from_numpy(cond)
    with torch.no_grad():
        a = model(torch.from_numpy(codes), condition=cond_t).reshape(2, h * w, -1)
        b = model(torch.from_numpy(changed.reshape(codes.shape)), condition=cond_t).reshape(2, h * w, -1)
    torch.testing.assert_close(a[:, : t + 1], b[:, : t + 1], rtol=0, atol=1e-6)
    assert not torch.allclose(a[:, t + 1:], b[:, t + 1:])


def test_build_model_gives_the_two_reference_configurations():
    """What ``vqvae2_tpu/train/pixelsnail.py::build_model`` fixes (its module
    is not imported here: it pulls in the whole JAX trainer): kernel 5, four
    blocks, attention on the top prior only, the bottom prior conditioned with
    ``cond_res_channel = n_res_channel``, the grids from ``code_hw``."""
    import argparse

    from vqvae2_tpu_torch.train.pixelsnail import build_model

    args = argparse.Namespace(n_class=12, channel=16, n_res_block=3, n_res_channel=8,
                              n_out_res_block=1, n_cond_res_block=2, dropout=0.1, bf16=False)
    common = dict(n_class=12, channel=16, kernel_size=5, n_block=4, n_res_block=3,
                  res_channel=8, dropout=0.1, cond_res_kernel=3)
    top = build_model("top", args, code_hw=(4, 8))
    assert top.config == dict(common, shape=(4, 4), attention=True, n_cond_res_block=0,
                              cond_res_channel=0, n_out_res_block=1)
    bottom = build_model("bottom", args, code_hw=(4, 8))
    assert bottom.config == dict(common, shape=(8, 8), attention=False, n_cond_res_block=2,
                                 cond_res_channel=8, n_out_res_block=0)
    # the same fields, by the same names, configure the JAX module
    for model in (top, bottom):
        jmodel = jps.PixelSNAIL(**model.config)
        assert all(getattr(jmodel, k) == v for k, v in model.config.items())


def test_dropout_follows_the_mode_and_the_generator():
    """``dropout`` is flax's inverted dropout, drawn from the generator it is
    given: a no-op in eval mode or at rate 0, repeatable for one seed, and
    refused in train mode without a generator."""
    x = torch.ones(4, 64, 64)
    assert tps.dropout(x, 0.5, False, None) is x and tps.dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        tps.dropout(x, 0.5, True, None)
    a = tps.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    assert torch.equal(a, tps.dropout(x, 0.25, True, torch.Generator().manual_seed(0)))
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.02


def test_train_mode_draws_every_dropout_from_the_generator():
    _, _, model, codes, cond = make_pair("bottom")
    model = tps.PixelSNAIL(**dict(BOTTOM, dropout=0.2))
    model.load_state_dict(make_pair("bottom")[2].state_dict())
    c, t = torch.from_numpy(codes), torch.from_numpy(cond)
    with torch.no_grad():
        want = model.eval()(c, condition=t)
        model.train()
        with pytest.raises(ValueError, match="generator"):
            model(c, condition=t)
        a, b, other = (model(c, condition=t, generator=torch.Generator().manual_seed(s))
                       for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, other) and not torch.allclose(a, want)
