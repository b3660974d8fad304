"""The port's ``models/layers.py`` against the JAX package's: flax's spectral
norm (``SNConv``, ``SNConvTranspose``) with ``update_stats`` off and on — the
output, the stored ``u`` and ``sigma`` and the gradient of the kernel against
``jax.grad`` — and that ``torch.nn.utils.spectral_norm`` in eval mode gives
another output (it skips the power iteration there, flax does not);
``InstanceNorm``, ``ResidualBlock``, ``LinearBlock`` with each activation,
``MLP`` / ``Discriminator``, ``NonLocal`` with its batch norm in train and
eval mode (and its running statistics after), and ``compute_mask``.

Inputs and weights are seeded numpy values carried across by the maps of
``utils/jax_import.py``.  Tolerance: rtol 1e-4 / atol 1e-5, the fp32 sums of
two libraries in different orders; gradients rtol 1e-4 / atol 1e-5 as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.models import layers as jl
from vqvae2_tpu_torch.models import layers as tl
from vqvae2_tpu_torch.utils import jax_import as ji

TOL = dict(rtol=1e-4, atol=1e-5)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one thread: the files run beside others in parallel
    workers, where each torch's pool of all the cores oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def seeded(shapes, seed):
    """He-scaled kernels, scales 1 +- 0.1 (also the non-local block's, which
    flax starts at 0), biases and means +- 0.1, variances in [0.5, 1.5], unit
    ``u`` vectors' directions at random, ``sigma`` 1."""
    g = np.random.default_rng(seed)

    def fill(path, s):
        leaf = getattr(path[-1], "key", str(path[-1]))
        if leaf.endswith("/sigma"):
            return np.ones(s.shape, np.float32)
        if leaf.endswith("/u"):
            return g.normal(size=s.shape).astype(np.float32)
        if leaf == "var":
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf in ("scale", "prelu_a"):
            return (1 + g.normal(0, 0.1, s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt(2.0 / fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def init(module, *args, seed=0, **kw):
    return seeded(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw)), seed)


def arrays(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), **(tol or TOL))


def sn_state(variables):
    out = {}
    ji._put_sn(out, "m", variables["params"], variables["batch_stats"])
    return {k[2:]: v for k, v in out.items()}


SN_CASES = {
    "3x3 no bias": (lambda: jl.SNConv(6, (3, 3), use_bias=False),
                    lambda: tl.SNConv(5, 6, 3, use_bias=False)),
    "1x1 with bias": (lambda: jl.SNConv(6, (1, 1)), lambda: tl.SNConv(5, 6, 1)),
    "1x1 stride 2": (lambda: jl.SNConv(6, (1, 1), strides=(2, 2)),
                     lambda: tl.SNConv(5, 6, 1, stride=2)),
    "transposed 4x4 stride 2": (lambda: jl.SNConvTranspose(6), lambda: tl.SNConvTranspose(5, 6)),
}


@pytest.mark.parametrize("update_stats", [False, True])
@pytest.mark.parametrize("case", sorted(SN_CASES))
def test_spectral_norm_is_flaxs(case, update_stats):
    """One power-iteration step from the stored ``u`` in either mode; ``u``
    and ``sigma`` stored only with ``update_stats``; the gradient flows
    through ``sigma`` but not through ``u`` and ``v``."""
    make_j, make_t = SN_CASES[case]
    jm, tm = make_j(), make_t()
    x = arrays(1, 2, 8, 6, 5)
    variables = init(jm, jnp.asarray(x), seed=2)
    tm.load_state_dict(sn_state(variables))
    r = arrays(3, *jax.eval_shape(lambda: jm.apply(variables, x)).shape)

    def loss(params):
        y, upd = jm.apply({**variables, "params": params}, jnp.asarray(x),
                          update_stats=update_stats, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd)

    (_, (want, upd)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    xt = torch.from_numpy(x)
    y = tm(xt, update_stats=update_stats)
    torch.sum(y * torch.from_numpy(r)).backward()
    close(y, want)
    stored = sn_state({"params": variables["params"], "batch_stats": host(upd["batch_stats"])})
    close(tm.u, stored["u"])
    close(tm.sigma, stored["sigma"])
    if not update_stats:
        close(tm.u, sn_state(variables)["u"], rtol=0, atol=0)
        assert float(tm.sigma) == 1.0
    want_grad = sn_state({"params": host(grads), "batch_stats": variables["batch_stats"]})
    close(tm.weight.grad, want_grad["weight"])


def test_torch_spectral_norm_in_eval_mode_is_not_flaxs():
    """``torch.nn.utils.spectral_norm`` skips the power iteration in eval
    mode and divides by the stored sigma: from the same weight and ``u`` it
    gives another output than flax's module without ``update_stats``."""
    jm = jl.SNConv(6, (3, 3))
    x = arrays(4, 2, 8, 6, 5)
    variables = init(jm, jnp.asarray(x), seed=5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    port = tl.SNConv(5, 6, 3)
    port.load_state_dict(sn_state(variables))
    close(port(torch.from_numpy(x)), want)

    conv = torch.nn.Conv2d(5, 6, 3, padding=1)
    state = sn_state(variables)
    with torch.no_grad():
        conv.weight.copy_(state["weight"])
        conv.bias.copy_(state["bias"])
    conv = torch.nn.utils.spectral_norm(conv)
    with torch.no_grad():
        conv.weight_u.copy_(state["u"][0])
    conv.eval()
    theirs = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert not np.allclose(theirs, want, rtol=1e-2, atol=1e-3)


def test_instance_norm_uses_the_population_variance():
    jm = jl.InstanceNorm()
    x = arrays(6, 3, 5, 4, 7) * 3 + 1
    variables = init(jm, jnp.asarray(x), seed=7)
    tm = tl.InstanceNorm(7)
    tm.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                        "bias": torch.from_numpy(variables["params"]["bias"])})
    close(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("update_stats", [False, True])
def test_residual_block(update_stats):
    jm = jl.ResidualBlock(6)
    x = arrays(8, 2, 6, 4, 6)
    variables = init(jm, jnp.asarray(x), seed=9)
    tm = tl.ResidualBlock(6)
    out = {}
    ji._put_residual_block(out, "m", variables["params"], variables["batch_stats"])
    tm.load_state_dict({k[2:]: v for k, v in out.items()})
    want, upd = jm.apply(variables, jnp.asarray(x), update_stats=update_stats,
                         mutable=["batch_stats"])
    close(tm(torch.from_numpy(x), update_stats=update_stats), want)
    out = {}
    ji._put_residual_block(out, "m", variables["params"], host(upd["batch_stats"]))
    for name in ("conv1.u", "conv1.sigma", "conv2.u", "conv2.sigma"):
        close(tm.state_dict()[name], out[f"m.{name}"])


@pytest.mark.parametrize("activation", tl.LinearBlock.ACTIVATIONS)
def test_linear_block(activation):
    jm = jl.LinearBlock(6, activation)
    x = arrays(10, 4, 5)
    variables = init(jm, jnp.asarray(x), seed=11)
    tm = tl.LinearBlock(5, 6, activation)
    p = variables["params"]
    state = {"dense.weight": torch.from_numpy(np.ascontiguousarray(p["Dense_0"]["kernel"].T)),
             "dense.bias": torch.from_numpy(p["Dense_0"]["bias"])}
    if activation == "prelu":
        p = {**p, "prelu_a": np.array(p["prelu_a"] - 1.3, np.float32)}     # a negative slope
        state["prelu_a"] = torch.from_numpy(p["prelu_a"])
    tm.load_state_dict(state)
    close(tm(torch.from_numpy(x)), jm.apply({"params": p}, jnp.asarray(x)))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unsupported activation"):
        tl.LinearBlock(3, 4, "gelu")


@pytest.mark.parametrize("n_blk", [2, 3])
def test_mlp_and_discriminator(n_blk):
    x = arrays(12, 4, 2, 3, 5)          # flattened to (4, 30)
    jm = jl.MLP(7, dim=9, n_blk=n_blk, activ="lrelu")
    variables = init(jm, jnp.asarray(x), seed=13)
    tm = tl.MLP(30, 7, dim=9, n_blk=n_blk, activ="lrelu")
    out = {}
    ji._put_mlp(out, "m", variables["params"])
    tm.load_state_dict({k[2:]: v for k, v in out.items()})
    close(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)))

    feat = arrays(14, 4, 30)
    jd = jl.Discriminator(8, dim=16)
    dvars = init(jd, jnp.asarray(feat), seed=15)
    td = tl.Discriminator(30, 8, dim=16)
    state = ji.adaptive_from_jax({"params": {"discriminator": dvars["params"]}})
    td.load_state_dict({k[len("discriminator."):]: v for k, v in state.items()})
    close(td(torch.from_numpy(feat)), jd.apply(dvars, jnp.asarray(feat)))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("reduc_ratio", [1, 4])
def test_nonlocal(train, reduc_ratio):
    """Softmax of ``theta(c) phi(s)^T / n`` over the keys, ``W_conv`` and the
    batch norm in the mode asked for, plus ``c``; the running statistics move
    in train mode only."""
    c, s = arrays(16, 2, 6, 4, 8), arrays(17, 2, 3, 2, 12)
    jm = jl.NonLocal(reduc_ratio=reduc_ratio)
    variables = init(jm, jnp.asarray(c), jnp.asarray(s), seed=18)
    tm = tl.NonLocal(8, 12, reduc_ratio=reduc_ratio)
    out = {}
    ji._put_nonlocal(out, "m", variables["params"], variables["batch_stats"])
    tm.load_state_dict({k[2:]: v for k, v in out.items()})
    tm.eval()                        # the mode comes from ``train``, not the module's own
    want, upd = jm.apply(variables, jnp.asarray(c), jnp.asarray(s), train=train,
                         mutable=["batch_stats"])
    close(tm(torch.from_numpy(c), torch.from_numpy(s), train=train), want)
    close(tm.W_bn.running_mean, upd["batch_stats"]["W_bn"]["mean"])
    close(tm.W_bn.running_var, upd["batch_stats"]["W_bn"]["var"])
    moved = not np.allclose(np.asarray(upd["batch_stats"]["W_bn"]["mean"]),
                            variables["batch_stats"]["W_bn"]["mean"])
    assert moved == train


def test_nonlocal_starts_as_the_identity():
    tm = tl.NonLocal(8, 12)
    c, s = torch.from_numpy(arrays(19, 2, 6, 4, 8)), torch.from_numpy(arrays(20, 2, 3, 2, 12))
    assert torch.equal(tm(c, s, train=True), c)


def test_compute_mask():
    feat = arrays(21, 3, 6, 3, 16) ** 2
    got = tl.compute_mask(torch.from_numpy(feat).requires_grad_())
    assert got.shape == (3, 6, 3, 1) and not got.requires_grad
    close(got, jl.compute_mask(jnp.asarray(feat)))
    flat = got.reshape(3, -1)
    assert torch.all(flat.amin(1) == 0) and torch.allclose(flat.amax(1), torch.ones(3))
