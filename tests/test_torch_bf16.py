"""The port's bf16 compute mode against the JAX package's, on the CPU.

The JAX package's bf16 mode is flax's: a module given ``dtype=bf16`` computes
in bf16 (``nn.Conv`` casts input, kernel and bias and adds the bias to the
rounded product), and a module without one (``nn.BatchNorm()``, ``nn.Dense()``,
the priors' ``WNDense`` and attention) promotes a bf16 input to its fp32
parameters.  The dtype maps pin that module by module: flax's
``capture_intermediates`` against forward hooks on the port, every module the
two name alike, in the bf16 ``VQVAE``, both bf16 priors and a bf16
``EmbedNet2``.

Tolerances are in bf16 units in the last place (ulp) at the scale of the
tensor compared (its largest magnitude): 2^(floor(log2 scale) - 7).  The two
sides round the same bf16 operations but sum each convolution in another
order, so a value may land on the neighbouring bf16 at any layer and the
difference grows with depth: ``ULPS`` for the outputs of a few layers.  Ids
are bit-equal given identical bf16 rows; through a whole bf16 model, where the
rows themselves differ by such roundings, their agreement is a share.
"""

import argparse
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vqvae2_tpu.models import pixelsnail as jps
from vqvae2_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae2_tpu.ops.quantize import nearest_code_reference as jax_nearest_code_reference
from vqvae2_tpu.part import part_model as jpm
from vqvae2_tpu.train import pixelsnail as jtp
from vqvae2_tpu.train import vqvae as jtv
from vqvae2_tpu_torch.models import layers
from vqvae2_tpu_torch.models import pixelsnail as tps
from vqvae2_tpu_torch.models.vqvae import VQVAE
from vqvae2_tpu_torch.ops import quantize as qz
from vqvae2_tpu_torch.part import part_model as tpm
from vqvae2_tpu_torch.train import pixelsnail as tp
from vqvae2_tpu_torch.train import vqvae as tv
from vqvae2_tpu_torch.utils import jax_import, schedules

BF16 = torch.bfloat16
ULPS = 8            # outputs of a few bf16 layers
# A first Adam step moves each weight by about the learning rate, the sign of
# its gradient: the two sides' bf16 gradients may differ in sign where they
# are near zero
UPDATE_SIGN_SHARE = 0.95
LR = 3e-4

VQ_CFG = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)
TOP = dict(shape=(6, 6), n_class=8, channel=16, kernel_size=5, n_block=2, n_res_block=2,
           res_channel=16, dropout=0.0, n_out_res_block=1)
BOTTOM = dict(shape=(8, 8), n_class=8, channel=16, kernel_size=5, n_block=2, n_res_block=2,
              res_channel=16, attention=False, dropout=0.0, n_cond_res_block=1,
              cond_res_channel=16)
REID_HW = (64, 32)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def bf16_ulp(scale: float) -> float:
    """The spacing of bf16 values at ``scale``."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def within_ulps(got, want, ulps=ULPS, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(np.asarray(want, np.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= ulps * bf16_ulp(scale), (what, err, scale, err / bf16_ulp(scale))
    return err / bf16_ulp(scale)


def to_bf16_numpy(x) -> np.ndarray:
    """A JAX bf16 array as fp32 numpy (every bf16 value is an fp32 value)."""
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- dtype maps ----------------------------------------------------------------------

def leaf_dtypes(out) -> list:
    if isinstance(out, (tuple, list)):
        return [d for o in out for d in leaf_dtypes(o)]
    if isinstance(out, torch.Tensor):
        return [str(out.dtype).replace("torch.", "")]
    return [] if out is None else [str(out.dtype)]


def jax_map(intermediates, rename) -> dict:
    """{port name: output dtypes over every call} from flax's intermediates."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if key == "__call__":
                name = rename(path)
                if name is not None and name not in out:
                    out[name] = leaf_dtypes(list(value))
            elif isinstance(value, dict):
                walk(value, path + (key,))

    walk(intermediates, ())
    return out


class PortMap:
    """Forward hooks on every named module of a port model: {name: output
    dtypes over every call}; also the dtypes each module received."""

    def __init__(self, model):
        self.outputs, self.inputs, self.hooks = {}, {}, []
        for name, mod in model.named_modules():
            if name:
                self.hooks.append(mod.register_forward_hook(self._hook(name)))

    def _hook(self, name):
        def hook(mod, args, out):
            self.outputs.setdefault(name, []).extend(leaf_dtypes(out))
            self.inputs.setdefault(name, []).extend(leaf_dtypes(list(args)))
        return hook

    def remove(self):
        for h in self.hooks:
            h.remove()


def compare_maps(jmap: dict, pmap: dict, required) -> dict:
    both = sorted(set(jmap) & set(pmap))
    wrong = {n: (jmap[n], pmap[n]) for n in both if jmap[n] != pmap[n]}
    assert not wrong, wrong
    missing = [n for n in required if n not in both]
    assert not missing, missing
    return {n: jmap[n] for n in both}


def _vq_rename(path):
    return path[0] if len(path) == 1 else None


_PIXEL_RENAMES = ((re.compile(r"^blocks_(\d+)$"), r"blocks.\1"),
                  (re.compile(r"^res(\d+)$"), r"res.\1"),
                  (re.compile(r"^out_res_(\d+)$"), r"out_res.\1"))


def _pixel_rename(path):
    parts = []
    for p in path:
        if p == "WNConv_0":         # CausalConv wraps its WNConv: the same output
            continue
        if p.startswith("Dropout"):
            return None
        for pattern, repl in _PIXEL_RENAMES:
            p = pattern.sub(repl, p)
        parts.append(p)
    return ".".join(parts) or None


def _reid_rename(path):
    return jax_import._reid_name(path) or None


def vq_pair(dtype_jax=jnp.bfloat16, dtype_port=BF16, remat=False, seed=0):
    jmodel = JaxVQVAE(**VQ_CFG, dtype=dtype_jax, remat=remat)
    g = np.random.default_rng(seed)
    x = g.normal(scale=0.5, size=(4, 32, 32, 3)).astype(np.float32)
    variables = host(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1])))
    for q in ("quantize_t", "quantize_b"):
        embed = (0.05 * g.normal(size=(16, 8))).astype(np.float32)
        variables["vq_stats"][q] = {"embed": embed, "embed_avg": embed.copy(),
                                    "cluster_size": g.uniform(size=16).astype(np.float32)}
    model = VQVAE(**VQ_CFG, dtype=dtype_port, remat=remat)
    model.load_state_dict(jax_import.vqvae_from_jax(variables))
    return jmodel, variables, model, x


def prior_pair(which, bf16=True):
    cfg = TOP if which == "top" else BOTTOM
    g = np.random.default_rng(1)
    h, w = cfg["shape"]
    codes = g.integers(0, cfg["n_class"], size=(2, h, w)).astype(np.int32)
    cond = (g.integers(0, cfg["n_class"], size=(2, h // 2, w // 2)).astype(np.int32)
            if which == "bottom" else None)
    jmodel = jps.PixelSNAIL(**cfg, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(codes),
                            condition=None if cond is None else jnp.asarray(cond))

    def fill(path, leaf):
        name = path[-1].key
        if name == "v":
            return (g.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((1.0 if name == "g" else 0.0) + 0.1 * g.normal(size=leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    model = tps.PixelSNAIL(**cfg, dtype=BF16 if bf16 else torch.float32).eval()
    model.load_state_dict(jax_import.pixelsnail_from_jax(variables, model))
    return jmodel, variables, model, codes, cond


def reid_variables(jmod, seed=17):
    """Seeded EmbedNet2 variables: He-scaled kernels, scales around 1, biases,
    means around 0, variances in [0.5, 1.5] (the non-local output scale 0, as
    flax starts it)."""
    probe = jnp.zeros((1, *REID_HW, 3))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xRGB=probe, xIR=probe,
                                              xZ=probe, modal=0, train=True))
    g = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(k, "key", str(k)) for k in path]
        leaf, owner = keys[-1], "/".join(keys[:-1])
        if leaf in ("var", "running_var"):
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "running_mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf in ("scale", "weight"):
            return np.zeros(s.shape, np.float32) if "W_bn" in owner else (
                1 + g.normal(0, 0.1, s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt((2.0 if len(s.shape) == 4 else 1.0) / fan)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def reid_pair():
    jmod = jpm.EmbedNet2(class_num=4, arch="resnet18", dtype=jnp.bfloat16)
    variables = reid_variables(jmod)
    model = tpm.EmbedNet2(class_num=4, arch="resnet18", dtype=BF16)
    model.load_state_dict(jax_import.embed_net2_from_jax(variables))
    return jmod, variables, model


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(tpm, "dropout", lambda x, *a, **k: x)


def test_vqvae_dtype_map():
    """Every convolution is bf16, so the quantizers receive bf16 rows and give
    bf16 back (ids int32, ``diff`` fp32), and ``dec`` is bf16."""
    jmodel, variables, model, x = vq_pair()
    (_, _), state = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["vq_stats", "intermediates"], capture_intermediates=True)
    port = PortMap(model)
    model(torch.from_numpy(x), train=True)
    port.remove()
    seen = compare_maps(jax_map(state["intermediates"], _vq_rename), port.outputs,
                        ["enc_b", "enc_t", "quantize_conv_t", "quantize_t", "dec_t",
                         "quantize_conv_b", "quantize_b", "upsample_t", "dec"])
    assert seen["quantize_t"] == seen["quantize_b"] == ["bfloat16", "float32", "int32"]
    assert port.inputs["quantize_t"] == port.inputs["quantize_b"] == ["bfloat16"]
    assert seen["dec"] == ["bfloat16"]


@pytest.mark.parametrize("which", ["top", "bottom"])
def test_prior_dtype_map(which):
    """bf16 convolutions; the attention's q, k, v (``WNDense``) and its output
    fp32, as JAX promotes ``bf16 @ fp32``; logits bf16."""
    jmodel, variables, model, codes, cond = prior_pair(which)
    _, state = jmodel.apply(variables, jnp.asarray(codes),
                            condition=None if cond is None else jnp.asarray(cond),
                            mutable=["intermediates"], capture_intermediates=True)
    port = PortMap(model)
    model(torch.from_numpy(codes), condition=None if cond is None else torch.from_numpy(cond))
    port.remove()
    required = ["horizontal", "vertical", "blocks.0", "blocks.0.res.0", "blocks.0.res.0.conv1",
                "out_conv"]
    if which == "top":
        required += [f"blocks.0.causal_attention{s}" for s in ("", ".query", ".key", ".value")]
        required += ["blocks.0.out_resblock.aux_conv", "out_res.0"]
    else:
        required += ["cond_resnet", "cond_resnet.conv_in", "blocks.1.res.1.condition",
                     "blocks.0.out"]
    seen = compare_maps(jax_map(state["intermediates"], _pixel_rename), port.outputs, required)
    if which == "top":
        for part in (".query", ".key", ".value", ""):
            assert seen[f"blocks.0.causal_attention{part}"] == ["float32"]
        assert port.inputs["blocks.0.out_resblock.aux_conv"] == ["float32"]
    assert seen["out_conv"] == seen["blocks.1"] == ["bfloat16"]


def test_embed_net2_dtype_map(no_dropout):
    """bf16 convolutions; every batch norm and dense head returns fp32; every
    in-place ABN receives the bf16 output of a convolution and stores bf16."""
    jmod, variables, model = reid_pair()
    g = np.random.default_rng(3)
    rgb, ir, gray = (g.normal(size=(2, *REID_HW, 3)).astype(np.float32) for _ in range(3))
    _, state = jmod.apply(variables, xRGB=rgb, xIR=ir, xZ=gray, modal=0, train=True,
                          mutable=["intermediates", "batch_stats"], capture_intermediates=True)
    port = PortMap(model)
    model.train()(xRGB=torch.from_numpy(rgb), xIR=torch.from_numpy(ir), xZ=torch.from_numpy(gray),
                  modal=0)
    port.remove()
    abns = [n for n, m in model.named_modules() if type(m).__name__ == "InPlaceABN"]
    bns = [n for n, m in model.named_modules() if type(m).__name__ == "BatchNorm"]
    dense = [n for n, m in model.named_modules() if type(m).__name__ == "Dense"]
    assert len(abns) == 13
    seen = compare_maps(jax_map(state["intermediates"], _reid_rename), port.outputs,
                        abns + bns + dense + ["visible_module", "trunk", "trunk.NL2.0",
                                              "part.edge.conv4", "part.fusion_out"])
    assert all(set(seen[n]) == {"bfloat16"} for n in abns)
    assert all(set(port.inputs[n]) == {"bfloat16"} for n in abns)
    assert all(set(seen[n]) == {"float32"} for n in bns + dense)
    assert seen["part.edge.conv4"] == ["bfloat16"] * 3 and seen["trunk"] == ["float32"] * 3


# -- numerics ------------------------------------------------------------------------

def test_a_bf16_convolution_adds_the_bias_to_the_rounded_product():
    """flax rounds the product to bf16, then adds the bf16 bias; the port's
    ``Conv2d(dtype=bf16)`` does so and is bit-equal to flax here, where a bias
    fused into ``F.conv2d`` rounds once and misses it by a bf16 ulp in many
    places."""
    g = np.random.default_rng(0)
    x = g.normal(size=(2, 16, 16, 32)).astype(np.float32)
    kernel = (0.2 * g.normal(size=(3, 3, 32, 24))).astype(np.float32)
    bias = g.normal(size=(24,)).astype(np.float32)
    want = to_bf16_numpy(fnn.Conv(24, (3, 3), padding="SAME", dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}}, x))
    conv = layers.Conv2d(32, 24, 3, padding=1, dtype=BF16)
    conv.load_state_dict({"weight": jax_import.conv_weight(kernel), "bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = conv(xt).permute(0, 2, 3, 1)
        fused = F.conv2d(xt.to(BF16), conv.weight.to(BF16), conv.bias.to(BF16), padding=1)
    assert got.dtype == BF16 and np.array_equal(got.float().numpy(), want)
    assert (fused.permute(0, 2, 3, 1).float().numpy() != want).mean() > 0.05


def test_wndense_widens_a_bf16_input_as_jax_promotes_it():
    g = np.random.default_rng(2)
    x = g.normal(size=(3, 5, 12)).astype(np.float32)
    xb = torch.from_numpy(x).to(BF16)
    jmod = jps.WNDense(7)
    variables = {"params": {"v": (0.3 * g.normal(size=(12, 7))).astype(np.float32),
                            "g": (1 + 0.1 * g.normal(size=7)).astype(np.float32),
                            "b": (0.1 * g.normal(size=7)).astype(np.float32)}}
    want = jmod.apply(variables, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    dense = tps.WNDense(12, 7)
    out = {}
    jax_import._put_wn(out, "m", variables["params"], dense=True)
    dense.load_state_dict({k[2:]: v for k, v in out.items()})
    with torch.no_grad():
        got = dense(xb)
        exact = dense(xb.float())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert torch.equal(got, exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_quantizer_ids_are_bit_equal_on_identical_bf16_rows():
    """Given the same bf16 rows, the search widens them exactly: ids and the
    looked-up rows bit-equal to JAX's plain reference, the counts equal, the
    sums within fp32 rounding."""
    g = np.random.default_rng(4)
    rows = torch.from_numpy(g.normal(size=(3000, 8)).astype(np.float32)).to(BF16)
    embed = (0.8 * g.normal(size=(64, 8))).astype(np.float32)
    idx, q, csum, esum = qz.nearest_code(rows, torch.from_numpy(embed), with_stats=True)
    j_idx, j_q, j_csum, j_esum = jax_nearest_code_reference(
        jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16), jnp.asarray(embed))
    assert q.dtype == BF16 and j_q.dtype == jnp.bfloat16
    assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(q.float().numpy(), to_bf16_numpy(j_q))
    assert np.array_equal(csum.numpy(), np.asarray(j_csum))
    np.testing.assert_allclose(esum.numpy(), np.asarray(j_esum), rtol=1e-6, atol=1e-5)


def test_vqvae_bf16_against_jax():
    """The quantizers' inputs within ULPS; the ids' agreement as a share (at
    least 0.9; all 320 ids of this input agree); the decoder on the JAX side's
    own quantized codes within ULPS; ``diff`` within 2 % (an fp32 mean of
    squared bf16 differences)."""
    jmodel, variables, model, x = vq_pair()
    (jquant_t, jquant_b, jdiff, jid_t, jid_b), state = jmodel.apply(
        variables, jnp.asarray(x), method=jmodel.encode, mutable=["intermediates"],
        capture_intermediates=True)
    inter = state["intermediates"]
    seen = {}
    hooks = [getattr(model, q).register_forward_pre_hook(
        lambda m, a, q=q: seen.__setitem__(q, a[0])) for q in ("quantize_t", "quantize_b")]
    with torch.no_grad():
        quant_t, quant_b, diff, id_t, id_b = model.encode(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    within_ulps(seen["quantize_t"], to_bf16_numpy(inter["quantize_conv_t"]["__call__"][0]),
                what="top quantizer input")
    assert quant_t.dtype == quant_b.dtype == BF16
    share = [float(np.mean(a.numpy() == np.asarray(b))) for a, b in ((id_t, jid_t), (id_b, jid_b))]
    assert min(share) >= 0.9, share
    if share[0] == 1.0:
        within_ulps(seen["quantize_b"], to_bf16_numpy(inter["quantize_conv_b"]["__call__"][0]),
                    what="bottom quantizer input")
    np.testing.assert_allclose(float(diff), float(jdiff), rtol=2e-2)
    want = jmodel.apply(variables, jquant_t, jquant_b, method=jmodel.decode)
    with torch.no_grad():
        got = model.decode(torch.from_numpy(to_bf16_numpy(jquant_t)).to(BF16),
                           torch.from_numpy(to_bf16_numpy(jquant_b)).to(BF16))
        from_codes = model.decode_code(torch.from_numpy(np.asarray(jid_t)),
                                       torch.from_numpy(np.asarray(jid_b)))
    assert got.dtype == from_codes.dtype == BF16
    within_ulps(got, to_bf16_numpy(want), what="decode")
    within_ulps(from_codes, to_bf16_numpy(jmodel.apply(
        variables, jid_t, jid_b, method=jmodel.decode_code)), what="decode_code")


@pytest.mark.parametrize("which", ["top", "bottom"])
def test_prior_bf16_logits_against_jax(which):
    jmodel, variables, model, codes, cond = prior_pair(which)
    want = jax.jit(lambda v, c, k: jmodel.apply(v, c, condition=k))(
        variables, jnp.asarray(codes), None if cond is None else jnp.asarray(cond))
    with torch.no_grad():
        got = model(torch.from_numpy(codes),
                    condition=None if cond is None else torch.from_numpy(cond))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    within_ulps(got, to_bf16_numpy(want), what=f"{which} logits")


def test_embed_net2_bf16_eval_against_jax():
    """The eval pair is fp32 on both sides (the batch norms and dense heads
    promote), within ULPS of bf16 at its scale."""
    jmod, variables, model = reid_pair()
    x = np.random.default_rng(5).normal(size=(2, *REID_HW, 3)).astype(np.float32)
    want = jax.jit(lambda v, a: jmod.apply(v, xRGB=a, modal=1))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(xRGB=torch.from_numpy(x), modal=1)
    for a, b, what in zip(got, want, ("pooled", "features")):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        within_ulps(a, b, what=what)


# -- one bf16 train step -------------------------------------------------------------

def same_update(model, want: dict, before: dict) -> None:
    """Every parameter after the step within 2 ulps at its tensor's scale, and
    the update (after - before) of the same sign as JAX's in UPDATE_SIGN_SHARE
    of the elements over the whole model."""
    agree = total = 0
    for name, value in model.named_parameters():
        within_ulps(value, want[name].numpy(), ulps=2, what=name)
        got = (value.detach() - before[name]).numpy()
        ref = want[name].numpy() - before[name].numpy()
        agree += int((np.sign(got) == np.sign(ref)).sum())
        total += got.size
    assert agree >= UPDATE_SIGN_SHARE * total, agree / total


def test_bf16_stage1_train_step_against_jax():
    """One bf16 step of the stage-1 trainer from the same weights and batch:
    the metrics within ULPS at their scale, every parameter after the Adam
    update within 2 ulps at its tensor's scale (a first Adam step moves each
    weight by about the learning rate, below a bf16 ulp of most tensors, so
    the parameters pin the update's sign and size), the codebooks where the
    ids agreed."""
    jmodel, variables, model, _ = vq_pair()
    x = np.random.default_rng(9).normal(scale=0.5, size=(4, 16, 16, 3)).astype(np.float32)
    tx = optax.adam(LR)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jtv.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            vq_stats=jax.tree_util.tree_map(jnp.asarray, variables["vq_stats"]),
                            opt_state=tx.init(params))
    jstate, jmetrics = jtv.make_train_step(jmodel, tx)(jstate, jnp.asarray(x))
    sched = schedules.adam(LR)
    state = tv.create_state(model, sched)
    _, metrics = tv.make_train_step(model, sched)(state, torch.from_numpy(x))
    for k in ("loss", "recon_mse", "latent"):
        within_ulps(metrics[k], np.asarray(jmetrics[k]), what=k)
    want = jax_import.vqvae_from_jax(host({"params": jstate.params, "vq_stats": jstate.vq_stats}))
    before = jax_import.vqvae_from_jax(variables)
    same_update(model, want, before)


def test_bf16_prior_train_step_against_jax():
    """One bf16 step of the top-prior trainer (dropout 0): the loss within
    ULPS, every parameter within 2 ulps at its tensor's scale."""
    args = argparse.Namespace(n_class=16, channel=32, n_res_block=1, n_res_channel=32,
                              n_out_res_block=0, n_cond_res_block=1, dropout=0.0, bf16=True)
    jmodel = jtp.build_model("top", args, code_hw=(8, 16))
    codes = np.random.default_rng(0).integers(0, 16, size=(2, 8, 8)).astype(np.int32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(codes[:1]))
    g = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: ((1.0 if path[-1].key == "g" else 0.0)
                            + 0.1 * g.normal(size=leaf.shape)).astype(np.float32)
        if path[-1].key != "v" else
        (g.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32),
        dict(shapes))["params"]
    tx = optax.adam(LR)
    jstate = jtp.PriorState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=tx.init(params))
    jstate, jmetrics = jtp.make_train_step(jmodel, tx, conditional=False)(
        jstate, {"target": jnp.asarray(codes)}, jax.random.PRNGKey(1))
    model = tp.build_model("top", args, code_hw=(8, 16))
    assert model.dtype == BF16
    model.load_state_dict(jax_import.pixelsnail_from_jax({"params": params}, model))
    sched = schedules.adam(LR)
    state = tv.create_state(model, sched)
    _, metrics = tp.make_train_step(model, sched, conditional=False)(
        state, {"target": torch.from_numpy(codes)})
    within_ulps(metrics["loss"], np.asarray(jmetrics["loss"]), what="loss")
    want = jax_import.pixelsnail_from_jax({"params": host(jstate.params)}, model)
    same_update(model, want, jax_import.pixelsnail_from_jax({"params": params}, model))
