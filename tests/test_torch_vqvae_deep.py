"""The port's ``models/vqvae_deep.py`` against the JAX package's: ``AdaIN``
and ``AdainResBlk``; ``EncoderDeep`` and ``DecoderDeep`` (plain and styled) at
strides 2, 4, 6 and 8; ``VQVAE_Deep`` through ``__call__`` (eval and train:
the codebook buffers after the EMA step), the split ``encode`` /
``quantize`` / ``upsample_top`` / ``decode`` and ``decode_code``; and a
reference-layout ``state_dict`` loaded by ``from_reference_deep_state_dict``
against the JAX package's ``import_vqvae_deep``.

Small configuration: channel 16, two residual blocks of 8 channels,
``embed_dim`` 8, 16 codes, a style of 12, images 32x32 (batch 2).  Weights are
seeded numpy values carried across by ``utils/jax_import.py``.  Tolerance:
rtol 1e-4 / atol 1e-5; code ids bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.models import vqvae_deep as jd
from vqvae2_tpu.utils import torch_import as ti
from vqvae2_tpu_torch.models import vqvae_deep as td
from vqvae2_tpu_torch.utils import jax_import as ji

TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(channel=16, n_res_block=2, n_res_channel=8, embed_dim=8, n_embed=16, style_dim=12)

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
    """LeCun-scaled kernels, biases +- 0.1; codebooks and their EMA sums
    standard normal, cluster sizes in [0.5, 2]."""
    g = np.random.default_rng(seed)

    def fill(path, s):
        leaf = getattr(path[-1], "key", str(path[-1]))
        if leaf in ("bias",):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf in ("embed", "embed_avg"):
            return g.normal(size=s.shape).astype(np.float32)
        if leaf == "cluster_size":
            return g.uniform(0.5, 2.0, s.shape).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt(1.0 / fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def arrays(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def strip(out, prefix="m."):
    return {k[len(prefix):]: v for k, v in out.items()}


def test_adain_and_its_residual_block():
    x, s = arrays(1, 2, 6, 4, 5), arrays(2, 2, 12)
    jm = jd.AdainResBlk(3)
    variables = seeded(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, s)), 3)
    tm = td.AdainResBlk(12, 5, 3)
    p, out = variables["params"], {}
    for conv in ("conv1", "conv2"):
        ji._put_conv(out, conv, p[conv])
    for norm in ("norm1", "norm2"):
        ji._put_dense(out, f"{norm}.fc", p[norm]["fc"])
    tm.load_state_dict(out)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(s)).permute(0, 2, 3, 1)
    close(got, jm.apply(variables, jnp.asarray(x), jnp.asarray(s)))

    ja = jd.AdaIN(5)
    avars = {"params": {"fc": variables["params"]["norm1"]["fc"]}}
    got = tm.norm1(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(s))
    close(got.permute(0, 2, 3, 1), ja.apply(avars, jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("stride", [2, 4, 6, 8])
def test_encoder_and_decoders_at_every_stride(stride):
    x = arrays(4, 2, 32, 32, 3)
    je = jd.EncoderDeep(16, 2, 8, stride)
    evars = seeded(jax.eval_shape(lambda: je.init(jax.random.PRNGKey(0), x)), 5)
    te = td.EncoderDeep(3, 16, 2, 8, stride)
    out = {}
    ji._put_deep_encoder(out, "m", evars["params"])
    te.load_state_dict(strip(out))
    z = te(torch.from_numpy(x))
    want = je.apply(evars, jnp.asarray(x))
    factor = {2: 2, 4: 4, 6: 8, 8: 16}[stride]          # 6: 2x then 4x; 8: 4x then 4x
    assert z.shape == (2, 32 // factor, 32 // factor, 16)
    close(z, want)

    s = arrays(6, 2, 12)
    for style_dim in (-1, 12):
        jdec = jd.DecoderDeep(3, 16, style_dim, 2, 8, stride)
        dvars = seeded(jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), want, s)), 7)
        tdec = td.DecoderDeep(16, 3, 16, style_dim, 2, 8, stride)
        out = {}
        ji._put_deep_decoder(out, "m", dvars["params"])
        tdec.load_state_dict(strip(out))
        got = tdec(z.detach(), torch.from_numpy(s) if style_dim > 0 else None)
        assert got.shape == (2, 32, 32, 3)
        close(got, jdec.apply(dvars, want, jnp.asarray(s) if style_dim > 0 else None))


def test_the_style_decoder_needs_a_style():
    dec = td.DecoderDeep(8, 3, 16, 12, 1, 8, 2)
    with pytest.raises(ValueError, match="style"):
        dec(torch.zeros(1, 4, 4, 8))


@pytest.fixture(scope="module")
def deep():
    jm = jd.VQVAE_Deep(**CFG)
    x, s = arrays(8, 2, 32, 32, 3), arrays(9, 2, 12)
    variables = seeded(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, s)), 10)
    return jm, variables, x, s


def port_deep(variables):
    model = td.VQVAE_Deep(**CFG)
    model.load_state_dict(ji.vqvae_deep_from_jax(variables))
    return model


@pytest.mark.parametrize("train", [False, True])
def test_call(deep, train):
    jm, variables, x, s = deep
    model = port_deep(variables)
    dec, diff, quant = model(torch.from_numpy(x), torch.from_numpy(s), train=train)
    (wdec, wdiff, wquant), upd = jm.apply(variables, jnp.asarray(x), jnp.asarray(s), train=train,
                                          mutable=["vq_stats"])
    assert dec.shape == (2, 32, 32, 3) and quant.shape == (2, 4, 4, 2 * CFG["embed_dim"])
    close(dec, wdec)
    close(diff, wdiff)
    close(quant, wquant)
    want = ji.vqvae_deep_from_jax({"params": variables["params"], "vq_stats": host(upd["vq_stats"])})
    for name, buf in model.named_buffers():
        close(buf, want[name])
    moved = not np.array_equal(want["quantize_b.cluster_size"].numpy(),
                               variables["vq_stats"]["quantize_b"]["cluster_size"])
    assert moved == train


def test_split_stages_and_decode_code(deep):
    jm, variables, x, s = deep
    model = port_deep(variables)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    enc_b, enc_t = model.encode(xt)
    wb, wt = jm.apply(variables, jnp.asarray(x), method=jm.encode)
    close(enc_b, wb)
    close(enc_t, wt)
    quant_t, quant_b, diff, id_t, id_b = model.quantize(enc_b, enc_t)
    want = jm.apply(variables, wb, wt, method=jm.quantize)
    np.testing.assert_array_equal(id_t.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(id_b.numpy(), np.asarray(want[4]))
    for got, w in zip((quant_t, quant_b, diff), want[:3]):
        close(got, w)
    up = model.upsample_top(quant_t)
    close(up, jm.apply(variables, want[0], method=jm.upsample_top))
    quant = torch.cat([up, quant_b], dim=-1)
    wquant = jnp.concatenate([jm.apply(variables, want[0], method=jm.upsample_top), want[1]], -1)
    close(model.decode(quant, st), jm.apply(variables, wquant, jnp.asarray(s), method=jm.decode))
    close(model.decode_code(id_t, id_b, st),
          jm.apply(variables, want[3], want[4], jnp.asarray(s), method=jm.decode_code))
    with pytest.raises(ValueError, match="divisible by 16"):
        model.encode(torch.zeros(1, 40, 32, 3))


def reference_state_dict(variables):
    """A state_dict in the original reference's layout: the decoders under
    their names, an unused ``conv`` Sequential in each AdaIN block, the
    encoders' and ``up_sample``'s layers at indices of their own (only their
    order is the port's), ``upsample_t`` wrapped as ``upsample_t.0``, the
    codebooks ``(D, K)``."""
    ours = ji.to_reference_state_dict(ji.vqvae_deep_from_jax(variables))
    sd, g = {}, np.random.default_rng(11)
    for k, v in ours.items():
        parts = k.split(".")
        if parts[1] in ("blocks", "up_sample") and parts[0] in ("enc_b", "enc_t", "dec_t", "dec") \
                and not (parts[0].startswith("dec") and parts[1] == "blocks"):
            parts[2] = str(3 * int(parts[2]) + 1)
        if parts[0] == "upsample_t":
            parts.insert(1, "0")
        sd[".".join(parts)] = v.clone()
    for j in range(CFG["n_res_block"]):
        sd[f"dec.blocks.{j}.conv.0.weight"] = torch.from_numpy(
            g.normal(size=(8, 16, 3, 3)).astype(np.float32))
    return sd


def test_reference_state_dict_loads_as_the_jax_package_imports_it(deep):
    jm, variables, x, s = deep
    sd = reference_state_dict(variables)
    wvars = ti.import_vqvae_deep(sd, variables)
    model = td.VQVAE_Deep(**CFG)
    model.load_state_dict(ji.from_reference_deep_state_dict(sd, model))
    dec, diff, quant = model(torch.from_numpy(x), torch.from_numpy(s))
    wdec, wdiff, wquant = jm.apply(wvars, jnp.asarray(x), jnp.asarray(s))
    close(dec, wdec)
    close(diff, wdiff)
    close(quant, wquant)
    close(model.quantize_t.embed, np.asarray(wvars["vq_stats"]["quantize_t"]["embed"]))
    incomplete = {k: v for k, v in sd.items() if not k.startswith("dec_t.conv1")}
    with pytest.raises(KeyError, match="dec_t.conv1"):
        ji.from_reference_deep_state_dict(incomplete, model)
