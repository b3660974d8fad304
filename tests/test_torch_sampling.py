"""Stage-2 serving of the port against the JAX package and against itself: the
incremental decoder, both samplers, ``train/sample.py`` and the image grid.

The parameter trees are the ones the JAX modules' ``init`` defines, filled
from a numpy seed and carried across through ``pixelsnail_from_jax``.
Tolerance for logits: rtol 2e-4 / atol 2e-5, what the JAX package holds its
incremental decoder to against its own full forward.  Codes drawn by the two
samplers from equally seeded generators are bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vqvae2_tpu.models import incremental as jinc
from vqvae2_tpu.models import pixelsnail as jps
from vqvae2_tpu.utils import image as jax_image
from vqvae2_tpu_torch.models import VQVAE
from vqvae2_tpu_torch.models import incremental as inc
from vqvae2_tpu_torch.models import pixelsnail as tps
from vqvae2_tpu_torch.models.sampling import draw_codes, sample_prior
from vqvae2_tpu_torch.train import sample
from vqvae2_tpu_torch.utils import image
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.jax_import import pixelsnail_from_jax

RTOL, ATOL = 2e-4, 2e-5

# the tiny configurations of the JAX package's incremental-decoder tests
CONFIGS = {
    "top": dict(shape=(6, 6), n_class=8, channel=16, kernel_size=5, n_block=2, n_res_block=2,
                res_channel=16, dropout=0.0, n_out_res_block=1),
    "bottom": dict(shape=(8, 8), n_class=8, channel=16, kernel_size=5, n_block=2,
                   n_res_block=2, res_channel=16, attention=False, dropout=0.0,
                   n_cond_res_block=1, cond_res_channel=16),
    # one block, one res block on a 4x4 grid: for the one compiled JAX sampler case
    "mini": dict(shape=(4, 4), n_class=8, channel=16, kernel_size=5, n_block=1, n_res_block=1,
                 res_channel=16, dropout=0.0),
}


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


@functools.lru_cache(maxsize=None)
def make_pair(which):
    """(jax model, jax variables, port model, codes, condition codes or None)."""
    cfg = CONFIGS[which]
    g = np.random.default_rng(1)
    h, w = cfg["shape"]
    codes = g.integers(0, cfg["n_class"], size=(2, h, w)).astype(np.int32)
    cond = (g.integers(0, cfg["n_class"], size=(2, h // 2, w // 2)).astype(np.int32)
            if which == "bottom" else None)
    jmodel = jps.PixelSNAIL(**cfg)
    variables = random_variables(jmodel, jnp.asarray(codes),
                                 condition=None if cond is None else jnp.asarray(cond))
    model = tps.PixelSNAIL(**cfg).eval()
    model.load_state_dict(pixelsnail_from_jax(variables, model))
    return jmodel, jax.tree_util.tree_map(jnp.asarray, variables), model, codes, cond


def tensor(a):
    return None if a is None else torch.from_numpy(a)


# -- the incremental decoder ------------------------------------------------------

@pytest.mark.parametrize("which", ["top", "bottom"])
def test_teacher_forced_logits_equal_the_full_forward_and_the_jax_forward(which):
    jmodel, variables, model, codes, cond = make_pair(which)
    got = inc.teacher_forced_logits(model, tensor(codes), condition=tensor(cond))
    with torch.no_grad():
        full = model(tensor(codes), condition=tensor(cond))
    assert got.shape == full.shape == codes.shape + (8,)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=RTOL, atol=ATOL)
    want = jax.jit(lambda v, c, k: jmodel.apply(v, c, condition=k))(
        variables, jnp.asarray(codes), None if cond is None else jnp.asarray(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["top", "bottom"])
def test_resolve_params_equals_the_jax_arrays(which):
    """Same tree, same layouts — ``(kh, kw, I, O)`` and ``(I, O)`` — same
    values: weight norm and causal masks folded once."""
    jmodel, variables, model, _, _ = make_pair(which)
    want = jax.jit(lambda v: jinc.resolve_params(jmodel, v))(variables)
    got = inc.resolve_params(model)
    flat_want, tree_want = jax.tree_util.tree_flatten(want, is_leaf=lambda x: x is None)
    flat_got, tree_got = jax.tree_util.tree_flatten(got, is_leaf=lambda x: x is None)
    assert tree_want == tree_got
    assert len(flat_got) > 20
    for g, w in zip(flat_got, flat_want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    masked = got["blocks"][0]["res"][0]["conv1"][0]
    assert masked.shape == (5, 5, 16, 16) and bool((masked[-1, 2:] == 0).all())


def test_caches_are_the_jax_packages():
    jmodel, _, model, _, _ = make_pair("top")
    want = jinc._make_caches(jmodel, 3)
    got = inc._make_caches(model, 3)
    assert (inc.PT, inc.PL, inc.PR) == (jinc.PT, jinc.PL, jinc.PR) == (4, 4, 4)
    assert set(got) == set(want) | {"pos"}
    for name, value in want.items():
        assert tuple(got[name].shape) == value.shape and not got[name].any()


# -- the two samplers -------------------------------------------------------------

@pytest.mark.parametrize("which", ["top", "bottom"])
def test_both_samplers_draw_the_same_codes_from_equal_seeds(which):
    _, _, model, _, cond = make_pair(which)
    h, w = model.shape
    gen = lambda seed: torch.Generator().manual_seed(seed)   # noqa: E731
    full = sample_prior(model, gen(7), 2, (h, w), temperature=0.9, condition=tensor(cond))
    cached = inc.sample_prior_incremental(model, gen(7), 2, temperature=0.9,
                                          condition=tensor(cond))
    assert full.dtype == cached.dtype == torch.int32 and tuple(full.shape) == (2, h, w)
    assert torch.equal(full, cached)
    assert int(full.min()) >= 0 and int(full.max()) < 8 and full.unique().numel() > 2
    again = inc.sample_prior_incremental(model, gen(7), 2, temperature=0.9,
                                         condition=tensor(cond))
    other = inc.sample_prior_incremental(model, gen(8), 2, temperature=0.9,
                                         condition=tensor(cond))
    assert torch.equal(cached, again) and not torch.equal(cached, other)


def test_draw_codes_follows_the_temperature():
    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0]]).repeat(4000, 1)
    cold = draw_codes(logits, 0.05, torch.Generator().manual_seed(0))
    warm = draw_codes(logits, 1.0, torch.Generator().manual_seed(0))
    assert cold.dtype == torch.int32 and bool((cold == 3).all())
    freq = torch.bincount(warm.long(), minlength=4).float() / 4000
    torch.testing.assert_close(freq, torch.softmax(logits[0], 0), atol=0.03, rtol=0)


def test_the_compiled_jax_decoder_agrees_on_one_tiny_case():
    """The JAX package's own ``teacher_forced_logits`` (one compiled loop)
    against the port's, at the smallest size.

    They agree when the biases of the two input convolutions are zero, as
    ``init`` leaves them.  With other biases the JAX decoder departs from its
    own full forward: ``shift_down``/``shift_right`` move zeros into row 0 and
    column 0, while its window dot over the padding gives the bias there.  The
    port's decoder follows the full forward."""
    jmodel, variables, model, codes, _ = make_pair("mini")
    jax_decoder = jax.jit(lambda v, c: jinc.teacher_forced_logits(jmodel, v, c))

    zeroed = jax.tree_util.tree_map(lambda a: a, variables)
    for stream in ("horizontal", "vertical"):
        b = zeroed["params"][stream]["WNConv_0"]["b"]
        zeroed["params"][stream]["WNConv_0"]["b"] = jnp.zeros_like(b)
    zero_model = tps.PixelSNAIL(**CONFIGS["mini"]).eval()
    zero_model.load_state_dict(pixelsnail_from_jax(
        jax.tree_util.tree_map(np.asarray, zeroed), zero_model))
    want = jax_decoder(zeroed, jnp.asarray(codes))
    got = inc.teacher_forced_logits(zero_model, tensor(codes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    jax_full = np.asarray(jmodel.apply(variables, jnp.asarray(codes)))
    jax_cached = np.asarray(jax_decoder(variables, jnp.asarray(codes)))
    assert np.abs(jax_cached - jax_full).max() > 1e-2          # the reference's fault
    got = inc.teacher_forced_logits(model, tensor(codes))
    np.testing.assert_allclose(got.numpy(), jax_full, rtol=RTOL, atol=ATOL)


# -- train/sample.py and the image grid -------------------------------------------

def test_make_grid_equals_the_jax_packages():
    g = np.random.default_rng(3)
    for shape, kw in (((5, 6, 7, 3), dict(nrow=2)), ((3, 4, 4, 1), dict(nrow=8, padding=1)),
                      ((2, 5, 5), dict(normalize=False)),
                      ((4, 3, 3, 3), dict(value_range=None))):
        x = g.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(image.make_grid(x, **kw), jax_image.make_grid(x, **kw))


@pytest.mark.parametrize("sampler", [[], ["--full_forward"]], ids=["incremental", "full_forward"])
def test_sample_main_on_the_cpu_writes_the_png(tmp_path, sampler):
    """Three checkpoint directories written here, each with its config.json;
    ``main`` rebuilds the models from them."""
    torch.manual_seed(0)
    vq_cfg = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=8)
    prior_cfg = dict(n_class=8, channel=16, n_res_block=1, n_res_channel=16,
                     n_out_res_block=1, n_cond_res_block=1, dropout=0.1)
    size, batch = 32, 3                          # 4x4 top grid, 8x8 bottom grid
    vqvae = VQVAE(**vq_cfg)
    CheckpointManager(str(tmp_path / "vqvae"), config=vq_cfg).save_last(
        {"model": vqvae.state_dict()})
    args = sample.argparse.Namespace(**prior_cfg)
    for hier in ("top", "bottom"):
        prior = sample.build_model(hier, args, code_hw=(size // 8, size // 4))
        CheckpointManager(str(tmp_path / hier), config=prior_cfg).save_last(prior.state_dict())

    out = tmp_path / "samples" / "grid.png"
    argv = [str(out), "--vqvae", str(tmp_path / "vqvae"), "--top", str(tmp_path / "top"),
            "--bottom", str(tmp_path / "bottom"), "--batch", str(batch), "--size", str(size),
            "--temp", "0.8", "--seed", "5", "--device", "cpu", *sampler]
    top, bottom = sample.main(argv)
    assert tuple(top.shape) == (batch, 4, 4) and tuple(bottom.shape) == (batch, 8, 8)
    assert int(bottom.min()) >= 0 and int(bottom.max()) < 8
    with Image.open(out) as png:
        assert png.size == (batch * (size + 2) + 2, size + 2 + 2) and png.mode == "RGB"
    # the picture is the decoder's output for these codes, one row of `batch`
    with torch.no_grad():
        decoded = vqvae.eval().decode_code(top, bottom).clamp(-1, 1).numpy()
    with Image.open(out) as png:
        np.testing.assert_array_equal(np.asarray(png), image.make_grid(decoded, nrow=batch))
    # the other sampler draws the same codes from the same seed
    flipped = [a for a in argv if a != "--full_forward"] + ([] if sampler else ["--full_forward"])
    top2, bottom2 = sample.main(flipped)
    assert torch.equal(top, top2) and torch.equal(bottom, bottom2)
