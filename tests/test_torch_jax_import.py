"""The layout maps of ``vqvae2_tpu_torch/utils/jax_import.py``: each map alone
against flax numerics, and the round trip through the JAX package's own
importer (port ``state_dict`` → reference key layout → ``import_vqvae``) giving
back the original JAX variables exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from vqvae2_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae2_tpu.utils import torch_import as ti
from vqvae2_tpu_torch.models import VQVAE
from vqvae2_tpu_torch.utils import jax_import as ji

CFG = dict(channel=16, n_res_block=2, n_res_channel=8, embed_dim=8, n_embed=16)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("size", [8, 10])           # even sizes: SAME == padding 1
def test_conv_map_matches_flax(rng, size):
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    kernel = rng.normal(size=(4, 4, 3, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    want = nn.Conv(5, (4, 4), strides=(2, 2), padding="SAME").apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    conv = torch.nn.Conv2d(3, 5, 4, stride=2, padding=1)
    conv.load_state_dict({"weight": ji.conv_weight(kernel), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # and it inverts the JAX package's map exactly
    np.testing.assert_array_equal(np.asarray(ti.conv_kernel(ji.conv_weight(kernel).numpy())),
                                  kernel)


def test_conv_transpose_map_is_flipped_and_swapped(rng):
    x = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    kernel = rng.normal(size=(4, 4, 3, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    want = nn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME").apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    weight = ji.conv_transpose_weight(kernel)
    assert tuple(weight.shape) == (3, 5, 4, 4)          # (I, O, kH, kW)
    tconv = torch.nn.ConvTranspose2d(3, 5, 4, stride=2, padding=1)
    tconv.load_state_dict({"weight": weight, "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (2, 12, 12, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # without the flip the map is wrong: the trap is real
    unflipped = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    tconv.load_state_dict({"weight": unflipped, "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        bad = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert np.abs(bad.numpy() - np.asarray(want)).max() > 0.1
    np.testing.assert_array_equal(np.asarray(ti.conv_transpose_kernel(weight.numpy())), kernel)


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxVQVAE(**CFG, with_ir_head=True)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                           method=model.forward_ir)
    g = np.random.default_rng(0)
    stats = numpy_tree(variables["vq_stats"])
    for q in stats:                     # embed_avg and cluster_size differ from embed
        stats[q]["embed_avg"] = g.normal(size=stats[q]["embed"].shape).astype(np.float32)
        stats[q]["cluster_size"] = g.uniform(size=(CFG["n_embed"],)).astype(np.float32)
    return {"params": numpy_tree(variables["params"]), "vq_stats": stats}


def test_state_dict_has_the_ports_keys_and_shapes(jax_variables):
    sd = ji.vqvae_from_jax(jax_variables)
    model = VQVAE(**CFG, with_ir_head=True)
    own = model.state_dict()
    assert set(sd) == set(own)
    for key, value in sd.items():
        assert tuple(value.shape) == tuple(own[key].shape), key
        assert value.dtype == torch.float32
    model.load_state_dict(sd)                            # strict


def test_codebook_buffers_stay_k_by_d(jax_variables):
    sd = ji.vqvae_from_jax(jax_variables)
    for q in ("quantize_t", "quantize_b"):
        for buf in ("embed", "embed_avg", "cluster_size"):
            np.testing.assert_array_equal(sd[f"{q}.{buf}"].numpy(),
                                          jax_variables["vq_stats"][q][buf])
        assert tuple(sd[f"{q}.embed"].shape) == (CFG["n_embed"], CFG["embed_dim"])
    # a copy, not a view of the caller's arrays
    sd["quantize_t.embed"].zero_()
    assert jax_variables["vq_stats"]["quantize_t"]["embed"].any()


def test_round_trip_through_the_jax_importer(jax_variables):
    """port state_dict → reference layout → ``import_vqvae`` == the original."""
    reference = ji.to_reference_state_dict(ji.vqvae_from_jax(jax_variables))
    assert tuple(reference["quantize_t.embed"].shape) == (CFG["embed_dim"], CFG["n_embed"])
    blank = jax.tree_util.tree_map(np.zeros_like, jax_variables)
    back = ti.import_vqvae(reference, blank)
    flat_want = jax.tree_util.tree_leaves_with_path(jax_variables)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, want), (_, got) in zip(flat_want, flat_got):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(path))


def test_reference_state_dict_round_trip(jax_variables):
    sd = ji.vqvae_from_jax(jax_variables)
    reference = ji.to_reference_state_dict(sd)
    # some reference checkpoints wrap upsample_t in a Sequential
    wrapped = {k.replace("upsample_t.", "upsample_t.0."): v for k, v in reference.items()}
    for variant in (reference, wrapped):
        back = ji.from_reference_state_dict(variant)
        assert set(back) == set(sd)
        for key in sd:
            assert torch.equal(back[key], sd[key]), key
