"""``VQVAE(remat=True)`` of the port against itself and against the JAX
package's ``nn.remat``: the encoders and decoders are recomputed in the
backward pass, the quantizers are not (their EMA step runs once a forward),
and the gradients are the same bit for bit as without remat, in fp32 and in
bf16 (the CPU's convolutions are deterministic, so the recompute is the same
program).  The JAX package's ``VQVAE(remat=True)`` has the variable tree of
``VQVAE()`` and carries across through ``vqvae_from_jax``; the port's remat
step matches it at the fp32 tolerance of ``tests/test_torch_train_vqvae.py``
(rtol 1e-4 / atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae2_tpu_torch.models import vqvae as tvq
from vqvae2_tpu_torch.models.vqvae import VQVAE, Decoder, Encoder, Quantize
from vqvae2_tpu_torch.train import vqvae as tv
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import vqvae_from_jax

RTOL, ATOL = 1e-4, 1e-5
CFG = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)
SIZE = 16


def host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def jax_variables(remat: bool):
    jmodel = JaxVQVAE(**CFG, remat=remat)
    variables = host(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    g = np.random.default_rng(0)
    for q in ("quantize_t", "quantize_b"):
        embed = (0.05 * g.normal(size=(16, 8))).astype(np.float32)
        variables["vq_stats"][q] = {"embed": embed, "embed_avg": embed.copy(),
                                    "cluster_size": g.uniform(size=16).astype(np.float32)}
    return jmodel, variables


def batch(seed=1, n=4):
    return np.random.default_rng(seed).normal(scale=0.5, size=(n, SIZE, SIZE, 3)).astype(np.float32)


def one_step(remat: bool, dtype=torch.float32):
    """One train step of the port from the JAX weights: (loss, gradients, state after)."""
    _, variables = jax_variables(False)
    model = VQVAE(**CFG, remat=remat, dtype=dtype)
    model.load_state_dict(vqvae_from_jax(variables))
    sched = schedules.adam(3e-4)
    state = tv.create_state(model, sched)
    _, metrics = tv.make_train_step(model, sched)(state, torch.from_numpy(batch()))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(metrics["loss"]), grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gradients_and_state_are_bit_equal_with_and_without_remat(dtype):
    loss0, g0, s0 = one_step(False, dtype)
    loss1, g1, s1 = one_step(True, dtype)
    assert loss0 == loss1
    assert set(g0) == set(g1) and all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(s0[n], s1[n]) for n in s0)


def test_only_the_coders_are_recomputed_and_only_where_a_backward_follows(monkeypatch):
    calls = {"checkpoint": 0}
    real = tvq.checkpoint

    def counted(*args, **kwargs):
        calls["checkpoint"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(tvq, "checkpoint", counted)
    forwards = {Encoder: 0, Decoder: 0, Quantize: 0}
    for cls in forwards:      # (module hooks do not fire in a recompute)
        def forward(self, *args, _real=cls.forward, **kwargs):
            forwards[type(self)] += 1
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(cls, "forward", forward)
    _, variables = jax_variables(False)
    model = VQVAE(**CFG, remat=True)
    model.load_state_dict(vqvae_from_jax(variables))
    before = model.quantize_b.cluster_size.clone()
    dec, diff = model(torch.from_numpy(batch()), train=True)
    (dec.square().mean() + diff).backward()
    # enc_b, enc_t, dec_t, dec: each run once more in the backward; the two
    # quantizers once each, so the EMA moved by one step
    assert calls["checkpoint"] == 4
    assert forwards == {Encoder: 4, Decoder: 4, Quantize: 2}
    assert not torch.equal(before, model.quantize_b.cluster_size)
    with torch.no_grad():
        model(torch.from_numpy(batch()))
    assert calls["checkpoint"] == 4 and forwards[Encoder] == 6


def test_the_jax_remat_tree_is_the_plain_tree_and_carries_across():
    _, plain = jax_variables(False)
    _, remat = jax_variables(True)
    flat = lambda t: {jax.tree_util.keystr(p): v.shape for p, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    assert flat(plain) == flat(remat)
    model = VQVAE(**CFG, remat=True)
    state = vqvae_from_jax(remat)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)


def test_a_remat_train_step_matches_the_jax_remat_step():
    """The JAX package's ``VQVAE(remat=True)`` loss and gradients, as its
    trainer takes them, against one step of the port's remat model."""
    jmodel, variables = jax_variables(True)
    x = batch()

    def loss_fn(params):
        (dec, diff), new = jmodel.apply({"params": params, "vq_stats": variables["vq_stats"]},
                                        jnp.asarray(x), train=True, mutable=["vq_stats"])
        return jnp.mean(jnp.square(dec - x)) + 0.25 * diff, new["vq_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    model = VQVAE(**CFG, remat=True)
    model.load_state_dict(vqvae_from_jax(variables))
    sched = schedules.adam(3e-4)
    state = tv.create_state(model, sched)
    _, metrics = tv.make_train_step(model, sched)(state, torch.from_numpy(x))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=RTOL, atol=ATOL)
    want = vqvae_from_jax(host({"params": grads, "vq_stats": stats}))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
