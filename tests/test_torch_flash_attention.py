"""The port's strictly-causal attention against the JAX package's: the plain
version (what the wrapper runs for a CPU tensor, and what the CUDA kernel is
held against on the card) on the same seeded numpy ``q, k, v`` as
``causal_attention_reference`` and as the Pallas kernel in interpret mode.

The backward: :func:`causal_attention_backward_reference` (the formula the
backward kernels compute, what they are held against on the card) against
autograd of the plain version and against ``jax.grad`` through the Pallas
kernels in interpret mode, at the same tolerance.

Tolerance: atol = rtol = 2e-5, what the JAX package holds its own kernel to
(fp32 sums in another order).  Row 0 is bit-zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.ops.flash_attention import causal_attention_reference as jax_reference
from vqvae2_tpu.ops.flash_attention import causal_flash_attention as jax_flash
from vqvae2_tpu_torch.ops import _build
from vqvae2_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=2e-5, rtol=2e-5)
# (B, H, N, D): the JAX package's own cases, its auto-shrink case, and a length
# that is no multiple of 8 (which only the reference takes there)
SHAPES = [(2, 2, 128, 16), (1, 4, 256, 32), (2, 1, 64, 64), (1, 1, 96, 16), (1, 2, 50, 16)]


def qkv(seed, *shape):
    g = np.random.default_rng(seed)
    return tuple(g.normal(size=shape).astype(np.float32) for _ in range(3))


def port(fn, *arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_equals_the_jax_reference(shape):
    q, k, v = qkv(0, *shape)
    want = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v))))
    got = port(fa.causal_attention_reference, q, k, v)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_plain_version_equals_the_interpreted_pallas_kernel(shape):
    q, k, v = qkv(1, *shape)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), block=64, interpret=True))
    got = port(fa.causal_attention_reference, q, k, v)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(want[:, :, 0] == 0.0) and bool((got[:, :, 0] == 0).all())


NO_CALLS = {"causal_flash_attention": 0, "causal_flash_attention_dq": 0,
            "causal_flash_attention_dkv": 0}


def test_wrapper_on_a_cpu_tensor_counts_a_plain_call_and_no_launch():
    q, k, v = qkv(2, 2, 2, 40, 16)
    fa.reset_counts()
    got = port(fa.causal_flash_attention, q, k, v)
    assert fa.plain_counts == dict(NO_CALLS, causal_flash_attention=1)
    assert fa.launch_counts == NO_CALLS
    want = port(fa.causal_attention_reference, q, k, v)
    assert torch.equal(got, want)
    o, lse = port(fa.causal_flash_attention_lse, *(a.reshape(4, 40, 16) for a in (q, k, v)))
    assert torch.equal(o.reshape(2, 2, 40, 16), want) and lse.shape == (4, 40, 1)
    assert fa.plain_counts["causal_flash_attention"] == 2
    fa.reset_counts()
    assert fa.plain_counts == NO_CALLS


def test_row_zero_is_bit_zero_and_a_single_position_gives_zeros():
    q, k, v = qkv(3, 2, 2, 128, 16)
    assert bool((port(fa.causal_flash_attention, q, k, v)[:, :, 0] == 0).all())
    one = port(fa.causal_flash_attention, *qkv(4, 1, 3, 1, 16))
    assert one.shape == (1, 3, 1, 16) and bool((one == 0).all())


def test_strict_causality():
    """Row i does not depend on keys and values at j >= i."""
    q, k, v = qkv(5, 1, 2, 128, 16)
    out = port(fa.causal_flash_attention, q, k, v)
    i = 70
    k2, v2 = k.copy(), v.copy()
    k2[:, :, i:] = 999.0
    v2[:, :, i:] = -999.0
    out2 = port(fa.causal_flash_attention, q, k2, v2)
    assert torch.equal(out[:, :, : i + 1], out2[:, :, : i + 1])
    assert not torch.allclose(out[:, :, i + 1:], out2[:, :, i + 1:])


def test_lse_is_the_logsumexp_of_the_visible_scores():
    q, k, v = qkv(6, 1, 2, 33, 16)
    _, lse = port(fa.causal_attention_reference_lse, q, k, v)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) / 4.0
    want = np.full((1, 2, 33), -1e30)
    for i in range(1, 33):
        row = s[:, :, i, :i]
        want[:, :, i] = np.log(np.exp(row - row.max(-1, keepdims=True)).sum(-1)) + row.max(-1)
    assert lse.shape == (1, 2, 33, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse[..., 0].numpy()[:, :, 1:], want[:, :, 1:], **TOL)
    assert bool((lse[:, :, 0] == np.float32(-1e30)).all())


def test_large_scores_do_not_overflow():
    q, k, v = qkv(7, 1, 2, 64, 16)
    got = port(fa.causal_attention_reference, q * 50.0, k, v)
    want = np.asarray(jax_reference(*map(jnp.asarray, (q * 50.0, k, v))))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_inputs_are_widened_and_the_result_is_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in qkv(8, 1, 2, 64, 16))
    got = fa.causal_attention_reference(q, k, v)
    assert got.dtype == torch.bfloat16
    want = fa.causal_attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)   # bf16 rounding of o


def numpy_dropout_attention(q, k, v, keep, rate):
    """The kernel's formula, written out: the normaliser takes the undropped
    probabilities, dropout scales only what multiplies v."""
    n, d = q.shape[-2:]
    s = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64) / np.sqrt(d)
    mask = np.arange(n)[None, :] < np.arange(n)[:, None]
    e = np.where(mask, np.exp(np.where(mask, s, -np.inf) - np.where(mask, s, -1e30).max(-1, keepdims=True)), 0.0)
    p = e / np.maximum(e.sum(-1, keepdims=True), 1e-30)
    return np.einsum("bhqk,bhkd->bhqd", p * keep / (1.0 - rate), v)


def test_explicit_keep_dropout_follows_the_kernels_formula():
    q, k, v = qkv(9, 1, 2, 48, 16)
    rate = 0.25
    keep = np.random.default_rng(10).random((1, 2, 48, 48)) >= rate
    got, lse = port(fa.causal_attention_reference_lse, q, k, v,
                    keep=torch.from_numpy(keep), dropout_rate=rate)
    np.testing.assert_allclose(got.numpy(), numpy_dropout_attention(q, k, v, keep, rate), **TOL)
    _, lse0 = port(fa.causal_attention_reference_lse, q, k, v)
    assert torch.equal(lse, lse0)           # dropout leaves the normaliser alone
    with pytest.raises(ValueError, match="keep"):
        port(fa.causal_attention_reference, q, k, v, dropout_rate=rate)


def test_dropout_statistics():
    """Averaged over seeds, dropout gives back the undropped attention (the JAX
    package's own statistic), and the mask keeps 1 - rate of the elements."""
    q, k, v = (torch.from_numpy(a) for a in qkv(11, 1, 2, 64, 16))
    nodrop = fa.causal_attention_reference(q, k, v)
    n_seed, acc = 48, torch.zeros_like(nodrop)
    for s in range(n_seed):
        acc += fa.causal_flash_attention(q, k, v, dropout_rate=0.5,
                                         generator=torch.Generator().manual_seed(s))
    rel = (acc / n_seed - nodrop).abs().mean() / nodrop.abs().mean()
    assert float(rel) < 0.25                # ~1/sqrt(48) sampling noise
    for rate in (0.1, 0.5):
        keep = fa.dropout_keep_reference(1234, 4, 128, rate)
        assert keep.shape == (4, 128, 128) and keep.dtype == torch.bool
        assert abs(float(keep.float().mean()) - (1 - rate)) < 0.01


def test_the_dropout_draw_is_philox_keyed_on_the_absolute_element():
    """Known answers of Philox-4x32-10 (Random123's test vectors), and a mask
    that depends on (seed, bh, i, j) alone: a longer sequence or more heads
    extend it without changing what was there."""
    def words(ctr, key):
        t = [torch.tensor([x], dtype=torch.int64) for x in (*ctr, *key)]
        return [int(w) for w in fa._philox4x32_10(tuple(t[:4]), tuple(t[4:]))]

    assert words((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert words((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert words((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]
    small = fa.dropout_keep_reference(77, 2, 10, 0.3)
    large = fa.dropout_keep_reference(77, 3, 23, 0.3)
    assert torch.equal(large[:2, :10, :10], small)
    assert not torch.equal(fa.dropout_keep_reference(78, 2, 10, 0.3), small)
    assert fa.dropout_threshold(0.0) == 0 and fa.dropout_threshold(0.5) == 2 ** 31
    assert fa.dropout_threshold(1.0) == 2 ** 32 - 1


def test_wrapper_dropout_needs_a_generator_and_is_repeatable():
    q, k, v = (torch.from_numpy(a) for a in qkv(12, 1, 2, 32, 16))
    with pytest.raises(ValueError, match="generator"):
        fa.causal_flash_attention(q, k, v, dropout_rate=0.1)
    a = fa.causal_flash_attention(q, k, v, dropout_rate=0.3, generator=torch.Generator().manual_seed(5))
    b = fa.causal_flash_attention(q, k, v, dropout_rate=0.3, generator=torch.Generator().manual_seed(5))
    c = fa.causal_flash_attention(q, k, v, dropout_rate=0.3, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        fa.causal_flash_attention_lse(q[0], k[0], v[0], dropout_rate=1.0)


def test_the_plain_version_is_differentiable_on_the_cpu():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv(13, 1, 1, 16, 8))
    fa.causal_flash_attention(q, k, v).sin().sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    assert bool((q.grad[:, :, 0] == 0).all())      # row 0 attends nothing


# -- the backward ----------------------------------------------------------------

def plain_grads(q, k, v, do, keep=None, rate=0.0):
    """Autograd of the plain version: ``(dq, dk, dv)`` and its ``(o, lse)``."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = fa.causal_attention_reference_lse(qt, kt, vt, keep=keep, dropout_rate=rate)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    return grads, o.detach(), lse.detach()


def reference_backward(q, k, v, o, lse, do, keep=None, rate=0.0):
    return fa.causal_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse, torch.from_numpy(do),
        keep=keep, dropout_rate=rate)


@pytest.mark.parametrize("n", [1, 7, 64, 96])
def test_backward_reference_equals_autograd_and_jax_grad(n):
    """The written-out backward against autograd of the plain forward, and
    against ``jax.grad`` of the Pallas kernels in interpret mode (the JAX
    package's flash path takes N a multiple of 8; at N = 1 and 7 its
    reference is differentiated instead).  The upstream gradient is that of
    ``sum(sin(o))``, as the JAX package's own test takes it."""
    q, k, v = qkv(20 + n, 1, 2, n, 16)
    want_o = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v))))
    do = np.cos(want_o).astype(np.float32)
    (aq, ak, av), o, lse = plain_grads(q, k, v, do)
    got = reference_backward(q, k, v, o, lse, do)
    for g, a, name in zip(got, (aq, ak, av), ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), a.numpy(), err_msg=name, **TOL)

    def loss(fn, **kw):
        return lambda q_, k_, v_: jnp.sum(jnp.sin(fn(q_, k_, v_, **kw)))

    fn = (loss(jax_flash, block=64, interpret=True) if n % 8 == 0 else loss(jax_reference))
    want = jax.grad(fn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    assert bool((got[0][:, :, 0] == 0).all())          # row 0 gets no gradient


def test_backward_reference_with_an_explicit_keep_mask():
    """Given the same keep mask, the written-out backward is autograd of the
    plain forward with dropout on."""
    q, k, v = qkv(30, 1, 2, 40, 16)
    rate = 0.3
    keep = torch.from_numpy(np.random.default_rng(31).random((1, 2, 40, 40)) >= rate)
    do = np.random.default_rng(32).normal(size=q.shape).astype(np.float32)
    (aq, ak, av), o, lse = plain_grads(q, k, v, do, keep=keep, rate=rate)
    got = reference_backward(q, k, v, o, lse, do, keep=keep, rate=rate)
    for g, a, name in zip(got, (aq, ak, av), ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), a.numpy(), err_msg=name, **TOL)
    with pytest.raises(ValueError, match="keep"):
        reference_backward(q, k, v, o, lse, do, rate=rate)


def test_no_gradient_crosses_the_causal_mask():
    """Row i's output moves no key or value at j >= i: with an upstream
    gradient on row i alone, dk and dv vanish from row i on."""
    q, k, v = qkv(33, 1, 1, 24, 8)
    i = 13
    do = np.zeros(q.shape, np.float32)
    do[:, :, i] = 1.0
    _, o, lse = plain_grads(q, k, v, do)
    dq, dk, dv = reference_backward(q, k, v, o, lse, do)
    assert bool((dk[:, :, i:] == 0).all()) and bool((dv[:, :, i:] == 0).all())
    assert bool((dk[:, :, :i] != 0).any()) and bool((dq[:, :, i] != 0).all())


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_the_autograd_binding_on_cpu_tensors_counts_plain_calls(rate):
    """``CausalFlashAttention`` on CPU tensors runs the plain forward and the
    written-out backward with the mask of the kernel's draw, counts plain
    calls and no launch, and gives autograd's gradients."""
    q, k, v = qkv(34, 2, 1, 33, 16)
    flat = [torch.from_numpy(a.reshape(2, 33, 16)).requires_grad_() for a in (q, k, v)]
    do = torch.from_numpy(np.random.default_rng(35).normal(size=(2, 33, 16)).astype(np.float32))
    seed = 99
    fa.reset_counts()
    o, lse = fa.CausalFlashAttention.apply(*flat, rate, seed)
    o.backward(do)
    assert fa.plain_counts == {"causal_flash_attention": 1, "causal_flash_attention_dq": 1,
                               "causal_flash_attention_dkv": 1}
    assert fa.launch_counts == NO_CALLS
    keep = fa.dropout_keep_reference(seed, 2, 33, rate) if rate else None
    same = [t.detach().clone().requires_grad_() for t in flat]
    want = fa.causal_attention_reference(*same, keep=keep, dropout_rate=rate)
    want.backward(do)
    assert torch.equal(o.detach(), want.detach())
    for a, b in zip(flat, same):
        torch.testing.assert_close(a.grad, b.grad, **TOL)
    assert not lse.requires_grad


# ---------------------------------------------------------------------------
# Why the tensor-core kernels take three TF32 passes (the arithmetic of
# mma.sync m16n8k8 TF32 with fp32 accumulation, emulated in plain torch)
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32: to nearest, ties away from zero, at 13 dropped
    mantissa bits (``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` with TF32 operands and fp32 sums (a product of two TF32
    values is exact in fp32): one pass ``hi·hi``, or three, ``lo·hi + hi·lo +
    hi·hi``, with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``."""
    a_hi, b_hi = tf32(a), tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def attention_by(q, k, v, scores, values):
    """Strictly-causal attention with the two products given as functions."""
    n, d = q.shape[-2:]
    s = scores(q, k.transpose(-1, -2)) / np.sqrt(d)
    seen = torch.arange(n)[None, :] < torch.arange(n)[:, None]
    p = torch.softmax(torch.where(seen, s, torch.full_like(s, fa.NEG_INF)), dim=-1)
    return values(p * (torch.arange(n)[:, None] > 0), v)


def test_three_tf32_passes_keep_fp32_accuracy_and_one_does_not():
    """At B·H = 4, N = 256, D = 16, unit-normal inputs: both products in three
    TF32 passes stay within FA_TOL of the fp32 plain version, a single pass
    misses it many times over."""
    q, k, v = (torch.from_numpy(a) for a in qkv(40, 4, 256, 16))
    want = fa.causal_attention_reference(q, k, v)
    three = attention_by(q, k, v, *(lambda a, b: tf32_product(a, b, 3),) * 2)
    one = attention_by(q, k, v, *(lambda a, b: tf32_product(a, b, 1),) * 2)
    torch.testing.assert_close(three, want, **TOL)
    assert not torch.allclose(one, want, **TOL)
    assert float((one - want).abs().max()) > 20 * float((three - want).abs().max())


def test_large_scores_need_the_plain_versions_rounding_of_the_scores():
    """Why the forward kernel forms its scores by fp32 FMAs in the plain
    version's order and takes P·V, not Q·Kᵀ, on the tensor cores: with q
    scaled by 50 (chip_smoke.py's large-score case) the scores reach a few
    hundred, and the plain fp32 version's own rounding of them moves o further
    than FA_TOL.  Scores more exact than fp32 (here exact, rounded once) then
    miss FA_TOL against the plain version, while the plain version's scores
    with P·V in three TF32 passes stay within it."""
    q, k, v = (torch.from_numpy(a) for a in qkv(41, 8, 512, 16))
    q = q * 50.0
    want = fa.causal_attention_reference(q, k, v)
    exact = lambda a, b: (a.double() @ b.double()).float()           # noqa: E731
    three = lambda a, b: tf32_product(a, b, 3)                        # noqa: E731
    assert not torch.allclose(attention_by(q, k, v, exact, three), want, **TOL)
    torch.testing.assert_close(attention_by(q, k, v, torch.matmul, three), want, **TOL)


# ---------------------------------------------------------------------------
# Head widths the kernels once refused (D = 6 is --channel 96; D = 72 is
# above one 64-wide tile; D = 128 is one wide tile of the attention kernels,
# D = 136 two), and what the tensor-core and wide kernels' arithmetic does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [6, 72, 128, 136])
def test_widths_the_jax_package_runs_match_its_reference_and_its_gradient(d):
    """The plain version and the written-out backward (what the kernels are
    held against on the card) against ``causal_attention_reference`` and
    ``jax.grad`` of it at D = 6, 72, 128 and 136, with the upstream gradient
    of ``sum(sin(o))``."""
    q, k, v = qkv(60 + d, 1, 2, 64, d)
    want_o = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v))))
    o, lse = fa.causal_attention_reference_lse(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    do = np.cos(want_o).astype(np.float32)
    got = reference_backward(q, k, v, o, lse, do)
    want = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(jax_reference(a, b, c))), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def fma_chain_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q @ kᵀ`` as the kernels form the scores: one fp32 FMA chain over d in
    order (each step's exact product, which fp64 holds, added to the running
    fp32 sum and rounded once)."""
    s = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float32)
    for c in range(q.shape[-1]):
        s = (q[..., :, c, None].double() * k[..., None, :, c].double() + s.double()).float()
    return s


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 to fp32 rounded toward zero, as the tensor cores round their fp32
    sums (``chip_smoke.py``'s phase probe)."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def mma_product(a: torch.Tensor, b: torch.Tensor, tile: int, fresh: bool) -> torch.Tensor:
    """``a @ b`` as mma.sync m16n8k8 accumulates it: k-steps of 8, each in
    three TF32 passes (``lo·hi``, ``hi·lo``, ``hi·hi``) whose sum is added to
    the accumulator and rounded toward zero.  ``fresh``: every ``tile`` of k
    goes into a fresh accumulator, added to the running sum by a rounded fp32
    add; otherwise one accumulator takes all of k."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    total = part = torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            part = toward_zero(part.double() + x[..., ks].double() @ y[..., ks, :].double())
        if fresh and (k0 + 8) % tile == 0:
            total, part = total + part, torch.zeros_like(part)
    return total + part if fresh else part


def test_tensor_core_dq_arithmetic_needs_a_fresh_accumulator_per_key_tile():
    """The tensor-core dq kernel's arithmetic at B·H = 2, N = 1024, D = 16:
    scores as fp32 FMA chains, dP = dO·Vᵀ and dq = dS·K in three TF32 passes
    with truncating sums, each 64-key tile into a fresh accumulator.  It stays
    within FA_TOL of the plain backward; one accumulator over all keys drifts
    more than twice as far."""
    q, k, v, do = (torch.from_numpy(a) for a in qkv(50, 2, 1024, 16) + qkv(51, 2, 1024, 16)[:1])
    n, d = q.shape[-2:]
    o, lse = fa.causal_attention_reference_lse(q, k, v)
    want = fa.causal_attention_backward_reference(q, k, v, o, lse, do)[0]
    scale = 1.0 / np.sqrt(d)
    seen = torch.arange(n)[None, :] < torch.arange(n)[:, None]
    p = torch.where(seen, torch.exp(fma_chain_scores(q, k) * scale - lse), torch.zeros(n, n))
    dp = mma_product(do, v.transpose(-1, -2), 8, fresh=True)
    ds = p * (dp - torch.sum(do * o, dim=-1, keepdim=True)) * scale
    fresh = mma_product(ds, k, 64, fresh=True)
    one = mma_product(ds, k, 64, fresh=False)
    torch.testing.assert_close(fresh, want, **TOL)
    assert float((one - want).abs().max()) > 2 * float((fresh - want).abs().max())


def test_backward_tiling_covers_every_width():
    """The wrapper's choice of the backward kernels' variant for every head
    width from 1 to 512: a tile the kernels have, groups whose columns cover
    the padded width with the last group not empty, the narrow variants of
    today up to 64 features (16, 32 or 64, one group), and 128-wide tiles
    above."""
    for d in range(1, 513):
        padded = -(-d // 4) * 4                     # what _build.kernel_operands hands over
        tile, groups = fa.backward_tiling(d)
        assert (tile, groups) == fa.backward_tiling(padded), d
        assert tile in fa.NARROW_TILES + (fa.WIDE_TILE,), d
        assert groups >= 1 and groups * tile >= padded and (groups - 1) * tile < d, d
        if d <= 64:
            assert groups == 1 and tile == min(t for t in fa.NARROW_TILES if t >= d), d
        else:
            assert tile == fa.WIDE_TILE == 128 and groups == -(-d // 128), d
    with pytest.raises(ValueError):
        fa.backward_tiling(0)


def float64_backward(q, k, v, do):
    """dq, dk, dv of strictly-causal attention in float64, written out."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    n, d = q.shape[-2:]
    seen = torch.arange(n)[None, :] < torch.arange(n)[:, None]
    s = torch.where(seen, q @ k.transpose(-1, -2) / np.sqrt(d), torch.tensor(-np.inf).double())
    p = torch.nan_to_num(torch.softmax(s, dim=-1))          # row 0 attends nothing
    o = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True)) / np.sqrt(d)
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def test_wide_backward_arithmetic_sums_dp_over_the_whole_head():
    """The wide backward kernels' arithmetic at D = 128 (one 128-wide tile):
    scores as fp32 FMA chains; dP = dO·Vᵀ over all 128 features in one
    truncating accumulator (the 64-wide design took each 64-feature chunk
    into a fresh one); dsum an FMA chain; dq += dS·K a fresh accumulator per
    32-key tile, dK += dSᵀ·Q and dV += Pᵀ·dO a fresh one per 64-query tile.
    At B·H = 2, N = 512 each gradient stays within FA_TOL of float64 and of
    the plain fp32 backward."""
    q, k, v, do = (torch.from_numpy(a) for a in qkv(52, 2, 512, 128) + qkv(53, 2, 512, 128)[:1])
    n, d = q.shape[-2:]
    o, lse = fa.causal_attention_reference_lse(q, k, v)
    scale = np.float32(1.0 / np.sqrt(d))
    seen = torch.arange(n)[None, :] < torch.arange(n)[:, None]
    p = torch.where(seen, torch.exp(fma_chain_scores(q, k) * scale - lse), torch.zeros(n, n))
    dsum = fma_chain_scores(do[..., None, :], o[..., None, :])[..., 0]   # <do, o> a row
    dp = mma_product(do, v.transpose(-1, -2), d, fresh=False)
    ds = p * (dp - dsum) * scale
    got = (mma_product(ds, k, 32, fresh=True),
           mma_product(ds.transpose(-1, -2), q, 64, fresh=True),
           mma_product(p.transpose(-1, -2), do, 64, fresh=True))
    plain = fa.causal_attention_backward_reference(q, k, v, o, lse, do)
    exact = float64_backward(q, k, v, do)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, plain, exact):
        torch.testing.assert_close(g, w, **TOL, msg=name)
        torch.testing.assert_close(g.double(), x, **TOL, msg=name)


def float64_forward(q, k, v, keep=None, rate=0.0):
    """o of strictly-causal attention in float64, written out; ``keep`` and
    ``rate`` drop probabilities as the kernels do."""
    q, k, v = (t.double() for t in (q, k, v))
    n, d = q.shape[-2:]
    seen = torch.arange(n)[None, :] < torch.arange(n)[:, None]
    s = torch.where(seen, q @ k.transpose(-1, -2) / np.sqrt(d), torch.tensor(-np.inf).double())
    p = torch.nan_to_num(torch.softmax(s, dim=-1))          # row 0 attends nothing
    if keep is not None:
        p = p * keep.double() / (1.0 - rate)
    return p @ v


# keys of a ring stage of the wide forward kernel (FWDW_KT)
WIDE_FORWARD_KEY_TILE = 64


def wide_forward_arithmetic(q, k, v, keep=None, rate: float = 0.0,
                            key_tile: int = WIDE_FORWARD_KEY_TILE, chunk: int = 128):
    """o as the wide forward kernel forms it: each score one fp32 FMA chain
    over d, continued over ``chunk``-wide feature chunks in order; then key
    tiles of ``key_tile`` in turn, each with the online softmax's rescale
    (the running maximum, ``alpha = exp(m_old - m_new)``, the normaliser
    rescaled and the tile's undropped ``p`` added), ``p`` times ``keep`` and
    the fp32 ``1 / (1 - rate)``, ``P·V`` over the tile in three TF32 passes
    into a fresh truncating accumulator, added to the running ``o`` by one
    rounded fp32 FMA; ``o`` divided by the normaliser at the end."""
    n, d = q.shape[-2:]
    s = torch.zeros(q.shape[:-1] + (n,), dtype=torch.float32)
    for c0 in range(0, d, chunk):
        for c in range(c0, min(c0 + chunk, d)):
            s = (q[..., :, c, None].double() * k[..., None, :, c].double() + s.double()).float()
    scale = np.float32(1.0 / np.sqrt(d))
    inv_keep = np.float32(1.0 / (1.0 - rate))
    rows = torch.arange(n)[:, None]
    o = torch.zeros(q.shape, dtype=torch.float32)
    m = torch.full(q.shape[:-1] + (1,), fa.NEG_INF, dtype=torch.float32)
    norm = torch.zeros_like(m)
    for k0 in range(0, n, key_tile):
        keys = torch.arange(k0, min(k0 + key_tile, n))[None, :]
        seen = keys < rows
        tile = torch.where(seen, s[..., k0:k0 + key_tile] * scale, torch.tensor(fa.NEG_INF))
        m_new = torch.maximum(m, tile.max(dim=-1, keepdim=True).values)
        alpha = torch.exp(m - m_new)
        p = torch.where(seen, torch.exp(tile - m_new), torch.zeros_like(tile))
        norm = norm * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + key_tile], p * inv_keep, torch.zeros_like(p))
        part = mma_product(p, v[..., k0:k0 + key_tile, :], key_tile, fresh=False)
        o = (o.double() * alpha.double() + part.double()).float()
        m = m_new
    return o / torch.clamp(norm, min=1e-30)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [72, 128, 136])
def test_wide_forward_arithmetic_stays_within_fa_tol(d, rate):
    """The wide forward kernel's arithmetic at D = 72 (one 128-wide tile,
    zero past 72), 128 (one tile) and 136 (two chunks, the chains continued
    across them), without and with the kernel's dropout draw: 64-key tiles,
    each with the online softmax's rescale and a fresh truncating
    accumulator for P·V.  At B·H = 2, N = 512 o stays within FA_TOL of
    float64 and of the plain fp32 version given the same mask."""
    q, k, v = (torch.from_numpy(a) for a in qkv(54 + d, 2, 512, d))
    keep = fa.dropout_keep_reference(77, 2, 512, rate) if rate else None
    got = wide_forward_arithmetic(q, k, v, keep, rate)
    assert bool((got[:, 0] == 0).all())
    torch.testing.assert_close(
        got, fa.causal_attention_reference(q, k, v, keep=keep, dropout_rate=rate), **TOL)
    torch.testing.assert_close(got.double(), float64_forward(q, k, v, keep, rate), **TOL)


@pytest.mark.parametrize("d", [6, 1, 13])
def test_the_kernels_zero_pad_changes_no_score(d):
    """What the wrapper hands the CUDA kernels for a width that is no multiple
    of 4: q, k, v zero-padded to the next multiple of 4 (other widths pass
    through as they are); FMA-chain scores over the padded rows have the same
    bits as over the unpadded ones."""
    q, k, v = (torch.from_numpy(a) for a in qkv(70 + d, 3, 40, d))
    pq, pk, pv = _build.kernel_operands(q, k, v)
    assert pq.shape == (3, 40, -(-d // 4) * 4) and pk.shape == pv.shape == pq.shape
    assert all(bool((t[..., d:] == 0).all()) and torch.equal(t[..., :d], u)
               for t, u in ((pq, q), (pk, k), (pv, v)))
    assert torch.equal(fma_chain_scores(pq, pk).view(torch.int32),
                       fma_chain_scores(q, k).view(torch.int32))
    aligned = torch.from_numpy(qkv(1, 2, 8, 16)[0])
    assert _build.kernel_operands(aligned)[0] is aligned
