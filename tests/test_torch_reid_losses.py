"""The port's ReID and parsing losses against the JAX package's, on the same
numpy inputs made from a seed: ``losses.py`` (distances, the three triplets),
``part/lovasz.py`` and ``part/criterion.py`` (``generate_edge`` bit-equal;
masked and class-weighted CE, consistency, KL, ``criterion_all``, the part-wise
InfoNCE, SupCon).  Values and gradients.

Tolerance rtol 1e-5 / atol 1e-6 on values and gradients (fp32 sums in another
order).  The Lovasz sort is not stable on either side: the loss does not
depend on the order of tied errors, its gradient does, so the inputs are
continuous (no ties but among ignored pixels, which get no gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu import losses as JL
from vqvae2_tpu.part import criterion as JC
from vqvae2_tpu.part import lovasz as JLV
from vqvae2_tpu_torch import losses as TL
from vqvae2_tpu_torch.part import criterion as TC
from vqvae2_tpu_torch.part import lovasz as TLV

TOL = dict(rtol=1e-5, atol=1e-6)


def _both(jfn, tfn, *arrays, grad_of=(0,), **kw):
    """Value and gradients (w.r.t. the float arrays at ``grad_of``) of a
    scalar loss on both sides; asserts the agreement."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in grad_of:
        targs[i].requires_grad_()
    jval, jgrads = jax.jit(jax.value_and_grad(lambda *a: jfn(*a, **kw), argnums=grad_of))(*jargs)
    tval = tfn(*targs, **kw)
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval), **TOL)
    tval.backward()
    for i, g in zip(grad_of, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(g), **TOL)
    return float(tval)


def _rng(seed):
    return np.random.default_rng(seed)


def _feats(n, d, seed):
    return _rng(seed).normal(size=(n, d)).astype(np.float32)


def _labels(n, ids, seed):
    return _rng(seed).integers(0, ids, size=(n,)).astype(np.int32)


def test_pdist():
    _both(lambda a, b: jnp.sum(jnp.sin(JL.pdist(a, b))),
          lambda a, b: torch.sum(torch.sin(TL.pdist(a, b))),
          _feats(6, 5, 0), _feats(4, 5, 1), grad_of=(0, 1))


@pytest.mark.parametrize("margin", [0.3, 5.0])
def test_triplet_loss(margin):
    x, y = _feats(8, 6, 2), _labels(8, 3, 3)
    _both(lambda a, b: JL.triplet_loss(a, b, margin)[0],
          lambda a, b: TL.triplet_loss(a, b, margin)[0], x, y)
    assert int(TL.triplet_loss(torch.from_numpy(x), torch.from_numpy(y), margin)[1]) == int(
        JL.triplet_loss(jnp.asarray(x), jnp.asarray(y), margin)[1])


@pytest.mark.parametrize("normalize", [False, True])
def test_triplet_loss_wrt(normalize):
    x, y = _feats(8, 6, 4), _labels(8, 3, 5)
    _both(lambda a, b: JL.triplet_loss_wrt(a, b, normalize)[0],
          lambda a, b: TL.triplet_loss_wrt(a, b, normalize)[0], x, y)


def test_cross_triplet_loss():
    a, p, n = _feats(6, 5, 6), _feats(6, 5, 7), _feats(6, 5, 8)
    l1, l2, l3 = _labels(6, 3, 9), _labels(6, 3, 9), _labels(6, 3, 10)
    _both(JL.cross_triplet_loss, TL.cross_triplet_loss, a, p, n, l1, l2, l3, grad_of=(0, 1, 2))


def _probas(shape, seed):
    logits = _rng(seed).normal(size=shape).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _part_labels(shape, c, seed, ignore_share=0.1):
    g = _rng(seed)
    lab = g.integers(0, c, size=shape).astype(np.int32)
    lab[g.random(shape) < ignore_share] = JC.IGNORE
    return lab


@pytest.mark.parametrize("weighted", [False, True])
def test_lovasz_softmax(weighted):
    probas, labels = _probas((2, 9, 7, 5), 11), _part_labels((2, 9, 7), 4, 12)  # class 4 absent
    weights = (_rng(13).uniform(0.5, 2.0, size=(5,)).astype(np.float32),) if weighted else ()
    _both(lambda p, lab, *w: JLV.lovasz_softmax(p, lab, class_weights=w[0] if w else None),
          lambda p, lab, *w: TLV.lovasz_softmax(p, lab, class_weights=w[0] if w else None),
          probas, labels, *weights)


def test_lovasz_softmax_with_every_pixel_ignored_is_zero():
    probas = torch.from_numpy(_probas((1, 3, 3, 4), 14))
    assert float(TLV.lovasz_softmax(probas, torch.full((1, 3, 3), 255))) == 0.0


def test_lovasz_loss_does_not_depend_on_the_order_of_ties():
    """Exact ties in the errors: the value still agrees."""
    probas = np.full((1, 4, 4, 3), 1.0 / 3.0, np.float32)
    labels = _part_labels((1, 4, 4), 3, 15, ignore_share=0.0)
    want = JLV.lovasz_softmax(jnp.asarray(probas), jnp.asarray(labels))
    got = TLV.lovasz_softmax(torch.from_numpy(probas), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_lovasz_hinge():
    logits = _rng(16).normal(size=(2, 6, 5)).astype(np.float32)
    labels = _part_labels((2, 6, 5), 2, 17)
    _both(JLV.lovasz_hinge, TLV.lovasz_hinge, logits, labels)


@pytest.mark.parametrize("seed", [18, 19])
def test_generate_edge_is_bit_equal(seed):
    labels = _part_labels((3, 17, 11), 7, seed, ignore_share=0.2)
    labels[0, :5] = 2                                   # flat regions have no edge
    want = np.asarray(JC.generate_edge(jnp.asarray(labels)))
    got = TC.generate_edge(torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    want5 = np.asarray(JC.generate_edge(jnp.asarray(labels), edge_width=5))
    np.testing.assert_array_equal(TC.generate_edge(torch.from_numpy(labels), 5).numpy(), want5)


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_cross_entropy(weighted):
    logits = _rng(20).normal(size=(2, 5, 4, 3)).astype(np.float32)
    labels = _part_labels((2, 5, 4), 3, 21)
    weights = (np.asarray([0.2, 0.5, 0.3], np.float32),) if weighted else ()
    _both(lambda lg, lab, *w: JC.masked_cross_entropy(lg, lab, class_weights=w[0] if w else None),
          lambda lg, lab, *w: TC.masked_cross_entropy(lg, lab, class_weights=w[0] if w else None),
          logits, labels, *weights)


def test_consistency_and_kl():
    parsing = _rng(22).normal(size=(2, 8, 6, 4)).astype(np.float32)
    edge = _rng(23).normal(size=(2, 8, 6, 2)).astype(np.float32)
    labels = _part_labels((2, 8, 6), 4, 24)
    want = JC.consistency_loss(jnp.asarray(parsing), jnp.asarray(edge), jnp.asarray(labels))
    got = TC.consistency_loss(torch.from_numpy(parsing), torch.from_numpy(edge),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    teacher = _rng(25).normal(size=(2, 8, 6, 4)).astype(np.float32)
    _both(lambda s, t, lab: JC.kl_divergence_loss(s, t, lab, T=2.0),
          lambda s, t, lab: TC.kl_divergence_loss(s, t, lab, T=2.0), parsing, teacher, labels)


def test_criterion_all():
    """Two parsing heads and one edge head at a quarter of the label grid,
    resized up (anti-aliased linear, as jax.image.resize)."""
    g = _rng(26)
    p1, p2 = (g.normal(size=(2, 6, 4, 5)).astype(np.float32) for _ in range(2))
    edge = g.normal(size=(2, 6, 4, 2)).astype(np.float32)
    labels = _part_labels((2, 24, 16), 5, 27)
    edges = np.asarray(JC.generate_edge(jnp.asarray(labels))).astype(np.int32)
    edges[labels == JC.IGNORE] = JC.IGNORE
    value = _both(lambda a, b, e, lab, ed: JC.criterion_all([a, b], [e], lab, ed),
                  lambda a, b, e, lab, ed: TC.criterion_all([a, b], [e], lab, ed),
                  p1, p2, edge, labels, edges, grad_of=(0, 1, 2))
    assert np.isfinite(value)


@pytest.mark.parametrize("b,k", [(6, 6), (3, 2)])
def test_contrastive_loss(b, k):
    feats = _rng(28).normal(size=(b, k, 8)).astype(np.float32)
    _both(JC.contrastive_loss, TC.contrastive_loss, feats)


@pytest.mark.parametrize("with_labels", [False, True])
def test_sup_con_loss(with_labels):
    feats = _rng(29).normal(size=(4, 2, 6)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    if with_labels:
        labels = np.asarray([0, 1, 0, 2], np.int32)
        _both(lambda f, lab: JC.sup_con_loss(f, lab), lambda f, lab: TC.sup_con_loss(f, lab),
              feats, labels)
    else:
        _both(JC.sup_con_loss, TC.sup_con_loss, feats)
