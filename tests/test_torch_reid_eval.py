"""The port's retrieval evaluation against the JAX package's: the SYSU-MM01
metric (identity-deduplicated CMC, mAP, mINP), the k-reciprocal re-ranking,
the SYSU test lists, and ``validate`` end to end on a tiny raw SYSU-MM01 tree
through ``EmbedNet2`` (resnet18) with one set of seeded weights on both sides.

The metrics are the same numpy code on both sides: equal to 1e-6.  The
features of the two eval forwards agree to 1e-5 (fp32 convolutions summed in
another order), and so do the mAPs computed from them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vqvae2_tpu.data import sysu as jsysu
from vqvae2_tpu.eval import reid as jev
from vqvae2_tpu.part.part_model import EmbedNet2 as JEmbedNet2
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.eval import reid as tev
from vqvae2_tpu_torch.part.part_model import EmbedNet2
from vqvae2_tpu_torch.utils.jax_import import embed_net2_from_jax


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_sysu(seed):
    g = np.random.default_rng(seed)
    q_pids, g_pids = g.integers(0, 12, size=30), g.integers(0, 10, size=90)
    distmat = g.normal(size=(30, 90)).astype(np.float32)
    want = jev.eval_sysu(distmat, q_pids, g_pids)
    got = tev.eval_sysu(distmat, q_pids, g_pids)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert got[1] == pytest.approx(want[1], rel=1e-6) and got[2] == pytest.approx(want[2], rel=1e-6)


def test_rerank_dist_and_cosine():
    g = np.random.default_rng(2)
    q, gal = g.normal(size=(7, 16)).astype(np.float32), g.normal(size=(25, 16)).astype(np.float32)
    np.testing.assert_allclose(tev.rerank_dist(q, gal), jev.rerank_dist(q, gal), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tev.cosine_distmat(q, gal), jev.cosine_distmat(q, gal), rtol=1e-6)
    ql, gl = g.integers(0, 3, size=7), g.integers(0, 3, size=25)
    cams = np.zeros(7), np.zeros(25)
    for rerank in (False, True):
        want = jev.test_retrieval(q, ql, cams[0], gal, gl, cams[1], rerank=rerank)
        got = tev.test_retrieval(q, ql, cams[0], gal, gl, cams[1], rerank=rerank)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        assert got[1] == pytest.approx(want[1], rel=1e-6)


def write_raw_sysu(root, ids=(1, 2, 3), per_cam=2, hw=(64, 32), seed=0):
    """A raw SYSU-MM01 tree: ``cam1..cam6/<id>/<n>.jpg`` and
    ``exp/test_id.txt``."""
    g = np.random.default_rng(seed)
    (root / "exp").mkdir(parents=True)
    (root / "exp" / "test_id.txt").write_text(",".join(map(str, ids)) + "\n")
    for cam in range(1, 7):
        for pid in ids:
            d = root / f"cam{cam}" / f"{pid:04d}"
            d.mkdir(parents=True)
            for k in range(per_cam):
                arr = g.integers(0, 255, size=(*hw, 3)).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{k:04d}.jpg")
    return root


def test_sysu_test_lists_are_the_jax_packages(tmp_path):
    root = write_raw_sysu(tmp_path / "SYSU-MM01")
    for data, mode in (("query", "all"), ("gallery", "all"), ("gallery", "indoor"),
                       ("query", "Vis")):
        want = jsysu.process_sysu(str(root), data=data, mode=mode, rng=np.random.default_rng(3))
        got = tsysu.process_sysu(str(root), data=data, mode=mode, rng=np.random.default_rng(3))
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    files, labels, cams = want
    a = tsysu.TestData(files, labels, cams, img_size=(16, 32))
    b = jsysu.TestData(files, labels, cams, img_size=(16, 32))
    np.testing.assert_array_equal(next(a.batches(3))[0], next(b.batches(3))[0])


def seeded(shapes, g):
    """Seeded values: He-scaled kernels, scales near 1 (0 for the non-local
    blocks' output scale, as flax starts it), small biases and means,
    variances in [0.5, 1.5]."""
    def fill(path, s):
        keys = [getattr(k, "key", str(k)) for k in path]
        leaf = keys[-1]
        if leaf in ("var", "running_var"):
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "running_mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf in ("scale", "weight"):
            return np.zeros(s.shape, np.float32) if "W_bn" in keys else (
                1 + g.normal(0, 0.1, s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt((2.0 if len(s.shape) == 4 else 1.0) / fan)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_validate_end_to_end(tmp_path):
    """``validate`` on a tiny raw tree with one set of weights: the port's
    features and mAP against the JAX package's."""
    root = write_raw_sysu(tmp_path / "SYSU-MM01")
    hw = (72, 36)
    jmod = JEmbedNet2(class_num=3, arch="resnet18")
    probe = jnp.zeros((1, *hw, 3))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xRGB=probe, xIR=probe,
                                              xZ=probe, modal=0, train=True))
    variables = seeded(shapes, np.random.default_rng(5))
    model = EmbedNet2(class_num=3, arch="resnet18")
    model.load_state_dict(embed_net2_from_jax(variables))
    model.train()

    imgs = tsysu.imagenet_normalize(np.random.default_rng(4).integers(
        0, 255, size=(3, *hw, 3)).astype(np.uint8))
    want = jax.jit(lambda v, x: jmod.apply(v, xRGB=x, modal=1))(variables, jnp.asarray(imgs))[1]
    with torch.no_grad():
        got = model.eval()(xRGB=torch.from_numpy(imgs), modal=1)[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    model.train()
    # one batch a side (12 query and 12 gallery images): one compile each for JAX
    mAP = tev.validate(model, str(root), img_size=(hw[1], hw[0]), test_batch=12, device="cpu")
    assert model.training, "validate gives the model back in the mode it had"
    want_map = jev.validate(jmod, variables, str(root), img_size=(hw[1], hw[0]), test_batch=12)
    assert 0.0 <= mAP <= 1.0
    assert mAP == pytest.approx(want_map, abs=1e-5)
