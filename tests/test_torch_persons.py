"""The port's procedural person corpus (``data/persons.py``) against the JAX
package's: every array bit-equal for the same seed (identity attributes,
both modalities' images and part maps), every blob file and every JPEG of the
raw evaluation tree byte for byte, and the blobs loading through the port's
``SYSUData``."""

import filecmp
import os

import numpy as np
import pytest

from vqvae2_tpu.data import persons as jp
from vqvae2_tpu_torch.data import persons as tp


@pytest.mark.parametrize("pid,seed", [(0, 0), (5, 3)])
def test_identity_attrs_are_bit_equal(pid, seed):
    got, want = tp.identity_attrs(pid, seed), jp.identity_attrs(pid, seed)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("modal", ["rgb", "ir"])
@pytest.mark.parametrize("hw", [(288, 144), (96, 48)])
def test_render_person_is_bit_equal(modal, hw):
    for pid, inst in ((0, 0), (3, 7), (11, 100002)):
        img, part = tp.render_person(pid, inst, hw, seed=1, modal=modal)
        want_img, want_part = jp.render_person(pid, inst, hw, seed=1, modal=modal)
        assert img.dtype == np.uint8 and part.dtype == np.uint8 and img.shape == (*hw, 3)
        np.testing.assert_array_equal(img, want_img)
        np.testing.assert_array_equal(part, want_part)
    assert (tp.BG, tp.HEAD, tp.TORSO, tp.LEGS, tp.ARMS) == (jp.BG, jp.HEAD, jp.TORSO, jp.LEGS,
                                                            jp.ARMS)


def test_blob_files_are_byte_equal(tmp_path):
    got = tp.save_person_sysu(str(tmp_path / "port"), n_ids=3, per_id=5, hw=(96, 48), seed=2)
    want = jp.save_person_sysu(str(tmp_path / "jax"), n_ids=3, per_id=5, hw=(96, 48), seed=2)
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and len(names) == 8
    match, mismatch, errors = filecmp.cmpfiles(got, want, names, shallow=False)
    assert match == names and not mismatch and not errors


def test_eval_tree_is_byte_equal(tmp_path):
    got = tp.save_person_sysu_eval(str(tmp_path / "port"), n_ids=2, per_id=2, hw=(64, 32))
    want = jp.save_person_sysu_eval(str(tmp_path / "jax"), n_ids=2, per_id=2, hw=(64, 32))
    files = sorted(os.path.relpath(os.path.join(r, f), want)
                   for r, _, fs in os.walk(want) for f in fs)
    assert len(files) == 1 + 6 * 2 * 2
    assert files == sorted(os.path.relpath(os.path.join(r, f), got)
                           for r, _, fs in os.walk(got) for f in fs)
    for f in files:
        assert filecmp.cmp(os.path.join(got, f), os.path.join(want, f), shallow=False), f


def test_the_blobs_load_through_the_ports_sysudata(tmp_path):
    from vqvae2_tpu_torch.data.sysu import SYSUData

    root = tp.save_person_sysu(str(tmp_path / "d"), n_ids=3, per_id=4, hw=(96, 48))
    ds = SYSUData(root, part=True, seed=0)
    assert ds.num_class == 3 and ds.train_ir_image.shape == (12, 96, 48, 3)
    assert set(np.unique(ds.train_color_cam)) <= {1, 2, 4, 5}
    assert set(np.unique(ds.train_ir_cam)) <= {3, 6}
