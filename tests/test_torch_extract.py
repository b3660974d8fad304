"""The slice as a whole: code extraction by both packages from the same weights
over the same images writes byte-identical ``.vq2`` files; the port's data and
checkpoint modules against their JAX counterparts."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.data import codestore as jax_codestore
from vqvae2_tpu.data import datasets as jax_datasets
from vqvae2_tpu.data import shapes as jax_shapes
from vqvae2_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae2_tpu.train import extract_codes as jax_extract
from vqvae2_tpu_torch.data import codestore, datasets, shapes
from vqvae2_tpu_torch.models import VQVAE, build_vqvae
from vqvae2_tpu_torch.train import extract_codes
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.jax_import import to_reference_state_dict, vqvae_from_jax

CFG = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)
CFG_ARGS = [f"--{k}={v}" for k, v in CFG.items()]
SIZE = 32


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def models():
    jmodel = JaxVQVAE(**CFG)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    g = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(variables["vq_stats"]))
    for q in stats:      # codebooks at the scale of the encoder's outputs
        stats[q]["embed"] = (0.3 * g.normal(size=stats[q]["embed"].shape)).astype(np.float32)
    variables = {"params": variables["params"],
                 "vq_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    model = VQVAE(**CFG).eval()
    model.load_state_dict(vqvae_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(variables))))
    return jmodel, variables, model


@pytest.mark.parametrize("dataset", ["synthetic", "shapes_uint8"])
def test_extract_writes_byte_identical_store(models, tmp_path, dataset):
    """n=12 at batch 8: a ragged last batch of 4, which the JAX side pads to its
    8 virtual devices and the port does not pad at all."""
    jmodel, variables, model = models
    if dataset == "synthetic":
        jdata, tdata = (m.SyntheticImages(n=12, size=SIZE) for m in (jax_datasets, datasets))
    else:
        jdata = jax_shapes.ShapesDataset(n=12, size=SIZE, raw=True)
        tdata = shapes.ShapesDataset(n=12, size=SIZE, raw=True)
    jpath, tpath = str(tmp_path / "jax.vq2"), str(tmp_path / "torch.vq2")
    n_jax = jax_extract.extract(jmodel, variables, jdata, jpath, batch_size=8, size=SIZE,
                                workers=0)
    n_port = extract_codes.extract(model, tdata, tpath, batch_size=8, size=SIZE, workers=2,
                                   device="cpu")
    assert n_jax == n_port == 12
    assert read(jpath) == read(tpath)
    # and either package reads the other's file
    store = codestore.CodeStore(jpath)
    top, bottom, label, name = store[11]
    store.close()
    assert top.shape == (4, 4) and bottom.shape == (8, 8) and label == 0
    assert name == ("synthetic/11.png" if dataset == "synthetic" else "shapes/000011.png")
    assert len(np.unique(bottom)) > 1


def test_ragged_last_batch_smaller_than_the_pad(models, tmp_path):
    """n=6 at batch 4 leaves a last batch of 2.  The port writes all 6 rows,
    each equal to a direct ``encode_ids``.  The JAX package cannot serve as the
    reference here: on its 8 virtual devices it pads with
    ``zeros_like(imgs[:pad])``, which has only 2 rows when pad is 6, then cuts
    6 rows off a batch of 4 and fails on the empty result."""
    jmodel, variables, model = models
    data = datasets.SyntheticImages(n=6, size=SIZE)
    path = str(tmp_path / "torch.vq2")
    assert extract_codes.extract(model, data, path, batch_size=4, size=SIZE, workers=0,
                                 device="cpu") == 6
    store = codestore.CodeStore(path)
    tops, bots, _, names = store.gather(np.arange(6), with_names=True)
    store.close()
    with torch.no_grad():
        id_t, id_b = model.encode_ids(torch.from_numpy(np.stack([data[i][0] for i in range(6)])))
    np.testing.assert_array_equal(tops, id_t.numpy())
    np.testing.assert_array_equal(bots, id_b.numpy())
    assert names == [f"synthetic/{i}.png" for i in range(6)]
    with pytest.raises(ValueError, match="cannot reshape array of size 0"):
        jax_extract.extract(jmodel, variables, jax_datasets.SyntheticImages(n=6, size=SIZE),
                            str(tmp_path / "jax.vq2"), batch_size=4, size=SIZE, workers=0)


@pytest.mark.parametrize("use_native", [True, False])
def test_codestore_backends_write_the_same_bytes(tmp_path, use_native):
    g = np.random.default_rng(1)
    tops = g.integers(0, 512, size=(5, 2, 2)).astype(np.int16)
    bots = g.integers(0, 512, size=(5, 4, 4)).astype(np.int16)
    labels = np.arange(5, dtype=np.int32)
    names = [f"img/{i}.png" for i in range(5)]
    paths = []
    for mod, tag in ((jax_codestore, "jax"), (codestore, "torch")):
        path = str(tmp_path / f"{tag}.vq2")
        with mod.CodeStoreWriter(path, (2, 2), (4, 4), use_native=use_native) as w:
            w.append(tops[:3], bots[:3], labels[:3], names[:3])
            assert w.append(tops[3:], bots[3:], labels[3:], names[3:]) == 5
        paths.append(path)
    assert read(paths[0]) == read(paths[1])
    assert len(read(paths[1])) == 56 + 5 * (2 * 4 + 2 * 16 + 4 + 64)
    store = codestore.CodeStore(paths[0], use_native=use_native)
    t, b, l, n = store.gather(np.array([4, 0]), with_names=True)
    store.close()
    np.testing.assert_array_equal(t, tops[[4, 0]])
    np.testing.assert_array_equal(b, bots[[4, 0]])
    assert list(l) == [4, 0] and n == ["img/4.png", "img/0.png"]
    assert codestore.HEADER.size == 56 and codestore.MAGIC == jax_codestore.MAGIC


def test_the_native_code_store_is_built_from_the_ports_own_source(tmp_path):
    """``use_native=True`` loads the library built from
    ``vqvae2_tpu_torch/data/csrc/codestore.cpp`` into the package's own
    ``data/_built/`` (named by a hash of the source), never the JAX
    package's ``native/`` build."""
    path = str(tmp_path / "native.vq2")
    with codestore.CodeStoreWriter(path, (2, 2), (4, 4), use_native=True) as w:
        w.append(np.zeros((1, 2, 2)), np.zeros((1, 4, 4)), np.zeros(1), ["a"])
    store = codestore.CodeStore(path, use_native=True)
    assert store.backend == "native" and len(store) == 1
    store.close()
    package = os.path.dirname(os.path.dirname(os.path.realpath(codestore.__file__)))
    lib = os.path.realpath(codestore._load_native()._name)
    assert lib == os.path.realpath(codestore.library_path())
    assert os.path.dirname(lib) == os.path.realpath(codestore.BUILD_DIR)
    assert lib.startswith(os.path.join(package, "data", "_built", "libcodestore_"))
    assert os.path.realpath(codestore.SOURCE) == os.path.join(package, "data", "csrc",
                                                              "codestore.cpp")


def test_use_native_raises_where_the_native_store_cannot_be_built(tmp_path, monkeypatch):
    """No compiler (or a failed build) is an error with ``use_native=True``,
    not a quiet switch to numpy; ``use_native=False`` takes the numpy
    backend."""
    monkeypatch.setattr(codestore, "_lib", None)
    monkeypatch.setattr(codestore, "library_path", lambda: str(tmp_path / "libcodestore.so"))
    monkeypatch.setattr(codestore.shutil, "which", lambda name: None)
    path = str(tmp_path / "codes.vq2")
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        codestore.CodeStoreWriter(path, (2, 2), (4, 4), use_native=True)
    with codestore.CodeStoreWriter(path, (2, 2), (4, 4), use_native=False) as w:
        w.append(np.zeros((1, 2, 2)), np.zeros((1, 4, 4)), np.zeros(1), ["a"])
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        codestore.CodeStore(path, use_native=True)
    assert codestore.CodeStore(path, use_native=False).backend == "numpy"
    assert not os.path.exists(tmp_path / "libcodestore.so")


def test_main_synthetic_random_init_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "codes.vq2")
    n = extract_codes.main(["--synthetic", "--random_init", "--device", "cpu", "--size",
                            str(SIZE), "--batch_size", "4", "--workers", "0", "--name", out,
                            *CFG_ARGS])
    assert n == 16
    assert "wrote 16 code rows" in capsys.readouterr().out
    store = codestore.CodeStore(out)
    assert len(store) == 16 and store.top_shape == (4, 4) and store.bot_shape == (8, 8)
    # the rows are what a direct encode_ids of the same seeded model gives
    model = build_vqvae(device="cpu", **CFG)
    data = datasets.SyntheticImages(n=16, size=SIZE)
    imgs = torch.from_numpy(np.stack([data[i][0] for i in range(12, 16)]))
    with torch.no_grad():
        id_t, id_b = model.encode_ids(imgs)
    tops, bots, _ = store.gather(np.arange(12, 16))
    store.close()
    np.testing.assert_array_equal(tops, id_t.numpy())
    np.testing.assert_array_equal(bots, id_b.numpy())


def test_main_restores_checkpoints(models, tmp_path):
    """``--ckpt_dir`` (the config comes from config.json, not the flags) and
    ``--torch_ckpt`` (reference layout, codebooks ``(D, K)``) give the file the
    model itself gives."""
    _, _, model = models
    data = datasets.SyntheticImages(n=8, size=SIZE)
    want = str(tmp_path / "want.vq2")
    extract_codes.extract(model, data, want, batch_size=2, size=SIZE, workers=0, device="cpu")

    ckpt_dir = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt_dir, config=model.config)
    mgr.save_last({"model": model.state_dict()})
    assert CheckpointManager(ckpt_dir).load_config()["channel"] == CFG["channel"]
    restored = CheckpointManager(ckpt_dir).restore("last")["model"]
    assert all(torch.equal(v, restored[k]) for k, v in model.state_dict().items())
    with pytest.raises(FileNotFoundError):
        mgr.restore("best")
    assert CheckpointManager(str(tmp_path / "fresh")).load_config() is None

    common = ["--synthetic", "--device", "cpu", "--size", str(SIZE), "--batch_size", "2",
              "--workers", "0"]
    got = str(tmp_path / "from_ckpt.vq2")
    extract_codes.main([*common, "--ckpt_dir", ckpt_dir, "--name", got])
    assert read(got) == read(want)

    torch_ckpt = str(tmp_path / "reference.pt")
    torch.save({"model": to_reference_state_dict(model.state_dict())}, torch_ckpt)
    got = str(tmp_path / "from_reference.vq2")
    extract_codes.main([*common, *CFG_ARGS, "--torch_ckpt", torch_ckpt, "--name", got])
    assert read(got) == read(want)


def test_to_unit_device_matches_jax():
    every_byte = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    want = np.asarray(jax_datasets.to_unit_device(jnp.asarray(every_byte)))
    got = datasets.to_unit_device(every_byte, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(datasets.normalize_to_unit(every_byte), want)
    floats = np.linspace(-1, 1, 12, dtype=np.float32).reshape(1, 2, 2, 3)
    np.testing.assert_array_equal(datasets.to_unit_device(floats, device="cpu").numpy(), floats)


def test_datasets_match_jax(tmp_path):
    a, b = jax_datasets.SyntheticImages(n=3, size=8, seed=2), datasets.SyntheticImages(
        n=3, size=8, seed=2)
    for i in range(3):
        np.testing.assert_array_equal(a[i][0], b[i][0])
        assert a[i][1:] == b[i][1:]
    np.testing.assert_array_equal(jax_shapes.render_shapes_image(3, 32),
                                  shapes.render_shapes_image(3, 32))
    batches = list(datasets.iterate_batches(b, 2, shuffle=False, drop_last=False, workers=2))
    assert [len(x[0]) for x in batches] == [2, 1]
    assert batches[1][2] == ["synthetic/2.png"]

    from PIL import Image
    os.makedirs(tmp_path / "cls")
    Image.fromarray(shapes.render_shapes_image(0, 48)).save(tmp_path / "cls" / "a.png")
    ja = jax_datasets.ImageFileDataset(str(tmp_path), size=32, raw=True)[0]
    ta = datasets.ImageFileDataset(str(tmp_path), size=32, raw=True)[0]
    np.testing.assert_array_equal(ja[0], ta[0])
    assert ja[1:] == ta[1:] == (0, os.path.join("cls", "a.png"))
