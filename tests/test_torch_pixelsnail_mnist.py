"""``train/pixelsnail_mnist.py`` of the port against the JAX package's: the
synthetic digits bit for bit, the idx reader on a tiny idx file written here
(plain and gzipped), one training step at dropout 0 from the same weights
(rtol 2e-4 / atol 2e-5, the tolerance of ``tests/test_torch_train_pixelsnail.py``),
and the command line on the CPU."""

import gzip
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae2_tpu.models.pixelsnail import PixelSNAIL as JaxPixelSNAIL
from vqvae2_tpu.train import pixelsnail_mnist as jmn
from vqvae2_tpu_torch.train import pixelsnail_mnist as pmn
from vqvae2_tpu_torch.train import vqvae as tv
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import pixelsnail_from_jax

RTOL, ATOL = 2e-4, 2e-5
LR = 3e-4
CHANNEL = 16


def write_idx(path: str, images: np.ndarray, gz: bool = False, magic: int = 2051) -> None:
    n, h, w = images.shape
    payload = struct.pack(">IIII", magic, n, h, w) + images.astype(np.uint8).tobytes()
    with (gzip.open if gz else open)(path + (".gz" if gz else ""), "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("n,seed", [(12, 0), (5, 3)])
def test_synthetic_digits_are_the_jax_packages_bit_for_bit(n, seed):
    got = pmn.synthetic_digits(n, seed)
    assert got.dtype == np.uint8 and got.shape == (n, 28, 28)
    assert np.array_equal(got, jmn.synthetic_digits(n, seed))


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_the_idx_reader_reads_what_the_jax_reader_reads(tmp_path, gz):
    images = np.random.default_rng(1).integers(0, 256, size=(3, 5, 4)).astype(np.uint8)
    write_idx(str(tmp_path / "train-images-idx3-ubyte"), images, gz=gz)
    got = pmn.load_mnist_images(str(tmp_path))
    assert np.array_equal(got, images) and np.array_equal(got, jmn.load_mnist_images(str(tmp_path)))


def test_a_bad_magic_or_a_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no MNIST idx files"):
        pmn.load_mnist_images(str(tmp_path))
    write_idx(str(tmp_path / "train-images.idx3-ubyte"), np.zeros((1, 2, 2)), magic=2049)
    with pytest.raises(ValueError, match="bad idx magic 2049"):
        pmn.load_mnist_images(str(tmp_path))


def test_one_training_step_matches_jax_at_dropout_0():
    """The JAX trainer's model and loss (``vqvae2_tpu/train/pixelsnail_mnist.py``:
    the cross-entropy over 256 intensities, accuracy beside it) and one Adam
    step, against the port's ``make_train_step``."""
    args = pmn.build_argparser().parse_args(["--channel", str(CHANNEL), "--dropout", "0"])
    codes = jmn.synthetic_digits(2, seed=4).astype(np.int32)
    jmodel = JaxPixelSNAIL(shape=(28, 28), n_class=256, channel=CHANNEL, kernel_size=5,
                           n_block=2, n_res_block=4, res_channel=CHANNEL, dropout=0.0)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(codes[:1]))["params"])

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(codes), train=True)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(codes)).mean()
        return ce, jnp.mean(jnp.argmax(logits, -1) == codes)

    (loss, acc), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = optax.adam(LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = jax.device_get(optax.apply_updates(params, updates))

    model = pmn.build_model(args)
    model.load_state_dict(pixelsnail_from_jax({"params": params}, model))
    sched = schedules.adam(LR)
    state = tv.create_state(model, sched)
    state, metrics = pmn.make_train_step(model, sched)(state, torch.from_numpy(codes).long())
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(metrics["acc"]), float(acc), rtol=RTOL, atol=ATOL)
    want = pixelsnail_from_jax({"params": new_params}, model)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("data", ["synthetic", "idx"])
def test_main_trains_on_the_cpu(tmp_path, data):
    csv = str(tmp_path / "m.csv")
    argv = ["--device", "cpu", "--steps", "2", "--channel", str(CHANNEL), "--batch", "2",
            "--log_every", "1", "--metrics_csv", csv]
    if data == "idx":
        write_idx(str(tmp_path / "train-images-idx3-ubyte"), pmn.synthetic_digits(8, seed=5))
        argv += ["--path", str(tmp_path)]
    else:
        argv += ["--n_synthetic", "8"]
    m = pmn.main(argv)
    assert np.isfinite(m["loss"]) and 0.0 <= m["acc"] <= 1.0
    with open(csv) as f:
        assert len(f.read().strip().splitlines()) == 3


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    assert pmn.build_argparser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        pmn.main(["--steps", "1", "--metrics_csv", str(tmp_path / "m.csv")])
    assert os.listdir(str(tmp_path)) == []
