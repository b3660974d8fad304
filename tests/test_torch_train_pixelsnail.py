"""The port's prior trainer against the JAX package's: a toy top prior
(attention, 8×8 grid) and a toy bottom prior (conditioned, 16×16 grid), channel
32, the JAX module's initial parameters carried across
(``pixelsnail_from_jax``), a fresh Adam on both sides, the same numpy codes.
One ``make_train_step``: loss, accuracy and every parameter.

``--dropout 0`` turns off every dropout of the top prior.  The bottom prior's
conditioning blocks drop at 0.1 whatever ``--dropout`` says (as in the
reference), so there the JAX side is its train step's loss and Adam update
with ``train=False``, and the port's blocks are set to rate 0: the port still
runs its train-mode path, with nothing drawn.

With dropout on, the draws are the port's own (a generator from the seed and
the step), so what is held is their effect: train mode differs from eval
mode, a step is repeatable for one seed and differs between seeds.

Tolerance: rtol 2e-4 / atol 2e-5, what the JAX package holds its incremental
decoder to (fp32 convolutions and matrix products summed in another order).
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae2_tpu.train import pixelsnail as jtp
from vqvae2_tpu_torch.models.pixelsnail import GatedResBlock
from vqvae2_tpu_torch.train import pixelsnail as tp
from vqvae2_tpu_torch.train.vqvae import create_state
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import pixelsnail_from_jax

RTOL, ATOL = 2e-4, 2e-5
LR = 3e-4
CODE_HW = (8, 16)
N_CLASS = 16


def args(dropout=0.0):
    return argparse.Namespace(n_class=N_CLASS, channel=32, n_res_block=1, n_res_channel=32,
                              n_out_res_block=0, n_cond_res_block=1, dropout=dropout,
                              bf16=False)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def make_batch(hier, seed=0, batch=2):
    g = np.random.default_rng(seed)
    top = g.integers(0, N_CLASS, size=(batch, 8, 8)).astype(np.int32)
    if hier == "top":
        return {"target": top}
    return {"target": g.integers(0, N_CLASS, size=(batch, 16, 16)).astype(np.int32),
            "condition": top}


@functools.lru_cache(maxsize=None)
def jax_start(hier):
    jmodel = jtp.build_model(hier, args(), code_hw=CODE_HW)
    batch = make_batch(hier)
    cond = jnp.asarray(batch["condition"][:1]) if hier == "bottom" else None
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["target"][:1]),
                         condition=cond)["params"]
    return jmodel, host(params)


def port_model(hier, dropout=0.0):
    _, params = jax_start(hier)
    with torch.random.fork_rng(devices=[]):
        model = tp.build_model(hier, args(dropout), code_hw=CODE_HW)
    model.load_state_dict(pixelsnail_from_jax({"params": params}, model))
    return model


def jax_bottom_step_without_dropout(jmodel, params, batch):
    """The JAX train step's loss and update, with ``train=False``."""
    tx = optax.adam(LR)
    codes = jnp.asarray(batch["target"])

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, codes, condition=jnp.asarray(batch["condition"]))
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), codes).mean()
        return ce, jnp.mean(jnp.argmax(logits, axis=-1) == codes)

    (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates), {"loss": loss, "acc": acc}


@pytest.mark.parametrize("hier", ["top", "bottom"])
def test_one_train_step_matches_jax(hier):
    jmodel, params = jax_start(hier)
    batch = make_batch(hier)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    if hier == "top":
        tx = optax.adam(LR)
        jstate = jtp.PriorState(step=jnp.zeros((), jnp.int32), params=jparams,
                                opt_state=tx.init(jparams))
        jstate, jm = jtp.make_train_step(jmodel, tx, conditional=False)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
        new_params = jstate.params
    else:
        new_params, jm = jax_bottom_step_without_dropout(jmodel, jparams, batch)

    model = port_model(hier)
    for mod in model.modules():
        if isinstance(mod, GatedResBlock):
            mod.dropout = 0.0
    tx = schedules.adam(LR)
    state = create_state(model, tx)
    step = tp.make_train_step(model, tx, conditional=hier == "bottom", seed=1)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1 and model.training
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
    assert float(m["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-6)
    assert abs(float(m["loss"]) - np.log(N_CLASS)) < 1.0      # starts near ln(n_class)
    want = pixelsnail_from_jax({"params": host(new_params)}, model)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def one_step(seed, hier="top", dropout=0.1, train=True):
    model = port_model(hier, dropout)
    tx = schedules.adam(LR)
    state = create_state(model, tx)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(hier).items()}
    if not train:
        model.eval()
    step = tp.make_train_step(model, tx, conditional=hier == "bottom", seed=seed)
    _, m = step(state, batch)
    return float(m["loss"]), {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("hier", ["top", "bottom"])
def test_dropout_is_drawn_from_the_seed_and_the_step(hier):
    loss, params = one_step(5, hier)
    again, params_again = one_step(5, hier)
    other, params_other = one_step(6, hier)
    no_dropout, _ = one_step(5, hier, train=False)
    assert loss == again and all(torch.equal(params[k], params_again[k]) for k in params)
    assert loss != other and any(not torch.equal(params[k], params_other[k]) for k in params)
    assert loss != no_dropout


def test_step_generator_depends_on_seed_and_step_only():
    def draw(seed, step):
        return torch.rand(4, generator=tp.step_generator(seed, step, "cpu"))

    assert torch.equal(draw(1, 7), draw(1, 7))
    assert not torch.equal(draw(1, 7), draw(1, 8)) and not torch.equal(draw(1, 7), draw(2, 7))


@pytest.mark.parametrize("hier", ["top", "bottom"])
def test_build_model_takes_bf16(hier):
    """``bf16`` builds the prior with bf16 compute and fp32 parameters, as the
    JAX package's ``build_model`` does; its logits are bf16 and its train
    step's loss and metrics fp32."""
    model = tp.build_model(hier, argparse.Namespace(**{**vars(args()), "bf16": True}),
                           code_hw=CODE_HW)
    jmodel = jtp.build_model(hier, argparse.Namespace(**{**vars(args()), "bf16": True}),
                             code_hw=CODE_HW)
    assert model.dtype == torch.bfloat16 and jmodel.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    batch = {k: torch.from_numpy(v) for k, v in make_batch(hier).items()}
    assert model.eval()(batch["target"], condition=batch.get("condition")).dtype == torch.bfloat16
    tx = schedules.adam(LR)
    _, metrics = tp.make_train_step(model, tx, conditional=hier == "bottom")(
        create_state(model, tx), batch)
    assert metrics["loss"].dtype == torch.float32 and bool(torch.isfinite(metrics["loss"]))
