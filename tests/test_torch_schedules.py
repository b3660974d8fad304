"""The port's schedules against the JAX package's, at the first steps, around
every phase boundary and at the last step; ``AdamSchedule`` driving
``torch.optim.Adam`` against optax over five updates of a toy parameter; the
LR finder's record.

Tolerances: schedules rtol 1e-5 with an absolute floor of 1e-6 of the peak
value (the JAX schedules run in fp32, the port's in fp64: a cosine near its
end point loses its relative digits in fp32); parameters after five Adam
updates at the trainers' lr of 3e-4, rtol 1e-6 (optax keeps β₂ in fp32, where
``1 - 0.999`` is off by 1.3e-5 relative, so an update differs from torch's by
about 1e-5 of its size: below the tolerance at that lr, not at 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae2_tpu.utils import schedules as js
from vqvae2_tpu_torch.utils import schedules as ts

N_ITER = 100


def steps_around(*boundaries, last=N_ITER - 1):
    out = {0, 1, last}
    for b in boundaries:
        out |= {b - 1, b, b + 1}
    return sorted(s for s in out if s >= 0)


# name -> (arguments, the steps that matter)
CASES = {
    "cycle_schedule": ((3e-4, N_ITER), steps_around(30)),
    "cycle_momentum_schedule": ((N_ITER,), steps_around(30)),
    "cosine_lr": ((1e-5, 1e-3, 40), steps_around(40, 80)),
    "power_lr": ((1e-5, 1e-3, 25), steps_around(25)),
    "sine_lr": ((1e-5, 1e-3, 40), steps_around(20, 40)),
    "linear_lr": ((1e-5, 1e-3, 10, 40), steps_around(10, 40, 50)),
    "clr": ((1e-5, 1e-3, 20), steps_around(20, 40)),
    "noam_warmup": ((256, 1.0, 30), steps_around(30)),
    "cycle_anneal": ((1e-3, 10.0, 10, 50), steps_around(22, 45, 50)),
    "lr_finder": ((1e-6, 1.0, N_ITER), steps_around()),
    "multi_step_lr": ((0.1, [30, 60]), steps_around(30, 60)),
    "stepped_reid_lr": ((3.5e-4,), steps_around(20, 60, 120, last=130)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax(name):
    args, steps = CASES[name]
    want_fn, got_fn = getattr(js, name)(*args), getattr(ts, name)(*args)
    want = np.array([float(want_fn(jnp.asarray(s))) for s in steps])
    got = np.array([got_fn(s) for s in steps])
    assert all(isinstance(got_fn(s), float) for s in steps)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_linear_lr_finder_matches_jax():
    want_fn, got_fn = js.lr_finder(1e-4, 1e-1, 50, linear=True), ts.lr_finder(1e-4, 1e-1, 50, linear=True)
    for s in (0, 1, 25, 49):
        np.testing.assert_allclose(got_fn(s), float(want_fn(s)), rtol=1e-6)


def run_optax(tx, grads_at, steps=5):
    p = {"w": jnp.asarray(np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(2, 3))}
    state = tx.init(p)
    for t in range(steps):
        updates, state = tx.update({"w": jnp.asarray(grads_at(t, np.asarray(p["w"])))}, state, p)
        p = optax.apply_updates(p, updates)
    return np.asarray(p["w"])


def run_torch(sched, grads_at, steps=5):
    w = torch.nn.Parameter(torch.from_numpy(np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(2, 3)))
    opt = sched.build([w])
    for t in range(steps):
        w.grad = torch.from_numpy(grads_at(t, w.detach().numpy().copy()))
        sched.apply(opt, t)
        opt.step()
    return w.detach().numpy()


def toy_grads(t, w):
    """A gradient that depends on the parameter and the step."""
    return (np.sin(3.0 * w) + 0.1 * (t + 1)).astype(np.float32)


@pytest.mark.parametrize("momentum", [(0.95, 0.85), None], ids=["beta1 scheduled", "beta1 fixed"])
def test_cycle_adam_drives_torch_adam_as_optax(momentum):
    n_iter = 10                                    # phase boundary at step 3, inside the run
    want = run_optax(js.cycle_adam(3e-4, n_iter, momentum=momentum), toy_grads)
    got = run_torch(ts.cycle_adam(3e-4, n_iter, momentum=momentum), toy_grads)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_cycle_adam_writes_lr_and_beta1_into_the_groups():
    w = torch.nn.Parameter(torch.zeros(3))
    sched = ts.cycle_adam(1e-2, 10)
    opt = sched.build([w])
    sched.apply(opt, 4)
    group = opt.param_groups[0]
    assert group["lr"] == ts.cycle_schedule(1e-2, 10)(4)
    assert group["betas"] == (ts.cycle_momentum_schedule(10)(4), 0.999)
    fixed = ts.cycle_adam(1e-2, 10, momentum=None)
    opt = fixed.build([w])
    fixed.apply(opt, 4)
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)    # optax.adam's default b1


def test_plain_adam_matches_optax():
    want = run_optax(optax.adam(3e-4), toy_grads)
    got = run_torch(ts.adam(3e-4), toy_grads)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_lr_finder_record_diverged_suggest_and_save(tmp_path):
    losses = [2.0, 1.9, 1.5, 1.0, 0.9, 0.95, 1.4, 3.0, 9.0, 30.0]
    want, got = js.LRFinder(1e-5, 1.0, len(losses)), ts.LRFinder(1e-5, 1.0, len(losses))
    flags = []
    for loss in losses:
        want.record(loss)
        got.record(loss)
        assert got.diverged == want.diverged
        flags.append(got.diverged)
    np.testing.assert_allclose(got.lrs, want.lrs, rtol=1e-6)
    np.testing.assert_allclose(got.smoothed, want.smoothed, rtol=1e-12)
    assert got.suggest() == pytest.approx(want.suggest(), rel=1e-6)
    assert not flags[0] and flags[-1]
    got.save(str(tmp_path / "lr.csv"))
    lines = (tmp_path / "lr.csv").read_text().splitlines()
    assert len(lines) == len(losses) and lines[0].endswith(",2.0")
    with pytest.raises(ValueError, match="record"):
        ts.LRFinder(1e-5, 1.0, 10).suggest()
