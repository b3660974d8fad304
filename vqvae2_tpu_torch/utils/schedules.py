"""LR / momentum schedules (port of ``vqvae2_tpu/utils/schedules.py``).

Every schedule is a pure ``step -> value`` function of plain Python and
numpy, evaluated on the host before each optimizer step.  ``step`` counts the
updates already made (0 before the first), as optax's schedules do.

:class:`AdamSchedule` takes the place of an optax Adam with scheduled
hyperparameters: it builds a ``torch.optim.Adam`` and, before each ``step()``,
writes the schedule's ``lr`` and β₁ into its parameter groups.
:func:`cycle_adam` is the 1-cycle policy the trainers select with ``--sched
cycle``: linear warmup ``lr_max/divider → lr_max`` over
``warmup_proportion·n_iter`` steps, then cosine decay to ``lr_min/1e4``, with β₁
mirroring the cycle (0.95 → 0.85 → 0.95) unless ``momentum=None``, which leaves
β₁ at Adam's 0.9.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def _anneal_linear(start, end, t):
    return start + t * (end - start)


def _anneal_cos(start, end, t):
    return end + (start - end) / 2 * (math.cos(math.pi * t) + 1)


def _clip01(t: float) -> float:
    return min(max(t, 0.0), 1.0)


def cycle_schedule(lr_max: float, n_iter: int, divider: float = 25.0,
                   warmup_proportion: float = 0.3) -> Schedule:
    """1-cycle LR."""
    phase1 = int(n_iter * warmup_proportion)
    phase2 = n_iter - phase1
    lr_min = lr_max / divider

    def schedule(step):
        # the reference's Phase.step increments first: proportion = (n + 1) / n_iter
        if step < phase1:
            return _anneal_linear(lr_min, lr_max, _clip01((step + 1) / max(phase1, 1)))
        return _anneal_cos(lr_max, lr_min / 1e4, _clip01((step - phase1 + 1) / max(phase2, 1)))

    return schedule


def cycle_momentum_schedule(n_iter: int, momentum: Tuple[float, float] = (0.95, 0.85),
                            warmup_proportion: float = 0.3) -> Schedule:
    """1-cycle β₁."""
    phase1 = int(n_iter * warmup_proportion)
    phase2 = n_iter - phase1
    m1, m2 = momentum

    def schedule(step):
        if step < phase1:
            return _anneal_linear(m1, m2, _clip01((step + 1) / max(phase1, 1)))
        return _anneal_cos(m2, m1, _clip01((step - phase1 + 1) / max(phase2, 1)))

    return schedule


class AdamSchedule:
    """Adam whose ``lr`` and β₁ may follow schedules.

    ``lr`` and ``b1`` are numbers or ``step -> value`` functions.
    :meth:`build` makes the ``torch.optim.Adam`` (eps 1e-8, no weight decay,
    as ``optax.adam``); :meth:`apply` writes the values for ``step`` into its
    groups and must run before each ``optimizer.step()``."""

    def __init__(self, lr: Union[float, Schedule], b1: Union[float, Schedule] = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    @staticmethod
    def _at(value, step: int) -> float:
        return float(value(step)) if callable(value) else float(value)

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self._at(self.lr, 0),
                                betas=(self._at(self.b1, 0), self.b2), eps=self.eps)

    def apply(self, optimizer: torch.optim.Optimizer, step: int) -> None:
        lr, b1 = self._at(self.lr, step), self._at(self.b1, step)
        for group in optimizer.param_groups:
            group["lr"] = lr
            group["betas"] = (b1, group["betas"][1])


class SGDSchedule:
    """``optax.sgd(lr, momentum, nesterov)``, after
    ``optax.add_decayed_weights(weight_decay)`` where ``weight_decay > 0``:
    :meth:`build` makes the ``torch.optim.SGD`` (its momentum buffer starts
    at the first gradient, as optax's trace starts at zero, and its weight
    decay is added to the gradient before the momentum, as the chain does);
    :meth:`apply` writes ``lr(step)`` into its groups and must run before
    each ``optimizer.step()``."""

    def __init__(self, lr: Union[float, Schedule], momentum: float = 0.9,
                 nesterov: bool = True, weight_decay: float = 0.0):
        self.lr, self.momentum, self.nesterov, self.weight_decay = (lr, momentum, nesterov,
                                                                     weight_decay)

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.SGD:
        return torch.optim.SGD(params, lr=AdamSchedule._at(self.lr, 0), momentum=self.momentum,
                               nesterov=self.nesterov, weight_decay=self.weight_decay)

    def apply(self, optimizer: torch.optim.Optimizer, step: int) -> None:
        for group in optimizer.param_groups:
            group["lr"] = AdamSchedule._at(self.lr, step)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init_value`` at step 0, linear to
    ``end_value`` at ``transition_steps``, constant after; in fp32, as optax
    computes it."""
    f32 = np.float32

    def schedule(step):
        frac = f32(1) - f32(min(max(step, 0), transition_steps)) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))
    return schedule


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for each parameter of ``optimizer`` that took none.
    optax updates every leaf of its tree, and a parameter the loss does not
    reach has a zero gradient there: its moments decay, its step count
    moves, weight decay still applies.  ``torch.optim`` skips a parameter
    whose ``grad`` is None; with this it does what optax does."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def adam(lr: float) -> AdamSchedule:
    """Plain Adam at a fixed ``lr`` (``optax.adam(lr)``)."""
    return AdamSchedule(lr)


def cycle_adam(lr_max: float, n_iter: int,
               momentum: Optional[Tuple[float, float]] = (0.95, 0.85),
               divider: float = 25.0, warmup_proportion: float = 0.3,
               b2: float = 0.999) -> AdamSchedule:
    """Adam with the full 1-cycle policy (lr and β₁ both scheduled); with
    ``momentum=None`` only the lr is, and β₁ stays 0.9."""
    lr = cycle_schedule(lr_max, n_iter, divider, warmup_proportion)
    if momentum is None:
        return AdamSchedule(lr, b2=b2)
    return AdamSchedule(lr, cycle_momentum_schedule(n_iter, momentum, warmup_proportion), b2=b2)


# ---------------------------------------------------------------------------
# The rest of the zoo
# ---------------------------------------------------------------------------

def cosine_lr(lr_min: float, lr_max: float, step_size: int) -> Schedule:
    """Repeating cosine."""
    def schedule(step):
        i = step % step_size
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(i / step_size * math.pi))
    return schedule


def power_lr(lr_min: float, lr_max: float, warmup: int) -> Schedule:
    """Linear warmup then inverse-sqrt decay."""
    def schedule(step):
        if step < warmup:
            return lr_min + (lr_max - lr_min) / warmup * step
        return lr_max * float(max(step - warmup + 1, 1)) ** -0.5
    return schedule


def sine_lr(lr_min: float, lr_max: float, step_size: int) -> Schedule:
    """Repeating half-sine."""
    def schedule(step):
        i = step % step_size
        return lr_min + (lr_max - lr_min) * math.sin(i / step_size * math.pi)
    return schedule


def linear_lr(lr_min: float, lr_max: float, warmup: int, step_size: int) -> Schedule:
    """Hold, then linear decay; repeating."""
    def schedule(step):
        i = step % step_size
        if i < warmup:
            return lr_max
        return lr_max + (i - warmup) * (lr_min - lr_max) / (step_size - warmup)
    return schedule


def clr(lr_min: float, lr_max: float, step_size: int) -> Schedule:
    """Triangular cyclical LR."""
    def schedule(step):
        e = float(step)
        cycle = math.floor(1 + e / (2 * step_size))
        x = abs(e / step_size - 2 * cycle + 1)
        return lr_min + (lr_max - lr_min) * max(0.0, 1 - x)
    return schedule


def noam_warmup(model_dim: int, factor: float = 1.0, warmup: int = 16000) -> Schedule:
    """Noam / transformer warmup."""
    def schedule(step):
        i = float(step) + 1          # the reference increments first
        return factor * model_dim ** -0.5 * min(i ** -0.5, i * warmup ** -1.5)
    return schedule


def cycle_anneal(lr_max: float, lr_divider: float, cut_point: int, step_size: int) -> Schedule:
    """Triangular 1-cycle with a final cut to ``lr_max / 100 / divider``."""
    cycle_step = int(step_size * (1 - cut_point / 100) / 2)

    def schedule(step):
        i = float(step % step_size)
        if i > 2 * cycle_step:
            tail_t = (i - 2 * cycle_step) / (step_size - 2 * cycle_step)
            return lr_max * (1 + tail_t * (1 - 100) / 100) / lr_divider
        if i > cycle_step:
            down_t = 1 - (i - cycle_step) / cycle_step
            return lr_max * (1 + down_t * (lr_divider - 1)) / lr_divider
        return lr_max * (1 + (i / cycle_step) * (lr_divider - 1)) / lr_divider

    return schedule


def lr_finder(lr_min: float, lr_max: float, step_size: int, linear: bool = False) -> Schedule:
    """Exponential (or linear) LR sweep for range tests; :class:`LRFinder`
    adds the loss record."""
    ratio = lr_max / lr_min
    mult = (ratio / step_size) if linear else ratio ** (1 / step_size)

    def schedule(step):
        if linear:
            return lr_min + mult * float(step)
        return lr_min * mult ** float(step)

    return schedule


class LRFinder:
    """LR range test with a loss record: ``.schedule`` drives the optimizer,
    the loop calls :meth:`record` with each step's loss, :meth:`save` writes
    ``lr,loss`` lines, :meth:`suggest` returns the LR at the steepest descent of
    the smoothed loss."""

    def __init__(self, lr_min: float, lr_max: float, step_size: int,
                 linear: bool = False, smooth: float = 0.3):
        self.schedule = lr_finder(lr_min, lr_max, step_size, linear)
        self.step_size = step_size
        self.smooth = smooth
        self.lrs: list = []
        self.losses: list = []
        self.smoothed: list = []

    def record(self, loss) -> None:
        self.lrs.append(float(self.schedule(len(self.losses))))
        loss = float(loss)
        prev = self.smoothed[-1] if self.smoothed else loss
        self.losses.append(loss)
        self.smoothed.append(self.smooth * loss + (1 - self.smooth) * prev
                             if len(self.losses) > 1 else loss)

    @property
    def diverged(self) -> bool:
        """The smoothed loss rose past 4× its running minimum."""
        if len(self.smoothed) < 2:
            return False
        return self.smoothed[-1] > 4.0 * min(self.smoothed)

    def suggest(self) -> float:
        """LR at the steepest descent of the smoothed loss."""
        if len(self.losses) < 3:
            raise ValueError("record() more steps before suggest()")
        grads = np.diff(self.smoothed) / np.maximum(np.diff(self.lrs), 1e-12)
        return float(self.lrs[int(np.argmin(grads))])

    def save(self, filename: str) -> None:
        with open(filename, "w") as f:
            for lr, loss in zip(self.lrs, self.losses):
                f.write(f"{lr},{loss}\n")


def multi_step_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1) -> Schedule:
    """``torch.optim.lr_scheduler.MultiStepLR`` as a function of the step."""
    ms = list(milestones)

    def schedule(step):
        return base_lr * gamma ** float(sum(step >= m for m in ms))

    return schedule


def stepped_reid_lr(base_lr: float) -> Schedule:
    """The hand-stepped ReID decay, by epoch: ×1 until 20, ×0.1 until 60,
    ×0.01 until 120, ×0.001 after."""
    def schedule(epoch):
        scale = 1.0 if epoch < 20 else 0.1 if epoch < 60 else 0.01 if epoch < 120 else 0.001
        return base_lr * scale
    return schedule
