"""Observability (port of ``vqvae2_tpu/utils/metrics.py``): windowed metrics,
step timing, CSV and optional TensorBoard scalars, and a ``torch.profiler``
trace around a block of work.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np


class SmoothedValue:
    """Window and global average of a scalar stream."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with an ETA and per-step data and iteration times."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        i = 0
        total = total if total is not None else getattr(iterable, "__len__", lambda: None)()
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_s = f"eta: {int(eta)//3600:d}:{(int(eta)//60)%60:02d}:{int(eta)%60:02d}  "
                else:
                    eta_s = ""
                print(f"{header} [{i}{f'/{total}' if total else ''}]  {eta_s}"
                      f"{self}  time: {iter_time}  data: {data_time}",
                      flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {elapsed:.1f}s "
              f"({elapsed / max(i, 1):.4f} s/it)", flush=True)


class TensorBoardWriter:
    """Optional TensorBoard scalar writer: does nothing when ``logdir`` is
    empty or TensorBoard is not installed."""

    def __init__(self, logdir: str = ""):
        self._w = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._w = SummaryWriter(logdir)
            except Exception:
                self._w = None

    def add_scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    prefix: str = ""):
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def flush(self):
        if self._w is not None:
            self._w.flush()


class CsvLogger:
    """Append-mode per-step scalar CSV; does nothing when ``path`` is empty.
    The columns are fixed by the first write."""

    def __init__(self, path: str = ""):
        self.path = path
        self._cols = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, step: int, scalars: Dict[str, float]):
        if not self.path:
            return
        if self._cols is None:
            self._cols = sorted(scalars)
            if not os.path.exists(self.path) or os.path.getsize(self.path) == 0:
                with open(self.path, "a") as f:
                    f.write(",".join(["step"] + self._cols) + "\n")
        with open(self.path, "a") as f:
            f.write(",".join([str(int(step))] +
                             [f"{float(scalars.get(c, float('nan'))):.6g}"
                              for c in self._cols]) + "\n")


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """``torch.profiler`` over the block (host and, where present, CUDA
    activity); the trace goes to ``<logdir>/trace.json`` for a Chrome-trace
    viewer.  Yields the profiler, or ``None`` when off."""
    if not enabled or not logdir:
        yield None
        return
    import torch

    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Per-step wall-clock timing with a warm-up skip."""

    def __init__(self, skip_first: int = 2):
        self.skip = skip_first
        self.times: list = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            if self.skip > 0:
                self.skip -= 1
            else:
                self.times.append(now - self._last)
        self._last = now

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0
