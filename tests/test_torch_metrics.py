"""The port's observability helpers against the JAX package's: the same
scalar streams give the same windowed statistics and the same CSV; the
profiler context writes a trace of the block it wraps."""

import os

import numpy as np
import pytest
import torch

from vqvae2_tpu.utils import metrics as jm
from vqvae2_tpu_torch.utils import metrics as tm

STREAM = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]


@pytest.mark.parametrize("window", [3, 20])
def test_smoothed_value_matches_jax(window):
    want, got = jm.SmoothedValue(window), tm.SmoothedValue(window)
    for v in STREAM:
        want.update(v, n=2)
        got.update(v, n=2)
        for attr in ("median", "avg", "global_avg", "max", "value"):
            assert getattr(got, attr) == pytest.approx(getattr(want, attr), rel=1e-12)
    assert str(got) == str(want)


def test_metric_logger_matches_jax(capsys):
    want, got = jm.MetricLogger(), tm.MetricLogger()
    for v in STREAM:
        want.update(loss=v, acc=v / 10)
        got.update(loss=torch.tensor(v), acc=v / 10)
    assert str(got) == str(want)
    assert got.loss.median == want.loss.median
    with pytest.raises(AttributeError):
        got.missing
    items = list(got.log_every(range(4), print_freq=2, header="epoch"))
    assert items == [0, 1, 2, 3]
    out = capsys.readouterr().out
    assert "epoch [0/4]" in out and "epoch [2/4]" in out and "Total time" in out


def test_csv_logger_writes_what_jax_writes(tmp_path):
    for module, name in ((jm, "jax.csv"), (tm, "port.csv")):
        log = module.CsvLogger(str(tmp_path / "sub" / name))
        for step, v in enumerate(STREAM):
            log.log(step, {"loss": v, "acc": v / 7})
    assert (tmp_path / "sub" / "port.csv").read_text() == (tmp_path / "sub" / "jax.csv").read_text()
    tm.CsvLogger("").log(1, {"loss": 1.0})          # no path: nothing written


def test_step_timer_and_an_empty_tensorboard_writer():
    timer = tm.StepTimer(skip_first=1)
    assert timer.mean == 0.0 and timer.p50 == 0.0
    for _ in range(4):
        timer.tick()
    assert len(timer.times) == 2 and timer.mean >= 0.0
    tb = tm.TensorBoardWriter("")
    tb.add_scalars({"loss": 1.0}, 3, prefix="train/")
    tb.flush()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tm.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with tm.profile_trace("", enabled=True) as off:
        assert off is None
    with tm.profile_trace(str(tmp_path / "never"), enabled=False) as off:
        assert off is None
    assert not (tmp_path / "never").exists()
