"""The port's tracing and profiling utilities (sph_taichi_torch/utils/
profiling.py) against the JAX package's (sph_taichi_tpu/utils/
profiling.py), on the CPU: ``StepTimer``'s phases and report format,
``trace``'s Chrome trace with a ``named_scope`` region in it, and
``summarize_metrics`` on the same metrics."""

import json
import math
import time

import numpy as np
import pytest
import torch

from sph_taichi_tpu.utils import profiling as jprof
from sph_taichi_torch.utils import profiling as prof


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_step_timer_accumulates_and_reports_as_jax():
    timer = prof.StepTimer("cpu")
    for _ in range(3):
        with timer.phase("step"):
            time.sleep(0.004)
    with timer.phase("emission"):
        pass
    totals = timer.totals
    assert timer.counts == {"step": 3, "emission": 1}
    assert totals["step"] >= 0.012 and totals["step"] > totals["emission"]
    ref = jprof.StepTimer()
    ref.totals, ref.counts = dict(totals), dict(timer.counts)
    assert timer.report() == ref.report()
    assert timer.report().splitlines()[0].startswith("step: total ")


def test_step_timer_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prof.StepTimer()
    assert not prof.StepTimer("cpu").cuda


def test_trace_writes_a_chrome_trace_with_the_named_scope(tmp_path):
    a = torch.arange(64, dtype=torch.float32)
    with prof.trace(str(tmp_path)) as p:
        with prof.named_scope("legacy2d_test_region"):
            (a * 2.0 + 1.0).sum()
    path = p.trace_path
    assert path.startswith(str(tmp_path))
    text = open(path).read()
    assert len(text) > 0
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert "legacy2d_test_region" in names
    assert "legacy2d_test_region" in {e.key for e in p.key_averages()}


def test_summarize_metrics_matches_jax():
    metrics = {"iterations": np.array([3, 5, 4], np.int32),
               "density_err": np.float32(0.25),
               "empty": np.zeros((0,), np.float32),
               "stacked": np.arange(6, dtype=np.float32).reshape(2, 3),
               "nested": {"skipped": np.ones(2)},
               "count": 7}
    ref = jprof.summarize_metrics(metrics)
    got = prof.summarize_metrics(metrics)
    as_tensors = prof.summarize_metrics(
        {k: (v if isinstance(v, dict) else torch.as_tensor(v))
         for k, v in metrics.items()})
    for out in (got, as_tensors):
        assert out.keys() == ref.keys()
        for k in ref:
            assert (out[k] == ref[k]) or (math.isnan(out[k])
                                          and math.isnan(ref[k]))
