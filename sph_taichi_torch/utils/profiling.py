"""Tracing and profiling (counterpart of sph_taichi_tpu/utils/profiling.py).

Four instruments:
- ``trace(log_dir)``: a ``torch.profiler`` context over the CPU and, where
  there is one, the CUDA device; writes a Chrome trace into ``log_dir``.
- ``StepTimer``: time per named phase, from CUDA events on a CUDA device
  (read when the report is asked for, never inside the phase) and from
  ``time.perf_counter`` on the CPU.
- ``named_scope``: ``torch.profiler.record_function``, to name a region
  in a trace.
- ``check_overflow`` / ``summarize_metrics``: the run-time check of the
  step's fatal flags and the host-side reduction of metrics for logging.

The cell-run CUDA engine walks whole cell ranges and has no capacity to
overflow, so four fatal flags remain: the sort invariant (a corrupted sort
poisons every pair sum), the plain engine's neighbour-list and cell
overflows, and the slot engine's ``slot_overflow`` (a cell holds more
particles than its slot layers, ops/slots.py).
"""

import contextlib
import math
import os
import time
import warnings

import numpy as np
import torch

from sph_taichi_torch.state import resolve_device

named_scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir):
    """Profile a region; on exit write its Chrome trace (view it in
    chrome://tracing or Perfetto) into ``log_dir``.  Yields the profiler:
    its ``key_averages()`` sum the region by op and kernel, and its
    ``trace_path`` names the file once the region has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


class StepTimer:
    """Accumulates time per named phase.

    >>> t = StepTimer(device)
    >>> with t.phase("step"):
    ...     state, m = solver.step(state)
    >>> print(t.report())

    ``device``: None means the CUDA device (as the port's entry points);
    on a CUDA device a phase is the time between two events recorded on
    the current stream (the device's timeline, idle gaps included), read
    when ``totals`` or ``report()`` is asked for; on the CPU, the host's
    ``perf_counter``.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self._totals = {}
        self.counts = {}
        self._pending = []   # (name, start event, end event)

    @contextlib.contextmanager
    def phase(self, name):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._pending.append((name, start, end))
                self.counts[name] = self.counts.get(name, 0) + 1
                if len(self._pending) >= 256:
                    self._fold(wait=False)
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def _add(self, name, seconds):
        self._totals[name] = self._totals.get(name, 0.0) + seconds

    def _fold(self, wait):
        """Move finished event pairs into the totals; ``wait`` waits for
        the last one first."""
        if wait and self._pending:
            self._pending[-1][2].synchronize()
        keep = []
        for name, start, end in self._pending:
            if wait or end.query():
                self._add(name, start.elapsed_time(end) / 1e3)
            else:
                keep.append((name, start, end))
        self._pending = keep

    @property
    def totals(self):
        """{phase: seconds}."""
        self._fold(wait=True)
        return dict(self._totals)

    def report(self):
        totals = self.totals
        lines = []
        for name, tot in sorted(totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: total {tot*1e3:.1f} ms, "
                         f"n={n}, avg {tot/n*1e3:.2f} ms")
        return "\n".join(lines)


FATAL_KEYS = ("sort_invariant_violated", "neighbor_overflow",
              "cell_overflow", "slot_overflow", "migration_overflow",
              "halo_overflow")


def check_overflow(metrics, where="step", strict=False):
    """Warn (or raise when ``strict``) if a fatal flag in ``metrics`` is
    set.  Reads the flags from the device in one transfer; returns the
    list of keys that fired."""
    present = [k for k in FATAL_KEYS if k in metrics]
    if not present:
        return []
    flags = torch.stack([metrics[k].to(torch.int32).reshape(())
                         for k in present]).cpu()
    fired = [k for k, f in zip(present, flags.tolist()) if f]
    if fired:
        msg = (f"fatal flag during {where}: {fired} — pair sums are wrong "
               f"or particles lost (a corrupted sort, params.neighbor_cap "
               f"or cell_cap too small for the plain engine, "
               f"params.slot_layers too small for the slot engine, or a "
               f"sharded run's mig_cap or halo_cap too small).")
        if strict:
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return fired


def summarize_metrics(metrics):
    """Host-side reduction of a metrics dict (tensors, arrays or numbers,
    possibly stacked over steps) to plain floats for logging: the last
    element of each, NaN for an empty one; nested dicts are skipped."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, dict):
            continue
        a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        out[k] = float(a.ravel()[-1]) if a.size else math.nan
    return out
