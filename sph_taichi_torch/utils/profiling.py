"""Run-time check of the step's fatal flags (counterpart of
sph_taichi_tpu/utils/profiling.py ``check_overflow``).

The cell-run CUDA engine walks whole cell ranges and has no capacity to
overflow, so four flags remain: the sort invariant (a corrupted sort
poisons every pair sum), the plain engine's neighbour-list and cell
overflows, and the slot engine's ``slot_overflow`` (a cell holds more
particles than its slot layers, ops/slots.py).
"""

import warnings

import torch

FATAL_KEYS = ("sort_invariant_violated", "neighbor_overflow",
              "cell_overflow", "slot_overflow")


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
               f"(a corrupted sort, params.neighbor_cap or cell_cap too "
               f"small for the plain engine, or params.slot_layers too "
               f"small for the slot engine).")
        if strict:
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return fired
