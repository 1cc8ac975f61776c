"""WCSPH's step on dragon_bath: the host's time to launch a step beside the
step time.

    python3 tools/wcsph_host_time.py [--root DIR] [--blocks B] [--steps N]
                                     [--batches M]

Runs data/scenes/dragon_bath.json (WCSPH) through the ``Simulation`` of the
``sph_taichi_torch`` package found under ``--root`` (default: this
checkout; another checkout, such as an unpacked parent commit, compares
two versions on one card when the two are run in alternating processes).
After 5 steps, ``--blocks`` blocks of ``--steps`` steps each through
``Simulation.run``, each block giving per step:

- ``step_ms``: CUDA events around ``Simulation.run`` (as chip_smoke.py);
- ``wall_ms``: the host's clock around the same call;
- ``host_ms``: the host's clock inside ``solver.step`` alone (the
  Python and the launches of one step; a step makes no host sync, so the
  device runs behind it).

The rest of ``wall_ms`` is the frame's fatal-flag read, which waits for the
device.  Before the blocks, at step 5, the host's time per call of the
step and of its stages (``stage_host``: the whole step, the substep, its
density call and its force call), each the median of ``--batches``
batches of 10 calls, the stages interleaved and the device synchronized
between batches, so that no launch waits for the device.  Prints one
JSON line for the stages, one per block, a summary line of the blocks'
medians, and the card's name and power limit.  Needs a CUDA device;
builds the package's ``pairs`` kernels.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch


def timed_steps(solver):
    """Wrap ``solver.step`` to sum its host time; returns the running
    total {"wall": s}."""
    step = solver.step
    total = {"wall": 0.0}

    def timed(state):
        t0 = time.perf_counter()
        out = step(state)
        total["wall"] += time.perf_counter() - t0
        return out

    solver.step = timed
    return total


def stage_host(sim, batches, calls=10):
    """{stage: host ms per call}, the medians over
    ``batches`` batches of ``calls`` calls from the current state, of the
    step and of the WCSPH substep's stages, whichever calls the package's
    substep makes (the density call with the step's pair list where it
    has one)."""
    from sph_taichi_torch.models import base

    solver, state = sim.solver, sim.state
    params, engine = solver.params, solver.engine
    q, starts, _ = base.bin_and_sort(state.p, params, engine, solver.tables)
    if hasattr(base, "compute_densities_and_pairs"):
        def density():
            return base.compute_densities_and_pairs(
                q, starts, engine, params, solver._pair_buffers)
    else:
        def density():
            return base.compute_densities(q, starts, engine, params), starts
    qd, ctx = density()
    stages = {"step": lambda: solver.step(state),
              "substep": lambda: solver.substep(q, starts, state.dt),
              "density": density,
              "forces": lambda: solver.compute_forces(qd, ctx, dt=state.dt)}
    times = {name: [] for name in stages}
    for _ in range(batches):
        for name, fn in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in times.items()}


def block(sim, total, steps):
    """One block of ``steps`` steps through ``Simulation.run``: its
    per-step times in ms."""
    w0 = total["wall"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"from_step": int(sim.state.step_count) - steps,
            "step_ms": start.elapsed_time(end) / steps,
            "wall_ms": wall * 1e3 / steps,
            "host_ms": (total["wall"] - w0) * 1e3 / steps}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batches", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wcsph_host_time: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)
    from sph_taichi_torch.ops import _build
    from sph_taichi_torch.simulation import Simulation

    _build.build(["pairs"])
    sim = Simulation("data/scenes/dragon_bath.json")
    sim.run(5 // sim.substeps, export=False)
    print(json.dumps({"stage_host_ms": stage_host(sim, args.batches)}))
    total = timed_steps(sim.solver)
    rows = []
    for _ in range(args.blocks):
        rows.append(block(sim, total, args.steps))
        print(json.dumps(rows[-1]))
    print(json.dumps({"root": root, "blocks": args.blocks,
                      "steps": args.steps, "median": {
                          k: statistics.median(r[k] for r in rows)
                          for k in ("step_ms", "wall_ms", "host_ms")}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
