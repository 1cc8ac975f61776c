"""IISPH's step on dragon_bath at two time steps, and PCISPH's: device busy, step time.

    python3 tools/iisph_device_busy.py [--root DIR] [--steps N]

Runs data/scenes/dragon_bath.json as IISPH (simulationMethod 2) and as
PCISPH (1) through the ``Simulation`` of the ``sph_taichi_torch`` package
found under ``--root`` (default: this checkout; another checkout, such as
an unpacked parent commit, compares two versions on one card): IISPH at dt
4e-4 after 5 steps, and at dt 2e-3 once a step's pressure solve iterates
more than once (the counts read every 10 steps, at most 400 steps, as
chip_smoke.py's iterating phase); PCISPH at dt 4e-4 after 5 steps.  At
each, for ``--steps`` steps (5 by default): the step time (CUDA events
around ``Simulation.run``), pressure iterations and host reads per step,
then the same number of steps under torch.profiler: the device busy time
per step (the kernels' summed device time), kernels per step and the idle
share.  Prints one JSON line per run and the card's name and power limit.
Needs a CUDA device; builds the package's kernels.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def device_busy(sim, steps):
    """(device busy ms per step, kernels per step) over ``steps`` steps
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.run(steps // sim.substeps, export=False)
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    if us <= 0:
        raise AssertionError("profiler: no device time recorded")
    return us / steps / 1e3, count / steps


def measure(method, dt, steps):
    from sph_taichi_torch import SimConfig
    from sph_taichi_torch.simulation import Simulation

    with open("data/scenes/dragon_bath.json") as f:
        d = json.load(f)
    d["Configuration"]["simulationMethod"] = method
    d["Configuration"]["timeStepSize"] = dt
    sim = Simulation(config=SimConfig(config_dict=d), scene_dir=".")
    if dt < 1e-3:
        sim.run(5 // sim.substeps, export=False)
    else:
        while True:
            sim.reset_solver_stats()
            sim.run(10 // sim.substeps, export=False)
            if sim.read_solver_stats()["pressure_iters_max"] > 1:
                break
            if int(sim.state.step_count) >= 400:
                raise AssertionError(f"no step iterated twice at dt {dt}")
    torch.cuda.synchronize()
    at = int(sim.state.step_count)
    sim.reset_solver_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    st = sim.read_solver_stats()
    busy, kernels = device_busy(sim, steps)
    return {"method": method, "dt": dt, "from_step": at, "step_ms": step_ms,
            "iters_per_step": st["pressure_iters_sum"] / steps,
            "host_reads_per_step": st["pressure_host_reads"] / steps,
            "busy_ms": busy, "kernels_per_step": kernels,
            "idle_share": 1.0 - busy / step_ms}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("iisph_device_busy: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)
    from sph_taichi_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(["pairs", "dfsph", "iisph", "pcisph"])
    print(f"{root}: kernels built in {time.perf_counter() - t0:.1f} s")
    for method, dt in ((2, 4e-4), (2, 2e-3), (1, 4e-4)):
        print(json.dumps(measure(method, dt, args.steps)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
