"""Time the DFSPH Jacobi kernels' walks against one-phase controls.

``dfsph_divergence`` (both modes) and ``dfsph_solver_dv`` walk the cell
runs in two phases (csrc/pair_common.cuh ``compact_cell_runs``) and, over
the slot walk, read the step's pair list that the density-and-factor
kernel writes (``for_each_jacobi_pair``).  This script builds
``tools/jacobi_walk_control.cu`` twice, the same kernels with a one-phase
walk and no list: as ``for_each_neighbor_walk`` (one candidate at a time)
and with each lane's candidate loads over the cell runs batched
``kCompactUnroll`` deep (over the slot map both controls walk as
``for_each_neighbor_walk``).  At dragon_bath_dfsph states (``--at``:
steps from the start; 28 is the state at which chip_smoke.py times the
DFSPH kernels) it checks that the three designs give equal results
bitwise, over the cell runs and over the slot map, and times each kernel
(CUDA events, mean of 20 launches) in interleaved turns.

    python3 tools/jacobi_walk_control.py [--at 3 28] [--turns 3]

Needs a CUDA device and nvcc; builds into build/walk_control/.
"""

import argparse
import contextlib
import ctypes
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DESIGNS = ("one-phase", "one-phase batched",
           "shipped (two-phase; list over slots)")


def build_controls():
    """{design: .so path} of the two one-phase controls, built together."""
    from sph_taichi_torch.ops import _build

    out = os.path.join(ROOT, "build", "walk_control")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(ROOT, "tools", "jacobi_walk_control.cu")
    procs = {}
    for design, flags in ((DESIGNS[0], []), (DESIGNS[1], ["-DWALK_BATCHED"])):
        lib = os.path.join(out, f"lib{len(procs)}.so")
        procs[design] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             *flags, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for design, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{design}: nvcc exit {proc.returncode}\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"{design}: built; ptxas {regs}")
        libs[design] = lib
    return libs


def typed(path, shipped):
    """ctypes handle of a control library with the shipped launchers'
    signatures."""
    lib = ctypes.CDLL(path)
    for name in ("dfsph_divergence_launch", "dfsph_solver_dv_launch"):
        fn = getattr(lib, name)
        fn.argtypes = getattr(shipped, name).argtypes
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def using(module, lib):
    """The wrappers of ``module`` launching from ``lib``."""
    real = module._lib
    module._lib = lambda: lib
    try:
        yield
    finally:
        module._lib = real


def dragon_states(device, at):
    """Yields (steps, params, sorted particles, cell offsets, the slot
    walk's context (the step's list over the slot map), a stiffness field,
    dt) at the dragon_bath_dfsph states ``at`` steps from the start."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops.slots import build_slot_map
    from sph_taichi_torch.simulation import Simulation

    sim = Simulation(os.path.join(ROOT, "data/scenes/dragon_bath_dfsph.json"),
                     device=device)
    done = 0
    for steps in sorted(at):
        sim.run(steps - done, export=False)
        done = steps
        solver, state, params = sim.solver, sim.state, sim.params
        q, starts, _ = base.bin_and_sort(state.p, params, solver.engine,
                                         solver.tables)
        q = solver.density_and_factor(q, starts)
        adv, _ = cd.divergence(starts, q, q.v, None, None, "change", params)
        kappa = adv * (q.dfsph_factor / state.dt)
        slots = cd.density_factor_list(build_slot_map(starts, params), q,
                                       params)[2]
        yield (int(state.step_count), params, q, starts, slots, kappa,
               state.dt)


def time_ms(fn, reps=20):
    """Mean ms of ``fn`` over ``reps`` calls, by CUDA events (one
    warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(libs, at, turns):
    """Checks and times the designs ``libs`` ({name: library}) at the
    dragon states ``at``."""
    from sph_taichi_torch.ops import cuda_dfsph as cd

    names = list(libs)
    for steps, params, q, starts, slots, kappa, dt in dragon_states(
            torch.device("cuda"), at):
        print(f"dragon_bath_dfsph after {steps} steps: {params.n_particles} "
              f"particles (fluid {params.n_fluid}); fluid centres over the "
              f"slot list {int((slots.cnt > slots.idx.shape[0]).sum())}")
        calls = {}
        for walk, ctx in (("", starts), ("[slots]", slots)):
            calls.update({
                "change" + walk: lambda ctx=ctx: cd.divergence(
                    ctx, q, q.v, None, None, "change", params),
                "adv" + walk: lambda ctx=ctx: cd.divergence(
                    ctx, q, q.v, q.density, dt, "adv", params),
                "solver_dv" + walk: lambda ctx=ctx: cd.solver_dv(
                    ctx, q, kappa, q.v, None, dt, False, params)})
        with using(cd, libs[names[0]]):
            ref = {name: fn() for name, fn in calls.items()}
        for design in names[1:]:
            with using(cd, libs[design]):
                for name, fn in calls.items():
                    for a, b in zip(fn(), ref[name]):
                        if b is not None and not torch.equal(a, b):
                            raise AssertionError(f"{design} {name}: not "
                                                 f"equal to {names[0]}")
        print(f"  the {len(names)} designs' results are equal bitwise")
        times = {(d, n): [] for d in names for n in calls}
        for _ in range(turns):
            for design in names:
                with using(cd, libs[design]):
                    for name, fn in calls.items():
                        times[design, name].append(time_ms(fn))
        for design in names:
            print(f"  {design}: " + ", ".join(
                f"{name} {statistics.median(times[design, name]):.4f} ms "
                f"(turns {[round(t, 4) for t in times[design, name]]})"
                for name in calls))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--at", type=int, nargs="+", default=[3, 28])
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("jacobi_walk_control: no CUDA device", file=sys.stderr)
        return 1
    from sph_taichi_torch.ops import cuda_dfsph as cd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    t0 = time.perf_counter()
    shipped = cd._lib()
    libs = {DESIGNS[2]: shipped}
    libs.update({d: typed(p, shipped) for d, p in build_controls().items()})
    print(f"built in {time.perf_counter() - t0:.1f} s")
    compare(libs, args.at, args.turns)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
