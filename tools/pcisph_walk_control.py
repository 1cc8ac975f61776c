"""Time PCISPH's loop kernels over the step's pair list against the loop
without it, and against controls of the list walk.

In a PCISPH step the loop kernels ``pcisph_d_rho_correct`` (g1) and
``pcisph_pressure_accel_predict`` (g2) read the fluid rows of the step's
pair list that the density kernel writes as it sums (ops/cuda_pairs.py
``density_sum_list``), 8 entries loaded ahead; a warp over the list walks
the cells in one phase.  This script builds ``tools/pcisph_walk_control.cu``,
the same kernels with the list walk replaced: without the list, every warp
walking the cells in two phases (the loop without the step-start list at
its fastest) or in one (the kernels before the list); the list loaded 1 or
4 entries ahead; the two-phase walk for a warp over the list.  At dragon_bath
PCISPH states (``--at``: steps from the start; chip_smoke.py times its
kernels at step 30) it checks that every design gives equal results
bitwise, prints each build's registers, times each kernel (CUDA events,
mean of 20 launches) in interleaved turns and the loop's kernels per step
(3 x (g1 + g2), over the list and without it); then whole steps, with the
loop over the list and without it (two-phase walk; the density kernel
still writes the list, which the non-pressure kernel reads before the
loop): device busy time per step (torch.profiler) and step time
(CUDA events), in interleaved turns, from the same state, states equal
bitwise.  With
``--other DIR`` the shipped kernels of another checkout (its
``sph_taichi_torch/csrc/pcisph.cu``, for example an unpacked parent
commit) join the designs, so a change to the shipped source is timed
against the other in the same process.

    python3 tools/pcisph_walk_control.py [--at 30] [--turns 3] [--other DIR]

Needs a CUDA device and nvcc; builds into build/kernels/ and
build/pcisph_walk_control/.
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

NO_LIST = "no list, two-phase walk"
ONE_PHASE = "no list, one-phase walk"
LIST = "step-start list (shipped)"
# the controls: name -> nvcc flags
CONTROLS = {NO_LIST: ["-DNO_LIST"],
            ONE_PHASE: ["-DONE_PHASE"],
            "list 1 deep": ["-DLIST_UNROLL=1"],
            "list 4 deep": ["-DLIST_UNROLL=4"],
            "list, two-phase walk over it": ["-DOVERFLOW_TWO_PHASE"]}
# the launchers a control library serves through the shipped wrappers
LAUNCHERS = ("pcisph_d_rho_correct_launch",
             "pcisph_pressure_accel_predict_launch")


def build_controls(other=None):
    """{control: ctypes handle} of CONTROLS (and, with ``other``, the
    shipped kernels of that checkout), built together, with the shipped
    launchers' signatures."""
    from sph_taichi_torch.ops import _build
    from sph_taichi_torch.ops import cuda_pcisph as cg

    shipped = cg._lib()
    out = os.path.join(ROOT, "build", "pcisph_walk_control")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(ROOT, "tools", "pcisph_walk_control.cu")
    # name -> (source, include directory, flags)
    sources = {name: (src, str(_build.CSRC), flags)
               for name, flags in CONTROLS.items()}
    if other is not None:
        csrc = os.path.join(os.path.abspath(other), "sph_taichi_torch",
                            "csrc")
        sources[f"shipped kernels of {other}"] = (
            os.path.join(csrc, "pcisph.cu"), csrc, [])
    procs = {}
    for k, (name, (source, include, flags)) in enumerate(sources.items()):
        lib = os.path.join(out, f"lib{k}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, *flags,
             "-o", lib, source], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        regs = [ln.split("Used")[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"{name}: built; ptxas {regs}")
        lib = ctypes.CDLL(path)
        for fn in LAUNCHERS:
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


@contextlib.contextmanager
def using(lib):
    """The PCISPH wrappers launching from ``lib`` (None: the shipped
    library)."""
    from sph_taichi_torch.ops import cuda_pcisph as cg

    real = cg._lib
    if lib is not None:
        cg._lib = lambda: lib
    try:
        yield
    finally:
        cg._lib = real


def busy_ms(sim, steps):
    """Device busy ms per step over ``steps`` steps (profiler: the sum of
    the kernels' device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.run(steps, export=False)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    if us <= 0:
        raise AssertionError("profiler: no device time recorded")
    return us / steps / 1e3


def step_ms(sim, steps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps, export=False)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def kernels(sim, controls, turns):
    """Per-launch times at the state of ``sim``: g1 and g2 over the list
    (shipped) and in each control of ``controls``, in turns, after checking
    that every design's results are equal bitwise."""
    import chip_smoke as cs
    from sph_taichi_torch.ops import cuda_pcisph as cg

    params, solver, state = sim.params, sim.solver, sim.state
    q, starts, plist, nl, (xp, vp, pressure, s_f), _ = \
        cs.pcisph_state_kernels(params, solver, state)
    dt = state.dt
    # design -> (library or None for the shipped one, loop context)
    designs = {LIST: (None, plist)}
    designs.update({name: (lib, plist) for name, lib in controls.items()})
    fns = {
        "pcisph_d_rho_correct": lambda c: cg.d_rho_correct(
            c, q, xp, vp, pressure, dt, s_f, params),
        "pcisph_pressure_accel_predict": lambda c: cg.pressure_accel_predict(
            c, q, xp, pressure, dt, params)}
    for kernel, fn in fns.items():
        ref = fn(plist)
        for d, (lib, ctx) in designs.items():
            with using(lib):
                if not all(torch.equal(a, b) for a, b in zip(fn(ctx), ref)):
                    raise AssertionError(f"{kernel} [{d}]: not equal to the "
                                         f"shipped list walk")
    print(f"  g1 and g2 equal bitwise in the {len(designs)} designs")
    times = {(k, d): [] for k in fns for d in designs}
    for _ in range(turns):
        for (k, d) in times:
            lib, ctx = designs[d]
            with using(lib):
                times[k, d].append(cs.time_ms(lambda: fns[k](ctx), 20))
    med = {key: statistics.median(t) for key, t in times.items()}
    for (k, d), t in times.items():
        print(f"  {k} [{d}]: {med[k, d]:.4f} ms (turns "
              f"{[round(x, 4) for x in t]})")
    g = ("pcisph_d_rho_correct", "pcisph_pressure_accel_predict")
    print(f"  the loop's kernels per step (3 iterations): {LIST} "
          f"{3 * sum(med[k, LIST] for k in g):.4f} ms, {NO_LIST} "
          f"{3 * sum(med[k, NO_LIST] for k in g):.4f} ms, {ONE_PHASE} "
          f"{3 * sum(med[k, ONE_PHASE] for k in g):.4f} ms")


def steps(sim, no_list, turns, per_turn=5):
    """Whole steps with the loop over the list and without it (every warp
    walking the cells in two phases: the library ``no_list``; the density
    kernel still writes the list, for the non-pressure kernel) from the
    same state, in interleaved turns: the states stay equal bitwise."""
    from sph_taichi_torch.simulation import Simulation

    twin = Simulation(config=sim.config, scene_dir=ROOT)
    twin.state = sim.state     # a step makes new tensors; none is written
    sims = {NO_LIST: twin, LIST: sim}
    busy = {d: [] for d in sims}
    wall = {d: [] for d in sims}
    for turn in range(turns):
        for d in list(sims)[::1 if turn % 2 == 0 else -1]:
            with using(no_list if d == NO_LIST else None):
                busy[d].append(busy_ms(sims[d], per_turn))
                wall[d].append(step_ms(sims[d], per_turn))
    same = all(torch.equal(a, getattr(twin.state.p, f))
               for f, a in sim.state.p._asdict().items() if a is not None)
    for d in sims:
        print(f"  {d}: device busy {statistics.median(busy[d]):.4f} ms per "
              f"step (turns {[round(t, 4) for t in busy[d]]}), step "
              f"{statistics.median(wall[d]):.4f} ms (turns "
              f"{[round(t, 4) for t in wall[d]]})")
    print(f"  after {int(sim.state.step_count)} steps each, the two "
          f"simulations hold the same state bitwise: {same}")
    if not same:
        raise AssertionError("the designs' steps differ")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--at", type=int, nargs="+", default=[30])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--other", help="another checkout whose shipped "
                    "csrc/pcisph.cu joins the designs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pcisph_walk_control: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sph_taichi_torch.ops import _build
    from sph_taichi_torch.simulation import Simulation

    os.chdir(ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    t0 = time.perf_counter()
    _build.build(["pairs", "dfsph", "pcisph"])
    controls = build_controls(args.other)
    print(f"built in {time.perf_counter() - t0:.1f} s")
    sim = Simulation(config=cs.dragon_config(1), scene_dir=ROOT)
    for at in sorted(args.at):
        sim.run(at - int(sim.state.step_count), export=False)
        torch.cuda.synchronize()
        print(f"dragon_bath PCISPH after {int(sim.state.step_count)} steps: "
              f"{sim.params.n_particles} particles (fluid "
              f"{sim.params.n_fluid})")
        kernels(sim, controls, args.turns)
        steps(sim, controls[NO_LIST], args.turns)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
