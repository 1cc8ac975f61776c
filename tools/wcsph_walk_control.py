"""Time WCSPH's two kernels, the density kernel writing the step's pair list
and the force kernel reading it, against the controls of that design.

On the WCSPH step over the cell runs ``density_sum_list`` sums the
densities and writes every real centre's accepted pairs to the step's pair
list as it runs the candidate phase of the two-phase walk, and
``wcsph_forces`` runs its pair body over the list (ops/cuda_pairs.py).  This
script builds ``tools/wcsph_walk_control.cu`` (the same kernels with the
force kernel's list walk replaced, the density kernel with its term in a
pass over its fresh list, and a separate list build) and, at dragon_bath
WCSPH states (``--at``:
steps from the start; chip_smoke.py times its kernels at step 55), times
in interleaved turns (CUDA events, mean of 20 launches) each design's
kernels per step:

- shipped: ``density_sum_list`` + ``wcsph_forces`` over its list;
- one phase: ``density_sum`` + ``wcsph_forces`` walking the cells in one
  phase (the design before the list);
- (A) two phases: ``density_sum`` + ``wcsph_forces`` walking the cells in
  two phases (``for_each_neighbor_compact``), no list;
- (B) separate build: ``density_sum`` + a list build (the candidate phase
  alone writing every real centre's list) + ``wcsph_forces`` over the
  list;
- (C) density pass: the density term in a pass over the centre's fresh
  list + ``wcsph_forces`` over the list.

Every design's densities, lists and forces are checked equal bitwise
first.  Then whole steps of each design from the same state, in
interleaved turns: device busy time per step (torch.profiler) and step time
(CUDA events); the states stay equal bitwise.

    python3 tools/wcsph_walk_control.py [--at 55] [--turns 3]

Needs a CUDA device and nvcc; builds into build/kernels/ and
build/wcsph_walk_control/.
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

SHIPPED = "shipped (a writes the list, b reads it)"
ONE_PHASE = "one phase (no list)"
TWO_PHASE = "A: b in two phases (no list)"
BUILD = "B: separate list build"
PASS = "C: a's term over its fresh list"
# the control libraries: name -> nvcc flags
CONTROLS = {ONE_PHASE: ["-DONE_PHASE"], TWO_PHASE: ["-DTWO_PHASE"],
            PASS: []}


def build_controls():
    """{control: ctypes handle} of CONTROLS, built together, with the
    shipped launchers' signatures."""
    from sph_taichi_torch.ops import _build
    from sph_taichi_torch.ops import cuda_pairs as cp

    shipped = cp._lib()
    out = os.path.join(ROOT, "build", "wcsph_walk_control")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(ROOT, "tools", "wcsph_walk_control.cu")
    procs = {}
    for k, (name, flags) in enumerate(CONTROLS.items()):
        lib = os.path.join(out, f"lib{k}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             *flags, "-o", lib, src], stdout=subprocess.PIPE,
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
        for fn in ("density_sum_launch", "density_sum_list_launch",
                   "wcsph_forces_launch"):
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.control_density_pass_launch.argtypes = \
            shipped.density_sum_list_launch.argtypes
        lib.control_density_pass_launch.restype = ctypes.c_int
        lib.control_build_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, cp.PairConsts,
                                     ctypes.c_void_p])
        lib.control_build_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def separate_build(lib, starts, p, params, buffers):
    """Design B's list: every real centre's, written by the control
    library ``lib``'s separate build kernel into ``buffers``."""
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops import pair_list

    dev, n, ptr, _, _ = cp._walk(starts, p, params)
    idx, cnt = pair_list.list_buffers(buffers, n, dev)
    rc = lib.control_build_launch(ptr["x"], ptr["starts"], idx.data_ptr(),
                                  cnt.data_ptr(), n, cp.pair_consts(params),
                                  cp._stream(dev))
    cp._raise_on(rc, "control_build")
    return pair_list.PairList(starts, idx, cnt)


class _Pass:
    """A control library whose density_sum_list launcher is the density
    pass's."""

    def __init__(self, lib):
        self.lib = lib
        self.density_sum_list_launch = lib.control_density_pass_launch

    def __getattr__(self, name):
        return getattr(self.lib, name)


@contextlib.contextmanager
def design(name, libs):
    """The WCSPH wrappers and step running design ``name``: its library
    for the pair kernels and, for the designs whose density kernel writes
    no list, a density call that gives the force kernel the context it
    reads (an unread list, or the separate build's)."""
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops import pair_list

    real_lib, real_list = cp._lib, cp.density_sum_list
    if name in (ONE_PHASE, TWO_PHASE):
        cp._lib = lambda: libs[name]
    elif name == PASS:
        cp._lib = lambda: _Pass(libs[name])
    if name in (ONE_PHASE, TWO_PHASE, BUILD):
        def density_and_context(ctx, p, params, buffers=None):
            den = cp.density_sum(ctx, p, params)
            if name == BUILD:
                return den, separate_build(libs[PASS], ctx, p, params,
                                           buffers)
            # the controls read no list: an unwritten one
            idx, cnt = pair_list.list_buffers(buffers, p.n, p.x.device)
            return den, pair_list.PairList(ctx, idx, cnt)

        cp.density_sum_list = density_and_context
    try:
        yield
    finally:
        cp._lib, cp.density_sum_list = real_lib, real_list


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


def kernels(sim, libs, turns):
    """Per-launch times at the state of ``sim`` of each design's kernels,
    in turns, after checking that every design's results are equal
    bitwise; each design's kernels per step."""
    import chip_smoke as cs
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_pairs as cp

    params, solver, state = sim.params, sim.solver, sim.state
    q, starts, _ = base.bin_and_sort(state.p, params, solver.engine,
                                     solver.tables)
    buffers, build_buffers = {}, {}
    q, plist = base.compute_densities_and_pairs(q, starts, solver.engine,
                                                params, buffers)
    q, dpi, p_r02, m_nc, rr0 = solver.force_inputs(q)
    dt = state.dt

    def forces(ctx):
        return cp.wcsph_forces(ctx, q, dpi, p_r02, m_nc, rr0, dt, params)

    # (kernel, design) -> call
    calls = {
        ("density_sum", ONE_PHASE): lambda: cp.density_sum(starts, q,
                                                           params),
        ("density_sum_list", SHIPPED): lambda: cp.density_sum_list(
            starts, q, params, buffers),
        ("density_sum_list", PASS): lambda: cp.density_sum_list(
            starts, q, params, buffers),
        ("list build", BUILD): lambda: separate_build(
            libs[PASS], starts, q, params, build_buffers),
        ("wcsph_forces", SHIPPED): lambda: forces(plist),
        ("wcsph_forces", ONE_PHASE): lambda: forces(plist),
        ("wcsph_forces", TWO_PHASE): lambda: forces(plist),
    }
    den_ref, list_ref = cp.density_sum_list(starts, q, params, {})
    frc_ref = forces(list_ref)
    for (k, d), fn in calls.items():
        with design(d, libs):
            out = fn()
        if k == "density_sum":
            same = torch.equal(out, den_ref)
        elif k == "wcsph_forces":
            same = all(torch.equal(a, b) for a, b in zip(out, frc_ref))
        else:
            if k == "density_sum_list":
                same = torch.equal(out[0], den_ref)
                out = out[1]
            else:
                same = True
            valid = torch.arange(out.idx.shape[0], device=q.x.device)[
                :, None] < torch.clamp_max(out.cnt, out.idx.shape[0])
            same = same and torch.equal(out.cnt, list_ref.cnt) and \
                torch.equal(torch.where(valid, out.idx, -1),
                            torch.where(valid, list_ref.idx, -1))
        if not same:
            raise AssertionError(f"{k} [{d}]: not equal to the shipped "
                                 f"design's")
    print(f"  densities, lists and forces equal bitwise in the "
          f"{len(calls)} kernel designs")
    times = {key: [] for key in calls}
    for _ in range(turns):
        for (k, d), fn in calls.items():
            with design(d, libs):
                times[k, d].append(cs.time_ms(fn, 20))
    med = {key: statistics.median(t) for key, t in times.items()}
    for (k, d), t in times.items():
        print(f"  {k} [{d}]: {med[k, d]:.4f} ms (turns "
              f"{[round(x, 4) for x in t]})")
    per_step = {
        SHIPPED: med["density_sum_list", SHIPPED]
        + med["wcsph_forces", SHIPPED],
        ONE_PHASE: med["density_sum", ONE_PHASE]
        + med["wcsph_forces", ONE_PHASE],
        TWO_PHASE: med["density_sum", ONE_PHASE]
        + med["wcsph_forces", TWO_PHASE],
        BUILD: med["density_sum", ONE_PHASE] + med["list build", BUILD]
        + med["wcsph_forces", SHIPPED],
        PASS: med["density_sum_list", PASS] + med["wcsph_forces", SHIPPED]}
    print("  the step's pair kernels per step (ms): " + ", ".join(
        f"{d} {t:.4f}" for d, t in per_step.items()))


def steps(sim, libs, turns, per_turn=5):
    """Whole steps of each design from the same state, in interleaved
    turns: device busy and step time per step; the states stay equal
    bitwise."""
    from sph_taichi_torch.simulation import Simulation

    names = [SHIPPED, ONE_PHASE, TWO_PHASE, BUILD, PASS]
    sims = {SHIPPED: sim}
    for d in names[1:]:
        twin = Simulation(config=sim.config, scene_dir=ROOT)
        twin.state = sim.state   # a step makes new tensors; none is written
        sims[d] = twin
    busy = {d: [] for d in names}
    wall = {d: [] for d in names}
    for turn in range(turns):
        for d in names[::1 if turn % 2 == 0 else -1]:
            with design(d, libs):
                busy[d].append(busy_ms(sims[d], per_turn))
                wall[d].append(step_ms(sims[d], per_turn))
    for d in names:
        print(f"  {d}: device busy {statistics.median(busy[d]):.4f} ms per "
              f"step (turns {[round(t, 4) for t in busy[d]]}), step "
              f"{statistics.median(wall[d]):.4f} ms (turns "
              f"{[round(t, 4) for t in wall[d]]})")
    same = all(torch.equal(a, getattr(sims[d].state.p, f))
               for d in names[1:]
               for f, a in sim.state.p._asdict().items() if a is not None)
    print(f"  after {int(sim.state.step_count)} steps each, the "
          f"{len(names)} simulations hold the same state bitwise: {same}")
    if not same:
        raise AssertionError("the designs' steps differ")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--at", type=int, nargs="+", default=[55])
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wcsph_walk_control: no CUDA device", file=sys.stderr)
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
    _build.build(["pairs"])
    libs = build_controls()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    sim = Simulation(config=cs.dragon_config(0), scene_dir=ROOT)
    for at in sorted(args.at):
        sim.run(at - int(sim.state.step_count), export=False)
        torch.cuda.synchronize()
        print(f"dragon_bath WCSPH after {int(sim.state.step_count)} steps: "
              f"{sim.params.n_particles} particles (fluid "
              f"{sim.params.n_fluid})")
        kernels(sim, libs, args.turns)
        steps(sim, libs, args.turns)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
