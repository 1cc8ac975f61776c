"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. the card's name and power limit; build the CUDA kernels from
   sph_taichi_torch/csrc (nvcc) and print the build time and ptxas report;
2. each kernel against its plain PyTorch version on the card, on small
   scenes with clumped positions (cells above 8 particles, particles in edge
   cells), for the fluid-only force term and for the two-way reaction term;
3. the main path: data/scenes/dragon_bath.json (WCSPH, 442,006 particles)
   through ``Simulation`` on the card, timed with CUDA events; the kernels'
   launch counts over that run; per-kernel and plain-version times at the
   dragon state's shapes; one kernel step held index-wise against one
   plain-engine step from the same state.
The last lines are a ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}``.

Tolerances: atol 2e-5, rtol 2e-4 (the engine-equivalence tolerance of the
JAX package's tests, tests/conftest.py _assert_states_close).  Kernel and
plain version compute the same f32 terms with the same rounding; they sum
them in different orders (the kernel sequentially per centre, torch.sum
in its own reduction order), which moves a pair sum by a few ulps of its
largest term.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ATOL, RTOL = 2e-5, 2e-4
H100_BYTES_PER_S = 3.35e12     # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores
# f32 operations per within-radius pair, counted from csrc/pairs.cu
# (distance test 8, sqrt 1, W 13, multiply-add 2)
DENSITY_FLOPS_PER_PAIR = 24
# (distance 8, sqrt+square 2, inverse 2, dW/r 12, W 13, surface tension 3,
#  v_ij.r_ij 8, viscosity 5, pressure 4, sum of terms 2, radial sum 6)
FORCES_FLOPS_PER_PAIR = 65


def small_scene(two_way=False):
    """A ~600-particle fluid block (and a dynamic rigid block) in the
    reference's scene schema."""
    d = {
        "Configuration": {
            "domainStart": [0.0, 0.0, 0.0], "domainEnd": [1.0, 1.0, 1.0],
            "particleRadius": 0.025, "numberOfStepsPerRenderUpdate": 1,
            "density0": 1000, "simulationMethod": 0,
            "gravitation": [0.0, -9.81, 0.0], "timeStepSize": 4e-4,
            "stiffness": 50000, "exponent": 7},
        "FluidBlocks": [{
            "objectId": 0, "start": [0.1, 0.3, 0.1], "end": [0.5, 0.8, 0.5],
            "translation": [0.0, 0.0, 0.0], "scale": [1, 1, 1],
            "velocity": [0.0, -1.0, 0.0], "density": 1000.0,
            "color": [50, 100, 200]}],
    }
    if two_way:
        d["RigidBlocks"] = [{
            "objectId": 1, "start": [0.55, 0.45, 0.25],
            "end": [0.8, 0.7, 0.5], "translation": [0.0, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0], "velocity": [0.0, 0.0, 0.0],
            "density": 500.0, "color": [100, 100, 100], "isDynamic": True}]
    return d


def clumped_positions(rng, params, x):
    """Random positions in the padded box, a 20-particle clump inside one
    cell, 12 particles straddling a cell plane, one particle in the first
    and last cell along each axis."""
    x = x.copy()
    n = params.n_fluid + params.n_solid
    size = np.asarray(params.domain_size, np.float32)
    cell, pad = params.grid_size, params.padding
    x[:n] = rng.uniform(pad, size - pad, size=(n, 3))
    c0 = np.array([3, 3, 3]) * cell + 0.1 * cell
    x[:20] = c0 + rng.uniform(0, 0.8 * cell, size=(20, 3))
    c1 = np.array([5, 5, 4]) * cell
    x[20:32] = c1 + rng.uniform(-0.4 * cell, 0.4 * cell, size=(12, 3))
    grid = np.asarray(params.grid_num)
    for i, (ax, hi) in enumerate(((0, False), (1, False), (2, False),
                                  (0, True), (1, True), (2, True))):
        p = rng.uniform(pad, size - pad, size=3)
        p[ax] = (grid[ax] - 0.5) * cell if hi else 0.5 * cell
        x[32 + i] = np.clip(p, pad, size - pad)
    return x.astype(np.float32)


def time_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls, by CUDA events (one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_errors(got, ref, name):
    """Max abs and rel error of ``got`` against ``ref``; raises above the
    tolerances."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    # entries that are not tiny, and the share of the tolerance used
    big = ref.abs() > 1e3 * ATOL
    rel = float((err[big] / ref.abs()[big]).max()) if bool(big.any()) else 0.0
    used = float((err / (ATOL + RTOL * ref.abs())).max())
    print(f"  {name}: max abs err {float(err.max()):.3e}  max rel err "
          f"(|ref| > {1e3 * ATOL:g}) {rel:.3e}  tolerance used {used:.3f}")
    if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
        bad = int((err > ATOL + RTOL * ref.abs()).sum())
        raise AssertionError(f"{name}: {bad} entries outside atol {ATOL} "
                             f"rtol {RTOL}")
    return float(err.max())


def prepared(scene_dict, device, seed):
    """Sorted particles with clumped positions and random velocities, their
    Akinci volumes and densities (plain engine), the cell offsets and the
    plain engine's neighbour lists."""
    from sph_taichi_torch import SimConfig, build_scene, build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops.pairs import GatherEngine

    params, part, _ = build_scene(SimConfig(config_dict=scene_dict),
                                  device=device)
    rng = np.random.default_rng(seed)
    x = clumped_positions(rng, params, part.x.cpu().numpy())
    v = np.zeros_like(x)
    n = params.n_fluid + params.n_solid
    v[:n] = rng.uniform(-1.0, 1.0, size=(n, 3))
    part = part._replace(x=torch.tensor(x, device=device),
                         v=torch.tensor(v, device=device))
    engine = GatherEngine(params)
    solver = build_solver(params, device=device, engine=engine)
    p, nl, diag = base.bin_and_sort(part, params, engine, solver.tables)
    p = base.compute_static_boundary_volume(p, nl, engine, params)
    p = base.compute_moving_boundary_volume(p, nl, engine, params)
    p = base.compute_densities(p, nl, engine, params)
    starts = base.cell_offsets(
        base.compute_cell_ids(p.x, p.material, params.grid_size,
                              params.grid_num), params.num_cells)
    return params, solver, p, nl, starts, diag


def check_kernels_on_small_scenes(device):
    from sph_taichi_torch.ops import cuda_pairs as cp

    worst = {"density_sum": 0.0, "wcsph_forces": 0.0}
    for two_way in (False, True):
        params, solver, p, nl, starts, diag = prepared(
            small_scene(two_way), device, seed=0)
        occ = int(diag["max_cell_occupancy"])
        if occ <= 8 or int(diag["neighbor_overflow"]):
            raise AssertionError(f"clumped scene: occupancy {occ}, "
                                 f"overflow {int(diag['neighbor_overflow'])}")
        print(f"small scene two_way={two_way}: {params.n_particles} "
              f"particles, max cell occupancy {occ}, max neighbours "
              f"{int(diag['max_neighbors'])}")
        got = cp.density_sum(starts, p, params)
        ref = cp.density_sum_plain(nl, p.x, p.material, p.m_V, params)
        worst["density_sum"] = max(worst["density_sum"], max_errors(
            got, ref, f"density_sum[two_way={two_way}]"))
        q, dpi, p_r02, m_nc, rr0 = solver.force_inputs(p)
        if (rr0 is not None) != two_way:
            raise AssertionError("reaction variant not selected as expected")
        dt = torch.full((), params.dt0, dtype=torch.float32, device=device)
        got = cp.wcsph_forces(starts, q, dpi, p_r02, m_nc, rr0, dt, params)
        ref = cp.wcsph_forces_plain(nl, q, dpi, p_r02, m_nc, rr0, dt, params)
        for name, a, b in zip(("x", "v", "acc"), got, ref):
            worst["wcsph_forces"] = max(
                worst["wcsph_forces"],
                max_errors(a, b, f"wcsph_forces[react={two_way}].{name}"))
        if two_way:
            rigid = q.material == 0
            g = torch.tensor(params.gravity, device=device)
            dev_acc = float((got[2][rigid] - g).abs().max())
            print(f"  reaction on the dynamic rigid: max |acc - g| "
                  f"{dev_acc:.3e}")
            if dev_acc < 1e-3:
                raise AssertionError("two-way reaction not exercised")
    return worst


def profile_steps(sim, steps):
    """Device busy share and the kernels by device time over ``steps``
    steps of ``Simulation.run`` under torch.profiler (the profiler adds
    host overhead, so the busy share it shows is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(steps // sim.substeps, export=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an aten op's row repeats its kernels' time
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    if not rows:
        print("profiler: no device time recorded; busy share not measured")
        return None
    busy = sum(r[0] for r in rows)
    print(f"profiler over {steps} steps: wall {wall_us / steps:.1f} us/step "
          f"under the profiler, device busy {busy / steps:.1f} us/step, "
          f"{sum(r[1] for r in rows) / steps:.1f} kernels/step")
    return busy / steps / 1e3
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / steps:9.2f} us/step  {count / steps:5.1f}/step  "
              f"{key[:90]}")


def main_path(device, scene_path, warmup, steps):
    from sph_taichi_torch import build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pairs import GatherEngine
    from sph_taichi_torch.simulation import Simulation

    t0 = time.perf_counter()
    sim = Simulation(scene_path)
    torch.cuda.synchronize()
    params = sim.params
    print(f"dragon_bath: {params.n_particles} particles (fluid "
          f"{params.n_fluid}, solid {params.n_solid}), n_pad {params.n_pad}, "
          f"grid {params.grid_num}, dt {params.dt0}; scene + initialize "
          f"{time.perf_counter() - t0:.2f} s")
    sim.run(warmup, export=False)
    torch.cuda.synchronize()
    # a step makes no host sync: PyTorch raises on one in this mode
    torch.cuda.set_sync_debug_mode("error")
    sim.solver.step(sim.state)
    torch.cuda.set_sync_debug_mode("default")
    print("one step under torch.cuda sync-debug mode 'error': no host sync")

    # the main path: counts to 0 just before, read just after
    cp.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = dict(cp.LAUNCHES)
    step_ms = start.elapsed_time(end) / steps
    print(f"main path: {steps} steps, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s; launches {launches}")
    for name, count in launches.items():
        if count != steps:
            raise AssertionError(f"{name}: {count} launches in {steps} steps")

    busy_ms = profile_steps(sim, 10)
    if busy_ms is not None:
        print(f"device busy {busy_ms:.4f} ms of the {step_ms:.4f} ms step: "
              f"idle share {100 * (1 - busy_ms / step_ms):.1f}%")

    p = sim.state.p
    fluid = p.material == 1
    xf = p.x[fluid]
    lo, hi = cp.box_limits(params)
    hi = torch.tensor(hi, device=device)
    metrics = sim.metrics
    if not bool(torch.isfinite(p.x).all() & torch.isfinite(p.v).all()):
        raise AssertionError("non-finite positions or velocities")
    if not bool((xf >= lo).all() & (xf <= hi).all()):
        raise AssertionError("fluid left the padded box")
    if bool(metrics["sort_invariant_violated"]):
        raise AssertionError("sort invariant violated")
    print(f"state after {int(sim.state.step_count)} steps: t "
          f"{float(sim.state.t):.4f} s, max fluid speed "
          f"{float(metrics['max_velocity']):.4f} m/s, max cell occupancy "
          f"{int(metrics['max_cell_occupancy'])}")

    # stage times of one step at this state (events around each stage)
    solver = sim.solver
    state = sim.state
    stages = {}

    def staged_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        q, ctx, _ = base.bin_and_sort(state.p, params, solver.engine,
                                      solver.tables)
        ev[1].record()
        q = base.compute_densities(q, ctx, solver.engine, params)
        ev[2].record()
        q = solver.compute_forces(q, ctx, dt=state.dt)
        ev[3].record()
        base.solve_rigid_body(q, state.rigid_rest_cm, params)
        ev[4].record()
        return ev

    for _ in range(3):
        staged_step()
    evs = [staged_step() for _ in range(10)]
    torch.cuda.synchronize()
    for k, name in enumerate(("bin_and_sort", "densities (incl. kernel)",
                              "forces (EOS + kernel)", "rigid solve")):
        stages[name] = sum(e[k].elapsed_time(e[k + 1]) for e in evs) / 10
    print("stage ms at this state: " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))

    # per-kernel times at the dragon state's shapes, and the plain versions
    plain_engine = GatherEngine(params)
    q, starts, _ = base.bin_and_sort(state.p, params, solver.engine,
                                     solver.tables)
    nl = plain_engine.prepare(q.x, starts)
    pairs = int(nl.cnt[:params.n_fluid + params.n_solid].long().sum())
    print(f"within-radius pairs (ordered, j != i): {pairs}; max neighbours "
          f"{int(nl.max_cnt)} (cap {params.neighbor_cap})")
    if int(nl.diag["neighbor_overflow"]):
        raise AssertionError("plain engine's neighbour cap overflowed")
    q = base.compute_densities(q, starts, solver.engine, params)
    q, dpi, p_r02, m_nc, rr0 = solver.force_inputs(q)
    n_real = params.n_fluid + params.n_solid
    cp.reset_launch_counts()      # comparison launches are not the path's
    k_den = time_ms(lambda: cp.density_sum(starts, q, params), 20)
    k_frc = time_ms(lambda: cp.wcsph_forces(starts, q, dpi, p_r02, m_nc, rr0,
                                            state.dt, params), 20)
    p_den = time_ms(lambda: cp.density_sum_plain(nl, q.x, q.material, q.m_V,
                                                 params), 3)
    p_frc = time_ms(lambda: cp.wcsph_forces_plain(nl, q, dpi, p_r02, m_nc,
                                                  rr0, state.dt, params), 3)
    nl_ms = time_ms(lambda: plain_engine.prepare(q.x, starts), 3)
    print(f"plain engine neighbour-list build: {nl_ms:.4f} ms")
    err_den = max_errors(cp.density_sum(starts, q, params)[:n_real],
                         cp.density_sum_plain(nl, q.x, q.material, q.m_V,
                                              params)[:n_real],
                         "dragon density_sum")
    err_frc = 0.0
    for name, a, b in zip(("x", "v", "acc"),
                          cp.wcsph_forces(starts, q, dpi, p_r02, m_nc, rr0,
                                          state.dt, params),
                          cp.wcsph_forces_plain(nl, q, dpi, p_r02, m_nc, rr0,
                                                state.dt, params)):
        err_frc = max(err_frc, max_errors(a, b, f"dragon wcsph_forces.{name}"))

    n = n_real
    cells = params.num_cells + 2
    den_bytes = n * (12 + 4 + 4) + 4 * cells + 4 * n
    frc_bytes = n * (12 + 12 + 4 + 4 + 4 + 4 + 4 + 4 + 4) + 4 * cells + 4 \
        + n * 36
    bounds = {}
    for name, nbytes, flops in (
            ("density_sum", den_bytes, pairs * DENSITY_FLOPS_PER_PAIR),
            ("wcsph_forces", frc_bytes, pairs * FORCES_FLOPS_PER_PAIR)):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOPS * 1e3
        bounds[name] = (max(t_bytes, t_ops),
                        "bytes" if t_bytes >= t_ops else "operations")
        print(f"{name} bound: {nbytes} bytes -> {t_bytes:.5f} ms, "
              f"{flops} flop -> {t_ops:.5f} ms")

    # one kernel step against one plain-engine step from the same state
    plain_solver = build_solver(params, device=device, engine=plain_engine)
    ks, _ = solver.step(state)
    ps, pm = plain_solver.step(state)
    if int(pm["neighbor_overflow"]):
        raise AssertionError("plain step overflowed its neighbour cap")
    real = ps.p.material != -1
    for name in ("x", "v", "density", "pressure", "acc"):
        max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                   f"step kernel vs plain engine: {name}")

    src = "sph_taichi_torch/csrc/pairs.cu"
    kernels = [
        {"name": "density_sum", "route": "cuda", "source": src,
         "replaces": "sph_taichi_tpu/ops/pallas_blocks.py:718",
         "launches": launches["density_sum"], "max_abs_err": err_den,
         "ms": k_den, "plain_ms": p_den, "bound_ms": bounds["density_sum"][0],
         "bound_by": bounds["density_sum"][1], "library_ms": None},
        {"name": "wcsph_forces", "route": "cuda", "source": src,
         "replaces": "sph_taichi_tpu/ops/pallas_blocks.py:718",
         "launches": launches["wcsph_forces"], "max_abs_err": err_frc,
         "ms": k_frc, "plain_ms": p_frc,
         "bound_ms": bounds["wcsph_forces"][0],
         "bound_by": bounds["wcsph_forces"][1], "library_ms": None},
    ]
    return kernels, step_ms


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    from sph_taichi_torch.ops import _build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(["pairs"])
    print(f"kernels built from sph_taichi_torch/csrc in "
          f"{time.perf_counter() - t0:.2f} s")
    print(_build.build_log("pairs").strip())

    worst = check_kernels_on_small_scenes(device)
    print(f"small-scene kernel vs plain max abs err: {json.dumps(worst)}")

    kernels, step_ms = main_path(device, "data/scenes/dragon_bath.json",
                                 warmup=5, steps=50)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
