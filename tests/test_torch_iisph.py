"""The PyTorch port's IISPH path against the JAX package, on the CPU.

Each pair sum's plain version (ops/cuda_iisph.py) against the JAX
solver's method from one sorted state, index by index; the same plain
versions against the dense numpy oracle of tests/test_iisph_oracle.py;
one whole step from identical particles, index by index; and the per-step
Jacobi iteration counts of both packages' own runs.  Tolerance: the
engine-equivalence one, atol 2e-5 and rtol 2e-4
(conftest._assert_states_close), except against the dense oracle, which
keeps test_iisph_oracle.py's tolerances.  The JAX side runs through its
gather engine (its CPU path, unfused), each program compiled once per
module.

Scenes: ``rigid`` is the oracle's, a falling fluid block beside a static
rigid block; ``rigid_impact`` a fluid block falling onto a static rigid
block (the solid pressure mirror); ``floor_impact`` is
test_torch_dfsph.py's block that rests on the floor and falls into it at
2 m/s, at dt 1e-3: there the pressure solve runs 59 iterations in the
second step and 2-7 in the next six.  (At DFSPH's dt 4e-3, and at 2e-3,
both packages' IISPH run 1000 iterations in the second step without
converging and reach NaN in the third.)
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sph_taichi_tpu as J
from sph_taichi_tpu.models import base as jbase

import sph_taichi_torch as T
from sph_taichi_torch import convert
from sph_taichi_torch.models import base as tbase
from sph_taichi_torch.models.iisph import IISPHSolver
from sph_taichi_torch.ops import cuda_iisph, cuda_pairs
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.pairs import GatherEngine

from conftest import _clumped_positions, small_scene_dict

ATOL, RTOL = 2e-5, 2e-4
N_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rigid_scene():
    """tests/test_iisph_oracle.py's scene: the small fluid block beside a
    static rigid block."""
    d = small_scene_dict(method=2)
    d["RigidBlocks"] = [{
        "objectId": 1, "start": [0.55, 0.1, 0.1], "end": [0.8, 0.35, 0.35],
        "translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
        "velocity": [0.0, 0.0, 0.0], "density": 1000.0,
        "color": [100, 100, 100], "isDynamic": False}]
    return d


def _floor_impact_scene():
    """768 fluid particles from the floor up to 0.6 m, falling at 2 m/s;
    the caps of test_torch_dfsph.py (the impact packs up to 36 particles
    into a cell)."""
    d = small_scene_dict(method=2, block=((0.1, 0.03, 0.1), (0.5, 0.6, 0.5)),
                         velocity=(0.0, -2.0, 0.0), dt=1e-3)
    d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


def _rigid_impact_scene():
    """A fluid block falling at 2 m/s onto a static rigid block right
    below it, at dt 1e-3: the pressure solve iterates, and the fluid at the
    rigid's top face takes the solid mirror."""
    d = small_scene_dict(method=2, block=((0.1, 0.27, 0.1), (0.5, 0.6, 0.5)),
                         velocity=(0.0, -2.0, 0.0), dt=1e-3)
    d["RigidBlocks"] = [{
        "objectId": 1, "start": [0.1, 0.1, 0.1], "end": [0.5, 0.25, 0.5],
        "translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
        "velocity": [0.0, 0.0, 0.0], "density": 1000.0,
        "color": [100, 100, 100], "isDynamic": False}]
    d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


SCENES = {"rigid": _rigid_scene, "rigid_impact": _rigid_impact_scene,
          "floor_impact": _floor_impact_scene}


def _np_state(s):
    return ({k: np.asarray(v) for k, v in s.p._asdict().items()
             if v is not None},
            np.asarray(s.rigid_rest_cm), np.asarray(s.dt), np.asarray(s.t),
            np.asarray(s.step_count))


def _torch_params(scene):
    return T.build_scene(T.SimConfig(config_dict=SCENES[scene]()),
                         device="cpu")[0]


def _run(scene, n_steps):
    params, particles, _ = T.build_scene(
        T.SimConfig(config_dict=SCENES[scene]()), device="cpu")
    solver = T.build_solver(params, device="cpu")
    state = solver.initialize(particles)
    metrics = []
    for _ in range(n_steps):
        state, m = solver.step(state)
        metrics.append(m)
    return params, solver, state, metrics


@pytest.fixture(scope="module")
def jax_runs():
    """{scene: (JAX states after 0..n steps, JAX metrics of steps 1..n)},
    each scene's step compiled once."""
    runs = {}
    for name in ("rigid_impact", "floor_impact"):
        jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=SCENES[name]()))
        solver = J.build_solver(jp)
        state = solver.initialize(jpart)
        states, metrics = [_np_state(state)], []
        for _ in range(N_STEPS):
            state, m = solver.step(state)
            states.append(_np_state(state))
            metrics.append({k: np.asarray(v) for k, v in m.items()
                            if k != "rigid"})
        runs[name] = (states, metrics)
    return runs


@pytest.fixture(scope="module")
def floor_run():
    """The port's own run of the floor-impact scene, N_STEPS steps."""
    return _run("floor_impact", N_STEPS)


# ---------------------------------------------------------------------------
# each pair sum's plain version against the JAX method
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _case(seed=0):
    """Identical sorted particles in both packages on the rigid scene
    (clumped positions, random velocities and pressures), and the JAX
    solver's stages on them from one compiled program.

    Returns (torch params, torch particles after compute_densities, cell
    offsets, neighbour lists, {name: JAX result})."""
    rng = np.random.default_rng(seed)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=_rigid_scene()))
    x = _clumped_positions(rng, jp, jpart)
    real = np.asarray(jpart.material) != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    pressure = np.where(real, rng.uniform(0.0, 2000.0, real.shape),
                        0.0).astype(np.float32)
    solver = J.build_solver(jp)
    one = J.build_solver(jp)
    one.max_iterations = 1          # pressure_solve = one Jacobi update
    dt = np.float32(jp.dt0)

    @jax.jit
    def refs(part):
        p, nl, _ = jbase.bin_and_sort(part, jp, solver.engine)
        p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_moving_boundary_volume(p, nl, solver.engine, jp)
        q = jbase.compute_densities(p, nl, solver.engine, jp)
        out = {"q": q}
        q = solver.compute_non_pressure(q, nl)
        out["acc"] = q.acc
        q, a_ii, source, last_p = solver.predict_advection(q, nl, dt)
        out.update(v_star=q.v, a_ii=a_ii, source=source, last_p=last_p)
        accel = solver._pressure_accel(q, nl, last_p)
        out["accel"] = accel
        out["ap_sum"] = solver._apply_A(q, nl, accel)
        new_p, m = one.pressure_solve(q, nl, a_ii, source, last_p, dt)
        out.update(new_p=new_p, err=m["pressure_error"],
                   iters=m["pressure_iters"])
        adv = solver.advect(q, jnp.where(q.is_fluid()[:, None], accel, 0.0),
                            dt)
        out["adv_v"], out["adv_x"] = adv.v, adv.x
        return out

    out = jax.device_get(refs(jpart._replace(
        x=jnp.asarray(x), v=jnp.asarray(v, jnp.float32),
        pressure=jnp.asarray(pressure))))
    assert int(out["iters"]) == 1
    p = {k: a for k, a in out.pop("q")._asdict().items() if a is not None}
    tp = _torch_params("rigid")
    tpart = convert.particles_from_numpy(p, "cpu")
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(tpart.x, tpart.material, tp.grid_size,
                               tp.grid_num), tp.num_cells)
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    assert not int(tnl.diag["neighbor_overflow"])
    return tp, tpart, starts, tnl, out


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, tp, name):
    n = tp.n_fluid + tp.n_solid
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got[:n], np.asarray(ref)[:n], atol=ATOL,
                               rtol=RTOL, err_msg=name)


def _wrapper_equals_plain(fn, args, plain_out):
    """The kernel wrapper takes the plain version on CPU tensors and
    counts no launch."""
    before = dict(cuda_iisph.LAUNCHES)
    got = fn(*args)
    if torch.is_tensor(plain_out):
        got, plain_out = (got,), (plain_out,)
    for a, b in zip(got, plain_out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert cuda_iisph.LAUNCHES == before


def test_nonpressure_kick_plain_matches_jax():
    """f1: acc = g + viscosity on every real row (static solids too) and
    the fluid kick."""
    tp, tpart, starts, tnl, ref = _case()
    dt = torch.tensor(np.float32(tp.dt0))
    got = cuda_iisph.nonpressure_kick_plain(tnl, tpart, dt, tp)
    _close(got[0], ref["acc"], tp, "acc")
    _close(got[1], ref["v_star"], tp, "v*")
    g = np.asarray(tp.gravity, np.float32)
    for mat in (0, 1):
        rows = tpart.material.numpy() == mat
        assert np.abs(ref["acc"][rows] - g).max() > 1e-3, mat
    # the wrapper takes the step's context, as the solver gives it
    ctx = cuda_pairs.density_sum_list(starts, tpart, tp)[1]
    _wrapper_equals_plain(cuda_iisph.nonpressure_kick,
                          (ctx, tpart, dt, tp), got)


def test_predict_advection_plain_matches_jax():
    """f2: a_ii, the source term and the warm start from v*."""
    tp, tpart, starts, tnl, ref = _case()
    dt = torch.tensor(np.float32(tp.dt0))
    p = tpart._replace(v=_t(ref["v_star"]))
    got = cuda_iisph.predict_advection_plain(tnl, p, dt, tp)
    for name, a in zip(("a_ii", "source", "last_p"), got):
        _close(a, ref[name], tp, name)
        assert np.abs(ref[name][:tp.n_particles]).max() > 0, name
    ctx = cuda_pairs.density_sum_list(starts, p, tp)[1]
    _wrapper_equals_plain(cuda_iisph.predict_advection, (ctx, p, dt, tp),
                          got)


def test_pressure_accel_plain_matches_jax():
    """f3 in both forms: every real row's acceleration (the loop's), and
    the advect of the fluid rows (the final one)."""
    tp, tpart, starts, tnl, ref = _case()
    dt = torch.tensor(np.float32(tp.dt0))
    p = tpart._replace(v=_t(ref["v_star"]))
    last_p = _t(ref["last_p"])
    accel = cuda_iisph.pressure_accel_plain(tnl, p, last_p, tp)
    _close(accel, ref["accel"], tp, "accel")
    solid = tpart.material.numpy() == 0
    assert np.abs(ref["accel"][solid]).max() > 0
    v, x = cuda_iisph.pressure_accel_plain(tnl, p, last_p, tp, advect_dt=dt)
    _close(v, ref["adv_v"], tp, "v")
    _close(x, ref["adv_x"], tp, "x")
    # the wrapper takes the step's context, as the solver gives it
    ctx = cuda_pairs.density_sum_list(starts, p, tp)[1]
    _wrapper_equals_plain(cuda_iisph.pressure_accel,
                          (ctx, p, last_p, tp), accel)
    _wrapper_equals_plain(cuda_iisph.pressure_accel,
                          (ctx, p, last_p, tp, dt), (v, x))
    # the solver's advect is the epilogue's unfused form
    fluid = p.is_fluid()[:, None]
    q = IISPHSolver(tp, device="cpu").advect(
        p, torch.where(fluid, accel, 0.0), dt)
    assert torch.equal(q.v, v) and torch.equal(q.x, x)


def test_apply_A_plain_matches_jax():
    """f4: the A sum, and one relaxed-Jacobi update with its error column
    against the JAX solve capped at one iteration."""
    tp, tpart, starts, tnl, ref = _case()
    dt = torch.tensor(np.float32(tp.dt0))
    p = tpart._replace(v=_t(ref["v_star"]))
    accel = _t(ref["accel"])
    a_ii, source, last_p = (_t(ref[k]) for k in ("a_ii", "source", "last_p"))
    _close(cuda_iisph.apply_A_sum_plain(tnl, p, accel, tp), ref["ap_sum"],
           tp, "ap_sum")
    got = cuda_iisph.apply_A_plain(tnl, p, accel, a_ii, source, last_p, dt,
                                   0.5, tp)
    _close(got[0], ref["new_p"], tp, "new_p")
    real = tpart.material.numpy() >= 0
    assert (ref["new_p"][real] > 0).mean() > 0.1
    assert (ref["new_p"][real] == 0).any()
    n_real = tp.n_fluid + tp.n_solid
    err = float(torch.sum(got[1][:n_real])) / tp.n_particles
    np.testing.assert_allclose(err, float(ref["err"]), rtol=RTOL, atol=ATOL)
    ctx = cuda_pairs.density_sum_list(starts, p, tp)[1]
    _wrapper_equals_plain(cuda_iisph.apply_A,
                          (ctx, p, accel, a_ii, source, last_p, dt, 0.5,
                           tp), got)


# ---------------------------------------------------------------------------
# the plain versions against the dense numpy oracle
# ---------------------------------------------------------------------------

def _grad_w_over_r(rn, h):
    """dW/dr / r of the 3D cubic spline in float64 (sph_base.py:47-68)."""
    k = 6.0 * 8.0 / np.pi / h ** 3
    q = rn / h
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(q <= 0.5, k * q * (3.0 * q - 2.0),
                     -k * (1.0 - q) ** 2) / (rn * h)
    return np.where((rn > 1e-5) & (q <= 1.0), g, 0.0)


def test_iisph_plain_matches_dense_oracle():
    """a_ii, the source term, the pressure acceleration (solid mirror), A
    and one omega = 0.5 update of the port, after one real step of the
    rigid scene (pressures from a seed), against
    tests/test_iisph_oracle.py's dense formulas in float64 (its
    tolerances)."""
    params, solver, state, _ = _run("rigid", 1)
    dt = state.dt
    p, nl, _ = tbase.bin_and_sort(state.p, params, solver.engine,
                                  solver.tables)
    p = tbase.compute_densities(p, nl, solver.engine, params)
    p = solver.compute_non_pressure(p, nl, dt)
    a_ii_s, source_s, _ = solver.predict_advection(p, nl, dt)
    # a seeded pressure field: the step's own is 0 at this state
    rng = np.random.default_rng(3)
    last_p_s = torch.tensor(np.where(
        p.material.numpy() >= 0, rng.uniform(0.0, 2000.0, p.n),
        0.0).astype(np.float32))
    accel_s = solver._pressure_accel(p, nl, last_p_s)
    ap_s = cuda_iisph.apply_A_sum_plain(nl, p, accel_s, params) \
        * (dt * dt) * params.density0
    new_p_s, _ = solver._apply_A(p, nl, accel_s, a_ii_s, source_s, last_p_s,
                                 dt)

    h, dtf = params.support_radius, float(dt)
    rho0 = float(params.density0)
    x = p.x.double().numpy()
    v = p.v.double().numpy()
    m_V = p.m_V.double().numpy()
    mat = p.material.numpy()
    real, fluid, solid = mat >= 0, mat == 1, mat == 0
    dens = np.where(real, p.density.double().numpy(), 1.0)
    rvec = x[:, None, :] - x[None, :, :]
    rn = np.sqrt((rvec ** 2).sum(-1))
    mask = (rn < h) & ~np.eye(len(x), dtype=bool) \
        & real[None, :] & real[:, None]
    gws = _grad_w_over_r(rn, h)
    gradw = gws[:, :, None] * rvec
    mgm = np.where(mask[:, :, None], m_V[None, :, None] * gradw, 0.0)
    G = mgm.sum(1)
    S = (mgm / (dens[None, :, None] ** 2)).sum(1)
    Q = np.where(mask, m_V[None, :] * gws ** 2 * rn ** 2, 0.0).sum(1)
    a_ii_o = dtf * dtf * rho0 * rho0 * (-(S * G).sum(-1)
                                        - (m_V / dens ** 2) * Q)
    dvr = ((v[:, None, :] - v[None, :, :]) * gradw).sum(-1)
    source_o = rho0 - dens - dtf * np.where(
        mask, m_V[None, :] * dvr, 0.0).sum(1) * rho0
    np.testing.assert_allclose(a_ii_s.numpy()[real], a_ii_o[real],
                               rtol=2e-3, atol=1e-10)
    np.testing.assert_allclose(source_s.numpy()[real], source_o[real],
                               rtol=2e-3, atol=2e-2)

    pr = last_p_s.double().numpy()
    dpi = pr / dens ** 2
    dpj = np.where(fluid[None, :], (pr / dens ** 2)[None, :],
                   pr[:, None] / rho0 ** 2)
    coef = np.where(mask & (fluid | solid)[None, :],
                    -rho0 * m_V[None, :] * (dpi[:, None] + dpj) * gws, 0.0)
    accel_o = (coef[:, :, None] * rvec).sum(1)
    np.testing.assert_allclose(accel_s.numpy()[real], accel_o[real],
                               rtol=2e-3, atol=1e-4)
    assert np.abs(accel_o[real]).max() > 1.0

    da = accel_o[:, None, :] - accel_o[None, :, :]
    ap_o = dtf * dtf * rho0 * np.where(
        mask, m_V[None, :] * (da * gradw).sum(-1), 0.0).sum(1)
    np.testing.assert_allclose(ap_s.numpy()[real], ap_o[real], rtol=5e-3,
                               atol=5e-3)
    with np.errstate(divide="ignore", invalid="ignore"):
        new_p_o = np.where(np.abs(a_ii_o) > 1e-6,
                           np.maximum(pr + 0.5 * (source_o - ap_o) / a_ii_o,
                                      0.0), 0.0)
    np.testing.assert_allclose(new_p_s.numpy()[real], new_p_o[real],
                               rtol=5e-3, atol=5e-1)
    assert new_p_o[real].max() > 0


# ---------------------------------------------------------------------------
# whole steps against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene,start", [("rigid_impact", 7),
                                         ("floor_impact", 2)])
def test_one_step_matches_jax(jax_runs, scene, start):
    """One step from the JAX state after ``start`` steps, index by index:
    the fluid pressed onto the static rigid (the eighth step, where the
    solve runs 2 iterations and the fluid at the rigid's face is under
    pressure since the seventh), and the floor impact's third
    step, where the pressure solve runs 7 iterations.  (In its second
    step, 59 iterations, 4 of 2304 v entries land at up to 1.2x this
    tolerance, and pressures that are small differences of terms near
    1e6 Pa further: XLA's summation order against the port's, as
    test_torch_dfsph.py records for DFSPH.)"""
    states, metrics = jax_runs[scene]
    tp = _torch_params(scene)
    ts, tm = T.build_solver(tp, device="cpu").step(
        convert.state_from_numpy(*states[start], "cpu"))
    ref, jm = states[start + 1][0], metrics[start]
    real = ref["material"] != -1
    got = convert.particles_to_numpy(ts.p)
    np.testing.assert_array_equal(got["material"], ref["material"])
    for name in ("x", "v", "acc", "density", "pressure"):
        np.testing.assert_allclose(got[name][real], ref[name][real],
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    assert int(tm["pressure_iters"]) == int(jm["pressure_iters"])
    np.testing.assert_allclose(float(tm["pressure_error"]),
                               float(jm["pressure_error"]), rtol=RTOL,
                               atol=ATOL)
    # the fluid is under pressure (at the rigid: the solid mirror)
    assert ref["pressure"][ref["material"] == 1].max() > 0
    if scene == "floor_impact":
        assert int(jm["pressure_iters"]) > 1


def test_iteration_counts_match_jax_each_step(jax_runs, floor_run):
    """Both packages run the floor impact 8 steps on their own; every
    step's pressure iterations agree, and the loop iterates."""
    _, jm = jax_runs["floor_impact"]
    tm = floor_run[3]
    j = [int(m["pressure_iters"]) for m in jm]
    t = [int(m["pressure_iters"]) for m in tm]
    assert t == j, (t, j)
    assert max(t) > 1
    assert not any(int(m["cell_overflow"]) | int(m["neighbor_overflow"])
                   for m in tm)
    k = floor_run[1].check_every
    assert [m["pressure_host_reads"] for m in tm] == [-(-n // k) for n in t]


def test_particles_stay_in_padded_box(floor_run):
    params, _, state, _ = floor_run
    fluid = state.p.material.numpy() == 1
    x = state.p.x.numpy()[fluid]
    assert np.isfinite(x).all() and np.isfinite(state.p.v.numpy()).all()
    assert np.isfinite(state.p.pressure.numpy()).all()
    size = np.asarray(params.domain_size)
    assert (x >= params.padding - 1e-5).all()
    assert (x <= size - params.padding + 1e-5).all()


def test_determinism_bitwise(floor_run):
    again = _run("floor_impact", N_STEPS)[2].p
    for name in ("x", "v", "pressure"):
        assert np.array_equal(getattr(floor_run[2].p, name).numpy(),
                              getattr(again, name).numpy()), name


def test_state_converts_with_pressure(floor_run):
    """An IISPH state, whose pressure is the next step's warm start,
    round-trips through numpy bitwise."""
    state = floor_run[2]
    assert float(state.p.pressure.abs().max()) > 0
    back = convert.state_from_numpy(*convert.state_to_numpy(state), "cpu")
    for name, a in state.p._asdict().items():
        if a is not None:
            assert torch.equal(getattr(back.p, name), a), name
    for name in ("rigid_rest_cm", "dt", "t", "step_count"):
        assert torch.equal(getattr(back, name), getattr(state, name)), name


def test_build_solver_gives_iisph(floor_run):
    params, solver, _, _ = floor_run
    assert params.simulation_method == 2
    assert isinstance(solver, IISPHSolver)
    assert (solver.omega, solver.tolerance, solver.max_iterations) == (
        0.5, 1e-3, 1000)


def test_simulation_cli_reports_iisph_iterations(tmp_path, capsys):
    """The CLI runs method 2 (here set with --method on a method-0 scene
    file) and prints the pressure solve's iterations and host reads per
    step."""
    import json
    from sph_taichi_torch import run_simulation
    d = _floor_impact_scene()
    d["Configuration"]["simulationMethod"] = 0
    scene = tmp_path / "scenes" / "x" / "s.json"
    scene.parent.mkdir(parents=True)
    scene.write_text(json.dumps(d))
    run_simulation.main(["--scene_file", str(scene), "--max_frames", "3",
                         "--method", "2", "--device", "cpu", "--output_dir",
                         str(tmp_path / "out")])
    out = capsys.readouterr().out.strip().splitlines()
    assert "method: 2" in out[0]
    line = out[-1]
    assert line.startswith("frame 3 ")
    # steps 1-3 of the scene: 1 + 59 + 7 pressure iterations
    assert "iterations/step pressure 22.33 (max 59)" in line
    assert "divergence" not in line
    reads = sum(-(-n // IISPHSolver(_torch_params("floor_impact"),
                                    device="cpu").check_every)
                for n in (1, 59, 7))
    assert f"host reads/step {reads / 3:.2f}" in line


def test_cuda_iisph_needs_no_nvcc_to_import():
    """The module loads without a toolkit (the build happens at the first
    launch), the shared constants carry rho0^2, and the kernel checks
    refuse CPU tensors."""
    params, part, _ = T.build_scene(
        T.SimConfig(config_dict=_rigid_scene()), device="cpu")
    c = cuda_pairs.pair_consts(params)
    assert c.rho0sq == 1e6
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_pairs._check_common(None, part, params)
    names = {"iisph_nonpressure_kick", "iisph_predict_advection",
             "iisph_pressure_accel", "iisph_pressure_accel_advect",
             "iisph_apply_A"}
    # each kernel's launches over cell runs and over the slot walk
    assert set(cuda_iisph.LAUNCHES) == names | {n + "[slots]"
                                                for n in names}
