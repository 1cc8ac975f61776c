"""The PyTorch port's PCISPH path and checkpoints against the JAX package, on the CPU.

Each pair sum's plain version (ops/cuda_pcisph.py) with its epilogue
against the JAX solver's unfused term and formulas from one sorted state,
index by index; one whole step from identical particles, index by index;
the per-step iteration counts of both packages' own runs; a port of
test_physics.py's incompressibility test; and checkpoints: a resumed run
equals an uninterrupted one bitwise, and a JAX checkpoint continues in the
port.  Tolerance: the engine-equivalence one, atol 2e-5 and rtol 2e-4
(conftest._assert_states_close).  The JAX side runs through its gather
engine (its CPU path, unfused), each program compiled once per module.

Scenes: ``small`` is small_scene_dict(method=1) (dt 4e-3); ``impact`` a
block from the floor's padding line up to 0.6 m falling at 2 m/s at dt
4e-3, where the loop runs 3-5 iterations per step; ``two_way`` the
dynamic rigid block of test_pallas_blocks.py's PCISPH case.  (The DFSPH
floor impact, whose block starts inside the floor's padding, does not
converge under PCISPH in either package: 1001 iterations from its second
step at every dt from 4e-3 to 4e-4.)
"""

import functools
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial import cKDTree

import sph_taichi_tpu as J
from sph_taichi_tpu.models import base as jbase
from sph_taichi_tpu.ops import kernels as jkernels
from sph_taichi_tpu.utils import checkpoint as jcheckpoint

import sph_taichi_torch as T
from sph_taichi_torch import convert
from sph_taichi_torch.models.pcisph import PCISPHSolver
from sph_taichi_torch.ops import cuda_pairs, cuda_pcisph
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.kernels import cubic_kernel_derivative_scalar
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.simulation import Simulation
from sph_taichi_torch.utils.checkpoint import load_checkpoint, save_checkpoint

from conftest import _clumped_positions, small_scene_dict

ATOL, RTOL = 2e-5, 2e-4
N_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _impact_scene():
    """640 fluid particles from the floor's padding line (y = 0.1) up to
    0.6 m, falling at 2 m/s, dt 4e-3, with test_torch_dfsph.py's caps."""
    d = small_scene_dict(method=1, block=((0.1, 0.1, 0.1), (0.5, 0.6, 0.5)),
                         velocity=(0.0, -2.0, 0.0), dt=4e-3)
    d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


def _two_way_scene():
    """tests/test_pallas_blocks.py's PCISPH scene: the small block and a
    dynamic rigid block beside it."""
    d = small_scene_dict(method=1)
    d["RigidBlocks"] = [{
        "objectId": 1, "start": [0.55, 0.1, 0.1], "end": [0.85, 0.4, 0.4],
        "translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
        "velocity": [0.0, 0.0, 0.0], "density": 1000.0,
        "color": [100, 100, 100], "isDynamic": True}]
    return d


def _rigid_scene():
    """test_torch_iisph.py's scene with method 1: the small block beside a
    static rigid block (the solid mirror)."""
    d = small_scene_dict(method=1)
    d["RigidBlocks"] = [{
        "objectId": 1, "start": [0.55, 0.1, 0.1], "end": [0.8, 0.35, 0.35],
        "translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
        "velocity": [0.0, 0.0, 0.0], "density": 1000.0,
        "color": [100, 100, 100], "isDynamic": False}]
    return d


SCENES = {"small": lambda: small_scene_dict(method=1),
          "impact": _impact_scene, "two_way": _two_way_scene,
          "rigid": _rigid_scene}
JAX_STEPS = {"small": 4, "impact": N_STEPS, "two_way": 2}


def _np_state(s):
    return ({k: np.asarray(v) for k, v in s.p._asdict().items()
             if v is not None},
            np.asarray(s.rigid_rest_cm), np.asarray(s.dt), np.asarray(s.t),
            np.asarray(s.step_count))


def _torch_scene(scene):
    return T.build_scene(T.SimConfig(config_dict=SCENES[scene]()),
                         device="cpu")


def _run(scene, n_steps):
    params, particles, _ = _torch_scene(scene)
    solver = T.build_solver(params, device="cpu")
    state = solver.initialize(particles)
    metrics = []
    for _ in range(n_steps):
        state, m = solver.step(state)
        metrics.append(m)
    return params, solver, state, metrics


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{scene: (JAX states after 0..n steps, JAX metrics of steps 1..n)},
    each scene's step compiled once; and the JAX package's checkpoint of
    the small scene after 2 steps."""
    runs = {}
    ckpt = str(tmp_path_factory.mktemp("jax") / "checkpoint.npz")
    for name, n in JAX_STEPS.items():
        jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=SCENES[name]()))
        solver = J.build_solver(jp)
        state = solver.initialize(jpart)
        states, metrics = [_np_state(state)], []
        for i in range(n):
            state, m = solver.step(state)
            states.append(_np_state(state))
            metrics.append({k: np.asarray(v) for k, v in m.items()
                            if k != "rigid"})
            if name == "small" and i == 1:
                jcheckpoint.save_checkpoint(ckpt, state)
        runs[name] = (states, metrics)
    runs["checkpoint"] = ckpt
    return runs


@pytest.fixture(scope="module")
def impact_run():
    """The port's own run of the impact scene, N_STEPS steps."""
    return _run("impact", N_STEPS)


# ---------------------------------------------------------------------------
# the scaling factor
# ---------------------------------------------------------------------------

def test_scaling_factor_matches_jax():
    """The gradient factor on f32 scalars and the lattice sum equal the
    JAX package's; s_f, from the state's dt, equals the JAX solver's to
    the bit at two dts."""
    params, _, _ = _torch_scene("small")
    jp, _, _ = J.build_scene(J.SimConfig(config_dict=SCENES["small"]()))
    jsolver = J.build_solver(jp)
    solver = T.build_solver(params, device="cpu")
    h = params.support_radius
    for rm in np.linspace(1e-5, h, 97)[1:]:
        got = cubic_kernel_derivative_scalar(
            torch.tensor(rm, dtype=torch.float32), h, 3)
        ref = jkernels.cubic_kernel_derivative_scalar(jnp.float32(rm), h, 3)
        assert np.float32(got) == np.float32(ref), rm
    assert solver.s_f_base == jsolver.s_f_base

    @jax.jit
    def jax_s_f(dt):
        # the expression of pcisph.py:188-190
        return 1.0 / jnp.maximum(
            2.0 * (dt * jp.m_V0) ** 2 * jsolver.s_f_base, 1e-6)

    for dt in (4e-3, 4e-4):
        got = solver.scaling_factor(torch.tensor(np.float32(dt)))
        ref = np.asarray(jax_s_f(jnp.float32(dt)))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == ref.tobytes(), (dt, got, ref)


# ---------------------------------------------------------------------------
# each pair sum's plain version against the JAX term
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _case(seed=0):
    """Identical sorted particles in both packages on the rigid scene
    (clumped positions, random velocities), a seeded prediction (v* up to
    10 m/s, x* = x + dt v*, so that pairs leave the radius) and pressure
    field (on the sorted rows),
    and the JAX solver's unfused terms on them with the formulas of its
    loop (pcisph.py:228-245).

    Returns (torch params, torch particles after compute_densities and the
    non-pressure forces, cell offsets, neighbour lists, inputs, {name: JAX
    result})."""
    rng = np.random.default_rng(seed)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=_rigid_scene()))
    x = _clumped_positions(rng, jp, jpart)
    real = np.asarray(jpart.material) != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    solver = J.build_solver(jp)
    dt = jnp.float32(jp.dt0)
    s_f = 1.0 / jnp.maximum(2.0 * (dt * jp.m_V0) ** 2 * solver.s_f_base,
                            1e-6)
    rho0 = jp.density0

    @jax.jit
    def refs(part, vp_seed, pressure):
        p, nl, _ = jbase.bin_and_sort(part, jp, solver.engine)
        p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_moving_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_densities(p, nl, solver.engine, jp)
        p = jbase.compute_non_pressure_forces(p, nl, solver.engine, jp,
                                              solver.g)
        fluid = p.is_fluid()
        fluid3 = fluid[:, None]
        vp = jnp.where(fluid3, vp_seed, p.v)
        xp = jnp.where(fluid3, p.x + dt * vp, p.x)
        q = p._replace(x=xp, v=vp, pressure=pressure)
        d_rho = solver._d_rho(q, nl, q.x, q.v)
        rho_err = jnp.where(
            fluid, jnp.maximum(p.density + dt * d_rho - rho0, 0.0), 0.0)
        pr = jnp.where(fluid, jnp.maximum(pressure + s_f * rho_err, 0.0),
                       0.0)
        q = q._replace(pressure=pr)
        p_acc = jnp.where(fluid3, solver._pressure_accel(q, nl, q.x, pr),
                          0.0)
        v_new = jnp.where(fluid3, p.v + dt * (p.acc + p_acc), p.v)
        x_new = jnp.where(fluid3, p.x + dt * v_new, p.x)
        return {"p": p, "vp": vp, "xp": xp, "pr": pr, "rho_err": rho_err,
                "v_new": v_new, "x_new": x_new}

    vp_seed = rng.uniform(-10.0, 10.0, size=x.shape).astype(np.float32)
    pressure = np.where(real, rng.uniform(0.0, 2000.0, real.shape),
                        0.0).astype(np.float32)
    out = jax.device_get(refs(jpart._replace(
        x=jnp.asarray(x), v=jnp.asarray(v, jnp.float32)),
        jnp.asarray(vp_seed), jnp.asarray(pressure)))
    p = {k: a for k, a in out.pop("p")._asdict().items() if a is not None}
    tp = _torch_scene("rigid")[0]
    tpart = convert.particles_from_numpy(p, "cpu")
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(tpart.x, tpart.material, tp.grid_size,
                               tp.grid_num), tp.num_cells)
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    assert not int(tnl.diag["neighbor_overflow"])
    inputs = {"xp": _t(out["xp"]), "vp": _t(out["vp"]),
              "pressure": _t(pressure),
              "dt": torch.tensor(np.float32(jp.dt0)),
              "s_f": torch.tensor(np.asarray(s_f))}
    return tp, tpart, starts, tnl, inputs, out


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
    before = dict(cuda_pcisph.LAUNCHES)
    for a, b in zip(fn(*args), plain_out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert cuda_pcisph.LAUNCHES == before


def test_pair_set_is_the_step_start_one():
    """The case moves pairs: some step-start pairs lie beyond h at x*,
    and some pairs that are not neighbours at the step start come within
    h at x* (the plain engine leaves them out, as the JAX gather engine
    does)."""
    tp, tpart, _, tnl, inputs, _ = _case()
    h2 = tp.support_radius ** 2
    xp = inputs["xp"]
    valid = tnl.mask()
    d2 = ((xp[:, None, :] - xp[tnl.idx]) ** 2).sum(-1)
    assert int((valid & (d2 >= h2)).sum()) > 10
    n = tp.n_fluid + tp.n_solid
    all_d2 = ((xp[:n, None, :] - xp[None, :n, :]) ** 2).sum(-1)
    near_at_xp = int(((all_d2 < h2).sum(1) - 1).sum())
    assert near_at_xp > int((valid & (d2 < h2))[:n].sum())


def test_d_rho_correct_plain_matches_jax():
    """g1: the density derivative at (x*, v*) with the correction
    epilogue, against the JAX unfused _d_rho and the loop's formulas."""
    tp, tpart, starts, tnl, inp, ref = _case()
    args = (tpart, inp["xp"], inp["vp"], inp["pressure"], inp["dt"],
            inp["s_f"], tp)
    got = cuda_pcisph.d_rho_correct_plain(tnl, *args)
    _close(got[0], ref["pr"], tp, "pressure")
    _close(got[1], ref["rho_err"], tp, "rho_err")
    fluid = tpart.material.numpy() == 1
    assert (ref["rho_err"][fluid] > 0).any() and (ref["rho_err"][fluid]
                                                  == 0).any()
    assert (ref["pr"][fluid] > inp["pressure"].numpy()[fluid]).any()
    # the wrapper takes the step's context, as the solver gives it
    ctx = cuda_pairs.density_sum_list(starts, tpart, tp)[1]
    _wrapper_equals_plain(cuda_pcisph.d_rho_correct, (ctx, *args), got)


def test_pressure_accel_predict_plain_matches_jax():
    """g2: the pressure acceleration at x* (solid mirror included) with
    the predict epilogue, against the JAX unfused _pressure_accel and the
    loop's predict."""
    tp, tpart, starts, tnl, inp, ref = _case()
    pr = _t(ref["pr"])
    args = (tpart, inp["xp"], pr, inp["dt"], tp)
    got = cuda_pcisph.pressure_accel_predict_plain(tnl, *args)
    _close(got[0], ref["v_new"], tp, "v*")
    _close(got[1], ref["x_new"], tp, "x*")
    solid = tpart.material.numpy() == 0
    assert np.array_equal(got[0].numpy()[solid], tpart.v.numpy()[solid])
    ctx = cuda_pairs.density_sum_list(starts, tpart, tp)[1]
    _wrapper_equals_plain(cuda_pcisph.pressure_accel_predict,
                          (ctx, *args), got)


# ---------------------------------------------------------------------------
# whole steps against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene,start", [("small", 2), ("impact", 3),
                                         ("impact", 7), ("two_way", 1)])
def test_one_step_matches_jax(jax_runs, scene, start):
    """One step from the JAX state after ``start`` steps, index by index:
    the small block in flight (3 iterations), the impact's fourth and
    eighth steps (4 iterations each), the dynamic rigid's second step."""
    states, metrics = jax_runs[scene]
    params = _torch_scene(scene)[0]
    ts, tm = T.build_solver(params, device="cpu").step(
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
    if scene == "impact":
        assert int(jm["pressure_iters"]) > 3
        assert ref["pressure"][ref["material"] == 1].max() > 0


def test_iteration_counts_match_jax_each_step(jax_runs, impact_run):
    """Both packages run the impact 8 steps on their own; every step's
    iterations agree, the loop iterates past its minimum, and the host
    reads its test once per check_every iterations."""
    _, jm = jax_runs["impact"]
    tm = impact_run[3]
    j = [int(m["pressure_iters"]) for m in jm]
    t = [int(m["pressure_iters"]) for m in tm]
    assert t == j, (t, j)
    assert min(t) >= 3 and max(t) > 3
    assert not any(int(m["cell_overflow"]) | int(m["neighbor_overflow"])
                   for m in tm)
    k = impact_run[1].check_every
    assert k == 3
    assert [m["pressure_host_reads"] for m in tm] == [-(-n // k) for n in t]


def test_two_way_rigid_matches_jax(jax_runs):
    """The dynamic rigid block (test_pallas_blocks.py's PCISPH case) two
    steps in both packages, each on its own: the rigid advects by its
    non-pressure acceleration and the shape matching.

    The block's faces rest on the box's low planes (y = z = padding).
    After the first shape matching, whose rotation comes from an SVD that
    differs between LAPACK and XLA by ~2e-7, a rigid particle on such a
    plane lands an ulp either side of it, and the clamp reflects its
    velocity on one axis more or less (6 of the 294 rigid rows here,
    ROADMAP.md section 3).  So the rigid rows' velocities are held on the
    rows off those planes; test_one_step_matches_jax[two_way-1] holds every
    row of the second step from the same state."""
    states, jm = jax_runs["two_way"]
    params, _, state, tm = _run("two_way", 2)
    ref = states[2][0]
    got = convert.particles_to_numpy(state.p)
    real = ref["material"] != -1
    # a rigid row that moves to the next cell permutes the sort: match
    # rows by nearest position (conftest._assert_states_close, matched)
    dist, idx = cKDTree(ref["x"][real]).query(got["x"][real], k=1)
    assert len(np.unique(idx)) == len(idx) and dist.max() < 5e-4
    ref = {k: a[real][idx] for k, a in ref.items()}
    got = {k: a[real] for k, a in got.items()}
    np.testing.assert_array_equal(got["material"], ref["material"])
    for name in ("x", "density", "pressure", "m_V"):
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    fluid = ref["material"] == 1
    rigid = ref["material"] == 0
    off_planes = rigid & (ref["x"] > params.padding + 1e-6).all(axis=1)
    assert off_planes.sum() > 100
    for rows in (fluid, off_planes):
        np.testing.assert_allclose(got["v"][rows], ref["v"][rows],
                                   atol=ATOL, rtol=RTOL)
    assert [int(m["pressure_iters"]) for m in tm] == [
        int(m["pressure_iters"]) for m in jm]
    assert np.abs(got["v"][rigid]).max() > 1e-3


def test_incompressibility_after_impact():
    """Port of test_physics.py:233: a falling block splashing down stays
    within 2% of rho0 over 120 steps, with at least 3 and at most 1001
    iterations per step, finite and inside the padded box."""
    d = small_scene_dict(method=1, dt=4e-4,
                         block=((0.1, 0.12, 0.1), (0.5, 0.42, 0.5)),
                         velocity=(0.0, -2.0, 0.0))
    params, particles, _ = T.build_scene(T.SimConfig(config_dict=d),
                                         device="cpu")
    solver = T.build_solver(params, device="cpu")
    state = solver.initialize(particles)
    iters = []
    for _ in range(120):
        state, m = solver.step(state)
        iters.append(m["pressure_iters"])
    iters = torch.stack(iters)
    assert int(iters.min()) >= 3 and int(iters.max()) <= 1001
    fluid = state.p.material == 1
    x = state.p.x[fluid].numpy()
    assert np.isfinite(x).all()
    assert x.min() >= params.padding - 1e-5
    dens = state.p.density[fluid]
    assert float(dens.max()) <= 1000.0 * 1.02, float(dens.max())


def test_determinism_bitwise(impact_run):
    again = _run("impact", N_STEPS)[2].p
    for name in ("x", "v", "pressure", "acc"):
        assert torch.equal(getattr(impact_run[2].p, name),
                           getattr(again, name)), name


def test_build_solver_gives_pcisph(impact_run):
    params, solver, _, _ = impact_run
    assert params.simulation_method == 1
    assert isinstance(solver, PCISPHSolver)
    assert (solver.max_iterations, solver.min_iterations,
            solver.tolerance_frac) == (1000, 3, 0.01)


def test_simulation_cli_runs_pcisph(tmp_path, capsys):
    """The CLI runs method 1 (set with --method on a method-0 scene file)
    on the CPU and prints its iterations and host reads per step."""
    from sph_taichi_torch import run_simulation
    d = _impact_scene()
    d["Configuration"]["simulationMethod"] = 0
    scene = tmp_path / "scenes" / "x" / "s.json"
    scene.parent.mkdir(parents=True)
    scene.write_text(json.dumps(d))
    run_simulation.main(["--scene_file", str(scene), "--max_frames", "5",
                         "--method", "1", "--device", "cpu", "--output_dir",
                         str(tmp_path / "out")])
    out = capsys.readouterr().out.strip().splitlines()
    assert "method: 1" in out[0]
    # steps 1-5 of the impact: 3 + 3 + 3 + 4 + 4 iterations, 2 host reads
    # each (a read every 3)
    assert out[-1].startswith("frame 5 ")
    assert "iterations/step pressure 3.40 (max 4)" in out[-1]
    assert "host reads/step 1.40" in out[-1]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path, impact_run):
    """Port of test_io.py's test_checkpoint_roundtrip on the impact: a
    state saved after 3 steps and loaded into a fresh one continues
    bitwise as the uninterrupted run."""
    params, particles, _ = _torch_scene("impact")
    solver = T.build_solver(params, device="cpu")
    state = solver.initialize(particles)
    for _ in range(3):
        state, _ = solver.step(state)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state)
    assert sorted(tmp_path.iterdir()) == [tmp_path / "ck.npz"]
    restored = load_checkpoint(path, solver.initialize(particles))
    assert int(restored.step_count) == 3
    for _ in range(N_STEPS - 3):
        restored, _ = solver.step(restored)
    for name, a in impact_run[2].p._asdict().items():
        if a is not None:
            assert torch.equal(getattr(restored.p, name), a), name
    for name in ("rigid_rest_cm", "dt", "t", "step_count"):
        assert torch.equal(getattr(restored, name),
                           getattr(impact_run[2], name)), name


def test_checkpoint_shape_mismatch_raises(tmp_path):
    small = _run("small", 0)
    two_way = _run("two_way", 0)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, small[2])
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, two_way[2])


def test_jax_checkpoint_resumes_in_the_port(jax_runs):
    """A checkpoint written by the JAX package (small scene, after 2
    steps) loads into the port, and the port's next 2 steps match the JAX
    package's at the tolerance."""
    params, particles, _ = _torch_scene("small")
    solver = T.build_solver(params, device="cpu")
    state = load_checkpoint(jax_runs["checkpoint"],
                            solver.initialize(particles))
    states, _ = jax_runs["small"]
    assert int(state.step_count) == 2
    assert np.array_equal(state.p.x.numpy(), states[2][0]["x"])
    for _ in range(2):
        state, _ = solver.step(state)
    ref = states[4][0]
    real = ref["material"] != -1
    got = convert.particles_to_numpy(state.p)
    for name in ("x", "v", "density", "pressure"):
        np.testing.assert_allclose(got[name][real], ref[name][real],
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_cli_checkpoint_interval_and_resume(tmp_path):
    """--checkpoint_interval writes <output_dir>/checkpoint.npz; --resume
    continues from it, and the resumed run's state equals the
    uninterrupted run's bitwise."""
    from sph_taichi_torch import run_simulation
    scene = tmp_path / "scenes" / "x" / "s.json"
    scene.parent.mkdir(parents=True)
    scene.write_text(json.dumps(_impact_scene()))
    out = tmp_path / "out"
    run_simulation.main(["--scene_file", str(scene), "--max_frames", "3",
                         "--checkpoint_interval", "2", "--device", "cpu",
                         "--output_dir", str(out), "--quiet"])
    ck = out / "checkpoint.npz"
    assert int(np.load(ck)["leaf_15"]) == 2        # step_count, frame 2
    out2 = tmp_path / "out2"
    run_simulation.main(["--scene_file", str(scene), "--max_frames", "2",
                         "--resume", str(ck), "--checkpoint_interval", "2",
                         "--device", "cpu", "--output_dir", str(out2),
                         "--quiet"])
    sim = Simulation(str(scene), scene_dir=str(tmp_path), device="cpu")
    sim.run(4, export=False)
    resumed = load_checkpoint(str(out2 / "checkpoint.npz"), sim.state)
    assert int(resumed.step_count) == 4
    for name, a in sim.state.p._asdict().items():
        if a is not None:
            assert torch.equal(getattr(resumed.p, name), a), name


def test_cuda_pcisph_needs_no_nvcc_to_import():
    """The module loads without a toolkit (the build happens at the first
    launch), and the kernel checks refuse CPU tensors."""
    params, part, _ = _torch_scene("small")
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_pairs._check_common(None, part, params)
    names = {"pcisph_d_rho_correct", "pcisph_pressure_accel_predict"}
    # each loop kernel's launches over cell runs and over the slot walk
    assert set(cuda_pcisph.LAUNCHES) == names | {n + "[slots]"
                                                 for n in names}
