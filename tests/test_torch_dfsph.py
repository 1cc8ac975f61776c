"""The PyTorch port's DFSPH path against the JAX package, on the CPU.

Each pair sum's plain version against the JAX term on clumped positions,
one step from identical particles index by index, and the per-step
Jacobi iteration counts, at the engine-equivalence tolerance (atol 2e-5,
rtol 2e-4, conftest._assert_states_close); five steps against the
committed goldens at test_golden.py's tolerances (x 1e-4, v 1e-3).  The
JAX side runs through its GatherEngine, each program compiled once per
module.

``floor_impact`` is a block that rests on the floor and falls into it:
unlike the golden scenes, whose loops stop after one iteration, its
divergence solve runs up to 4 iterations and its pressure solve 2.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial import cKDTree

import sph_taichi_tpu as J
from sph_taichi_tpu.models import base as jbase

import sph_taichi_torch as T
from sph_taichi_torch import convert
from sph_taichi_torch.models import base as tbase
from sph_taichi_torch.models import dfsph as tdfsph
from sph_taichi_torch.ops import cuda_dfsph, cuda_pairs
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.pairs import GatherEngine

from conftest import _clumped_positions, small_scene_dict
from test_golden import _two_way_dfsph_scene

ATOL, RTOL = 2e-5, 2e-4
N_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes hold a few hundred particles: more torch threads only
    contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _floor_impact_scene():
    """768 fluid particles from the floor up to 0.6 m, falling at 2 m/s."""
    d = small_scene_dict(method=4, block=((0.1, 0.03, 0.1), (0.5, 0.6, 0.5)),
                         velocity=(0.0, -2.0, 0.0), dt=4e-3)
    # the impact packs up to 36 particles into a cell: above the default
    # cell cap of 32, where both packages' plain engines would truncate
    # the neighbour lists (the CUDA kernels have no cap)
    d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


SCENES = {"small": lambda: small_scene_dict(method=4),
          "two_way": _two_way_dfsph_scene,
          "floor_impact": _floor_impact_scene}


def _np_state(s):
    return ({k: np.asarray(v) for k, v in s.p._asdict().items()
             if v is not None},
            np.asarray(s.rigid_rest_cm), np.asarray(s.dt), np.asarray(s.t),
            np.asarray(s.step_count))


def _torch_state(s):
    return convert.state_from_numpy(*_np_state(s), "cpu")


def _run(scene, n_steps):
    params, particles, _ = T.build_scene(T.SimConfig(config_dict=scene),
                                         device="cpu")
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
    for name, n in (("small", 1), ("floor_impact", N_STEPS)):
        jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=SCENES[name]()))
        solver = J.build_solver(jp)
        state = solver.initialize(jpart)
        states, metrics = [_np_state(state)], []
        for _ in range(n):
            state, m = solver.step(state)
            states.append(_np_state(state))
            metrics.append({k: np.asarray(v) for k, v in m.items()
                            if k != "rigid"})
        runs[name] = (states, metrics)
    return runs


# ---------------------------------------------------------------------------
# (1) each pair sum's plain version against the JAX term
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _case(scene, seed=0):
    """Identical sorted particles in both packages (clumped positions,
    random velocities, accelerations and stiffnesses), and the JAX
    package's pair sums on them from one compiled program per scene.

    Returns (torch params, torch particles with the JAX density, cell
    offsets, neighbour lists, kappa, {name: JAX result}).  The stiffnesses
    span 1e-7 .. 10 in magnitude, on both sides of the m_eps gate and
    large enough that the solver update moves every velocity."""
    rng = np.random.default_rng(seed)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=SCENES[scene]()))
    x = _clumped_positions(rng, jp, jpart)
    real = np.asarray(jpart.material) != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    # accelerations away from gravity, so the reaction's sum shows
    acc = rng.uniform(-5.0, 5.0, size=x.shape).astype(np.float32)
    kappa = (rng.choice([-1.0, 1.0], size=real.shape)
             * 10.0 ** rng.uniform(-7.0, 1.0, size=real.shape))
    kappa = np.where(real, kappa, 0.0).astype(np.float32)
    solver = J.build_solver(jp)
    dt = np.float32(jp.dt0)
    react = bool(jp.dynamic_rigid_ids)

    @jax.jit
    def refs(part, acc, kappa):
        p, nl, _ = jbase.bin_and_sort(part, jp, solver.engine)
        p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_moving_boundary_volume(p, nl, solver.engine, jp)
        p = p._replace(acc=acc)
        q = solver.density_and_factor(p, nl)
        out = {"p": p, "density": q.density, "factor": q.dfsph_factor}
        out["change"] = solver._density_change(q, nl, q.v)
        out["adv"] = solver._density_adv(q, nl, q.v, q.density, dt)
        for mode, offset in (("change", 0.0), ("adv", jp.density0)):
            out[f"{mode}_err"] = solver._avg_density_error(q, out[mode],
                                                           offset)
        dv, reaction = solver._solver_dv(q, nl, kappa, react, dt)
        out["solver_v"] = jnp.where(q.is_fluid()[:, None], q.v + dv, q.v)
        if react:
            out["solver_acc"] = jnp.where(q.is_dynamic_rigid()[:, None],
                                          q.acc + reaction, q.acc)
        f = jbase.compute_non_pressure_forces(q, nl, solver.engine, jp,
                                              solver.g)
        f = solver.predict_velocity(f, dt)
        out["nonpressure_acc"], out["nonpressure_v"] = f.acc, f.v
        return out

    out = jax.device_get(refs(jpart._replace(x=jnp.asarray(x),
                                             v=jnp.asarray(v, jnp.float32)),
                              jnp.asarray(acc), jnp.asarray(kappa)))
    p = {k: a for k, a in out.pop("p")._asdict().items() if a is not None}
    p["density"] = out["density"]
    tp = T.build_scene(T.SimConfig(config_dict=SCENES[scene]()),
                       device="cpu")[0]
    tpart = convert.particles_from_numpy(p, "cpu")
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(tpart.x, tpart.material, tp.grid_size,
                               tp.grid_num), tp.num_cells)
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    return tp, tpart, starts, tnl, torch.tensor(kappa), out


def _close(got, ref, tp, name):
    n = tp.n_fluid + tp.n_solid
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got[:n], np.asarray(ref)[:n], atol=ATOL,
                               rtol=RTOL, err_msg=name)


def _wrapper_equals_plain(fn, args, plain_out):
    """The kernel wrapper takes the plain version on CPU tensors and
    counts no launch."""
    before = dict(cuda_dfsph.LAUNCHES)
    for a, b in zip(fn(*args), plain_out):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert cuda_dfsph.LAUNCHES == before


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_density_factor_plain_matches_jax(scene):
    tp, tpart, starts, tnl, _, ref = _case(scene)
    got = cuda_dfsph.density_factor_plain(tnl, tpart, tp)
    _close(got[0], ref["density"], tp, "density")
    _close(got[1], ref["factor"], tp, "factor")
    assert np.abs(ref["factor"]).max() > 0
    _wrapper_equals_plain(cuda_dfsph.density_factor, (starts, tpart, tp), got)
    # compute_factor is the factor output of the same traversal
    tsolver = T.build_solver(tp, device="cpu")
    np.testing.assert_array_equal(tsolver.compute_factor(tpart, tnl).numpy(),
                                  got[1].numpy())


@pytest.mark.parametrize("mode", ["change", "adv"])
@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_divergence_plain_matches_jax(scene, mode):
    tp, tpart, starts, tnl, _, ref = _case(scene)
    dt = torch.tensor(np.float32(tp.dt0))
    got = cuda_dfsph.divergence_plain(tnl, tpart, tpart.v, tpart.density,
                                      dt, mode, tp)
    _close(got[0], ref[mode], tp, "adv")
    assert np.abs(ref[mode]).max() > 0
    tsolver = T.build_solver(tp, device="cpu")
    np.testing.assert_allclose(float(tsolver._avg_density_error(got[1])),
                               float(ref[f"{mode}_err"]), rtol=RTOL,
                               atol=ATOL)
    _wrapper_equals_plain(cuda_dfsph.divergence,
                          (starts, tpart, tpart.v, tpart.density, dt, mode,
                           tp), got)


@pytest.mark.parametrize("scene,react", [("small", False), ("two_way", True)])
def test_solver_dv_plain_matches_jax(scene, react):
    """Without the reaction on the fluid-only scene, with it on the
    two-way scene (dynamic rigid centres gather the reaction)."""
    tp, tpart, starts, tnl, kappa, ref = _case(scene)
    assert bool(tp.dynamic_rigid_ids) == react
    dt = torch.tensor(np.float32(tp.dt0))
    got = cuda_dfsph.solver_dv_plain(tnl, tpart, kappa, tpart.v, tpart.acc,
                                     dt, react, tp)
    _close(got[0], ref["solver_v"], tp, "v")
    fluid = tpart.material.numpy() == 1
    assert (ref["solver_v"] != tpart.v.numpy())[fluid].mean() > 0.5
    if react:
        _close(got[1], ref["solver_acc"], tp, "acc")
        dynr = tpart.is_dynamic_rigid().numpy()
        assert np.abs(ref["solver_acc"] - tpart.acc.numpy())[dynr].max() > 0
    else:
        assert got[1] is None
    _wrapper_equals_plain(cuda_dfsph.solver_dv,
                          (starts, tpart, kappa, tpart.v, tpart.acc, dt,
                           react, tp), got)


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_nonpressure_kick_plain_matches_jax(scene):
    tp, tpart, starts, tnl, _, ref = _case(scene)
    dt = torch.tensor(np.float32(tp.dt0))
    got = cuda_dfsph.nonpressure_kick_plain(tnl, tpart, dt, tp)
    _close(got[0], ref["nonpressure_acc"], tp, "acc")
    _close(got[1], ref["nonpressure_v"], tp, "v")
    g = np.asarray(tp.gravity, np.float32)
    fluid = tpart.material.numpy() == 1
    assert np.abs(got[0].numpy()[fluid] - g).max() > 1e-3
    _wrapper_equals_plain(cuda_dfsph.nonpressure_kick,
                          (starts, tpart, dt, tp), got)
    # the unfused form sets acc alone
    q = tbase.compute_non_pressure_forces(tpart, tnl, GatherEngine(tp), tp)
    np.testing.assert_array_equal(q.acc.numpy(), got[0].numpy())
    np.testing.assert_array_equal(q.v.numpy(), tpart.v.numpy())


# ---------------------------------------------------------------------------
# (2, 3) whole steps against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene,start", [("small", 0), ("floor_impact", 1)])
def test_one_step_matches_jax(jax_runs, scene, start):
    """One step from identical particles, index by index.  The
    floor-impact step starts after 1 step, where the divergence solve
    runs 4 iterations.  (After 2 steps, 2 of 1536 acc entries, sums of
    viscosity terms near 100 that cancel near the floor, move past this
    tolerance with the summation order.)"""
    states, metrics = jax_runs[scene]
    tp = T.build_scene(T.SimConfig(config_dict=SCENES[scene]()),
                       device="cpu")[0]
    ts, tm = T.build_solver(tp, device="cpu").step(
        convert.state_from_numpy(*states[start], "cpu"))
    ref, jm = states[start + 1][0], metrics[start]
    real = ref["material"] != -1
    got = convert.particles_to_numpy(ts.p)
    np.testing.assert_array_equal(got["material"], ref["material"])
    for name in ("x", "v", "acc", "density", "density_adv", "dfsph_factor"):
        np.testing.assert_allclose(got[name][real], ref[name][real],
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    for k in ("divergence_iters", "pressure_iters"):
        assert int(tm[k]) == int(jm[k]), k
    for k in ("divergence_error", "pressure_error"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    if scene == "floor_impact":
        assert int(jm["divergence_iters"]) > 1


@pytest.fixture(scope="module")
def floor_run():
    """The port's own run of the floor-impact scene, N_STEPS steps."""
    return _run(_floor_impact_scene(), N_STEPS)


def test_iteration_counts_match_jax_each_step(jax_runs, floor_run):
    """Both packages run the floor-impact scene 8 steps on their own;
    every step's iteration counts agree, and both loops do iterate."""
    _, jm = jax_runs["floor_impact"]
    tm = floor_run[3]
    for k in ("divergence_iters", "pressure_iters"):
        j = [int(m[k]) for m in jm]
        t = [int(m[k]) for m in tm]
        assert t == j, (k, t, j)
        assert max(t) > 1, k
    assert not any(int(m["cell_overflow"]) | int(m["neighbor_overflow"])
                   for m in tm)


def test_golden_method4_5steps():
    ref = np.load("tests/golden/method4_5steps.npz")
    _, _, state, _ = _run(small_scene_dict(method=4), 5)
    m = state.p.material.numpy() >= 0
    np.testing.assert_allclose(state.p.x.numpy()[m], ref["x"], atol=1e-4)
    np.testing.assert_allclose(state.p.v.numpy()[m], ref["v"], atol=1e-3)


def test_golden_two_way_dfsph_5steps():
    """Matched by nearest position, as the WCSPH two-way golden is
    (test_torch_wcsph.py): the rigid lattice sits on cell planes."""
    ref = np.load("tests/golden/two_way_dfsph_5steps.npz")
    params, _, state, metrics = _run(_two_way_dfsph_scene(), 5)
    m = state.p.material.numpy() >= 0
    x, v = state.p.x.numpy()[m], state.p.v.numpy()[m]
    dist, idx = cKDTree(x).query(ref["x"], k=1)
    assert len(np.unique(idx)) == len(idx), "matching not a bijection"
    assert dist.max() < 1e-4
    np.testing.assert_allclose(v[idx], ref["v"], atol=1e-3)
    assert 1 <= int(metrics[-1]["pressure_iters"]) <= 100
    rigid = state.p.material.numpy()[m] == 0
    # the reaction shows: the rigid left the gravity-only trajectory
    assert np.abs(v[rigid][:, 1] - (-9.81 * 5 * params.dt0)).max() > 0.1


# ---------------------------------------------------------------------------
# (6, 7) ports of the JAX package's physics tests
# ---------------------------------------------------------------------------

def test_dfsph_converges_or_caps():
    _, _, _, metrics = _run(small_scene_dict(method=4), 8)
    assert 1 <= int(metrics[-1]["pressure_iters"]) <= 100
    assert 1 <= int(metrics[-1]["divergence_iters"]) <= 100


def test_dfsph_warm_start_matches_cold():
    """Both runs converge to the same tolerances, so matched states agree
    closely; the kappa accumulators stay finite and populate."""
    d = small_scene_dict(method=4)
    _, _, sc, _ = _run(d, 6)
    d2 = dict(d)
    d2["TPU"] = {"dfsphWarmStart": True}
    params2, _, sw, _ = _run(d2, 6)
    assert params2.dfsph_warm_start and sw.p.kappa_p is not None
    # the converters carry every DFSPH field
    arrays = convert.particles_to_numpy(sw.p)
    back = convert.particles_from_numpy(arrays, "cpu")
    for name in ("dfsph_factor", "density_adv", "kappa_v", "kappa_p"):
        assert torch.equal(getattr(back, name), getattr(sw.p, name)), name
    kv = sw.p.kappa_v.numpy()
    assert np.isfinite(kv).all()
    assert np.abs(kv).max() > 0, "warm accumulator never populated"
    xc = sc.p.x.numpy()[sc.p.material.numpy() == 1]
    xw = sw.p.x.numpy()[sw.p.material.numpy() == 1]
    dist, idx = cKDTree(xw).query(xc, k=1)
    assert len(np.unique(idx)) == len(idx)
    assert dist.max() < 5e-4, f"warm/cold diverged: {dist.max()}"


def test_particles_stay_in_padded_box(floor_run):
    """Through the impact on the floor: finite, and inside the padded box."""
    params, _, state, _ = floor_run
    fluid = state.p.material.numpy() == 1
    x = state.p.x.numpy()[fluid]
    assert np.isfinite(x).all() and np.isfinite(state.p.v.numpy()).all()
    size = np.asarray(params.domain_size)
    assert (x >= params.padding - 1e-5).all()
    assert (x <= size - params.padding + 1e-5).all()


def test_determinism_bitwise(floor_run):
    again = _run(_floor_impact_scene(), N_STEPS)[2].p
    for name in ("x", "v", "density_adv"):
        assert np.array_equal(getattr(floor_run[2].p, name).numpy(),
                              getattr(again, name).numpy()), name


# ---------------------------------------------------------------------------
# (8) the Jacobi loop's host reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_iters", [1, 4, 5, 9])
def test_jacobi_while_reads_once_per_k_iterations(monkeypatch, n_iters):
    """A loop of n iterations reads its test ceil(n / k) times and ends
    with the carry of a plain while loop."""
    k = tdfsph.JACOBI_CHECK_EVERY
    eta, cap = 0.5, 100

    def cond(c):
        err, it = c[-2:]
        return (it == 0) | ((err > eta) & (it < cap))

    def body(c, active):
        x, err, it = c
        return x * 0.5 + 1.0, err - 1.0, it + 1

    init = (torch.arange(4, dtype=torch.float32),
            torch.tensor(n_iters - 0.25), torch.tensor(0, dtype=torch.int32))
    reads = []
    real_bool = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda t: reads.append(1) or real_bool(t))
    (x, err, it), n_reads = tdfsph.jacobi_while(cond, body, init)
    monkeypatch.undo()
    assert int(it) == n_iters
    assert n_reads == len(reads) == -(-n_iters // k)
    ref = init
    while bool(cond(ref)):
        ref = body(ref, None)
    for a, b in zip((x, err, it), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("every", [2, 3])
def test_chunked_step_equals_per_iteration_step(jax_runs, every):
    """The floor-impact step with 4 divergence iterations: reading the
    test every iteration or every ``every`` iterations gives the same
    state bitwise, with ceil(4 / every) reads instead of 4."""
    states, metrics = jax_runs["floor_impact"]
    tp = T.build_scene(T.SimConfig(config_dict=_floor_impact_scene()),
                       device="cpu")[0]
    out = {}
    for k in (1, every):
        solver = T.build_solver(tp, device="cpu")
        solver.check_every = k
        out[k] = solver.step(convert.state_from_numpy(*states[1], "cpu"))
    (s1, m1), (sk, mk) = out[1], out[every]
    iters = int(m1["divergence_iters"])
    assert iters == int(metrics[1]["divergence_iters"]) > every
    assert m1["divergence_host_reads"] == iters
    assert mk["divergence_host_reads"] == -(-iters // every)
    for name, a in s1.p._asdict().items():
        if a is not None:
            assert torch.equal(a, getattr(sk.p, name)), name
    for k in ("divergence_iters", "pressure_iters", "divergence_error",
              "pressure_error"):
        assert torch.equal(m1[k], mk[k]), k


def test_simulation_cli_reports_dfsph_iterations(tmp_path, capsys):
    """The CLI runs method 4 and prints the solves' iterations and host
    reads per step, read from the device once per progress line."""
    import json
    from sph_taichi_torch import run_simulation
    scene = tmp_path / "scenes" / "x" / "s.json"
    scene.parent.mkdir(parents=True)
    scene.write_text(json.dumps(_floor_impact_scene()))
    run_simulation.main(["--scene_file", str(scene), "--max_frames", "3",
                         "--device", "cpu", "--output_dir",
                         str(tmp_path / "out")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("frame 3 ")
    # steps 1-3 of the scene: 1 + 4 + 4 divergence iterations, 3 pressure
    assert "iterations/step divergence 3.00 (max 4) pressure 1.00" in line
    k = tdfsph.JACOBI_CHECK_EVERY
    reads = sum(-(-n // k) for n in (1, 4, 4, 1, 1, 1))
    assert f"host reads/step {reads / 3:.2f}" in line


def test_cuda_dfsph_needs_no_nvcc_to_import():
    """The ctypes layout of the shared constants includes the DFSPH
    fields, and the kernel checks refuse CPU tensors."""
    params, part, _ = T.build_scene(
        T.SimConfig(config_dict=small_scene_dict(method=4)), device="cpu")
    c = cuda_pairs.pair_consts(params)
    assert (c.min_nbr, c.rho0) == (20.0, 1000.0)
    assert np.float32(c.m_eps) == np.float32(1e-5)
    assert c.w0 > 0
    with pytest.raises(ValueError, match="mode"):
        cuda_dfsph.divergence(None, part, part.v, None, None, "bad", params)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_pairs._check_common(None, part, params)
    # the CUDA engine's form without the kick (PCISPH's) is the kernel's
    # un-kicked variant, whose wrapper takes the plain version on CPU
    # tensors and counts no launch
    p, nl, _ = tbase.bin_and_sort(part, params, GatherEngine(params))
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(p.x, p.material, params.grid_size,
                               params.grid_num), params.num_cells)
    before = dict(cuda_dfsph.LAUNCHES)
    got = tbase.compute_non_pressure_forces(p, starts,
                                            cuda_pairs.CudaEngine(params),
                                            params)
    assert cuda_dfsph.LAUNCHES == before
    assert torch.equal(got.acc,
                       cuda_dfsph.nonpressure_accel_plain(nl, p, params))
    assert torch.equal(got.v, p.v)
