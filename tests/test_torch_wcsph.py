"""The PyTorch port's WCSPH path against the JAX package, on the CPU.

Scene construction must agree bitwise; one step from identical particles
index-wise at the engine-equivalence tolerance (atol 2e-5, rtol 2e-4,
conftest._assert_states_close); five steps against the committed goldens at
test_golden.py's tolerances (x 1e-4, v 1e-3).  The physics invariants are
ports of tests/test_physics.py.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import sph_taichi_tpu as J
import sph_taichi_torch as T
from sph_taichi_torch import convert
from sph_taichi_torch.scene import compute_cube_particle_num

from conftest import small_scene_dict
from test_golden import _two_way_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4
SCENES = {"small": small_scene_dict, "two_way": _two_way_scene}


def _run(scene, n_steps):
    params, particles, _ = T.build_scene(T.SimConfig(config_dict=scene),
                                         device="cpu")
    solver = T.build_solver(params, device="cpu")
    state = solver.initialize(particles)
    metrics = None
    for _ in range(n_steps):
        state, metrics = solver.step(state)
    return params, state, metrics


def _assert_scene_equal(scene, scene_dir="."):
    jp, jpart, jobj = J.build_scene(J.SimConfig(config_dict=scene),
                                    scene_dir=scene_dir)
    tp, tpart, tobj = T.build_scene(T.SimConfig(config_dict=scene),
                                    scene_dir=scene_dir, device="cpu")
    for name, a in tpart._asdict().items():
        b = getattr(jpart, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == {np.dtype(np.float32): torch.float32,
                               np.dtype(np.int32): torch.int32}[
                np.asarray(b).dtype], name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    for f in ("dim", "particle_radius", "density0", "gravity", "dt0",
              "stiffness", "exponent", "simulation_method", "domain_start",
              "domain_end", "n_particles", "n_fluid", "n_solid", "n_pad",
              "num_objects", "rigid_body_ids", "dynamic_rigid_ids",
              "neighbor_cap", "cell_cap", "obj_material", "obj_density0",
              "obj_is_dynamic", "obj_m0", "grid_num", "num_cells"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.obj_m0, "the object tables must be built"
    assert tobj.rigid_body_ids == jobj.rigid_body_ids
    return tp


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_build_scene_matches_jax(scene):
    _assert_scene_equal(SCENES[scene]())


def test_dragon_scene_matches_jax():
    cfg = T.SimConfig("data/scenes/dragon_bath.json")
    fluid = cfg.get_fluid_blocks()[0]
    assert compute_cube_particle_num(fluid["start"], fluid["end"], 0.02,
                                     3) == 423500
    tp = _assert_scene_equal(cfg.config)
    assert (tp.n_fluid, tp.n_pad) == (423500, 442368)
    assert tp.n_particles == 442006


def test_initialize_volumes_match_jax():
    scene = _two_way_scene()
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=scene))
    js = J.build_solver(jp).initialize(jpart)
    _, ts, _ = _run(scene, 0)
    solid = np.asarray(js.p.material) == 0
    assert solid.any()
    np.testing.assert_allclose(ts.p.m_V.numpy(), np.asarray(js.p.m_V),
                               rtol=2e-6)
    np.testing.assert_array_equal(ts.p.x.numpy(), np.asarray(js.p.x))
    np.testing.assert_allclose(ts.rigid_rest_cm.numpy(),
                               np.asarray(js.rigid_rest_cm), atol=1e-6)


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_one_step_matches_jax(scene):
    """One step from identical particles, compared index by index (the
    step starts with a sort of the same positions)."""
    d = SCENES[scene]()
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=d))
    jsolver = J.build_solver(jp)
    js = jsolver.initialize(jpart)
    ts = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in js.p._asdict().items()
         if v is not None},
        np.asarray(js.rigid_rest_cm), np.asarray(js.dt), np.asarray(js.t),
        np.asarray(js.step_count), "cpu")
    tp = T.build_scene(T.SimConfig(config_dict=d), device="cpu")[0]
    js, jm = jsolver.step(js)
    ts, tm = T.build_solver(tp, device="cpu").step(ts)
    real = np.asarray(js.p.material) != -1
    got = convert.particles_to_numpy(ts.p)
    np.testing.assert_array_equal(got["material"], np.asarray(js.p.material))
    for name in ("x", "v", "acc", "density", "pressure", "m_V"):
        np.testing.assert_allclose(
            got[name][real], np.asarray(getattr(js.p, name))[real],
            atol=ATOL, rtol=RTOL, err_msg=name)
    for k in ("max_neighbors", "max_cell_occupancy"):
        assert int(tm[k]) == int(jm[k]), k
    assert not bool(tm["sort_invariant_violated"])
    np.testing.assert_allclose(float(tm["max_velocity"]),
                               float(jm["max_velocity"]), rtol=RTOL)
    if scene == "two_way":
        np.testing.assert_allclose(tm["rigid"]["R"].numpy(),
                                   np.asarray(jm["rigid"]["R"]), atol=1e-6)


def test_golden_method0_5steps():
    ref = np.load("tests/golden/method0_5steps.npz")
    _, state, _ = _run(small_scene_dict(method=0), 5)
    m = state.p.material.numpy() >= 0
    np.testing.assert_allclose(state.p.x.numpy()[m], ref["x"], atol=1e-4)
    np.testing.assert_allclose(state.p.v.numpy()[m], ref["v"], atol=1e-3)


def test_golden_two_way_coupling_5steps():
    """Index-wise order is not comparable here: the rigid lattice sits on
    cell planes, so an ulp of difference in the rigid centre of mass (the
    two packages sum in different orders) moves a rigid particle to the
    neighbouring cell and permutes the sort.  Each golden particle is
    matched to its nearest port particle (a bijection), then compared at
    the golden tolerances."""
    ref = np.load("tests/golden/two_way_5steps.npz")
    _, state, _ = _run(_two_way_scene(), 5)
    m = state.p.material.numpy() >= 0
    x, v = state.p.x.numpy()[m], state.p.v.numpy()[m]
    dist, idx = cKDTree(x).query(ref["x"], k=1)
    assert len(np.unique(idx)) == len(idx), "matching not a bijection"
    assert dist.max() < 1e-4
    np.testing.assert_allclose(v[idx], ref["v"], atol=1e-3)
    rigid = state.p.material.numpy()[m] == 0
    assert np.abs(v[rigid]).max() > 1e-3     # the rigid moved


def test_particles_stay_in_padded_box():
    params, state, _ = _run(small_scene_dict(method=0), 15)
    fluid = state.p.material.numpy() == 1
    x = state.p.x.numpy()[fluid]
    assert np.isfinite(x).all()
    size = np.asarray(params.domain_size)
    assert (x >= params.padding - 1e-5).all()
    assert (x <= size - params.padding + 1e-5).all()


def test_density_clamped_before_eos():
    # WCSPH stores max(rho, rho0) (WCSPH.py:75)
    params, state, _ = _run(small_scene_dict(method=0), 5)
    fluid = state.p.material.numpy() == 1
    assert (state.p.density.numpy()[fluid] >= params.density0 - 1e-3).all()
    assert (state.p.pressure.numpy()[fluid] >= -1e-3).all()


def test_momentum_conservation_of_pair_forces():
    # zero gravity: symmetric pressure + viscosity pairs conserve momentum
    d = small_scene_dict(method=0, velocity=(0.3, 0.0, 0.0))
    d["Configuration"]["gravitation"] = [0.0, 0.0, 0.0]
    params, particles, _ = T.build_scene(T.SimConfig(config_dict=d),
                                         device="cpu")
    solver = T.build_solver(params, device="cpu")
    state = solver.initialize(particles)

    def momentum(p):
        fluid = p.material.numpy() == 1
        return (p.m.numpy()[fluid, None] * p.v.numpy()[fluid]).sum(0)

    mom0 = momentum(state.p)
    for _ in range(5):
        state, _ = solver.step(state)
    np.testing.assert_allclose(momentum(state.p), mom0,
                               atol=5e-4 * max(1.0, abs(mom0).max()))


def test_determinism_bitwise():
    outs = [_run(small_scene_dict(method=0), 5)[1].p.x.numpy()
            for _ in range(2)]
    assert np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("method", [3])
def test_unported_methods_raise(method):
    params, _, _ = T.build_scene(
        T.SimConfig(config_dict=small_scene_dict(method=0)), device="cpu")
    import dataclasses
    params = dataclasses.replace(params, simulation_method=method)
    with pytest.raises(NotImplementedError, match="not been implemented"):
        T.build_solver(params, device="cpu")


def test_simulation_cli_runs_on_cpu(tmp_path):
    import json
    from sph_taichi_torch import run_simulation
    d = small_scene_dict(method=0)
    d["Configuration"]["exportPly"] = True
    scene = tmp_path / "scenes" / "x" / "s.json"
    scene.parent.mkdir(parents=True)
    scene.write_text(json.dumps(d))
    out = tmp_path / "out"
    run_simulation.main(["--scene_file", str(scene), "--max_frames", "2",
                         "--device", "cpu", "--output_dir", str(out)])
    assert (out / "particle_object_0_000000.ply").exists()


def _rigid_scene(velocity=(0.0, 0.0, 0.0)):
    # fluid column right above a dynamic rigid block (test_physics.py)
    d = small_scene_dict(method=0, block=((0.15, 0.45, 0.15),
                                          (0.55, 0.8, 0.55)),
                         velocity=velocity)
    d["RigidBlocks"] = [{
        "objectId": 1,
        "start": [0.35, 0.15, 0.35], "end": [0.6, 0.4, 0.6],
        "translation": [0.0, 0.0, 0.0], "scale": [1, 1, 1],
        "velocity": [0.0, 0.0, 0.0], "density": 800.0,
        "color": [255, 255, 255], "isDynamic": True,
    }]
    return d


def test_rigid_body_shape_preserved():
    # shape matching keeps the rigid's pairwise distances at rest values
    _, state, metrics = _run(_rigid_scene(), 10)
    p = state.p
    rigid = (p.material.numpy() == 0) & (p.object_id.numpy() == 1)
    x, x0 = p.x.numpy()[rigid], p.x0.numpy()[rigid]
    assert x.shape[0] > 0
    idx = np.arange(0, x.shape[0], max(x.shape[0] // 20, 1))
    d_now = np.linalg.norm(x[idx, None] - x[None, idx], axis=-1)
    d_rest = np.linalg.norm(x0[idx, None] - x0[None, idx], axis=-1)
    np.testing.assert_allclose(d_now, d_rest, atol=1e-4)
    r = metrics["rigid"]["R"].numpy()[0]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-4)
    assert abs(np.linalg.det(r) - 1.0) < 1e-4


def test_pressure_reaction_matches_scatter_formula():
    """One pressurized fluid particle next to one dynamic rigid particle:
    the gather-form reaction equals the reference's scatter
    (WCSPH.py:67-68), replayed by hand."""
    from sph_taichi_torch.models.wcsph import WCSPHSolver
    from sph_taichi_torch.ops.kernels import cubic_kernel
    from sph_taichi_torch.state import SimParams, make_particles

    params = SimParams(
        dim=3, particle_radius=0.025, density0=1000.0,
        gravity=(0.0, 0.0, 0.0), dt0=4e-4, stiffness=5e4, exponent=7,
        simulation_method=0, domain_start=(0, 0, 0), domain_end=(1, 1, 1),
        n_particles=2, n_fluid=1, n_solid=1, n_pad=512, num_objects=2,
        rigid_body_ids=(1,), dynamic_rigid_ids=(1,))
    h = params.support_radius
    x_f = np.array([0.5, 0.53, 0.5])
    x_r = np.array([0.5, 0.47, 0.5])
    arrays = dict(
        object_id=np.array([0, 1]), x=np.stack([x_f, x_r]),
        v=np.zeros((2, 3)), density=np.array([1200.0, 1000.0]),
        pressure=np.zeros(2), material=np.array([1, 0]),
        is_dynamic=np.array([1, 1]), color=np.zeros((2, 3)),
        m_V=np.full(2, params.m_V0), m=np.full(2, params.m_V0 * 1000.0))
    solver = WCSPHSolver(params, device="cpu")
    state = solver.initialize(make_particles(arrays, 512, "cpu"))
    state, _ = solver.step(state)
    p = state.p
    rigid = p.material.numpy() == 0
    acc_r = p.acc.numpy()[rigid][0]

    rho0 = 1000.0
    w0 = float(cubic_kernel(torch.zeros(()), h))
    rdist = np.linalg.norm(x_f - x_r)
    w_fr = float(cubic_kernel(torch.tensor(rdist, dtype=torch.float32), h))
    m_v_r = 3.0 / w0      # the only solid neighbour of the rigid is itself
    np.testing.assert_allclose(float(p.m_V.numpy()[rigid][0]), m_v_r,
                               rtol=1e-4)
    rho_f = max(rho0 * (params.m_V0 * w0 + m_v_r * w_fr), rho0)
    pr = 5e4 * ((rho_f / rho0) ** 7 - 1.0)
    # grad W(r) = 6k/h^3 * (-(1 - q)^2) * r / (|r| h) for q > 0.5
    q = rdist / h
    k = 6.0 * 8.0 / np.pi / h ** 3
    gradw = (k * q * (3 * q - 2) if q <= 0.5 else -k * (1 - q) ** 2) \
        * (x_f - x_r) / (rdist * h)
    f_p = -rho0 * m_v_r * (pr / rho_f ** 2 + pr / rho0 ** 2) * gradw
    expected = -f_p * rho0 / 1000.0
    np.testing.assert_allclose(acc_r, expected, rtol=5e-3, atol=1e-5)
