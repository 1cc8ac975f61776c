"""DFSPH, IISPH and PCISPH under the port's slot engine (``--backend
pallas_slots``) against the JAX package, on the CPU.

One step of each solver under the slot backend (the plain slot engine,
ops/slots.py) must match the JAX package's gather engine from the same
state at the engine-equivalence tolerance (atol 2e-5, rtol 2e-4), with the
same iteration counts.  Without an overflowing cell, two steps under the
slot backend must equal the default backend's bit for bit (the same pairs
in the same order).  Each DFSPH, IISPH and PCISPH kernel wrapper given a
``SlotMap`` of CPU tensors must return exactly its plain version over the
slot neighbour lists, with no launch counted, also where a 40-particle
cell overflows the map's 8 x 4 slots and the slot lists drop pairs.

Scenes (tests/conftest.py small_scene_dict): DFSPH's floor impact at dt
4e-3 (its second step: the divergence solve runs 4 iterations, the
fullest cell holds 16); IISPH's fluid block falling onto a static rigid at
dt 1e-3 (its eighth step: 2 iterations, the solid mirror); PCISPH's block
from the floor's padding line up at dt 4e-3 (its fourth step: 4
iterations).  The DFSPH floor impact packs 36 particles into a cell from
its third step, past the slot map's capacity, and PCISPH does not converge
on it (tests/test_torch_pcisph.py).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import sph_taichi_tpu as J
import sph_taichi_torch as T
from sph_taichi_torch import convert
from sph_taichi_torch.models import base as tbase
from sph_taichi_torch.ops import cuda_dfsph, cuda_iisph, cuda_pcisph
from sph_taichi_torch.ops import slots as tslots
from sph_taichi_torch.ops.pairs import GatherEngine

from conftest import _clumped_positions, small_scene_dict
from test_golden import _two_way_scene

ATOL, RTOL = 2e-5, 2e-4
METHODS = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dfsph_floor_impact():
    d = small_scene_dict(method=4, block=((0.1, 0.03, 0.1), (0.5, 0.6, 0.5)),
                         velocity=(0.0, -2.0, 0.0), dt=4e-3)
    d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


def _iisph_rigid_impact():
    d = small_scene_dict(method=2, block=((0.1, 0.27, 0.1), (0.5, 0.6, 0.5)),
                         velocity=(0.0, -2.0, 0.0), dt=1e-3)
    d["RigidBlocks"] = [{
        "objectId": 1, "start": [0.1, 0.1, 0.1], "end": [0.5, 0.25, 0.5],
        "translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
        "velocity": [0.0, 0.0, 0.0], "density": 1000.0,
        "color": [100, 100, 100], "isDynamic": False}]
    d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


def _pcisph_impact():
    d = small_scene_dict(method=1, block=((0.1, 0.1, 0.1), (0.5, 0.6, 0.5)),
                         velocity=(0.0, -2.0, 0.0), dt=4e-3)
    d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


# method: (scene, the step compared, the fields compared, iteration keys)
CASES = {
    4: (_dfsph_floor_impact, 1,
        ("x", "v", "acc", "density", "density_adv", "dfsph_factor"),
        ("divergence_iters", "pressure_iters")),
    2: (_iisph_rigid_impact, 7, ("x", "v", "acc", "density", "pressure"),
        ("pressure_iters",)),
    1: (_pcisph_impact, 3, ("x", "v", "acc", "density", "pressure"),
        ("pressure_iters",)),
}


def _np_state(s):
    return ({k: np.asarray(v) for k, v in s.p._asdict().items()
             if v is not None},
            np.asarray(s.rigid_rest_cm), np.asarray(s.dt), np.asarray(s.t),
            np.asarray(s.step_count))


def _slot_params(method, backend="pallas_slots"):
    params = T.build_scene(T.SimConfig(config_dict=CASES[method][0]()),
                           device="cpu")[0]
    return dataclasses.replace(params, backend=backend)


@pytest.fixture(scope="module")
def jax_runs():
    """{method: (JAX states after 0..start + 1 steps, JAX metrics)}, each
    solver's step compiled once (the gather engine, JAX's plain path)."""
    runs = {}
    for method, (scene, start, _, _) in CASES.items():
        jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=scene()))
        solver = J.build_solver(jp)
        state = solver.initialize(jpart)
        states, metrics = [_np_state(state)], []
        for _ in range(start + 1):
            state, m = solver.step(state)
            states.append(_np_state(state))
            metrics.append({k: np.asarray(v) for k, v in m.items()
                            if k != "rigid"})
        runs[method] = (states, metrics)
    return runs


@pytest.mark.parametrize("method", METHODS)
def test_slot_step_matches_jax_gather(jax_runs, method):
    """One step under the slot backend from the JAX state, index by index
    against the JAX gather engine's step, with equal iteration counts."""
    _, start, fields, iters = CASES[method]
    states, metrics = jax_runs[method]
    solver = T.build_solver(_slot_params(method), device="cpu")
    assert isinstance(solver.engine, tslots.SlotGatherEngine)
    ts, tm = solver.step(convert.state_from_numpy(*states[start], "cpu"))
    assert not bool(tm["slot_overflow"])
    ref, jm = states[start + 1][0], metrics[start]
    real = ref["material"] != -1
    got = convert.particles_to_numpy(ts.p)
    np.testing.assert_array_equal(got["material"], ref["material"])
    for name in fields:
        np.testing.assert_allclose(got[name][real], ref[name][real],
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    for k in iters:
        assert int(tm[k]) == int(jm[k]), k
    # the step iterates
    assert max(int(jm[k]) for k in iters) > 1


@pytest.mark.parametrize("method", METHODS)
def test_slot_steps_equal_default_backend_bitwise(method):
    """Two steps from the scene's start under the slot backend equal the
    default backend's bit for bit while no cell overflows."""
    params, part, _ = T.build_scene(
        T.SimConfig(config_dict=CASES[method][0]()), device="cpu")
    runs = []
    for backend in ("auto", "pallas_slots"):
        solver = T.build_solver(dataclasses.replace(params, backend=backend),
                                device="cpu")
        s = solver.initialize(part)
        metrics = []
        for _ in range(2):
            s, m = solver.step(s)
            metrics.append(m)
        runs.append((s, metrics))
    (cs, cm), (ss, sm) = runs
    assert not any(bool(m["slot_overflow"]) for m in sm)
    for name, a in cs.p._asdict().items():
        if a is not None:
            assert torch.equal(a, getattr(ss.p, name)), name
    for k in CASES[method][3]:
        assert [int(m[k]) for m in cm] == [int(m[k]) for m in sm], k


@functools.lru_cache(maxsize=None)
def _clump(kind):
    """Sorted particles of the two-way scene (a dynamic rigid block) at
    clumped positions with random velocities, Akinci volumes and densities
    from the plain engine, and their slot map: "layers" has a 20-particle
    cell (three of the four layers), "overflow" also a 40-particle cell."""
    cfg = T.SimConfig(config_dict=_two_way_scene())
    params, part, _ = T.build_scene(cfg, device="cpu")
    params = dataclasses.replace(params, neighbor_cap=256, cell_cap=64)
    rng = np.random.default_rng(0)
    x = _clumped_positions(rng, params, part)
    if kind == "overflow":
        c0 = np.array([6, 6, 6]) * params.grid_size \
            + 0.05 * params.grid_size
        x[40:80] = (c0 + rng.uniform(0, 0.9 * params.grid_size,
                                     (40, 3))).astype(np.float32)
    n = params.n_fluid + params.n_solid
    v = np.zeros_like(x)
    v[:n] = rng.uniform(-1.0, 1.0, (n, 3))
    part = part._replace(x=torch.from_numpy(x), v=torch.from_numpy(v))
    engine = GatherEngine(params)
    p, nl, _ = tbase.bin_and_sort(part, params, engine)
    p = tbase.compute_static_boundary_volume(p, nl, engine, params)
    p = tbase.compute_moving_boundary_volume(p, nl, engine, params)
    p = tbase.compute_densities(p, nl, engine, params)
    starts = tbase.cell_offsets(
        tbase.compute_cell_ids(p.x, p.material, params.grid_size,
                               params.grid_num), params.num_cells)
    smap = tslots.build_slot_map(starts, params)
    assert bool(smap.diag["slot_overflow"]) == (kind == "overflow")
    return params, p, starts, smap


def _field(p, seed, lo, hi, shape=()):
    """A seeded f32 field on the real rows, 0 on padding."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(lo, hi, (p.n,) + shape)
                         .astype(np.float32))
    real = (p.material >= 0).reshape((-1,) + (1,) * len(shape))
    return torch.where(real, a, 0.0)


def _calls(module, params, p):
    """(name, wrapper, plain version, the arguments after the context) of
    every kernel wrapper of ``module``."""
    dt = torch.tensor(np.float32(4e-3))
    kappa = torch.where(p.material == 1, _field(p, 1, -10.0, 10.0), 0.0)
    acc = _field(p, 2, -5.0, 5.0, (3,))
    pressure = _field(p, 3, 0.0, 2000.0)
    if module is cuda_dfsph:
        d = cuda_dfsph
        return [
            ("density_factor", d.density_factor, d.density_factor_plain,
             (p, params)),
            ("divergence change", d.divergence, d.divergence_plain,
             (p, p.v, None, None, "change", params)),
            ("divergence adv", d.divergence, d.divergence_plain,
             (p, p.v, p.density, dt, "adv", params)),
            ("solver_dv", d.solver_dv, d.solver_dv_plain,
             (p, kappa, p.v, None, dt, False, params)),
            ("solver_dv react", d.solver_dv, d.solver_dv_plain,
             (p, kappa, p.v, acc, dt, True, params)),
            ("nonpressure_kick", d.nonpressure_kick, d.nonpressure_kick_plain,
             (p, dt, params)),
            ("nonpressure_accel", d.nonpressure_accel,
             d.nonpressure_accel_plain, (p, params))]
    if module is cuda_iisph:
        d = cuda_iisph
        q = p._replace(pressure=pressure)
        return [
            ("nonpressure_kick", d.nonpressure_kick, d.nonpressure_kick_plain,
             (p, dt, params)),
            ("predict_advection", d.predict_advection,
             d.predict_advection_plain, (q, dt, params)),
            ("pressure_accel", d.pressure_accel, d.pressure_accel_plain,
             (p, pressure, params)),
            ("pressure_accel advect", d.pressure_accel,
             d.pressure_accel_plain, (p, pressure, params, dt)),
            ("apply_A", d.apply_A, d.apply_A_plain,
             (p, acc, _field(p, 4, -1e-3, -1e-5), _field(p, 5, -5.0, 5.0),
              pressure, dt, 0.5, params))]
    d = cuda_pcisph
    q = p._replace(acc=acc)
    vp = torch.where((p.material == 1)[:, None],
                     _field(p, 6, -10.0, 10.0, (3,)), p.v)
    xp = torch.where((p.material == 1)[:, None], p.x + dt * vp, p.x)
    s_f = torch.tensor(np.float32(0.5))
    return [
        ("d_rho_correct", d.d_rho_correct, d.d_rho_correct_plain,
         (q, xp, vp, pressure, dt, s_f, params)),
        ("pressure_accel_predict", d.pressure_accel_predict,
         d.pressure_accel_predict_plain, (q, xp, pressure, dt, params))]


def _outputs(r):
    return (r,) if torch.is_tensor(r) else tuple(r)


@pytest.mark.parametrize("kind", ["layers", "overflow"])
@pytest.mark.parametrize("module", [cuda_dfsph, cuda_iisph, cuda_pcisph],
                         ids=["dfsph", "iisph", "pcisph"])
def test_wrappers_given_a_slot_map_on_cpu_equal_plain(module, kind):
    """Each wrapper given a ``SlotMap`` of CPU tensors returns exactly its
    plain version over the slot neighbour lists and counts no launch.
    Without an overflow that is also the plain version over the cell-run
    lists; with one, some rows lose pairs."""
    params, p, starts, smap = _clump(kind)
    snl = tslots.slot_neighbor_list(smap, p.x, params)
    cnl = GatherEngine(params).prepare(p.x, starts)
    assert not bool(snl.diag["neighbor_overflow"])
    assert not bool(cnl.diag["neighbor_overflow"])
    assert not bool(cnl.cell_overflow)
    assert torch.equal(snl.cnt, cnl.cnt) == (kind == "layers")
    before = dict(module.LAUNCHES)
    for name, wrapper, plain, args in _calls(module, params, p):
        got = _outputs(wrapper(smap, *args))
        ref = _outputs(plain(snl, *args))
        cell = _outputs(plain(cnl, *args))
        assert len(got) == len(ref)
        for a, b, c in zip(got, ref, cell):
            if b is None:
                assert a is None, name
                continue
            assert torch.equal(a, b), name
            if kind == "layers":
                assert torch.equal(a, c), name
    assert module.LAUNCHES == before


@pytest.mark.parametrize("module", [cuda_dfsph, cuda_iisph, cuda_pcisph],
                         ids=["dfsph", "iisph", "pcisph"])
def test_every_kernel_counts_slot_launches(module):
    names = [k for k in module.LAUNCHES if not k.endswith("[slots]")]
    assert names
    assert sorted(module.LAUNCHES) == sorted(
        names + [k + "[slots]" for k in names])
