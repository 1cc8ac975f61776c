"""The slot walk's readers of the step's pair list: WCSPH's forces (b),
IISPH's four kernels (f1-f4), and the non-pressure kernel (d).

Under ``--backend pallas_slots`` the WCSPH, IISPH and PCISPH steps'
density kernel writes every real centre's accepted neighbours, in the
slot walk's order, to the step's pair list (ops/cuda_pairs.py
``density_sum_list`` given a ``SlotMap`` returns a ``PairList`` over it),
and the DFSPH step's density-and-factor kernel the fluid and
dynamic-rigid centres' (ops/cuda_dfsph.py ``density_factor_list``).  The
positions stay the sort's until the advect, so ``cuda_pairs.wcsph_forces``
(b, with the two-way reaction and without it), ``cuda_iisph.
nonpressure_kick`` (f1), ``cuda_iisph.predict_advection`` (f2),
``cuda_iisph.pressure_accel`` (f3, in the loop and with its advect),
``cuda_iisph.apply_A`` (f4, with the Jacobi update),
``cuda_dfsph.nonpressure_kick`` (d with the DFSPH kick, over e1's list)
and ``cuda_dfsph.nonpressure_accel`` (d without it, PCISPH, over the
density kernel's list) run only their pair body over that list, a warp
over the list walking the slot map in one phase, pinned with xg = x.
chip_smoke.py holds the kernels against their plain versions bitwise on
the card.  Here, on the CPU:
- each wrapper given that context on CPU tensors equal to its plain
  version over the slot lists bitwise, padding rows included (padding
  velocities, densities and pressures, and f4's padding accelerations,
  a_ii and source, not 0; the acceleration, f2's a_ii, source and warm
  start and f4's p' and error 0 there, the forces' and the advect's x and
  v and f1's and d's kicked v the step-start x and v), launching nothing;
- where no cell overflows, each against the JAX package from the same
  numpy-seeded inputs, on the JAX gather engine, which runs the fused
  epilogues unfused: b against WCSPH's ``compute_forces`` with its
  advect and fluid box clamp (the reaction from the scene's dynamic rigid
  block, and without it from the same scene with no dynamic rigid
  listed), f1 against IISPH's ``compute_non_pressure`` with the kick of
  ``predict_advection``, f2 against ``predict_advection`` (its sums and
  epilogue, v* the seeded v) at the seeded pressure, f3 against
  ``_pressure_accel`` without and with its advect (IISPH's ``advect`` of
  the fluid rows' acceleration), f4 against ``_apply_A`` with the Jacobi
  update at JAX's f2 and f3 outputs, the seeded pressure the last
  iterate, d against ``compute_non_pressure_forces`` without and with the
  kick of ``predict_dt`` (DFSPH's ``predict_velocity``).  f3's acceleration is
  held at that tolerance relative to each row's largest component
  (tests/test_torch_iisph_compact.py ``_close_rows``: a wall row's
  cancelling component keeps a few ulps of its terms under XLA's sum
  order).
The context check of these wrappers and of PCISPH's loop
(``pair_list.list_walk``) and one slot step of each solver against its
cell-run step are in tests/test_torch_pcisph_slot_list.py.
Scenes: those of tests/test_torch_pcisph_slot_list.py, itself built on
tests/test_torch_dfsph_slot_list.py's corner form ("layers": the clumped
two-way scene, a 20-particle cell; "overflow": a 40-particle cell past the
map's 8 x 4 slots; "edge": a ~100-particle cell; "corner": the clump on a
corner of 8 cells, no overflow, centres over the list of 64), each with a
dynamic rigid block, whose centres e1's list holds beside the fluid ones.
Tolerance against JAX: atol 2e-5, rtol 2e-4 (the engine-equivalence
tolerance of tests/conftest.py).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sph_taichi_tpu as J
from sph_taichi_tpu.models import base as jbase
from sph_taichi_tpu.models.dfsph import DFSPHSolver as JDFSPHSolver
from sph_taichi_tpu.models.iisph import IISPHSolver as JIISPHSolver
from sph_taichi_tpu.models.wcsph import WCSPHSolver as JWCSPHSolver

from sph_taichi_torch.ops import cuda_dfsph, cuda_iisph, cuda_pairs
from sph_taichi_torch.ops import pair_list

import test_torch_pcisph_slot_list as pcisph_scenes
from test_torch_iisph_compact import _close_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4
K_LIST = pair_list.PAIR_LIST_ENTRIES
KINDS = pcisph_scenes.KINDS
JAX_KINDS = pcisph_scenes.JAX_KINDS
# f3 in the loop and with its advect; d with the DFSPH kick and without it;
# b with the two-way reaction and without it; f1; f2; f4
CALLS = ["f3", "f3_advect", "d_kick", "d_accel", "b", "b_react", "f1", "f2",
         "f4"]
# the calls whose list every real centre walks
REAL_CENTRES = ("f1", "f2", "f3", "f3_advect", "f4")


def _slot_list(call, snl, p, params):
    """(idx, cnt) of the step's slot list that ``call`` reads, from its
    plain version over the slot lists ``snl``: e1's (the fluid and
    dynamic-rigid centres) for kicked d, the density kernel's (every real
    centre) for b, f1-f4 and un-kicked d."""
    if call == "d_kick":
        return cuda_dfsph.density_factor_list_plain(snl, p, params,
                                                    "jacobi")[2:]
    return cuda_pairs.density_sum_list_plain(snl, p, params)[1:]


def _state(call, kind):
    """(params, sorted particles with padding velocities and densities not
    0, the readers' inputs (the pressure, dt and f4's inputs of
    ``iisph_loop_inputs``, their padding rows not 0), slot lists, the
    step's context over the slot map, the rows whose list the reader
    walks)."""
    params, p, inputs, smap, snl, _ = pcisph_scenes._case(kind)
    idx, cnt = _slot_list(call, snl, p, params)
    n_real = params.n_fluid + params.n_solid
    assert p.n > n_real
    pad = torch.arange(3 * (p.n - n_real), dtype=torch.float32)
    v, density = p.v.clone(), p.density.clone()
    v[n_real:] = pad.reshape(-1, 3)
    density[n_real:] = 1000.0 + pad[:p.n - n_real]
    pressure = inputs["pressure"].clone()
    pressure[n_real:] = 100.0 + pad[:p.n - n_real]
    p = p._replace(v=v, density=density)
    inp = pcisph_scenes.iisph_loop_inputs(
        p, snl, {"pressure": pressure,
                 "dt": torch.tensor(np.float32(params.dt0))}, params)
    inp["accel"][n_real:] = -pad.reshape(-1, 3)
    inp["a_ii"][n_real:] = -1.0 - pad[:p.n - n_real]
    inp["source"][n_real:] = 1.0 + pad[:p.n - n_real]
    if call in REAL_CENTRES:
        walks = p.material >= 0
    elif call == "b_react":
        walks = p.is_fluid() | p.is_dynamic_rigid()
    else:
        walks = p.material == 1
    return (params, p, inp, snl, pair_list.PairList(smap, idx, cnt), walks)


def _padding_rows(call, p, params):
    """The padding rows' outputs of a reader, as the JAX package's
    restore_tail gives them: the acceleration, f2's a_ii, source and warm
    start and f4's p' and error 0, the forces' x and v, the advect's v'
    and x' and f1's and d's kicked v the step-start x and v."""
    n_real = params.n_fluid + params.n_solid
    zero = torch.zeros(p.n - n_real, 3)
    zero1 = torch.zeros(p.n - n_real)
    forces = (p.x[n_real:], p.v[n_real:], zero)
    return {"f3": (zero,), "f3_advect": (p.v[n_real:], p.x[n_real:]),
            "d_kick": (zero, p.v[n_real:]), "d_accel": (zero,),
            "b": forces, "b_react": forces,
            "f1": (zero, p.v[n_real:]), "f2": (zero1,) * 3,
            "f4": (zero1,) * 2}[call]


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("kind", KINDS)
def test_readers_over_the_slot_list_equal_plain(kind, call):
    """Each reader given the step's slot context on CPU tensors returns
    exactly its plain version over the slot lists, whole outputs, the
    padding rows what the JAX package's restore_tail gives them, launching
    nothing; in the corner scene centres it walks hold more pairs than the
    list (their warps walk the map on the card)."""
    params, p, inp, snl, ctx, walks = _state(call, kind)
    if kind == "corner":
        assert int((ctx.cnt[walks] > K_LIST).sum()) > 0
    wrapper, plain, args = pcisph_scenes._list_reader(call, p, inp, params)
    expect = _padding_rows(call, p, params)
    modules = (cuda_iisph, cuda_dfsph, cuda_pairs)
    before = tuple(dict(m.LAUNCHES) for m in modules)
    got = pcisph_scenes._outputs(wrapper(ctx, *args))
    assert tuple(m.LAUNCHES for m in modules) == before
    ref = pcisph_scenes._outputs(plain(snl, *args))
    n_real = params.n_fluid + params.n_solid
    assert len(got) == len(ref) == len(expect)
    for a, b, e in zip(got, ref, expect):
        assert torch.equal(a, b)
        assert torch.equal(a[n_real:], e)
    assert float(got[0][:n_real].abs().max()) > 0


@functools.lru_cache(maxsize=None)
def _jax_refs(kind):
    """From one compiled JAX program on the scene ``kind`` ("layers" or
    "corner") at the numpy-seeded state of tests/test_torch_pcisph_slot_
    list.py (the same positions, velocities and pressure), on the JAX
    gather engine: f3 at that pressure without and with its advect (dt0:
    ``_pressure_accel`` then IISPH's ``advect`` of the fluid rows'
    acceleration), d without and with the kick (dt0:
    ``compute_non_pressure_forces`` then DFSPH's ``predict_velocity``, the
    unfused form of ``predict_dt``'s epilogue), b with and without the
    reaction (dt0: WCSPH's ``compute_forces``, ``advect`` and the fluid box
    clamp of ``enforce_boundary``, the unfused form of the force kernel's
    epilogue; without the reaction on the same scene with no dynamic rigid
    listed), f1 (dt0: IISPH's ``compute_non_pressure``, then the fluid
    kick of ``predict_advection``), f2 (dt0: ``predict_advection`` of the
    seeded v as v*, the warm start from the seeded pressure) and f4 (dt0:
    ``_apply_A`` of f3's acceleration with the relaxed-Jacobi update at
    f2's a_ii and source, the seeded pressure the last iterate; its inputs
    are returned as ``f4_inputs``)."""
    rng = np.random.default_rng(0)
    jp, jpart, _ = J.build_scene(
        J.SimConfig(config_dict=pcisph_scenes._scene(kind)))
    x = pcisph_scenes._place(kind, rng, jp, jpart)
    material = np.asarray(jpart.material)
    real = material != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    pressure = pcisph_scenes._seeded(rng, x, material)[1]
    solver = J.build_solver(jp)
    iisph, dfsph = JIISPHSolver(jp), JDFSPHSolver(jp)
    wcsph = {"b_react": JWCSPHSolver(jp), "b": JWCSPHSolver(
        dataclasses.replace(jp, dynamic_rigid_ids=()))}
    assert jp.dynamic_rigid_ids
    dt = jnp.float32(jp.dt0)
    rho0 = jp.density0
    omega = pcisph_scenes.OMEGA
    assert iisph.omega == omega

    def forces(solver, p, nl):
        f = solver.advect(solver.compute_forces(p, nl, dt=None), dt)
        clamped = jbase.enforce_boundary(f, jp, J.state.MATERIAL_FLUID)
        # the velocity before the box clamp, for _close_forces
        return clamped.x, clamped.v, clamped.acc, f.v

    @jax.jit
    def refs(part, pressure):
        p, nl, _ = jbase.bin_and_sort(part, jp, solver.engine)
        p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_moving_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_densities(p, nl, solver.engine, jp)
        f = jbase.compute_non_pressure_forces(p, nl, solver.engine, jp,
                                              solver.g)
        kicked = dfsph.predict_velocity(f, dt)
        accel = iisph._pressure_accel(p, nl, pressure)
        adv = iisph.advect(p, jnp.where(p.is_fluid()[:, None], accel, 0.0),
                           dt)
        f1 = iisph.compute_non_pressure(p, nl)
        f1_kicked = iisph.predict_advection(f1, nl, dt)[0]
        _, a_ii, source, last_p = iisph.predict_advection(
            p._replace(pressure=pressure), nl, dt, vstar_done=True)
        # _apply_A with the relaxed-Jacobi update, as IISPH's loop
        # (models/iisph.py pressure_solve) runs it on the gather engine
        ap = iisph._apply_A(p, nl, accel) * (dt * dt) * rho0
        real = p.material >= 0
        new_p = jnp.where(
            jnp.abs(a_ii) > 1e-6,
            jnp.maximum(pressure + omega * (source - ap) / a_ii, 0.0), 0.0)
        new_p = jnp.where(real, new_p, 0.0)
        err = jnp.where(real & (new_p != 0.0),
                        jnp.abs(ap - source) / rho0, 0.0)
        return {"x": p.x, "f3": accel, "f3_advect": (adv.v, adv.x),
                "d_kick": (f.acc, kicked.v), "d_accel": f.acc,
                **{k: forces(s, p, nl) for k, s in wcsph.items()},
                "f1": (f1.acc, f1_kicked.v), "f2": (a_ii, source, last_p),
                "f4": (new_p, err),
                "f4_inputs": {"accel": accel, "a_ii": a_ii,
                              "source": source}}

    return jax.device_get(refs(
        jpart._replace(x=jnp.asarray(x), v=jnp.asarray(v, jnp.float32)),
        jnp.asarray(pressure)))


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("kind", JAX_KINDS)
def test_readers_over_the_slot_list_match_jax(kind, call):
    """Where no cell overflows the slot map, each reader over the step's
    slot list on CPU tensors matches the JAX package's term on the real
    rows, from the same numpy-seeded state (the scenes of
    tests/test_torch_pcisph_slot_list.py, DFSPH's kick and WCSPH's forces
    on the two-way scene's fluid and dynamic rigid block too)."""
    params, p, inputs, smap, snl, _ = pcisph_scenes._case(kind)
    out = _jax_refs(kind)
    np.testing.assert_array_equal(p.x.numpy(), np.asarray(out["x"]))
    # f4 takes the JAX package's own f2 and f3 outputs
    inputs = dict(inputs, **{k: torch.from_numpy(np.array(a))
                             for k, a in out["f4_inputs"].items()})
    ctx = pair_list.PairList(smap, *_slot_list(call, snl, p, params))
    wrapper, _, args = pcisph_scenes._list_reader(call, p, inputs, params)
    got = pcisph_scenes._outputs(wrapper(ctx, *args))
    want = out[call]
    want = want if isinstance(want, tuple) else (want,)
    n_real = params.n_fluid + params.n_solid
    if call in ("b", "b_react"):
        _close_forces(got, want, params, call)
        return
    assert len(got) == len(want)
    if call == "f3":
        _close_rows(got[0], want[0], params, call)
        return
    if call in ("f2", "f4"):
        real = p.material.numpy() >= 0
        assert all(np.abs(np.asarray(b)[real]).max() > 0 for b in want), call
        if call == "f4":
            # both sides of the Jacobi update's clamp at 0
            assert (want[0][real] > 0).any() and (want[0][real] == 0).any()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy()[:n_real],
                                   np.asarray(b)[:n_real], atol=ATOL,
                                   rtol=RTOL, err_msg=call)


def _close_forces(got, want, params, name):
    """WCSPH's forces (x, v, acc) against the JAX package's (x, v, acc and
    the velocity before the fluid box clamp) on the real rows at the engine
    tolerance, the clamped velocity of a row that the clamp reflected
    relative to that row's largest velocity component before the clamp:
    v - (1 + cf)(v . n) n cancels components of a velocity that the clump's
    pressure drove to ~1e6-1e7 m/s, and keeps a few ulps of them (the two
    packages add a centre's pair terms in different orders)."""
    n = params.n_fluid + params.n_solid
    g = [a.numpy()[:n] for a in got]
    r = [np.asarray(b)[:n] for b in want]
    assert len(g) == 3 and len(r) == 4
    for k in (0, 2):
        np.testing.assert_allclose(g[k], r[k], atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name}: {'x v acc'.split()[k]}")
    reflected = (r[1] != r[3]).any(axis=1, keepdims=True)
    scale = np.where(reflected, np.abs(r[3]).max(axis=1, keepdims=True),
                     np.abs(r[1]))
    bad = np.argwhere(np.abs(g[1] - r[1]) > ATOL + RTOL * scale)
    assert bad.size == 0, (f"{name}: v off in {len(bad)} components, first "
                           f"row {bad[0, 0]}: {g[1][bad[0, 0]]} vs "
                           f"{r[1][bad[0, 0]]}")
    # the clamp reflected some row, and most keep their velocity
    assert 0 < int(reflected.sum()) < n // 2
