"""PCISPH's loop kernels over the slot walk read the step's pair list.

Under ``--backend pallas_slots`` the WCSPH, IISPH and PCISPH steps'
density kernel keeps its one-phase walk over the slot map and writes every
real centre's accepted neighbours, in the walk's order, to the step's pair
list (ops/cuda_pairs.py ``density_sum_list`` given a ``SlotMap`` returns a
``PairList`` over it); PCISPH's loop keeps the step-start pair set, so
``d_rho_correct`` (g1) and ``pressure_accel_predict`` (g2) run only their
pair body over that list every iteration, a warp over the list walking the
slot map in one phase, pinned.  chip_smoke.py holds the kernels against
their plain versions bitwise on the card.  Here, on the CPU:
- the two loop wrappers given that context on CPU tensors equal to their
  plain versions over the slot lists bitwise, padding rows included
  (padding velocities and pressures not 0; p' and rho_err 0 there, v*'
  and x*' the step-start v and x), launching nothing, and equal to the JAX
  package's ``_d_rho`` with the loop's correction and ``_pressure_accel``
  with its predict where no cell overflows, from the same numpy-seeded
  x*, v* and pressure;
- ``density_sum_list`` on CPU tensors given a ``SlotMap``: the plain sums
  over the slot lists, bitwise, and the map, launching nothing;
- the context check of the kernels that read the step's list over both
  walks (``pair_list.list_walk``: PCISPH's loop, WCSPH's forces with and
  without the reaction, IISPH's four kernels, the non-pressure kernel
  kicked and un-kicked) refusing a bare ``SlotMap`` and bare cell offsets,
  naming the call that makes the context, in each wrapper;
- one slot-backend PCISPH, IISPH and DFSPH step through ``substep``, the
  list readers given the step's slot list, equal bitwise to the cell-run
  step, with the same iterations.
Scenes: the clumped two-way scene as PCISPH ("layers": a 20-particle
cell, three of the four layers; "overflow": also a 40-particle cell past
the map's 8 x 4 slots), the edge scene of tests/test_torch_dfsph_compact.py
as PCISPH ("edge": its ~100-particle cell overflows the map) and its
"corner" form (the clump on a corner of 8 cells: no overflow, fluid
centres with more accepted pairs than the list holds); the step runs the
edge scene with its block squeezed to 0.95 and not clumped, as the PCISPH
and IISPH substep tests do (on the clumped scene PCISPH's loop runs to its
cap and IISPH diverges in both packages).  Tolerance against JAX: atol 2e-5, rtol 2e-4 (the
engine-equivalence tolerance of tests/conftest.py).
"""

import dataclasses
import functools
import re

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
from sph_taichi_torch.models.pcisph import PCISPHSolver
from sph_taichi_torch.models.wcsph import WCSPHSolver
from sph_taichi_torch.ops import (
    cuda_dfsph, cuda_iisph, cuda_pairs, cuda_pcisph)
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops import pair_list
from sph_taichi_torch.ops import slots as tslots
from sph_taichi_torch.ops.pairs import GatherEngine

from conftest import _clumped_positions
from test_golden import _two_way_scene
from test_torch_dfsph_compact import edge_positions
from test_torch_dfsph_slot_list import corner_positions
from test_torch_iisph_compact import squeezed_positions
from test_torch_pcisph_compact import pcisph_edge_scene
from test_torch_slot_solvers import _clump


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4
K_LIST = pair_list.PAIR_LIST_ENTRIES
KINDS = ["layers", "overflow", "edge", "corner"]
CALLS = ["d_rho_correct", "pressure_accel_predict"]
# the scenes where no cell overflows the slot map: held against JAX
JAX_KINDS = ("layers", "corner")


def _scene(kind):
    if kind == "layers":
        d = _two_way_scene(method=1)
        d["TPU"] = {"cellCap": 64, "neighborCap": 256}
        return d
    return pcisph_edge_scene()


def _place(kind, rng, params, part):
    x, material = np.asarray(part.x), np.asarray(part.material)
    if kind == "layers":
        return _clumped_positions(rng, params, part)
    place = corner_positions if kind == "corner" else edge_positions
    return place(rng, params, x, material)


def _seeded(rng, x, material):
    """The loop's seeded inputs on the rows' order: v* up to 10 m/s (the
    fluid rows take it; x* = x + dt v* there) and a pressure field on the
    real rows (numpy, f32)."""
    vp = rng.uniform(-10.0, 10.0, size=x.shape).astype(np.float32)
    real = material != -1
    pressure = np.where(real, rng.uniform(0.0, 2000.0, real.shape),
                        0.0).astype(np.float32)
    return vp, pressure


@functools.lru_cache(maxsize=None)
def _jax_case(kind):
    """Scene ``kind`` ("layers" or "corner") in both packages: sorted by
    the JAX package, with Akinci volumes, densities and the non-pressure
    acceleration, and from one compiled JAX program the loop's terms at a
    seeded prediction and pressure with its formulas (pcisph.py:228-245;
    g2 at the seeded pressure):
    (torch params, sorted particles, inputs, {name: JAX result})."""
    rng = np.random.default_rng(0)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=_scene(kind)))
    x = _place(kind, rng, jp, jpart)
    material = np.asarray(jpart.material)
    real = material != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    solver = J.build_solver(jp)
    dt = jnp.float32(jp.dt0)
    s_f = 1.0 / jnp.maximum(2.0 * (dt * jp.m_V0) ** 2 * solver.s_f_base,
                            1e-6)
    rho0 = jp.density0
    vp_seed, pressure = _seeded(rng, x, material)

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
        # g2 at the seeded pressure, as the wrappers are called here
        p_acc = jnp.where(fluid3,
                          solver._pressure_accel(q, nl, q.x, pressure), 0.0)
        v_new = jnp.where(fluid3, p.v + dt * (p.acc + p_acc), p.v)
        x_new = jnp.where(fluid3, p.x + dt * v_new, p.x)
        return {"p": p, "vp": vp, "xp": xp, "pr": pr, "rho_err": rho_err,
                "v_new": v_new, "x_new": x_new}

    out = jax.device_get(refs(
        jpart._replace(x=jnp.asarray(x), v=jnp.asarray(v, jnp.float32)),
        jnp.asarray(vp_seed), jnp.asarray(pressure)))
    p = {k: a for k, a in out.pop("p")._asdict().items() if a is not None}
    tp = T.build_scene(T.SimConfig(config_dict=_scene(kind)),
                       device="cpu")[0]
    inputs = {"xp": torch.tensor(out["xp"]), "vp": torch.tensor(out["vp"]),
              "pressure": torch.tensor(pressure),
              "dt": torch.tensor(np.float32(jp.dt0)),
              "s_f": torch.tensor(np.asarray(s_f))}
    return tp, convert.particles_from_numpy(p, "cpu"), inputs, out


@functools.lru_cache(maxsize=None)
def _torch_case(kind):
    """Scene ``kind`` ("overflow" or "edge") sorted by the port's plain
    engine, with Akinci volumes, densities and the non-pressure
    acceleration, and the loop's seeded inputs: (params, particles,
    inputs)."""
    if kind == "overflow":
        params, p = _clump(kind)[:2]
    else:
        params, part, _ = T.build_scene(
            T.SimConfig(config_dict=_scene(kind)), device="cpu")
        rng = np.random.default_rng(0)
        x = _place(kind, rng, params, part)
        material = part.material.numpy()
        v = np.zeros_like(x)
        real = material != -1
        v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
        part = part._replace(x=torch.from_numpy(x), v=torch.from_numpy(v))
        engine = GatherEngine(params)
        p, nl, _ = tbase.bin_and_sort(part, params, engine)
        p = tbase.compute_static_boundary_volume(p, nl, engine, params)
        p = tbase.compute_moving_boundary_volume(p, nl, engine, params)
        p = tbase.compute_densities(p, nl, engine, params)
    caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
    p = p._replace(acc=cuda_dfsph.nonpressure_accel_plain(
        GatherEngine(caps).prepare(p.x, _starts(p, params)), p, params))
    rng = np.random.default_rng(4)
    dt = np.float32(params.dt0)
    vp_seed, pressure = _seeded(rng, p.x.numpy(), p.material.numpy())
    fluid = (p.material == 1)[:, None]
    dt_t = torch.tensor(dt)
    vp = torch.where(fluid, torch.from_numpy(vp_seed), p.v)
    solver = PCISPHSolver(params, device="cpu")
    return params, p, {"xp": torch.where(fluid, p.x + dt_t * vp, p.x),
                       "vp": vp, "pressure": torch.from_numpy(pressure),
                       "dt": dt_t, "s_f": solver.scaling_factor(dt_t)}


def _starts(p, params):
    return tgrid.cell_offsets(
        tgrid.compute_cell_ids(p.x, p.material, params.grid_size,
                               params.grid_num), params.num_cells)


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(params with the lists' caps raised, sorted particles, loop inputs,
    slot map, slot lists, the cell-run lists) of scene ``kind``."""
    if kind in JAX_KINDS:
        params, p, inputs, _ = _jax_case(kind)
    else:
        params, p, inputs = _torch_case(kind)
    caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
    starts = _starts(p, params)
    smap = tslots.build_slot_map(starts, params)
    snl = tslots.slot_neighbor_list(smap, p.x, caps)
    full = GatherEngine(caps).prepare(p.x, starts)
    assert not int(snl.diag["neighbor_overflow"])
    assert not int(full.diag["neighbor_overflow"])
    assert not int(full.diag["cell_overflow"])
    assert bool(smap.diag["slot_overflow"]) == (kind not in JAX_KINDS)
    assert int(smap.diag["max_layers_used"]) >= 3
    return caps, p, inputs, smap, snl, full


def _slot_context(kind):
    """The step's context over the slot walk, as ``density_sum_list``
    gives it on the card: a ``PairList`` whose walk is the slot map, its
    list from the plain version (every real centre)."""
    params, p, _, smap, snl, _ = _case(kind)
    _, idx, cnt = cuda_pairs.density_sum_list_plain(snl, p, params)
    return pair_list.PairList(smap, idx, cnt)


def _padded(p, params, inputs):
    """``p`` and the loop inputs with padding velocities (step-start and
    predicted) and pressures that are not 0."""
    n_real = params.n_fluid + params.n_solid
    assert p.n > n_real
    pad = torch.arange(3 * (p.n - n_real), dtype=torch.float32)
    v, vp, pressure = (p.v.clone(), inputs["vp"].clone(),
                       inputs["pressure"].clone())
    v[n_real:] = pad.reshape(-1, 3)
    vp[n_real:] = -pad.reshape(-1, 3)
    pressure[n_real:] = 100.0 + pad[:p.n - n_real]
    return p._replace(v=v), dict(inputs, vp=vp, pressure=pressure)


def _loop_call(call, p, inp, params):
    """(wrapper, plain version, arguments after the context, the padding
    rows' expected outputs) of a loop call."""
    n_real = params.n_fluid + params.n_solid
    if call == "d_rho_correct":
        zero = torch.zeros(p.n - n_real)
        return (cuda_pcisph.d_rho_correct, cuda_pcisph.d_rho_correct_plain,
                (p, inp["xp"], inp["vp"], inp["pressure"], inp["dt"],
                 inp["s_f"], params), (zero, zero))
    return (cuda_pcisph.pressure_accel_predict,
            cuda_pcisph.pressure_accel_predict_plain,
            (p, inp["xp"], inp["pressure"], inp["dt"], params),
            (p.v[n_real:], p.x[n_real:]))


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("kind", KINDS)
def test_loop_wrappers_over_the_slot_list_equal_plain(kind, call):
    """Each loop wrapper given the step's slot context on CPU tensors
    returns exactly its plain version over the slot lists, whole outputs,
    the padding rows what the JAX package's restore_tail gives them (p' and
    rho_err 0, v*' and x*' from v and x), launching nothing.  Where no cell
    overflows, the real rows match the JAX package's terms."""
    params, p, inputs, _, snl, _ = _case(kind)
    ctx = _slot_context(kind)
    if kind == "corner":
        assert int((ctx.cnt[p.material == 1] > K_LIST).sum()) > 0
    q, inp = _padded(p, params, inputs)
    wrapper, plain, args, expect = _loop_call(call, q, inp, params)
    before = dict(cuda_pcisph.LAUNCHES)
    got = wrapper(ctx, *args)
    assert cuda_pcisph.LAUNCHES == before
    ref = plain(snl, *args)
    n_real = params.n_fluid + params.n_solid
    for a, b, e in zip(got, ref, expect):
        assert torch.equal(a, b)
        assert torch.equal(a[n_real:], e)
    fluid = q.material == 1
    assert float(got[0][fluid].abs().max()) > 0
    if kind not in JAX_KINDS:
        return
    out = _jax_case(kind)[3]
    names = (("pr", "rho_err") if call == "d_rho_correct"
             else ("v_new", "x_new"))
    for a, name in zip(got, names):
        np.testing.assert_allclose(a.numpy()[:n_real],
                                   np.asarray(out[name])[:n_real],
                                   atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_density_sum_list_on_cpu_given_a_slot_map(kind):
    """On CPU tensors ``density_sum_list`` given a ``SlotMap`` returns the
    plain sums over the slot lists bitwise and the map as the step's
    context, launching nothing; where a cell overflows the map, the sums
    lose its pairs past the slots."""
    params, p, _, smap, snl, full = _case(kind)
    before = dict(cuda_pairs.LAUNCHES)
    den, ctx = cuda_pairs.density_sum_list(smap, p, params)
    assert cuda_pairs.LAUNCHES == before
    assert ctx is smap
    assert torch.equal(den, cuda_pairs.density_sum_plain(
        snl, p.x, p.material, p.m_V, params))
    cell = cuda_pairs.density_sum_plain(full, p.x, p.material, p.m_V, params)
    assert torch.equal(den, cell) == (kind in JAX_KINDS)


# The wrappers that read the step's list over both walks, by the name their
# context check gives them: (the call that makes their context, their calls)
LIST_READERS = {
    "PCISPH": ("density_sum_list", CALLS),
    "wcsph_forces": ("density_sum_list", ("b", "b_react")),
    "iisph_nonpressure_kick": ("density_sum_list", ("f1",)),
    "iisph_predict_advection": ("density_sum_list", ("f2",)),
    "iisph_pressure_accel": ("density_sum_list", ("f3", "f3_advect")),
    "iisph_apply_A": ("density_sum_list", ("f4",)),
    "nonpressure_kick": (
        "density_factor_list (DFSPH) or density_sum_list (PCISPH)",
        ("d_kick", "d_accel")),
}


def _outputs(r):
    return (r,) if torch.is_tensor(r) else tuple(r)


# IISPH's relaxation factor (models/iisph.py)
OMEGA = 0.5


def iisph_loop_inputs(p, snl, inp, params):
    """``inp`` with f4's inputs besides the pressure, from the plain
    versions over the lists ``snl``: the acceleration of f3 at
    ``inp["pressure"]`` (``accel``), and f2's a_ii and source."""
    a_ii, source, _ = cuda_iisph.predict_advection_plain(snl, p, inp["dt"],
                                                         params)
    accel = cuda_iisph.pressure_accel_plain(snl, p, inp["pressure"], params)
    return dict(inp, accel=accel, a_ii=a_ii, source=source)


def _list_reader(call, p, inp, params):
    """(wrapper, plain version, arguments after the context) of a wrapper
    of ``LIST_READERS``: WCSPH's forces (b) at the particles' own pressure
    (the solver's density clamp and EOS), with the reaction (b_react, the
    scenes' dynamic rigid block) and without it; IISPH's f2 with the warm
    start from ``inp["pressure"]``, and f4 at the inputs of
    ``iisph_loop_inputs`` with that pressure as the last iterate."""
    if call in CALLS:
        return _loop_call(call, p, inp, params)[:3]
    if call == "f4":
        return (cuda_iisph.apply_A, cuda_iisph.apply_A_plain,
                (p, inp["accel"], inp["a_ii"], inp["source"],
                 inp["pressure"], inp["dt"], OMEGA, params))
    if call in ("b", "b_react"):
        q, dpi, p_r02, m_nc, rr0 = WCSPHSolver(
            params, device="cpu").force_inputs(p)
        assert rr0 is not None
        return (cuda_pairs.wcsph_forces, cuda_pairs.wcsph_forces_plain,
                (q, dpi, p_r02, m_nc, rr0 if call == "b_react" else None,
                 inp["dt"], params))
    return {
        "f1": (cuda_iisph.nonpressure_kick, cuda_iisph.nonpressure_kick_plain,
               (p, inp["dt"], params)),
        "f2": (cuda_iisph.predict_advection,
               cuda_iisph.predict_advection_plain,
               (p._replace(pressure=inp["pressure"]), inp["dt"], params)),
        "f3": (cuda_iisph.pressure_accel, cuda_iisph.pressure_accel_plain,
               (p, inp["pressure"], params)),
        "f3_advect": (cuda_iisph.pressure_accel,
                      cuda_iisph.pressure_accel_plain,
                      (p, inp["pressure"], params, inp["dt"])),
        "d_kick": (cuda_dfsph.nonpressure_kick,
                   cuda_dfsph.nonpressure_kick_plain, (p, inp["dt"], params)),
        "d_accel": (cuda_dfsph.nonpressure_accel,
                    cuda_dfsph.nonpressure_accel_plain, (p, params)),
    }[call]


@pytest.mark.parametrize("solver", list(LIST_READERS))
def test_list_walk_refuses_a_bare_slot_map(solver):
    """On the card the wrappers that read the step's list over both walks
    (PCISPH's loop, WCSPH's forces with and without the reaction, IISPH's
    f1-f4, d kicked and un-kicked) take the ``PairList`` that the
    step's density call gives, over the cell offsets or the slot map, not
    a bare ``SlotMap`` or bare offsets, whose kernels would have no list
    to read: their context check
    (``pair_list.list_walk``) raises TypeError naming that call before any
    device check, in each wrapper given particles off the CPU (the meta
    device stands for the card), and passes the ``PairList`` on to the
    device checks.  On CPU tensors a wrapper given the bare map still runs
    its plain version over the slot lists."""
    source, calls = LIST_READERS[solver]
    params, p, inputs, smap, snl, _ = _case("layers")
    inputs = iisph_loop_inputs(p, snl, inputs, params)
    starts = _starts(p, params)
    slot_ctx = _slot_context("layers")
    lists = (slot_ctx, pair_list.PairList(starts, *slot_ctx[1:]))
    for bare in (smap, starts):
        with pytest.raises(TypeError, match=re.escape(source)):
            pair_list.list_walk(bare, p, params, solver, source)
    for ctx in lists:
        with pytest.raises(ValueError, match="CUDA kernel"):
            pair_list.list_walk(ctx, p, params, solver, source)
    off = p._replace(x=p.x.to("meta"))
    for call in calls:
        wrapper, plain, args = _list_reader(call, p, inputs, params)
        for bare in (smap, starts):
            with pytest.raises(TypeError, match=re.escape(source)):
                wrapper(bare, off, *args[1:])
        for ctx in lists:
            with pytest.raises(ValueError):
                wrapper(ctx, off, *args[1:])
        assert all(torch.equal(a, b) for a, b in zip(
            _outputs(wrapper(smap, *args)), _outputs(plain(snl, *args))))


# simulationMethod -> (the step's density call that writes its list, the
# pair calls after it, the least iterations of each loop on the squeezed
# edge scene)
STEPS = {
    1: ((cuda_pairs, "density_sum_list"),
        ((cuda_dfsph, "nonpressure_accel"), (cuda_pcisph, "d_rho_correct"),
         (cuda_pcisph, "pressure_accel_predict")),
        {"pressure_iters": 3}),
    2: ((cuda_pairs, "density_sum_list"),
        ((cuda_iisph, "nonpressure_kick"), (cuda_iisph, "predict_advection"),
         (cuda_iisph, "pressure_accel"), (cuda_iisph, "apply_A")),
        {"pressure_iters": 1}),
    4: ((cuda_dfsph, "density_factor_list"),
        ((cuda_dfsph, "divergence"), (cuda_dfsph, "solver_dv"),
         (cuda_dfsph, "nonpressure_kick")),
        {"divergence_iters": 1, "pressure_iters": 1}),
}


@pytest.mark.parametrize("method", sorted(STEPS))
def test_slot_step_reads_the_step_list_and_equals_the_cell_run_step(
        monkeypatch, method):
    """One PCISPH (1), IISPH (2) or DFSPH (4) step of the squeezed edge
    scene on the slot engine over CPU tensors, the step's density call
    giving the slot list as on the card (``density_sum_list``, or DFSPH's
    ``density_factor_list``, patched to return a ``PairList`` over the slot
    map from its plain version): ``substep`` hands that context to every
    pair call after it (PCISPH's d and loop, IISPH's f1-f4, DFSPH's solves
    and d), and the step equals the cell-run step bitwise, with the same
    loop iterations."""
    (dmod, dname), readers, least = STEPS[method]
    scene = pcisph_edge_scene()
    scene["Configuration"]["simulationMethod"] = method
    params, part, _ = T.build_scene(T.SimConfig(config_dict=scene),
                                    device="cpu")
    part = part._replace(x=torch.from_numpy(squeezed_positions(
        part.x.numpy(), part.material.numpy())))
    real_list = getattr(dmod, dname)

    def slot_list(ctx, p, prm, buffers=None):
        if not isinstance(ctx, tslots.SlotMap):
            return real_list(ctx, p, prm, buffers)
        snl = tslots.slot_neighbor_list(ctx, p.x, prm)
        if method == 4:
            *out, idx, cnt = cuda_dfsph.density_factor_list_plain(
                snl, p, prm, "jacobi")
        else:
            *out, idx, cnt = cuda_pairs.density_sum_list_plain(snl, p, prm)
        return (*out, pair_list.PairList(ctx, idx, cnt))

    given = {}

    def spy(module, name):
        fn = getattr(module, name)
        key = f"{module.__name__.rsplit('.', 1)[1]}.{name}"

        def call(ctx, *args, **kw):
            given.setdefault(key, set()).add(type(ctx).__name__)
            return fn(ctx, *args, **kw)
        return call

    monkeypatch.setattr(dmod, dname, slot_list)
    for module, name in readers:
        monkeypatch.setattr(module, name, spy(module, name))
    slot = T.build_solver(params, device="cpu",
                          engine=cuda_pairs.CudaSlotEngine(params))
    cell = T.build_solver(params, device="cpu",
                          engine=cuda_pairs.CudaEngine(params))
    state = slot.initialize(part)
    s, sm = slot.step(state)
    assert given == {f"{m.__name__.rsplit('.', 1)[1]}.{name}": {"PairList"}
                     for m, name in readers}
    c, cm = cell.step(state)
    assert not bool(sm["slot_overflow"])
    for k, n in least.items():
        assert int(sm[k]) == int(cm[k]) >= n, k
    for name, a in c.p._asdict().items():
        if a is not None:
            assert torch.equal(a, getattr(s.p, name)), name
