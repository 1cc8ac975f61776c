"""IISPH's step pair list and its four pair kernels on the edge scene of the two-phase walk.

Over the cell runs every pair kernel of the IISPH step after the densities
reads the step's pair list that the density kernel writes as it sums
(ops/cuda_pairs.py ``density_sum_list``, models/base.py
``compute_densities_and_pairs``): every real centre's accepted neighbours,
solids included, in the walk's order, at most PAIR_LIST_ENTRIES of them,
its count also beyond; a warp holding a centre over the list walks the
cells in one phase instead.  The kernels are the non-pressure kick
(``iisph_nonpressure_kick``, f1), the advection prediction
(``iisph_predict_advection``, f2), the pressure acceleration
(``iisph_pressure_accel``, f3, in the Jacobi loop and with the advect after
it) and A (``iisph_apply_A``, f4).  chip_smoke.py holds the kernels, their
padding rows included, against the plain versions bitwise on the card.
Here, on the CPU, on the scene of tests/test_torch_dfsph_compact.py as
IISPH (a cell of ~100 particles, so centres with more neighbours than the
list holds):
- the plain list (``density_sum_list_plain``, from the port's GatherEngine
  lists) against the JAX package's gather-engine pairs at the same
  positions for every real centre: the same j per centre in walk order,
  the count, and the mark of a centre over the list;
- f1-f4's plain versions over the step's context against the JAX solver's
  ``compute_non_pressure`` with its kick, ``predict_advection``,
  ``_pressure_accel`` (with ``advect``) and ``_apply_A`` with its Jacobi
  update at a seeded pressure field, at the engine tolerance (atol 2e-5,
  rtol 2e-4; the pressure acceleration's components relative to their
  row's largest, see ``_close_rows``);
- the wrappers' padding rows on CPU tensors (their plain versions) against
  the JAX package's ``restore_tail``, over the step's context from
  ``density_sum_list`` and over the slot map; given bare cell offsets, the
  wrappers refuse;
- one IISPH step through ``substep`` on the CUDA engine over CPU tensors
  (the wrappers' plain versions), every pair call after the densities
  given the context that ``density_sum_list`` returned, against the JAX
  package's substep.
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
from sph_taichi_torch.ops import cuda_iisph, cuda_pairs
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.ops.slots import build_slot_map

from test_torch_dfsph_compact import edge_positions, edge_scene
from test_torch_iisph import ATOL, RTOL, _close, _t

K_LIST = cuda_iisph.pair_list.PAIR_LIST_ENTRIES
OMEGA = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def iisph_edge_scene():
    d = edge_scene()
    d["Configuration"]["simulationMethod"] = 2
    return d


# The fluid block of the edge scene squeezed about its centroid: a state
# whose pressure solve converges in both packages (on the clump IISPH
# diverges and PCISPH runs to its iteration cap): IISPH's in 1 iteration
# (pressures up to ~1.1e3 Pa), PCISPH's in 3.  (At 0.93 IISPH's runs 3
# iterations to pressures up to ~2e4 Pa, and one pressure of ~10 Pa, a
# small difference of such terms, lands at 1.7x the engine tolerance:
# XLA's summation order against the port's, as tests/test_torch_iisph.py
# records for its floor impact.)
SQUEEZE = 0.95


def squeezed_positions(x, material):
    x = x.copy()
    fluid = material == 1
    centre = x[fluid].mean(axis=0)
    x[fluid] = centre + SQUEEZE * (x[fluid] - centre)
    return x


@functools.lru_cache(maxsize=None)
def _case(seed=0):
    """Identical sorted particles in both packages after the densities,
    the kick and the advection prediction (with a seeded pressure field,
    whose half is the warm start), a seeded loop pressure, the JAX
    neighbour lists, the non-pressure acceleration and the kicked
    velocity, the advection prediction, the loop terms at that pressure
    and one substep from the sorted particles before the densities, from
    one compiled program, and the torch inputs: (torch params, particles,
    cell offsets, neighbour lists, inputs, {name: JAX result}).  The
    particles are those after the prediction (v is v*); ``inputs["v0"]``
    is the velocity before the kick.  Besides, one substep of the scene
    with the fluid squeezed (``squeezed_positions``) from the sorted
    particles before the densities, ``inputs["step_p"]``, and their cell
    offsets, ``inputs["step_starts"]``."""
    rng = np.random.default_rng(seed)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=iisph_edge_scene()))
    material = np.asarray(jpart.material)
    x = edge_positions(rng, jp, np.asarray(jpart.x), material)
    real = material != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    solver = J.build_solver(jp)
    dt = jnp.float32(jp.dt0)
    rho0 = jp.density0

    def sorted_with_volumes(part):
        p, nl, _ = jbase.bin_and_sort(part, jp, solver.engine)
        p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
        return jbase.compute_moving_boundary_volume(p, nl, solver.engine,
                                                    jp), nl

    # jitted apart, so that the program traces and compiles each once
    prep = jax.jit(sorted_with_volumes)

    @jax.jit
    def substep(p, nl):
        return solver.substep(p, nl, dt)

    @jax.jit
    def refs(part, step_part, pressure):
        step_p, step_nl = prep(step_part)
        step, m = substep(step_p, step_nl)
        p, nl = prep(part)
        p = jbase.compute_densities(p, nl, solver.engine, jp)
        v0 = p.v
        p = solver.compute_non_pressure(p, nl)
        p, a_ii, source, last_p = solver.predict_advection(p, nl, dt)
        accel = solver._pressure_accel(p, nl, pressure)
        adv = solver.advect(p, jnp.where(p.is_fluid()[:, None], accel, 0.0),
                            dt)
        ap = solver._apply_A(p, nl, accel) * (dt * dt) * rho0
        realc = p.material >= 0
        new_p = jnp.where(
            jnp.abs(a_ii) > 1e-6,
            jnp.maximum(pressure + OMEGA * (source - ap) / a_ii, 0.0), 0.0)
        new_p = jnp.where(realc, new_p, 0.0)
        err = jnp.where(realc & (new_p != 0.0),
                        jnp.abs(ap - source) / rho0, 0.0)
        return {"p": p, "step_p": step_p, "nl_idx": nl.idx,
                "nl_cnt": nl.cnt,
                "v0": v0, "acc": p.acc, "v_star": p.v, "a_ii": a_ii,
                "source": source, "last_p": last_p, "accel": accel,
                "adv_v": adv.v, "adv_x": adv.x, "new_p": new_p, "err": err,
                "step": step, "step_iters": m["pressure_iters"]}

    pressure = np.where(real, rng.uniform(0.0, 2000.0, real.shape),
                        0.0).astype(np.float32)
    # the state's own pressure field: the warm start is half of it
    p_state = np.where(real, rng.uniform(0.0, 2000.0, real.shape),
                       0.0).astype(np.float32)
    part = jpart._replace(v=jnp.asarray(v, jnp.float32),
                          pressure=jnp.asarray(p_state))
    out = jax.device_get(refs(
        part._replace(x=jnp.asarray(x)),
        part._replace(x=jnp.asarray(squeezed_positions(
            np.asarray(jpart.x), material))), jnp.asarray(pressure)))

    def torch_particles(jax_p):
        return convert.particles_from_numpy(
            {k: a for k, a in jax_p._asdict().items() if a is not None},
            "cpu")
    tp = T.build_scene(T.SimConfig(config_dict=iisph_edge_scene()),
                       device="cpu")[0]
    def offsets(q):
        return tgrid.cell_offsets(
            tgrid.compute_cell_ids(q.x, q.material, tp.grid_size,
                                   tp.grid_num), tp.num_cells)

    tpart = torch_particles(out.pop("p"))
    starts = offsets(tpart)
    step_p = torch_particles(out.pop("step_p"))
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    assert not int(tnl.diag["neighbor_overflow"])
    assert not int(tnl.diag["cell_overflow"])
    inputs = {"pressure": _t(pressure), "accel": _t(out["accel"]),
              "a_ii": _t(out["a_ii"]), "source": _t(out["source"]),
              "dt": torch.tensor(np.float32(jp.dt0)), "v0": _t(out["v0"]),
              "step_p": step_p, "step_starts": offsets(step_p)}
    return tp, tpart, starts, tnl, inputs, out


def _step_context(starts, p, tp):
    """The step's context that the IISPH and PCISPH steps give their pair
    kernels over the cell runs: ``density_sum_list``'s (on CPU tensors,
    the plain engine's neighbour lists)."""
    return cuda_pairs.density_sum_list(starts, p, tp)[1]


def test_step_pairs_plain_matches_jax_pairs():
    """The step's list (``density_sum_list_plain``'s, which the IISPH
    step's pair kernels read over the cell runs) holds every real centre's
    first K_LIST pairs, solids' too, in the JAX gather engine's order, its
    count is the JAX count (beyond the list too, the mark of a centre over
    it), and padding rows list none."""
    tp, tpart, _, tnl, _, ref = _case()
    _, idx, cnt = cuda_pairs.density_sum_list_plain(tnl, tpart, tp)
    assert idx.shape == (K_LIST, tp.n_pad) and cnt.shape == (tp.n_pad,)
    material = tpart.material.numpy()
    real = material >= 0
    jcnt = np.asarray(ref["nl_cnt"])
    np.testing.assert_array_equal(cnt.numpy(), np.where(real, jcnt, 0))
    over = cnt.numpy() > K_LIST
    assert over.sum() > 0 and (real & ~over).sum() > 0
    assert (cnt.numpy()[material == 0] > 0).sum() > 0
    jidx = np.asarray(ref["nl_idx"])
    idx = idx.numpy()
    for i in np.flatnonzero(real):
        listed = min(int(jcnt[i]), K_LIST)
        np.testing.assert_array_equal(idx[:listed, i], jidx[i, :listed])
        assert (idx[listed:, i] == -1).all()
    assert (idx[:, ~real] == -1).all()


def _plain(call, ctx, p, inp, tp):
    if call == "nonpressure_kick":
        return cuda_iisph.nonpressure_kick_plain(
            ctx, p._replace(v=inp["v0"]), inp["dt"], tp)
    if call == "predict_advection":
        return cuda_iisph.predict_advection_plain(ctx, p, inp["dt"], tp)
    if call == "apply_A":
        return cuda_iisph.apply_A_plain(
            ctx, p, inp["accel"], inp["a_ii"], inp["source"],
            inp["pressure"], inp["dt"], OMEGA, tp)
    return cuda_iisph.pressure_accel_plain(
        ctx, p, inp["pressure"], tp,
        advect_dt=inp["dt"] if call == "pressure_accel_advect" else None)


def _close_rows(got, ref, tp, name):
    """A vector field's real rows at the engine tolerance relative to each
    row's largest component: |got - ref| <= atol + rtol max_k |ref_k|.
    The two packages add a centre's pair terms in different orders (the
    port in neighbour order, ops/pairs.py ``sum_in_order``; XLA in its
    own), so a component whose terms cancel to near 0 (a wall particle's
    acceleration across the wall) keeps the rounding of the terms that
    cancelled, a few ulps of the row's scale."""
    n = tp.n_fluid + tp.n_solid
    g = got.numpy()[:n]
    r = np.asarray(ref)[:n]
    bound = ATOL + RTOL * np.abs(r).max(axis=1, keepdims=True)
    bad = np.argwhere(np.abs(g - r) > bound)
    assert bad.size == 0, (f"{name}: {len(bad)} components off, first row "
                           f"{bad[0, 0]}: {g[bad[0, 0]]} vs {r[bad[0, 0]]}")


CALLS = ["nonpressure_kick", "predict_advection", "pressure_accel",
         "pressure_accel_advect", "apply_A"]
REFS = {"nonpressure_kick": ("acc", "v_star"),
        "predict_advection": ("a_ii", "source", "last_p"),
        "pressure_accel": ("accel",), "pressure_accel_advect":
        ("adv_v", "adv_x"), "apply_A": ("new_p", "err")}


@pytest.mark.parametrize("call", CALLS)
def test_loop_term_plain_matches_jax(call):
    """Over the step's context: f1 (gravity and viscosity on every real
    row, the kick of the fluid rows), f2 (a_ii, the source term and the
    warm start), f3 (every real row's acceleration, the solid mirror
    included; and its advect of the fluid rows) and f4 (A with the
    relaxed-Jacobi update and the error column) at a seeded pressure,
    against the JAX compute_non_pressure with its kick,
    predict_advection, _pressure_accel, advect and _apply_A."""
    tp, tpart, starts, _, inp, ref = _case()
    got = _plain(call, _step_context(starts, tpart, tp), tpart, inp, tp)
    got = (got,) if torch.is_tensor(got) else got
    for a, key in zip(got, REFS[call]):
        (_close_rows if key == "accel" else _close)(a, ref[key], tp, key)
    if call == "nonpressure_kick":
        g = np.asarray(tp.gravity, np.float32)
        for mat in (0, 1):
            rows = tpart.material.numpy() == mat
            assert np.abs(ref["acc"][rows] - g).max() > 1e-3, mat
    if call == "predict_advection":
        real = tpart.material.numpy() >= 0
        for key in REFS[call]:
            assert np.abs(ref[key][real]).max() > 0, key
    if call == "pressure_accel":
        solid = tpart.material.numpy() == 0
        assert np.abs(ref["accel"][solid]).max() > 0
    if call == "apply_A":
        real = tpart.material.numpy() >= 0
        assert (ref["new_p"][real] > 0).any()
        assert (ref["new_p"][real] == 0).any()


def _call(call, ctx, p, inp, tp):
    if call == "nonpressure_kick":
        return cuda_iisph.nonpressure_kick(ctx, p, inp["dt"], tp)
    if call == "predict_advection":
        return cuda_iisph.predict_advection(ctx, p, inp["dt"], tp)
    if call == "apply_A":
        return cuda_iisph.apply_A(ctx, p, inp["accel"], inp["a_ii"],
                                  inp["source"], inp["pressure"], inp["dt"],
                                  OMEGA, tp)
    return cuda_iisph.pressure_accel(
        ctx, p, inp["pressure"], tp,
        advect_dt=inp["dt"] if call == "pressure_accel_advect" else None)


@pytest.mark.parametrize("ctx", ["list", "slots"])
@pytest.mark.parametrize("call", CALLS)
def test_wrapper_padding_rows(call, ctx):
    """Each f1-f4 wrapper's result on CPU tensors (its plain version) holds
    the padding rows that the JAX package's restore_tail gives (the
    acceleration, a_ii, the source, the warm start, p' and the error 0;
    f1's v and the advect's v' and x' from v and x, with padding velocities
    that are not 0), given the step's context from ``density_sum_list`` or
    the slot map.  On the card the kernels write these rows themselves,
    over both walks; chip_smoke.py's IISPH edge-scene phase, not this
    test, holds their
    whole outputs, padding rows included, against the plain versions."""
    tp, tpart, starts, _, inp, _ = _case()
    jp = J.build_scene(J.SimConfig(config_dict=iisph_edge_scene()))[0]
    n_real = tp.n_fluid + tp.n_solid
    assert tp.n_pad > n_real
    v = tpart.v.clone()
    v[n_real:] = torch.arange(3 * (tp.n_pad - n_real),
                              dtype=torch.float32).reshape(-1, 3)
    p = tpart._replace(v=v)
    c = (_step_context(starts, p, tp) if ctx == "list"
         else build_slot_map(starts, tp))
    before = dict(cuda_iisph.LAUNCHES)
    got = _call(call, c, p, inp, tp)
    assert cuda_iisph.LAUNCHES == before
    got = (got,) if torch.is_tensor(got) else got
    zeros = torch.zeros(tp.n_pad)
    fallbacks = {"nonpressure_kick": (torch.zeros_like(p.x), p.v),
                 "predict_advection": (zeros, zeros, zeros),
                 "pressure_accel": (torch.zeros_like(p.x),),
                 "pressure_accel_advect": (p.v, p.x),
                 "apply_A": (zeros, zeros)}
    for a, fallback in zip(got, fallbacks[call]):
        restored = np.asarray(jbase.restore_tail(
            jnp.asarray(a.numpy()), jnp.asarray(fallback.numpy()), jp))
        np.testing.assert_array_equal(a.numpy(), restored)
        assert torch.equal(a[n_real:], fallback[n_real:])


@pytest.mark.parametrize("call", CALLS)
def test_wrapper_refuses_bare_cell_offsets(call):
    """Over the cell runs f1-f4 read the step's context from
    ``density_sum_list``: given the bare cell offsets, they raise."""
    tp, tpart, starts, _, inp, _ = _case()
    with pytest.raises(TypeError, match="density_sum_list"):
        _call(call, starts, tpart, inp, tp)


def test_substep_matches_jax(monkeypatch):
    """One IISPH step of the squeezed scene through ``substep`` on the CUDA
    engine over CPU tensors: the densities come from ``density_sum_list``
    (the one-phase ``density_sum`` is not called), every later pair call
    takes the context it returned, nothing is launched, and the state
    equals the JAX substep's at the engine tolerance, with the same number
    of Jacobi iterations."""
    tp, _, _, _, inp, ref = _case()
    solver = T.build_solver(tp, device="cpu",
                            engine=cuda_pairs.CudaEngine(tp))
    given = []

    def density_sum_list(ctx, p, params, buffers=None):
        den, c = real_list(ctx, p, params, buffers)
        given.append(c)
        return den, c

    def one_phase(*args):
        raise AssertionError("the IISPH step called the one-phase "
                             "density_sum")

    def takes_the_list(fn):
        def call(ctx, *args, **kw):
            assert ctx is given[-1], fn.__name__
            return fn(ctx, *args, **kw)
        return call

    real_list = cuda_pairs.density_sum_list
    monkeypatch.setattr(cuda_pairs, "density_sum_list", density_sum_list)
    monkeypatch.setattr(cuda_pairs, "density_sum", one_phase)
    calls = {}
    for name in CALLS[:2] + ["pressure_accel", "apply_A"]:
        fn = getattr(cuda_iisph, name)
        calls[name] = 0

        def counted(ctx, *args, _fn=takes_the_list(fn), _name=name, **kw):
            calls[_name] += 1
            return _fn(ctx, *args, **kw)
        monkeypatch.setattr(cuda_iisph, name, counted)
    before = dict(cuda_iisph.LAUNCHES)
    got, m = solver.substep(inp["step_p"], inp["step_starts"], inp["dt"])
    assert cuda_iisph.LAUNCHES == before
    assert len(given) == 1
    assert int(m["pressure_iters"]) == int(ref["step_iters"])
    # the loop runs its kernels k times per read of its test
    loop = solver.check_every * m["pressure_host_reads"]
    assert calls == {"nonpressure_kick": 1, "predict_advection": 1,
                     "pressure_accel": loop + 1, "apply_A": loop}, calls
    for name in ("x", "v", "density", "pressure", "acc"):
        _close(getattr(got, name), getattr(ref["step"], name), tp, name)
    assert ref["step"].pressure.max() > 0
