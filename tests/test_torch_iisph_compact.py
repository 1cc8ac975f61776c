"""IISPH's step-start pair list and loop terms on the edge scene of the two-phase walk.

Over the cell runs, IISPH's pressure acceleration (``iisph_pressure_accel``,
f3, in the Jacobi loop and with the advect after it) and A
(``iisph_apply_A``, f4) read the step-start pair list that
``iisph_step_pairs`` builds once per step (ops/cuda_iisph.py
``step_pairs``): every real centre's accepted neighbours, solids included,
in the walk's order, at most PAIR_LIST_ENTRIES of them, its count also
beyond; a warp holding a centre over the list walks the cells in one phase
instead.  chip_smoke.py holds the kernels, their padding rows included,
against the plain versions bitwise on the card.  Here, on the CPU, on the
scene of tests/test_torch_dfsph_compact.py as IISPH (a cell of ~100
particles, so centres with more neighbours than the list holds):
- the plain list (``step_pairs_plain``, from the port's GatherEngine
  lists) against the JAX package's gather-engine pairs at the same
  positions for every real centre: the same j per centre in walk order,
  the count, and the mark of a centre over the list;
- ``pressure_accel_plain`` (both variants) and ``apply_A_plain`` against
  the JAX solver's ``_pressure_accel`` (with ``advect``) and ``_apply_A``
  with its Jacobi update at a seeded pressure field, at the engine
  tolerance (atol 2e-5, rtol 2e-4; the acceleration's components relative
  to their row's largest, see ``_close_rows``);
- the wrappers' padding rows on CPU tensors (their plain versions) against
  the JAX package's ``restore_tail``, over the step's context from
  ``step_pairs`` and over the slot map; given bare cell offsets, the
  wrappers refuse.
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
from sph_taichi_torch.ops import cuda_iisph
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.ops.slots import build_slot_map

from test_torch_dfsph_compact import edge_positions, edge_scene
from test_torch_iisph import ATOL, RTOL, _close, _t

K_LIST = cuda_iisph.pair_list.PAIR_LIST_ENTRIES
OMEGA = 0.5


def iisph_edge_scene():
    d = edge_scene()
    d["Configuration"]["simulationMethod"] = 2
    return d


@functools.lru_cache(maxsize=None)
def _case(seed=0):
    """Identical sorted particles in both packages after the densities,
    the kick and the advection prediction, a seeded pressure field, the
    JAX neighbour lists and loop terms at that pressure from one compiled
    program, and the torch inputs: (torch params, particles, cell offsets,
    neighbour lists, inputs, {name: JAX result})."""
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

    @jax.jit
    def refs(part, pressure):
        p, nl, _ = jbase.bin_and_sort(part, jp, solver.engine)
        p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_moving_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_densities(p, nl, solver.engine, jp)
        p = solver.compute_non_pressure(p, nl)
        p, a_ii, source, _ = solver.predict_advection(p, nl, dt)
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
        return {"p": p, "nl_idx": nl.idx, "nl_cnt": nl.cnt, "a_ii": a_ii,
                "source": source, "accel": accel, "adv_v": adv.v,
                "adv_x": adv.x, "new_p": new_p, "err": err}

    pressure = np.where(real, rng.uniform(0.0, 2000.0, real.shape),
                        0.0).astype(np.float32)
    out = jax.device_get(refs(jpart._replace(
        x=jnp.asarray(x), v=jnp.asarray(v, jnp.float32)),
        jnp.asarray(pressure)))
    p = {k: a for k, a in out.pop("p")._asdict().items() if a is not None}
    tp = T.build_scene(T.SimConfig(config_dict=iisph_edge_scene()),
                       device="cpu")[0]
    tpart = convert.particles_from_numpy(p, "cpu")
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(tpart.x, tpart.material, tp.grid_size,
                               tp.grid_num), tp.num_cells)
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    assert not int(tnl.diag["neighbor_overflow"])
    assert not int(tnl.diag["cell_overflow"])
    inputs = {"pressure": _t(pressure), "accel": _t(out["accel"]),
              "a_ii": _t(out["a_ii"]), "source": _t(out["source"]),
              "dt": torch.tensor(np.float32(jp.dt0))}
    return tp, tpart, starts, tnl, inputs, out


def test_step_pairs_plain_matches_jax_pairs():
    """The list holds every real centre's first K_LIST step-start pairs,
    solids' too, in the JAX gather engine's order, its count is the JAX
    count (beyond the list too, the mark of a centre over it), and padding
    rows list none."""
    tp, tpart, _, tnl, _, ref = _case()
    idx, cnt = cuda_iisph.step_pairs_plain(tnl, tpart, tp)
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


CALLS = ["pressure_accel", "pressure_accel_advect", "apply_A"]
REFS = {"pressure_accel": ("accel",), "pressure_accel_advect":
        ("adv_v", "adv_x"), "apply_A": ("new_p", "err")}


@pytest.mark.parametrize("call", CALLS)
def test_loop_term_plain_matches_jax(call):
    """f3 (every real row's acceleration, the solid mirror included; and
    its advect of the fluid rows) and f4 (A with the relaxed-Jacobi update
    and the error column) over the step-start pairs at a seeded pressure,
    against the JAX _pressure_accel, advect and _apply_A."""
    tp, tpart, _, tnl, inp, ref = _case()
    got = _plain(call, tnl, tpart, inp, tp)
    got = (got,) if torch.is_tensor(got) else got
    for a, key in zip(got, REFS[call]):
        (_close_rows if key == "accel" else _close)(a, ref[key], tp, key)
    if call == "pressure_accel":
        solid = tpart.material.numpy() == 0
        assert np.abs(ref["accel"][solid]).max() > 0
    if call == "apply_A":
        real = tpart.material.numpy() >= 0
        assert (ref["new_p"][real] > 0).any()
        assert (ref["new_p"][real] == 0).any()


def _call(call, ctx, p, inp, tp):
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
    """Each f3/f4 wrapper's result on CPU tensors (its plain version) holds
    the padding rows that the JAX package's restore_tail gives (the
    acceleration, p' and the error 0; the advect's v' and x' from v and
    x), given the step's context from ``step_pairs`` or the slot map.  On
    the card the kernels write these rows themselves; chip_smoke.py's IISPH
    edge-scene phase, not this test, holds their whole outputs, padding
    rows included, against the plain versions."""
    tp, tpart, starts, _, inp, _ = _case()
    jp = J.build_scene(J.SimConfig(config_dict=iisph_edge_scene()))[0]
    n_real = tp.n_fluid + tp.n_solid
    assert tp.n_pad > n_real
    v = tpart.v.clone()
    v[n_real:] = torch.arange(3 * (tp.n_pad - n_real),
                              dtype=torch.float32).reshape(-1, 3)
    p = tpart._replace(v=v)
    c = cuda_iisph.step_pairs(
        starts if ctx == "list" else build_slot_map(starts, tp), p, tp)
    before = dict(cuda_iisph.LAUNCHES)
    got = _call(call, c, p, inp, tp)
    assert cuda_iisph.LAUNCHES == before
    got = (got,) if torch.is_tensor(got) else got
    fallbacks = {"pressure_accel": (torch.zeros_like(p.x),),
                 "pressure_accel_advect": (p.v, p.x),
                 "apply_A": (torch.zeros(tp.n_pad), torch.zeros(tp.n_pad))}
    for a, fallback in zip(got, fallbacks[call]):
        restored = np.asarray(jbase.restore_tail(
            jnp.asarray(a.numpy()), jnp.asarray(fallback.numpy()), jp))
        np.testing.assert_array_equal(a.numpy(), restored)
        assert torch.equal(a[n_real:], fallback[n_real:])


@pytest.mark.parametrize("call", CALLS)
def test_wrapper_refuses_bare_cell_offsets(call):
    """Over the cell runs f3 and f4 read the step's context from
    ``step_pairs``: given the bare cell offsets, they raise."""
    tp, tpart, starts, _, inp, _ = _case()
    with pytest.raises(TypeError, match="step_pairs"):
        _call(call, starts, tpart, inp, tp)
