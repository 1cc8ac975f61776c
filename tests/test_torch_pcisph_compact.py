"""PCISPH's step-start pair list and loop terms on the edge scene of the two-phase walk.

Over the cell runs, PCISPH's loop kernels ``pcisph_d_rho_correct`` (g1) and
``pcisph_pressure_accel_predict`` (g2) read the step-start pair list that
``pcisph_step_pairs`` builds once per step (ops/cuda_pcisph.py
``step_pairs``): each fluid centre's accepted neighbours in the walk's
order, at most PAIR_LIST_ENTRIES of them, its count also beyond; a warp
holding a centre over the list walks the cells in one phase instead
(``for_each_neighbor_pinned``).
chip_smoke.py holds the kernels, their padding rows included, against the
plain versions bitwise on the card.  Here, on the CPU, on the scene of
tests/test_torch_dfsph_compact.py as PCISPH (a cell of ~100 particles, so
centres with more neighbours than the list holds):
- the plain list (``step_pairs_plain``, from the port's GatherEngine
  lists) against the JAX package's gather-engine pairs at the same
  positions: the same j per centre in walk order, the count, and the mark
  of a centre over the list;
- ``d_rho_correct_plain`` and ``pressure_accel_predict_plain`` against the
  JAX solver's ``_d_rho`` and ``_pressure_accel`` with its loop's formulas
  at a seeded prediction that moves pairs out of the radius, at the engine
  tolerance (atol 2e-5, rtol 2e-4);
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
from sph_taichi_torch.ops import cuda_pcisph
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.ops.slots import build_slot_map

from test_torch_dfsph_compact import edge_positions, edge_scene
from test_torch_pcisph import _close, _t

K_LIST = cuda_pcisph.PAIR_LIST_ENTRIES


def pcisph_edge_scene():
    d = edge_scene()
    d["Configuration"]["simulationMethod"] = 1
    return d


@functools.lru_cache(maxsize=None)
def _case(seed=0):
    """Identical sorted particles in both packages with densities and the
    non-pressure acceleration, a seeded prediction (v* up to 10 m/s on
    fluid rows, x* = x + dt v*) and pressure field, the JAX neighbour
    lists and terms with the loop's formulas (pcisph.py:228-245) from one
    compiled program, and the torch inputs: (torch params, particles,
    cell offsets, neighbour lists, inputs, {name: JAX result})."""
    rng = np.random.default_rng(seed)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=pcisph_edge_scene()))
    material = np.asarray(jpart.material)
    x = edge_positions(rng, jp, np.asarray(jpart.x), material)
    real = material != -1
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
        p_acc = jnp.where(fluid3, solver._pressure_accel(q, nl, q.x, pr),
                          0.0)
        v_new = jnp.where(fluid3, p.v + dt * (p.acc + p_acc), p.v)
        x_new = jnp.where(fluid3, p.x + dt * v_new, p.x)
        return {"p": p, "nl_idx": nl.idx, "nl_cnt": nl.cnt, "vp": vp,
                "xp": xp, "pr": pr, "rho_err": rho_err, "v_new": v_new,
                "x_new": x_new}

    vp_seed = rng.uniform(-10.0, 10.0, size=x.shape).astype(np.float32)
    pressure = np.where(real, rng.uniform(0.0, 2000.0, real.shape),
                        0.0).astype(np.float32)
    out = jax.device_get(refs(jpart._replace(
        x=jnp.asarray(x), v=jnp.asarray(v, jnp.float32)),
        jnp.asarray(vp_seed), jnp.asarray(pressure)))
    p = {k: a for k, a in out.pop("p")._asdict().items() if a is not None}
    tp = T.build_scene(T.SimConfig(config_dict=pcisph_edge_scene()),
                       device="cpu")[0]
    tpart = convert.particles_from_numpy(p, "cpu")
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(tpart.x, tpart.material, tp.grid_size,
                               tp.grid_num), tp.num_cells)
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    assert not int(tnl.diag["neighbor_overflow"])
    assert not int(tnl.diag["cell_overflow"])
    inputs = {"xp": _t(out["xp"]), "vp": _t(out["vp"]),
              "pressure": _t(pressure),
              "dt": torch.tensor(np.float32(jp.dt0)),
              "s_f": torch.tensor(np.asarray(s_f))}
    return tp, tpart, starts, tnl, inputs, out


def test_step_pairs_plain_matches_jax_pairs():
    """The list holds each fluid centre's first K_LIST step-start pairs in
    the JAX gather engine's order, its count is the JAX count (beyond the
    list too, the mark of a centre over it), and other rows list none."""
    tp, tpart, _, tnl, _, ref = _case()
    idx, cnt = cuda_pcisph.step_pairs_plain(tnl, tpart, tp)
    assert idx.shape == (K_LIST, tp.n_pad) and cnt.shape == (tp.n_pad,)
    fluid = tpart.material.numpy() == 1
    jcnt = np.asarray(ref["nl_cnt"])
    np.testing.assert_array_equal(cnt.numpy(), np.where(fluid, jcnt, 0))
    over = cnt.numpy() > K_LIST
    assert over.sum() > 0 and (fluid & ~over).sum() > 0
    jidx = np.asarray(ref["nl_idx"])
    idx = idx.numpy()
    for i in np.flatnonzero(fluid):
        listed = min(int(jcnt[i]), K_LIST)
        np.testing.assert_array_equal(idx[:listed, i], jidx[i, :listed])
        assert (idx[listed:, i] == -1).all()
    assert (idx[:, ~fluid] == -1).all()


def test_step_pairs_wrapper_on_cpu():
    """On CPU tensors ``step_pairs`` gives the port's neighbour lists of the
    step-start particles (the pairs the plain versions read, and
    ``step_pairs_plain`` lists), counts no launch, and passes a slot map
    through."""
    tp, tpart, starts, tnl, _, _ = _case()
    before = dict(cuda_pcisph.LAUNCHES)
    lists = cuda_pcisph.step_pairs(starts, tpart, tp)
    assert isinstance(lists, NeighborList)
    assert torch.equal(lists.idx, tnl.idx)
    assert torch.equal(lists.cnt, tnl.cnt)
    smap = build_slot_map(starts, tp)
    assert cuda_pcisph.step_pairs(smap, tpart, tp) is smap
    assert cuda_pcisph.LAUNCHES == before


def test_d_rho_correct_plain_matches_jax():
    """g1 at (x*, v*) over the step-start pairs, with the correction,
    against the JAX _d_rho and the loop's formulas."""
    tp, tpart, _, tnl, inp, ref = _case()
    got = cuda_pcisph.d_rho_correct_plain(
        tnl, tpart, inp["xp"], inp["vp"], inp["pressure"], inp["dt"],
        inp["s_f"], tp)
    _close(got[0], ref["pr"], tp, "pressure")
    _close(got[1], ref["rho_err"], tp, "rho_err")
    fluid = tpart.material.numpy() == 1
    assert (ref["rho_err"][fluid] > 0).any()
    assert (ref["rho_err"][fluid] == 0).any()


def test_pressure_accel_predict_plain_matches_jax():
    """g2 at x* over the step-start pairs (the solid mirror included),
    with the predict, against the JAX _pressure_accel and the loop's
    formulas; the prediction moves pairs out of the radius."""
    tp, tpart, _, tnl, inp, ref = _case()
    xp = inp["xp"]
    valid = tnl.mask()
    d2 = ((xp[:, None, :] - xp[tnl.idx]) ** 2).sum(-1)
    assert int((valid & (d2 >= tp.support_radius ** 2)).sum()) > 10
    got = cuda_pcisph.pressure_accel_predict_plain(
        tnl, tpart, xp, _t(ref["pr"]), inp["dt"], tp)
    _close(got[0], ref["v_new"], tp, "v*")
    _close(got[1], ref["x_new"], tp, "x*")


def _call(call, ctx, p, inp, tp):
    if call == "d_rho_correct":
        return cuda_pcisph.d_rho_correct(ctx, p, inp["xp"], inp["vp"],
                                         inp["pressure"], inp["dt"],
                                         inp["s_f"], tp)
    return cuda_pcisph.pressure_accel_predict(ctx, p, inp["xp"],
                                              inp["pressure"], inp["dt"], tp)


@pytest.mark.parametrize("ctx", ["list", "slots"])
@pytest.mark.parametrize("call", ["d_rho_correct", "pressure_accel_predict"])
def test_wrapper_padding_rows(call, ctx):
    """Each loop wrapper's result on CPU tensors (its plain version) holds
    the padding rows that the JAX package's restore_tail gives (p' and
    rho_err 0, v*' and x*' from v and x), given the step's context from
    ``step_pairs`` or the slot map.  On the card the kernels write these rows
    themselves; chip_smoke.py's PCISPH edge-scene phase, not this test,
    holds their whole outputs, padding rows included, against the plain
    versions."""
    tp, tpart, starts, _, inp, _ = _case()
    jp = J.build_scene(J.SimConfig(config_dict=pcisph_edge_scene()))[0]
    n_real = tp.n_fluid + tp.n_solid
    assert tp.n_pad > n_real
    v = tpart.v.clone()
    v[n_real:] = torch.arange(3 * (tp.n_pad - n_real),
                              dtype=torch.float32).reshape(-1, 3)
    p = tpart._replace(v=v)
    c = cuda_pcisph.step_pairs(
        starts if ctx == "list" else build_slot_map(starts, tp), p, tp)
    got = _call(call, c, p, inp, tp)
    fallbacks = ((torch.zeros(tp.n_pad), torch.zeros(tp.n_pad))
                 if call == "d_rho_correct" else (p.v, p.x))
    for a, fallback in zip(got, fallbacks):
        restored = np.asarray(jbase.restore_tail(
            jnp.asarray(a.numpy()), jnp.asarray(fallback.numpy()), jp))
        np.testing.assert_array_equal(a.numpy(), restored)
        assert torch.equal(a[n_real:], fallback[n_real:])


@pytest.mark.parametrize("call", ["d_rho_correct", "pressure_accel_predict"])
def test_wrapper_refuses_bare_cell_offsets(call):
    """Over the cell runs the loop wrappers read the step's context from
    ``step_pairs``: given the bare cell offsets, they raise."""
    tp, tpart, starts, _, inp, _ = _case()
    with pytest.raises(TypeError, match="step_pairs"):
        _call(call, starts, tpart, inp, tp)
