"""PCISPH's step pair list and loop terms on the edge scene of the two-phase walk.

Over the cell runs, PCISPH's loop kernels ``pcisph_d_rho_correct`` (g1) and
``pcisph_pressure_accel_predict`` (g2), and the un-kicked non-pressure
kernel before the loop, read the fluid rows of the step's pair list that
the density kernel writes as it sums at the step-start positions
(ops/cuda_pairs.py ``density_sum_list``, models/base.py
``compute_densities_and_pairs``): every real centre's accepted neighbours
in the walk's order, at most PAIR_LIST_ENTRIES of them, its count also
beyond; a warp holding a centre over the list walks the cells in one phase
instead (``for_each_neighbor_pinned``).
chip_smoke.py holds the kernels, their padding rows included, against the
plain versions bitwise on the card.  Here, on the CPU, on the scene of
tests/test_torch_dfsph_compact.py as PCISPH (a cell of ~100 particles, so
centres with more neighbours than the list holds):
- the plain list (``density_sum_list_plain``, from the port's GatherEngine
  lists) against the JAX package's gather-engine pairs at the same
  positions, for every real centre and so for the fluid centres the loop
  walks: the same j per centre in walk order, the count, and the mark of a
  centre over the list; on CPU tensors ``density_sum_list`` gives the
  plain engine's lists as the step's context;
- ``d_rho_correct_plain`` and ``pressure_accel_predict_plain`` against the
  JAX solver's ``_d_rho`` and ``_pressure_accel`` with its loop's formulas
  at a seeded prediction that moves pairs out of the radius, at the engine
  tolerance (atol 2e-5, rtol 2e-4);
- the wrappers' padding rows on CPU tensors (their plain versions) against
  the JAX package's ``restore_tail``, over the step's context from
  ``density_sum_list`` and over the slot map; given bare cell offsets, the
  wrappers refuse;
- one PCISPH step through ``substep`` on the CUDA engine over CPU tensors
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
from sph_taichi_torch.ops import cuda_dfsph, cuda_pairs, cuda_pcisph
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.models import base as tbase
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.ops.slots import build_slot_map

from test_torch_dfsph_compact import edge_positions, edge_scene
from test_torch_iisph_compact import _step_context, squeezed_positions
from test_torch_pcisph import _close, _t

K_LIST = cuda_pcisph.pair_list.PAIR_LIST_ENTRIES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pcisph_edge_scene():
    d = edge_scene()
    d["Configuration"]["simulationMethod"] = 1
    return d


@functools.lru_cache(maxsize=None)
def _case(seed=0):
    """Identical sorted particles in both packages with densities and the
    non-pressure acceleration, a seeded prediction (v* up to 10 m/s on
    fluid rows, x* = x + dt v*) and pressure field, the JAX neighbour
    lists and terms with the loop's formulas (pcisph.py:228-245) and one
    substep of the scene with the fluid squeezed (``squeezed_positions``)
    from one compiled program, and the torch inputs: (torch params,
    particles, cell offsets, neighbour lists, inputs, {name: JAX result}).
    ``inputs["step_p"]`` and ``inputs["step_starts"]`` are the squeezed
    scene's sorted particles before the densities and their cell
    offsets."""
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
    def refs(part, step_part, vp_seed, pressure):
        step_p, step_nl = prep(step_part)
        step, m = substep(step_p, step_nl)
        p, nl = prep(part)
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
                "x_new": x_new, "step_p": step_p, "step": step,
                "step_iters": m["pressure_iters"]}

    vp_seed = rng.uniform(-10.0, 10.0, size=x.shape).astype(np.float32)
    pressure = np.where(real, rng.uniform(0.0, 2000.0, real.shape),
                        0.0).astype(np.float32)
    part = jpart._replace(v=jnp.asarray(v, jnp.float32))
    out = jax.device_get(refs(
        part._replace(x=jnp.asarray(x)),
        part._replace(x=jnp.asarray(squeezed_positions(
            np.asarray(jpart.x), material))),
        jnp.asarray(vp_seed), jnp.asarray(pressure)))
    tp = T.build_scene(T.SimConfig(config_dict=pcisph_edge_scene()),
                       device="cpu")[0]

    def torch_particles(jax_p):
        return convert.particles_from_numpy(
            {k: a for k, a in jax_p._asdict().items() if a is not None},
            "cpu")

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
    inputs = {"xp": _t(out["xp"]), "vp": _t(out["vp"]),
              "pressure": _t(pressure),
              "dt": torch.tensor(np.float32(jp.dt0)),
              "s_f": torch.tensor(np.asarray(s_f)), "step_p": step_p,
              "step_starts": offsets(step_p)}
    return tp, tpart, starts, tnl, inputs, out



def test_step_pairs_plain_matches_jax_pairs():
    """The step's list (``density_sum_list_plain``'s, whose fluid rows the
    loop and the non-pressure kernel read over the cell runs) holds every
    real centre's first K_LIST step-start pairs in the JAX gather engine's
    order, fluid centres over the list and within it among them; its count
    is the JAX count (beyond the list too, the mark of a centre over it),
    and padding rows list none."""
    tp, tpart, _, tnl, _, ref = _case()
    _, idx, cnt = cuda_pairs.density_sum_list_plain(tnl, tpart, tp)
    assert idx.shape == (K_LIST, tp.n_pad) and cnt.shape == (tp.n_pad,)
    material = tpart.material.numpy()
    real, fluid = material >= 0, material == 1
    jcnt = np.asarray(ref["nl_cnt"])
    np.testing.assert_array_equal(cnt.numpy(), np.where(real, jcnt, 0))
    over = cnt.numpy() > K_LIST
    assert (fluid & over).sum() > 0 and (fluid & ~over).sum() > 0
    jidx = np.asarray(ref["nl_idx"])
    idx = idx.numpy()
    for i in np.flatnonzero(real):
        listed = min(int(jcnt[i]), K_LIST)
        np.testing.assert_array_equal(idx[:listed, i], jidx[i, :listed])
        assert (idx[listed:, i] == -1).all()
    assert (idx[:, ~real] == -1).all()


def test_step_pairs_wrapper_on_cpu():
    """On CPU tensors ``density_sum_list`` gives, as the PCISPH step's
    context, the port's neighbour lists of the step-start particles (the
    pairs the plain versions read, and ``density_sum_list_plain`` lists)
    beside the plain density sums, counts no launch, and passes a slot map
    through; the PCISPH solver's step on the CUDA engine takes the same
    context from ``compute_densities_and_pairs``."""
    tp, tpart, starts, tnl, _, _ = _case()
    before = dict(cuda_pairs.LAUNCHES)
    den, lists = cuda_pairs.density_sum_list(starts, tpart, tp)
    assert isinstance(lists, NeighborList)
    assert torch.equal(lists.idx, tnl.idx)
    assert torch.equal(lists.cnt, tnl.cnt)
    assert torch.equal(den, cuda_pairs.density_sum_list_plain(
        tnl, tpart, tp)[0])
    smap = build_slot_map(starts, tp)
    assert cuda_pairs.density_sum_list(smap, tpart, tp)[1] is smap
    solver = T.build_solver(tp, device="cpu",
                            engine=cuda_pairs.CudaEngine(tp))
    q, ctx = tbase.compute_densities_and_pairs(
        tpart, starts, solver.engine, tp, solver._pair_buffers)
    assert isinstance(ctx, NeighborList) and torch.equal(ctx.idx, tnl.idx)
    assert cuda_pairs.LAUNCHES == before


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
    ``density_sum_list`` or the slot map.  On the card the kernels write these rows
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
    c = (_step_context(starts, p, tp) if ctx == "list"
         else build_slot_map(starts, tp))
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
    ``density_sum_list``: given the bare cell offsets, they raise."""
    tp, tpart, starts, _, inp, _ = _case()
    with pytest.raises(TypeError, match="density_sum_list"):
        _call(call, starts, tpart, inp, tp)


def test_substep_matches_jax(monkeypatch):
    """One PCISPH step of the squeezed scene through ``substep`` on the
    CUDA engine over CPU tensors: the densities come from
    ``density_sum_list`` (the one-phase ``density_sum`` is not called), the
    non-pressure kernel and every loop call take the context it returned,
    nothing is launched, and the state equals the JAX substep's at the
    engine tolerance, with the same number of loop iterations (3)."""
    tp, _, _, _, inp, ref = _case()
    solver = T.build_solver(tp, device="cpu",
                            engine=cuda_pairs.CudaEngine(tp))
    given = []

    def density_sum_list(ctx, p, params, buffers=None):
        den, c = real_list(ctx, p, params, buffers)
        given.append(c)
        return den, c

    def one_phase(*args):
        raise AssertionError("the PCISPH step called the one-phase "
                             "density_sum")

    real_list = cuda_pairs.density_sum_list
    monkeypatch.setattr(cuda_pairs, "density_sum_list", density_sum_list)
    monkeypatch.setattr(cuda_pairs, "density_sum", one_phase)
    calls = {}
    for module, name in ((cuda_dfsph, "nonpressure_accel"),
                         (cuda_pcisph, "d_rho_correct"),
                         (cuda_pcisph, "pressure_accel_predict")):
        calls[name] = 0

        def counted(ctx, *args, _fn=getattr(module, name), _name=name,
                    **kw):
            assert ctx is given[-1], _name
            calls[_name] += 1
            return _fn(ctx, *args, **kw)
        monkeypatch.setattr(module, name, counted)
    before = {**cuda_pcisph.LAUNCHES, **cuda_dfsph.LAUNCHES}
    got, m = solver.substep(inp["step_p"], inp["step_starts"], inp["dt"])
    assert {**cuda_pcisph.LAUNCHES, **cuda_dfsph.LAUNCHES} == before
    assert len(given) == 1
    assert int(m["pressure_iters"]) == int(ref["step_iters"]) == 3
    # the loop runs its kernels k times per read of its test
    loop = solver.check_every * m["pressure_host_reads"]
    assert calls == {"nonpressure_accel": 1, "d_rho_correct": loop,
                     "pressure_accel_predict": loop}, calls
    for name in ("x", "v", "density", "pressure", "acc"):
        _close(getattr(got, name), getattr(ref["step"], name), tp, name)
    assert ref["step"].pressure.max() > 0
