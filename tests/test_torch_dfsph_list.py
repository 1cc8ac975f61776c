"""The DFSPH and PCISPH steps' pair list: e1 writes it, d reads it.

On the DFSPH step the positions stay those of the sort from the
density-and-factor kernel (e1) to the non-pressure kernel (d), and both walk
the fluid centres.  So over the cell runs ``density_factor_list``
(ops/cuda_dfsph.py) computes the density and the factor and writes every
fluid centre's accepted neighbours, in the walk's order, to the step's pair
list (ops/pair_list.py ``PairList``: at most PAIR_LIST_ENTRIES per centre,
the count also beyond), and ``nonpressure_kick`` runs its pair body over
that list.  On the PCISPH step ``nonpressure_accel`` reads the fluid rows
of the step's list, which the density kernel writes (ops/cuda_pairs.py
``density_sum_list``).
A warp holding a centre over the list walks the cells in one phase.
chip_smoke.py holds both kernels, their padding rows included, against the
plain versions bitwise on the card.  Here, on the CPU, over the edge scene
of tests/test_torch_dfsph_compact.py (a dynamic rigid block, a cell of ~100
particles, so centres with more neighbours than the list holds) and over a
small scene of a fluid block on a static rigid block:
- ``density_factor_list_plain`` (from the port's GatherEngine lists)
  against the JAX ``density_and_factor`` on every row, and its list
  against the JAX gather engine's pairs for every fluid centre (the same j
  in walk order, the count, the mark of a centre over the list);
- d's plain versions over the step's contexts against the JAX
  ``compute_non_pressure_forces``, kicked (acc, v) and un-kicked (acc);
- the wrappers' padding rows on CPU tensors (their plain versions) against
  the JAX package's ``restore_tail``, over the step's context and over the
  slot map;
- the contexts the DFSPH and PCISPH steps give on each engine, one step of
  each on the CUDA engine over CPU tensors equal to the plain engine's,
  and the refusal of bare cell offsets by d's context check.
Tolerance: atol 2e-5, rtol 2e-4 (the engine-equivalence tolerance of
tests/conftest.py: the two packages sum the same f32 terms in different
orders).
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
from sph_taichi_torch.models import base as tbase
from sph_taichi_torch.ops import cuda_dfsph, cuda_pairs, pair_list
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.ops.slots import build_slot_map

from conftest import small_scene_dict
from test_torch_dfsph_compact import edge_positions, edge_scene
from test_torch_wcsph_list import jittered


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4
K_LIST = pair_list.PAIR_LIST_ENTRIES
SCENES = ["static", "edge"]


def scene_dict(scene, method=4):
    """"edge": the two-phase walk's edge scene; "static": the small fluid
    block resting on a static rigid block; as DFSPH (method 4) or PCISPH
    (method 1), dt 4e-3."""
    if scene == "edge":
        d = edge_scene()
    else:
        d = small_scene_dict(method=4)
        d["RigidBlocks"] = [{
            "objectId": 1, "start": [0.05, 0.1, 0.05],
            "end": [0.55, 0.28, 0.55], "translation": [0.0, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0], "velocity": [0.0, 0.0, 0.0],
            "density": 1000.0, "color": [100, 100, 100],
            "isDynamic": False}]
    d["Configuration"]["simulationMethod"] = method
    return d


@functools.lru_cache(maxsize=None)
def _case(scene):
    """Identical sorted particles in both packages with their Akinci
    volumes and random velocities, the JAX neighbour lists, density and
    factor, and the non-pressure acceleration with and without the kick,
    from one compiled program; and the torch inputs: (torch params,
    particles, cell offsets, neighbour lists, dt, {name: JAX result})."""
    d = scene_dict(scene)
    rng = np.random.default_rng(0)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=d))
    material = np.asarray(jpart.material)
    place = edge_positions if scene == "edge" else jittered
    x = place(rng, jp, np.asarray(jpart.x), material)
    real = material != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    solver = J.build_solver(jp)
    dt = jnp.float32(jp.dt0)

    @jax.jit
    def refs(part):
        p, nl, _ = jbase.bin_and_sort(part, jp, solver.engine)
        p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_moving_boundary_volume(p, nl, solver.engine, jp)
        q = solver.density_and_factor(p, nl)
        f = jbase.compute_non_pressure_forces(q, nl, solver.engine, jp,
                                              solver.g)
        k = solver.predict_velocity(f, dt)
        return {"p": p, "nl_idx": nl.idx, "nl_cnt": nl.cnt,
                "density": q.density, "factor": q.dfsph_factor,
                "acc": f.acc, "v": k.v}

    out = jax.device_get(refs(jpart._replace(
        x=jnp.asarray(x), v=jnp.asarray(v, jnp.float32))))
    p = {k: a for k, a in out.pop("p")._asdict().items() if a is not None}
    tp = T.build_scene(T.SimConfig(config_dict=d), device="cpu")[0]
    tpart = convert.particles_from_numpy(p, "cpu")
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(tpart.x, tpart.material, tp.grid_size,
                               tp.grid_num), tp.num_cells)
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    assert not int(tnl.diag["neighbor_overflow"])
    assert not int(tnl.diag["cell_overflow"])
    return tp, tpart, starts, tnl, torch.tensor(np.float32(jp.dt0)), out


@pytest.fixture(scope="module", params=SCENES)
def case(request):
    return request.param, _case(request.param)


@pytest.fixture(scope="module")
def edge_case():
    return _case("edge")


def _close(got, ref, name, rows=slice(None)):
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows],
                               atol=ATOL, rtol=RTOL, err_msg=name)


@functools.lru_cache(maxsize=None)
def _params(scene, method):
    return T.build_scene(T.SimConfig(config_dict=scene_dict(scene, method)),
                         device="cpu")[0]


def _cuda_solver(scene, method=4):
    """The scene's DFSPH (method 4) or PCISPH (method 1) solver on the CUDA
    engine over CPU tensors: its kernel wrappers take their plain
    versions."""
    params = _params(scene, method)
    return T.build_solver(params, device="cpu",
                          engine=cuda_pairs.CudaEngine(params))


def test_density_factor_and_list_plain_match_jax(case):
    """Density and factor on every row; the list holds every fluid
    centre's first K_LIST pairs in the JAX gather engine's order, its count
    is the JAX count (beyond the list too: the mark of a centre over it),
    other rows list none.  The step's call on the CUDA engine over CPU
    tensors gives the same density and factor and, as its context, the
    plain engine's neighbour lists."""
    scene, (tp, tpart, starts, tnl, _, ref) = case
    density, factor, idx, cnt = cuda_dfsph.density_factor_list_plain(
        tnl, tpart, tp)
    _close(density, ref["density"], "density")
    _close(factor, ref["factor"], "factor")
    assert np.abs(ref["factor"]).max() > 0
    assert idx.shape == (K_LIST, tp.n_pad) and cnt.shape == (tp.n_pad,)
    fluid = tpart.material.numpy() == 1
    jcnt = np.asarray(ref["nl_cnt"])
    np.testing.assert_array_equal(cnt.numpy(), np.where(fluid, jcnt, 0))
    over = cnt.numpy() > K_LIST
    assert (over.sum() > 0) == (scene == "edge")
    assert (fluid & ~over).sum() > 0
    jidx = np.asarray(ref["nl_idx"])
    idx = idx.numpy()
    for i in np.flatnonzero(fluid):
        listed = min(int(jcnt[i]), K_LIST)
        np.testing.assert_array_equal(idx[:listed, i], jidx[i, :listed])
        assert (idx[listed:, i] == -1).all()
    assert (idx[:, ~fluid] == -1).all()

    q, ctx = _cuda_solver(scene).density_factor_and_pairs(tpart,
                                                            starts)
    assert isinstance(ctx, NeighborList)
    torch.testing.assert_close(ctx.idx, tnl.idx, rtol=0, atol=0)
    assert torch.equal(q.density, density)
    assert torch.equal(q.dfsph_factor, factor)


def test_nonpressure_plain_over_the_step_contexts_match_jax(case):
    """d's plain versions over the contexts the steps give it (DFSPH's
    from its density-and-factor call, PCISPH's from its density call, both
    the neighbour lists on CPU tensors) against the JAX
    ``compute_non_pressure_forces``: kicked (acc, v), un-kicked (acc)."""
    scene, (tp, tpart, starts, _, dt, ref) = case
    q, ctx = _cuda_solver(scene).density_factor_and_pairs(tpart,
                                                            starts)
    acc, v = cuda_dfsph.nonpressure_kick_plain(ctx, q, dt, tp)
    _close(acc, ref["acc"], "acc")
    _close(v, ref["v"], "v")
    fluid = tpart.material.numpy() == 1
    g = np.asarray(tp.gravity, np.float32)
    assert np.abs(acc.numpy()[fluid] - g).max() > 1e-3
    assert (v.numpy()[fluid] != tpart.v.numpy()[fluid]).any()
    pcisph = _cuda_solver(scene, method=1)
    pctx = tbase.compute_densities_and_pairs(q, starts, pcisph.engine,
                                             pcisph.params)[1]
    assert isinstance(pctx, NeighborList)
    un = cuda_dfsph.nonpressure_accel_plain(pctx, q, tp)
    _close(un, ref["acc"], "un-kicked acc")
    assert torch.equal(un, acc)


@pytest.mark.parametrize("ctx", ["list", "slots"])
@pytest.mark.parametrize("call", ["density_factor_list", "nonpressure_kick",
                                  "nonpressure_accel"])
def test_wrapper_padding_rows(edge_case, call, ctx):
    """Each wrapper's result on CPU tensors (its plain version) holds the
    padding rows the JAX package's ``restore_tail`` gives: the density
    carried through and the factor 0; acc 0 and v carried through (with
    padding densities and velocities that are not 0), given the step's
    context from ``density_factor_list`` or the slot map.  On the card the
    kernels write these rows themselves; chip_smoke.py holds their whole
    outputs against the plain versions.  No launch is counted."""
    tp, tpart, starts, _, dt, _ = edge_case
    jp = J.build_scene(J.SimConfig(config_dict=scene_dict("edge")))[0]
    n_real = tp.n_fluid + tp.n_solid
    assert tp.n_pad > n_real
    pad = torch.arange(3 * (tp.n_pad - n_real), dtype=torch.float32)
    v, density = tpart.v.clone(), tpart.density.clone()
    v[n_real:] = pad.reshape(-1, 3)
    density[n_real:] = 1000.0 + pad[:tp.n_pad - n_real]
    p = tpart._replace(v=v, density=density)
    given = starts if ctx == "list" else build_slot_map(starts, tp)
    before = dict(cuda_dfsph.LAUNCHES)
    den, factor, c = cuda_dfsph.density_factor_list(given, p, tp, {})
    if call == "density_factor_list":
        got = (den, factor)
        fallbacks = (p.density, torch.zeros(tp.n_pad))
    elif call == "nonpressure_kick":
        got = cuda_dfsph.nonpressure_kick(c, p, dt, tp)
        fallbacks = (torch.zeros_like(p.x), p.v)
    else:
        got = (cuda_dfsph.nonpressure_accel(c, p, tp),)
        fallbacks = (torch.zeros_like(p.x),)
    assert cuda_dfsph.LAUNCHES == before
    for a, fallback in zip(got, fallbacks):
        restored = np.asarray(jbase.restore_tail(
            jnp.asarray(a.numpy()), jnp.asarray(fallback.numpy()), jp))
        np.testing.assert_array_equal(a.numpy(), restored)
        assert torch.equal(a[n_real:], fallback[n_real:])


def test_step_contexts_and_the_refusal_of_bare_offsets():
    """The contexts the steps give d: the neighbour lists on CPU tensors,
    the slot map as it is, and on the plain engine the context it was
    given, for DFSPH's density-and-factor call and PCISPH's density call;
    one DFSPH step (the static scene) and one PCISPH step (the fluid block
    alone: with the rigid block PCISPH's loop runs to its 1001-iteration
    cap, in both packages) on the CUDA engine over CPU tensors (the
    wrappers' plain versions) equal the plain engine's steps bitwise,
    launching nothing.  Over the cell runs on the card d takes only a
    ``PairList``: its context check refuses the bare cell offsets before
    any device check, naming the calls that make its context."""
    tp, tpart, starts, tnl, _, _ = _case("static")
    smap = build_slot_map(starts, tp)
    for method in (4, 1):
        cuda = _cuda_solver("static", method)
        plain = T.build_solver(cuda.params, device="cpu",
                               engine=GatherEngine(cuda.params))
        if method == 4:
            def pairs(solver, ctx):
                return solver.density_factor_and_pairs(tpart, ctx)[1]
        else:
            def pairs(solver, ctx):
                return tbase.compute_densities_and_pairs(
                    tpart, ctx, solver.engine, solver.params)[1]
        assert isinstance(pairs(cuda, starts), NeighborList)
        assert pairs(cuda, smap) is smap
        assert pairs(plain, tnl) is tnl
    before = {**cuda_dfsph.LAUNCHES, **cuda_pairs.LAUNCHES}
    for d in (scene_dict("static"), small_scene_dict(method=1)):
        params, part, _ = T.build_scene(T.SimConfig(config_dict=d),
                                        device="cpu")
        plain = T.build_solver(params, device="cpu",
                               engine=GatherEngine(params))
        cuda = T.build_solver(params, device="cpu",
                              engine=cuda_pairs.CudaEngine(params))
        state = plain.initialize(part)
        a, m = plain.step(state)
        b, _ = cuda.step(state)
        assert int(m["pressure_iters"]) < 100
        for name in ("x", "v", "density", "pressure", "acc"):
            assert torch.equal(getattr(a.p, name), getattr(b.p, name)), \
                (params.simulation_method, name)
    assert {**cuda_dfsph.LAUNCHES, **cuda_pairs.LAUNCHES} == before
    with pytest.raises(TypeError, match="density_factor_list"):
        cuda_dfsph._nonpressure_args(starts, tpart, tp)
