"""WCSPH's step over its pair list: the density kernel writes it, the force kernel reads it.

On the WCSPH step the positions stay those of the sort until the force
kernel's advect epilogue, and the force kernel's centres (the fluid and,
with the two-way reaction, the dynamic rigids) are a subset of the density
kernel's (every real row).  So over the cell runs ``density_sum_list``
(ops/cuda_pairs.py) sums the densities and writes every real centre's
accepted neighbours, in the walk's order, to the step's pair list
(ops/pair_list.py ``PairList``: at most PAIR_LIST_ENTRIES per centre, the
count also beyond), and ``wcsph_forces`` runs its pair body over that list;
a warp holding a centre over the list walks the cells in one phase.
chip_smoke.py holds both kernels, their padding rows included, against the
plain versions bitwise on the card.  Here, on the CPU, over the edge scene
of tests/test_torch_dfsph_compact.py as WCSPH (a dynamic rigid block, so
the reaction variant runs, and a cell of ~100 particles, so centres with
more neighbours than the list holds) and over a small scene of a fluid
block on a static rigid block (no reaction):
- the plain density-and-list call (``density_sum_list_plain``, from the
  port's GatherEngine lists) against the JAX package's gather-engine pairs
  for every real centre (the same j in walk order, the count, the mark of
  a centre over the list), and the step's density on every real row
  against the JAX ``compute_densities``;
- ``wcsph_forces_plain`` over the step's context against the JAX solver's
  forces, advect and fluid clamp (x, v, acc);
- the wrappers' padding rows on CPU tensors (their plain versions) against
  the JAX package's ``restore_tail``, over the step's context and over the
  slot map;
- the contexts the step's call gives on each engine, and that the force
  kernel's context check refuses bare cell offsets and a bare slot map.
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
from sph_taichi_torch.ops import cuda_pairs, pair_list
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.ops.slots import SlotMap, build_slot_map

from conftest import small_scene_dict
from test_torch_dfsph_compact import edge_positions, edge_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4
K_LIST = pair_list.PAIR_LIST_ENTRIES
SCENES = ["static", "edge"]


def scene_dict(scene):
    """"edge": the two-phase walk's edge scene as WCSPH (dt 4e-4);
    "static": the small fluid block resting on a static rigid block."""
    if scene == "edge":
        d = edge_scene()
    else:
        d = small_scene_dict()
        d["RigidBlocks"] = [{
            "objectId": 1, "start": [0.05, 0.1, 0.05],
            "end": [0.55, 0.28, 0.55], "translation": [0.0, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0], "velocity": [0.0, 0.0, 0.0],
            "density": 1000.0, "color": [100, 100, 100],
            "isDynamic": False}]
    cfg = d["Configuration"]
    cfg["simulationMethod"], cfg["timeStepSize"] = 0, 4e-4
    return d


def jittered(rng, params, x, material):
    """The scene's lattice jittered by up to 0.3 particle radii."""
    x = x.copy()
    real = material != -1
    r = params.particle_radius
    x[real] += rng.uniform(-0.3 * r, 0.3 * r, size=(int(real.sum()), 3))
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(scene):
    """Identical sorted particles in both packages with their Akinci
    volumes and random velocities, the JAX neighbour lists, densities and
    one force step (forces, advect, fluid clamp) from one compiled program,
    and the torch inputs: (torch params, particles, cell offsets, neighbour
    lists, dt, {name: JAX result})."""
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
        q = jbase.compute_densities(p, nl, solver.engine, jp)
        f = solver.compute_forces(q, nl, dt=None)
        f = solver.advect(f, dt)
        f = jbase.enforce_boundary(f, jp, J.state.MATERIAL_FLUID)
        return {"p": p, "nl_idx": nl.idx, "nl_cnt": nl.cnt,
                "density": q.density, "x": f.x, "v": f.v, "acc": f.acc}

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


def _close(got, ref, name, rows):
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows],
                               atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("scene", SCENES)
def test_density_and_list_plain_match_jax(scene):
    """The list holds every real centre's first K_LIST pairs, solids'
    too, in the JAX gather engine's order; its count is the JAX count
    (beyond the list too: the mark of a centre over it); padding rows list
    none.  The step's density (the sums of the same call, through
    ``compute_densities_and_pairs`` on the CUDA engine, whose wrapper takes
    its plain version on CPU tensors) equals the JAX ``compute_densities``
    and, bitwise, the plain engine's."""
    tp, tpart, starts, tnl, _, ref = _case(scene)
    den, idx, cnt = cuda_pairs.density_sum_list_plain(tnl, tpart, tp)
    assert idx.shape == (K_LIST, tp.n_pad) and cnt.shape == (tp.n_pad,)
    material = tpart.material.numpy()
    real = material >= 0
    jcnt = np.asarray(ref["nl_cnt"])
    np.testing.assert_array_equal(cnt.numpy(), np.where(real, jcnt, 0))
    over = cnt.numpy() > K_LIST
    assert (over.sum() > 0) == (scene == "edge")
    assert (real & ~over).sum() > 0
    assert (cnt.numpy()[material == 0] > 0).sum() > 0
    jidx = np.asarray(ref["nl_idx"])
    idx = idx.numpy()
    for i in np.flatnonzero(real):
        listed = min(int(jcnt[i]), K_LIST)
        np.testing.assert_array_equal(idx[:listed, i], jidx[i, :listed])
        assert (idx[listed:, i] == -1).all()
    assert (idx[:, ~real] == -1).all()

    q, ctx = tbase.compute_densities_and_pairs(
        tpart, starts, cuda_pairs.CudaEngine(tp), tp)
    assert isinstance(ctx, NeighborList)
    torch.testing.assert_close(ctx.idx, tnl.idx, rtol=0, atol=0)
    # every real row: the solids' density feeds the reaction's rho0 / rho
    _close(q.density, ref["density"], "density", real)
    assert torch.equal(
        q.density,
        tbase.compute_densities(tpart, tnl, GatherEngine(tp), tp).density)
    assert torch.equal(den, cuda_pairs.density_sum_plain(
        tnl, tpart.x, tpart.material, tpart.m_V, tp))


@pytest.mark.parametrize("scene", SCENES)
def test_forces_plain_over_the_step_context_match_jax(scene):
    """``wcsph_forces_plain`` over the context of the step's density call
    (the reaction variant on the edge scene's dynamic rigid block, none on
    the static scene) against the JAX solver's forces, advect and fluid
    box clamp."""
    tp, tpart, starts, _, dt, ref = _case(scene)
    q, ctx = tbase.compute_densities_and_pairs(
        tpart, starts, cuda_pairs.CudaEngine(tp), tp)
    tsolver = T.build_solver(tp, device="cpu")
    q, dpi, p_r02, m_nc, rr0 = tsolver.force_inputs(q)
    assert (rr0 is not None) == (scene == "edge")
    x, v, acc = cuda_pairs.wcsph_forces_plain(ctx, q, dpi, p_r02, m_nc, rr0,
                                              dt, tp)
    real = tpart.material.numpy() != -1
    for name, got in (("x", x), ("v", v), ("acc", acc)):
        _close(got, ref[name], name, real)
    solid = tpart.material.numpy() == 0
    g = np.asarray(tp.gravity, np.float32)
    felt = np.abs(acc.numpy()[solid] - g).max()
    # the reaction moves the dynamic rigids; static solids keep acc 0
    assert (felt > 1e-3) if scene == "edge" else felt == np.abs(g).max()


@pytest.mark.parametrize("ctx", ["list", "slots"])
@pytest.mark.parametrize("call", ["density_sum_list", "wcsph_forces"])
def test_wrapper_padding_rows(call, ctx):
    """Each wrapper's result on CPU tensors (its plain version) holds the
    padding rows the JAX package's ``restore_tail`` gives: the density
    sum 0; x and v carried through and acc 0 (with padding velocities that
    are not 0), given the step's context from ``density_sum_list`` or the
    slot map.  On the card the kernels write these rows themselves;
    chip_smoke.py holds their whole outputs against the plain versions."""
    tp, tpart, starts, _, dt, _ = _case("edge")
    jp = J.build_scene(J.SimConfig(config_dict=scene_dict("edge")))[0]
    n_real = tp.n_fluid + tp.n_solid
    assert tp.n_pad > n_real
    v = tpart.v.clone()
    v[n_real:] = torch.arange(3 * (tp.n_pad - n_real),
                              dtype=torch.float32).reshape(-1, 3)
    p = tpart._replace(v=v)
    given = starts if ctx == "list" else build_slot_map(starts, tp)
    before = dict(cuda_pairs.LAUNCHES)
    if call == "density_sum_list":
        got = (cuda_pairs.density_sum_list(given, p, tp, {})[0],)
        fallbacks = (torch.zeros(tp.n_pad),)
    else:
        q, c = tbase.compute_densities_and_pairs(
            p, given, cuda_pairs.CudaEngine(tp), tp, {})
        q, dpi, p_r02, m_nc, rr0 = T.build_solver(
            tp, device="cpu").force_inputs(q)
        got = cuda_pairs.wcsph_forces(c, q, dpi, p_r02, m_nc, rr0, dt, tp)
        fallbacks = (q.x, q.v, torch.zeros_like(q.x))
    assert cuda_pairs.LAUNCHES == before
    for a, fallback in zip(got, fallbacks):
        restored = np.asarray(jbase.restore_tail(
            jnp.asarray(a.numpy()), jnp.asarray(fallback.numpy()), jp))
        np.testing.assert_array_equal(a.numpy(), restored)
        assert torch.equal(a[n_real:], fallback[n_real:])


def test_step_contexts_and_the_refusal_of_bare_offsets():
    """The step's density call gives the force term the context it reads:
    the neighbour lists on CPU tensors, the slot map as it is, and on the
    plain engine the context it was given; one WCSPH step on the CUDA
    engine over CPU tensors (its wrappers' plain versions) equals the plain
    engine's step bitwise, launching nothing.  On the card the force
    kernel takes only a ``PairList``: its context check
    (``pair_list.list_walk``) refuses the bare cell offsets and the bare
    slot map before any device check."""
    tp, tpart, starts, tnl, _, _ = _case("static")
    smap = build_slot_map(starts, tp)
    cuda = cuda_pairs.CudaEngine(tp)
    assert isinstance(
        tbase.compute_densities_and_pairs(tpart, starts, cuda, tp)[1],
        NeighborList)
    assert isinstance(
        tbase.compute_densities_and_pairs(tpart, smap, cuda, tp)[1], SlotMap)
    assert tbase.compute_densities_and_pairs(
        tpart, tnl, GatherEngine(tp), tp)[1] is tnl
    plain = T.build_solver(tp, device="cpu")
    fused = T.build_solver(tp, device="cpu", engine=cuda)
    state = plain.initialize(tpart)
    before = dict(cuda_pairs.LAUNCHES)
    a, _ = plain.step(state)
    b, _ = fused.step(state)
    assert cuda_pairs.LAUNCHES == before
    for name in ("x", "v", "density", "pressure", "acc"):
        assert torch.equal(getattr(a.p, name), getattr(b.p, name)), name
    for bare in (starts, smap):
        with pytest.raises(TypeError, match="density_sum_list"):
            pair_list.list_walk(bare, tpart, tp, "wcsph_forces",
                                source="density_sum_list")
