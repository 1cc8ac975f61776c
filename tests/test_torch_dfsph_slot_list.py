"""DFSPH's Jacobi kernels over the slot walk read the step's pair list.

Under ``--backend pallas_slots`` the DFSPH step's density-and-factor
kernel keeps its one-phase walk over the slot map and writes the accepted
neighbours of every centre of the Jacobi kernels (fluid, and dynamic rigid
for the reaction), in the walk's order, to the step's pair list
(ops/cuda_dfsph.py ``density_factor_list`` given a ``SlotMap`` returns a
``PairList`` over it); the solves move v, not x, so ``divergence`` (both
modes) and ``solver_dv`` (with and without the reaction) run only their
pair body over that list, a warp over the list walking the slot map in
one phase.  chip_smoke.py holds the kernels against their plain versions
bitwise on the card.  Here, on the CPU:
- the slot list's plain version (``pair_list.step_pairs_plain`` over
  ``slot_neighbor_list``, centres "jacobi") against the JAX gather
  engine's pairs of every fluid and dynamic-rigid centre where no cell
  overflows, and, where a cell holds more than the map's 8 x 4 slots,
  dropping exactly the pairs whose neighbour lies past its cell's first
  32; the same for the slot density kernel's list of every real centre
  (``cuda_pairs.density_sum_list_plain``, centres "real"), which the
  WCSPH, IISPH and PCISPH steps write (tests/test_torch_pcisph_slot_list.py);
- the Jacobi wrappers given that context on CPU tensors equal to their
  plain versions over the slot lists bitwise, padding rows included
  (padding densities, velocities and accelerations not 0), launching
  nothing, and equal to the JAX ``_density_change``, ``_density_adv`` and
  ``_solver_dv`` where no cell overflows;
- one slot-backend DFSPH step through ``substep``, the two solves given
  the step's slot list, equal bitwise to the cell-run step;
- the Jacobi wrappers' context check refusing a bare ``SlotMap``.
Scenes: the clumped two-way scene of tests/test_torch_slot_solvers.py (a
dynamic rigid block; "layers": a 20-particle cell, three of the four
layers; "overflow": also a 40-particle cell), the edge scene of
tests/test_torch_dfsph_compact.py (a dynamic rigid block and a cell of
~100 particles) and its "corner" form (the clump centred on a corner of 8
cells: no cell past the map's slots, and fluid centres with more accepted
pairs than the list holds).  Tolerance against JAX: atol 2e-5, rtol 2e-4 (the
engine-equivalence tolerance of tests/conftest.py).
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

import sph_taichi_torch as T
from sph_taichi_torch import convert
from sph_taichi_torch.models import base as tbase
from sph_taichi_torch.ops import cuda_dfsph, cuda_pairs, pair_list
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops import slots as tslots
from sph_taichi_torch.ops.pairs import GatherEngine

from conftest import _clumped_positions
from test_golden import _two_way_scene
from test_torch_dfsph_compact import edge_positions, edge_scene
from test_torch_slot_solvers import _clump, _dfsph_floor_impact


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4
K_LIST = pair_list.PAIR_LIST_ENTRIES
KINDS = ["layers", "overflow", "edge", "corner"]
CALLS = ["change", "adv", "solver_dv", "solver_dv_react"]
# the slot lists' centres: e1's (DFSPH) and the density kernel's (WCSPH,
# IISPH and PCISPH steps)
CENTRES = ["jacobi", "real"]


def _layers_scene():
    d = _two_way_scene(method=4)
    d["TPU"] = {"cellCap": 64, "neighborCap": 256}
    return d


@functools.lru_cache(maxsize=None)
def _jax_layers():
    """The "layers" state in both packages: the two-way scene at clumped
    positions (tests/conftest.py ``_clumped_positions``: a 20-particle
    cell) with random velocities, sorted by the JAX package, and from one
    compiled JAX program its neighbour lists, density and factor, and the
    Jacobi terms at a seeded stiffness and acceleration: (torch params,
    sorted particles, kappa, acc, {name: JAX result})."""
    rng = np.random.default_rng(0)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=_layers_scene()))
    x = _clumped_positions(rng, jp, jpart)
    real = np.asarray(jpart.material) != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    acc = rng.uniform(-5.0, 5.0, size=x.shape).astype(np.float32)
    kappa = (rng.choice([-1.0, 1.0], size=real.shape)
             * 10.0 ** rng.uniform(-7.0, 1.0, size=real.shape))
    kappa = np.where(real, kappa, 0.0).astype(np.float32)
    solver = J.build_solver(jp)
    dt = np.float32(jp.dt0)

    @jax.jit
    def refs(part, acc, kappa):
        p, nl, _ = jbase.bin_and_sort(part, jp, solver.engine)
        p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
        p = jbase.compute_moving_boundary_volume(p, nl, solver.engine, jp)
        q = solver.density_and_factor(p._replace(acc=acc), nl)
        out = {"p": q, "nl_idx": nl.idx, "nl_cnt": nl.cnt}
        out["change"] = solver._density_change(q, nl, q.v)
        out["adv"] = solver._density_adv(q, nl, q.v, q.density, dt)
        for react in (False, True):
            dv, reaction = solver._solver_dv(q, nl, kappa, react, dt)
            out[f"v{react}"] = jnp.where(q.is_fluid()[:, None], q.v + dv,
                                         q.v)
            if react:
                out["acc"] = jnp.where(q.is_dynamic_rigid()[:, None],
                                       q.acc + reaction, q.acc)
        return out

    out = jax.device_get(refs(jpart._replace(x=jnp.asarray(x),
                                             v=jnp.asarray(v, jnp.float32)),
                              jnp.asarray(acc), jnp.asarray(kappa)))
    p = {k: a for k, a in out.pop("p")._asdict().items() if a is not None}
    tp = T.build_scene(T.SimConfig(config_dict=_layers_scene()),
                       device="cpu")[0]
    tpart = convert.particles_from_numpy(p, "cpu")
    return tp, tpart, torch.tensor(kappa), torch.tensor(acc), out


def corner_positions(rng, params, x, material):
    """``edge_positions`` with the clump's ball centred on the corner that
    cells (2..3, 3..4, 2..3) share: ~12 of its particles in each of the 8
    cells, none past the slot map's 32, each with ~100 neighbours."""
    x = edge_positions(rng, params, x, material)
    clump = np.linalg.norm(x - (np.array([2, 3, 2]) + 0.5)
                           * params.grid_size, axis=1) \
        < 0.46 * params.support_radius
    x[clump] += np.float32(0.5 * params.grid_size)
    return x


@functools.lru_cache(maxsize=None)
def _torch_edge(kind):
    """The sorted particles of the edge scene ("edge") or its corner form
    ("corner") with Akinci volumes and densities from the plain engine,
    random velocities: (params, particles)."""
    params, part, _ = T.build_scene(T.SimConfig(config_dict=edge_scene()),
                                    device="cpu")
    rng = np.random.default_rng(0)
    material = part.material.numpy()
    place = corner_positions if kind == "corner" else edge_positions
    x = place(rng, params, part.x.numpy(), material)
    v = np.zeros_like(x)
    real = material != -1
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    part = part._replace(x=torch.from_numpy(x), v=torch.from_numpy(v))
    engine = GatherEngine(params)
    p, nl, _ = tbase.bin_and_sort(part, params, engine)
    p = tbase.compute_static_boundary_volume(p, nl, engine, params)
    p = tbase.compute_moving_boundary_volume(p, nl, engine, params)
    return params, tbase.compute_densities(p, nl, engine, params)


def _starts(p, params):
    return tgrid.cell_offsets(
        tgrid.compute_cell_ids(p.x, p.material, params.grid_size,
                               params.grid_num), params.num_cells)


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(params with the lists' caps raised, sorted particles, cell
    offsets, slot map, slot lists, the cell-run lists, a seeded stiffness
    (fluid rows) and acceleration) of scene ``kind``."""
    if kind == "layers":
        params, p, kappa, acc, _ = _jax_layers()
    else:
        if kind == "overflow":
            params, p = _clump(kind)[:2]
        else:
            params, p = _torch_edge(kind)
        rng = np.random.default_rng(1)
        k = rng.choice([-1.0, 1.0], p.n) * 10.0 ** rng.uniform(-7, 1, p.n)
        kappa = torch.where(p.material == 1,
                            torch.from_numpy(k.astype(np.float32)), 0.0)
        acc = torch.from_numpy(rng.uniform(-5, 5, (p.n, 3))
                               .astype(np.float32))
    caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
    starts = _starts(p, params)
    smap = tslots.build_slot_map(starts, params)
    snl = tslots.slot_neighbor_list(smap, p.x, caps)
    full = GatherEngine(caps).prepare(p.x, starts)
    assert not int(snl.diag["neighbor_overflow"])
    assert not int(full.diag["neighbor_overflow"])
    assert not int(full.diag["cell_overflow"])
    assert bool(smap.diag["slot_overflow"]) == (kind in ("overflow",
                                                          "edge"))
    assert int(smap.diag["max_layers_used"]) >= 3
    return caps, p, starts, smap, snl, full, kappa, acc


def _slot_context(kind):
    """The step's context over the slot walk, as ``density_factor_list``
    gives it on the card: a ``PairList`` whose walk is the slot map, its
    list from the plain version."""
    params, p, _, smap, snl = _case(kind)[:5]
    idx, cnt = cuda_dfsph.density_factor_list_plain(snl, p, params,
                                                    "jacobi")[2:]
    return pair_list.PairList(smap, idx, cnt)


def _slot_list(snl, p, params, centres):
    """The plain slot list of ``centres``: e1's ("jacobi", DFSPH's step)
    or the density kernel's ("real", the WCSPH, IISPH and PCISPH steps':
    ``density_sum_list_plain``), and the rows it lists."""
    if centres == "real":
        return (*cuda_pairs.density_sum_list_plain(snl, p, params)[1:],
                p.material >= 0)
    return (*pair_list.step_pairs_plain(snl, p, "jacobi"),
            p.is_fluid() | p.is_dynamic_rigid())


@pytest.mark.parametrize("centres", CENTRES)
def test_slot_list_plain_matches_jax_pairs(centres):
    """Where no cell overflows, the slot list holds every listed centre's
    pairs of the JAX gather engine (fluid and dynamic rigid for e1's,
    every real centre for the density kernel's), in its order, and the JAX
    count; other rows list none."""
    params, p, _, _, snl = _case("layers")[:5]
    out = _jax_layers()[4]
    idx, cnt, listed_rows = _slot_list(snl, p, params, centres)
    assert idx.shape == (K_LIST, params.n_pad) and cnt.shape == (params.n_pad,)
    listed_rows = listed_rows.numpy()
    assert p.is_dynamic_rigid().any()
    jcnt = np.asarray(out["nl_cnt"])
    np.testing.assert_array_equal(cnt.numpy(), np.where(listed_rows, jcnt, 0))
    jidx = np.asarray(out["nl_idx"])
    idx = idx.numpy()
    for i in np.flatnonzero(listed_rows):
        listed = min(int(jcnt[i]), K_LIST)
        np.testing.assert_array_equal(idx[:listed, i], jidx[i, :listed])
        assert (idx[listed:, i] == -1).all()
    assert (idx[:, ~listed_rows] == -1).all()
    assert int(cnt.max()) > 0


@pytest.mark.parametrize("centres", CENTRES)
@pytest.mark.parametrize("kind", ["overflow", "edge", "corner"])
def test_slot_list_drops_the_pairs_past_the_slots(kind, centres):
    """Each listed centre's slot list is its cell-run list without the
    neighbours ranked past the first 8 x layers of their cell (the cells
    are sorted, so a neighbour's rank is its row less its cell's start),
    in the same order, and the count is the kept pairs', also beyond the
    list: some centres lose pairs where a cell overflows the map, none in
    the corner scene, where centres hold more pairs than the list."""
    params, p, starts, smap, snl, full = _case(kind)[:6]
    idx, cnt, listed_rows = _slot_list(snl, p, params, centres)
    cell = tgrid.compute_cell_ids(p.x, p.material, params.grid_size,
                                  params.grid_num).long()
    rank = torch.arange(p.n) - starts.long()[cell.clamp_max(
        params.num_cells - 1)]
    slots = 8 * smap.layers
    lose = 0
    for i in torch.nonzero(listed_rows)[:, 0].tolist():
        nbrs = full.idx[i, :int(full.cnt[i])].long()
        kept = nbrs[rank[nbrs] < slots]
        lose += int(kept.numel() < nbrs.numel())
        assert int(cnt[i]) == kept.numel()
        listed = min(kept.numel(), K_LIST)
        assert torch.equal(idx[:listed, i].long(), kept[:listed])
        assert (idx[listed:, i] == -1).all()
    assert (lose > 0) == bool(smap.diag["slot_overflow"])
    assert (int((cnt > K_LIST).sum()) > 0) == (kind == "corner")
    assert int((cnt[~listed_rows] != 0).sum()) == 0


def _padded(p, params, acc):
    """``p`` and ``acc`` with padding densities, velocities and
    accelerations that are not 0."""
    n_real = params.n_fluid + params.n_solid
    assert p.n > n_real
    pad = torch.arange(3 * (p.n - n_real), dtype=torch.float32)
    v, density, acc = p.v.clone(), p.density.clone(), acc.clone()
    v[n_real:] = pad.reshape(-1, 3)
    density[n_real:] = 1000.0 + pad[:p.n - n_real]
    acc[n_real:] = -v[n_real:]
    return p._replace(v=v, density=density), acc


def _jacobi_call(call, p, kappa, acc, params):
    """(wrapper, plain version, arguments after the context, the padding
    rows' expected outputs) of a Jacobi call."""
    dt = torch.tensor(np.float32(params.dt0))
    n_real = params.n_fluid + params.n_solid
    if call.startswith("solver_dv"):
        react = call.endswith("react")
        return (cuda_dfsph.solver_dv, cuda_dfsph.solver_dv_plain,
                (p, kappa, p.v, acc, dt, react, params),
                (p.v[n_real:], acc[n_real:] if react else None))
    zero = torch.zeros(p.n - n_real)
    return (cuda_dfsph.divergence, cuda_dfsph.divergence_plain,
            (p, p.v, p.density, dt, call, params), (zero, zero))


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("kind", KINDS)
def test_jacobi_wrappers_over_the_slot_list_equal_plain(kind, call):
    """Each Jacobi wrapper given the step's slot context on CPU tensors
    returns exactly its plain version over the slot lists, whole outputs,
    the padding rows what the JAX package's restore_tail gives them (adv
    and errt 0, v and acc carried through), launching nothing.  Where no
    cell overflows, the real rows match the JAX package's terms."""
    params, p, _, _, snl, _, kappa, acc = _case(kind)
    ctx = _slot_context(kind)
    q, acc_q = _padded(p, params, acc)
    wrapper, plain, args, expect = _jacobi_call(call, q, kappa, acc_q, params)
    before = dict(cuda_dfsph.LAUNCHES)
    got = wrapper(ctx, *args)
    assert cuda_dfsph.LAUNCHES == before
    ref = plain(snl, *args)
    n_real = params.n_fluid + params.n_solid
    for a, b, e in zip(got, ref, expect):
        if e is None:
            assert a is None and b is None
            continue
        assert torch.equal(a, b)
        assert torch.equal(a[n_real:], e)
    assert float(got[0][:n_real].abs().max()) > 0
    if kind != "layers":
        return
    out = _jax_layers()[4]
    if call.startswith("solver_dv"):
        react = call.endswith("react")
        pairs = [(got[0], out[f"v{react}"])]
        if react:
            pairs.append((got[1], out["acc"]))
    else:
        pairs = [(got[0], out[call])]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy()[:n_real],
                                   np.asarray(b)[:n_real], atol=ATOL,
                                   rtol=RTOL, err_msg=call)


def test_slot_step_reads_the_step_list_and_equals_the_cell_run_step(
        monkeypatch):
    """Two DFSPH steps of the floor impact (its second step iterates) on
    the slot engine over CPU tensors, the step's density-and-factor call
    giving the slot list as on the card (``density_factor_list`` patched
    to return a ``PairList`` over the slot map from its plain version):
    ``substep`` hands that context to both solves and the non-pressure
    call, and every step equals the cell-run step bitwise, with the same
    iteration counts."""
    params, part, _ = T.build_scene(
        T.SimConfig(config_dict=_dfsph_floor_impact()), device="cpu")
    real_list = cuda_dfsph.density_factor_list

    def slot_list(ctx, p, prm, buffers=None):
        if not isinstance(ctx, tslots.SlotMap):
            return real_list(ctx, p, prm, buffers)
        snl = tslots.slot_neighbor_list(ctx, p.x, prm)
        density, factor, idx, cnt = cuda_dfsph.density_factor_list_plain(
            snl, p, prm, "jacobi")
        return density, factor, pair_list.PairList(ctx, idx, cnt)

    given = {}

    def spy(name):
        fn = getattr(cuda_dfsph, name)

        def call(ctx, *args, **kw):
            given.setdefault(name, set()).add(type(ctx).__name__)
            return fn(ctx, *args, **kw)
        return call

    monkeypatch.setattr(cuda_dfsph, "density_factor_list", slot_list)
    for name in ("divergence", "solver_dv", "nonpressure_kick"):
        monkeypatch.setattr(cuda_dfsph, name, spy(name))
    slot = T.build_solver(params, device="cpu",
                          engine=cuda_pairs.CudaSlotEngine(params))
    cell = T.build_solver(params, device="cpu",
                          engine=cuda_pairs.CudaEngine(params))
    state = slot.initialize(part)
    iters = 0
    for _ in range(2):
        given.clear()
        s, sm = slot.step(state)
        assert given == {name: {"PairList"} for name in (
            "divergence", "solver_dv", "nonpressure_kick")}
        given.clear()
        c, cm = cell.step(state)
        assert not bool(sm["slot_overflow"])
        for k in ("divergence_iters", "pressure_iters"):
            assert int(sm[k]) == int(cm[k]), k
        iters = max(iters, int(sm["divergence_iters"]))
        for name, a in c.p._asdict().items():
            if a is not None:
                assert torch.equal(a, getattr(s.p, name)), name
        state = c
    assert iters > 1


def test_jacobi_context_check_refuses_a_bare_slot_map():
    """On the card the Jacobi wrappers take a ``PairList`` over the slot
    map, not the bare map, whose kernels would have no list to read: the
    context check raises before any device check, naming the call that
    makes the context.  On CPU tensors a wrapper given the bare map still
    runs its plain version over the slot lists."""
    params, p, _, smap, snl = _case("layers")[:5]
    with pytest.raises(TypeError, match="density_factor_list"):
        pair_list.jacobi_walk(smap, p, params)
    args = (p, p.v, None, None, "change", params)
    assert all(torch.equal(a, b) for a, b in zip(
        cuda_dfsph.divergence(smap, *args),
        cuda_dfsph.divergence_plain(snl, *args)))
    # over the cell runs the context check takes bare offsets and a
    # PairList alike; both reach the device check
    for ctx in (_starts(p, params), pair_list.PairList(
            _starts(p, params), *_slot_context("layers")[1:])):
        with pytest.raises(ValueError, match="CUDA kernel"):
            pair_list.jacobi_walk(ctx, p, params)
