"""The DFSPH Jacobi terms on a scene built for the two-phase walk's edges.

``dfsph_divergence`` and ``dfsph_solver_dv`` compact each centre's accepted
pairs into a list in shared memory before the pair body, flushing a full
list mid-walk (csrc/pair_common.cuh ``for_each_neighbor_compact``).  Their plain versions are the oracle the
kernels are held against bitwise on the card (chip_smoke.py builds the same
scene with its own copy of the generator).  Here, on the CPU, the plain
versions are held against the JAX package's ``_density_change``,
``_density_adv`` and ``_solver_dv`` on that scene at the engine tolerance
(atol 2e-5, rtol 2e-4), and the scene is checked to hold the edges:
- a cell of >= 54 particles (as at the dynamic dragon's contact);
- centres with more accepted neighbours than two lists of LIST_ENTRIES
  (two flushes or more);
- 32 consecutive sorted fluid centres in two (ix, iy) columns;
- a dynamic rigid block with fluid neighbours (the reaction).
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
from sph_taichi_torch.ops import cuda_dfsph
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops.pairs import GatherEngine

from conftest import small_scene_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4
CLUMP = 96


def edge_scene():
    """The two-way DFSPH scene (a fluid block above a dynamic rigid block)
    with the plain engines' caps raised for the clump."""
    d = small_scene_dict(method=4)
    d["RigidBlocks"] = [{
        "objectId": 1, "start": [0.15, 0.08, 0.15], "end": [0.45, 0.26, 0.45],
        "translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
        "velocity": [0.0, 0.0, 0.0], "density": 500.0,
        "color": [100, 100, 100], "isDynamic": True}]
    d["TPU"] = {"cellCap": 128, "neighborCap": 192}
    return d


def edge_positions(rng, params, x, material):
    """The scene's lattice jittered by up to 0.3 particle radii, and the
    CLUMP highest fluid particles moved into a ball of radius 0.45 h at
    the centre of cell (2, 3, 2), inside the fluid block's lowest layer of
    cells: one cell of ~100 particles, each with ~100 neighbours."""
    x = x.copy()
    real = material != -1
    r = params.particle_radius
    x[real] += rng.uniform(-0.3 * r, 0.3 * r, size=(int(real.sum()), 3))
    fluid = np.flatnonzero(material == 1)
    top = fluid[np.argsort(x[fluid, 1], kind="stable")[-CLUMP:]]
    h = params.support_radius
    centre = (np.array([2, 3, 2]) + 0.5) * params.grid_size
    d = rng.normal(size=(CLUMP, 3))
    d *= (0.45 * h * rng.uniform(0, 1, CLUMP) ** (1 / 3)
          / np.linalg.norm(d, axis=1))[:, None]
    x[top] = centre + d
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(seed=0):
    """Identical sorted particles in both packages, random velocities,
    accelerations and stiffnesses (1e-7 .. 10 in magnitude, both sides of
    the m_eps gate), the JAX package's terms on them from one compiled
    program, and the torch inputs: (torch params, particles, cell offsets,
    neighbour lists, kappa, {name: JAX result})."""
    rng = np.random.default_rng(seed)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=edge_scene()))
    material = np.asarray(jpart.material)
    x = edge_positions(rng, jp, np.asarray(jpart.x), material)
    real = material != -1
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
        p = p._replace(acc=acc)
        q = solver.density_and_factor(p, nl)
        out = {"p": q}
        out["change"] = solver._density_change(q, nl, q.v)
        out["adv"] = solver._density_adv(q, nl, q.v, q.density, dt)
        for react in (False, True):
            dv, reaction = solver._solver_dv(q, nl, kappa, react, dt)
            out[f"solver_v{react}"] = jnp.where(q.is_fluid()[:, None],
                                                q.v + dv, q.v)
            if react:
                out["solver_acc"] = jnp.where(q.is_dynamic_rigid()[:, None],
                                              q.acc + reaction, q.acc)
        return out

    out = jax.device_get(refs(jpart._replace(x=jnp.asarray(x),
                                             v=jnp.asarray(v, jnp.float32)),
                              jnp.asarray(acc), jnp.asarray(kappa)))
    p = {k: a for k, a in out.pop("p")._asdict().items() if a is not None}
    tp = T.build_scene(T.SimConfig(config_dict=edge_scene()),
                       device="cpu")[0]
    tpart = convert.particles_from_numpy(p, "cpu")
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(tpart.x, tpart.material, tp.grid_size,
                               tp.grid_num), tp.num_cells)
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    assert not int(tnl.diag["neighbor_overflow"])
    assert not int(tnl.diag["cell_overflow"])
    return tp, tpart, starts, tnl, torch.tensor(kappa), out


def _close(got, ref, tp, name):
    n = tp.n_fluid + tp.n_solid
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(ref)[:n],
                               atol=ATOL, rtol=RTOL, err_msg=name)


def test_edge_scene_holds_the_edges():
    tp, tpart, starts, tnl, _, _ = _case()
    occ = starts[1:-1] - starts[:-2]
    assert int(occ.max()) >= 54
    material = tpart.material
    fluid = material == 1
    # accepted pairs of the centres that walk (every real neighbour is
    # accepted by the candidate phase; the body filters materials)
    assert int(tnl.cnt[fluid].max()) > 2 * cuda_dfsph.LIST_ENTRIES
    # warps of 32 consecutive sorted rows whose fluid centres lie in two
    # or more (ix, iy) columns
    cell = tgrid.pos_to_cell(tpart.x, tp.grid_size).long()
    col = cell[:, 0] * tp.grid_num[1] + cell[:, 1]
    n = tp.n_fluid + tp.n_solid
    straddle = 0
    for w in range(0, n, 32):
        cols = col[w:min(w + 32, n)][fluid[w:min(w + 32, n)]]
        straddle += int(torch.unique(cols).numel() >= 2)
    assert straddle >= 2
    # dynamic rigid centres with fluid neighbours
    dynr = tpart.is_dynamic_rigid()
    fluid_nbr = tnl.mask() & (material[tnl.idx] == 1)
    assert int(fluid_nbr[dynr].sum()) > 0


@pytest.mark.parametrize("mode", ["change", "adv"])
def test_divergence_plain_matches_jax(mode):
    tp, tpart, starts, tnl, _, ref = _case()
    dt = torch.tensor(np.float32(tp.dt0))
    adv, errt = cuda_dfsph.divergence_plain(tnl, tpart, tpart.v,
                                            tpart.density, dt, mode, tp)
    _close(adv, ref[mode], tp, f"{mode} adv")
    # the per-centre column of the average density error
    fluid = tpart.material.numpy() == 1
    offset = tp.density0 if mode == "adv" else 0.0
    rho0_adv = np.float32(tp.density0) * np.asarray(ref[mode])
    _close(errt, np.where(fluid, rho0_adv - np.float32(offset), 0.0), tp,
           f"{mode} errt")
    assert np.abs(np.asarray(ref[mode])[fluid]).max() > 0


@pytest.mark.parametrize("react", [False, True])
def test_solver_dv_plain_matches_jax(react):
    tp, tpart, starts, tnl, kappa, ref = _case()
    dt = torch.tensor(np.float32(tp.dt0))
    v, acc = cuda_dfsph.solver_dv_plain(tnl, tpart, kappa, tpart.v,
                                        tpart.acc, dt, react, tp)
    _close(v, ref[f"solver_v{react}"], tp, "v")
    fluid = tpart.material.numpy() == 1
    assert (v.numpy() != tpart.v.numpy())[fluid].mean() > 0.5
    if react:
        _close(acc, ref["solver_acc"], tp, "acc")
        dynr = tpart.is_dynamic_rigid().numpy()
        assert np.abs(acc.numpy() - tpart.acc.numpy())[dynr].max() > 0
    else:
        assert acc is None


@pytest.mark.parametrize("call", ["change", "adv", "solver_dv",
                                  "solver_dv_react"])
def test_wrapper_padding_rows(call):
    """Each Jacobi wrapper's result on CPU tensors (its plain version)
    holds the padding rows the JAX package's restore_tail gives: 0 in adv
    and errt, v and acc passed through.  On the card the kernels write
    these rows themselves; chip_smoke.py's edge-scene phase holds their
    whole outputs, padding rows included, against the plain versions."""
    tp, tpart, starts, tnl, kappa, _ = _case()
    n_real = tp.n_fluid + tp.n_solid
    assert tp.n_pad > n_real
    dt = torch.tensor(np.float32(tp.dt0))
    v = tpart.v.clone()
    v[n_real:] = torch.arange(3 * (tp.n_pad - n_real),
                              dtype=torch.float32).reshape(-1, 3)
    acc = tpart.acc.clone()
    acc[n_real:] = -v[n_real:]
    if call.startswith("solver_dv"):
        react = call.endswith("react")
        args = (tpart, kappa, v, acc, dt, react, tp)
        got = cuda_dfsph.solver_dv(starts, *args)
        ref = cuda_dfsph.solver_dv_plain(tnl, *args)
        expect = (v[n_real:], acc[n_real:] if react else None)
    else:
        args = (tpart, v, tpart.density, dt, call, tp)
        got = cuda_dfsph.divergence(starts, *args)
        ref = cuda_dfsph.divergence_plain(tnl, *args)
        zero = torch.zeros(tp.n_pad - n_real)
        expect = (zero, zero)
    for a, b, e in zip(got, ref, expect):
        if e is None:
            assert a is None and b is None
            continue
        assert torch.equal(a, b)
        assert torch.equal(a[n_real:], e)
