"""Parity of the PyTorch port's operators with the JAX package, on the CPU.

The same numpy-seeded inputs go through each JAX function and its
counterpart in sph_taichi_torch.  Grid, sort and neighbour lists must agree
bitwise; the pair sums at the engine-equivalence tolerance of
conftest._assert_states_close (atol 2e-5, rtol 2e-4: the two packages sum
the same f32 terms in different orders, and XLA's rsqrt and torch's
1/sqrt differ by an ulp).
"""

import ctypes
import functools
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sph_taichi_tpu as J
from sph_taichi_tpu.models import base as jbase
from sph_taichi_tpu.ops import grid as jgrid
from sph_taichi_tpu.ops import kernels as jkernels

import sph_taichi_torch as T
from sph_taichi_torch import convert
from sph_taichi_torch.models import base as tbase
from sph_taichi_torch.ops import cuda_pairs
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops import kernels as tkernels
from sph_taichi_torch.ops import neighbors as tneighbors
from sph_taichi_torch.ops.pairs import GatherEngine

from conftest import _clumped_positions, small_scene_dict
from test_golden import _two_way_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4


def _jax_particles_numpy(p):
    return {k: np.asarray(v) for k, v in p._asdict().items() if v is not None}


@functools.lru_cache(maxsize=None)
def _prepared(scene, seed=0):
    """Identical sorted particles in both packages on the scene ``scene``
    ("small" or "two_way"): clumped positions and random velocities,
    Akinci volumes and densities computed by the JAX package, then carried
    across with convert.particles_from_numpy.  Computed once per scene in
    a test process; the tests do not modify them."""
    scene = small_scene_dict() if scene == "small" else _two_way_scene()
    rng = np.random.default_rng(seed)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=scene))
    x = _clumped_positions(rng, jp, jpart)
    real = np.asarray(jpart.material) != -1
    v = np.zeros_like(x)
    v[real] = rng.uniform(-1.0, 1.0, size=(int(real.sum()), 3))
    jpart = jpart._replace(x=jnp.asarray(x), v=jnp.asarray(v, jnp.float32))
    solver = J.build_solver(jp)
    p, nl, _ = jbase.bin_and_sort(jpart, jp, solver.engine)
    p = jbase.compute_static_boundary_volume(p, nl, solver.engine, jp)
    p = jbase.compute_moving_boundary_volume(p, nl, solver.engine, jp)
    p = jbase.compute_densities(p, nl, solver.engine, jp)
    tp = T.build_scene(T.SimConfig(config_dict=scene), device="cpu")[0]
    tpart = convert.particles_from_numpy(_jax_particles_numpy(p), "cpu")
    starts = tgrid.cell_offsets(
        tgrid.compute_cell_ids(tpart.x, tpart.material, tp.grid_size,
                               tp.grid_num), tp.num_cells)
    return jp, solver, p, nl, tp, tpart, starts


def test_cubic_kernel_matches_jax():
    rng = np.random.default_rng(0)
    h = 0.1
    r = (rng.uniform(0.0, 1.2, 4096) * h).astype(np.float32)
    r[:4] = [0.0, 0.5 * h, h, 1e-6]
    inv = (np.float32(1.0) / np.maximum(r, np.float32(1e-24))).astype(
        np.float32)
    tr, ti = torch.from_numpy(r), torch.from_numpy(inv)
    np.testing.assert_array_equal(
        tkernels.cubic_kernel(tr, h).numpy(),
        np.asarray(jkernels.cubic_kernel(jnp.asarray(r), h)))
    np.testing.assert_array_equal(
        tkernels.cubic_kernel_derivative_scalar(tr, h, inv_r=ti).numpy(),
        np.asarray(jkernels.cubic_kernel_derivative_scalar(
            jnp.asarray(r), h, inv_r=jnp.asarray(inv))))
    np.testing.assert_allclose(
        tkernels.cubic_kernel_derivative_scalar(tr, h).numpy(),
        np.asarray(jkernels.cubic_kernel_derivative_scalar(
            jnp.asarray(r), h)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_grid_sort_and_offsets_bitwise(scene):
    d = small_scene_dict() if scene == "small" else _two_way_scene()
    rng = np.random.default_rng(1)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=d))
    x = _clumped_positions(rng, jp, jpart)
    # particles exactly on cell planes, and strays outside the domain
    x[40] = [0.3, 0.4, 0.5]
    x[41] = [-0.01, 0.5, 1.05]
    jpart = jpart._replace(x=jnp.asarray(x))
    tpart = convert.particles_from_numpy(_jax_particles_numpy(jpart), "cpu")

    jids = jgrid.compute_cell_ids(jpart.x, jpart.material, jp.grid_size,
                                  jp.grid_num)
    tids = tgrid.compute_cell_ids(tpart.x, tpart.material, jp.grid_size,
                                  jp.grid_num)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    real = np.asarray(jpart.material) != -1   # padding x overflows int32
    np.testing.assert_array_equal(
        tgrid.pos_to_cell(tpart.x, jp.grid_size).numpy()[real],
        np.asarray(jgrid.pos_to_cell(jpart.x, jp.grid_size))[real])

    jsorted, jsids = jgrid.sort_by_cell(jpart, jids, extra_transient=("acc",))
    tsorted, tsids = tgrid.sort_by_cell(tpart, tids, extra_transient=("acc",))
    np.testing.assert_array_equal(tsids.numpy(), np.asarray(jsids))
    for name, a in _jax_particles_numpy(jsorted).items():
        np.testing.assert_array_equal(getattr(tsorted, name).numpy(), a,
                                      err_msg=name)
    jstarts = jgrid.cell_offsets(jsids, jp.num_cells)
    tstarts = tgrid.cell_offsets(tsids, jp.num_cells)
    assert tstarts.dtype == torch.int32
    np.testing.assert_array_equal(tstarts.numpy(), np.asarray(jstarts))
    assert int(tgrid.max_cell_occupancy(tstarts)) == int(
        jgrid.max_cell_occupancy(jstarts))


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_neighbor_list_bitwise(scene):
    jp, _, p, nl, tp, tpart, starts = _prepared(scene)
    tnl = tneighbors.build_neighbor_list(
        tpart.x, starts, tp.grid_num, tp.grid_size, tp.support_radius,
        tp.neighbor_cap, tp.cell_cap)
    np.testing.assert_array_equal(tnl.cnt.numpy(), np.asarray(nl.cnt))
    np.testing.assert_array_equal(tnl.idx.numpy(), np.asarray(nl.idx))
    assert int(tnl.diag["neighbor_overflow"]) == int(
        nl.diag["neighbor_overflow"]) == 0


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_density_sum_plain_matches_jax(scene):
    jp, solver, p, nl, tp, tpart, starts = _prepared(scene)
    h = jp.support_radius

    def term(fi, fj, d2, rn, dots):     # models/base.py compute_densities
        w = jkernels.cubic_kernel(rn, h, jp.dim)
        return {"den": jnp.where(fj["material"] >= 0, fj["m_V"] * w, 0.0)}

    ref = np.asarray(solver.engine.traverse(
        nl, p.x, {"material": p.material, "m_V": p.m_V}, term,
        {"den": "scalar"}, mode="mxu")["den"])
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    got = cuda_pairs.density_sum_plain(tnl, tpart.x, tpart.material,
                                       tpart.m_V, tp).numpy()
    real = np.asarray(p.material) != -1
    assert ref[real].max() > 0
    np.testing.assert_allclose(got[real], ref[real], atol=ATOL, rtol=RTOL)
    # the wrapper takes the plain version on CPU tensors and counts nothing
    before = dict(cuda_pairs.LAUNCHES)
    np.testing.assert_array_equal(
        cuda_pairs.density_sum(starts, tpart, tp).numpy(), got)
    assert cuda_pairs.LAUNCHES == before


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_wcsph_forces_plain_matches_jax(scene):
    """Forces + advect + fluid clamp; "two_way" has a dynamic rigid, so
    the reaction variant (rr0) runs."""
    jp, solver, p, nl, tp, tpart, starts = _prepared(scene)
    assert bool(jp.dynamic_rigid_ids) == (scene == "two_way")
    dt = np.float32(jp.dt0)
    pj = solver.compute_forces(p, nl, dt=None)
    pj = solver.advect(pj, jnp.asarray(dt))
    pj = jbase.enforce_boundary(pj, jp, J.state.MATERIAL_FLUID)

    tsolver = T.build_solver(tp, device="cpu")
    tq, dpi, p_r02, m_nc, rr0 = tsolver.force_inputs(tpart)
    assert (rr0 is not None) == (scene == "two_way")
    tnl = GatherEngine(tp).prepare(tpart.x, starts)
    tdt = torch.tensor(dt)
    x, v, acc = cuda_pairs.wcsph_forces_plain(tnl, tq, dpi, p_r02, m_nc, rr0,
                                              tdt, tp)
    real = np.asarray(p.material) != -1
    for name, got in (("x", x), ("v", v), ("acc", acc)):
        ref = np.asarray(getattr(pj, name))
        np.testing.assert_allclose(got.numpy()[real], ref[real], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    # the EOS's pow may differ by an ulp between XLA and torch
    np.testing.assert_allclose(tq.pressure.numpy()[real],
                               np.asarray(pj.pressure)[real], rtol=RTOL)
    if scene == "two_way":
        rigid = np.asarray(p.material) == 0
        g = np.asarray(jp.gravity, np.float32)
        assert np.abs(acc.numpy()[rigid] - g).max() > 1e-3   # reaction felt
    before = dict(cuda_pairs.LAUNCHES)
    for a, b in zip(cuda_pairs.wcsph_forces(starts, tq, dpi, p_r02, m_nc,
                                            rr0, tdt, tp), (x, v, acc)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert cuda_pairs.LAUNCHES == before


def test_boundary_volume_dense_matches_jax():
    jp, solver, p, nl, tp, tpart, starts = _prepared("two_way")
    s = np.asarray(p.material) == 0
    jref = jbase._boundary_volume_dense(p, jp, p.material == 0)
    tgot = tbase._boundary_volume_dense(tpart, tp, tpart.material == 0)
    np.testing.assert_allclose(tgot.m_V.numpy()[s], np.asarray(jref.m_V)[s],
                               rtol=2e-6)
    np.testing.assert_array_equal(tgot.m_V.numpy()[~s],
                                  np.asarray(jref.m_V)[~s])


def test_polar_rotation_matches_jax():
    from sph_taichi_tpu.ops.linalg import polar_rotation as jpolar
    from sph_taichi_torch.ops.linalg import polar_rotation as tpolar
    rng = np.random.default_rng(3)
    for a in [rng.normal(size=(3, 3)), np.diag([2.0, 1.0, -0.5]),
              np.zeros((3, 3)), np.full((3, 3), 1e-14)]:
        a = a.astype(np.float32)
        r = tpolar(torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(r, np.asarray(jpolar(jnp.asarray(a))),
                                   atol=1e-5)
        assert abs(np.linalg.det(r) - 1.0) < 1e-5
    np.testing.assert_array_equal(tpolar(torch.zeros(3, 3)).numpy(),
                                  np.eye(3, dtype=np.float32))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, sph_taichi_torch\n"
        "for m in pkgutil.walk_packages(sph_taichi_torch.__path__,"
        " 'sph_taichi_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'sph_taichi_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from sph_taichi_torch.simulation import Simulation
    cfg = T.SimConfig(config_dict=small_scene_dict())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.build_scene(cfg)
    params, _, _ = T.build_scene(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.build_solver(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(config=cfg)
    assert Simulation(config=cfg, device="cpu").state.p.x.device.type == "cpu"


def test_cuda_pairs_needs_no_nvcc_to_import():
    """The module and its ctypes layout load without a toolkit: the build
    happens at the first launch.  The ctypes struct must list the fields
    of PairConsts (csrc/pair_common.cuh, included by every kernel source)
    in the same order."""
    src = (cuda_pairs.__file__.rsplit("/ops/", 1)[0]
           + "/csrc/pair_common.cuh")
    body = re.search(r"struct PairConsts \{(.*?)\};", open(src).read(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"([A-Za-z_][A-Za-z0-9_]*)\s*(?=[,;])", body)
    assert names == [f for f, _ in cuda_pairs.PairConsts._fields_]
    assert ctypes.sizeof(cuda_pairs.PairConsts) == 4 * len(names)
    params, part, _ = T.build_scene(
        T.SimConfig(config_dict=small_scene_dict()), device="cpu")
    c = cuda_pairs.pair_consts(params)
    assert c.n_real == params.n_fluid + params.n_solid
    assert (c.nx, c.ny, c.nz) == params.grid_num
    # the kernel checks refuse CPU tensors
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_pairs._check_common(None, part, params)
