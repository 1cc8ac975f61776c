"""The boundary-volume traversal (TPU kernel 2.1 c) of the port against the
JAX package, on the CPU.

The CUDA engines compute the Akinci volumes by a pair traversal in
``initialize`` and, with dynamic rigids, in every step, at every solid
count; the plain engines do so only above DENSE_SOLID_CAP solids and take
the dense sum below it, as the JAX package does (models/base.py
``_boundary_volume``).  Its plain version must equal
the JAX package's traversal (gather backend) and the port's dense path at
rtol 2e-6 (a port of tests/test_physics.py
test_boundary_volume_dense_matches_engine), and whole steps taken through it
must match the JAX package's at the engine-equivalence tolerance (atol
2e-5, rtol 2e-4), with DENSE_SOLID_CAP set to 0 in both packages, and so
must the CUDA engine's steps over CPU tensors against the JAX package's
dense path.  The
scene that reaches it on the card, dragon_bath_dynamic_dfsph with the
dragon scaled by 1.25, must build the same arrays in both packages.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import sph_taichi_tpu as J
import sph_taichi_torch as T
from sph_taichi_torch import convert
from sph_taichi_torch.models import base as tbase
from sph_taichi_torch.ops import cuda_pairs
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.ops.slots import SlotGatherEngine, build_slot_map

from conftest import small_scene_dict
from test_torch_wcsph import _assert_scene_equal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4


def _rigid_scene(method=0):
    """The small fluid block, test_physics.py's dynamic rigid block beside
    it, and a static rigid block below that."""
    d = small_scene_dict(method=method)
    block = {"translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
             "velocity": [0.0, 0.0, 0.0], "density": 500.0,
             "color": [100, 100, 100]}
    d["RigidBlocks"] = [
        dict(block, objectId=1, start=[0.55, 0.45, 0.25],
             end=[0.8, 0.7, 0.5], isDynamic=True),
        dict(block, objectId=2, start=[0.55, 0.1, 0.55],
             end=[0.9, 0.3, 0.9], isDynamic=False)]
    return d


def _mask(p, which):
    return p.is_dynamic_rigid() if which == "dynamic" else p.is_static_rigid()


@pytest.mark.parametrize("which", ["static", "dynamic"])
def test_boundary_volume_engine_matches_jax_and_dense(which):
    from sph_taichi_tpu.models import base as jbase

    d = _rigid_scene()
    params, part, _ = T.build_scene(T.SimConfig(config_dict=d), device="cpu")
    assert 0 < params.n_solid <= tbase.DENSE_SOLID_CAP
    engine = GatherEngine(params)
    p, nl, _ = tbase.bin_and_sort(part, params, engine)
    tgt = _mask(p, which)
    assert bool(tgt.any()) and not bool(tgt.all())
    pe = tbase._boundary_volume_engine(p, nl, engine, params, tgt)
    pd = tbase._boundary_volume_dense(p, params, tgt)

    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=d))
    jsolver = J.build_solver(jp)
    jq, jctx, _ = jbase.bin_and_sort(jpart, jp, jsolver.engine)
    np.testing.assert_array_equal(p.x.numpy(), np.asarray(jq.x))
    jmask = _mask(jq, which)
    je = jbase._boundary_volume_engine(jq, jctx, jsolver.engine, jp, jmask)

    t = tgt.numpy()
    np.testing.assert_allclose(pe.m_V.numpy()[t], np.asarray(je.m_V)[t],
                               rtol=2e-6)
    np.testing.assert_allclose(pe.m_V.numpy()[t], pd.m_V.numpy()[t],
                               rtol=2e-6)
    # non-target rows untouched
    for q in (pe, pd):
        assert torch.equal(q.m_V[~tgt], p.m_V[~tgt])
    # the kernel wrapper's CPU branch over either walk: the same numbers
    starts = tbase.cell_offsets(
        tbase.compute_cell_ids(p.x, p.material, params.grid_size,
                               params.grid_num), params.num_cells)
    for ctx in (starts, build_slot_map(starts, params)):
        assert torch.equal(cuda_pairs.boundary_volume(ctx, p, tgt, params),
                           pe.m_V)


def test_target_rows():
    rng = np.random.default_rng(0)
    mask = torch.from_numpy(rng.random(300) < 0.2)
    cap = int(mask.sum()) + 7
    rows = cuda_pairs.target_rows(mask, cap)
    assert rows.dtype == torch.int32 and rows.shape == (cap,)
    want = torch.nonzero(mask).flatten().to(torch.int32)
    assert torch.equal(rows[:want.numel()], want)
    assert bool((rows[want.numel():] == -1).all())
    assert cuda_pairs.target_rows(torch.zeros(5, dtype=torch.bool),
                                  3).tolist() == [-1, -1, -1]


def _dense_raises(monkeypatch, module):
    def dense(*args, **kwargs):
        raise AssertionError("the dense boundary-volume path ran")

    monkeypatch.setattr(module, "_boundary_volume_dense", dense)


def _forbid_dense(monkeypatch, module):
    monkeypatch.setattr(module, "DENSE_SOLID_CAP", 0)
    _dense_raises(monkeypatch, module)


@pytest.mark.parametrize("method, fused", [(0, False), (4, False),
                                           (0, True), (4, True)],
                         ids=["0", "4", "cuda-engine-0", "cuda-engine-4"])
def test_steps_through_the_traversal_match_jax(method, fused, monkeypatch):
    """initialize and three steps with the boundary volumes taken by the
    traversal, each step from the JAX state, index by index (m_V of the
    solid rows at rtol 2e-6).  Either DENSE_SOLID_CAP is patched to 0 in
    both packages (before the JAX solver is built, since its programs read
    it when traced), or (``fused``) the port's solver runs on
    ``CudaEngine`` over CPU tensors with the cap as it is, where the
    dispatch takes the traversal at every solid count (its wrapper's plain
    version, no launch), against the JAX package's own path below the cap,
    the dense sum.  The dense path is patched to raise in the port."""
    from sph_taichi_tpu.models import base as jbase

    if fused:
        _dense_raises(monkeypatch, tbase)
    else:
        _forbid_dense(monkeypatch, jbase)
        _forbid_dense(monkeypatch, tbase)
    d = _rigid_scene(method)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=d))
    jsolver = J.build_solver(jp)
    js = jsolver.initialize(jpart)
    tp, tpart, _ = T.build_scene(T.SimConfig(config_dict=d), device="cpu")
    # below the cap: only the fused engine's dispatch takes the traversal
    assert 0 < tp.n_solid <= (tbase.DENSE_SOLID_CAP if fused else 1 << 30)
    engine = cuda_pairs.CudaEngine(tp) if fused else None
    tsolver = T.build_solver(tp, device="cpu", engine=engine)
    assert tsolver.engine.fused == fused
    before = dict(cuda_pairs.LAUNCHES)
    ts = tsolver.initialize(tpart)
    solid = np.asarray(js.p.material) == 0
    np.testing.assert_allclose(ts.p.m_V.numpy()[solid],
                               np.asarray(js.p.m_V)[solid], rtol=2e-6)
    for _ in range(3):
        ts = convert.state_from_numpy(
            {k: np.asarray(v) for k, v in js.p._asdict().items()
             if v is not None},
            np.asarray(js.rigid_rest_cm), np.asarray(js.dt),
            np.asarray(js.t), np.asarray(js.step_count), "cpu")
        js, _ = jsolver.step(js)
        ts, _ = tsolver.step(ts)
        real = np.asarray(js.p.material) != -1
        for name in ("x", "v", "density", "m_V"):
            np.testing.assert_allclose(
                getattr(ts.p, name).numpy()[real],
                np.asarray(getattr(js.p, name))[real], atol=ATOL,
                rtol=RTOL, err_msg=name)
        solid = np.asarray(js.p.material) == 0
        np.testing.assert_allclose(ts.p.m_V.numpy()[solid],
                                   np.asarray(js.p.m_V)[solid], rtol=2e-6)
    assert cuda_pairs.LAUNCHES == before


@pytest.mark.parametrize("backend", ["gather", "pallas_slots"])
def test_plain_engines_take_the_dense_path_below_the_cap(backend,
                                                         monkeypatch):
    """The plain engines (``GatherEngine``; ``SlotGatherEngine`` under
    ``pallas_slots``) keep the dense path below DENSE_SOLID_CAP, as the
    JAX package does: with the traversal patched to raise, ``initialize``
    takes the dense path twice (the static and the moving volumes) and a
    step once (the dynamic rigid's), and the state keeps the volumes of
    the last dense call."""
    d = _rigid_scene()
    tp, tpart, _ = T.build_scene(T.SimConfig(config_dict=d), device="cpu")
    tp = dataclasses.replace(tp, backend=backend)
    solver = T.build_solver(tp, device="cpu")
    assert type(solver.engine) is {"gather": GatherEngine,
                                   "pallas_slots": SlotGatherEngine}[backend]

    def engine(*args, **kwargs):
        raise AssertionError("the traversal ran on a plain engine")

    calls = []
    dense = tbase._boundary_volume_dense

    def counted(p, params, mask):
        out = dense(p, params, mask)
        calls.append((p, mask, out))
        return out

    monkeypatch.setattr(tbase, "_boundary_volume_engine", engine)
    monkeypatch.setattr(tbase, "_boundary_volume_dense", counted)
    state = solver.initialize(tpart)
    assert len(calls) == 2
    assert torch.equal(state.p.m_V, calls[-1][2].m_V)
    state, _ = solver.step(state)
    assert len(calls) == 3
    assert bool(calls[-1][1].any())
    assert torch.equal(state.p.m_V, calls[-1][2].m_V)


def test_scaled_dynamic_dragon_matches_jax():
    """dragon_bath_dynamic_dfsph with the dragon scaled by 1.25: the same
    arrays in both packages, and more solids than the dense path takes."""
    from sph_taichi_tpu.models.base import DENSE_SOLID_CAP as JCAP

    with open("data/scenes/dragon_bath_dynamic_dfsph.json") as f:
        d = json.load(f)
    d["RigidBodies"][0]["scale"] = [1.25, 1.25, 1.25]
    tp = _assert_scene_equal(d)
    assert tbase.DENSE_SOLID_CAP == JCAP
    assert tp.n_solid > tbase.DENSE_SOLID_CAP
    assert (tp.n_fluid, tp.n_solid, tp.grid_num) == (423500, 34058,
                                                      (125, 75, 50))
    assert tp.dynamic_rigid_ids == (1,)
