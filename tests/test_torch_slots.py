"""The port's slot engine (``--backend pallas_slots``) against the JAX
package, on the CPU.

The slot map must equal the JAX ``SlotEngine.prepare`` gather map slot for
slot, with the same diagnostics, on a clumped scene that fills a second
layer and on one whose clump overflows the four layers.  The plain slot
engine's neighbour lists must equal the cell-run lists bitwise (when no
cell overflows, and at cell_cap = 8 * slot_layers when one does).  WCSPH
steps under the slot backend must match the JAX package's gather engine at
the engine-equivalence tolerance (atol 2e-5, rtol 2e-4), as the JAX
package's own tests/test_pallas_slots.py holds its slot engine (the other
solvers: tests/test_torch_slot_solvers.py).  The engine choice follows the
JAX package's ``--backend`` names.
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
from sph_taichi_torch.ops import slots as tslots
from sph_taichi_torch.ops.neighbors import build_neighbor_list
from sph_taichi_torch.ops.pairs import GatherEngine, make_engine
from sph_taichi_torch.utils.profiling import FATAL_KEYS, check_overflow

from conftest import _clumped_positions, small_scene_dict
from test_golden import _two_way_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 2e-4


def _clumped(scene, kind):
    """Scene params and particles (both packages' arrays) with clumped
    positions: "layers" has a 20-particle cell (three of the four layers),
    "overflow" also a 40-particle cell (beyond 8 * 4 slots)."""
    cfg = T.SimConfig(config_dict=scene)
    params, part, _ = T.build_scene(cfg, device="cpu")
    x = _clumped_positions(np.random.default_rng(0), params, part)
    if kind == "overflow":
        c0 = np.array([6, 6, 6]) * params.grid_size \
            + 0.05 * params.grid_size
        x[40:80] = (c0 + np.random.default_rng(1).uniform(
            0, 0.9 * params.grid_size, (40, 3))).astype(np.float32)
    return cfg, params, part._replace(x=torch.from_numpy(x))


def _sorted(part, params):
    """Port: sorted particles and cell offsets."""
    p, ctx, _ = tbase.bin_and_sort(part, params, GatherEngine(params))
    starts = tbase.cell_offsets(
        tbase.compute_cell_ids(p.x, p.material, params.grid_size,
                               params.grid_num), params.num_cells)
    return p, starts


@pytest.mark.parametrize("kind", ["layers", "overflow"])
def test_slot_map_matches_jax(kind):
    from sph_taichi_tpu.models.base import bin_and_sort as jbin_and_sort
    from sph_taichi_tpu.ops.pairs import make_engine as jmake_engine

    cfg, tp, tpart = _clumped(small_scene_dict(), kind)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=cfg.config))
    jp = dataclasses.replace(jp, backend="pallas_slots", slot_layers=4)
    jpart = jpart._replace(x=jpart.x.at[:].set(tpart.x.numpy()))
    _, jctx, jdiag = jbin_and_sort(jpart, jp, jmake_engine(jp))

    p, starts = _sorted(tpart, tp)
    smap = tslots.build_slot_map(starts, tp)
    nx, ny, nz = tp.grid_num
    eng = jmake_engine(jp)
    jmap = np.asarray(jctx.dense_idx).reshape(
        4, eng.nx2, eng.ny2, eng.nzs)[:, 1:nx + 1, 1:ny + 1, 8:(nz + 1) * 8]
    jmap = np.where(jmap == tp.n_pad, -1, jmap)
    assert smap.idx.dtype == torch.int32
    np.testing.assert_array_equal(smap.idx.numpy(), jmap)
    for k in ("max_cell_occupancy_engine", "max_layers_used",
              "slot_overflow"):
        assert int(smap.diag[k]) == int(jdiag[k]), k
    assert int(smap.diag["max_layers_used"]) >= 2
    assert bool(smap.diag["slot_overflow"]) == (kind == "overflow")
    # the map holds every sorted row at most once
    held = smap.idx[smap.idx >= 0]
    assert held.unique().numel() == held.numel()


@pytest.mark.parametrize("kind", ["layers", "overflow"])
def test_slot_lists_equal_cell_lists(kind):
    """Without an overflow the slot lists are the cell-run lists, bitwise;
    with one they drop what a cell cap of 8 * slot_layers drops."""
    _, tp, tpart = _clumped(small_scene_dict(), kind)
    tp = dataclasses.replace(tp, neighbor_cap=256)
    p, starts = _sorted(tpart, tp)
    sl = tslots.slot_neighbor_list(tslots.build_slot_map(starts, tp), p.x,
                                   tp)
    cl = build_neighbor_list(p.x, starts, tp.grid_num, tp.grid_size,
                             tp.support_radius, tp.neighbor_cap,
                             8 * tp.slot_layers)
    assert not bool(sl.diag["neighbor_overflow"])
    assert torch.equal(sl.cnt, cl.cnt)
    assert torch.equal(sl.idx * sl.mask(), cl.idx * cl.mask())
    assert int(sl.cell_overflow) == int(cl.cell_overflow) == \
        (kind == "overflow")
    if kind == "layers":
        full = build_neighbor_list(p.x, starts, tp.grid_num, tp.grid_size,
                                   tp.support_radius, tp.neighbor_cap, 64)
        assert torch.equal(sl.idx, full.idx)
        assert torch.equal(sl.cnt, full.cnt)


def _jax_state(scene):
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=scene))
    jsolver = J.build_solver(jp)
    return jsolver, jsolver.initialize(jpart)


def _to_torch(js):
    return convert.state_from_numpy(
        {k: np.asarray(v) for k, v in js.p._asdict().items()
         if v is not None},
        np.asarray(js.rigid_rest_cm), np.asarray(js.dt), np.asarray(js.t),
        np.asarray(js.step_count), "cpu")


@pytest.mark.parametrize("scene", ["small", "two_way"])
def test_wcsph_slots_matches_jax_gather(scene):
    """Two WCSPH steps under the slot backend (plain slot engine) from the
    JAX package's initial state, each held index by index against the JAX
    gather engine's step from the same state."""
    d = {"small": small_scene_dict, "two_way": _two_way_scene}[scene]()
    jsolver, js = _jax_state(d)
    tp = T.build_scene(T.SimConfig(config_dict=d), device="cpu")[0]
    tp = dataclasses.replace(tp, backend="pallas_slots")
    tsolver = T.build_solver(tp, device="cpu")
    assert isinstance(tsolver.engine, tslots.SlotGatherEngine)
    for _ in range(2):
        ts = _to_torch(js)
        js, _ = jsolver.step(js)
        ts, tm = tsolver.step(ts)
        assert not bool(tm["slot_overflow"])
        assert int(tm["max_layers_used"]) >= 1
        real = np.asarray(js.p.material) != -1
        for name in ("x", "v", "density", "pressure", "acc", "m_V"):
            np.testing.assert_allclose(
                getattr(ts.p, name).numpy()[real],
                np.asarray(getattr(js.p, name))[real], atol=ATOL, rtol=RTOL,
                err_msg=name)


def test_wcsph_slots_equal_cell_run_bitwise():
    """Without an overflow the slot backend's steps are the default
    backend's, bit for bit (the same pairs in the same order)."""
    d = _two_way_scene()
    params, part, _ = T.build_scene(T.SimConfig(config_dict=d), device="cpu")
    states = []
    for backend in ("auto", "pallas_slots"):
        solver = T.build_solver(dataclasses.replace(params, backend=backend),
                                device="cpu")
        s = solver.initialize(part)
        for _ in range(3):
            s, _ = solver.step(s)
        states.append(s)
    for name in ("x", "v", "density", "pressure", "m_V"):
        assert torch.equal(getattr(states[0].p, name),
                           getattr(states[1].p, name)), name


def test_slot_overflow_is_fatal():
    _, tp, tpart = _clumped(small_scene_dict(), "overflow")
    solver = T.build_solver(dataclasses.replace(tp, backend="pallas_slots"),
                            device="cpu")
    _, metrics = solver.step(solver.initialize(tpart))
    assert "slot_overflow" in FATAL_KEYS
    assert bool(metrics["slot_overflow"])
    with pytest.raises(RuntimeError, match="slot_overflow"):
        check_overflow(metrics, strict=True)


@pytest.mark.parametrize("backend,cuda,engine", [
    ("auto", False, "GatherEngine"), ("pallas_blocks", False, "GatherEngine"),
    ("gather", False, "GatherEngine"),
    ("pallas_slots", False, "SlotGatherEngine"),
    ("auto", True, "CudaEngine"), ("pallas_blocks", True, "CudaEngine"),
    ("pallas_slots", True, "CudaSlotEngine")])
def test_make_engine_by_backend(backend, cuda, engine):
    params = T.build_scene(T.SimConfig(config_dict=small_scene_dict()),
                           device="cpu")[0]
    params = dataclasses.replace(params, backend=backend)
    eng = make_engine(params, "cuda" if cuda else "cpu")
    assert type(eng).__name__ == engine
    assert eng.fused == cuda


def test_gather_raises_on_a_cuda_device(monkeypatch):
    params = T.build_scene(T.SimConfig(config_dict=small_scene_dict()),
                           device="cpu")[0]
    params = dataclasses.replace(params, backend="gather")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="gather"):
        T.build_solver(params, device="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        make_engine(dataclasses.replace(params, backend="pallas"), "cpu")


@pytest.mark.parametrize("method,solver", [(1, "PCISPHSolver"),
                                           (2, "IISPHSolver"),
                                           (4, "DFSPHSolver")])
def test_slots_build_every_method(method, solver):
    """Under the slot backend every solver is built, on the plain slot
    engine on the CPU (tests/test_torch_slot_solvers.py steps them)."""
    params = T.build_scene(T.SimConfig(config_dict=small_scene_dict(
        method=method)), device="cpu")[0]
    built = T.build_solver(dataclasses.replace(params,
                                               backend="pallas_slots"),
                           device="cpu")
    assert type(built).__name__ == solver
    assert isinstance(built.engine, tslots.SlotGatherEngine)


def test_cli_backend(tmp_path, capsys):
    from sph_taichi_torch import run_simulation

    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(small_scene_dict()))
    run_simulation.main(["--scene_file", str(scene), "--max_frames", "2",
                         "--device", "cpu", "--backend", "pallas_slots",
                         "--output_dir", str(tmp_path / "out")])
    assert "backend: pallas_slots" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_simulation.main(["--scene_file", str(scene), "--backend",
                             "pallas"])


def test_cli_backend_with_dfsph(tmp_path, capsys):
    """``--backend pallas_slots --method 4``: two DFSPH frames."""
    from sph_taichi_torch import run_simulation

    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(small_scene_dict()))
    run_simulation.main(["--scene_file", str(scene), "--max_frames", "2",
                         "--device", "cpu", "--backend", "pallas_slots",
                         "--method", "4", "--output_dir",
                         str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "method: 4  backend: pallas_slots" in out
    assert "frame 2" in out and "iterations/step divergence" in out
