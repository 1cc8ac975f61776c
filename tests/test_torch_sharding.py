"""The port's spatial slab sharding (sph_taichi_torch/parallel) on the CPU.

Four gloo ranks (nxd = 3 on the 10^3 grid of the small scene) are spawned
once for the module (``runs``: parallel/comm.py ``launch`` of
``entry.run_scenarios``, one torch thread per rank, every spawn and join
under LAUNCH_TIMEOUT) and step every scenario below; meanwhile this process
steps the JAX package's single-device solver and the port's own.  Each
case asserts on its scenario:

- counterparts of tests/test_sharding.py's eight cases (its four methods,
  the fast-flow crossing stress, the migration overflow, the moving-rigid
  staleness bound, and its blocks-engine case as the CUDA engine's
  dispatch over CPU tensors);
- methods 0, 1, 2 and 4 on the plain engine and on ``CudaEngine`` over CPU
  tensors against the JAX single-device step and the port's: one step at
  the engine tolerance (x, v and density through a nearest-position
  bijection, conftest._assert_states_close's atol 2e-5 / rtol 2e-4) with
  equal iteration counts, then five steps at x atol 1e-4 and v atol 1e-3;
- the slab layout after ``initialize`` against the JAX ShardedSolver's
  (owned and ghost rows, positions, tags; not m_V, which the JAX package
  sums over the wrong cells, see below);
- world size 1 in this process, the slot engine under WCSPH, and the
  communicator's and the cell lookup's own cases.

``python tests/test_torch_sharding.py`` prints the agreements and the JAX
sharded path's deviation from its own single-device step, for the record:
its gather engine looks up a slab's centres at their global cells in the
slab's local cell offsets.  Nothing asserts on that deviation.
"""

import os
import sys
import threading

if __name__ == "__main__":     # as a script: the repository on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

# first: it sets up the JAX package's 8 CPU devices, also when this file
# runs as a script
from conftest import small_scene_dict

import sph_taichi_tpu as J
import sph_taichi_torch as T
from sph_taichi_torch import convert, entry
from sph_taichi_torch.parallel import comm as pcomm
from sph_taichi_torch.parallel.sharding import ShardedSolver

WORLD = 4
ATOL, RTOL = 2e-5, 2e-4
X_ATOL_5, V_ATOL_5 = 1e-4, 1e-3
METHODS = (0, 1, 2, 4)
ENGINES = ("gather", "cuda")
LAUNCH_TIMEOUT = 300.0
ITER_KEYS = ("pressure_iters", "divergence_iters")


def _crossing_scene(velocity):
    return small_scene_dict(method=0, radius=0.05,
                            block=((0.1, 0.4, 0.1), (0.45, 0.7, 0.45)),
                            velocity=velocity)


def _two_way_scene():
    """tests/test_sharding.py's moving-rigid scene: a falling rigid block
    beside the fluid block."""
    d = small_scene_dict(method=0)
    d["RigidBlocks"] = [{
        "objectId": 1, "start": [0.55, 0.45, 0.25], "end": [0.8, 0.7, 0.5],
        "translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
        "velocity": [0.0, -0.5, 0.0], "density": 500.0,
        "color": [100, 100, 100], "isDynamic": True}]
    return d


def _spec(scene, steps, **kw):
    return dict(scene=scene, steps=steps, mig_cap=128, halo_cap=256, **kw)


SPECS = {}
for _engine in ENGINES:
    for _m in METHODS:
        SPECS[(_engine, _m)] = _spec(
            small_scene_dict(method=_m), 5, record=[1, 5],
            engine=None if _engine == "gather" else _engine)
SPECS["crossing"] = _spec(_crossing_scene((3.0, 0.0, 1.0)), 50,
                          record=[50])
SPECS["overflow"] = dict(_spec(_crossing_scene((3.0, 0.0, 0.0)), 30,
                               stop_on="migration_overflow"), mig_cap=1)
SPECS["two_way"] = _spec(_two_way_scene(), 10, record=[1, 10], slabs=True)
SPECS["slots"] = _spec(small_scene_dict(method=0), 5, record=[1, 5],
                       backend="pallas_slots")


def _iisph_impact_scene():
    """tests/test_torch_iisph.py's floor impact: 59 and 7 iterations in
    the second and third steps, the pressure high across the slab
    boundaries."""
    d = small_scene_dict(method=2, block=((0.1, 0.03, 0.1), (0.5, 0.6, 0.5)),
                         velocity=(0.0, -2.0, 0.0), dt=1e-3)
    d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


SPECS["iisph_impact"] = _spec(_iisph_impact_scene(), 3, record=[1, 2, 3])
SPECS["replicated"] = _spec(small_scene_dict(method=4), 1, record=[1],
                            replicated=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Runs:
    """The module's one launch of the ranks, running in a thread while the
    references are computed here; ``get(name)`` waits for it."""

    def __init__(self):
        self._out = {}
        self._thread = threading.Thread(target=self._go, daemon=True)
        self._thread.start()

    def _go(self):
        try:
            recs = pcomm.launch(entry.run_scenarios, WORLD,
                                args=(list(SPECS.values()),),
                                devices=["cpu"] * WORLD,
                                timeout=LAUNCH_TIMEOUT)[0]
            self._out["recs"] = dict(zip(SPECS, recs))
        except Exception as e:   # re-raised in every case
            self._out["error"] = e

    def get(self, name):
        self._thread.join(LAUNCH_TIMEOUT + 30.0)
        if self._thread.is_alive():
            raise TimeoutError("the sharded ranks did not finish")
        if "error" in self._out:
            raise self._out["error"]
        return self._out["recs"][name]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _real(p):
    """numpy dict of the real rows of a state's particles (JAX or port)."""
    out = {}
    real = np.asarray(p.material) >= 0
    for f, a in p._asdict().items():
        if a is not None:
            a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
            out[f] = a[real]
    return out


def _iters(metrics):
    return {k: int(np.asarray(metrics[k])) for k in ITER_KEYS
            if k in metrics}


def _jax_steps(scene, steps, record):
    params, particles, _ = J.build_scene(J.SimConfig(config_dict=scene))
    solver = J.build_solver(params)
    state = solver.initialize(particles)
    out = {}
    for i in range(1, steps + 1):
        state, m = solver.step(state)
        if i in record:
            out[i] = (_real(state.p), _iters(m))
    return out


def _port_steps(scene, steps, record, engine=None, backend=None):
    import dataclasses

    params, particles, _ = T.build_scene(T.SimConfig(config_dict=scene),
                                         device="cpu")
    if backend:
        params = dataclasses.replace(params, backend=backend)
    eng = entry._engine_factory(engine)
    solver = T.build_solver(params, device="cpu",
                            engine=None if eng is None else eng(params))
    state = solver.initialize(particles)
    out = {}
    for i in range(1, steps + 1):
        state, m = solver.step(state)
        if i in record:
            out[i] = (_real(state.p), _iters(m))
    return out


@pytest.fixture(scope="module")
def jax_single():
    """The JAX single-device steps of each method (gather engine): step 1
    and step 5."""
    return {m: _jax_steps(small_scene_dict(method=m), 5, (1, 5))
            for m in METHODS}


@pytest.fixture(scope="module")
def port_single():
    """The port's single-device steps of each (engine, method)."""
    out = {(e, m): _port_steps(small_scene_dict(method=m), 5, (1, 5),
                               engine=None if e == "gather" else e)
           for e in ENGINES for m in METHODS}
    out["two_way"] = _port_steps(_two_way_scene(), 10, (1, 10))
    out["iisph_impact"] = _port_steps(_iisph_impact_scene(), 3, (1, 2, 3))
    out["slots"] = _port_steps(small_scene_dict(method=0), 5, (1, 5),
                               backend="pallas_slots")
    return out


def _match(ref, got, atol, rtol=0.0, fields=("x", "v", "density")):
    """Nearest-position bijection of ``got`` onto ``ref`` (numpy dicts of
    the real particles), then each field within atol + rtol |ref|
    (``entry.match_states``).  Returns {field: largest difference}."""
    return entry.match_states(ref, got, {f: atol for f in fields}, rtol)


def _no_overflow(rec):
    for i, m in enumerate(rec["metrics"]):
        assert m["migration_overflow"] == 0, f"step {i + 1}"
        assert m["halo_overflow"] == 0, f"step {i + 1}"


def _check_against(ref, rec):
    """One step at the engine tolerance with equal iteration counts, five
    at x 1e-4 and v 1e-3."""
    _no_overflow(rec)
    (r1, it1), (r5, _) = ref[1], ref[5]
    _match(r1, rec["states"][1], ATOL, RTOL)
    got_it = {k: int(v) for k, v in rec["metrics"][0].items()
              if k in ITER_KEYS}
    assert got_it == it1
    _match(r5, rec["states"][5], X_ATOL_5, fields=("x",))
    _match(r5, rec["states"][5], V_ATOL_5, fields=("v",))


# ---------------------------------------------------------------------------
# against the single-device steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("method", METHODS)
def test_sharded_matches_jax_single_device(runs, jax_single, engine,
                                           method):
    """tests/test_sharding.py's four methods, held against the JAX
    single-device step at the engine tolerance."""
    _check_against(jax_single[method], runs.get((engine, method)))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("method", METHODS)
def test_sharded_matches_port_single_device(runs, port_single, engine,
                                            method):
    _check_against(port_single[(engine, method)], runs.get((engine, method)))


def test_sharded_cuda_engine_launches_nothing_on_the_cpu(runs):
    """tests/test_sharding.py's blocks-engine case: the CUDA engine's
    dispatch under sharding, its wrappers on CPU tensors taking their
    plain versions (above), no kernel launched."""
    for m in METHODS:
        rec = runs.get(("cuda", m))
        assert all(not counts for r in rec["ranks"]
                   for counts in r["launches"])
        assert rec["ranks"][0]["collectives"][0] > 0


def test_replicated_initialize_matches_single_device(runs, port_single):
    """``initialize_replicated`` (the single-device initialize, then each
    rank's slab of it): its first step is the single-device step."""
    rec = runs.get("replicated")
    _no_overflow(rec)
    ref, it = port_single[("gather", 4)][1]
    _match(ref, rec["states"][1], ATOL, RTOL)
    assert {k: int(v) for k, v in rec["metrics"][0].items()
            if k in ITER_KEYS} == it


def test_sharded_slot_engine_matches_single_device(runs, jax_single,
                                                   port_single):
    rec = runs.get("slots")
    _check_against(jax_single[0], rec)
    _check_against(port_single["slots"], rec)
    assert all(m["slot_overflow"] == 0 for m in rec["metrics"])


def _sorted_rows(state):
    """(n, 8) rows of x, v, density and pressure in lexicographic order:
    the floor impact's box clamp stacks particles on one point, which a
    nearest-position match cannot tell apart."""
    m = np.concatenate([state["x"], state["v"], state["density"][:, None],
                        state["pressure"][:, None]], axis=1)
    return m[np.lexsort(m.T[::-1])]


def test_sharded_iisph_impact_iterates_like_single_device(runs,
                                                         port_single):
    """The IISPH pressure solve iterating across the slab boundaries (59
    iterations in the second step): each of three steps at the engine
    tolerance with equal iterations.  It needs the ghost refresh of the
    pressure acceleration that A reads at neighbours."""
    rec = runs.get("iisph_impact")
    _no_overflow(rec)
    for step in (1, 2, 3):
        ref, it = port_single["iisph_impact"][step]
        a, b = _sorted_rows(ref), _sorted_rows(rec["states"][step])
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {step}")
        assert int(rec["metrics"][step - 1]["pressure_iters"]) == \
            it["pressure_iters"]
    assert port_single["iisph_impact"][2][1]["pressure_iters"] > 10


# ---------------------------------------------------------------------------
# the capacity machinery
# ---------------------------------------------------------------------------

def test_sharded_fast_flow_crossing_stress(runs):
    """Particles with a strong x velocity cross slab boundaries for 50
    steps: every particle kept, no capacity flag, the state finite and in
    the padded box."""
    rec = runs.get("crossing")
    _no_overflow(rec)
    params = T.build_scene(T.SimConfig(config_dict=SPECS["crossing"]
                                       ["scene"]), device="cpu")[0]
    got = rec["states"][50]
    x = got["x"]
    assert x.shape[0] == params.n_particles
    assert np.isfinite(x).all() and np.isfinite(got["v"]).all()
    pad = params.padding
    size = np.asarray(params.domain_size)
    assert (x >= pad - 1e-4).all() and (x <= size - pad + 1e-4).all()
    # particles did cross: the migration blocks carried rows
    assert max(m["owned_particles_max"] for m in rec["metrics"]) > 0


def test_sharded_migration_overflow_is_loud(runs):
    """mig_cap = 1: the overflow flag fires (silent loss is what it
    guards)."""
    rec = runs.get("overflow")
    assert rec["metrics"][-1]["migration_overflow"] > 0, (
        "migration overflow never flagged despite mig_cap=1")


def test_sharded_moving_rigid_ghost_staleness_bound(runs, port_single):
    """tests/test_sharding.py's bound on the moving rigid's ghost volumes
    after 10 steps (within a particle radius, 0.1 m/s), and here the
    five-step tolerance: the slab step refreshes the ghosts' m_V right
    after the moving volumes, so nothing is a step late."""
    rec = runs.get("two_way")
    _no_overflow(rec)
    ref, _ = port_single["two_way"][10]
    got = rec["states"][10]
    radius = SPECS["two_way"]["scene"]["Configuration"]["particleRadius"]
    _match(ref, got, radius, fields=("x",))
    _match(ref, got, 0.1, fields=("v",))
    _match(ref, got, X_ATOL_5, fields=("x",))
    _match(ref, got, V_ATOL_5, fields=("v",))
    _match(port_single["two_way"][1][0], rec["states"][1], ATOL, RTOL,
           fields=("x", "v", "density", "m_V"))


def test_slab_layout_matches_jax_sharded_initialize(runs):
    """Each rank's rows after ``initialize`` against the JAX ShardedSolver's
    segment (4 virtual devices, the same capacities): the same owned and
    ghost rows in the same order, positions and tags equal.  m_V is not
    compared (the JAX sharded volumes sum over the wrong cells)."""
    from sph_taichi_tpu.parallel.sharding import ShardedSolver as JSharded

    spec = SPECS["two_way"]
    params, particles, _ = J.build_scene(J.SimConfig(
        config_dict=spec["scene"]))
    jsh = JSharded(params, n_devices=WORLD, mig_cap=spec["mig_cap"],
                   halo_cap=spec["halo_cap"], loc_cap=params.n_pad)
    jstate = jsh.initialize(particles)
    jslabs = convert.sharded_segments_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in jstate.p._asdict().items()}, WORLD, "cpu")
    rec = runs.get("two_way")
    assert rec["n_ext"] == jsh.n_ext
    slabs = rec["slabs"]
    ghosts = 0
    for d, (js, ts) in enumerate(zip(jslabs, slabs)):
        for f in ("material", "is_dynamic", "object_id", "x", "x0", "v"):
            np.testing.assert_array_equal(ts[f], js._asdict()[f].numpy(),
                                          err_msg=f"rank {d} field {f}")
        ghosts += int((ts["is_dynamic"] < 0).sum())
    assert ghosts > 0, "no ghost rows: the scene does not cross a slab"
    back = convert.sharded_segments_to_numpy(slabs)
    np.testing.assert_array_equal(back["x"], np.asarray(jstate.p.x))


# ---------------------------------------------------------------------------
# one rank, the communicator, the cell lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", [0, 4])
def test_world_size_one_matches_single_device(method):
    """A world of one rank in this process (gloo): the slab is the whole
    grid with x_origin -1, and two steps equal the single-device steps."""
    scene = small_scene_dict(method=method)
    params, particles, _ = T.build_scene(T.SimConfig(config_dict=scene),
                                         device="cpu")
    ref = _port_steps(scene, 2, (2,))[2][0]
    with pcomm.single() as comm:
        sh = ShardedSolver(params, comm, mig_cap=128, halo_cap=512,
                           loc_cap=params.n_pad, device="cpu")
        assert sh.local_params.x_origin == -1
        assert sh.local_params.grid_num == (params.grid_num[0] + 2,
                                            *params.grid_num[1:])
        state = sh.initialize(particles)
        for _ in range(2):
            state, m = sh.step(state)
        got = _real(sh.owned_rows(state))
    # the kernels take contiguous fields
    assert all(a.is_contiguous() for a in state.p if a is not None)
    assert m["halo_overflow"] == 0 and m["migration_overflow"] == 0
    _match(ref, got, ATOL, RTOL, fields=("x", "v", "density", "pressure"))


def test_ghost_sync_refreshes_ghost_rows_contiguously():
    """The ghost sync over a ring whose hop hands back this rank's own
    block: the ghost rows take the boundary layers' values, the owned rows
    keep theirs, and every field comes back contiguous in its shape."""
    scene = small_scene_dict(method=0)
    params, particles, _ = T.build_scene(T.SimConfig(config_dict=scene),
                                         device="cpu")
    comm = pcomm.Comm(0, 2)
    comm.hop = lambda block, direction: block
    sh = ShardedSolver(params, comm, mig_cap=128, halo_cap=256,
                       loc_cap=params.n_pad, device="cpu")
    n, lc = sh.n_ext, sh.layer_cells
    # rows 0-2 are left ghosts, 3-9 owned, 10-11 right ghosts; the owned
    # first layer starts at row 3, the last at row 7
    starts = torch.zeros(sh.num_cells_ext + 2, dtype=torch.int32)
    starts[lc:] = 3
    starts[sh.nxd * lc:] = 7
    starts[(sh.nxd + 1) * lc:] = 10
    starts[(sh.nxd + 2) * lc:] = 12
    sync = sh._make_ghost_sync(starts)
    rho = torch.arange(n, dtype=torch.float32)
    v = torch.arange(3 * n, dtype=torch.float32).reshape(n, 3)
    rho2, v2 = sync([rho, v])
    assert rho2.is_contiguous() and v2.is_contiguous()
    assert v2.shape == v.shape
    np.testing.assert_array_equal(rho2[:3].numpy(), [7, 8, 9])
    np.testing.assert_array_equal(rho2[3:10].numpy(), rho[3:10].numpy())
    np.testing.assert_array_equal(rho2[10:12].numpy(), [3, 4])
    np.testing.assert_array_equal(v2[:3].numpy(), v[7:10].numpy())


def test_hop_is_the_identity_at_world_size_one():
    comm = pcomm.Comm(0, 1, "gloo")
    block = torch.arange(12.0).reshape(4, 3)
    assert comm.hop(block, +1) is block and comm.hop(block, -1) is block
    assert comm.psum(block) is block and comm.pmax(block) is block
    assert comm.calls == 0


def test_launch_refuses_two_nccl_ranks_on_one_device():
    with pytest.raises(ValueError, match="one rank per device"):
        pcomm.launch(entry.run_scenarios, 2, args=([],), backend="nccl",
                     devices=["cuda:0", "cuda:0"])


def test_failed_rank_reports_its_traceback(tmp_path):
    """A rank's body (run here as a world of one, not spawned) that raises
    writes its traceback where ``launch`` reads it, and the launcher's
    reading of it names the rank."""
    bad = [{"scene": small_scene_dict(method=3), "steps": 1}]
    store = str(tmp_path / "store")
    pcomm._rank_main(0, 1, "gloo", ["cpu"], store, 60.0,
                     entry.run_scenarios, (bad,))
    status, text = pcomm._read_result(str(tmp_path), 0)
    assert status == "error" and "Solver type 3" in text


def test_cell_lookup_takes_the_origin_and_owners_clip_padding():
    """pos_to_cell less the origin in x only; the owner of a padding row
    parked at 1e9 is clipped to the last rank, not read from an undefined
    int32."""
    from sph_taichi_torch.ops.grid import pos_to_cell
    from sph_taichi_torch.parallel.sharding import owner_of

    x = torch.tensor([[0.25, 0.35, 0.45], [0.05, 0.95, 0.5]])
    np.testing.assert_array_equal(pos_to_cell(x, 0.1).numpy(),
                                  [[2, 3, 4], [0, 9, 5]])
    np.testing.assert_array_equal(pos_to_cell(x, 0.1, 5).numpy(),
                                  [[-3, 3, 4], [-5, 9, 5]])
    params = T.build_scene(T.SimConfig(config_dict=small_scene_dict()),
                           device="cpu")[0]
    x0 = torch.tensor([0.05, 0.35, 0.95, 1e9, -0.01])
    np.testing.assert_array_equal(owner_of(x0, params, 3, 4).numpy(),
                                  [0, 1, 3, 3, 0])
    np.testing.assert_array_equal(owner_of(x0.numpy(), params, 3, 4),
                                  [0, 1, 3, 3, 0])


def test_sharding_flags_are_fatal():
    from sph_taichi_torch.utils import profiling

    assert {"migration_overflow", "halo_overflow"} <= set(
        profiling.FATAL_KEYS)
    with pytest.raises(RuntimeError, match="halo_overflow"):
        profiling.check_overflow({"halo_overflow": torch.tensor(1)},
                                 strict=True)


def test_slab_solver_refuses_a_direct_step():
    """A slab's solver stepped without its ShardedSolver would run no
    ghost sync and no reduction."""
    scene = small_scene_dict(method=0)
    params, particles, _ = T.build_scene(T.SimConfig(config_dict=scene),
                                         device="cpu")
    sh = ShardedSolver(params, pcomm.Comm(0, 1), loc_cap=params.n_pad,
                       mig_cap=128, halo_cap=512, device="cpu")
    state = T.build_solver(params, device="cpu").initialize(particles)
    with pytest.raises(ValueError, match="ShardedSolver"):
        sh.solver.step(state)


# ---------------------------------------------------------------------------
# for the record: python tests/test_torch_sharding.py
# ---------------------------------------------------------------------------

def _jax_sharded_deviation(n_devices):
    """The JAX ShardedSolver's DFSPH step of the small scene against its
    own single-device step: (density, dfsph_factor) max |difference|
    through a nearest-position match."""
    from sph_taichi_tpu.parallel.sharding import ShardedSolver as JSharded

    params, particles, _ = J.build_scene(J.SimConfig(
        config_dict=small_scene_dict(method=4)))
    single = J.build_solver(params)
    s, _ = single.step(single.initialize(particles))
    sh = JSharded(params, n_devices=n_devices, mig_cap=128, halo_cap=512,
                  loc_cap=params.n_pad)
    g, _ = sh.step(sh.initialize(particles))
    ref, got = _real(s.p), _real(sh.gather_particles(g))
    _, idx = cKDTree(got["x"]).query(ref["x"], k=1)
    return tuple(float(np.max(np.abs(ref[f] - got[f][idx])))
                 for f in ("density", "dfsph_factor"))


def main():
    runs = _Runs()
    jax_ref = {m: _jax_steps(small_scene_dict(method=m), 5, (1, 5))
               for m in METHODS}
    for e in ENGINES:
        for m in METHODS:
            rec = runs.get((e, m))
            (r1, it1), (r5, _) = jax_ref[m][1], jax_ref[m][5]
            d1 = _match(r1, rec["states"][1], ATOL, RTOL)
            d5 = entry.match_states(r5, rec["states"][5],
                                    {"x": X_ATOL_5, "v": V_ATOL_5})
            print(f"{WORLD} ranks, engine {e}, method {m}: against the JAX "
                  f"single-device step, step 1 {d1}, iterations {it1}; "
                  f"step 5 {d5}; collectives per step on rank 0 "
                  f"{rec['ranks'][0]['collectives']}")
    print("the JAX ShardedSolver's DFSPH step against its single-device "
          "step (density, dfsph_factor max |difference|):")
    for n in (1, 4, 8):
        print(f"  {n} devices: {_jax_sharded_deviation(n)}")


if __name__ == "__main__":
    sys.exit(main())
