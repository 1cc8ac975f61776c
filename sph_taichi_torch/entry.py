"""Driver entry points: one WCSPH step on a tiny scene, and a sharded dry run.

Counterparts of ``__graft_entry__.py``'s ``entry`` and ``dryrun_multichip``:

    python -m sph_taichi_torch.entry [--ranks N] [--device cpu]

runs ``entry()``'s step once, then ``dryrun_multichip(N)`` (default 4):
N gloo ranks (parallel/comm.py ``launch``) sharing the CUDA devices, or on
the CPU with ``--device cpu``, step the tiny scene sharded for methods 0,
1, 2 and 4, then a dynamic rigid block beside the fluid for methods 0 and
4, held against the single-device step.  Without a card only ``--device
cpu`` runs; the default raises (state.resolve_device).

``run_scenarios`` is the rank body that the dry run, the tests
(tests/test_torch_sharding.py) and chip_smoke.py spawn: it steps scenarios
given as dicts and returns what rank 0 gathered.
"""

import argparse
import time

import numpy as np
import torch

from sph_taichi_torch.state import resolve_device


def tiny_scene(method=0, radius=0.025, rigid=False):
    """The dry run's scene dict: a falling fluid column in a unit box; with
    ``rigid``, a dynamic rigid block beside it (inside the padded box at
    radius 0.05), so the sharded rigid sums and the ghost volumes run."""
    d = {
        "Configuration": {
            "domainStart": [0.0, 0.0, 0.0],
            "domainEnd": [1.0, 1.0, 1.0],
            "particleRadius": radius,
            "numberOfStepsPerRenderUpdate": 1,
            "density0": 1000,
            "simulationMethod": method,
            "gravitation": [0.0, -9.81, 0.0],
            "timeStepSize": 4e-4 if method == 0 else 4e-3,
            "stiffness": 50000, "exponent": 7,
            "boundaryHandlingMethod": 0,
            "exportFrame": False, "exportPly": False, "exportObj": False,
        },
        "FluidBlocks": [{
            "objectId": 0,
            "start": [0.1, 0.3, 0.1], "end": [0.5, 0.8, 0.5],
            "translation": [0.0, 0.0, 0.0], "scale": [1, 1, 1],
            "velocity": [0.0, -1.0, 0.0], "density": 1000.0,
            "color": [50, 100, 200],
        }],
    }
    if rigid:
        d["RigidBlocks"] = [{
            "objectId": 1,
            "start": [0.55, 0.35, 0.25], "end": [0.8, 0.6, 0.5],
            "translation": [0.0, 0.0, 0.0], "scale": [1, 1, 1],
            "velocity": [0.0, 0.0, 0.0], "density": 800.0,
            "color": [120, 120, 120], "isDynamic": True,
        }]
    return d


def entry(device=None):
    """(step_fn, (state,)): one WCSPH step of the tiny scene and its
    initialized state, on the CUDA device unless ``device`` names another
    (``device="cpu"``)."""
    from sph_taichi_torch import SimConfig, build_scene, build_solver

    params, particles, _ = build_scene(
        SimConfig(config_dict=tiny_scene(method=0)), device=device)
    solver = build_solver(params, device=device)
    state = solver.initialize(particles)

    def step_fn(state):
        return solver.step(state)[0]

    return step_fn, (state,)


# ---------------------------------------------------------------------------
# the rank body
# ---------------------------------------------------------------------------

def launch_counts():
    """{kernel: launches} of every hand-kernel wrapper."""
    from sph_taichi_torch.ops import (
        cuda_dfsph, cuda_iisph, cuda_pairs, cuda_pcisph)
    return {**cuda_pairs.LAUNCHES, **cuda_dfsph.LAUNCHES,
            **cuda_iisph.LAUNCHES, **cuda_pcisph.LAUNCHES}


def reset_launch_counts():
    from sph_taichi_torch.ops import (
        cuda_dfsph, cuda_iisph, cuda_pairs, cuda_pcisph)
    for mod in (cuda_pairs, cuda_dfsph, cuda_iisph, cuda_pcisph):
        mod.reset_launch_counts()


def _engine_factory(name):
    """None (the device's make_engine), "cuda" (CudaEngine, also over CPU
    tensors, where its wrappers run their plain versions) or "gather"."""
    if name is None:
        return None
    if name == "cuda":
        from sph_taichi_torch.ops.cuda_pairs import CudaEngine
        return CudaEngine
    if name == "gather":
        from sph_taichi_torch.ops.pairs import GatherEngine
        return GatherEngine
    raise ValueError(f"engine {name!r}: None, 'cuda' or 'gather'")


def _to_numpy(p):
    return {f: a.cpu().numpy() for f, a in p._asdict().items()
            if a is not None}


def run_scenario(comm, device, spec):
    """One scenario on this rank; returns rank 0's record (None on the
    others).  ``spec``: "scene" (a scene dict or a scene file's path),
    "steps", optionally "record" (steps after which to gather the owned
    particles; 0 is the initialized state), "fields" (the fields gathered;
    default all), "mig_cap", "halo_cap", "loc_cap" (default: the
    scene's n_pad), "engine" (see ``_engine_factory``), "backend" (the
    params' pair backend), "replicated" (``initialize_replicated``),
    "slabs" (also gather each rank's initialized rows), "stop_on" (a
    metric that ends the run once non-zero), "time" (synchronized wall
    time per step on a CUDA device).  The record holds the gathered
    states, each step's metrics, and each rank's collectives, hopped
    bytes, kernel launches and times per step and its owned rows per
    object id after ``initialize``; "seconds" is the scenario's wall time
    on rank 0."""
    import dataclasses

    from sph_taichi_torch import SimConfig, build_scene
    from sph_taichi_torch.parallel.sharding import ShardedSolver
    from sph_taichi_torch.utils.profiling import summarize_metrics

    t_start = time.perf_counter()
    scene = spec["scene"]
    config = (SimConfig(scene) if isinstance(scene, str)
              else SimConfig(config_dict=scene))
    params, particles, _ = build_scene(config, device=device)
    if spec.get("backend"):
        params = dataclasses.replace(params, backend=spec["backend"])
    sh = ShardedSolver(params, comm, mig_cap=spec.get("mig_cap", 128),
                       halo_cap=spec.get("halo_cap", 512),
                       loc_cap=spec.get("loc_cap", params.n_pad),
                       device=device,
                       engine=_engine_factory(spec.get("engine")))
    init = sh.initialize_replicated if spec.get("replicated") \
        else sh.initialize
    state = init(particles)
    del particles
    record = set(spec.get("record", ()))
    fields = spec.get("fields")
    out = {"states": {}, "metrics": [], "n_ext": sh.n_ext, "nxd": sh.nxd,
           "init_metrics": (summarize_metrics(sh.init_metrics)
                            if hasattr(sh, "init_metrics") else {}),
           "collectives": [], "hop_bytes": [], "launches": [], "ms": []}
    if spec.get("slabs"):
        rows = comm.gather_host(_to_numpy(state.p))
        out["slabs"] = rows if comm.rank == 0 else None
    owned = sh.owned_rows(state).object_id
    owned_by_object = torch.bincount(owned.long(), minlength=max(
        params.num_objects, 1)).tolist() if owned.numel() else []
    if 0 in record:
        out["states"][0] = _to_numpy(sh.gather_particles(state, fields))
    cuda = torch.device(device).type == "cuda"
    timed = spec.get("time") and cuda
    for i in range(1, spec["steps"] + 1):
        comm.reset_counts()
        reset_launch_counts()
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = sh.step(state)
        if timed:
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["collectives"].append(comm.calls)
        out["hop_bytes"].append(comm.hop_bytes)
        out["launches"].append({k: v for k, v in launch_counts().items()
                                if v})
        m = summarize_metrics(metrics)
        out["metrics"].append(m)
        if i in record:
            out["states"][i] = _to_numpy(sh.gather_particles(state, fields))
        if spec.get("stop_on") and m.get(spec["stop_on"], 0):
            break
    out["seconds"] = time.perf_counter() - t_start
    # every rank's per-step counts (each rank's collectives and launches)
    mine = {k: out[k] for k in ("collectives", "hop_bytes", "launches",
                                "ms")}
    mine["owned_by_object"] = owned_by_object
    out["ranks"] = comm.gather_host(mine)
    return out if comm.rank == 0 else None


def run_scenarios(comm, device, specs):
    """``run_scenario`` of each spec in turn: rank 0's records, else
    None."""
    return [run_scenario(comm, device, s) for s in specs]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def match_states(ref, got, tol, rtol=0.0, material=None, bijection=True):
    """Nearest-position match of ``got``'s particles onto ``ref``'s (numpy
    dicts by field; ``material``: only its rows, default every real row),
    raising unless the counts agree, the match is a bijection (with
    ``bijection``: the box clamp can stack particles on one point) and
    each field of ``tol`` ({field: atol}) agrees within atol + rtol |ref|.
    Returns {"dist": the largest position distance, field: the largest
    difference}."""
    from scipy.spatial import cKDTree

    rows = [(d["material"] >= 0) if material is None
            else d["material"] == material for d in (ref, got)]
    x1, x2 = ref["x"][rows[0]], got["x"][rows[1]]
    if x1.shape != x2.shape:
        raise AssertionError(f"material {material}: {x2.shape[0]} "
                             f"particles against {x1.shape[0]}")
    dist, idx = cKDTree(x2).query(x1, k=1)
    if bijection and len(np.unique(idx)) != len(idx):
        raise AssertionError(f"material {material}: the match is not a "
                             f"bijection")
    out = {"dist": float(dist.max(initial=0.0))}
    for f, atol in tol.items():
        a = ref[f][rows[0]]
        diff = np.abs(got[f][rows[1]][idx] - a)
        out[f] = float(diff.max(initial=0.0))
        if (diff > atol + rtol * np.abs(a)).any():
            raise AssertionError(f"material {material}: {f} differs by "
                                 f"{out[f]:.3g} (atol {atol}, rtol {rtol})")
    return out


def _single_states(scene, steps, device):
    """The single-device port's real particles after each of ``steps``
    steps (numpy dicts)."""
    from sph_taichi_torch import SimConfig, build_scene, build_solver

    params, particles, _ = build_scene(SimConfig(config_dict=scene),
                                       device=device)
    solver = build_solver(params, device=device)
    state = solver.initialize(particles)
    out = []
    for _ in range(steps):
        state, _ = solver.step(state)
        real = state.p.material >= 0
        out.append({f: a[real].cpu().numpy()
                    for f, a in state.p._asdict().items() if a is not None})
    return params, out


def dryrun_multichip(n_ranks, devices=None, timeout=600.0):
    """One sharded step of the tiny scene for methods 0, 1, 2 and 4 on
    ``n_ranks`` gloo ranks, then three of the two-way scene (a dynamic
    rigid block) for methods 0 and 4, held against the single-device step
    (positions and velocities through a nearest-position bijection after
    3 steps of WCSPH and 1 of DFSPH, as the JAX dry run holds its own).
    ``devices``: one per rank (default: the CUDA devices round-robin,
    ``comm.cuda_devices``, which raises without a card; pass ``["cpu"] *
    n_ranks`` for the CPU)."""
    from sph_taichi_torch.parallel import comm

    if devices is None:
        devices = comm.cuda_devices(n_ranks)
    if any(d.startswith("cuda") for d in devices):
        # here, once: ranks building into build/ at once would race
        from sph_taichi_torch.ops import _build
        _build.build(_build.SOURCES)
    specs = [{"scene": tiny_scene(method=m, radius=0.05), "steps": 1,
              "record": [1], "mig_cap": 128, "halo_cap": 256}
             for m in (0, 1, 2, 4)]
    specs += [{"scene": tiny_scene(method=m, radius=0.05, rigid=True),
               "steps": 3, "record": [0, 1, 3], "mig_cap": 128,
               "halo_cap": 256} for m in (0, 4)]
    out = comm.launch(run_scenarios, n_ranks, args=(specs,),
                      backend="gloo", devices=devices, timeout=timeout)[0]
    for spec, rec in zip(specs[:4], out[:4]):
        method = spec["scene"]["Configuration"]["simulationMethod"]
        x = rec["states"][1]["x"]
        m = rec["metrics"][-1]
        if not np.isfinite(x).all():
            raise AssertionError(f"method {method}: non-finite state")
        if m["migration_overflow"] or m["halo_overflow"]:
            raise AssertionError(f"method {method}: overflow {m}")
        print(f"dryrun_multichip({n_ranks}) method={method}: OK - "
              f"{x.shape[0]} particles stepped over {n_ranks} slabs "
              f"({rec['collectives'][0]} collectives on rank 0)")
    for spec, rec in zip(specs[4:], out[4:]):
        method = spec["scene"]["Configuration"]["simulationMethod"]
        cross = 3 if method == 0 else 1
        params, single = _single_states(spec["scene"], cross, devices[0])
        got = rec["states"][cross]
        fluid = match_states(single[-1], got, {"x": 2e-3, "v": 2.0},
                             material=1, bijection=False)
        rigid = match_states(single[-1], got, {"x": 2e-4, "v": 0.5},
                             material=0)
        x0 = rec["states"][0]["x"][rec["states"][0]["material"] == 0]
        last = rec["states"][3]
        xs = last["x"][last["material"] == 0]
        if xs.shape != x0.shape or not np.isfinite(last["x"]).all():
            raise AssertionError(f"method {method}: rigid rows lost or "
                                 f"non-finite state")
        if last["x"].shape[0] != params.n_particles:
            raise AssertionError(f"method {method}: lost particles")
        r0 = np.sqrt(((x0 - x0.mean(0)) ** 2).sum(1).mean())
        r1 = np.sqrt(((xs - xs.mean(0)) ** 2).sum(1).mean())
        if abs(r1 - r0) >= 1e-3 * max(r0, 1e-9):
            raise AssertionError(f"rigid shape not kept: rms radius {r0} "
                                 f"-> {r1}")
        if any(m["migration_overflow"] or m["halo_overflow"]
               for m in rec["metrics"]):
            raise AssertionError(f"method {method}: overflow")
        print(f"dryrun_multichip({n_ranks}) method={method} two-way: OK - "
              f"|dCOM| {np.linalg.norm(xs.mean(0) - x0.mean(0)):.2e}, rms "
              f"radius drift {abs(r1 - r0):.2e}; against the single-device "
              f"step after {cross}: rigid position {rigid['dist']:.2e}, "
              f"velocity {rigid['v']:.2e}; fluid (nearest) "
              f"{fluid['dist']:.2e}, {fluid['v']:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fn, (state,) = entry(device=device)
    state = fn(state)
    print(f"entry(): one WCSPH step of {int((state.p.material >= 0).sum())} "
          f"particles on {state.p.x.device}")
    devices = None if device.type == "cuda" else [str(device)] * args.ranks
    dryrun_multichip(args.ranks, devices=devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
