"""Run a bundled scene at a coarse particle radius on the CPU, in the JAX
package or in the port, and print what each step did.

    JAX_PLATFORMS=cpu python tools/coarse_scene_runs.py --package jax \
        --scene data/scenes/high_fluid_dfsph.json --radius 0.04 --steps 60
    python tools/coarse_scene_runs.py --package torch \
        --scene data/scenes/high_fluid_dfsph.json --radius 0.04 --steps 60

Only ``particleRadius`` changes in the loaded scene dict (``--inside``
also clips the fluid blocks to the padded box, whose padding is 4 r).
Per step: the Jacobi iterations (DFSPH), the fastest fluid particle, the
fluid's largest x and y, the fullest cell, whether the state is finite;
then the first step with fluid at the far wall (x at the padded box's
end), the first step with a fluid particle within the support radius of
a solid, the steps at a loop's cap of 100, the first non-finite step and
the wall time.  The run stops at the first non-finite state (the port's
rigid solve raises on one: its SVD refuses non-finite input).  One torch
thread; the tests' coarse scenes (tests/test_torch_bundled_scenes.py)
take these radii.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def scene_dict(path, radius, inside):
    with open(path) as f:
        d = json.load(f)
    conf = d["Configuration"]
    conf["particleRadius"] = radius
    if inside:
        pad = 4 * radius
        for block in d["FluidBlocks"]:
            block["start"] = [max(s, pad) for s in block["start"]]
            block["end"] = [min(e, hi - pad) for e, hi in
                            zip(block["end"], conf["domainEnd"])]
    return d


def stepper(package, d):
    """(params, state, step(state) -> (state, metrics), to_numpy)."""
    if package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import sph_taichi_tpu as J
        params, part, _ = J.build_scene(J.SimConfig(config_dict=d))
        solver = J.build_solver(params)

        def to_numpy(p):
            return {k: np.asarray(v) for k, v in p._asdict().items()
                    if v is not None}
    else:
        import torch
        import sph_taichi_torch as T
        torch.set_num_threads(1)
        params, part, _ = T.build_scene(T.SimConfig(config_dict=d),
                                        device="cpu")
        solver = T.build_solver(params, device="cpu")

        def to_numpy(p):
            return {k: v.numpy() for k, v in p._asdict().items()
                    if v is not None}
    return params, solver.initialize(part), solver.step, to_numpy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--radius", type=float, default=0.04)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--inside", action="store_true")
    args = ap.parse_args(argv)
    from scipy.spatial import cKDTree

    t0 = time.perf_counter()
    params, state, step, to_numpy = stepper(
        args.package, scene_dict(args.scene, args.radius, args.inside))
    hi = np.float32(params.domain_end[0] - params.padding)
    print(f"{args.package}: {args.scene} at radius {args.radius}"
          f"{' (fluid inside the padded box)' if args.inside else ''}: "
          f"n_fluid {params.n_fluid}, n_solid {params.n_solid}, dt "
          f"{params.dt0}, padding {params.padding:g}")
    wall = contact = lost = None
    capped = []
    for i in range(1, args.steps + 1):
        try:
            state, m = step(state)
        except Exception as e:   # the port's SVD on a non-finite state
            print(f"step {i}: {type(e).__name__}: {e}")
            lost = i
            break
        p = to_numpy(state.p)
        fluid = p["x"][p["material"] == 1]
        finite = bool(np.isfinite(p["x"]).all() and np.isfinite(p["v"]).all())
        its = {k: int(m[k]) for k in ("divergence_iters", "pressure_iters")
               if k in m}
        if any(v >= 100 for v in its.values()):
            capped.append(i)
        if finite and wall is None and (fluid[:, 0] >= hi).any():
            wall = i
        solid = p["x"][p["material"] == 0]
        if finite and contact is None and len(solid) and (
                cKDTree(solid).query(fluid, k=1)[0]
                < params.support_radius).any():
            contact = i
        print(f"step {i}: {its} fastest {float(m['max_velocity']):.3f} m/s, "
              f"fluid x max {fluid[:, 0].max():.4f} y max "
              f"{fluid[:, 1].max():.4f}, fullest cell "
              f"{int(m['max_cell_occupancy'])}, finite {finite}", flush=True)
        if not finite:
            lost = i
            break
    print(f"{args.package}: fluid at the far wall from step {wall}; first "
          f"contact with a solid at step {contact}; steps at a loop's cap "
          f"of 100 {capped}; first non-finite step {lost}; wall time "
          f"{time.perf_counter() - t0:.1f} s (CPU)")


if __name__ == "__main__":
    main()
