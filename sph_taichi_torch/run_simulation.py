"""Headless command-line runner of the PyTorch/CUDA port.

    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/dragon_bath.json --max_frames 200
    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/dragon_bath_dfsph.json --max_frames 50
    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/dragon_bath.json --method 2 --max_frames 50
    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/dragon_bath.json --method 1 --max_frames 50 \
        --checkpoint_interval 10
    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/dragon_bath.json --method 1 --max_frames 50 \
        --resume dragon_bath_output/checkpoint.npz
    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/dragon_bath.json --backend pallas_slots
    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/dragon_bath_dfsph.json --backend pallas_slots
    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/high_fluid_wcsph.json --max_frames 600
    python -m sph_taichi_torch.run_simulation \
        --scene_file data/scenes/armadillo_bath_dynamic_dfsph.json \
        --max_frames 25

Runs on the CUDA device unless ``--device cpu`` is given.  With
``--checkpoint_interval N`` it writes ``<output_dir>/checkpoint.npz`` every
N frames; ``--resume`` continues from such a file (one written by the JAX
package's ``run_simulation.py`` loads too).  ``--backend`` picks the pair
engine with the JAX package's names: ``auto`` and ``pallas_blocks`` the
cell-run CUDA kernels, ``pallas_slots`` the slot-map kernels (every
solver), ``gather`` the plain engine (CPU only).
"""

import argparse
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="SPH on PyTorch/CUDA")
    parser.add_argument("--scene_file", required=True, help="scene file")
    parser.add_argument("--max_frames", type=int, default=0,
                        help="stop after N frames (0 = run forever)")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--method", type=int, default=None,
                        help="override the scene's simulationMethod "
                             "(0 WCSPH, 1 PCISPH, 2 IISPH, 4 DFSPH)")
    parser.add_argument("--backend", default=None,
                        choices=["auto", "gather", "pallas_blocks",
                                 "pallas_slots"],
                        help="pair engine: 'auto' and 'pallas_blocks' the "
                             "cell-run CUDA kernels, 'pallas_slots' the "
                             "slot-map kernels, 'gather' the plain engine "
                             "(CPU only)")
    parser.add_argument("--checkpoint_interval", type=int, default=0,
                        help="write <output_dir>/checkpoint.npz every N "
                             "frames (0 = never)")
    parser.add_argument("--resume", default="",
                        help="checkpoint to resume from")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    import torch
    from sph_taichi_torch.config import SimConfig
    from sph_taichi_torch.simulation import Simulation

    scene_dir = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(args.scene_file))))
    config = SimConfig(args.scene_file)
    if args.method is not None:
        config.config["Configuration"]["simulationMethod"] = args.method
    sim = Simulation(args.scene_file, config=config, scene_dir=scene_dir,
                     output_dir=args.output_dir, device=args.device,
                     backend=args.backend)
    if args.resume:
        sim.resume(args.resume)
    dev = sim.state.p.x.device
    print(f"scene: {sim.scene_name}  method: "
          f"{sim.params.simulation_method}  backend: {sim.params.backend}  "
          f"particles: {sim.params.n_particles} "
          f"(fluid {sim.params.n_fluid} / solid {sim.params.n_solid})  "
          f"dt: {sim.params.dt0}  substeps/frame: {sim.substeps}  "
          f"device: {dev}")

    n = args.max_frames or (1 << 62)
    t0 = time.time()
    done = 0
    try:
        while done < n:
            chunk = min(50, n - done)
            sim.run(chunk, checkpoint_interval=args.checkpoint_interval)
            done += chunk
            if not args.quiet:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                el = time.time() - t0
                steps = done * sim.substeps
                line = (f"frame {done}  t={float(sim.state.t):.4f}s  "
                        f"{steps / el:.1f} steps/s")
                st = sim.read_solver_stats()
                sim.reset_solver_stats()
                solves = [s for s in ("divergence", "pressure")
                          if f"{s}_iters_sum" in st]
                if solves:
                    k = st["steps"]
                    line += "  iterations/step" + "".join(
                        f" {s} {st[f'{s}_iters_sum'] / k:.2f} (max "
                        f"{st[f'{s}_iters_max']})" for s in solves)
                    reads = sum(st[f"{s}_host_reads"] for s in solves)
                    line += f"  host reads/step {reads / k:.2f}"
                print(line, flush=True)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)


if __name__ == "__main__":
    main()
