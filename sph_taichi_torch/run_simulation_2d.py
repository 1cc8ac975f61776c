"""Headless 2D legacy driver on the port (counterpart of the repository's
root ``run_simulation_2d.py``, the reference's legacy/scene.py).

Dam-break scene with boundary walls, optional adaptive dt, PNG frame
export, and the legacy demo's mid-simulation cube emission at t > 0.4
(legacy/scene.py:59-75):

    python -m sph_taichi_torch.run_simulation_2d --method PCISPH \\
        --adaptive --save
    python -m sph_taichi_torch.run_simulation_2d --method DFSPH --adaptive \\
        --device cpu --max_frames 20

Runs on the CUDA device unless ``--device`` names another.
"""

import argparse
import os
import time

import numpy as np

from sph_taichi_torch.legacy2d import (
    MATERIAL_FLUID, METHODS, SPHSolver2D)
from sph_taichi_torch.utils.exporters import write_png
from sph_taichi_torch.utils.profiling import StepTimer

RES = (400, 400)
SCREEN_TO_WORLD_RATIO = 35
EMISSION_TIME = 0.40   # simulated seconds before the emission


def build_solver(method, adaptive, max_frames, max_time=5.0, device=None):
    """The dam-break scene: res 400x400 at 35 px per metre, dx 0.1, the
    3 x 5 fluid block falling at 5 m/s, capacity 2^14."""
    u, b, l, r = np.array([RES[1], 0, 0, RES[0]]) / SCREEN_TO_WORLD_RATIO
    sph = SPHSolver2D(RES, SCREEN_TO_WORLD_RATIO, [u, b, l, r],
                      alpha=0.30, dx=0.1, max_time=max_time,
                      max_steps=max_frames, method=METHODS[method],
                      adaptive_time_step=adaptive,
                      max_num_particles=2 ** 14, device=device)
    # dam-break fluid block + boundary walls (legacy/scene.py setup style)
    sph.add_cube(lower_corner=[l + 0.5, b + 0.5],
                 cube_size=[3.0, 5.0], velocity=[0.0, -5.0],
                 density=[1000], material=MATERIAL_FLUID, color=0x068587)
    return sph


def emit(sph):
    """The legacy demo's emission (legacy/scene.py:59-75)."""
    sph.add_cube(lower_corner=[6, 6], cube_size=[2.0, 2.0],
                 velocity=[0.0, -5.0], density=[1000.0],
                 color=0xED553B, material=MATERIAL_FLUID)
    sph.add_cube(lower_corner=[3, 8], cube_size=[1.0, 1.0],
                 velocity=[0.0, -10.0], density=[1000.0],
                 color=0xEEEEF0, material=MATERIAL_FLUID)


def render(info):
    """The particles as a (res, res, 3) uint8 image, one pixel each."""
    img = np.zeros((RES[1], RES[0], 3), np.uint8)
    pix = (info["position"] * SCREEN_TO_WORLD_RATIO).astype(int)
    ok = ((pix[:, 0] >= 0) & (pix[:, 0] < RES[0])
          & (pix[:, 1] >= 0) & (pix[:, 1] < RES[1]))
    pix = pix[ok]
    col = info["color"][ok]
    img[RES[1] - 1 - pix[:, 1], pix[:, 0], 0] = (col >> 16) & 0xFF
    img[RES[1] - 1 - pix[:, 1], pix[:, 0], 1] = (col >> 8) & 0xFF
    img[RES[1] - 1 - pix[:, 1], pix[:, 0], 2] = col & 0xFF
    return img


def run(opt, device=None, timer=None, on_emission=None, log=print):
    """Run the scene until ``opt.max_frames`` steps or ``opt.max_time``
    simulated seconds.  ``timer`` (a ``StepTimer``) times the phases "step"
    and "emission"; ``on_emission(sph)`` is called just after the
    emission.  Returns a summary dict (the solver under "solver")."""
    sph = build_solver(opt.method, opt.adaptive, opt.max_frames,
                       opt.max_time, device)
    timer = timer or StepTimer(sph.device)
    add = True
    add_cnt = 0.0
    t = 0.0
    frame = 0
    n_before = sph.state.n
    its, reads = [], []
    out_dir = opt.output_dir or f"legacy2d_{opt.method.lower()}_output"
    if opt.save:
        os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    while frame < opt.max_frames and t < sph.max_time:
        with timer.phase("step"):
            dt = sph.step(frame, t, t0)
        its.append(sph.it)
        reads.append(sph.reads)

        if add and add_cnt > EMISSION_TIME:   # legacy/scene.py:59-75
            n_before = sph.state.n
            with timer.phase("emission"):
                emit(sph)
            add = False
            if on_emission is not None:
                on_emission(sph)

        if opt.save and frame % 50 == 0:
            write_png(os.path.join(out_dir, f"{frame:06d}.png"),
                      render(sph.particle_info()))

        frame += 1
        t += dt
        add_cnt += dt
        if frame % 100 == 0 and log is not None:
            info = sph.particle_info()
            vmax = np.linalg.norm(info["velocity"], axis=1).max()
            log(f"frame {frame} t={t:.3f} dt={dt:.2e} "
                f"n={len(info['position'])} max|v|={vmax:.2f} "
                f"iters={sph.it}")
    seconds = time.time() - t0
    if log is not None:
        log(f"done {frame} frames in {seconds} s")
    return {"solver": sph, "frames": frame, "t": t, "seconds": seconds,
            "n_before": n_before, "n_after": sph.state.n,
            "emitted": not add, "iterations": its, "reads": reads,
            "timer": timer}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--method", type=str, default="PCISPH",
                        choices=list(METHODS))
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--adaptive", action="store_true")
    parser.add_argument("--dynamic-allocate", action="store_true",
                        help="accepted for legacy CLI parity (capacity is "
                             "preallocated; emission fills padded slots)")
    parser.add_argument("--max_frames", type=int, default=1000)
    parser.add_argument("--max_time", type=float, default=5.0,
                        help="simulated seconds to stop at")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="PNG directory (default "
                             "legacy2d_<method>_output)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA device)")
    return parser.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    return run(opt, device=opt.device)


if __name__ == "__main__":
    main()
