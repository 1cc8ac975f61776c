"""Kernel launches in torch.profiler windows, per kernel name, to compare
two checkouts on one card.

    python tools/window_kernel_counts.py steps TREE OUT.json
    python tools/window_kernel_counts.py chip_smoke TREE OUT.json
    python tools/window_kernel_counts.py diff A.json B.json

``steps``: dragon_bath as IISPH through ``Simulation`` of the checkout
TREE, over the cell runs and under ``backend="pallas_slots"``, 25 steps,
then two windows of 5 steps and five of 1 step.  ``chip_smoke``: TREE's
``chip_smoke.py`` with its ``profile_steps`` wrapped so that every window
it profiles is kept.  Both write {label: [window: {kernel: launches}]}
and print each window's total.  ``diff``: the windows whose counts differ
between two such files, and the kernels that differ in them.  Needs a
CUDA device for ``steps`` and ``chip_smoke``.
"""
import json
import os
import sys


def _load(tree):
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke
    return chip_smoke


def _counts(prof):
    c = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            c[e.key] = c.get(e.key, 0) + e.count
    return c


def steps(tree):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cs = _load(tree)
    from sph_taichi_torch.ops import _build
    from sph_taichi_torch.simulation import Simulation

    _build.build(["pairs", "dfsph", "iisph", "pcisph"])

    def window(sim, n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.run(n, export=False)
            torch.cuda.synchronize()
        return _counts(prof)

    out = {}
    for backend in ("auto", "pallas_slots"):
        sim = Simulation(config=cs.dragon_config(2), scene_dir=".",
                         backend=backend)
        sim.run(25, export=False)
        torch.cuda.synchronize()
        out[backend] = [window(sim, 5), window(sim, 5)] + [
            window(sim, 1) for _ in range(5)]
        del sim
    return out


def chip_smoke(tree):
    cs = _load(tree)
    profile_steps, windows = cs.profile_steps, []

    def kept(sim, n, counts=None):
        c = {} if counts is None else counts
        busy = profile_steps(sim, n, c)
        windows.append(dict(c))
        return busy

    cs.profile_steps = kept
    if cs.main():
        raise SystemExit("chip_smoke failed")
    return {"chip_smoke": windows}


def diff(a, b):
    for label in a:
        for k, (wa, wb) in enumerate(zip(a[label], b[label])):
            keys = {n for n in set(wa) | set(wb)
                    if wa.get(n, 0) != wb.get(n, 0)}
            if keys:
                print(f"{label} window {k}: {sum(wa.values())} -> "
                      f"{sum(wb.values())}")
                for n in sorted(keys):
                    print(f"  {wa.get(n, 0)} -> {wb.get(n, 0)}  {n[:150]}")


def main():
    mode, first, second = sys.argv[1:4]
    if mode == "diff":
        with open(first) as f, open(second) as g:
            diff(json.load(f), json.load(g))
        return
    second = os.path.abspath(second)
    out = {"steps": steps, "chip_smoke": chip_smoke}[mode](first)
    for label, wins in out.items():
        print(f"{label}: launches per window "
              f"{[sum(w.values()) for w in wins]}")
    with open(second, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
