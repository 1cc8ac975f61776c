"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. the card's name and power limit; build the CUDA kernels from
   sph_taichi_torch/csrc (nvcc, one process per source, started together)
   and print the build time and ptxas report;
2. each kernel against its plain PyTorch version on the card, on small
   scenes with clumped positions (cells above 8 particles, particles in edge
   cells): the WCSPH kernels (density_sum, density_sum_list with the
   step's pair list, wcsph_forces over that list with and without the
   two-way reaction, whole outputs bitwise), the
   DFSPH kernels (e1 with the step's pair list and d over it, whole
   outputs and the list bitwise; both divergence modes, the solver update
   with and without the reaction), and the DFSPH kernels and two whole
   steps on a block
   that falls onto the floor, where the Jacobi loops iterate; IISPH's
   step list (density_sum_list's) and the four IISPH kernels over it on
   a clumped scene with a static rigid block and on the
   floor impact (pressures from a seed), and the floor impact's first
   three IISPH steps at dt 1e-3 (59 and 7 iterations in the second and
   third), kernel engine against plain engine; kernel 2.1 c (boundary
   volume) and the three slot-walk kernels on a clumped scene with a
   static and a dynamic rigid block, at a 20-particle cell (slot and
   cell-run kernels equal bitwise) and a 40-particle cell (slot_overflow:
   kernel and plain slot lists drop the same pairs), kernel c's one-thread
   design and lane groups of 8, 16 and 32 (tools/volume_walk_control.cu,
   built with the kernels) and its plain version equal to it bitwise over
   both walks;
3. the WCSPH path: data/scenes/dragon_bath.json (442,006 particles)
   through ``Simulation`` on the card, timed with CUDA events; the kernels'
   launch counts over that run (density_sum_list = wcsph_forces = steps);
   device busy and stage times; at the dragon state the walk profiles of
   the two kernels' centres (accepted pairs per centre, warps over the
   list), their registers, shared memory and resident blocks, per-kernel
   and plain-version times and bounds (each beside the bytes of the list's
   write or read, a design figure), both against their plain versions bitwise (the list
   too); one kernel step held index-wise against one plain-engine step
   from the same state;
4. the DFSPH path: data/scenes/dragon_bath_dfsph.json (the same particles,
   dt 4e-3) through ``Simulation``, timed with CUDA events; iteration
   counts, host reads per step and launch counts over that run (e1 = d =
   steps); the host syncs of one step; device busy, and e1's and d's
   kernels in 5 profiled steps against their wrappers' calls; stage
   times; the step time by the Jacobi loops' read interval, there and
   100 steps later; one kernel step against one plain-engine step; at the
   dragon state the walk profile of e1's and d's centres with the list,
   the registers, shared memory and resident blocks of e1 and d (both
   walks, both variants), per-kernel and plain-version times and bounds
   (e1 and d beside the bytes of the list's write and read, design
   figures), e1 (the list too) and d against their plain versions
   bitwise;
5. the DFSPH reaction variant at scale: data/scenes/
   dragon_bath_dynamic_dfsph.json (a dynamic dragon), run until the fluid
   reaches the dragon, then 5 timed steps and the reaction kernel's time;
   at that state the walk profile of e1's and d's centres with the list,
   and e1 (the list too) and d against their plain versions bitwise;
   kernel 2.1 c once per step (the CUDA engines take it at every solid
   count), at the contact over both walks against its plain versions and
   its other designs (bitwise) with their times and bounds, beside the
   dense path that the dispatch took before (the record); one step against
   one plain-engine step (the dense volumes), at the tolerance;
6. the IISPH path: data/scenes/dragon_bath.json with simulationMethod 2
   (442,006 particles, dt 4e-4) through ``Simulation``, 20 steps after 5
   of warm-up, timed with CUDA events; pressure iterations and host reads
   per step, launch counts (density_sum_list = f1 = f2 = steps, f3 and f4
   k per host read in the loop, f3 once more per step with the advect; no
   one-phase density_sum); the host syncs of one step (none in the loop's
   wrappers); the step's list kernels in 5 profiled steps against their
   wrappers' calls; stage times; the step time by the Jacobi loop's read
   interval; one kernel step against one plain-engine step; at that state
   the walk profile of every real centre with the list (and of the fluid
   and solid centres alone), the registers, shared memory and resident
   blocks of f1-f4 (both walks), per-kernel (density_sum_list's and the
   one-phase density_sum's too) and plain-version times and bounds (f1-f4
   beside the bytes of the list's read), the list and f1-f4 against their
   plain versions bitwise;
7. the IISPH iterating regime: the same scene at dt 2e-3, run until a
   step's pressure solve iterates more than once, then 5 timed steps and
   the read-interval sweep; at that state (pressures not 0) the walk
   profiles, the list and f1-f4 over it against their plain versions
   bitwise, and one kernel step against one plain-engine step;
8. the PCISPH kernels (over density_sum_list's step list the
   un-kicked non-pressure variant, the density derivative with its
   correction and the pressure acceleration with its predict) against
   their plain versions on the clumped
   small scene and the two-way scene at a seeded prediction x* = x + dt v*
   that moves pairs out of the radius; three PCISPH steps of an impact on
   the floor, kernel engine against plain engine;
9. the PCISPH path: data/scenes/dragon_bath.json with simulationMethod 1
   (dt 4e-4) through ``Simulation``, 20 steps after 5 of warm-up, timed
   with CUDA events; iterations and host reads per step, launch counts
   (density_sum_list = non-pressure = steps, g1 = g2 = k per host read);
   the host syncs of one step (none in the loop's wrappers); the density
   kernel's, d's and the loop's kernels in 5 profiled steps against their
   wrappers' calls; stage times (the list written with the densities); the
   read-interval sweep (k = 1, 2, 3, 4); one kernel step against one
   plain-engine step; at that state the walk profile with the list, each
   list kernel's registers, shared memory and resident blocks (d's too),
   per-kernel and plain-version times and bounds (d, g1 and g2 beside the
   bytes and operations of the list's read), the list against its plain
   version; a checkpoint
   saved there and resumed into a fresh ``Simulation``, one step on both,
   bitwise equal;
10. the armadillo scene's particle counts (build_scene only): its solids
   take kernel 2.1 c on the card, the dense path on the plain engines;
11. the solid-heavy path: dragon_bath_dynamic_dfsph.json with the dragon
   scaled by 1.25, built in memory (457,558 particles, 34,058 dynamic
   solids, above DENSE_SOLID_CAP), through ``Simulation`` with DFSPH at dt
   4e-3, 20 timed steps after 5: kernel 2.1 c once per step, the dense path
   never; kernel c against its plain version for both target masks, its
   designs (bitwise) and their times, its registers, plain time and
   bound;
12. the slot path: data/scenes/dragon_bath.json (WCSPH) with
   ``backend="pallas_slots"`` through ``Simulation``, 50 timed steps after
   5, steps/s beside the cell-run path's, device busy per step beside
   that of wcsph_forces' one-phase slot design without the list (the
   control library of tools/wcsph_walk_control.cu with ONE_PHASE, built
   with the kernels), in the same run, and the state then bitwise that of
   the cell-run twin; the slot map's build time and bytes,
   max_layers_used and the launch counts (density_sum_list[slots], which
   writes the step's list over the map, = wcsph_forces[slots], which
   reads it, = steps); the slot kernels against their plain versions (the
   slot neighbour lists; the list too) and beside the cell-run kernels at
   the dragon state, the list kernel beside the one-phase
   density_sum[slots] (on no step), wcsph_forces[slots] beside the
   control on the same inputs (equal bitwise), the walk profile,
   registers and the design figures of the list's stores and reads; one
   slot step against one cell-run step from the same state (expected:
   equal bitwise);
13. the scaled dynamic dragon as WCSPH (dt 4e-4) under
   ``backend="pallas_slots"``, 10 timed steps after 2: kernel c's slot
   instantiation once per step, against its
   plain version, beside the cell-run kernel c; device busy per step with
   the reaction forces over the step's list beside the one-phase control,
   and the state then bitwise that of a cell-run twin; at that state the
   reaction forces over the list (its dynamic-rigid centres) against
   their plain version and beside the control on the same inputs;
14. (in phase 2) the 14 slot instantiations of kernels d-g (DFSPH,
   IISPH, PCISPH) against their plain versions over the slot lists on
   the clumped DFSPH, IISPH and PCISPH scenes, at a 20-particle cell
   (each also equal to its cell-run instantiation) and with a
   40-particle overflow clump: all bitwise, DFSPH's Jacobi kernels and d
   over the step's list that e1 writes over the slot walk, IISPH's f1-f4
   and PCISPH's d, g1 and g2 over the list that density_sum_list[slots]
   writes, each list against its plain version (padding rows included);
15. data/scenes/dragon_bath_dfsph.json (DFSPH) with
   ``backend="pallas_slots"`` through ``Simulation`` beside a cell-run
   twin: 20 timed steps after 3 on each, steps/s, iterations, host reads
   and max_layers_used per step; the slot run launches each kernel of
   the cell-run run as its ``[slots]`` instantiation as often, runs the
   same iterations and holds the same state bitwise; the slot run's
   device busy per step beside that of the Jacobi kernels' and d's
   one-phase slot design without the list (the control library of
   tools/jacobi_walk_control.cu, built with the kernels), in the same
   call; six interleaved turns of 5 steps; at that state the slot list
   against its plain version, its walk profile (accepted pairs per fluid
   centre, warps over the list, warps walking the map), the registers,
   shared memory and resident blocks of e1's, the Jacobi kernels' and d's
   slot instantiations, the slot kernels against their plain versions and
   their cell-run instantiations, times (the list readers' also beside
   the one-phase slot design on the same inputs, equal bitwise), bounds
   and the list's design figures;
16. the same for dragon_bath as IISPH and as PCISPH (dt 4e-4, 20 steps
   after 5; density_sum_list[slots] writes the step's list over the map
   as density_sum_list does over the cell runs, and the slot run launches
   it as often): IISPH's f1-f4 (f3 in both variants) and PCISPH's d, g1
   and g2 read the list, and each step's device busy stands beside that of
   their one-phase slot design without the list (the control libraries of
   tools/iisph_walk_control.cu, and of tools/pcisph_walk_control.cu with
   ONE_PHASE beside tools/jacobi_walk_control.cu, built with the kernels),
   each reader beside the control on the same inputs (equal bitwise), the
   slot density kernel beside the one-phase density_sum[slots] (PCISPH),
   the walk profile over the list, registers and the list's design
   figures;
17. the same for the scaled dynamic dragon as DFSPH (20 steps after 5):
   kernel c's and the reaction update's slot instantiations every step,
   the reaction kernel against its plain version, the dynamic-rigid
   centres that e1's slot list holds for it and the reaction variant's
   time;
18. (in phase 2) the two-phase Jacobi kernels (dfsph_divergence in both
   modes, dfsph_solver_dv with and without the reaction, over cell runs
   and over the slot list) against their plain versions bitwise on an
   edge scene (a
   ~100-particle cell, lists that flush, warps in two columns, a dynamic
   rigid block), padding rows included, with the walk profile (torch,
   from the neighbour lists) and one kernel launched per wrapper call; (in
   phase 4) at the dragon_bath_dfsph state the walk profile, registers,
   shared memory and resident blocks of each instantiation, a launch with
   the Jacobi flag false, and the path's iteration and read counts against
   those of the one-phase walk;
19. (in phase 2) PCISPH's step list (density_sum_list's) and loop
   kernels on the same edge scene as PCISPH (centres with more accepted
   pairs than the
   list holds, so warps reading the list beside warps walking the cells):
   the list against its plain version, g1 and g2 over the list and over
   the slot map's list and un-kicked d over the list against their plain
   versions bitwise, padding rows included; bare cell offsets refused; the
   walk profile with the list; one kernel per wrapper call;
20. (in phase 2) IISPH's step list (density_sum_list's), f1, f2, f3
   (both variants) and f4 on the same edge scene as IISPH, every real
   centre over the list at a seeded pressure, padding velocities not 0:
   the list against its plain version, f1-f4 over the list and over the
   slot map's list against their plain versions bitwise, padding rows
   included;
   bare cell offsets refused; the walk profile with the list; one kernel
   per wrapper call;
21. (in phase 2) WCSPH's density_sum_list and wcsph_forces over its list
   on the same edge scene as WCSPH, with and without the reaction,
   padding velocities not 0: both against their plain versions bitwise
   (the list too), padding rows included; bare cell offsets refused; the
   walk profiles of both kernels' centres; one kernel per wrapper call.
   (density_sum, one phase over the cell runs, is on no solver step: it
   is timed and held against its plain version at phase 6's state.)
22. (in phase 2) DFSPH's e1 with the step's list and d over it on the
   same edge scene, padding densities and velocities not 0: both against
   their plain versions bitwise (the list too), e1 over the slot map too
   (d over the slot walk: phase 25), padding rows included; d refuses
   bare cell offsets (kicked and un-kicked; PCISPH's edge-scene phase runs
   un-kicked d over its list); the walk profile; one kernel per wrapper
   call.
23. (in phase 2) DFSPH's e1 over the slot walk writing the step's list
   and the four Jacobi instantiations over it on the edge scene (the
   cell overflows the slot map) and its corner form (the clump on a
   corner of 8 cells: fluid centres over the list of 64), the dynamic
   rigid block's centres listed for the reaction, padding densities and
   velocities not 0: e1 (density, factor and list) and the Jacobi kernels
   against their plain versions over
   the slot lists bitwise, padding rows included; the walk profile over
   the list; the Jacobi wrappers refuse the bare slot map; one kernel per
   wrapper call; the registers, shared memory and resident blocks of
   each slot instantiation.
24. (in phase 2) the slot density kernel writing the step's list of every
   real centre and PCISPH's g1 and g2 over it on the edge scene as PCISPH
   (the cell overflows the slot map) and its corner form (fluid centres
   over the list of 64: their warps walk the map in one phase, pinned),
   at a seeded prediction, padding velocities and pressures not 0:
   density_sum_list[slots] (sums and list), g1 and g2 against their plain
   versions over the slot lists bitwise, padding rows included; the walk
   profile over the list; the bare map refused by the wrappers (TypeError)
   and by the launchers (cudaErrorInvalidValue); one kernel per wrapper
   call; the registers, shared memory and resident blocks of each slot
   instantiation.
25. (in phase 2) the other readers of the slot walk's list on the same
   edge scene and corner form: WCSPH's b (with and without the reaction,
   at dt 4e-4), IISPH's f1, f2, f3 (both variants, at a seeded pressure)
   and f4 (at f2's and f3's plain outputs) and PCISPH's un-kicked d over
   density_sum_list[slots]'s list, DFSPH's kicked d over e1's slot list,
   padding velocities, densities, pressures and f4's inputs not 0: each
   list and reader against its plain version
   over the slot lists bitwise, padding rows included; the walk profile of
   each reader's centres over its list (the corner's warps over it walk
   the map in one phase, pinned); the bare map refused by the wrappers
   (TypeError naming the context's source) and by the launchers
   (cudaErrorInvalidValue); one kernel per wrapper call; the registers,
   shared memory and resident blocks of b's and f1-f4's slot
   instantiations (d's with phases 23 and 24).
26. the legacy 2D engine (sph_taichi_torch/legacy2d.py, plain torch: it
   reaches no Pallas kernel) through its driver's ``run``
   (sph_taichi_torch/run_simulation_2d.py), run_simulation_2d's scene
   unchanged (capacity 2^14, dx 0.1, the 3 x 5 dam break, the emission at
   t > 0.4 s) for WCSPH, PCISPH and DFSPH with adaptive dt to t >= 0.5 s:
   steps, simulated time and steps/s (CUDA events around the run), host
   reads and iterations per step, n before and after the emission (1,500
   and 2,000), a ``StepTimer`` report of the steps and the emission; then
   20 steps under ``utils/profiling.trace`` (device busy per step, the
   Chrome trace's bytes); the state finite and the fluid inside the padded
   bounds; from the state just after the emission one step on the card
   against one step of the port on the CPU (``convert.state2d_*``), at
   ``state2d_step_tolerances`` with ``DEVICE_STEP_TOL`` and equal
   iterations, and both against the same step in f64 on the CPU
   (``state2d_f64_witness``: the card's no more than twice as far from it
   as the CPU's, plus ``JAX_STEP_TOL``'s share); no hand kernel launched.
27. spatial slab sharding (sph_taichi_torch/parallel): the port's
   single-device WCSPH step of data/scenes/armadillo_bath_dynamic.json
   (1,723,968 fluid + 5,349 solids, three dynamic armadillos, the middle
   one across the slab boundary at x = 2.52 m) on the card, then the same
   scene in slabs of D = 2 (two processes sharing the card over gloo,
   staged through the host; halo_cap from the scene's fullest x-layer)
   and D = 1 (one process, NCCL), spawned by parallel/comm.py ``launch``
   with the kernels built above: after 1 step each state against the
   single-device step through a nearest-position bijection at the
   tolerance below, after 5 the particle count, a finite state inside the
   padded box, no overflow flag and each rigid's rms radius within 1e-3
   relative; per rank the hand-kernel launches per step (each of
   density_sum_list, wcsph_forces and boundary_volume in every step; the
   ranks count their own), collectives and bytes hopped per step and the
   step ms beside the single device's; then the small scene's methods 0,
   1, 2 and 4 at D = 2 against the single-device step on the card,
   iterations equal.
28. data/scenes/high_fluid_wcsph.json (a 0.6 x 5.4 x 0.6 m column of
   243,000 fluid particles, WCSPH at dt 4e-4) through ``Simulation`` to
   step 600 (t = 0.24 s), timed after 5 steps of warm-up: launches per
   step (density_sum_list = wcsph_forces = steps), the state finite,
   inside the padded box, the sort invariant intact and no fatal flag in
   any step, the fullest cell and the centres over the pair list's 64
   entries; one kernel step against one plain-engine step from that state
   (the plain engine's caps raised to the state's); the same 5 steps twice
   from it, bitwise equal (no atomics); device busy per step over 10 more
   steps, timed, then replayed from the same state under the profiler;
29. data/scenes/high_fluid_dfsph.json (the same column, DFSPH at dt 4e-3)
   to step 60 (t = 0.24 s): the same lines, with the iterations and host
   reads per step, each step's iterations, the steps at a loop's cap of
   100 and the first step whose state is not finite (none so far); one
   kernel step against one plain-engine step, iterations equal; device
   busy over 5 more steps;
30. data/scenes/armadillo_bath_dynamic_dfsph.json (1,723,968 fluid
   particles, three dynamic armadillos of 1,783 solids at 7874, 1700 and
   300 kg/m^3, DFSPH at dt 4e-3) until the fluid reaches an armadillo,
   then 5 timed steps: launches per step (kernel c, e1 and d once, e5
   with the reaction), iterations, host reads, device busy (the timed
   steps replayed under the profiler), the correctness line, each
   armadillo's rms radius drift (below 1e-3) and centre of mass; at the
   contact over all 1,729,317 rows e1 (with its
   list), d, e3/e4 and e5 with and without the reaction against their
   plain versions, kernel c over both walks against its plain versions
   and its designs (bitwise, timed) and against the dense path
   (VOLUME_RTOL), one kernel step against one plain-engine step whose
   volumes take kernel c's plain version (the dense path's step beside
   it, printed: its volumes sum in another order).
Each path's launch counts are set to 0 just before it runs and read just
after.  Every ``Simulation`` on the card launches kernel c twice in its
``initialize`` (the static and the moving volumes) and nothing else, or
nothing in a scene without solids; the
dense boundary-volume path is counted (``count_dense_calls``): never on a
path, never by a CUDA engine.  The last lines are a ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}``.

Tolerances: atol 2e-5, rtol 2e-4 (the engine-equivalence tolerance of the
JAX package's tests, tests/conftest.py _assert_states_close).  Kernel and
plain version compute the same f32 terms with the same rounding and add
them in the same order (ops/pairs.py sum_in_order), so they are expected
to agree to the bit; the tolerance is the bound that is held.
"""

import contextlib
import ctypes
import dataclasses
import importlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ATOL, RTOL = 2e-5, 2e-4
# kernel c's volumes against the dense path's: the same terms summed in
# another order, 5.6e-07-6.3e-07 apart (relative) at the dynamic dragon's
# 18,506 solids on an NVIDIA H100; the CPU tests hold m_V at this limit
VOLUME_RTOL = 2e-6
H100_BYTES_PER_S = 3.35e12     # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores
# f32 operations per within-radius pair, counted from csrc/pairs.cu
# (distance test 8, sqrt 1, W 13, multiply-add 2)
DENSITY_FLOPS_PER_PAIR = 24
# (distance 8, sqrt+square 2, inverse 2, dW/r 12, W 13, surface tension 3,
#  v_ij.r_ij 8, viscosity 5, pressure 4, sum of terms 2, radial sum 6)
FORCES_FLOPS_PER_PAIR = 65
# counted from csrc/dfsph.cu on the same scale (distance 8, sqrt+square 2,
# inverse 2, dW/r 12, W 13; v_ij.r_ij 8; radial sum 6):
# density+factor: W 13, dW/r 12, den 2, gradient coefficient 1, radial 6,
#   squared gradient 3
DENSITY_FACTOR_FLOPS_PER_PAIR = 49
# divergence: dW/r 12, v_ij.r_ij 8, div 3, count 1
DIVERGENCE_FLOPS_PER_PAIR = 36
# solver update: dW/r 12, k_i + k_j 1, fluid and solid coefficients 4,
#   their sum 1, radial 6
SOLVER_DV_FLOPS_PER_PAIR = 36
# non-pressure (fluid pairs only): dW/r 12, W 13, surface tension 2,
#   v_ij.r_ij 8, viscosity 6, sum 1, radial 6
NONPRESSURE_FLOPS_PER_PAIR = 60
# counted from csrc/iisph.cu on the same scale (distance 8, sqrt+square 2,
# inverse 2, dW/r 12):
# non-pressure (fluid j): v_ij.r_ij 8, viscosity 6, radial 6
IISPH_NONPRESSURE_FLOPS_PER_PAIR = 44
# predict advection (real j): m_V dW 1, rho_j^2 and S coefficient 2,
#   v_ij.r_ij 8, G and S radial 12, Q 3, div 2
IISPH_PREDICT_FLOPS_PER_PAIR = 52
# pressure acceleration (fluid and solid j): p_j / rho_j^2 2, pressure
#   coefficient 4, radial 6
IISPH_PRESSURE_FLOPS_PER_PAIR = 36
# A (real j): a_ij.r_ij 8, m_V dW a 2, sum 1
IISPH_APPLY_A_FLOPS_PER_PAIR = 35
# counted from csrc/pcisph.cu: IISPH's terms plus the pair geometry at the
# predicted positions (3 sub, 3 mul, 2 add = 8) besides the inclusion
# test at the step-start ones:
# g1 density derivative (real j): distance 8 + 8, sqrt+square 2, inverse 2,
#   dW/r 12, v_ij.r_ij 8, product and sum 3
PCISPH_D_RHO_FLOPS_PER_PAIR = 43
# g2 pressure acceleration (fluid and solid j): f3's 36, geometry 8
PCISPH_PRESSURE_FLOPS_PER_PAIR = 44
# the distance test at the step-start positions (3 sub, 3 mul, 2 add):
# g1 and g2 over the step's list do not do it
PCISPH_TEST_FLOPS = 8
# counted from csrc/pairs.cu boundary_volume: a within-radius pair costs its
# distance test (8); a solid one also sqrt 1, W 13, material test and sum 2
BOUNDARY_VOLUME_FLOPS_PER_PAIR = 24

# The bound's counts of each d-g kernel, over either walk: the bytes per
# real row that it reads once and writes once besides the walk's index, a
# constant for its device scalars, the within-radius pairs whose term it
# evaluates and its f32 operations per such pair.  Pairs: "fluid" of a
# fluid centre, "fluid_ff" of a fluid centre with a fluid neighbour, "real"
# of any real centre, "real_fj" of a real centre with a fluid neighbour.
ROW_COSTS = {
    # reads x, material, m_V, density; writes density, factor
    "dfsph_density_factor": (32, 0, "fluid", DENSITY_FACTOR_FLOPS_PER_PAIR),
    # reads x, v, material, m_V (adv: density, dt); writes adv, errt
    "dfsph_divergence_change": (40, 0, "fluid", DIVERGENCE_FLOPS_PER_PAIR),
    "dfsph_divergence_adv": (44, 4, "fluid", DIVERGENCE_FLOPS_PER_PAIR),
    # without the reaction: reads x, material, m_V, kappa, v, dt; writes v
    "dfsph_solver_dv": (48, 4, "fluid", SOLVER_DV_FLOPS_PER_PAIR),
    # e1 as this design runs it over the cell runs (a design figure printed
    # beside its bound, not a bound: the list is the design's own
    # intermediate): the function's bytes, and the list's counts (4 per
    # row) and entries written (counted with the index)
    "dfsph_density_factor_list": (36, 0, "fluid",
                                  DENSITY_FACTOR_FLOPS_PER_PAIR),
    # reads x, v, material, is_dynamic, m, density, dt; writes acc, v
    "nonpressure_kick": (64, 4, "fluid_ff", NONPRESSURE_FLOPS_PER_PAIR),
    # d as this design runs it over the step's list (a design figure, as
    # e1's): the list's counts and entries read instead of the cell
    # offsets; the pair geometry is still computed
    "nonpressure_kick_list": (68, 4, "fluid_ff", NONPRESSURE_FLOPS_PER_PAIR),
    # reads x, v, material, m, density, dt; writes acc, v
    "iisph_nonpressure_kick": (60, 4, "real_fj",
                               IISPH_NONPRESSURE_FLOPS_PER_PAIR),
    # reads x, v, material, m_V, density, p, dt; writes a_ii, source, last_p
    "iisph_predict_advection": (52, 4, "real", IISPH_PREDICT_FLOPS_PER_PAIR),
    # reads x, material, m_V, density, p, the flag (advect: v, dt); writes
    # acc (advect: v, x); f3 walks fluid and solid j, every real one
    "iisph_pressure_accel": (40, 1, "real", IISPH_PRESSURE_FLOPS_PER_PAIR),
    "iisph_pressure_accel_advect": (64, 4, "real",
                                    IISPH_PRESSURE_FLOPS_PER_PAIR),
    # reads x, material, m_V, accel, a_ii, source, last_p, dt, the flag;
    # writes new_p, err
    "iisph_apply_A": (52, 5, "real", IISPH_APPLY_A_FLOPS_PER_PAIR),
    # reads x, v, material, is_dynamic, m, density; writes acc
    "nonpressure_accel": (52, 0, "fluid_ff", NONPRESSURE_FLOPS_PER_PAIR),
    "nonpressure_accel_list": (56, 0, "fluid_ff", NONPRESSURE_FLOPS_PER_PAIR),
    # reads x, x*, v*, material, m_V, density, p, dt, s_f, the flag; writes
    # p', rho_err
    "pcisph_d_rho_correct": (60, 9, "fluid", PCISPH_D_RHO_FLOPS_PER_PAIR),
    # reads x, x*, material, m_V, density, p, v, acc, dt, the flag; writes
    # v*', x*'
    "pcisph_pressure_accel_predict": (88, 5, "fluid",
                                      PCISPH_PRESSURE_FLOPS_PER_PAIR),
    # g1 and g2 as this design runs them over the step's list (a design
    # figure printed beside their bounds, not a bound: the list is the
    # design's own intermediate), no warp over it: the list's counts (4 per
    # row) and entries read, no distance test; g1 reads no step-start x
    "pcisph_d_rho_correct_list": (
        52, 9, "fluid", PCISPH_D_RHO_FLOPS_PER_PAIR - PCISPH_TEST_FLOPS),
    "pcisph_pressure_accel_predict_list": (
        92, 5, "fluid", PCISPH_PRESSURE_FLOPS_PER_PAIR - PCISPH_TEST_FLOPS),
    # f1-f4 as this design runs them over the step's list (a design
    # figure, not a bound, as g1 and g2's): the list's counts and entries
    # read besides the function's bytes; the pair geometry is still
    # computed
    "iisph_nonpressure_kick_list": (64, 4, "real_fj",
                                    IISPH_NONPRESSURE_FLOPS_PER_PAIR),
    "iisph_predict_advection_list": (56, 4, "real",
                                     IISPH_PREDICT_FLOPS_PER_PAIR),
    "iisph_pressure_accel_list": (44, 1, "real",
                                  IISPH_PRESSURE_FLOPS_PER_PAIR),
    "iisph_pressure_accel_advect_list": (68, 4, "real",
                                         IISPH_PRESSURE_FLOPS_PER_PAIR),
    "iisph_apply_A_list": (56, 5, "real", IISPH_APPLY_A_FLOPS_PER_PAIR),
    # the DFSPH Jacobi kernels as this design runs them over the slot walk,
    # reading the step's list (a design figure, as f1-f4's): the list's
    # counts and entries read instead of the map
    "dfsph_divergence_change_list": (44, 0, "fluid",
                                     DIVERGENCE_FLOPS_PER_PAIR),
    "dfsph_divergence_adv_list": (48, 4, "fluid", DIVERGENCE_FLOPS_PER_PAIR),
    "dfsph_solver_dv_list": (52, 4, "fluid", SOLVER_DV_FLOPS_PER_PAIR),
}


def small_scene(two_way=False):
    """A ~600-particle fluid block (and a dynamic rigid block) in the
    reference's scene schema."""
    d = {
        "Configuration": {
            "domainStart": [0.0, 0.0, 0.0], "domainEnd": [1.0, 1.0, 1.0],
            "particleRadius": 0.025, "numberOfStepsPerRenderUpdate": 1,
            "density0": 1000, "simulationMethod": 0,
            "gravitation": [0.0, -9.81, 0.0], "timeStepSize": 4e-4,
            "stiffness": 50000, "exponent": 7},
        "FluidBlocks": [{
            "objectId": 0, "start": [0.1, 0.3, 0.1], "end": [0.5, 0.8, 0.5],
            "translation": [0.0, 0.0, 0.0], "scale": [1, 1, 1],
            "velocity": [0.0, -1.0, 0.0], "density": 1000.0,
            "color": [50, 100, 200]}],
    }
    if two_way:
        d["RigidBlocks"] = [{
            "objectId": 1, "start": [0.55, 0.45, 0.25],
            "end": [0.8, 0.7, 0.5], "translation": [0.0, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0], "velocity": [0.0, 0.0, 0.0],
            "density": 500.0, "color": [100, 100, 100], "isDynamic": True}]
    return d


def dfsph_scene(kind):
    """Small DFSPH scenes (dt 4e-3): "small" is the WCSPH block;
    "two_way" puts a dynamic rigid block right below it (the two-way DFSPH
    golden scene); "floor_impact" is a block resting on the floor and
    falling into it at 2 m/s, where both Jacobi loops iterate (the
    divergence solve 4 times in its second and third steps)."""
    d = small_scene()
    cfg = d["Configuration"]
    cfg["simulationMethod"], cfg["timeStepSize"] = 4, 4e-3
    if kind == "two_way":
        d["RigidBlocks"] = [{
            "objectId": 1, "start": [0.15, 0.08, 0.15],
            "end": [0.45, 0.26, 0.45], "translation": [0.0, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0], "velocity": [0.0, 0.0, 0.0],
            "density": 500.0, "color": [100, 100, 100], "isDynamic": True}]
    elif kind == "floor_impact":
        block = d["FluidBlocks"][0]
        block["start"], block["end"] = [0.1, 0.03, 0.1], [0.5, 0.6, 0.5]
        block["velocity"] = [0.0, -2.0, 0.0]
        # the impact packs up to 36 particles into a cell: the plain
        # engine's caps must hold them (the kernels have none)
        d["TPU"] = {"cellCap": 64, "neighborCap": 96}
    return d


def clumped_positions(rng, params, x):
    """Random positions in the padded box, a 20-particle clump inside one
    cell, 12 particles straddling a cell plane, one particle in the first
    and last cell along each axis."""
    x = x.copy()
    n = params.n_fluid + params.n_solid
    size = np.asarray(params.domain_size, np.float32)
    cell, pad = params.grid_size, params.padding
    x[:n] = rng.uniform(pad, size - pad, size=(n, 3))
    c0 = np.array([3, 3, 3]) * cell + 0.1 * cell
    x[:20] = c0 + rng.uniform(0, 0.8 * cell, size=(20, 3))
    c1 = np.array([5, 5, 4]) * cell
    x[20:32] = c1 + rng.uniform(-0.4 * cell, 0.4 * cell, size=(12, 3))
    grid = np.asarray(params.grid_num)
    for i, (ax, hi) in enumerate(((0, False), (1, False), (2, False),
                                  (0, True), (1, True), (2, True))):
        p = rng.uniform(pad, size - pad, size=3)
        p[ax] = (grid[ax] - 0.5) * cell if hi else 0.5 * cell
        x[32 + i] = np.clip(p, pad, size - pad)
    return x.astype(np.float32)


def time_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls, by CUDA events (one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_named(key, kernel):
    """Whether the profiler's kernel name ``key`` contains ``kernel`` (a
    string, or a tuple of strings it must all contain), spaces ignored."""
    parts = (kernel,) if isinstance(kernel, str) else kernel
    key = key.replace(" ", "")
    return all(p.replace(" ", "") in key for p in parts)


def kernel_ms(fn, kernel, reps, tries=5):
    """Mean device ms of the CUDA kernel whose name contains ``kernel``
    (``kernel_named``), over ``reps`` calls of ``fn`` under torch.profiler
    (one warm-up).  ``fn`` is one call of a wrapper that launches the
    kernel once, and the wrappers' counters (``all_launch_counts``) must
    show ``reps`` launches in every capture.  For
    a wrapper whose host work (small torch ops before the launch) outlasts
    its kernel, CUDA events around the calls time the host instead.  The
    profiler can lose device records of a capture: one that holds fewer
    launches than calls is taken again, at most ``tries`` times.  If the
    last capture still lacks records, it is taken only when it lacks one
    (the mean is then over the ``reps - 1`` recorded launches); fewer, or
    more launches than calls, raise."""
    from torch.profiler import ProfilerActivity, profile

    def launched():
        return sum(all_launch_counts().values())

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        first = launched()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counted = launched() - first
        if counted != reps:
            raise AssertionError(f"kernel_ms: the wrappers counted "
                                 f"{counted} launches in {reps} calls of "
                                 f"{kernel}")
        us, count = 0.0, 0
        for e in prof.key_averages():
            if kernel_named(e.key, kernel) and \
                    str(e.device_type).endswith("CUDA"):
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
                count += e.count
        if count == reps:
            if attempt:
                print(f"  profiler: {kernel} captured again {attempt} "
                      f"times (records lost)")
            return us / count / 1e3
        if count > reps:
            break
    if count == reps - 1:
        print(f"  profiler: {kernel}: {count} of {reps} launches recorded "
              f"in the last of {tries} captures, {reps} counted by the "
              f"wrapper (one record lost); the mean is over the {count}")
        return us / count / 1e3
    raise AssertionError(f"profiler: {count} launches of {kernel} in "
                         f"{reps} calls")


def max_errors(got, ref, name):
    """Max abs and rel error of ``got`` against ``ref``; raises above the
    tolerances."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    # entries that are not tiny, and the share of the tolerance used
    big = ref.abs() > 1e3 * ATOL
    rel = float((err[big] / ref.abs()[big]).max()) if bool(big.any()) else 0.0
    used = float((err / (ATOL + RTOL * ref.abs())).max())
    print(f"  {name}: max abs err {float(err.max()):.3e}  max rel err "
          f"(|ref| > {1e3 * ATOL:g}) {rel:.3e}  tolerance used {used:.3f}")
    if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
        bad = int((err > ATOL + RTOL * ref.abs()).sum())
        raise AssertionError(f"{name}: {bad} entries outside atol {ATOL} "
                             f"rtol {RTOL}")
    return float(err.max())


def prepared(scene_dict, device, seed, clump=True, place=None):
    """Sorted particles with clumped positions (or the scene's own with
    ``clump=False``, or ``place(rng, params, x, material)``'s) and random
    velocities, their Akinci volumes and densities (plain engine), the cell
    offsets and the plain engine's neighbour lists."""
    from sph_taichi_torch import SimConfig, build_scene, build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops.pairs import GatherEngine

    params, part, _ = build_scene(SimConfig(config_dict=scene_dict),
                                  device=device)
    rng = np.random.default_rng(seed)
    x = part.x.cpu().numpy()
    if place is not None:
        x = place(rng, params, x, part.material.cpu().numpy())
    elif clump:
        x = clumped_positions(rng, params, x)
    v = np.zeros_like(x)
    n = params.n_fluid + params.n_solid
    v[:n] = rng.uniform(-1.0, 1.0, size=(n, 3))
    part = part._replace(x=torch.tensor(x, device=device),
                         v=torch.tensor(v, device=device))
    engine = GatherEngine(params)
    solver = build_solver(params, device=device, engine=engine)
    p, nl, diag = base.bin_and_sort(part, params, engine, solver.tables)
    p = base.compute_static_boundary_volume(p, nl, engine, params)
    p = base.compute_moving_boundary_volume(p, nl, engine, params)
    p = base.compute_densities(p, nl, engine, params)
    starts = base.cell_offsets(
        base.compute_cell_ids(p.x, p.material, params.grid_size,
                              params.grid_num), params.num_cells)
    return params, solver, p, nl, starts, diag


def compare_wcsph_list_kernels(params, solver, p, nl, starts, label,
                               worst):
    """WCSPH's two kernels over the cell runs against their plain versions
    at one state, whole outputs (padding rows included) equal bitwise:
    ``density_sum_list`` (the sums and the step's pair list) and
    ``wcsph_forces`` over that list, with the two-way reaction where the
    scene has a dynamic rigid and without it.  Fills ``worst`` and returns
    (the list, the force inputs, the forces of the scene's own variant)."""
    from sph_taichi_torch.ops import cuda_pairs as cp

    den, pairs = cp.density_sum_list(starts, p, params, {})
    ref_den, idx, cnt = cp.density_sum_list_plain(nl, p, params)
    err = max(float((den.double() - ref_den.double()).abs().max()),
              check_pair_list(pairs, nl, p, params, label,
                              plain=("density_sum_list", idx, cnt))[0])
    worst["density_sum_list"] = max(worst.get("density_sum_list", 0.0), err)
    if not torch.equal(den, ref_den):
        raise AssertionError(f"{label}: density_sum_list's sums differ from "
                             f"their plain version ({err:.3e})")
    q, dpi, p_r02, m_nc, rr0 = solver.force_inputs(p)
    dt = torch.full((), params.dt0, dtype=torch.float32, device=p.x.device)
    own = None
    for react in ((rr0, None) if rr0 is not None else (None,)):
        got = cp.wcsph_forces(pairs, q, dpi, p_r02, m_nc, react, dt, params)
        ref = cp.wcsph_forces_plain(nl, q, dpi, p_r02, m_nc, react, dt,
                                    params)
        for name, a, b in zip(("x", "v", "acc"), got, ref):
            e = float((a.double() - b.double()).abs().max())
            worst["wcsph_forces"] = max(worst.get("wcsph_forces", 0.0), e)
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{label}: wcsph_forces[react={react is not None}].{name}"
                    f" over the list differs from its plain version "
                    f"({e:.3e})")
        own = got if own is None else own
    variants = "with and without" if rr0 is not None else "without"
    print(f"  {label}: density_sum_list (sums and list) and wcsph_forces "
          f"over the list ({variants} the reaction) equal to their plain "
          f"versions bitwise, padding rows included")
    return pairs, (q, dpi, p_r02, m_nc, rr0, dt), own


def check_kernels_on_small_scenes(device):
    from sph_taichi_torch.ops import cuda_pairs as cp

    worst = {"density_sum": 0.0}
    for two_way in (False, True):
        params, solver, p, nl, starts, diag = prepared(
            small_scene(two_way), device, seed=0)
        occ = int(diag["max_cell_occupancy"])
        if occ <= 8 or int(diag["neighbor_overflow"]):
            raise AssertionError(f"clumped scene: occupancy {occ}, "
                                 f"overflow {int(diag['neighbor_overflow'])}")
        print(f"small scene two_way={two_way}: {params.n_particles} "
              f"particles, max cell occupancy {occ}, max neighbours "
              f"{int(diag['max_neighbors'])}")
        got = cp.density_sum(starts, p, params)
        ref = cp.density_sum_plain(nl, p.x, p.material, p.m_V, params)
        worst["density_sum"] = max(worst["density_sum"], max_errors(
            got, ref, f"density_sum[two_way={two_way}]"))
        _, (q, _, _, _, rr0, _), got = compare_wcsph_list_kernels(
            params, solver, p, nl, starts, f"two_way={two_way}", worst)
        if (rr0 is not None) != two_way:
            raise AssertionError("reaction variant not selected as expected")
        if two_way:
            rigid = q.material == 0
            g = torch.tensor(params.gravity, device=device)
            dev_acc = float((got[2][rigid] - g).abs().max())
            print(f"  reaction on the dynamic rigid: max |acc - g| "
                  f"{dev_acc:.3e}")
            if dev_acc < 1e-3:
                raise AssertionError("two-way reaction not exercised")
    return worst


def check_wcsph_on_edge_scene(device):
    """WCSPH's kernels on the edge scene (a ~100-particle cell: centres
    over the list, so warps that read the list beside warps that walk the
    cells in one phase; a dynamic rigid block, so the reaction), with
    padding velocities that are not 0: density_sum_list and wcsph_forces
    over its list, with and without the reaction, against their plain
    versions bitwise, padding rows included; bare cell offsets refused; the
    walk profiles; one kernel per wrapper call."""
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES

    scene = compact_edge_scene()
    cfg = scene["Configuration"]
    cfg["simulationMethod"], cfg["timeStepSize"] = 0, 4e-4
    params, solver, p, nl, starts, diag = prepared(
        scene, device, seed=0, place=compact_edge_positions)
    if int(diag["neighbor_overflow"]) or int(diag["cell_overflow"]):
        raise AssertionError("edge scene: the plain engine's caps overflowed")
    print(f"WCSPH edge scene: {params.n_particles} particles "
          f"({params.n_solid} dynamic solids), max cell occupancy "
          f"{int(diag['max_cell_occupancy'])}, max neighbours "
          f"{int(diag['max_neighbors'])}")
    n_real = params.n_fluid + params.n_solid
    vpad = p.v.clone()
    vpad[n_real:] = torch.arange(3 * (p.n - n_real), dtype=torch.float32,
                                 device=device).reshape(-1, 3)
    p = p._replace(v=vpad)
    worst = {}
    pairs, (q, dpi, p_r02, m_nc, rr0, dt), _ = compare_wcsph_list_kernels(
        params, solver, p, nl, starts, "WCSPH edge scene", worst)
    if rr0 is None:
        raise AssertionError("edge scene: no reaction variant")
    walk_profile(params, p.x, p.material >= 0, starts, nl,
                 "WCSPH edge scene, density_sum_list's centres (every real "
                 "one)", list_entries=PAIR_LIST_ENTRIES)
    fig = walk_profile(params, p.x, (p.material == 1) | p.is_dynamic_rigid(),
                       starts, nl, "WCSPH edge scene, wcsph_forces' centres "
                       "(fluid and dynamic rigid)",
                       list_entries=PAIR_LIST_ENTRIES)
    if not 0 < fig["warps_over_list"] < fig["warps"]:
        raise AssertionError("edge scene: no warp over the list beside one "
                             "within it")
    try:
        cp.wcsph_forces(starts, q, dpi, p_r02, m_nc, rr0, dt, params)
    except TypeError:
        print("  wcsph_forces refuses bare cell offsets")
    else:
        raise AssertionError("wcsph_forces: bare cell offsets not refused")
    buffers = {}
    calls = {
        "density_sum_list": lambda: cp.density_sum_list(starts, p, params,
                                                        buffers),
        "wcsph_forces": lambda: cp.wcsph_forces(pairs, q, dpi, p_r02, m_nc,
                                                rr0, dt, params),
        "wcsph_forces (no reaction)": lambda: cp.wcsph_forces(
            pairs, q, dpi, p_r02, m_nc, None, dt, params)}
    for name, fn in calls.items():
        key = name.split(" ")[0]
        before = cp.LAUNCHES[key]
        launched, lost = kernels_per_call(fn)
        counted = (cp.LAUNCHES[key] - before) / (2 + lost)
        print(f"  {name}: one wrapper call launches {launched} (its count "
              f"{counted:g} per call; captures that lost the markers {lost})")
        if len(launched) != 1 or key not in launched[0] or counted != 1:
            raise AssertionError(f"{name}: the wrapper launches {launched}")
    return {f"{k} (WCSPH edge scene)": v for k, v in worst.items()}


def random_kappa(p, seed=1):
    """A stiffness field with random signs and magnitudes 1e-7 .. 10 (0 off
    fluid): both sides of the m_eps gate, and large enough that a solver
    update moves the velocities."""
    rng = np.random.default_rng(seed)
    k = rng.choice([-1.0, 1.0], p.n) * 10.0 ** rng.uniform(-7, 1, p.n)
    k = torch.tensor(k.astype(np.float32), device=p.x.device)
    return torch.where(p.material == 1, k, 0.0)


def compare_dfsph_list_kernels(params, p, nl, starts, label, worst):
    """DFSPH's e1 and d over the cell runs against their plain versions at
    one state, whole outputs (padding rows included) equal bitwise:
    ``density_factor_list`` (the density, the factor and the step's pair
    list) and ``nonpressure_kick`` over that list.  Fills ``worst`` and
    returns (the list, ``p`` with the density and factor, dt)."""
    from sph_taichi_torch.ops import cuda_dfsph as cd

    def equal(name, got, ref, fields):
        for field, a, b in zip(fields, got, ref):
            e = float((a.double() - b.double()).abs().max())
            worst[name] = max(worst.get(name, 0.0), e)
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {name}.{field} differs from "
                                     f"its plain version ({e:.3e})")

    density, factor, pairs = cd.density_factor_list(starts, p, params, {})
    ref = cd.density_factor_list_plain(nl, p, params)
    equal("dfsph_density_factor", (density, factor), ref[:2],
          ("density", "factor"))
    worst["dfsph_density_factor"] = max(
        worst["dfsph_density_factor"], check_pair_list(
            pairs, nl, p, params, label,
            plain=("dfsph_density_factor_list", *ref[2:]))[0])
    q = p._replace(density=density, dfsph_factor=factor)
    dt = torch.full((), params.dt0, dtype=torch.float32, device=p.x.device)
    equal("nonpressure_kick", cd.nonpressure_kick(pairs, q, dt, params),
          cd.nonpressure_kick_plain(nl, q, dt, params), ("acc", "v"))
    print(f"  {label}: dfsph_density_factor_list (density, factor and list) "
          f"and nonpressure_kick over the list equal to their plain versions "
          f"bitwise, padding rows included")
    return pairs, q, dt


def compare_dfsph_kernels(params, solver, p, nl, starts, label, worst):
    """K1-K4 against their plain versions at one state (e1 and d over the
    cell runs bitwise, ``compare_dfsph_list_kernels``).  The stiffness is
    random with magnitudes 1e-7 .. 10, on both sides of the m_eps gate and
    large enough that the solver update moves the velocities."""
    from sph_taichi_torch.ops import cuda_dfsph as cd

    device = p.x.device

    def check(name, got, ref, what):
        for field, a, b in zip(what, got, ref):
            if b is None:
                continue
            worst[name] = max(worst.get(name, 0.0), max_errors(
                a, b, f"{name}[{label}].{field}"))

    _, p, dt = compare_dfsph_list_kernels(params, p, nl, starts, label, worst)
    for mode in cd.MODES:
        check("dfsph_divergence",
              cd.divergence(starts, p, p.v, p.density, dt, mode, params),
              cd.divergence_plain(nl, p, p.v, p.density, dt, mode, params),
              (f"{mode}.adv", f"{mode}.errt"))
    kappa = random_kappa(p)
    rng = np.random.default_rng(2)
    acc = torch.tensor(rng.uniform(-5, 5, (p.n, 3)).astype(np.float32),
                       device=device)
    for react in sorted({False, bool(params.dynamic_rigid_ids)}):
        got = cd.solver_dv(starts, p, kappa, p.v, acc, dt, react, params)
        ref = cd.solver_dv_plain(nl, p, kappa, p.v, acc, dt, react, params)
        check("dfsph_solver_dv", got, ref,
              (f"react={react}.v", f"react={react}.acc"))
        fluid = p.material == 1
        moved = float((got[0] != p.v)[fluid].float().mean())
        if moved < 0.5:
            raise AssertionError(f"solver update moved {moved:.2f} of the "
                                 f"fluid velocities")
        if react:
            dynr = p.is_dynamic_rigid()
            moved = float((got[1] - acc)[dynr].abs().max())
            print(f"  reaction on the dynamic rigid: max |acc change| "
                  f"{moved:.3e}")
            if moved < 1e-6:
                raise AssertionError("DFSPH reaction not exercised")


def check_dfsph_on_small_scenes(device):
    """The DFSPH kernels against their plain versions on clumped small
    scenes and on the floor-impact state; then the floor-impact scene's
    first two DFSPH steps, kernel engine against plain engine from the
    same state each step, with equal iteration counts."""
    from sph_taichi_torch import SimConfig, build_scene, build_solver
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops.pairs import GatherEngine

    worst = {}
    for kind, clump in (("small", True), ("two_way", True),
                        ("floor_impact", False)):
        params, solver, p, nl, starts, diag = prepared(
            dfsph_scene(kind), device, seed=0, clump=clump)
        if int(diag["neighbor_overflow"]):
            raise AssertionError(f"{kind}: neighbour cap overflowed")
        print(f"DFSPH small scene {kind}: {params.n_particles} particles, "
              f"max cell occupancy {int(diag['max_cell_occupancy'])}")
        compare_dfsph_kernels(params, solver, p, nl, starts, kind, worst)

    params, part, _ = build_scene(SimConfig(config_dict=dfsph_scene(
        "floor_impact")), device=device)
    ksolver = build_solver(params, device=device)
    psolver = build_solver(params, device=device,
                           engine=GatherEngine(params))
    state = ksolver.initialize(part)
    for step in range(2):
        cd.reset_launch_counts()
        ks, km = ksolver.step(state)
        ps, pm = psolver.step(state)
        its = [(int(km[k]), int(pm[k])) for k in ("divergence_iters",
                                                  "pressure_iters")]
        print(f"  floor impact step {step + 1}: iterations (kernel, plain) "
              f"divergence {its[0]} pressure {its[1]}; launches "
              f"{dict(cd.LAUNCHES)}")
        if any(a != b for a, b in its):
            raise AssertionError("iteration counts differ")
        real = ps.p.material != -1
        for name in ("x", "v", "density", "density_adv", "acc"):
            max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                       f"floor impact step {step + 1}: {name}")
        state = ks
    return worst


CLUMP = 96


def compact_edge_scene():
    """The two-way DFSPH scene (a fluid block above a dynamic rigid block)
    with the plain engines' caps raised for the clump of
    ``compact_edge_positions``."""
    d = dfsph_scene("two_way")
    d["TPU"] = {"cellCap": 128, "neighborCap": 192}
    return d


def compact_edge_positions(rng, params, x, material):
    """The scene's lattice jittered by up to 0.3 particle radii, and the
    CLUMP highest fluid particles moved into a ball of radius 0.45 h at
    the centre of cell (2, 3, 2): one cell of ~100 particles, each with ~100
    neighbours (tests/test_torch_dfsph_compact.py has the same generator)."""
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


def walk_profile(params, x, walkers, starts, nl, label, list_entries=None):
    """What the warps of the Jacobi kernels do at the sorted positions
    ``x``, computed in torch from the cell offsets and the plain neighbour
    lists ``nl`` (no device counter): warps of 32 consecutive rows, the rows
    ``walkers`` walking.  The one-phase walk (for_each_neighbor_walk) runs
    each column's candidates in lockstep, so a warp's candidate iterations
    are the sum over columns of the most candidates a lane has there, and
    it runs the pair body at every such iteration where a lane accepts.
    The two-phase walk over cell runs (for_each_neighbor_compact) runs
    the same candidate loop, in blocks of COMPACT_UNROLL steps, and the
    body as often as the fullest list wherever every lane's list flushes:
    at the end, and before a block where a list of LIST_ENTRIES has fewer
    than COMPACT_UNROLL entries free.  Also the (ix, iy) column groups of
    a warp.  With ``list_entries`` also the distribution of accepted
    pairs per walking lane and the iterations of the step-start list walk
    (csrc/pair_common.cuh ``for_each_listed_pair``).  Prints and returns
    the figures."""
    from sph_taichi_torch.ops.cuda_dfsph import COMPACT_UNROLL as unroll
    from sph_taichi_torch.ops.cuda_dfsph import LIST_ENTRIES as lists
    from sph_taichi_torch.ops.grid import pos_to_cell

    dev = x.device
    n = x.shape[0]
    nx, ny, nz = params.grid_num
    nw = (n + 31) // 32
    cell = pos_to_cell(x, params.grid_size).long()
    walk = walkers.clone()
    ix = torch.where(walk, cell[:, 0], 0)
    iy = torch.where(walk, cell[:, 1], 0)
    iz = torch.where(walk, cell[:, 2], 0)
    zlo = torch.clamp(iz - 1, min=0)
    zhi = torch.clamp(iz + 1, max=nz - 1)
    walk &= zlo <= zhi
    st = starts.long()
    b = torch.zeros(n, 9, dtype=torch.long, device=dev)
    cand = torch.zeros(n, 9, dtype=torch.long, device=dev)
    for k, (dx, dy) in enumerate(itertools.product((-1, 0, 1), repeat=2)):
        cx, cy = ix + dx, iy + dy
        ok = walk & (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
        base = (cx.clamp(0, nx - 1) * ny + cy.clamp(0, ny - 1)) * nz
        bb, ee = st[base + zlo], st[base + zhi + 1]
        b[:, k] = torch.where(ok, bb, 0)
        cand[:, k] = torch.where(ok, ee - bb, 0)
    wid = torch.arange(n, device=dev) // 32

    def per_warp(t):
        out = torch.zeros(nw * 32, *t.shape[1:], dtype=t.dtype, device=dev)
        out[:n] = t
        return out.view(nw, 32, *t.shape[1:])

    # accepted pairs of the walking rows, each in its centre's column
    valid = nl.mask() & walk[:, None]
    rows = torch.nonzero(valid)[:, 0]
    j = nl.idx[valid].long()
    k = ((cell[j, 0] - ix[rows] + 1) * 3 + (cell[j, 1] - iy[rows] + 1))
    pos = j - b[rows, k]
    if bool(((k < 0) | (k > 8)).any()) or bool(
            ((pos < 0) | (pos >= cand[rows, k])).any()):
        raise AssertionError(f"{label}: a neighbour outside its centre's "
                             f"candidate runs")
    accepted = torch.bincount(rows, minlength=n)
    live = per_warp(walk).any(1)
    nlive = int(live.sum())
    mean_acc = float(accepted[walk].double().mean())

    # one-phase walk: columns in lockstep
    colmax = per_warp(cand).max(1).values
    colpre = torch.cumsum(colmax, 1) - colmax
    old_t = colpre[wid[rows], k] + pos
    span = int(colmax.sum(1).max()) + 1
    old_body = torch.bincount(torch.unique(wid[rows] * span + old_t) // span,
                              minlength=nw)
    old_cand = colmax.sum(1)

    # two-phase walk: the same lockstep candidate loop in blocks of
    # ``unroll`` steps per column; before a block, every lane's list
    # flushes if one holds more than lists - unroll pairs, the body running
    # as often as the fullest list; once more at the end
    hit = torch.zeros(nw * 32, span, dtype=torch.bool, device=dev)
    hit[rows, old_t] = True
    hit = hit.view(nw, 32, span)
    check = torch.zeros(nw, span, dtype=torch.bool, device=dev)
    warps = torch.arange(nw, device=dev)
    for k2 in range(9):
        for m in range(0, int(colmax[:, k2].max()), unroll):
            at = m < colmax[:, k2]
            check[warps[at], (colpre[:, k2] + m)[at]] = True
    cnt = torch.zeros(nw, 32, dtype=torch.long, device=dev)
    body = torch.zeros(nw, dtype=torch.long, device=dev)
    flushes = torch.zeros(nw, dtype=torch.long, device=dev)
    for t in range(span):
        full = check[:, t] & (cnt > lists - unroll).any(1)
        body += torch.where(full, cnt.max(1).values, 0)
        flushes += full
        cnt[full] = 0
        cnt += hit[:, :, t]
    body += cnt.max(1).values
    # column groups: the walking lanes of a warp by (ix, iy)
    key = wid * (nx * ny) + ix * ny + iy
    ngroups = torch.bincount(torch.unique(key[walk]) // (nx * ny),
                             minlength=nw)

    fig = {
        "warps": nlive,
        "accepted_per_lane": mean_acc,
        "candidate_iters": float(old_cand[live].double().mean()),
        "one_phase_body_iters": float(old_body[live].double().mean()),
        "two_phase_body_iters": float(body[live].double().mean()),
        "flushes_mean": float(flushes[live].double().mean()),
        "flushes_max": int(flushes.max()),
        "warps_2plus_flushes": int((flushes >= 2).sum()),
        "warps_2plus_groups": int((ngroups >= 2).sum()),
        "groups_max": int(ngroups.max()),
        # each walking lane's own candidates, itself excluded
        "candidates_tested": int(cand[walk].sum()) - int(walk.sum())}
    if list_entries:
        # the step-start pair list of list_entries per centre: a warp whose
        # centres all fit reads it, max-over-lanes body iterations; a warp
        # holding a centre over it walks the cells in one phase
        acc_w = accepted[walk].double()
        fig["accepted_max"] = int(acc_w.max())
        fig["accepted_p99"] = float(torch.quantile(acc_w, 0.99))
        wmax = per_warp(torch.where(walk, accepted, 0)).max(1).values
        over = wmax > list_entries
        fig["share_over_list"] = float((acc_w > list_entries).double().mean())
        fig["warps_over_list"] = int((over & live).sum())
        fig["list_body_iters"] = float(torch.where(
            over, old_cand, wmax)[live].double().mean())
        print(f"{label} accepted pairs per walking lane: max "
              f"{fig['accepted_max']}, p99 {fig['accepted_p99']:.1f}, share "
              f"over {list_entries} {fig['share_over_list']:.2e}; "
              f"{fig['warps_over_list']} warps hold a centre over "
              f"{list_entries}; the list walk runs "
              f"{fig['list_body_iters']:.1f} iterations per warp "
              f"({fig['list_body_iters'] / mean_acc:.2f}x the accepted "
              f"pairs per lane; a warp over the list counted with its "
              f"one-phase candidate iterations)")
    print(f"{label} walk profile (torch, from the neighbour lists): "
          f"{nlive} warps, {mean_acc:.2f} accepted pairs per walking lane, "
          f"{fig['candidate_iters']:.1f} candidate iterations per warp; "
          f"the one-phase walk runs the body in "
          f"{fig['one_phase_body_iters']:.1f} of them "
          f"({fig['one_phase_body_iters'] / mean_acc:.2f}x the accepted "
          f"pairs per lane), the two-phase walk "
          f"{fig['two_phase_body_iters']:.1f} times "
          f"({fig['two_phase_body_iters'] / mean_acc:.2f}x); list {lists}: "
          f"flushes per warp mean {fig['flushes_mean']:.3f} max "
          f"{fig['flushes_max']}, warps with 2+ flushes "
          f"{fig['warps_2plus_flushes']}; warps with 2+ column groups "
          f"{fig['warps_2plus_groups']}, groups per warp max "
          f"{fig['groups_max']}")
    return fig


def compact_calls(params, solver, p, lists):
    """The Jacobi kernels' calls of ``solver_calls`` (divergence in both
    modes, the solver update with and without the reaction)."""
    return [c for c in solver_calls(4, params, solver, p, lists)
            if "divergence" in c[0] or "solver_dv" in c[0]]


def check_compact_walk_on_edge_scene(device):
    """The two-phase Jacobi kernels against their plain versions, bitwise,
    on the edge scene (a ~100-particle cell whose centres flush their lists
    more than once; warps in two columns; the dynamic rigid block), over
    cell runs and over the slot map (the cell overflows its 32 slots:
    kernel and plain slot lists drop the same pairs); the walk profile;
    each Jacobi wrapper launches one kernel, padding rows included (the
    whole outputs are compared)."""
    from sph_taichi_torch.ops.slots import build_slot_map, slot_neighbor_list

    params, solver, p, nl, starts, diag = prepared(
        compact_edge_scene(), device, seed=0, place=compact_edge_positions)
    if int(diag["neighbor_overflow"]) or int(diag["cell_overflow"]):
        raise AssertionError("edge scene: the plain engine's caps overflowed")
    print(f"compact-walk edge scene: {params.n_particles} particles, max "
          f"cell occupancy {int(diag['max_cell_occupancy'])}, max "
          f"neighbours {int(diag['max_neighbors'])}")
    caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
    smap = build_slot_map(starts, params)
    snl = slot_neighbor_list(smap, p.x, caps)
    if int(snl.diag["neighbor_overflow"]) or \
            not int(smap.diag["slot_overflow"]):
        raise AssertionError("edge scene: slot lists overflowed, or the "
                             "slot map did not")
    walkers = (p.material == 1) | p.is_dynamic_rigid()
    fig = walk_profile(params, p.x, walkers, starts, nl, "edge scene")
    if not (fig["warps_2plus_flushes"] and fig["warps_2plus_groups"]):
        raise AssertionError("edge scene: no warp flushes twice or holds "
                             "two column groups")
    worst, checked = {}, 0
    slist = slot_contexts(4, smap, p, params, "edge scene", snl)[1]
    for ctx, lists_ in ((starts, nl), (slist, snl)):
        suffix = "[slots]" if ctx is slist else ""
        for label, _, wrapper, plain, args in compact_calls(
                params, solver, p, lists_):
            got = outputs(wrapper(ctx, *args))
            ref = outputs(plain(lists_, *args))
            for a, b in zip(got, ref):
                if b is None:
                    continue
                err = float((a.double() - b.double()).abs().max())
                worst[label + suffix] = max(worst.get(label + suffix, 0.0),
                                            err)
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"edge scene {label}{suffix}: not equal to its "
                        f"plain version ({err:.3e})")
            checked += 1
    print(f"  {checked} kernel calls (divergence change / adv, solver_dv "
          f"with and without the reaction, cell runs and the slot list) "
          f"equal to their plain versions bitwise, padding rows included")
    from sph_taichi_torch.ops import cuda_dfsph as cd

    for label, _, wrapper, _, args in compact_calls(params, solver, p, nl):
        before = sum(cd.LAUNCHES.values())
        launched, lost = kernels_per_call(lambda: wrapper(starts, *args))
        # a warm-up call, then one call per capture
        counted = (sum(cd.LAUNCHES.values()) - before) / (2 + lost)
        print(f"  {label}: one wrapper call launches {launched} (its count "
              f"{counted:g} per call; captures that lost the markers "
              f"{lost})")
        if len(launched) != 1 or counted != 1:
            raise AssertionError(f"{label}: the wrapper launches "
                                 f"{len(launched)} kernels")
    return worst


def check_dfsph_on_edge_scene(device):
    """DFSPH's e1 and d on the edge scene (a ~100-particle cell: centres
    over the list, so warps that read the list beside warps that walk the
    cells in one phase), with padding densities and velocities that are not
    0: density_factor_list and nonpressure_kick over its list, and e1 over
    the slot map (the cell overflows its 32 slots; d over the slot walk
    reads a slot list: ``check_slot_list_readers_on_edge_scenes``), against
    their plain versions bitwise, padding rows included; d refuses bare
    cell offsets; the walk profile of their centres; one kernel per
    wrapper call."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES
    from sph_taichi_torch.ops.slots import build_slot_map, slot_neighbor_list

    params, solver, p, nl, starts, diag = prepared(
        compact_edge_scene(), device, seed=0, place=compact_edge_positions)
    if int(diag["neighbor_overflow"]) or int(diag["cell_overflow"]):
        raise AssertionError("edge scene: the plain engine's caps overflowed")
    print(f"DFSPH edge scene: {params.n_particles} particles "
          f"({params.n_solid} dynamic solids), max cell occupancy "
          f"{int(diag['max_cell_occupancy'])}, max neighbours "
          f"{int(diag['max_neighbors'])}")
    n_real = params.n_fluid + params.n_solid
    pad = torch.arange(3 * (p.n - n_real), dtype=torch.float32,
                       device=device)
    v, density = p.v.clone(), p.density.clone()
    v[n_real:] = pad.reshape(-1, 3)
    density[n_real:] = 1000.0 + pad[:p.n - n_real]
    p = p._replace(v=v, density=density)
    worst = {"dfsph_density_factor": 0.0}
    pairs, q, dt = compare_dfsph_list_kernels(params, p, nl, starts,
                                              "DFSPH edge scene", worst)
    fig = walk_profile(params, p.x, p.material == 1, starts, nl,
                       "DFSPH edge scene, e1's and d's centres (fluid)",
                       list_entries=PAIR_LIST_ENTRIES)
    if not 0 < fig["warps_over_list"] < fig["warps"]:
        raise AssertionError("edge scene: no warp over the list beside one "
                             "within it")
    caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
    smap = build_slot_map(starts, params)
    snl = slot_neighbor_list(smap, q.x, caps)
    name = "dfsph_density_factor[slots]"
    for a, b in zip(cd.density_factor(smap, p, params),
                    cd.density_factor_plain(snl, p, params)):
        e = float((a.double() - b.double()).abs().max())
        worst[name] = max(worst.get(name, 0.0), e)
        if not torch.equal(a, b):
            raise AssertionError(f"edge scene {name}: not equal to its "
                                 f"plain version ({e:.3e})")
    print("  e1 over the slot map equal to its plain version bitwise, "
          "padding rows included")
    for name, fn in (("nonpressure_kick",
                      lambda: cd.nonpressure_kick(starts, q, dt, params)),
                     ("nonpressure_accel",
                      lambda: cd.nonpressure_accel(starts, q, params))):
        try:
            fn()
        except TypeError:
            continue
        raise AssertionError(f"{name}: bare cell offsets not refused")
    print("  nonpressure_kick and nonpressure_accel refuse bare cell offsets")
    buffers = {}
    # name -> (its launch count, parts of the kernel's name, the call)
    calls = {
        "dfsph_density_factor (with the list)": (
            "dfsph_density_factor", ("dfsph_density_factor_list_kernel",),
            lambda: cd.density_factor_list(starts, p, params, buffers)),
        "nonpressure_kick (over the list)": (
            "nonpressure_kick", ("nonpressure_kick_kernel<true",
                                 "CellRunWalk"),
            lambda: cd.nonpressure_kick(pairs, q, dt, params)),
        "nonpressure_accel (over the list)": (
            "nonpressure_accel", ("nonpressure_kick_kernel<false",
                                  "CellRunWalk"),
            lambda: cd.nonpressure_accel(pairs, q, params))}
    for name, (key, kernel, fn) in calls.items():
        before = cd.LAUNCHES[key]
        launched, lost = kernels_per_call(fn)
        counted = (cd.LAUNCHES[key] - before) / (2 + lost)
        print(f"  {name}: one wrapper call launches {launched} (its count "
              f"{counted:g} per call; captures that lost the markers {lost})")
        if len(launched) != 1 or counted != 1 or not all(
                k in launched[0] for k in kernel):
            raise AssertionError(f"{name}: the wrapper launches {launched}")
    return {f"{k} (DFSPH edge scene)": v for k, v in worst.items()}


def corner_positions(rng, params, x, material):
    """``compact_edge_positions`` with the clump's ball centred on the
    corner that cells (2..3, 3..4, 2..3) share: ~12 of its particles in
    each of the 8 cells, none past the slot map's 32, each with ~100
    neighbours, so fluid centres over the step's list of 64 over the slot
    walk (tests/test_torch_dfsph_slot_list.py has the same generator)."""
    x = compact_edge_positions(rng, params, x, material)
    clump = np.linalg.norm(x - (np.array([2, 3, 2]) + 0.5)
                           * params.grid_size, axis=1) \
        < 0.46 * params.support_radius
    x[clump] += np.float32(0.5 * params.grid_size)
    return x


def slot_list_profile(p, cnt, react, label, walks=None):
    """What the warps of a list reader do over the step's slot list, from
    its counts ``cnt`` (every row; beyond the list too): warps of 32
    consecutive rows, the rows ``walks`` walking (by default the fluid
    rows and, with ``react``, the dynamic-rigid ones, as DFSPH's Jacobi
    kernels walk them; IISPH's kernels walk every real row).  A warp whose
    walking lanes are all within the list reads it (its body runs as often
    as its fullest lane's count); a warp holding a centre over the list
    walks the slot map in one phase.  Prints and returns the figures."""
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES as k_list

    n = p.n
    nw = (n + 31) // 32
    fluid = p.material == 1
    dynr = p.is_dynamic_rigid() if react else torch.zeros_like(fluid)
    if walks is None:
        walks = fluid | dynr

    def per_warp(t):
        out = torch.zeros(nw * 32, dtype=t.dtype, device=t.device)
        out[:n] = t
        return out.view(nw, 32)

    cnt_w = cnt[walks].double()
    live = per_warp(walks).any(1)
    over = per_warp(walks & (cnt > k_list)).any(1)
    wmax = per_warp(torch.where(walks, cnt, 0)).max(1).values
    reads = live & ~over
    fig = {"walking_centres": int(walks.sum()),
           "dynamic_rigid_centres": int(dynr.sum()),
           "accepted_mean": float(cnt_w.mean()),
           "accepted_max": int(cnt_w.max()),
           "accepted_p99": float(torch.quantile(cnt_w, 0.99)),
           "centres_over_list": int((cnt_w > k_list).sum()),
           "warps": int(live.sum()), "warps_over_list": int(over.sum()),
           "warps_dynamic_rigid": int(per_warp(dynr).any(1).sum()),
           "list_body_iters": float(wmax[reads].double().mean())
           if bool(reads.any()) else 0.0}
    print(f"{label} slot list walk profile (torch, from the list's counts): "
          f"{fig['walking_centres']} walking centres ("
          f"{fig['dynamic_rigid_centres']} dynamic rigid, in "
          f"{fig['warps_dynamic_rigid']} warps), accepted pairs per centre "
          f"mean {fig['accepted_mean']:.2f} max {fig['accepted_max']} p99 "
          f"{fig['accepted_p99']:.1f}, {fig['centres_over_list']} over the "
          f"list of {k_list}; {fig['warps']} warps walk, "
          f"{fig['warps_over_list']} hold a centre over the list and walk "
          f"the slot map in one phase; the list warps' body runs "
          f"{fig['list_body_iters']:.1f} times per warp "
          f"({fig['list_body_iters'] / max(fig['accepted_mean'], 1e-9):.2f}x "
          f"the accepted pairs per centre)")
    return fig


def slot_occupancy(method=4):
    """Prints the registers, shared memory and resident blocks of the slot
    instantiations that write and read the step's list: e1, the Jacobi
    kernels and kicked d (``method`` 4), the slot density kernel (beside
    the one-phase ``density_sum[slots]``) and b, both variants (0), f1-f4,
    f3 in both variants (2), or un-kicked d, g1 and g2 (1)."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_iisph as ci
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops import cuda_pcisph as cg

    if method in (0, 1, 2):
        rows = [("density_sum_list[slots] (writing the list)",
                 cp.occupancy("density_sum_list", True)),
                ("density_sum[slots] (one phase, no list)",
                 cp.occupancy("density_sum", True))]
    if method == 0:
        rows += [(f"{kernel}[slots] (over the list)",
                  cp.occupancy(kernel, slots=True))
                 for kernel in ("wcsph_forces", "wcsph_forces_react")]
    elif method == 1:
        rows += [("nonpressure_accel[slots] (over the list)",
                  cd.occupancy("nonpressure_accel", slots=True))]
        rows += [(f"{kernel}[slots] (over the list)",
                  cg.occupancy(kernel, slots=True))
                 for kernel in ("pcisph_d_rho_correct",
                                "pcisph_pressure_accel_predict")]
    elif method == 2:
        rows += [(f"{kernel}[slots] (over the list)",
                  ci.occupancy(kernel, slots=True))
                 for kernel in ("iisph_nonpressure_kick",
                                "iisph_predict_advection",
                                "iisph_pressure_accel",
                                "iisph_pressure_accel_advect",
                                "iisph_apply_A")]
    else:
        rows = [("dfsph_density_factor[slots] (writing the list)",
                 cd.occupancy("density_factor", True))]
        for kernel, variant in itertools.product(("divergence", "solver_dv"),
                                                 (False, True)):
            rows.append((f"{kernel}<{int(variant)}>[slots] (over the list)",
                         cd.jacobi_occupancy(kernel, variant, True)))
        rows.append(("nonpressure_kick[slots] (over the list)",
                     cd.occupancy("nonpressure_kick", slots=True)))
    for name, (regs, smem, blocks) in rows:
        print(f"  {name}: {regs} registers, {smem} bytes of shared memory "
              f"per block, {blocks} blocks of 128 per SM (occupancy "
              f"{blocks * 4 / 64:.3f})")


def slot_density_at_state(q, smap, snl, params, label):
    """The slot density kernel writing the step's list beside the
    one-phase ``density_sum[slots]`` on the same inputs (20 launches
    each, CUDA events): the sums equal bitwise, and the list against its
    plain version."""
    from sph_taichi_torch.ops import cuda_pairs as cp

    buffers = {}
    ms = time_ms(lambda: cp.density_sum_list(smap, q, params, buffers), 20)
    one_ms = time_ms(lambda: cp.density_sum(smap, q, params), 20)
    den, slist = cp.density_sum_list(smap, q, params, buffers)
    if not torch.equal(den, cp.density_sum(smap, q, params)):
        raise AssertionError(f"{label}: density_sum_list[slots]'s sums "
                             f"differ from density_sum[slots]'s")
    check_pair_list(slist, snl, q, params, f"{label} slot density list")
    print(f"{label}: density_sum_list[slots] (writing the list) {ms:.4f} ms, "
          f"density_sum[slots] (one phase, no list) {one_ms:.4f} ms on the "
          f"same inputs ({ms / one_ms - 1:+.1%}), sums equal bitwise")


def check_dfsph_slot_list_on_edge_scenes(device):
    """DFSPH's e1 over the slot walk with the step's list and the Jacobi
    kernels over that list on the edge scene (its ~100-particle cell
    overflows the slot map) and its corner form (no overflow; fluid
    centres over the list of 64), the dynamic rigid block's centres listed
    for the reaction, padding densities
    and velocities not 0: e1's density, factor and list and the four
    Jacobi instantiations against their plain versions over the slot lists
    bitwise, padding rows included; the walk profile over the list; the
    Jacobi wrappers refusing the bare slot map; one kernel per wrapper
    call."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops.slots import build_slot_map, slot_neighbor_list

    worst = {}
    for scene, place in (("edge", compact_edge_positions),
                         ("corner", corner_positions)):
        params, solver, p, nl, starts, diag = prepared(
            compact_edge_scene(), device, seed=0, place=place)
        n_real = params.n_fluid + params.n_solid
        pad = torch.arange(3 * (p.n - n_real), dtype=torch.float32,
                           device=device)
        v, density = p.v.clone(), p.density.clone()
        v[n_real:] = pad.reshape(-1, 3)
        density[n_real:] = 1000.0 + pad[:p.n - n_real]
        p = p._replace(v=v, density=density)
        caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
        smap = build_slot_map(starts, params)
        snl = slot_neighbor_list(smap, p.x, caps)
        if int(snl.diag["neighbor_overflow"]) or \
                bool(smap.diag["slot_overflow"]) != (scene == "edge"):
            raise AssertionError(f"{scene}: slot lists or map {smap.diag}")
        label = f"DFSPH slot list, {scene} scene"
        print(f"{label}: {params.n_particles} particles ({params.n_solid} "
              f"dynamic solids), max cell occupancy "
              f"{int(diag['max_cell_occupancy'])}, slot map "
              f"{ {k: int(x) for k, x in smap.diag.items()} }")
        density, factor, slist = cd.density_factor_list(smap, p, params, {})
        ref = cd.density_factor_list_plain(snl, p, params, "jacobi")
        for field, a, b in (("density", density, ref[0]),
                            ("factor", factor, ref[1])):
            e = float((a.double() - b.double()).abs().max())
            worst["dfsph_density_factor[slots]"] = max(
                worst.get("dfsph_density_factor[slots]", 0.0), e)
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: e1 {field} differs from "
                                     f"its plain version ({e:.3e})")
        check_pair_list(slist, snl, p, params, label, plain=(
            "dfsph_density_factor[slots]'s list", *ref[2:]))
        fig = slot_list_profile(p, slist.cnt, True, label)
        if not fig["warps_dynamic_rigid"] or fig["warps_over_list"] >= \
                fig["warps"] or (scene == "corner") != bool(
                    fig["warps_over_list"]):
            raise AssertionError(f"{label}: the scene misses an edge: {fig}")
        q = p._replace(density=density, dfsph_factor=factor)
        calls = compact_calls(params, solver, q, snl)
        for name, _, wrapper, plain, args in calls:
            for a, b in zip(outputs(wrapper(slist, *args)),
                            outputs(plain(snl, *args))):
                if b is None:
                    continue
                e = float((a.double() - b.double()).abs().max())
                worst[name + "[slots]"] = max(
                    worst.get(name + "[slots]", 0.0), e)
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: {name} over the list "
                                         f"differs from its plain version "
                                         f"({e:.3e})")
        print(f"  e1 (density, factor and list) and {len(calls)} Jacobi "
              f"calls over the list equal to their plain versions bitwise, "
              f"padding rows included")
        for name, _, wrapper, _, args in calls:
            try:
                wrapper(smap, *args)
            except TypeError:
                continue
            raise AssertionError(f"{name}: a bare slot map not refused")
        print("  the Jacobi wrappers refuse the bare slot map")
        if scene == "corner":
            continue
        buffers = {}
        per_call = [("dfsph_density_factor[slots] (with the list)",
                     "dfsph_density_factor[slots]",
                     ("dfsph_density_factor_slot_kernel",),
                     lambda: cd.density_factor_list(smap, p, params,
                                                    buffers))]
        for name, key, wrapper, _, args in calls:
            kernel = ("dfsph_divergence_kernel<" if "divergence" in name
                      else "dfsph_solver_dv_kernel<") + (
                "true" if name.endswith(("adv", "<REACT>")) else "false")
            per_call.append((name + "[slots] (over the list)",
                             key + "[slots]", (kernel, "SlotWalk"),
                             lambda w=wrapper, a=args: w(slist, *a)))
        for name, key, kernel, fn in per_call:
            before = cd.LAUNCHES[key]
            launched, lost = kernels_per_call(fn)
            counted = (cd.LAUNCHES[key] - before) / (2 + lost)
            print(f"  {name}: one wrapper call launches {launched} (its count "
                  f"{counted:g} per call; captures that lost the markers "
                  f"{lost})")
            if len(launched) != 1 or counted != 1 or not all(
                    k in launched[0] for k in kernel):
                raise AssertionError(f"{name}: the wrapper launches "
                                     f"{launched}")
    slot_occupancy()
    return {f"{k} (slot list edge scenes)": x for k, x in worst.items()}


def check_pcisph_slot_list_on_edge_scenes(device):
    """The slot density kernel writing the step's list of every real
    centre and PCISPH's g1 and g2 over that list on the edge scene as
    PCISPH (its ~100-particle cell overflows the slot map) and its corner
    form (no overflow; fluid centres over the list of 64, whose warps walk
    the map in one phase, pinned), at a seeded prediction, padding
    velocities and pressures not 0: density_sum_list[slots]'s sums and
    list and g1 and g2 against their plain versions over the slot lists
    bitwise, padding rows included; the walk profile over the list; the
    bare map refused by the wrappers (TypeError) and by the launchers
    (cudaErrorInvalidValue); one kernel per wrapper call."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops import cuda_pcisph as cg
    from sph_taichi_torch.ops.slots import build_slot_map, slot_neighbor_list

    worst = {}
    scene_dict = compact_edge_scene()
    scene_dict["Configuration"]["simulationMethod"] = 1
    for scene, place in (("edge", compact_edge_positions),
                         ("corner", corner_positions)):
        params, solver, p, nl, starts, diag = prepared(
            scene_dict, device, seed=0, place=place)
        n_real = params.n_fluid + params.n_solid
        pad = torch.arange(3 * (p.n - n_real), dtype=torch.float32,
                           device=device)
        v = p.v.clone()
        v[n_real:] = pad.reshape(-1, 3)
        p = p._replace(v=v, acc=cd.nonpressure_accel_plain(nl, p, params))
        xp, vp, pressure, dt, s_f = pcisph_inputs(params, solver, p)
        vp[n_real:] = -pad.reshape(-1, 3)
        pressure[n_real:] = 100.0 + pad[:p.n - n_real]
        caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
        smap = build_slot_map(starts, params)
        snl = slot_neighbor_list(smap, p.x, caps)
        if int(snl.diag["neighbor_overflow"]) or \
                bool(smap.diag["slot_overflow"]) != (scene == "edge"):
            raise AssertionError(f"{scene}: slot lists or map {smap.diag}")
        label = f"PCISPH slot list, {scene} scene"
        print(f"{label}: {params.n_particles} particles, max cell occupancy "
              f"{int(diag['max_cell_occupancy'])}, slot map "
              f"{ {k: int(x) for k, x in smap.diag.items()} }")
        den, slist = cp.density_sum_list(smap, p, params, {})
        ref_den = cp.density_sum_plain(snl, p.x, p.material, p.m_V, params)
        e = float((den.double() - ref_den.double()).abs().max())
        if not torch.equal(den, ref_den):
            raise AssertionError(f"{label}: density_sum_list[slots]'s sums "
                                 f"differ from their plain version ({e:.3e})")
        worst["density_sum_list[slots]"] = max(e, check_pair_list(
            slist, snl, p, params, label, plain=(
                "density_sum_list[slots]'s list",
                *cp.density_sum_list_plain(snl, p, params)[1:]))[0])
        fig = slot_list_profile(p, slist.cnt, False, label)
        if fig["warps_over_list"] >= fig["warps"] or \
                (scene == "corner") != bool(fig["warps_over_list"]):
            raise AssertionError(f"{label}: the scene misses an edge: {fig}")
        if pairs_moved(snl, xp, params.support_radius)[0] == 0:
            raise AssertionError(f"{label}: the prediction moved no pair "
                                 f"out of the radius")
        ref = cg.d_rho_correct_plain(snl, p, xp, vp, pressure, dt, s_f,
                                     params)
        ref2 = cg.pressure_accel_predict_plain(snl, p, xp, pressure, dt,
                                               params)
        calls = {
            "pcisph_d_rho_correct": (lambda c: cg.d_rho_correct(
                c, p, xp, vp, pressure, dt, s_f, params), ref),
            "pcisph_pressure_accel_predict": (
                lambda c: cg.pressure_accel_predict(c, p, xp, pressure, dt,
                                                    params), ref2)}
        for name, (fn, want) in calls.items():
            for a, b in zip(fn(slist), want):
                e = float((a.double() - b.double()).abs().max())
                worst[name + "[slots]"] = max(
                    worst.get(name + "[slots]", 0.0), e)
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: {name} over the list "
                                         f"differs from its plain version "
                                         f"({e:.3e})")
        print("  density_sum_list[slots] (sums and list), g1 and g2 over the "
              "list equal to their plain versions bitwise, padding rows "
              "included (padding velocities and pressures not 0)")
        for name, (fn, _) in calls.items():
            try:
                fn(smap)
            except TypeError:
                continue
            raise AssertionError(f"{name}: a bare slot map not refused")
        # the launchers given the slot map and no list
        _, n, ptr, walk, _ = cp._walk(smap, p, params)
        out = [torch.empty_like(p.m_V) for _ in range(2)] + [
            torch.empty_like(p.x) for _ in range(2)]
        rcs = [cg._lib().pcisph_d_rho_correct_launch(
                   ptr["x"], xp.data_ptr(), vp.data_ptr(), ptr["material"],
                   ptr["m_V"], p.density.data_ptr(), pressure.data_ptr(),
                   *walk, None, None, dt.data_ptr(), s_f.data_ptr(), None,
                   out[0].data_ptr(), out[1].data_ptr(), n,
                   cp.pair_consts(params), cp._stream(p.x.device)),
               cg._lib().pcisph_pressure_accel_predict_launch(
                   ptr["x"], xp.data_ptr(), ptr["material"], ptr["m_V"],
                   p.density.data_ptr(), pressure.data_ptr(),
                   p.v.data_ptr(), p.acc.data_ptr(), *walk, None, None,
                   dt.data_ptr(), None, out[2].data_ptr(),
                   out[3].data_ptr(), n,
                   cp.pair_consts(params), cp._stream(p.x.device))]
        torch.cuda.synchronize()
        if rcs != [1, 1]:    # cudaErrorInvalidValue
            raise AssertionError(f"{label}: the launchers given no list "
                                 f"returned {rcs}")
        print(f"  the wrappers refuse the bare slot map (TypeError), the "
              f"launchers a launch without the list (CUDA error {rcs[0]}, "
              f"cudaErrorInvalidValue)")
        if scene == "corner":
            continue
        per_call = [("density_sum_list[slots] (writing the list)", cp,
                     "density_sum_list[slots]", "density_sum_slot_kernel",
                     lambda: cp.density_sum_list(smap, p, params, {}))]
        per_call += [(f"{name}[slots] (over the list)", cg, name + "[slots]",
                      f"{name}_kernel<SlotWalk>", lambda f=fn: f(slist))
                     for name, (fn, _) in calls.items()]
        for name, module, key, kernel, fn in per_call:
            before = module.LAUNCHES[key]
            launched, lost = kernels_per_call(fn)
            counted = (module.LAUNCHES[key] - before) / (2 + lost)
            print(f"  {name}: one wrapper call launches {launched} (its count "
                  f"{counted:g} per call; captures that lost the markers "
                  f"{lost})")
            if len(launched) != 1 or counted != 1 or kernel not in \
                    launched[0]:
                raise AssertionError(f"{name}: the wrapper launches "
                                     f"{launched}")
    slot_occupancy(1)
    return {f"{k} (PCISPH slot list edge scenes)": x
            for k, x in worst.items()}


def slot_reader_calls(method, params, p, snl, smap, dt, pad):
    """The list readers of the slot step of ``method`` on the edge-scene
    particles ``p`` (padding rows of v and density not 0) and its slot
    map: (the step's list over the map, its plain version, the readers'
    particles, the rows they walk, {name: (the wrapper given a context, its
    plain outputs over the slot lists, module, parts of the kernel's name,
    the launcher given the map and no list)}, the call that the wrappers'
    refusal names).  A name's launch count is its first word with
    ``[slots]``.  f1, f2 and f3 (both variants) at a seeded pressure
    (padding pressures not 0) and f4 at f2's and f3's plain outputs there
    (padding rows not 0) over the slot density kernel's list (IISPH, 2); kicked
    d over e1's slot list at e1's densities (DFSPH, 4); un-kicked d over
    the slot density kernel's list (PCISPH, 1); b with and without the
    reaction over the slot density kernel's list at the step's density
    clamp and EOS (WCSPH, 0)."""
    from sph_taichi_torch import build_solver
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_iisph as ci
    from sph_taichi_torch.ops import cuda_pairs as cp

    n_real = params.n_fluid + params.n_solid
    _, n, ptr, walk, _ = cp._walk(smap, p, params)
    consts, stream = cp.pair_consts(params), cp._stream(p.x.device)
    out = [torch.empty_like(p.x) for _ in range(2)]
    if method == 4:
        density, factor, slist = cd.density_factor_list(smap, p, params, {})
        plain = ("dfsph_density_factor[slots]'s list",
                 *cd.density_factor_list_plain(snl, p, params, "jacobi")[2:])
        q = p._replace(density=density, dfsph_factor=factor)
        source = "density_factor_list"
        calls = {"nonpressure_kick": (
            lambda c: cd.nonpressure_kick(c, q, dt, params),
            cd.nonpressure_kick_plain(snl, q, dt, params), cd,
            ("nonpressure_kick_kernel<true", "SlotWalk"),
            lambda: cd._lib().nonpressure_kick_launch(
                ptr["x"], q.v.data_ptr(), ptr["material"],
                q.is_dynamic.data_ptr(), q.m.data_ptr(),
                q.density.data_ptr(), *walk, None, None, dt.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), n, consts, stream))}
        return slist, plain, q, q.material == 1, calls, source
    slist = cp.density_sum_list(smap, p, params, {})[1]
    plain = ("density_sum_list[slots]'s list",
             *cp.density_sum_list_plain(snl, p, params)[1:])
    source = "density_sum_list"
    if method == 0:
        q, dpi, p_r02, m_nc, rr0 = build_solver(
            params, device=p.x.device).force_inputs(p)
        if rr0 is None:
            raise AssertionError("WCSPH edge scene: no reaction variant")
        out.append(torch.empty_like(p.x))

        def forces(react):
            rr = rr0 if react else None
            launch = (lambda: cp._lib().wcsph_forces_launch(
                ptr["x"], q.v.data_ptr(), ptr["material"],
                q.is_dynamic.data_ptr(), q.m.data_ptr(), ptr["m_V"],
                dpi.data_ptr(), p_r02.data_ptr(), m_nc.data_ptr(),
                rr.data_ptr() if react else None, *walk, None, None,
                dt.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), int(react), n, consts, stream))
            return (lambda c: cp.wcsph_forces(c, q, dpi, p_r02, m_nc, rr,
                                              dt, params),
                    cp.wcsph_forces_plain(snl, q, dpi, p_r02, m_nc, rr, dt,
                                          params), cp,
                    (f"wcsph_forces_kernel<{str(react).lower()}",
                     "SlotWalk"), launch)

        calls = {"wcsph_forces": forces(False),
                 "wcsph_forces (reaction)": forces(True)}
        return slist, plain, q, (q.material == 1) | q.is_dynamic_rigid(), \
            calls, source
    if method == 1:
        calls = {"nonpressure_accel": (
            lambda c: (cd.nonpressure_accel(c, p, params),),
            (cd.nonpressure_accel_plain(snl, p, params),), cd,
            ("nonpressure_kick_kernel<false", "SlotWalk"),
            lambda: cd._lib().nonpressure_accel_launch(
                ptr["x"], p.v.data_ptr(), ptr["material"],
                p.is_dynamic.data_ptr(), p.m.data_ptr(),
                p.density.data_ptr(), *walk, None, None, out[0].data_ptr(),
                n, consts, stream))}
        return slist, plain, p, p.material == 1, calls, source
    pressure = random_pressure(p)
    pressure[n_real:] = 100.0 + pad[:p.n - n_real]
    # f2 with the warm start from that pressure; f4 at f2's and f3's plain
    # outputs, the pressure the last iterate, padding rows not 0
    pf2 = p._replace(pressure=pressure)
    a_ii, src, _ = ci.predict_advection_plain(snl, pf2, dt, params)
    accel = ci.pressure_accel_plain(snl, p, pressure, params)
    accel[n_real:] = -pad.reshape(-1, 3)
    a_ii[n_real:] = -1.0 - pad[:p.n - n_real]
    src[n_real:] = 1.0 + pad[:p.n - n_real]
    rows = [torch.empty_like(p.m_V) for _ in range(3)]

    def launch(adv):
        return lambda: ci._lib().iisph_pressure_accel_launch(
            ptr["x"], ptr["material"], ptr["m_V"], p.density.data_ptr(),
            pressure.data_ptr(), *walk, None, None, p.v.data_ptr(),
            dt.data_ptr(), None, out[0].data_ptr(), out[1].data_ptr(), adv,
            n, consts, stream)

    calls = {
        "iisph_nonpressure_kick": (
            lambda c: ci.nonpressure_kick(c, p, dt, params),
            ci.nonpressure_kick_plain(snl, p, dt, params), ci,
            ("iisph_nonpressure_kick_list_kernel", "SlotWalk"),
            lambda: ci._lib().iisph_nonpressure_kick_launch(
                ptr["x"], p.v.data_ptr(), ptr["material"], p.m.data_ptr(),
                p.density.data_ptr(), *walk, None, None, dt.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), n, consts, stream)),
        "iisph_predict_advection": (
            lambda c: ci.predict_advection(c, pf2, dt, params),
            ci.predict_advection_plain(snl, pf2, dt, params), ci,
            ("iisph_predict_advection_list_kernel", "SlotWalk"),
            lambda: ci._lib().iisph_predict_advection_launch(
                ptr["x"], p.v.data_ptr(), ptr["material"], ptr["m_V"],
                p.density.data_ptr(), pressure.data_ptr(), *walk, None, None,
                dt.data_ptr(), *(r.data_ptr() for r in rows), n, consts,
                stream)),
        "iisph_pressure_accel": (
            lambda c: (ci.pressure_accel(c, p, pressure, params),),
            (ci.pressure_accel_plain(snl, p, pressure, params),), ci,
            ("iisph_pressure_accel_kernel<false", "SlotWalk"), launch(0)),
        "iisph_pressure_accel_advect": (
            lambda c: ci.pressure_accel(c, p, pressure, params, advect_dt=dt),
            ci.pressure_accel_plain(snl, p, pressure, params, advect_dt=dt),
            ci, ("iisph_pressure_accel_kernel<true", "SlotWalk"),
            launch(1)),
        "iisph_apply_A": (
            lambda c: ci.apply_A(c, p, accel, a_ii, src, pressure, dt, 0.5,
                                 params),
            ci.apply_A_plain(snl, p, accel, a_ii, src, pressure, dt, 0.5,
                             params), ci,
            ("iisph_apply_A_kernel<SlotWalk",),
            lambda: ci._lib().iisph_apply_A_launch(
                ptr["x"], ptr["material"], ptr["m_V"], accel.data_ptr(),
                a_ii.data_ptr(), src.data_ptr(), pressure.data_ptr(),
                *walk, None, None, dt.data_ptr(), None, 0.5,
                rows[0].data_ptr(), rows[1].data_ptr(), n, consts, stream))}
    return slist, plain, p, p.material >= 0, calls, source


def check_slot_list_readers_on_edge_scenes(device):
    """WCSPH's b (both variants), IISPH's f1-f4 (f3 in both variants) and
    PCISPH's un-kicked d over the list that the slot density kernel
    writes, and DFSPH's kicked d over the list that e1 writes over the
    slot walk, on the edge scene (its ~100-particle cell overflows the
    slot map) and its corner form (no overflow; centres over the list of
    64, whose warps walk the map in one phase, pinned), padding
    velocities, densities and pressures not 0:
    each list and each reader against its plain version over the slot
    lists bitwise, padding rows included; the walk profile of each
    reader's centres over its list; the bare map refused by the wrappers
    (TypeError naming the context's source) and by the launchers
    (cudaErrorInvalidValue); one kernel per wrapper call."""
    from sph_taichi_torch.ops.slots import build_slot_map, slot_neighbor_list

    worst = {}
    for scene, place in (("edge", compact_edge_positions),
                         ("corner", corner_positions)):
        for method in (2, 4, 1, 0):
            scene_dict = compact_edge_scene()
            cfg = scene_dict["Configuration"]
            cfg["simulationMethod"] = method
            if method == 0:
                cfg["timeStepSize"] = 4e-4    # as the WCSPH edge scene
            params, _, p, _, starts, diag = prepared(
                scene_dict, device, seed=0, place=place)
            n_real = params.n_fluid + params.n_solid
            pad = torch.arange(3 * (p.n - n_real), dtype=torch.float32,
                               device=device)
            v, density = p.v.clone(), p.density.clone()
            v[n_real:] = pad.reshape(-1, 3)
            density[n_real:] = 1000.0 + pad[:p.n - n_real]
            p = p._replace(v=v, density=density)
            caps = dataclasses.replace(params, neighbor_cap=256,
                                       cell_cap=128)
            smap = build_slot_map(starts, params)
            snl = slot_neighbor_list(smap, p.x, caps)
            if int(snl.diag["neighbor_overflow"]) or \
                    bool(smap.diag["slot_overflow"]) != (scene == "edge"):
                raise AssertionError(f"{scene}: slot lists or map "
                                     f"{smap.diag}")
            dt = torch.full((), params.dt0, dtype=torch.float32,
                            device=device)
            solver = {2: "IISPH", 4: "DFSPH", 1: "PCISPH", 0: "WCSPH"}
            label = f"slot list readers, {scene} scene, {solver[method]}"
            print(f"{label}: {params.n_particles} particles, max cell "
                  f"occupancy {int(diag['max_cell_occupancy'])}, slot map "
                  f"{ {k: int(x) for k, x in smap.diag.items()} }")
            slist, plain, q, walks, calls, source = slot_reader_calls(
                method, params, p, snl, smap, dt, pad)
            check_pair_list(slist, snl, q, params, label, plain=plain)
            fig = slot_list_profile(q, slist.cnt, False, label, walks=walks)
            if fig["warps_over_list"] >= fig["warps"] or (
                    scene == "corner" and not fig["warps_over_list"]):
                raise AssertionError(f"{label}: the scene misses an edge: "
                                     f"{fig}")
            for name, (fn, want, _, _, launch) in calls.items():
                key = name.split(" ")[0] + "[slots]"
                for a, b in zip(outputs(fn(slist)), want):
                    e = float((a.double() - b.double()).abs().max())
                    worst[key] = max(worst.get(key, 0.0), e)
                    if not torch.equal(a, b):
                        raise AssertionError(f"{label}: {name} over the "
                                             f"list differs from its plain "
                                             f"version ({e:.3e})")
                try:
                    fn(smap)
                except TypeError as e:
                    if source not in str(e):
                        raise AssertionError(f"{name}: the refusal does not "
                                             f"name {source}: {e}")
                else:
                    raise AssertionError(f"{name}: a bare slot map not "
                                         f"refused")
                rc = launch()
                torch.cuda.synchronize()
                if rc != 1:    # cudaErrorInvalidValue
                    raise AssertionError(f"{label}: {name}'s launcher given "
                                         f"no list returned {rc}")
            print(f"  {', '.join(calls)} over the list equal to "
                  f"{'their' if len(calls) > 1 else 'its'} plain "
                  f"version{'s' if len(calls) > 1 else ''} bitwise, padding "
                  f"rows included; the bare map refused by the wrapper "
                  f"(TypeError naming {source}) and the launcher given no "
                  f"list (CUDA error 1, cudaErrorInvalidValue)")
            if scene == "corner":
                continue
            for name, (fn, _, module, kernel, _) in calls.items():
                key = name.split(" ")[0] + "[slots]"
                before = module.LAUNCHES[key]
                launched, lost = kernels_per_call(lambda f=fn: f(slist))
                counted = (module.LAUNCHES[key] - before) / (2 + lost)
                print(f"  {name}[slots] (over the list): one wrapper call "
                      f"launches "
                      f"{launched} (its count {counted:g} per call; captures "
                      f"that lost the markers {lost})")
                if len(launched) != 1 or counted != 1 or not all(
                        k in launched[0] for k in kernel):
                    raise AssertionError(f"{key}: the wrapper launches "
                                         f"{launched}")
    slot_occupancy(2)
    slot_occupancy(0)
    return {f"{k} (slot list reader edge scenes)": x
            for k, x in worst.items()}


def check_pcisph_on_edge_scene(device):
    """PCISPH's loop kernels over the step's list (``density_sum_list``'s)
    on the edge scene (a ~100-particle cell: centres over the list, so
    warps that read the list beside warps that walk the cells in one
    phase) at a seeded prediction: g1 and g2 over the list and over the
    slot map's list (the cell overflows its 32 slots) and un-kicked d over
    the list against their plain versions bitwise, padding rows included,
    and
    refusing the bare cell offsets; the list against its plain version;
    the walk profile; one kernel per wrapper call."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops import cuda_pcisph as cg
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES
    from sph_taichi_torch.ops.slots import build_slot_map, slot_neighbor_list

    scene = compact_edge_scene()
    scene["Configuration"]["simulationMethod"] = 1
    params, solver, p, nl, starts, diag = prepared(
        scene, device, seed=0, place=compact_edge_positions)
    if int(diag["neighbor_overflow"]) or int(diag["cell_overflow"]):
        raise AssertionError("edge scene: the plain engine's caps overflowed")
    print(f"PCISPH edge scene: {params.n_particles} particles, max cell "
          f"occupancy {int(diag['max_cell_occupancy'])}, max neighbours "
          f"{int(diag['max_neighbors'])}")
    p = p._replace(acc=cd.nonpressure_accel_plain(nl, p, params))
    xp, vp, pressure, dt, s_f = pcisph_inputs(params, solver, p)
    pairs = cp.density_sum_list(starts, p, params, {})[1]
    worst = {"density_sum_list (PCISPH edge scene)": check_pair_list(
        pairs, nl, p, params, "PCISPH edge scene")[0]}
    fig = walk_profile(params, p.x, p.material == 1, starts, nl,
                       "PCISPH edge scene", list_entries=PAIR_LIST_ENTRIES)
    if not 0 < fig["warps_over_list"] < fig["warps"]:
        raise AssertionError("edge scene: no warp over the list beside one "
                             "within it")
    caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
    smap = build_slot_map(starts, params)
    snl = slot_neighbor_list(smap, p.x, caps)
    checked = 0
    # over the slot walk, the list that the slot density kernel writes
    slist = cp.density_sum_list(smap, p, params, {})[1]
    for ctx, lists_, how in ((pairs, nl, "list"), (slist, snl, "slots")):
        ref = cg.d_rho_correct_plain(lists_, p, xp, vp, pressure, dt, s_f,
                                     params)
        ref2 = cg.pressure_accel_predict_plain(lists_, p, xp, ref[0], dt,
                                               params)
        for name, got, want in (
                ("pcisph_d_rho_correct", cg.d_rho_correct(
                    ctx, p, xp, vp, pressure, dt, s_f, params), ref),
                ("pcisph_pressure_accel_predict", cg.pressure_accel_predict(
                    ctx, p, xp, ref[0], dt, params), ref2)):
            key = name + ("[slots]" if how == "slots" else "")
            for a, b in zip(got, want):
                err = float((a.double() - b.double()).abs().max())
                worst[key] = max(worst.get(key, 0.0), err)
                if not torch.equal(a, b):
                    raise AssertionError(f"edge scene {name} over {how}: not "
                                         f"equal to its plain version "
                                         f"({err:.3e})")
            checked += 1
    got = cd.nonpressure_accel(pairs, p, params)
    want = cd.nonpressure_accel_plain(nl, p, params)
    worst["nonpressure_accel"] = float((got.double() - want.double())
                                       .abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"edge scene nonpressure_accel over the list: "
                             f"not equal to its plain version "
                             f"({worst['nonpressure_accel']:.3e})")
    checked += 1
    print(f"  {checked} PCISPH kernel calls (g1, g2 over the list and the "
          f"slots, un-kicked d over the list) equal to their plain versions "
          f"bitwise, padding rows included")
    for name, fn in (("pcisph_d_rho_correct", lambda: cg.d_rho_correct(
            starts, p, xp, vp, pressure, dt, s_f, params)),
                     ("pcisph_pressure_accel_predict",
                      lambda: cg.pressure_accel_predict(
                          starts, p, xp, pressure, dt, params)),
                     ("nonpressure_accel",
                      lambda: cd.nonpressure_accel(starts, p, params))):
        try:
            fn()
        except TypeError:
            continue
        raise AssertionError(f"{name}: bare cell offsets not refused")
    print("  g1, g2 and un-kicked d refuse bare cell offsets")
    calls = {
        "pcisph_d_rho_correct": lambda: cg.d_rho_correct(
            pairs, p, xp, vp, pressure, dt, s_f, params),
        "pcisph_pressure_accel_predict": lambda: cg.pressure_accel_predict(
            pairs, p, xp, pressure, dt, params),
        "nonpressure_accel": lambda: cd.nonpressure_accel(pairs, p, params)}
    for name, fn in calls.items():
        module = cd if name == "nonpressure_accel" else cg
        kernel = ("nonpressure_kick_kernel<false"
                  if name == "nonpressure_accel" else name)
        before = module.LAUNCHES[name]
        launched, lost = kernels_per_call(fn)
        counted = (module.LAUNCHES[name] - before) / (2 + lost)
        print(f"  {name}: one wrapper call launches {launched} (its count "
              f"{counted:g} per call; captures that lost the markers {lost})")
        if len(launched) != 1 or kernel not in launched[0] or counted != 1:
            raise AssertionError(f"{name}: the wrapper launches {launched}")
    return worst


def check_iisph_on_edge_scene(device):
    """IISPH's four kernels over the step's list (``density_sum_list``'s,
    every real centre) on the edge scene (a ~100-particle cell: centres
    over the list, so warps that read the list beside warps that walk the
    cells in one phase) at a seeded pressure, with padding velocities that
    are not 0: the list against its plain version; f1, f2, f3 (both
    variants) and f4 over the list and over the slot map's list (the cell
    overflows its 32 slots) against their plain versions bitwise, padding
    rows included; bare
    cell offsets refused; the walk profile; one kernel per wrapper call."""
    from sph_taichi_torch.ops import cuda_iisph as ci
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES
    from sph_taichi_torch.ops.slots import build_slot_map, slot_neighbor_list

    scene = compact_edge_scene()
    scene["Configuration"]["simulationMethod"] = 2
    params, solver, p, nl, starts, diag = prepared(
        scene, device, seed=0, place=compact_edge_positions)
    if int(diag["neighbor_overflow"]) or int(diag["cell_overflow"]):
        raise AssertionError("edge scene: the plain engine's caps overflowed")
    print(f"IISPH edge scene: {params.n_particles} particles "
          f"({params.n_solid} solids), max cell occupancy "
          f"{int(diag['max_cell_occupancy'])}, max neighbours "
          f"{int(diag['max_neighbors'])}")
    dt = torch.full((), params.dt0, dtype=torch.float32, device=device)
    # padding rows of v that f1 and the advect must carry through
    n_real = params.n_fluid + params.n_solid
    vpad = p.v.clone()
    vpad[n_real:] = torch.arange(3 * (p.n - n_real), dtype=torch.float32,
                                 device=device).reshape(-1, 3)
    p0 = p._replace(v=vpad, pressure=random_pressure(p, seed=4))
    acc, v = ci.nonpressure_kick_plain(nl, p0, dt, params)
    p = p0._replace(acc=acc, v=v)
    a_ii, source, _ = ci.predict_advection_plain(nl, p, dt, params)
    pressure = random_pressure(p)
    pairs = cp.density_sum_list(starts, p, params, {})[1]
    worst = {"density_sum_list": check_pair_list(
        pairs, nl, p, params, "IISPH edge scene")[0]}
    fig = walk_profile(params, p.x, p.material >= 0, starts, nl,
                       "IISPH edge scene", list_entries=PAIR_LIST_ENTRIES)
    if not 0 < fig["warps_over_list"] < fig["warps"]:
        raise AssertionError("edge scene: no warp over the list beside one "
                             "within it")
    caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=128)
    smap = build_slot_map(starts, params)
    snl = slot_neighbor_list(smap, p.x, caps)
    accel = ci.pressure_accel_plain(nl, p, pressure, params)

    def calls(ctx):
        return {
            "iisph_nonpressure_kick": lambda: ci.nonpressure_kick(
                ctx, p0, dt, params),
            "iisph_predict_advection": lambda: ci.predict_advection(
                ctx, p, dt, params),
            "iisph_pressure_accel": lambda: ci.pressure_accel(
                ctx, p, pressure, params),
            "iisph_pressure_accel_advect": lambda: ci.pressure_accel(
                ctx, p, pressure, params, advect_dt=dt),
            "iisph_apply_A": lambda: ci.apply_A(
                ctx, p, accel, a_ii, source, pressure, dt, 0.5, params)}

    checked = 0
    # over the slot walk, the list that the slot density kernel writes
    slist = cp.density_sum_list(smap, p, params, {})[1]
    for ctx, lists_, how in ((pairs, nl, "list"), (slist, snl, "slots")):
        refs = {
            "iisph_nonpressure_kick": ci.nonpressure_kick_plain(
                lists_, p0, dt, params),
            "iisph_predict_advection": ci.predict_advection_plain(
                lists_, p, dt, params),
            "iisph_pressure_accel": (ci.pressure_accel_plain(
                lists_, p, pressure, params),),
            "iisph_pressure_accel_advect": ci.pressure_accel_plain(
                lists_, p, pressure, params, advect_dt=dt),
            "iisph_apply_A": ci.apply_A_plain(lists_, p, accel, a_ii, source,
                                              pressure, dt, 0.5, params)}
        for name, fn in calls(ctx).items():
            got = outputs(fn())
            key = name + ("[slots]" if how == "slots" else "")
            for a, b in zip(got, refs[name]):
                err = float((a.double() - b.double()).abs().max())
                worst[key] = max(worst.get(key, 0.0), err)
                if not torch.equal(a, b):
                    raise AssertionError(f"edge scene {name} over {how}: not "
                                         f"equal to its plain version "
                                         f"({err:.3e})")
            checked += 1
    print(f"  {checked} IISPH kernel calls (f1, f2, f3, f3 with the advect, "
          f"f4 over the list and the slots) equal to their plain versions "
          f"bitwise, padding rows included (padding velocities not 0)")
    for name, fn in calls(starts).items():
        try:
            fn()
        except TypeError:
            continue
        raise AssertionError(f"{name}: bare cell offsets not refused")
    print("  f1, f2, f3 and f4 refuse bare cell offsets")
    kernels = {"iisph_nonpressure_kick": "iisph_nonpressure_kick_list_kernel",
               "iisph_predict_advection":
                   "iisph_predict_advection_list_kernel"}
    for name, fn in calls(pairs).items():
        before = ci.LAUNCHES[name]
        launched, lost = kernels_per_call(fn)
        counted = (ci.LAUNCHES[name] - before) / (2 + lost)
        print(f"  {name}: one wrapper call launches {launched} (its count "
              f"{counted:g} per call; captures that lost the markers {lost})")
        kernel = kernels.get(name, name.replace("_advect", ""))
        if len(launched) != 1 or kernel not in launched[0] or counted != 1:
            raise AssertionError(f"{name}: the wrapper launches {launched}")
    return {f"{k} (IISPH edge scene)": v for k, v in worst.items()}


MARKER = "spin_kernel"   # the kernel of torch.cuda._sleep


def kernels_per_call(fn, tries=5):
    """The device activities (kernels, copies, fills) of one call of
    ``fn``, by name, from torch.profiler, and the number of captures taken
    again.  The call stands between two marker kernels, with a millisecond
    of host time on either side; a capture counts only if both markers show
    in it, because the profiler can lose the device records of so short a
    window (a lost capture is taken again, at most ``tries`` times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(1e-3)
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(1e-3)
        names = [e.key[:60] for e in prof.key_averages()
                 for _ in range(e.count)
                 if str(e.device_type).endswith("CUDA")]
        if sum(MARKER in k for k in names) == 2:
            return [k for k in names if MARKER not in k], attempt
    raise AssertionError(f"profiler: the markers of a call were lost in "
                         f"{tries} captures")


def compact_at_dragon(params, q, starts, nl, kappa, dt):
    """The two-phase walk at the dragon state: its walk profile, the
    registers, shared memory and resident blocks of each instantiation,
    and a launch with the Jacobi flag false (no traversal)."""
    from sph_taichi_torch.ops import cuda_dfsph as cd

    walk_profile(params, q.x, q.material == 1, starts, nl,
                 "dragon_bath_dfsph state")
    for kernel, variant in itertools.product(("divergence", "solver_dv"),
                                             (False, True)):
        for slots in (False, True):
            regs, smem, blocks = cd.jacobi_occupancy(kernel, variant, slots)
            print(f"  {kernel}<{int(variant)}>{'[slots]' if slots else ''}:"
                  f" {regs} registers, {smem} bytes of shared memory per "
                  f"block, {blocks} blocks of 128 per SM (occupancy "
                  f"{blocks * 4 / 64:.3f})")
    off = torch.zeros((), dtype=torch.bool, device=q.x.device)
    calls = {
        "change": ("dfsph_divergence_kernel<false", lambda: cd.divergence(
            starts, q, q.v, None, None, "change", params, active=off)),
        "adv": ("dfsph_divergence_kernel<true", lambda: cd.divergence(
            starts, q, q.v, q.density, dt, "adv", params, active=off)),
        "solver_dv": ("dfsph_solver_dv_kernel<false", lambda: cd.solver_dv(
            starts, q, kappa, q.v, None, dt, False, params, active=off))}
    for name, (kernel, fn) in calls.items():
        print(f"  {name}: a launch with the Jacobi flag false takes "
              f"{kernel_ms(fn, kernel, 20):.4f} ms on the card (profiler)")


def kernel_rows(prof):
    """(device us, launches, name) of each kernel a profiler recorded:
    kernel rows only, since an aten op's row repeats its kernels' time."""
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return rows


def profile_steps(sim, steps, counts=None):
    """Device busy share and the kernels by device time over ``steps``
    steps of ``Simulation.run`` under torch.profiler (the profiler adds
    host overhead, so the busy share it shows is a lower bound).  Fills
    ``counts`` (a dict) with each kernel's launches in the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(steps // sim.substeps, export=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = kernel_rows(prof)
    if counts is not None:
        for _, count, key in rows:
            counts[key] = counts.get(key, 0) + count
    if not rows:
        print("profiler: no device time recorded; busy share not measured")
        return None
    busy = sum(r[0] for r in rows)
    print(f"profiler over {steps} steps: wall {wall_us / steps:.1f} us/step "
          f"under the profiler, device busy {busy / steps:.1f} us/step, "
          f"{sum(r[1] for r in rows) / steps:.1f} kernels/step")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {dev_us / steps:9.2f} us/step  {count / steps:5.1f}/step  "
              f"{key[:90]}")
    return busy / steps / 1e3


def check_state(sim):
    """Finite positions and velocities, the fluid inside the padded box,
    the last step's sort invariant intact."""
    from sph_taichi_torch.ops import cuda_pairs as cp

    p = sim.state.p
    xf = p.x[p.material == 1]
    lo, hi = cp.box_limits(sim.params)
    hi = torch.tensor(hi, device=p.x.device)
    if not bool(torch.isfinite(p.x).all() & torch.isfinite(p.v).all()):
        raise AssertionError("non-finite positions or velocities")
    if not bool((xf >= lo).all() & (xf <= hi).all()):
        raise AssertionError("fluid left the padded box")
    if bool(sim.metrics["sort_invariant_violated"]):
        raise AssertionError("sort invariant violated")


def reset_all_launch_counts():
    from sph_taichi_torch import entry
    entry.reset_launch_counts()


def all_launch_counts():
    from sph_taichi_torch import entry
    return entry.launch_counts()


def main_path(device, scene_path, warmup, steps):
    from sph_taichi_torch import build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pairs import GatherEngine

    t0 = time.perf_counter()
    sim = simulation(scene_path)
    dense0 = DENSE_CALLS["dense"]
    params = sim.params
    print(f"dragon_bath: {params.n_particles} particles (fluid "
          f"{params.n_fluid}, solid {params.n_solid}), n_pad {params.n_pad}, "
          f"grid {params.grid_num}, dt {params.dt0}; scene + initialize "
          f"{time.perf_counter() - t0:.2f} s")
    sim.run(warmup, export=False)
    torch.cuda.synchronize()
    # a step makes no host sync: PyTorch raises on one in this mode
    torch.cuda.set_sync_debug_mode("error")
    sim.solver.step(sim.state)
    torch.cuda.set_sync_debug_mode("default")
    print("one step under torch.cuda sync-debug mode 'error': no host sync")

    # the WCSPH path: counts to 0 just before, read just after
    reset_all_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = all_launch_counts()
    step_ms = start.elapsed_time(end) / steps
    print(f"WCSPH path: {steps} steps, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s; launches {launches}")
    expect = {"density_sum_list": steps, "wcsph_forces": steps}
    for name, count in launches.items():
        if count != expect.get(name, 0):
            raise AssertionError(f"{name}: {count} launches in {steps} "
                                 f"WCSPH steps, expected "
                                 f"{expect.get(name, 0)}")
    dense_calls_since(dense0, "WCSPH path")

    busy_ms = profile_steps(sim, 10)
    if busy_ms is not None:
        print(f"device busy {busy_ms:.4f} ms of the {step_ms:.4f} ms step: "
              f"idle share {100 * (1 - busy_ms / step_ms):.1f}%")

    check_state(sim)
    metrics = sim.metrics
    print(f"state after {int(sim.state.step_count)} steps: t "
          f"{float(sim.state.t):.4f} s, max fluid speed "
          f"{float(metrics['max_velocity']):.4f} m/s, max cell occupancy "
          f"{int(metrics['max_cell_occupancy'])}")

    # stage times of one step at this state (events around each stage)
    solver = sim.solver
    state = sim.state
    stages = {}

    def staged_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        q, ctx, _ = base.bin_and_sort(state.p, params, solver.engine,
                                      solver.tables)
        ev[1].record()
        q, ctx = base.compute_densities_and_pairs(
            q, ctx, solver.engine, params, solver._pair_buffers)
        ev[2].record()
        q = solver.compute_forces(q, ctx, dt=state.dt)
        ev[3].record()
        base.solve_rigid_body(q, state.rigid_rest_cm, params)
        ev[4].record()
        return ev

    for _ in range(3):
        staged_step()
    evs = [staged_step() for _ in range(10)]
    torch.cuda.synchronize()
    for k, name in enumerate(("bin_and_sort", "densities + list (kernel a)",
                              "forces (EOS + kernel)", "rigid solve")):
        stages[name] = sum(e[k].elapsed_time(e[k + 1]) for e in evs) / 10
    print("stage ms at this state: " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))

    # per-kernel times at the dragon state's shapes, and the plain versions
    plain_engine = GatherEngine(params)
    q, starts, _ = base.bin_and_sort(state.p, params, solver.engine,
                                     solver.tables)
    nl = plain_engine.prepare(q.x, starts)
    n = params.n_fluid + params.n_solid
    pairs = int(nl.cnt[:n].long().sum())
    print(f"within-radius pairs (ordered, j != i): {pairs}; max neighbours "
          f"{int(nl.max_cnt)} (cap {params.neighbor_cap})")
    if int(nl.diag["neighbor_overflow"]):
        raise AssertionError("plain engine's neighbour cap overflowed")
    buffers = {}
    q, plist = base.compute_densities_and_pairs(q, starts, solver.engine,
                                                params, buffers)
    q, dpi, p_r02, m_nc, rr0 = solver.force_inputs(q)
    reset_all_launch_counts()     # comparison launches are not the path's
    # the walk profiles of the two kernels' centres: a's every real row, b's
    # the fluid and the dynamic rigids
    k_list = plist.idx.shape[0]
    walkers = (q.material == 1) | q.is_dynamic_rigid()
    fig_a = walk_profile(params, q.x, q.material >= 0, starts, nl,
                         "dragon_bath WCSPH state, density_sum_list's "
                         "centres (every real one)", list_entries=k_list)
    fig_b = walk_profile(params, q.x, walkers, starts, nl,
                         "dragon_bath WCSPH state, wcsph_forces' centres",
                         list_entries=k_list)
    for name, slots in (("density_sum_list", False), ("density_sum", False),
                        ("wcsph_forces", False), ("wcsph_forces_react", False),
                        ("wcsph_forces", True), ("wcsph_forces_react", True)):
        regs, smem, blocks = cp.occupancy(name, slots)
        print(f"  {name}{'[slots]' if slots else ''}: {regs} registers, "
              f"{smem} bytes of shared memory per block, {blocks} blocks of "
              f"128 per SM (occupancy {blocks * 4 / 64:.3f})")
    calls = {
        "density_sum_list": (
            lambda: cp.density_sum_list(starts, q, params, buffers),
            lambda: cp.density_sum_list_plain(nl, q, params)),
        "wcsph_forces": (
            lambda: cp.wcsph_forces(plist, q, dpi, p_r02, m_nc, rr0,
                                    state.dt, params),
            lambda: cp.wcsph_forces_plain(nl, q, dpi, p_r02, m_nc, rr0,
                                          state.dt, params))}
    ms, plain_ms, err = {}, {}, {}
    for name, (kern, plain) in calls.items():
        ms[name] = time_ms(kern, 20)
        plain_ms[name] = time_ms(plain, 3)
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f}"
              f" ms")
    one_phase = time_ms(lambda: cp.density_sum(starts, q, params), 20)
    print(f"  density_sum (one phase, no list; PCISPH's and IISPH's) at this "
          f"state: {one_phase:.4f} ms; the step's two kernels "
          f"{ms['density_sum_list'] + ms['wcsph_forces']:.4f} ms")
    nl_ms = time_ms(lambda: plain_engine.prepare(q.x, starts), 3)
    print(f"plain engine neighbour-list build: {nl_ms:.4f} ms")
    den, got_list = cp.density_sum_list(starts, q, params, buffers)
    ref_den, idx, cnt = cp.density_sum_list_plain(nl, q, params)
    err["density_sum_list"] = max(
        max_errors(den, ref_den, "dragon density_sum_list (whole output)"),
        check_pair_list(got_list, nl, q, params, "dragon state",
                        plain=("density_sum_list", idx, cnt))[0])
    err["wcsph_forces"] = 0.0
    for name, a, b in zip(("x", "v", "acc"), calls["wcsph_forces"][0](),
                          calls["wcsph_forces"][1]()):
        err["wcsph_forces"] = max(err["wcsph_forces"], max_errors(
            a, b, f"dragon wcsph_forces.{name} (whole output)"))
    if any(e != 0.0 for e in err.values()):
        raise AssertionError(f"dragon: a WCSPH kernel differs from its plain "
                             f"version: {err}")

    # both kernels are bounded by the function they compute, over the cell
    # offsets: density_sum_list by the density sum (as density_sum on the
    # IISPH path: x, material, m_V read, the real rows' sums written), the
    # forces from the fluid centres and the dynamic rigids, every row
    # written (padding rows carried)
    listed_a = int(torch.clamp_max(plist.cnt, k_list).long().sum())
    listed_b = int(torch.clamp_max(plist.cnt[walkers], k_list).long().sum())
    n_pad = params.n_pad
    den_read = n * (12 + 4 + 4) + offset_bytes(params, q.x[:n])
    frc_read = n * (12 + 12 + 4 + 4 + 4 + 4 + 4 + 4 + 4) \
        + (n_pad - n) * 24 + 4
    frc_pairs = int(nl.cnt[walkers].long().sum())
    bounds = {
        "density_sum_list": bound("density_sum_list", den_read + 4 * n,
                                  pairs * DENSITY_FLOPS_PER_PAIR),
        "wcsph_forces": bound(
            "wcsph_forces", frc_read + offset_bytes(params, q.x[walkers])
            + n_pad * 36, frc_pairs * FORCES_FLOPS_PER_PAIR)}
    # the design as it runs (design figures, not bounds): a also writes
    # every row's sum and count and the list's entries; b reads the list's
    # counts and entries instead of the cell offsets, no distance test
    bound("density_sum_list design figure (writing the list, "
          f"{fig_a['warps_over_list']} warps over it; not the bound)",
          den_read + 4 * n_pad + 4 * n_pad + 4 * listed_a,
          pairs * DENSITY_FLOPS_PER_PAIR)
    bound("wcsph_forces design figure (reading the list, "
          f"{fig_b['warps_over_list']} warps over it; not the bound)",
          frc_read + 4 * int(walkers.sum()) + 4 * listed_b + n_pad * 36,
          frc_pairs * (FORCES_FLOPS_PER_PAIR - 8))
    print(f"  the list: {listed_a} entries written ({4 * listed_a} bytes; "
          f"{k_list} x {n_pad} x 4 = {4 * k_list * n_pad} bytes allocated "
          f"once per solver), {listed_b} of them read by wcsph_forces; "
          f"density_sum_list's centres over it {fig_a['warps_over_list']} "
          f"warps")

    # one kernel step against one plain-engine step from the same state
    plain_solver = build_solver(params, device=device, engine=plain_engine)
    ks, _ = solver.step(state)
    ps, pm = plain_solver.step(state)
    if int(pm["neighbor_overflow"]):
        raise AssertionError("plain step overflowed its neighbour cap")
    real = ps.p.material != -1
    for name in ("x", "v", "density", "pressure", "acc"):
        max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                   f"step kernel vs plain engine: {name}")

    src = "sph_taichi_torch/csrc/pairs.cu"
    kernels = [
        {"name": name, "route": "cuda", "source": src,
         "replaces": "sph_taichi_tpu/ops/pallas_blocks.py:718",
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name in ("density_sum_list", "wcsph_forces")]
    return kernels, step_ms


def dragon_state_kernels(params, solver, state):
    """The DFSPH kernels at a dragon state: sorted particles with density
    and factor, the plain engine's neighbour lists, a stiffness field from
    the divergence term, and the pair counts each kernel walks."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops.pairs import GatherEngine

    q, starts, _ = base.bin_and_sort(state.p, params, solver.engine,
                                     solver.tables)
    # the oracle's capacities, raised to what this state needs (a splash
    # or the fluid at a rigid can exceed the scene's caps; the kernels
    # have none)
    occ = int(base.max_cell_occupancy(starts))
    caps = dataclasses.replace(params, cell_cap=max(params.cell_cap, occ))
    nl = GatherEngine(caps).prepare(q.x, starts)
    if int(nl.diag["neighbor_overflow"]):
        caps = dataclasses.replace(caps, neighbor_cap=int(nl.max_cnt))
        nl = GatherEngine(caps).prepare(q.x, starts)
    q = solver.density_and_factor(q, starts)
    adv, _ = cd.divergence(starts, q, q.v, None, None, "change", params)
    kappa = adv * (q.dfsph_factor / state.dt)
    fluid = q.material == 1
    valid = nl.mask()
    pairs_fc = int(nl.cnt[fluid].long().sum())
    pairs_ff = int((valid & (q.material[nl.idx] == 1))[fluid].sum())
    print(f"within-radius pairs with a fluid centre: {pairs_fc}, of them "
          f"fluid-fluid {pairs_ff}; max neighbours {int(nl.max_cnt)}, max "
          f"cell occupancy {occ} (the oracle's caps {caps.neighbor_cap}, "
          f"{caps.cell_cap})")
    return q, starts, nl, kappa, pairs_fc, pairs_ff


def bound(name, nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    print(f"{name} bound: {nbytes} bytes -> {t_bytes:.5f} ms, {flops} flop "
          f"-> {t_ops:.5f} ms")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def row_bound(name, n, index_bytes, pairs, label=None):
    """``bound`` of the d-g kernel ``name`` (ROW_COSTS) over ``n`` real
    rows, ``index_bytes`` of its walk's index and the within-radius pairs
    ``pairs`` by class."""
    per_row, extra, kind, flops = ROW_COSTS[name]
    return bound(label or name, n * per_row + extra + index_bytes,
                 pairs[kind] * flops)


def offset_bytes(params, xc):
    """Bytes of the cell offsets that cell-run walks from the centres at
    ``xc`` read: per (dx, dy) column of a centre, the offsets of its z-run's
    first cell and of the cell past its last (pair_common.cuh
    ``CellRunWalk``), each offset counted once."""
    from sph_taichi_torch.ops.grid import pos_to_cell

    nx, ny, nz = params.grid_num
    ix, iy, iz = pos_to_cell(xc, params.grid_size).long().unbind(1)
    zlo = torch.clamp(iz - 1, min=0)
    zhi = torch.clamp(iz + 1, max=nz - 1)
    read = torch.zeros(params.num_cells + 1, dtype=torch.bool,
                       device=xc.device)
    for dx, dy in itertools.product((-1, 0, 1), repeat=2):
        cx, cy = ix + dx, iy + dy
        ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (zlo <= zhi)
        base = (cx * ny + cy) * nz
        read[(base + zlo)[ok]] = True
        read[(base + zhi + 1)[ok]] = True
    return 4 * int(read.sum())


# dragon_bath_dfsph, 20 steps after 3: the Jacobi iterations and host reads
# of the one-phase Jacobi kernels (3.40 / 1.70 iterations and 3.35 reads per
# step); the two-phase kernels are bitwise equal to them, so they stay
DFSPH_PATH_COUNTS = {"divergence_iters": 68, "pressure_iters": 34,
                     "host_reads": 67}


def dfsph_path(device, scene_path, warmup, steps):
    """Phase 4: DFSPH dragon through ``Simulation``; returns the kernels'
    JSON entries and the step time."""
    import warnings

    from sph_taichi_torch import build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.models.base import JACOBI_CHECK_EVERY as K
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops.pairs import GatherEngine

    t0 = time.perf_counter()
    sim = simulation(scene_path)
    dense0 = DENSE_CALLS["dense"]
    params = sim.params
    print(f"dragon_bath_dfsph: {params.n_particles} particles (fluid "
          f"{params.n_fluid}, solid {params.n_solid}), dt {params.dt0}; "
          f"scene + initialize {time.perf_counter() - t0:.2f} s")
    sim.run(warmup, export=False)
    torch.cuda.synchronize()

    # every host sync of a step is a read of a Jacobi loop's test
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, m = sim.solver.step(sim.state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    reads = m["divergence_host_reads"] + m["pressure_host_reads"]
    print(f"one DFSPH step under torch.cuda sync-debug mode 'warn': "
          f"{len(where)} host syncs {where}; the solver reports {reads} "
          f"reads of its loop tests (iterations divergence "
          f"{int(m['divergence_iters'])}, pressure "
          f"{int(m['pressure_iters'])}, a read every {K})")
    if len(where) != reads:
        raise AssertionError("a DFSPH step syncs outside its loop tests")

    # the DFSPH path: counts to 0 just before, read just after
    reset_all_launch_counts()
    sim.reset_solver_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = all_launch_counts()
    st = sim.read_solver_stats()
    step_ms = start.elapsed_time(end) / steps
    n_div, n_prs = st["divergence_iters_sum"], st["pressure_iters_sum"]
    r_div, r_prs = st["divergence_host_reads"], st["pressure_host_reads"]
    print(f"DFSPH path: {steps} steps, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s; iterations per step divergence "
          f"mean {n_div / steps:.2f} max {st['divergence_iters_max']}, "
          f"pressure mean {n_prs / steps:.2f} max "
          f"{st['pressure_iters_max']}; host reads per step "
          f"{(r_div + r_prs) / steps:.2f}; launches {launches}")
    expect_launches(launches, dfsph_launches(steps, st), "DFSPH path")
    dense_calls_since(dense0, "DFSPH path")
    counts = {"divergence_iters": n_div, "pressure_iters": n_prs,
              "host_reads": r_div + r_prs}
    if steps == 20:
        print(f"  counts {counts}, those of the one-phase walk "
              f"{DFSPH_PATH_COUNTS}: equal {counts == DFSPH_PATH_COUNTS}")
        if counts != DFSPH_PATH_COUNTS:
            raise AssertionError("the DFSPH path's counts moved")
    for solve, n, r in (("divergence", n_div, r_div),
                        ("pressure", n_prs, r_prs)):
        if not n <= K * r <= n + (K - 1) * steps:
            raise AssertionError(f"{solve}: {n} iterations, {r} reads")
        print(f"  {solve}: {n} iterations ran (the launches with work are "
              f"{steps} + {n}), {K * r - n} queued after the exit")

    counts = {}
    reset_all_launch_counts()
    busy_ms = profile_steps(sim, 5, counts)
    if busy_ms is not None:
        print(f"device busy {busy_ms:.4f} ms of the {step_ms:.4f} ms step: "
              f"idle share {100 * (1 - busy_ms / step_ms):.1f}%")
        # e1 and d launched their one kernel per wrapper call, once per step
        got = {name: sum(c for k, c in counts.items()
                         if all(part in k for part in parts))
               for name, parts in (
                   ("dfsph_density_factor",
                    ("dfsph_density_factor_list_kernel",)),
                   ("nonpressure_kick", ("nonpressure_kick_kernel<true",
                                         "CellRunWalk")))}
        calls = {name: cd.LAUNCHES[name] for name in got}
        print(f"  e1 and d in the profiled 5 steps {got}, their wrappers' "
              f"calls {calls}")
        if got != calls or set(calls.values()) != {5}:
            raise AssertionError(f"DFSPH e1/d kernels {got}, wrapper calls "
                                 f"{calls}")

    check_state(sim)
    metrics = sim.metrics
    print(f"state after {int(sim.state.step_count)} steps: t "
          f"{float(sim.state.t):.4f} s, max fluid speed "
          f"{float(metrics['max_velocity']):.4f} m/s, divergence error "
          f"{float(metrics['divergence_error']):.4f}, pressure error "
          f"{float(metrics['pressure_error']):.4f}")

    # stage times of one step at this state (events around each stage)
    solver, state = sim.solver, sim.state

    def staged_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        q, ctx, _ = base.bin_and_sort(state.p, params, solver.engine,
                                      solver.tables)
        ev[1].record()
        q, pairs = solver.density_factor_and_pairs(q, ctx)
        ev[2].record()
        q, _ = solver.divergence_solve(q, pairs, state.dt)
        ev[3].record()
        q = base.compute_non_pressure_forces(q, pairs, solver.engine, params,
                                             predict_dt=state.dt)
        ev[4].record()
        q, _ = solver.pressure_solve(q, pairs, state.dt)
        ev[5].record()
        q = solver.advect(q, state.dt)
        q, _ = base.solve_rigid_body(q, state.rigid_rest_cm, params)
        base.enforce_boundary(q, params, 1)
        ev[6].record()
        return ev

    for _ in range(2):
        staged_step()
    evs = [staged_step() for _ in range(5)]
    torch.cuda.synchronize()
    stages = {}
    for k, name in enumerate(("bin_and_sort", "density+factor + list (e1)",
                              "divergence solve",
                              "non-pressure + kick (d, over the list)",
                              "pressure solve", "advect + rigid + clamp")):
        stages[name] = sum(e[k].elapsed_time(e[k + 1]) for e in evs) / 5
    print("DFSPH stage ms at this state: " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))

    k_sweep(solver, state, "this state")

    # one kernel step against one plain-engine step from the same state
    plain_solver = build_solver(params, device=device,
                                engine=GatherEngine(params))
    ks, km = solver.step(state)
    ps, pm = plain_solver.step(state)
    if int(pm["neighbor_overflow"]):
        raise AssertionError("plain step overflowed its neighbour cap")
    its = [(int(km[k]), int(pm[k])) for k in ("divergence_iters",
                                              "pressure_iters")]
    print(f"step kernel vs plain engine: iterations (kernel, plain) "
          f"divergence {its[0]}, pressure {its[1]}")
    if any(a != b for a, b in its):
        raise AssertionError("iteration counts differ")
    real = ps.p.material != -1
    for name in ("x", "v", "density", "density_adv", "acc"):
        max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                   f"DFSPH step kernel vs plain engine: {name}")
    del plain_solver, ps

    # per-kernel times at the dragon state's shapes, and the plain versions
    q, starts, nl, kappa, pairs_fc, pairs_ff = dragon_state_kernels(
        params, solver, state)
    dt = state.dt
    reset_all_launch_counts()     # comparison launches are not the path's
    buffers = {}
    plist = cd.density_factor_list(starts, q, params, buffers)[2]
    k_list = plist.idx.shape[0]
    fig = walk_profile(params, q.x, q.material == 1, starts, nl,
                       "dragon_bath_dfsph state, e1's and d's centres "
                       "(fluid), with the list", list_entries=k_list)
    for name, slots in (("density_factor_list", False),
                        ("density_factor", True),
                        ("nonpressure_kick", False), ("nonpressure_kick", True),
                        ("nonpressure_accel", False),
                        ("nonpressure_accel", True)):
        regs, smem, blocks = cd.occupancy(name, slots)
        print(f"  {name}{'[slots]' if slots else ''}: {regs} registers, "
              f"{smem} bytes of shared memory per block, {blocks} blocks of "
              f"128 per SM (occupancy {blocks * 4 / 64:.3f})")
    calls = {
        "dfsph_density_factor": (
            lambda: cd.density_factor_list(starts, q, params, buffers),
            lambda: cd.density_factor_list_plain(nl, q, params)),
        "change": (
            lambda: cd.divergence(starts, q, q.v, None, None, "change",
                                  params),
            lambda: cd.divergence_plain(nl, q, q.v, None, None, "change",
                                        params)),
        "adv": (
            lambda: cd.divergence(starts, q, q.v, q.density, dt, "adv",
                                  params),
            lambda: cd.divergence_plain(nl, q, q.v, q.density, dt, "adv",
                                        params)),
        "dfsph_solver_dv": (
            lambda: cd.solver_dv(starts, q, kappa, q.v, None, dt, False,
                                 params),
            lambda: cd.solver_dv_plain(nl, q, kappa, q.v, None, dt, False,
                                       params)),
        "nonpressure_kick": (
            lambda: cd.nonpressure_kick(plist, q, dt, params),
            lambda: cd.nonpressure_kick_plain(nl, q, dt, params)),
    }
    ms, plain_ms, err = {}, {}, {}
    for name, (kern, plain) in calls.items():
        ms[name] = time_ms(kern, 20)
        plain_ms[name] = time_ms(plain, 3)
        err[name] = 0.0
        got, ref = kern(), plain()
        if name == "dfsph_density_factor":
            # e1's whole outputs and its list
            err[name] = check_pair_list(
                got[2], nl, q, params, "dragon state",
                plain=("dfsph_density_factor_list", *ref[2:]))[0]
            got, ref = got[:2], ref[:2]
        # e1 and d over the whole outputs (padding rows included), the
        # Jacobi kernels over the real rows
        rows = slice(None) if name in ("dfsph_density_factor",
                                       "nonpressure_kick") else slice(
            0, params.n_fluid + params.n_solid)
        for k, (a, b) in enumerate(zip(got, ref)):
            if b is not None:
                err[name] = max(err[name], max_errors(
                    a[rows], b[rows], f"dragon {name} output {k}"))
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f}"
              f" ms")
    if err["dfsph_density_factor"] or err["nonpressure_kick"]:
        raise AssertionError(f"dragon: e1 or d differs from its plain "
                             f"version: {err}")
    print(f"  the step's e1 and d: {ms['dfsph_density_factor'] + ms['nonpressure_kick']:.4f} ms")

    compact_at_dragon(params, q, starts, nl, kappa, dt)
    n = params.n_fluid + params.n_solid
    cells = offset_bytes(params, q.x[q.material == 1])   # fluid centres walk
    pairs = {"fluid": pairs_fc, "fluid_ff": pairs_ff}
    bounds = {key: row_bound(name, n, cells, pairs) for key, name in (
        ("dfsph_density_factor", "dfsph_density_factor"),
        ("change", "dfsph_divergence_change"),
        ("adv", "dfsph_divergence_adv"),
        ("dfsph_solver_dv", "dfsph_solver_dv"),
        ("nonpressure_kick", "nonpressure_kick"))}
    # e1 and d are bounded by the function they compute, over the cell
    # offsets; the list as this design writes and reads it, design figures
    listed = int(torch.clamp_max(plist.cnt, k_list).long().sum())
    row_bound("dfsph_density_factor_list", n, cells + 4 * listed, pairs,
              f"dfsph_density_factor design figure (writing the list, "
              f"{fig['warps_over_list']} warps over it; not the bound)")
    row_bound("nonpressure_kick_list", n, 4 * listed, pairs,
              f"nonpressure_kick design figure (reading the list, "
              f"{fig['warps_over_list']} warps over it; not the bound)")
    print(f"  the list: {listed} entries written by e1 and read by d "
          f"({4 * listed} bytes; {k_list} x {params.n_pad} x 4 = "
          f"{4 * k_list * params.n_pad} bytes allocated once per solver)")
    # a later state, where the fluid has hit the bath: iterations and the
    # read interval again
    sim.reset_solver_stats()
    sim.run(100 // sim.substeps, export=False)
    st = sim.read_solver_stats()
    sim.reset_solver_stats()
    print(f"after {int(sim.state.step_count)} steps (t "
          f"{float(sim.state.t):.4f} s): iterations per step divergence "
          f"mean {st['divergence_iters_sum'] / st['steps']:.2f} max "
          f"{st['divergence_iters_max']}, pressure mean "
          f"{st['pressure_iters_sum'] / st['steps']:.2f} max "
          f"{st['pressure_iters_max']} over the last {st['steps']} steps")
    k_sweep(solver, sim.state, f"step {int(sim.state.step_count)}")

    # the divergence entry: both modes, weighted by their launches
    w_chg = launches["dfsph_divergence_change"]
    w_adv = launches["dfsph_divergence_adv"]

    def mixed(d):
        return (w_chg * d["change"] + w_adv * d["adv"]) / (w_chg + w_adv)

    ms["dfsph_divergence"] = mixed(ms)
    plain_ms["dfsph_divergence"] = mixed(plain_ms)
    err["dfsph_divergence"] = max(err["change"], err["adv"])
    b_div = mixed({k: bounds[k][0] for k in ("change", "adv")})
    bounds["dfsph_divergence"] = (b_div, bounds["adv"][1])
    launches["dfsph_divergence"] = w_chg + w_adv
    src = "sph_taichi_torch/csrc/dfsph.cu"
    kernels = []
    for name in ("dfsph_density_factor", "dfsph_divergence",
                 "dfsph_solver_dv", "nonpressure_kick"):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "sph_taichi_tpu/ops/pallas_blocks.py:718",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None})
    return kernels, step_ms


def k_sweep(solver, state, label, steps=5, turns=3, settings=(1, 2, 4, 8)):
    """Step ms by the loops' read interval k (DFSPH's two solves, IISPH's
    or PCISPH's one): ``steps`` steps from ``state`` per setting, the
    settings interleaved over ``turns`` turns, host clock around work that
    ends in a synchronize.  The solver's own k is restored."""
    K = solver.check_every
    per_k, iters = {}, None
    for turn in range(turns):
        for every in settings[::1 if turn % 2 == 0 else -1]:
            solver.check_every = every
            s, its = state, []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                s, m = solver.step(s)
                its.append(sum(m[k] for k in ("divergence_iters",
                                              "pressure_iters") if k in m))
            torch.cuda.synchronize()
            per_k.setdefault(every, []).append(
                (time.perf_counter() - t0) * 1e3 / steps)
            iters = int(sum(its))
    solver.check_every = K
    print(f"step ms by Jacobi read interval k at {label} ({steps} steps "
          f"per setting, {iters} Jacobi iterations in them, {turns} turns "
          f"interleaved): " + json.dumps(
              {k: [round(t, 4) for t in v] for k, v in per_k.items()}) +
          "; medians " + json.dumps(
              {k: round(float(np.median(v)), 4) for k, v in per_k.items()}))
    return per_k


def dragon_contact(sim):
    """Largest reaction on the dynamic rigid from one reaction-kernel launch
    with a random stiffness: 0 until the fluid reaches the rigid."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_dfsph as cd

    solver, state = sim.solver, sim.state
    q, starts, _ = base.bin_and_sort(state.p, sim.params, solver.engine,
                                     solver.tables)
    q = solver.density_and_factor(q, starts)
    _, acc = cd.solver_dv(starts, q, random_kappa(q), q.v,
                          torch.zeros_like(q.x), state.dt, True, sim.params)
    return float(acc[q.is_dynamic_rigid()].abs().max())


def contact_volumes(device, sim, q, starts, nl, label="dynamic dragon",
                    dense_step=True):
    """The dynamic rigids' volumes at the contact (sorted particles ``q``,
    cell offsets ``starts``, the plain engine's lists ``nl``): kernel c,
    which gives the step's volumes since the dispatch gave the CUDA
    engines kernel c at every solid count, over both walks against its
    plain versions and its other designs (``volume_designs``), beside the
    dense path that took them before (the record); then one step of
    ``sim`` against one plain-engine step from its state, whose volumes
    take the dense path below DENSE_SOLID_CAP; without ``dense_step``
    against one whose volumes take kernel c's plain version (the cap
    patched to 0), the dense-path step's differences printed beside it.
    Returns kernel c's ms and its volumes' largest relative difference
    from the dense path's."""
    from sph_taichi_torch import build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pairs import GatherEngine
    from sph_taichi_torch.ops.slots import build_slot_map, slot_neighbor_list

    params = sim.params
    dynr = q.is_dynamic_rigid()
    volume_occupancy()
    err, c_ms = volume_designs(starts, q, dynr, params,
                               f"{label} at contact", nl)
    caps = dataclasses.replace(
        params, neighbor_cap=max(params.neighbor_cap, int(nl.max_cnt)),
        cell_cap=max(params.cell_cap, int(base.max_cell_occupancy(starts))))
    smap = build_slot_map(starts, params)
    snl = slot_neighbor_list(smap, q.x, caps)
    if int(snl.diag["neighbor_overflow"]):
        raise AssertionError(f"{label}: plain slot lists overflowed")
    print(f"  slot map at contact: max_layers_used "
          f"{int(smap.diag['max_layers_used'])}, slot_overflow "
          f"{bool(smap.diag['slot_overflow'])} (kernel and plain slot lists "
          f"drop the same pairs)")
    err_s, s_ms = volume_designs(smap, q, dynr, params,
                                 f"{label} at contact [slots]", snl)
    dense_ms = time_ms(lambda: base._boundary_volume_dense(q, params, dynr),
                       3)
    p_ms = time_ms(lambda: cp.boundary_volume_plain(nl, q, dynr, params), 3)
    mv_c = cp.boundary_volume(starts, q, dynr, params)[dynr].double()
    mv_d = base._boundary_volume_dense(q, params, dynr).m_V[dynr].double()
    rel_cd = float(((mv_c - mv_d) / mv_d).abs().max())
    b = volume_bound(f"boundary_volume at the {label}'s contact",
                     params, q, nl, dynr, offset_bytes(params, q.x[dynr]))
    b_s = volume_bound(f"boundary_volume[slots] at the {label}'s contact",
                       params, q, snl, dynr,
                       slot_map_bytes(params, smap, q.x[dynr]))
    print(f"boundary volumes of the {label}'s {int(dynr.sum())} solids at "
          f"the contact: kernel c {c_ms['shipped']:.4f} ms, over the slot "
          f"map {s_ms['shipped']:.4f} ms (profiler; bounds {b[0]:.5f} ms by "
          f"{b[1]}, {b_s[0]:.5f} ms by {b_s[1]}), plain {p_ms:.4f} ms; the "
          f"dense path, which the dispatch took before, {dense_ms:.4f} ms "
          f"(CUDA events); max rel difference kernel c against dense "
          f"{rel_cd:.3e} (summation order, limit {VOLUME_RTOL:g}); max abs "
          f"error against the plain versions {err:.3e} / {err_s:.3e}")
    if not rel_cd <= VOLUME_RTOL:
        raise AssertionError(f"{label} at contact: kernel c's volumes "
                             f"{rel_cd:.3e} from the dense path's")
    del smap, snl

    # one step from this state on the card's engine and on the plain
    # engine (caps raised to the state's), whose dispatch takes the dense
    # path below DENSE_SOLID_CAP: the volumes differ by summation order
    plain_solver = build_solver(caps, device=device,
                                engine=GatherEngine(caps))
    ks, km = sim.solver.step(sim.state)
    cap = base.DENSE_SOLID_CAP
    if not dense_step:
        base.DENSE_SOLID_CAP = 0    # kernel c's plain version
    try:
        ps, pm = plain_solver.step(sim.state)
    finally:
        base.DENSE_SOLID_CAP = cap
    if int(pm["neighbor_overflow"]):
        raise AssertionError("plain step overflowed its neighbour cap")
    its = [(int(km[k]), int(pm[k])) for k in ("divergence_iters",
                                              "pressure_iters")]
    volumes = "the dense path's" if dense_step else "kernel c's plain"
    print(f"{label} at contact, step kernel vs plain engine ({volumes} "
          f"volumes): iterations (kernel, plain) divergence {its[0]}, "
          f"pressure {its[1]}")
    if not dense_step and any(a != b for a, b in its):
        raise AssertionError(f"{label}: iteration counts differ")
    real = ps.p.material != -1
    for name in ("x", "v", "density", "m_V"):
        max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                   f"{label} step kernel vs plain engine: {name}")
    if not dense_step:
        # the record: the plain step with the dense volumes, whose sums
        # differ from kernel c's by their order; the solves iterate on
        ps, pm = plain_solver.step(sim.state)
        its = [(int(km[k]), int(pm[k])) for k in ("divergence_iters",
                                                  "pressure_iters")]
        diffs = []
        for name in ("x", "v", "density"):
            ref = getattr(ps.p, name)[real].double()
            d = (getattr(ks.p, name)[real].double() - ref).abs()
            used = float((d / (ATOL + RTOL * ref.abs())).max())
            diffs.append(f"{name} max abs {float(d.max()):.3e}, tolerance "
                         f"used {used:.3f}")
        print(f"  the record: the plain step with the dense path's volumes"
              f" against the kernel step: iterations (kernel, plain) "
              f"divergence {its[0]}, pressure {its[1]}; " + ", ".join(diffs))
    solid = ps.p.material == 0
    rel = float(((ks.p.m_V[solid].double() - ps.p.m_V[solid].double())
                 / ps.p.m_V[solid].double()).abs().max())
    print(f"  m_V of the solids, kernel c against the dense path: max rel "
          f"difference {rel:.3e} (limit {VOLUME_RTOL:g})")
    if not rel <= VOLUME_RTOL:
        raise AssertionError(f"{label} step: m_V {rel:.3e} from the "
                             f"plain engine's")
    del plain_solver, ks, ps
    return c_ms["shipped"], rel_cd


def reaction_at_scale(device, scene_path, steps, max_lead=200):
    """Phase 5: the dynamic dragon (DFSPH with the reaction variant): run
    until the fluid reaches the dragon (at most ``max_lead`` steps), then
    ``steps`` timed steps (kernel c once per step, the dense path never),
    the reaction kernel's time at that state, kernel c's designs over both
    walks there beside the dense path, and one step against one
    plain-engine step."""
    from sph_taichi_torch.ops import cuda_dfsph as cd

    sim = simulation(scene_path)
    dense0 = DENSE_CALLS["dense"]
    params = sim.params
    print(f"dragon_bath_dynamic_dfsph: {params.n_particles} particles, "
          f"dynamic rigids {params.dynamic_rigid_ids}")
    t0 = time.perf_counter()
    while dragon_contact(sim) == 0.0:
        if int(sim.state.step_count) >= max_lead:
            raise AssertionError(f"no fluid at the dragon after {max_lead} "
                                 f"steps")
        sim.run(20 // sim.substeps, export=False)
    print(f"the fluid reaches the dragon by step "
          f"{int(sim.state.step_count)} (t {float(sim.state.t):.4f} s; "
          f"{time.perf_counter() - t0:.1f} s)")
    reset_all_launch_counts()
    sim.reset_solver_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    st = sim.read_solver_stats()
    launches = all_launch_counts()
    print(f"dynamic dragon: {steps} steps, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s; iterations divergence "
          f"{st['divergence_iters_sum']} pressure {st['pressure_iters_sum']};"
          f" launches {launches}")
    dense_calls_since(dense0, "dynamic dragon path")
    if launches["boundary_volume"] != steps or \
            launches["boundary_volume[slots]"]:
        raise AssertionError(f"kernel c: {launches['boundary_volume']} "
                             f"launches in {steps} steps, expected {steps}")
    check_state(sim)
    busy_ms = profile_steps(sim, 3)
    if busy_ms is not None:
        print(f"device busy {busy_ms:.4f} ms of the {step_ms:.4f} ms step: "
              f"idle share {100 * (1 - busy_ms / step_ms):.1f}%")
    q, starts, nl, kappa, _, _ = dragon_state_kernels(params, sim.solver,
                                                      sim.state)
    dt = sim.state.dt
    # e1's list and d over it at the contact, where the fullest cells hold
    # ~54 particles: whole outputs and the list against the plain versions
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES
    walk_profile(params, q.x, q.material == 1, starts, nl,
                 "dynamic dragon at contact, e1's and d's centres (fluid), "
                 "with the list", list_entries=PAIR_LIST_ENTRIES)
    density, factor, plist = cd.density_factor_list(starts, q, params, {})
    ref = cd.density_factor_list_plain(nl, q, params)
    err = check_pair_list(plist, nl, q, params, "dynamic dragon at contact",
                          plain=("dfsph_density_factor_list", *ref[2:]))[0]
    got = (density, factor, *cd.nonpressure_kick(plist, q, dt, params))
    want = (*ref[:2], *cd.nonpressure_kick_plain(nl, q, dt, params))
    for name, a, b in zip(("density", "factor", "acc", "v"), got, want):
        err = max(err, max_errors(a, b, f"dynamic dragon at contact: "
                                        f"e1/d {name} (whole output)"))
    if err != 0.0:
        raise AssertionError(f"dynamic dragon at contact: e1 or d differs "
                             f"from its plain version ({err:.3e})")
    print("  dynamic dragon at contact: dfsph_density_factor_list (density, "
          "factor and list) and nonpressure_kick over the list equal to "
          "their plain versions bitwise")
    acc = torch.zeros_like(q.x)
    react_ms = time_ms(lambda: cd.solver_dv(starts, q, kappa, q.v, acc, dt,
                                            True, params), 20)
    plain_ms = time_ms(lambda: cd.solver_dv_plain(nl, q, kappa, q.v, acc,
                                                  dt, True, params), 3)
    fluid_ms = time_ms(lambda: cd.solver_dv(starts, q, kappa, q.v, None, dt,
                                            False, params), 20)
    dynr = q.is_dynamic_rigid()
    moved = float(cd.solver_dv(starts, q, kappa, q.v, acc, dt, True,
                               params)[1][dynr].abs().max())
    # the state's own stiffness gives the times; a random one, on which the
    # reaction is large, the comparison
    kappa = random_kappa(q)
    got = cd.solver_dv(starts, q, kappa, q.v, acc, dt, True, params)
    ref = cd.solver_dv_plain(nl, q, kappa, q.v, acc, dt, True, params)
    for name, a, b in zip(("v", "acc"), got, ref):
        max_errors(a, b, f"dynamic dragon dfsph_solver_dv<REACT>.{name}")
    moved_random = float(got[1][dynr].abs().max())
    if moved_random == 0.0:
        raise AssertionError("DFSPH reaction not exercised at the dragon")
    print(f"dfsph_solver_dv<REACT> at the dynamic dragon: {react_ms:.4f} ms "
          f"(without the reaction {fluid_ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms); max |reaction| on the dragon {moved:.3e} with the state's "
          f"stiffness, {moved_random:.3e} with a random one")
    contact_volumes(device, sim, q, starts, nl)
    return step_ms, react_ms


def iisph_scene(kind):
    """Small IISPH scenes: "rigid" is the small block beside a static rigid
    block (tests/test_iisph_oracle.py's scene, dt 4e-3); "floor_impact" is
    the DFSPH floor impact at dt 1e-3, where the pressure solve runs 59
    iterations in the second step and 7 in the third (at 4e-3 IISPH does
    not converge there, in either package)."""
    d = small_scene()
    cfg = d["Configuration"]
    cfg["simulationMethod"], cfg["timeStepSize"] = 2, 4e-3
    if kind == "rigid":
        d["RigidBlocks"] = [{
            "objectId": 1, "start": [0.55, 0.1, 0.1],
            "end": [0.8, 0.35, 0.35], "translation": [0.0, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0], "velocity": [0.0, 0.0, 0.0],
            "density": 1000.0, "color": [100, 100, 100],
            "isDynamic": False}]
    elif kind == "floor_impact":
        d = dfsph_scene("floor_impact")
        d["Configuration"]["simulationMethod"] = 2
        d["Configuration"]["timeStepSize"] = 1e-3
    return d


def random_pressure(p, seed=3):
    """A pressure field of 0 .. 2000 Pa on real rows, 0 on padding."""
    rng = np.random.default_rng(seed)
    pr = torch.tensor(rng.uniform(0.0, 2000.0, p.n).astype(np.float32),
                      device=p.x.device)
    return torch.where(p.material >= 0, pr, 0.0)


def compare_iisph_kernels(params, p, nl, starts, pressure, label, worst):
    """The step's list (``density_sum_list``'s) and f1-f4 over it against
    their plain versions at one state, each kernel on the plain chain's
    inputs, as a step runs them, equal to the bit (padding rows
    included).  ``pressure`` is the loop's last_p for the pressure
    acceleration and A."""
    from sph_taichi_torch.ops import cuda_iisph as ci
    from sph_taichi_torch.ops import cuda_pairs as cp

    device = p.x.device
    dt = torch.full((), params.dt0, dtype=torch.float32, device=device)
    omega = 0.5

    def check(name, got, ref, what):
        if torch.is_tensor(ref):
            got, ref = (got,), (ref,)
        for field, a, b in zip(what, got, ref):
            err = max_errors(a, b, f"{name}[{label}].{field}")
            if err != 0.0:
                raise AssertionError(f"{name}[{label}].{field}: not equal "
                                     f"to its plain version ({err:.3e})")
            worst[name] = max(worst.get(name, 0.0), err)

    pairs = cp.density_sum_list(starts, p, params)[1]
    worst["density_sum_list (IISPH)"] = max(
        worst.get("density_sum_list (IISPH)", 0.0),
        check_pair_list(pairs, nl, p, params, label)[0])
    ref = ci.nonpressure_kick_plain(nl, p, dt, params)
    check("iisph_nonpressure_kick", ci.nonpressure_kick(pairs, p, dt, params),
          ref, ("acc", "v"))
    p = p._replace(acc=ref[0], v=ref[1])
    ref = ci.predict_advection_plain(nl, p, dt, params)
    check("iisph_predict_advection",
          ci.predict_advection(pairs, p, dt, params), ref,
          ("a_ii", "source", "last_p"))
    a_ii, source, _ = ref
    accel = ci.pressure_accel_plain(nl, p, pressure, params)
    check("iisph_pressure_accel", ci.pressure_accel(pairs, p, pressure,
                                                    params), accel, ("accel",))
    solid = p.material == 0
    if bool(solid.any()) and float(accel[solid].abs().max()) == 0.0:
        raise AssertionError("solid rows' pressure acceleration is 0")
    check("iisph_pressure_accel",
          ci.pressure_accel(pairs, p, pressure, params, advect_dt=dt),
          ci.pressure_accel_plain(nl, p, pressure, params, advect_dt=dt),
          ("advect.v", "advect.x"))
    got = ci.apply_A(pairs, p, accel, a_ii, source, pressure, dt, omega,
                     params)
    ref = ci.apply_A_plain(nl, p, accel, a_ii, source, pressure, dt, omega,
                           params)
    check("iisph_apply_A", got, ref, ("new_p", "err"))
    real = p.material >= 0
    share = float((ref[0][real] > 0).float().mean())
    print(f"  {label}: share of rows with a positive Jacobi pressure "
          f"{share:.3f}")
    return share


def check_iisph_on_small_scenes(device):
    """The IISPH kernels against their plain versions on a clumped scene
    with a static rigid and on the floor impact; then the floor impact's
    first three IISPH steps, kernel engine against plain engine from the
    same state each step, with equal iteration counts (59 and 7 in the
    second and third)."""
    from sph_taichi_torch import SimConfig, build_scene, build_solver
    from sph_taichi_torch.ops import cuda_iisph as ci
    from sph_taichi_torch.ops.pairs import GatherEngine

    worst, shares = {}, []
    for kind, clump in (("rigid", True), ("floor_impact", False)):
        params, solver, p, nl, starts, diag = prepared(
            iisph_scene(kind), device, seed=0, clump=clump)
        if int(diag["neighbor_overflow"]) or int(diag["cell_overflow"]):
            raise AssertionError(f"{kind}: the plain engine's caps overflowed")
        print(f"IISPH small scene {kind}: {params.n_particles} particles "
              f"({params.n_solid} static solids), max cell occupancy "
              f"{int(diag['max_cell_occupancy'])}")
        shares.append(compare_iisph_kernels(params, p, nl, starts,
                                            random_pressure(p), kind, worst))
    if not any(0.0 < s < 1.0 for s in shares):
        raise AssertionError("the Jacobi update's clamp not exercised")

    params, part, _ = build_scene(SimConfig(config_dict=iisph_scene(
        "floor_impact")), device=device)
    ksolver = build_solver(params, device=device)
    psolver = build_solver(params, device=device,
                           engine=GatherEngine(params))
    state = ksolver.initialize(part)
    iters = []
    for step in range(3):
        ci.reset_launch_counts()
        ks, km = ksolver.step(state)
        ps, pm = psolver.step(state)
        its = (int(km["pressure_iters"]), int(pm["pressure_iters"]))
        iters.append(its[0])
        print(f"  IISPH floor impact step {step + 1}: pressure iterations "
              f"(kernel, plain) {its}; launches {dict(ci.LAUNCHES)}")
        if its[0] != its[1]:
            raise AssertionError("iteration counts differ")
        real = ps.p.material != -1
        for name in ("x", "v", "density", "pressure", "acc"):
            max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                       f"IISPH floor impact step {step + 1}: {name}")
        state = ks
    if max(iters) < 2:
        raise AssertionError("the floor impact's pressure solve did not "
                             "iterate")
    return worst


def dragon_config(method, dt=None):
    """data/scenes/dragon_bath.json with simulationMethod ``method`` (and
    ``dt``)."""
    from sph_taichi_torch import SimConfig

    with open("data/scenes/dragon_bath.json") as f:
        d = json.load(f)
    d["Configuration"]["simulationMethod"] = method
    if dt is not None:
        d["Configuration"]["timeStepSize"] = dt
    return SimConfig(config_dict=d)


def iisph_state_kernels(params, solver, state):
    """Inputs of the IISPH kernels at a dragon state, built by the kernels
    themselves as in a step (the density kernel writing the step's list,
    which is returned with the cell offsets, and f1-f3 over it), the
    particles before f1's kick, the plain engine's neighbour lists (caps
    raised to what the state needs), and the pair counts each kernel
    walks."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops.pairs import GatherEngine

    q, starts, _ = base.bin_and_sort(state.p, params, solver.engine,
                                     solver.tables)
    occ = int(base.max_cell_occupancy(starts))
    caps = dataclasses.replace(params, cell_cap=max(params.cell_cap, occ))
    nl = GatherEngine(caps).prepare(q.x, starts)
    if int(nl.diag["neighbor_overflow"]):
        caps = dataclasses.replace(caps, neighbor_cap=int(nl.max_cnt))
        nl = GatherEngine(caps).prepare(q.x, starts)
    q0, plist = base.compute_densities_and_pairs(q, starts, solver.engine,
                                                 params)
    q = solver.compute_non_pressure(q0, plist, state.dt)
    a_ii, source, last_p = solver.predict_advection(q, plist, state.dt)
    accel = solver._pressure_accel(q, plist, last_p)
    n_real = params.n_fluid + params.n_solid
    valid = nl.mask()
    mat_j = q.material[nl.idx]
    pairs = {"real": int(nl.cnt[:n_real].long().sum()),
             "fluid_j": int((valid & (mat_j == 1))[:n_real].sum())}
    print(f"within-radius pairs with a real centre: {pairs['real']}, of them "
          f"with a fluid neighbour {pairs['fluid_j']}; max "
          f"neighbours {int(nl.max_cnt)}, max cell occupancy {occ} (the oracle's caps "
          f"{caps.neighbor_cap}, {caps.cell_cap}); last_p max "
          f"{float(last_p.max()):.4f} Pa")
    return q0, q, (starts, plist), nl, (a_ii, source, last_p, accel), pairs


def iisph_walk_profiles(params, q, starts, nl, label):
    """The walk profile of IISPH's loop at the sorted state ``q``: every
    real row walking (with the list of PAIR_LIST_ENTRIES: the list walk's
    iterations), then the fluid and the solid centres alone (accepted
    pairs per centre: mean, p99, max; candidate and one-phase body
    iterations per warp).  Returns the real rows' figures."""
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES as k_list

    fig = walk_profile(params, q.x, q.material >= 0, starts, nl,
                       f"{label}, every real centre", list_entries=k_list)
    for kind, rows in (("fluid", q.material == 1), ("solid", q.material == 0)):
        if bool(rows.any()):
            walk_profile(params, q.x, rows, starts, nl,
                         f"{label}, {kind} centres alone",
                         list_entries=k_list)
    return fig


def armadillo_counts(device):
    """The armadillo scene's particle counts (build_scene alone): on the
    card its boundary volumes take kernel 2.1 c, as every scene's do; its
    solids stay under DENSE_SOLID_CAP, so the plain engines take the
    dense path."""
    from sph_taichi_torch import SimConfig, build_scene
    from sph_taichi_torch.models.base import DENSE_SOLID_CAP

    params, _, _ = build_scene(SimConfig(
        "data/scenes/armadillo_bath_dynamic.json"), device=device)
    dense = params.n_solid <= DENSE_SOLID_CAP
    print(f"armadillo_bath_dynamic: {params.n_fluid} fluid + "
          f"{params.n_solid} solid particles, dynamic rigids "
          f"{params.dynamic_rigid_ids}; boundary volumes by kernel 2.1 c on "
          f"the card, by the "
          f"{'dense path' if dense else 'traversal'} on the plain engines "
          f"(cap {DENSE_SOLID_CAP})")
    return params.n_fluid, params.n_solid


def iisph_path(device, warmup, steps):
    """The IISPH path: dragon_bath.json with simulationMethod 2 through
    ``Simulation``; returns the kernels' JSON entries (the one-phase
    density_sum's, which no solver step launches, with its launches 0)
    and the step time."""
    import warnings

    from sph_taichi_torch import build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.models.base import JACOBI_CHECK_EVERY as K
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops import cuda_iisph as ci
    from sph_taichi_torch.ops.pairs import GatherEngine

    t0 = time.perf_counter()
    sim = simulation(config=dragon_config(2), scene_dir=".")
    dense0 = DENSE_CALLS["dense"]
    params = sim.params
    if type(sim.solver).__name__ != "IISPHSolver":
        raise AssertionError(f"method 2 built {type(sim.solver).__name__}")
    print(f"dragon_bath, IISPH: {params.n_particles} particles (fluid "
          f"{params.n_fluid}, solid {params.n_solid}), dt {params.dt0}; "
          f"scene + initialize {time.perf_counter() - t0:.2f} s")
    sim.run(warmup, export=False)
    torch.cuda.synchronize()

    # every host sync of a step is a read of the Jacobi loop's test
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, m = sim.solver.step(sim.state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"one IISPH step under torch.cuda sync-debug mode 'warn': "
          f"{len(where)} host syncs {where}; the solver reports "
          f"{m['pressure_host_reads']} reads of its loop test (iterations "
          f"{int(m['pressure_iters'])}, a read every {K})")
    if len(where) != m["pressure_host_reads"]:
        raise AssertionError("an IISPH step syncs outside its loop test")
    inside = [w for w in where if "cuda_iisph" in w or "pair_list" in w
              or "csrc" in w]
    print(f"  host syncs in the loop's kernels and wrappers: {len(inside)}")
    if inside:
        raise AssertionError(f"IISPH wrappers sync: {inside}")

    # the IISPH path: counts to 0 just before, read just after
    reset_all_launch_counts()
    sim.reset_solver_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = all_launch_counts()
    st = sim.read_solver_stats()
    step_ms = start.elapsed_time(end) / steps
    n_it, reads = st["pressure_iters_sum"], st["pressure_host_reads"]
    print(f"IISPH path: {steps} steps, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s; pressure iterations per step mean "
          f"{n_it / steps:.2f} max {st['pressure_iters_max']}; host reads "
          f"per step {reads / steps:.2f}; launches {launches}")
    # the density kernel writing the list = f1 = f2 = steps; in the loop
    # f3 = f4 = k x reads (the iterations queued after the exit return at
    # once); f3 once more per step, with the advect
    expect = {"density_sum_list": steps, "iisph_nonpressure_kick": steps,
              "iisph_predict_advection": steps,
              "iisph_pressure_accel": K * reads,
              "iisph_pressure_accel_advect": steps,
              "iisph_apply_A": K * reads}
    for name, count in launches.items():
        if count != expect.get(name, 0):
            raise AssertionError(f"{name}: {count} launches in {steps} "
                                 f"IISPH steps, expected "
                                 f"{expect.get(name, 0)}")
    dense_calls_since(dense0, "IISPH path")
    if not n_it <= K * reads <= n_it + (K - 1) * steps:
        raise AssertionError(f"{n_it} iterations, {reads} reads")
    print(f"  pressure solve: {n_it} iterations ran (the loop launches with "
          f"work), {K * reads - n_it} queued after the exit")

    counts = {}
    reset_all_launch_counts()
    busy_ms = profile_steps(sim, 5, counts)
    if busy_ms is not None:
        print(f"device busy {busy_ms:.4f} ms of the {step_ms:.4f} ms step: "
              f"idle share {100 * (1 - busy_ms / step_ms):.1f}%")
        # each wrapper call launched its one kernel: the profiled kernels
        # equal the wrappers' counts over the same 5 steps
        kernel_keys = {
            "density_sum_list": ("density_sum_list_kernel(",),
            "iisph_nonpressure_kick": (
                "iisph_nonpressure_kick_list_kernel<CellRunWalk>",),
            "iisph_predict_advection": (
                "iisph_predict_advection_list_kernel<CellRunWalk>",),
            "iisph_pressure_accel": ("iisph_pressure_accel_kernel<false",
                                     "CellRunWalk"),
            "iisph_pressure_accel_advect": (
                "iisph_pressure_accel_kernel<true", "CellRunWalk"),
            "iisph_apply_A": ("iisph_apply_A_kernel<CellRunWalk",)}
        got = {name: sum(c for k, c in counts.items()
                         if all(part in k for part in parts))
               for name, parts in kernel_keys.items()}
        calls = {name: all_launch_counts()[name] for name in kernel_keys}
        print(f"  the step's list kernels in the profiled 5 steps {got}, "
              f"their wrappers' calls {calls}")
        if got != calls or calls["density_sum_list"] != 5 \
                or calls["iisph_nonpressure_kick"] != 5:
            raise AssertionError(f"IISPH kernels {got}, wrapper calls "
                                 f"{calls}")

    check_state(sim)
    metrics = sim.metrics
    print(f"state after {int(sim.state.step_count)} steps: t "
          f"{float(sim.state.t):.4f} s, max fluid speed "
          f"{float(metrics['max_velocity']):.4f} m/s, pressure error "
          f"{float(metrics['pressure_error']):.6f}")

    # stage times of one step at this state (events around each stage)
    solver, state = sim.solver, sim.state

    def staged_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        q, ctx, _ = base.bin_and_sort(state.p, params, solver.engine,
                                      solver.tables)
        ev[1].record()
        q, ctx = base.compute_densities_and_pairs(q, ctx, solver.engine,
                                                  params,
                                                  solver._pair_buffers)
        ev[2].record()
        q = solver.compute_non_pressure(q, ctx, state.dt)
        ev[3].record()
        a_ii, source, last_p = solver.predict_advection(q, ctx, state.dt)
        ev[4].record()
        pr, _ = solver.pressure_solve(q, ctx, a_ii, source, last_p, state.dt)
        ev[5].record()
        q = solver._pressure_accel(q._replace(pressure=pr), ctx, pr,
                                   advect_dt=state.dt)
        ev[6].record()
        q, _ = base.solve_rigid_body(q, state.rigid_rest_cm, params)
        base.enforce_boundary(q, params, 1)
        ev[7].record()
        return ev

    for _ in range(2):
        staged_step()
    evs = [staged_step() for _ in range(5)]
    torch.cuda.synchronize()
    stages = {}
    for k, name in enumerate(("bin_and_sort", "densities + list",
                              "non-pressure + kick", "predict advection",
                              "pressure solve",
                              "pressure accel + advect", "rigid + clamp")):
        stages[name] = sum(e[k].elapsed_time(e[k + 1]) for e in evs) / 5
    print("IISPH stage ms at this state: " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))
    k_sweep(solver, state, f"IISPH step {int(state.step_count)}")

    # one kernel step against one plain-engine step from the same state
    plain_solver = build_solver(params, device=device,
                                engine=GatherEngine(params))
    ks, km = solver.step(state)
    ps, pm = plain_solver.step(state)
    if int(pm["neighbor_overflow"]) or int(pm["cell_overflow"]):
        raise AssertionError("plain step overflowed its caps")
    its = (int(km["pressure_iters"]), int(pm["pressure_iters"]))
    print(f"IISPH step kernel vs plain engine: pressure iterations (kernel, "
          f"plain) {its}")
    if its[0] != its[1]:
        raise AssertionError("iteration counts differ")
    real = ps.p.material != -1
    for name in ("x", "v", "density", "pressure", "acc"):
        max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                   f"IISPH step kernel vs plain engine: {name}")
    del plain_solver, ps

    # per-kernel times at the dragon state's shapes, and the plain versions
    q0, q, (starts, plist), nl, (a_ii, source, last_p, accel), pairs = \
        iisph_state_kernels(params, solver, state)
    dt = state.dt
    omega = solver.omega
    reset_all_launch_counts()     # comparison launches are not the path's
    fig = iisph_walk_profiles(params, q, starts, nl, "dragon_bath IISPH state")
    for name, slots in itertools.product(
            ("iisph_nonpressure_kick", "iisph_predict_advection",
             "iisph_pressure_accel", "iisph_pressure_accel_advect",
             "iisph_apply_A"), (False, True)):
        regs, smem, blocks = ci.occupancy(name, slots)
        print(f"  {name}{'[slots]' if slots else ''}: {regs} registers, "
              f"{smem} bytes of shared memory per block, {blocks} blocks of "
              f"128 per SM (occupancy {blocks * 4 / 64:.3f})")
    buffers = {}
    calls = {
        # the one-phase density kernel over the cell runs: no solver step
        # launches it (the IISPH and PCISPH steps, as WCSPH's, take
        # density_sum_list); held against its plain version here
        "density_sum": (
            lambda: cp.density_sum(starts, q0, params),
            lambda: cp.density_sum_plain(nl, q0.x, q0.material, q0.m_V,
                                         params)),
        # the IISPH step's density kernel, writing the step's list (its
        # kernels-line entry is the WCSPH path's, main_path)
        "density_sum_list": (
            lambda: cp.density_sum_list(starts, q0, params, buffers),
            lambda: cp.density_sum_list_plain(nl, q0, params)),
        "iisph_nonpressure_kick": (
            lambda: ci.nonpressure_kick(plist, q0, dt, params),
            lambda: ci.nonpressure_kick_plain(nl, q0, dt, params)),
        "iisph_predict_advection": (
            lambda: ci.predict_advection(plist, q, dt, params),
            lambda: ci.predict_advection_plain(nl, q, dt, params)),
        "loop": (
            lambda: ci.pressure_accel(plist, q, last_p, params),
            lambda: ci.pressure_accel_plain(nl, q, last_p, params)),
        "advect": (
            lambda: ci.pressure_accel(plist, q, last_p, params,
                                      advect_dt=dt),
            lambda: ci.pressure_accel_plain(nl, q, last_p, params,
                                            advect_dt=dt)),
        "iisph_apply_A": (
            lambda: ci.apply_A(plist, q, accel, a_ii, source, last_p, dt,
                               omega, params),
            lambda: ci.apply_A_plain(nl, q, accel, a_ii, source, last_p, dt,
                                     omega, params)),
    }
    n = params.n_fluid + params.n_solid
    ms, plain_ms, err = {}, {}, {}
    for name, (kern, plain) in calls.items():
        ms[name] = time_ms(kern, 20)
        plain_ms[name] = time_ms(plain, 3)
        got, ref = kern(), plain()
        if name == "density_sum_list":
            err[name] = check_pair_list(got[1], nl, q0, params,
                                        "dragon state")[0]
            got, ref = got[:1], ref[:1]
        if torch.is_tensor(ref):
            got, ref = (got,), (ref,)
        err[name] = err.get(name, 0.0)
        # whole outputs: the kernels write the padding rows
        for k, (a, b) in enumerate(zip(got, ref)):
            err[name] = max(err[name], max_errors(
                a, b, f"dragon {name} output {k}"))
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f}"
              f" ms")
    per_step = sum(ms[k] for k in ("density_sum_list",
                                   "iisph_nonpressure_kick",
                                   "iisph_predict_advection", "loop",
                                   "iisph_apply_A", "advect"))
    print(f"  the step's pair kernels at one iteration: density_sum_list + "
          f"f1 + f2 + f3 + f4 + advect = {per_step:.4f} ms")
    print(f"  density_sum (one phase over the cell runs) is on no solver "
          f"step: its kernels-line entry counts {launches['density_sum']} "
          f"launches on the IISPH path")
    if any(err[k] != 0.0 for k in calls):
        raise AssertionError(f"dragon: an IISPH kernel differs from its "
                             f"plain version: {err}")

    cells = offset_bytes(params, q.x[:n])   # every real centre walks
    k_list = plist.idx.shape[0]
    list_bytes = 4 * int(torch.clamp_max(plist.cnt, k_list).long().sum())
    pairs = {"real": pairs["real"], "real_fj": pairs["fluid_j"]}
    # f1-f4 are bounded by the function they compute, over the cell
    # offsets; reading the list instead is a design figure
    bounds = {key: row_bound(name, n, cells, pairs) for key, name in (
        ("iisph_nonpressure_kick", "iisph_nonpressure_kick"),
        ("iisph_predict_advection", "iisph_predict_advection"),
        ("loop", "iisph_pressure_accel"),
        ("advect", "iisph_pressure_accel_advect"),
        ("iisph_apply_A", "iisph_apply_A"))}
    # density_sum reads x, material, m_V and writes the sums of the real rows
    bounds["density_sum"] = bound("density_sum", n * (12 + 4 + 4) + cells
                                  + 4 * n,
                                  pairs["real"] * DENSITY_FLOPS_PER_PAIR)
    for name in ("iisph_nonpressure_kick", "iisph_predict_advection",
                 "iisph_pressure_accel", "iisph_pressure_accel_advect",
                 "iisph_apply_A"):
        row_bound(name + "_list", n, list_bytes, pairs,
                  f"{name} design figure (reading the list, "
                  f"{fig['warps_over_list']} warps over it; not the bound)")
    # the pressure-acceleration entry: both variants, weighted by their
    # launches on the path
    w_loop = launches["iisph_pressure_accel"]
    w_adv = launches["iisph_pressure_accel_advect"]

    def mixed(d):
        return (w_loop * d["loop"] + w_adv * d["advect"]) / (w_loop + w_adv)

    ms["iisph_pressure_accel"] = mixed(ms)
    plain_ms["iisph_pressure_accel"] = mixed(plain_ms)
    err["iisph_pressure_accel"] = max(err["loop"], err["advect"])
    bounds["iisph_pressure_accel"] = (
        mixed({k: bounds[k][0] for k in ("loop", "advect")}),
        bounds["advect"][1])
    launches["iisph_pressure_accel"] = w_loop + w_adv
    kernels = []
    for name in ("density_sum", "iisph_nonpressure_kick",
                 "iisph_predict_advection", "iisph_pressure_accel",
                 "iisph_apply_A"):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sph_taichi_torch/csrc/" + (
                "pairs.cu" if name == "density_sum" else "iisph.cu"),
            "replaces": "sph_taichi_tpu/ops/pallas_blocks.py:718",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None})
    return kernels, step_ms


def iisph_iterating(device, dt, steps, max_lead=400):
    """The IISPH dragon at a larger dt: run until a step's pressure solve
    iterates more than once (reading the counts every 10 steps, at most
    ``max_lead`` steps), then ``steps`` timed steps."""

    sim = simulation(config=dragon_config(2, dt), scene_dir=".")
    t0 = time.perf_counter()
    first = None
    while True:
        sim.reset_solver_stats()
        sim.run(10 // sim.substeps, export=False)
        st = sim.read_solver_stats()
        if first is None:
            first = st
            print(f"IISPH dragon at dt {dt}: the first 10 steps from t = 0 "
                  f"run {st['pressure_iters_sum']} pressure iterations (max "
                  f"{st['pressure_iters_max']} per step)")
        if st["pressure_iters_max"] > 1:
            break
        if int(sim.state.step_count) >= max_lead:
            raise AssertionError(f"no IISPH step iterated more than once in "
                                 f"{max_lead} steps at dt {dt}")
    check_state(sim)
    print(f"  by step {int(sim.state.step_count)} (t "
          f"{float(sim.state.t):.4f} s, {time.perf_counter() - t0:.1f} s) a "
          f"step iterates: {st['pressure_iters_sum']} iterations in the last "
          f"10 steps, max {st['pressure_iters_max']}")
    sim.reset_solver_stats()
    its = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        sim.run_frame()
        its.append(sim.metrics["pressure_iters"])
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    its = [int(i) for i in its]
    check_state(sim)
    print(f"IISPH iterating regime (dt {dt}): {steps} steps from step "
          f"{int(sim.state.step_count) - steps}, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s; pressure iterations per step {its}; "
          f"max fluid speed {float(sim.metrics['max_velocity']):.4f} m/s, "
          f"pressure error {float(sim.metrics['pressure_error']):.6f}")
    if max(its) < 2:
        raise AssertionError("the timed IISPH steps did not iterate")
    busy_ms = profile_steps(sim, 5)
    if busy_ms is not None:
        print(f"device busy {busy_ms:.4f} ms of the {step_ms:.4f} ms step at "
              f"dt {dt}: idle share {100 * (1 - busy_ms / step_ms):.1f}%")
    k_sweep(sim.solver, sim.state,
            f"IISPH dt {dt} step {int(sim.state.step_count)}")

    # where the pressure is not 0: the step's list and the four kernels over
    # it against their plain versions on the state's own inputs, and one
    # kernel step against one plain-engine step
    from sph_taichi_torch import build_solver
    from sph_taichi_torch.ops import cuda_iisph as ci
    from sph_taichi_torch.ops.pairs import GatherEngine

    params, solver, state = sim.params, sim.solver, sim.state
    q0, q, (starts, plist), nl, (a_ii, source, last_p, accel), _ = \
        iisph_state_kernels(params, solver, state)
    if float(last_p.max()) <= 0.0:
        raise AssertionError("no pressure at the iterating state")
    iisph_walk_profiles(params, q, starts, nl, f"IISPH dt {dt} state")
    errs = [check_pair_list(plist, nl, q, params, "iterating state")[0]]
    for name, got, ref in (
            ("iisph_nonpressure_kick",
             ci.nonpressure_kick(plist, q0, state.dt, params),
             ci.nonpressure_kick_plain(nl, q0, state.dt, params)),
            ("iisph_predict_advection",
             ci.predict_advection(plist, q, state.dt, params),
             ci.predict_advection_plain(nl, q, state.dt, params)),
            ("iisph_pressure_accel",
             (ci.pressure_accel(plist, q, last_p, params),),
             (ci.pressure_accel_plain(nl, q, last_p, params),)),
            ("iisph_pressure_accel_advect",
             ci.pressure_accel(plist, q, last_p, params, advect_dt=state.dt),
             ci.pressure_accel_plain(nl, q, last_p, params,
                                     advect_dt=state.dt)),
            ("iisph_apply_A",
             ci.apply_A(plist, q, accel, a_ii, source, last_p, state.dt,
                        solver.omega, params),
             ci.apply_A_plain(nl, q, accel, a_ii, source, last_p, state.dt,
                              solver.omega, params))):
        for k, (a, b) in enumerate(zip(got, ref)):
            errs.append(max_errors(a, b, f"iterating state {name} output "
                                         f"{k}"))
    if max(errs) != 0.0:
        raise AssertionError(f"iterating state: the list or a kernel over "
                             f"it differs from its plain version "
                             f"({max(errs)})")
    print(f"  at the iterating state the step's list and f1-f4 over it "
          f"equal their plain versions bitwise (whole outputs)")
    plain_solver = build_solver(params, device=device,
                                engine=GatherEngine(params))
    ks, km = solver.step(state)
    ps, pm = plain_solver.step(state)
    if int(pm["neighbor_overflow"]) or int(pm["cell_overflow"]):
        raise AssertionError("plain step overflowed its caps")
    pair = (int(km["pressure_iters"]), int(pm["pressure_iters"]))
    print(f"IISPH step kernel vs plain engine at the iterating state: "
          f"pressure iterations (kernel, plain) {pair}")
    if pair[0] != pair[1]:
        raise AssertionError("iteration counts differ")
    real = ps.p.material != -1
    for name in ("x", "v", "density", "pressure", "acc"):
        max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                   f"IISPH iterating step kernel vs plain engine: {name}")
    return step_ms, its


def pcisph_scene(kind):
    """Small PCISPH scenes (dt 4e-3): "small" and "two_way" are the WCSPH
    scenes (the block, and the block beside a dynamic rigid block);
    "impact" is a block from the floor's padding line up to 0.6 m falling
    at 2 m/s, where the loop runs 3-5 iterations per step.  (The DFSPH
    floor impact, whose block starts inside the floor's padding, does not
    converge under PCISPH in either package.)"""
    if kind == "impact":
        d = dfsph_scene("floor_impact")
        d["FluidBlocks"][0]["start"] = [0.1, 0.1, 0.1]
    else:
        d = small_scene(two_way=kind == "two_way")
    cfg = d["Configuration"]
    cfg["simulationMethod"], cfg["timeStepSize"] = 1, 4e-3
    return d


def pcisph_inputs(params, solver, p, seed=4):
    """The loop's inputs at a sorted state with density and acc: a seeded
    prediction v* (up to 10 m/s on fluid rows), x* = x + dt v*, a seeded
    pressure field, dt and s_f as device scalars."""
    device = p.x.device
    dt = torch.full((), params.dt0, dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    vs = torch.tensor(rng.uniform(-10.0, 10.0, (p.n, 3)).astype(np.float32),
                      device=device)
    fluid = (p.material == 1)[:, None]
    vp = torch.where(fluid, vs, p.v)
    xp = torch.where(fluid, p.x + dt * vp, p.x)
    return xp, vp, random_pressure(p), dt, solver.scaling_factor(dt)


def pairs_moved(nl, xp, h):
    """(step-start pairs beyond h at x*, all step-start pairs)."""
    valid = nl.mask()
    d2 = ((xp[:, None, :] - xp[nl.idx]) ** 2).sum(-1)
    return int((valid & (d2 >= h * h)).sum()), int(valid.sum())


def check_pair_list(pairs, nl, p, params, label, plain=None):
    """The kernel's step pair list ``pairs`` (a ``PairList``) against
    ``plain`` (name, idx, cnt), by default ``density_sum_list``'s plain
    list (every real centre's) over the neighbour lists ``nl``: every
    count and every listed entry equal.  Returns (largest difference,
    centres with more accepted pairs than the list holds)."""
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES as k_list

    if plain is None:
        plain = ("density_sum_list", *cp.density_sum_list_plain(
            nl, p, params)[1:])
    name, idx, cnt = plain
    listed = torch.clamp_max(cnt, k_list)
    valid = torch.arange(k_list, device=cnt.device)[:, None] < listed[None, :]
    got = torch.where(valid, pairs.idx, -1)
    err = max(float((got - idx).abs().max()),
              float((pairs.cnt - cnt).abs().max()))
    over = int((cnt > k_list).sum())
    print(f"  {label}: {name} against its plain version: max abs "
          f"err {err:g}; {int(listed.sum())} listed pairs, at most "
          f"{int(cnt.max())} per centre, {over} centres over the list of "
          f"{k_list}")
    if err != 0.0:
        raise AssertionError(f"{label}: the step's pair list differs "
                             f"from its plain version")
    return err, over


def compare_pcisph_kernels(params, solver, p, nl, starts, label, worst):
    """The step's list (``density_sum_list``'s), the un-kicked
    non-pressure kernel, g1 and g2 (over the list) against their plain
    versions at one state, each kernel on the plain chain's inputs: equal
    to the bit (every output's largest difference is 0, padding rows
    included)."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops import cuda_pcisph as cg

    def check(name, got, ref, what):
        if torch.is_tensor(ref):
            got, ref = (got,), (ref,)
        for field, a, b in zip(what, got, ref):
            err = max_errors(a, b, f"{name}[{label}].{field}")
            if err != 0.0:
                raise AssertionError(f"{name}[{label}].{field}: not equal "
                                     f"to its plain version ({err:.3e})")
            worst[name] = max(worst.get(name, 0.0), err)

    pairs = cp.density_sum_list(starts, p, params)[1]
    worst["density_sum_list (PCISPH)"] = max(
        worst.get("density_sum_list (PCISPH)", 0.0),
        check_pair_list(pairs, nl, p, params, label)[0])
    acc = cd.nonpressure_accel_plain(nl, p, params)
    check("nonpressure_accel", cd.nonpressure_accel(pairs, p, params), acc,
          ("acc",))
    p = p._replace(acc=acc)
    xp, vp, pressure, dt, s_f = pcisph_inputs(params, solver, p)
    moved, total = pairs_moved(nl, xp, params.support_radius)
    print(f"  {label}: {moved} of {total} step-start pairs beyond h at x*")
    if moved == 0:
        raise AssertionError("the prediction moved no pair out of the radius")
    ref = cg.d_rho_correct_plain(nl, p, xp, vp, pressure, dt, s_f, params)
    ref2 = cg.pressure_accel_predict_plain(nl, p, xp, ref[0], dt, params)
    check("pcisph_d_rho_correct", cg.d_rho_correct(
        pairs, p, xp, vp, pressure, dt, s_f, params), ref,
        ("pressure", "rho_err"))
    check("pcisph_pressure_accel_predict", cg.pressure_accel_predict(
        pairs, p, xp, ref[0], dt, params), ref2, ("v*", "x*"))
    fluid = p.material == 1
    share = float((ref[1][fluid] > 0).float().mean())
    print(f"  {label}: share of fluid rows with a density error {share:.3f}")
    return share


def check_pcisph_on_small_scenes(device):
    """The PCISPH kernels against their plain versions on the clumped small
    scene and the two-way scene; then three PCISPH steps of the impact,
    kernel engine against plain engine from the same state each step, with
    equal iteration counts."""
    from sph_taichi_torch import SimConfig, build_scene, build_solver
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_pcisph as cg
    from sph_taichi_torch.ops.pairs import GatherEngine

    worst, shares = {}, []
    for kind in ("small", "two_way"):
        params, solver, p, nl, starts, diag = prepared(
            pcisph_scene(kind), device, seed=0)
        if int(diag["neighbor_overflow"]) or int(diag["cell_overflow"]):
            raise AssertionError(f"{kind}: the plain engine's caps overflowed")
        print(f"PCISPH small scene {kind}: {params.n_particles} particles "
              f"({params.n_solid} solids, dynamic {params.dynamic_rigid_ids})"
              f", max cell occupancy {int(diag['max_cell_occupancy'])}")
        shares.append(compare_pcisph_kernels(params, solver, p, nl, starts,
                                             kind, worst))
    if not any(0.0 < s < 1.0 for s in shares):
        raise AssertionError("the density-error clamp not exercised")

    params, part, _ = build_scene(SimConfig(config_dict=pcisph_scene(
        "impact")), device=device)
    ksolver = build_solver(params, device=device)
    psolver = build_solver(params, device=device,
                           engine=GatherEngine(params))
    state = ksolver.initialize(part)
    iters = []
    for step in range(3):
        cg.reset_launch_counts()
        cd.reset_launch_counts()
        ks, km = ksolver.step(state)
        ps, pm = psolver.step(state)
        its = (int(km["pressure_iters"]), int(pm["pressure_iters"]))
        iters.append(its[0])
        print(f"  PCISPH impact step {step + 1}: pressure iterations (kernel, "
              f"plain) {its}; launches {dict(cg.LAUNCHES)}, non-pressure "
              f"{cd.LAUNCHES['nonpressure_accel']}")
        if its[0] != its[1]:
            raise AssertionError("iteration counts differ")
        if int(pm["neighbor_overflow"]) or int(pm["cell_overflow"]):
            raise AssertionError("plain step overflowed its caps")
        real = ps.p.material != -1
        for name in ("x", "v", "density", "pressure", "acc"):
            max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                       f"PCISPH impact step {step + 1}: {name}")
        state = ks
    if min(iters) < 3:
        raise AssertionError(f"PCISPH iterations {iters}: fewer than 3")
    return worst


def pcisph_state_kernels(params, solver, state):
    """The loop's inputs at a dragon state as a step builds them (density
    and the step's list, the non-pressure acceleration, the first
    prediction and its pressure), the plain engine's neighbour lists (caps
    raised to what the state needs), and the pair counts each kernel
    walks."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_pcisph as cg
    from sph_taichi_torch.ops.pairs import GatherEngine

    q, starts, _ = base.bin_and_sort(state.p, params, solver.engine,
                                     solver.tables)
    occ = int(base.max_cell_occupancy(starts))
    caps = dataclasses.replace(params, cell_cap=max(params.cell_cap, occ))
    nl = GatherEngine(caps).prepare(q.x, starts)
    if int(nl.diag["neighbor_overflow"]):
        caps = dataclasses.replace(caps, neighbor_cap=int(nl.max_cnt))
        nl = GatherEngine(caps).prepare(q.x, starts)
    q, plist = base.compute_densities_and_pairs(q, starts, solver.engine,
                                                params)
    q = base.compute_non_pressure_forces(q, plist, solver.engine, params)
    dt = state.dt
    fluid = (q.material == 1)[:, None]
    vp = torch.where(fluid, q.v + dt * q.acc, q.v)
    xp = torch.where(fluid, q.x + dt * vp, q.x)
    s_f = solver.scaling_factor(dt)
    pressure, _ = cg.d_rho_correct(plist, q, xp, vp, torch.zeros_like(
        q.pressure), dt, s_f, params)
    valid = nl.mask()
    fluid_i = q.material == 1
    pairs = {"fluid_i": int(nl.cnt[fluid_i].long().sum()),
             "fluid_ff": int((valid & (q.material[nl.idx] == 1))[fluid_i]
                             .sum())}
    print(f"within-radius pairs with a fluid centre: {pairs['fluid_i']}, of "
          f"them fluid-fluid {pairs['fluid_ff']}; max neighbours "
          f"{int(nl.max_cnt)}, max cell occupancy {occ} (the oracle's caps "
          f"{caps.neighbor_cap}, {caps.cell_cap}); first-iteration pressure "
          f"max {float(pressure.max()):.4f} Pa")
    return q, starts, plist, nl, (xp, vp, pressure, s_f), pairs


def pcisph_path(device, warmup, steps):
    """The PCISPH path: dragon_bath.json with simulationMethod 1 through
    ``Simulation``; returns the kernels' JSON entries and the step time."""
    import warnings

    from sph_taichi_torch import build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops import cuda_pcisph as cg
    from sph_taichi_torch.ops.pairs import GatherEngine

    t0 = time.perf_counter()
    sim = simulation(config=dragon_config(1), scene_dir=".")
    dense0 = DENSE_CALLS["dense"]
    params = sim.params
    if type(sim.solver).__name__ != "PCISPHSolver":
        raise AssertionError(f"method 1 built {type(sim.solver).__name__}")
    K = sim.solver.check_every
    print(f"dragon_bath, PCISPH: {params.n_particles} particles (fluid "
          f"{params.n_fluid}, solid {params.n_solid}), dt {params.dt0}, "
          f"s_f_base {sim.solver.s_f_base!r}; scene + initialize "
          f"{time.perf_counter() - t0:.2f} s")
    sim.run(warmup, export=False)
    torch.cuda.synchronize()

    # every host sync of a step is a read of the loop's test
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, m = sim.solver.step(sim.state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"one PCISPH step under torch.cuda sync-debug mode 'warn': "
          f"{len(where)} host syncs {where}; the solver reports "
          f"{m['pressure_host_reads']} reads of its loop test (iterations "
          f"{int(m['pressure_iters'])}, a read every {K})")
    if len(where) != m["pressure_host_reads"]:
        raise AssertionError("a PCISPH step syncs outside its loop test")
    inside = [w for w in where if "cuda_pcisph" in w or "csrc" in w]
    print(f"  host syncs in the loop's kernels and wrappers: {len(inside)}")
    if inside:
        raise AssertionError(f"PCISPH wrappers sync: {inside}")

    # the PCISPH path: counts to 0 just before, read just after
    reset_all_launch_counts()
    sim.reset_solver_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = all_launch_counts()
    st = sim.read_solver_stats()
    step_ms = start.elapsed_time(end) / steps
    n_it, reads = st["pressure_iters_sum"], st["pressure_host_reads"]
    print(f"PCISPH path: {steps} steps, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s; pressure iterations per step mean "
          f"{n_it / steps:.2f} max {st['pressure_iters_max']}; host reads "
          f"per step {reads / steps:.2f}; launches {launches}")
    # the density kernel writing the list = non-pressure = steps; in the
    # loop g1 = g2 = k x reads (the iterations queued after the exit return
    # at once)
    expect = {"density_sum_list": steps, "nonpressure_accel": steps,
              "pcisph_d_rho_correct": K * reads,
              "pcisph_pressure_accel_predict": K * reads}
    for name, count in launches.items():
        if count != expect.get(name, 0):
            raise AssertionError(f"{name}: {count} launches in {steps} "
                                 f"PCISPH steps, expected "
                                 f"{expect.get(name, 0)}")
    dense_calls_since(dense0, "PCISPH path")
    if not 3 * steps <= n_it <= K * reads <= n_it + (K - 1) * steps:
        raise AssertionError(f"{n_it} iterations, {reads} reads")
    print(f"  pressure loop: {n_it} iterations ran (the launches with work),"
          f" {K * reads - n_it} queued after the exit")

    counts = {}
    reset_all_launch_counts()
    busy_ms = profile_steps(sim, 5, counts)
    if busy_ms is not None:
        print(f"device busy {busy_ms:.4f} ms of the {step_ms:.4f} ms step: "
              f"idle share {100 * (1 - busy_ms / step_ms):.1f}%")
        # each wrapper call launched its one kernel: the profiled kernels
        # equal the wrappers' counts over the same 5 steps
        names = ("density_sum_list", "pcisph_d_rho_correct",
                 "pcisph_pressure_accel_predict")
        got = {name: sum(c for k, c in counts.items()
                         if f"{name}_kernel<CellRunWalk>" in k
                         or k.startswith(f"{name}_kernel("))
               for name in names}
        calls = {name: all_launch_counts()[name] for name in names}
        got["nonpressure_accel"] = sum(
            c for k, c in counts.items()
            if "nonpressure_kick_kernel<false" in k and "CellRunWalk" in k)
        calls["nonpressure_accel"] = cd.LAUNCHES["nonpressure_accel"]
        print(f"  the density kernel's (writing the list), d's and the "
              f"loop's kernels in the profiled 5 steps {got}, their "
              f"wrappers' calls {calls}")
        if got != calls or calls["density_sum_list"] != 5 \
                or calls["nonpressure_accel"] != 5:
            raise AssertionError(f"PCISPH kernels {got}, wrapper calls "
                                 f"{calls}")

    check_state(sim)
    metrics = sim.metrics
    fluid = sim.state.p.material == 1
    print(f"state after {int(sim.state.step_count)} steps: t "
          f"{float(sim.state.t):.4f} s, max fluid speed "
          f"{float(metrics['max_velocity']):.4f} m/s, pressure error "
          f"{float(metrics['pressure_error']):.6f}, max fluid density "
          f"{float(sim.state.p.density[fluid].max()):.4f}")

    # stage times of one step at this state (events around each stage)
    solver, state = sim.solver, sim.state

    def staged_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        q, ctx, _ = base.bin_and_sort(state.p, params, solver.engine,
                                      solver.tables)
        ev[1].record()
        q, ctx = base.compute_densities_and_pairs(q, ctx, solver.engine,
                                                  params,
                                                  solver._pair_buffers)
        ev[2].record()
        q = base.compute_non_pressure_forces(q, ctx, solver.engine, params)
        ev[3].record()
        pr, (vp, xp), _ = solver.pressure_solve(q, ctx, state.dt)
        ev[4].record()
        q = solver.advect(q._replace(pressure=pr), vp, xp, state.dt)
        q, _ = base.solve_rigid_body(q, state.rigid_rest_cm, params)
        base.enforce_boundary(q, params, 1)
        ev[5].record()
        return ev

    for _ in range(2):
        staged_step()
    evs = [staged_step() for _ in range(5)]
    torch.cuda.synchronize()
    stages = {}
    for k, name in enumerate(("bin_and_sort", "densities + list",
                              "non-pressure (d over the list)",
                              "pressure loop", "advect + rigid + clamp")):
        stages[name] = sum(e[k].elapsed_time(e[k + 1]) for e in evs) / 5
    print("PCISPH stage ms at this state: " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))
    # 3 iterations per step here: k = 3 reads once with nothing queued;
    # more steps and turns than the other sweeps, the differences are small
    k_sweep(solver, state, f"PCISPH step {int(state.step_count)}", steps=10,
            turns=5, settings=(1, 2, 3, 4))

    # one kernel step against one plain-engine step from the same state
    plain_solver = build_solver(params, device=device,
                                engine=GatherEngine(params))
    ks, km = solver.step(state)
    ps, pm = plain_solver.step(state)
    if int(pm["neighbor_overflow"]) or int(pm["cell_overflow"]):
        raise AssertionError("plain step overflowed its caps")
    its = (int(km["pressure_iters"]), int(pm["pressure_iters"]))
    print(f"PCISPH step kernel vs plain engine: pressure iterations (kernel, "
          f"plain) {its}")
    if its[0] != its[1]:
        raise AssertionError("iteration counts differ")
    real = ps.p.material != -1
    for name in ("x", "v", "density", "pressure", "acc"):
        max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                   f"PCISPH step kernel vs plain engine: {name}")
    del plain_solver, ps

    # per-kernel times at the dragon state's shapes, and the plain versions
    q, starts, plist, nl, (xp, vp, pressure, s_f), pairs = \
        pcisph_state_kernels(params, solver, state)
    dt = state.dt
    reset_all_launch_counts()     # comparison launches are not the path's
    k_list = plist.idx.shape[0]
    fig = walk_profile(params, q.x, q.material == 1, starts, nl,
                       "dragon_bath PCISPH state", list_entries=k_list)
    for name, slots in (("pcisph_d_rho_correct", False),
                        ("pcisph_pressure_accel_predict", False),
                        ("pcisph_d_rho_correct", True),
                        ("pcisph_pressure_accel_predict", True),
                        ("nonpressure_accel", False),
                        ("nonpressure_accel", True)):
        module = cd if name == "nonpressure_accel" else cg
        regs, smem, blocks = module.occupancy(name, slots)
        print(f"  {name}{'[slots]' if slots else ''}: {regs} registers, "
              f"{smem} bytes of shared memory per block, {blocks} blocks of "
              f"128 per SM (occupancy {blocks * 4 / 64:.3f})")
    calls = {
        "nonpressure_accel": (
            lambda: cd.nonpressure_accel(plist, q, params),
            lambda: cd.nonpressure_accel_plain(nl, q, params)),
        "pcisph_d_rho_correct": (
            lambda: cg.d_rho_correct(plist, q, xp, vp, pressure, dt, s_f,
                                     params),
            lambda: cg.d_rho_correct_plain(nl, q, xp, vp, pressure, dt, s_f,
                                           params)),
        "pcisph_pressure_accel_predict": (
            lambda: cg.pressure_accel_predict(plist, q, xp, pressure, dt,
                                              params),
            lambda: cg.pressure_accel_predict_plain(nl, q, xp, pressure, dt,
                                                    params)),
    }
    n = params.n_fluid + params.n_solid
    ms, plain_ms, err = {}, {}, {}
    for name, (kern, plain) in calls.items():
        ms[name] = time_ms(kern, 20)
        plain_ms[name] = time_ms(plain, 3)
        got, ref = kern(), plain()
        if torch.is_tensor(ref):
            got, ref = (got,), (ref,)
        err[name] = 0.0
        for k, (a, b) in enumerate(zip(got, ref)):
            err[name] = max(err[name], max_errors(
                a, b, f"dragon {name} output {k}"))
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f}"
              f" ms")
    err_list = check_pair_list(plist, nl, q, params, "dragon state")[0]
    list_ms = time_ms(lambda: cp.density_sum_list(starts, q, params, {}), 20)
    print(f"density_sum_list (the PCISPH step's density kernel, writing the "
          f"step's list): kernel {list_ms:.4f} ms")
    print(f"  the step's list kernels per step: density_sum_list + d + 3 x "
          f"(g1 + g2) = "
          f"{list_ms + ms['nonpressure_accel'] + 3 * (ms['pcisph_d_rho_correct'] + ms['pcisph_pressure_accel_predict']):.4f}"
          f" ms")
    # the state's own pressure may be 0 this early: g1 and g2 at a seeded
    # prediction (pairs leave the radius) and pressure too
    xs, vs, prs, _, _ = pcisph_inputs(params, solver, q)
    moved, total = pairs_moved(nl, xs, params.support_radius)
    ref = cg.d_rho_correct_plain(nl, q, xs, vs, prs, dt, s_f, params)
    ref2 = cg.pressure_accel_predict_plain(nl, q, xs, ref[0], dt, params)
    got = cg.d_rho_correct(plist, q, xs, vs, prs, dt, s_f, params)
    for k in range(2):
        err["pcisph_d_rho_correct"] = max(
            err["pcisph_d_rho_correct"],
            max_errors(got[k], ref[k], f"dragon, seeded x* and p: g1 output "
                                       f"{k}"))
    got = cg.pressure_accel_predict(plist, q, xs, ref[0], dt, params)
    for k in range(2):
        err["pcisph_pressure_accel_predict"] = max(
            err["pcisph_pressure_accel_predict"],
            max_errors(got[k], ref2[k], f"dragon, seeded x* and p: g2 output "
                                        f"{k}"))
    print(f"  seeded prediction at the dragon: {moved} of {total} step-start "
          f"pairs beyond h at x*, density error on "
          f"{float((ref[1] > 0).float().mean()):.3f} of the rows")
    if err_list != 0.0 or any(err[k] != 0.0 for k in calls):
        raise AssertionError(f"dragon: a kernel differs from its plain "
                             f"version: {err}")
    cells = offset_bytes(params, q.x[q.material == 1])   # fluid centres walk
    # the fluid rows' entries of the list: the ones d and the loop read
    fluid_cnt = torch.where(q.material == 1, plist.cnt, 0)
    list_bytes = 4 * int(torch.clamp_max(fluid_cnt, k_list).long().sum())
    pairs = {"fluid": pairs["fluid_i"], "fluid_ff": pairs["fluid_ff"]}
    # d, g1 and g2 are bounded by the function they compute, over the cell
    # offsets; reading the list instead is a design figure
    bounds = {name: row_bound(name, n, cells, pairs) for name in (
        "nonpressure_accel", "pcisph_d_rho_correct",
        "pcisph_pressure_accel_predict")}
    for name in ("nonpressure_accel", "pcisph_d_rho_correct",
                 "pcisph_pressure_accel_predict"):
        row_bound(name + "_list", n, list_bytes, pairs,
                  f"{name} design figure (reading the list, "
                  f"{fig['warps_over_list']} warps over it; not the bound)")

    # the checkpoint on the card: saved here, resumed into a fresh
    # Simulation, one step on both, bitwise equal
    path = os.path.join("build", "chip_smoke", "checkpoint.npz")
    sim.save(path)
    t0 = time.perf_counter()
    fresh = simulation(config=dragon_config(1), scene_dir=".")
    fresh.resume(path)
    print(f"checkpoint: {os.path.getsize(path)} bytes at step "
          f"{int(sim.state.step_count)}, resumed into a fresh Simulation in "
          f"{time.perf_counter() - t0:.2f} s")
    sim.run(1, export=False)
    fresh.run(1, export=False)
    for name, a in sim.state.p._asdict().items():
        if a is not None and not torch.equal(getattr(fresh.state.p, name), a):
            raise AssertionError(f"resumed step differs in {name}")
    for name in ("rigid_rest_cm", "dt", "t", "step_count"):
        if not torch.equal(getattr(fresh.state, name),
                           getattr(sim.state, name)):
            raise AssertionError(f"resumed step differs in {name}")
    print(f"resumed step {int(fresh.state.step_count)} equals the "
          f"uninterrupted one bitwise (every field)")
    del fresh

    src = {"nonpressure_accel": "sph_taichi_torch/csrc/dfsph.cu"}
    kernels = []
    for name in ("nonpressure_accel", "pcisph_d_rho_correct",
                 "pcisph_pressure_accel_predict"):
        kernels.append({
            "name": name, "route": "cuda",
            "source": src.get(name, "sph_taichi_torch/csrc/pcisph.cu"),
            "replaces": "sph_taichi_tpu/ops/pallas_blocks.py:718",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None})
    return kernels, step_ms


# ---------------------------------------------------------------------------
# kernel 2.1 c (boundary volume) and the slot walk (2.2)
# ---------------------------------------------------------------------------

def volume_scene():
    """The WCSPH two-way scene with a static rigid block below the dynamic
    one: both target masks of the boundary volume have rows."""
    d = small_scene(two_way=True)
    d["RigidBlocks"].append({
        "objectId": 2, "start": [0.55, 0.1, 0.55], "end": [0.9, 0.3, 0.9],
        "translation": [0.0, 0.0, 0.0], "scale": [1.0, 1.0, 1.0],
        "velocity": [0.0, 0.0, 0.0], "density": 500.0,
        "color": [100, 100, 100], "isDynamic": False})
    return d


def overflow_clump(params, p, seed=5):
    """Sorted particles with 40 of them moved into one cell, beyond the
    slot map's 8 x 4 slots."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops.pairs import GatherEngine

    rng = np.random.default_rng(seed)
    x = p.x.cpu().numpy()
    c0 = np.array([6, 6, 6]) * params.grid_size + 0.05 * params.grid_size
    x[40:80] = c0 + rng.uniform(0, 0.9 * params.grid_size, (40, 3))
    q = p._replace(x=torch.tensor(x, device=p.x.device))
    q, _, _ = base.bin_and_sort(q, params, GatherEngine(params))
    starts = base.cell_offsets(
        base.compute_cell_ids(q.x, q.material, params.grid_size,
                              params.grid_num), params.num_cells)
    return q, starts


def check_volume_and_slot_kernels_on_small_scenes(device):
    """Kernel 2.1 c over cell runs, and the three slot instantiations,
    against their plain versions on the clumped small scene with a static
    and a dynamic rigid block: a 20-particle cell (three of the four slot
    layers in use), where the slot kernels must equal the cell-run kernels
    bitwise, and a 40-particle cell (``slot_overflow``), where kernel and
    plain slot lists drop the same pairs (called directly); the slot forces
    over the list that the slot density kernel writes, held against its
    plain version first.  Kernel c's one-thread design and its lane groups
    (``volume_designs``) equal it bitwise over both walks, for both target
    masks (the static one padded with -1)."""
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pairs import GatherEngine
    from sph_taichi_torch.ops.slots import (
        build_slot_map, slot_neighbor_list)

    worst = {}

    def check(name, got, ref, label):
        worst[name] = max(worst.get(name, 0.0), max_errors(
            got, ref, f"{name}[{label}]"))

    params, solver, p, nl, starts, diag = prepared(volume_scene(), device,
                                                   seed=0)
    if int(diag["neighbor_overflow"]) or int(diag["cell_overflow"]):
        raise AssertionError("volume scene: the plain engine's caps "
                             "overflowed")
    caps = dataclasses.replace(params, neighbor_cap=256)
    masks = {"static": p.is_static_rigid(), "dynamic": p.is_dynamic_rigid()}
    for which, mask in masks.items():
        if not bool(mask.any()):
            raise AssertionError(f"no {which} solid in the volume scene")
        worst["boundary_volume"] = max(
            worst.get("boundary_volume", 0.0),
            volume_designs(starts, p, mask, params,
                           f"volume scene [{which}]", nl, reps=0)[0])
    q, dpi, p_r02, m_nc, rr0 = solver.force_inputs(p)
    dt = torch.full((), params.dt0, dtype=torch.float32, device=device)
    for kind in ("layers", "overflow"):
        if kind == "overflow":
            p, starts = overflow_clump(params, p)
            q, dpi, p_r02, m_nc, rr0 = solver.force_inputs(p)
            masks = {"static": p.is_static_rigid(),
                     "dynamic": p.is_dynamic_rigid()}
        smap = build_slot_map(starts, params)
        snl = slot_neighbor_list(smap, p.x, caps)
        d = {k: int(v) for k, v in smap.diag.items()}
        print(f"slot map [{kind}]: {d}, plain slot lists: max neighbours "
              f"{int(snl.max_cnt)}")
        if int(snl.diag["neighbor_overflow"]):
            raise AssertionError("plain slot lists overflowed")
        if d["slot_overflow"] != (kind == "overflow") or \
                d["max_layers_used"] < 2:
            raise AssertionError(f"slot map [{kind}]: {d}")
        got = cp.density_sum(smap, p, params)
        check("density_sum[slots]", got, cp.density_sum_plain(
            snl, p.x, p.material, p.m_V, params), kind)
        # the sums over every pair: plain lists without a cell cap
        full = GatherEngine(dataclasses.replace(caps, cell_cap=64)).prepare(
            p.x, starts)
        dropped = int((got != cp.density_sum_plain(
            full, p.x, p.material, p.m_V, params)).sum())
        print(f"  rows whose slot density differs from the sum over every "
              f"pair: {dropped}")
        if (dropped > 0) != (kind == "overflow"):
            raise AssertionError(f"slot walk [{kind}]: {dropped} rows "
                                 f"differ from the sum over every pair")
        # the forces over the list that the slot density kernel writes
        slist = cp.density_sum_list(smap, p, params)[1]
        check_pair_list(slist, snl, p, params,
                        f"volume scene slot list [{kind}]")
        got = cp.wcsph_forces(slist, q, dpi, p_r02, m_nc, rr0, dt, params)
        ref = cp.wcsph_forces_plain(snl, q, dpi, p_r02, m_nc, rr0, dt,
                                    params)
        for name, a, b in zip(("x", "v", "acc"), got, ref):
            check("wcsph_forces[slots]", a, b, f"{kind}.{name}")
        if kind == "layers":
            plist = cp.density_sum_list(starts, p, params)[1]
            for a, b in zip(got, cp.wcsph_forces(plist, q, dpi, p_r02, m_nc,
                                                 rr0, dt, params)):
                if not torch.equal(a, b):
                    raise AssertionError("slot and cell-run forces differ")
        # kernel c's designs over both walks (-1 pads the static mask's
        # targets), the cell runs of the clump against the lists of every
        # pair
        for which, mask in masks.items():
            worst["boundary_volume[slots]"] = max(
                worst.get("boundary_volume[slots]", 0.0),
                volume_designs(smap, p, mask, params,
                               f"volume scene [{kind}, slots, {which}]", snl,
                               reps=0)[0])
            worst["boundary_volume"] = max(
                worst["boundary_volume"],
                volume_designs(starts, p, mask, params,
                               f"volume scene [{kind}, {which}]", full,
                               reps=0)[0])
            got = cp.boundary_volume(smap, p, mask, params)
            if kind == "layers" and not torch.equal(
                    got, cp.boundary_volume(starts, p, mask, params)):
                raise AssertionError("slot and cell-run volumes differ")
    return worst


# the dense boundary-volume path's calls since main() wrapped it
# (count_dense_calls): all of them, and those a fused (CUDA) engine's
# dispatch made, which must stay 0
DENSE_CALLS = {"dense": 0, "fused": 0}


def count_dense_calls():
    """Wrap the boundary-volume dispatch and its dense path to count the
    dense path's calls in ``DENSE_CALLS``: every call, and the calls that
    a fused engine's dispatch made; returns a function that restores
    both."""
    from sph_taichi_torch.models import base

    dense, dispatch = base._boundary_volume_dense, base._boundary_volume
    fused = [False]

    def counted_dispatch(p, ctx, engine, params, target_mask):
        fused[0] = engine.fused
        try:
            return dispatch(p, ctx, engine, params, target_mask)
        finally:
            fused[0] = False

    def counted(*args, **kwargs):
        DENSE_CALLS["dense"] += 1
        DENSE_CALLS["fused"] += int(fused[0])
        return dense(*args, **kwargs)

    base._boundary_volume = counted_dispatch
    base._boundary_volume_dense = counted

    def restore():
        base._boundary_volume = dispatch
        base._boundary_volume_dense = dense
    return restore


def simulation(*args, **kwargs):
    """``Simulation(*args, **kwargs)`` on the card: its ``initialize``
    must launch kernel c twice over the engine's walk (the static and the
    moving volumes; a target mask without rows writes nothing) and nothing
    else, none in a scene without solids, and never take the dense
    path."""
    from sph_taichi_torch.simulation import Simulation

    reset_all_launch_counts()
    before = DENSE_CALLS["dense"]
    sim = Simulation(*args, **kwargs)
    torch.cuda.synchronize()
    init = {k: v for k, v in all_launch_counts().items() if v}
    dense = DENSE_CALLS["dense"] - before
    name = "boundary_volume" + (
        "[slots]" if sim.params.backend == "pallas_slots" else "")
    expect = {name: 2} if sim.params.n_solid else {}
    print(f"initialize ({sim.params.n_solid} solids, backend "
          f"{sim.params.backend}): launches {init}, dense path calls "
          f"{dense}")
    if init != expect or dense:
        raise AssertionError(f"initialize launched {init} and took the dense "
                             f"path {dense} times; expected {expect} and "
                             f"none")
    return sim


def dense_calls_since(before, label):
    """Raises if the dense path ran since ``DENSE_CALLS["dense"]`` read
    ``before``; prints the count."""
    n = DENSE_CALLS["dense"] - before
    print(f"{label}: dense path calls {n}")
    if n:
        raise AssertionError(f"{label}: the dense boundary-volume path ran "
                             f"{n} times")


def scaled_dragon_config(method=None, dt=None):
    """data/scenes/dragon_bath_dynamic_dfsph.json with the dragon scaled by
    1.25 (34,058 dynamic solids, above DENSE_SOLID_CAP), built in memory;
    ``method`` and ``dt`` override the scene's."""
    from sph_taichi_torch import SimConfig

    with open("data/scenes/dragon_bath_dynamic_dfsph.json") as f:
        d = json.load(f)
    d["RigidBodies"][0]["scale"] = [1.25, 1.25, 1.25]
    if method is not None:
        d["Configuration"]["simulationMethod"] = method
    if dt is not None:
        d["Configuration"]["timeStepSize"] = dt
    return SimConfig(config_dict=d)


def volume_pairs(params, q, nl, mask):
    """Within-radius pairs of the target centres ``mask``, those with a
    solid neighbour, and the rows a target walk reads (the targets and
    their neighbours)."""
    valid = nl.mask() & mask[:, None]
    solid = valid & (q.material[nl.idx] == 0)
    touched = mask.clone()
    touched[nl.idx[valid]] = True
    return int(valid.sum()), int(solid.sum()), int(touched.sum())


def slot_map_bytes(params, smap, xc):
    """Bytes of the slot map that the walks from the centres at ``xc``
    must read: every cell in some centre's 27-cell neighbourhood, in each
    its layers up to the first that holds an empty slot (32 bytes a
    layer)."""
    from sph_taichi_torch.ops.grid import pos_to_cell

    nx, ny, nz = params.grid_num
    dev = xc.device
    cell = pos_to_cell(xc, params.grid_size).long()
    hi = torch.tensor([nx, ny, nz], device=dev)
    seen = torch.zeros((nx, ny, nz), dtype=torch.bool, device=dev)
    for off in itertools.product((-1, 0, 1), repeat=3):
        cc = cell + torch.tensor(off, device=dev)
        cc = cc[((cc >= 0) & (cc < hi)).all(dim=1)]
        seen[cc[:, 0], cc[:, 1], cc[:, 2]] = True
    c = params.num_cells
    cnt = (smap.starts[1:c + 1] - smap.starts[:c]).reshape(nx, ny, nz)
    layers = torch.clamp(cnt // 8 + 1, max=smap.layers)
    return int((layers * seen).sum()) * 32


def volume_bound(name, params, q, nl, mask, index_bytes):
    """Bound of kernel c over the targets ``mask``: x and material of the
    rows the walk reads, the target indices (one per solid), the targets'
    m_V, and ``index_bytes`` of the walk's index (the cell offsets or the
    slot map's entries the targets' walks read); the distance test on each
    within-radius pair and W on each solid one."""
    pairs, solid, touched = volume_pairs(params, q, nl, mask)
    n_t = int(mask.sum())
    nbytes = touched * 16 + params.n_solid * 4 + n_t * 4 + index_bytes
    flops = (pairs - solid) * 8 + solid * BOUNDARY_VOLUME_FLOPS_PER_PAIR
    print(f"{name}: {n_t} targets, {pairs} within-radius pairs, {solid} "
          f"solid-solid, {touched} rows read")
    return bound(name, nbytes, flops)


# lanes per target of kernel c's designs in the control library
VOLUME_GROUPS = (8, 16, 32)
# the shipped kernel c over each walk, as the profiler names it
VOLUME_KERNELS = {"CellRunWalk": "boundary_volume_warp_kernel(",
                  "SlotWalk": "boundary_volume_thread_kernel<SlotWalk>"}


def volume_designs(ctx, q, mask, params, label, nl, reps=20):
    """Kernel c at these inputs (``ctx`` the cell offsets or a SlotMap,
    ``mask`` the targets): the shipped kernel (a warp per target over the
    cell runs, a thread per target over the slot map) equal bitwise to its
    plain version over the lists ``nl``, and to it bitwise the one-thread
    design and every lane group of VOLUME_GROUPS (the control library of
    tools/volume_walk_control.cu) on the same inputs; with ``reps``, each
    design's device ms (profiler).  Returns (the largest difference from
    the plain version, which is 0, {design: ms})."""
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.slots import SlotMap

    walk = "SlotWalk" if isinstance(ctx, SlotMap) else "CellRunWalk"

    def call():
        return cp.boundary_volume(ctx, q, mask, params)

    shipped = call()
    plain = cp.boundary_volume_plain(nl, q, mask, params)
    err = max_errors(shipped, plain, f"{label}: boundary_volume over {walk}")
    if not torch.equal(shipped, plain):
        raise AssertionError(f"{label}: kernel c over {walk} is not bitwise "
                             f"its plain version")
    ms = {}
    if reps:
        ms["shipped"] = kernel_ms(call, VOLUME_KERNELS[walk], reps)
    lib = CONTROL["volume"]
    designs = {"one thread": (1, f"boundary_volume_thread_kernel<{walk}>")}
    designs.update({f"{g} lanes": (g, f"boundary_volume_group_kernel<{g},"
                                      f"{walk}>") for g in VOLUME_GROUPS})
    with control_libs("volume"):
        for name, (group, kernel) in designs.items():
            if lib.control_volume_group(group):
                raise AssertionError(f"control_volume_group({group})")
            try:
                if not torch.equal(call(), shipped):
                    raise AssertionError(f"{label}: kernel c's {name} design "
                                         f"over {walk} differs from the "
                                         f"shipped kernel")
                if reps:
                    ms[name] = kernel_ms(call, kernel, reps)
            finally:
                lib.control_volume_group(0)
    print(f"  {label}: kernel c over {walk}, {int(mask.sum())} targets: "
          f"equal to its plain version bitwise, and the one-thread design "
          f"and lane groups {VOLUME_GROUPS} equal to it bitwise"
          + (f"; device ms (profiler, {reps} launches each) "
             + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) if reps
             else ""))
    return err, ms


def volume_occupancy():
    """Registers, shared memory and resident blocks of kernel c over both
    walks, and of the design not shipped on each (the control library)."""
    from sph_taichi_torch.ops import cuda_pairs as cp

    for k, slots in enumerate((False, True)):
        regs, smem, blocks = cp.occupancy("boundary_volume", slots)
        out = [ctypes.c_int() for _ in range(3)]
        if CONTROL["volume"].control_volume_occupancy(
                k, *[ctypes.byref(o) for o in out]):
            raise AssertionError("control_volume_occupancy")
        shipped, other = (("a thread per target", "the lane group of 32")
                          if slots else
                          ("a warp per target", "a thread per target"))
        print(f"  boundary_volume{'[slots]' if slots else ''} ({shipped}): "
              f"{regs} registers, {smem} bytes of shared memory per block, "
              f"{blocks} blocks of 128 per SM (occupancy {blocks * 4 / 64:.3f})"
              f"; {other} {out[0].value} registers, {out[2].value} blocks "
              f"per SM")


def volume_path(device, warmup, steps):
    """The solid-heavy dynamic dragon (dragon_bath_dynamic_dfsph with the
    dragon scaled by 1.25) through ``Simulation`` with DFSPH: kernel c in
    ``initialize`` and once per step, the dense path never; at that state
    kernel c against its plain version (both target masks) and its
    designs (``volume_designs``); returns the kernel's JSON entry."""
    import warnings

    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_pairs as cp

    t0 = time.perf_counter()
    sim = simulation(config=scaled_dragon_config())
    dense0 = DENSE_CALLS["dense"]
    params = sim.params
    print(f"scaled dynamic dragon (dragon_bath_dynamic_dfsph, dragon "
          f"scale 1.25): {params.n_particles} particles (fluid "
          f"{params.n_fluid}, solid {params.n_solid} > DENSE_SOLID_CAP "
          f"{base.DENSE_SOLID_CAP}), dynamic rigids "
          f"{params.dynamic_rigid_ids}, grid {params.grid_num}, dt "
          f"{params.dt0}; scene + initialize "
          f"{time.perf_counter() - t0:.2f} s")
    if params.n_solid <= base.DENSE_SOLID_CAP:
        raise AssertionError("the scaled dragon is not above the cap")
    sim.run(warmup, export=False)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, m = sim.solver.step(sim.state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    reads = int(m["divergence_host_reads"] + m["pressure_host_reads"])
    # the loop tests' reads, and the rigid solve's SVD and determinant
    loop = [w for w in where if w.startswith("sph_taichi_torch/models/")]
    other = [w for w in where if w not in loop
             and not w.startswith("sph_taichi_torch/ops/linalg.py")]
    print(f"one step under torch.cuda sync-debug mode 'warn': "
          f"{len(where)} host syncs {where}; {reads} reads of the loop "
          f"tests")
    if len(loop) != reads or other:
        raise AssertionError("a step syncs outside its loop tests and "
                             "its rigid solve")

    reset_all_launch_counts()
    sim.reset_solver_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = all_launch_counts()
    st = sim.read_solver_stats()
    step_ms = start.elapsed_time(end) / steps
    print(f"scaled dragon path (DFSPH): {steps} steps, {step_ms:.4f} "
          f"ms/step, {1e3 / step_ms:.3f} steps/s; iterations "
          f"divergence {st['divergence_iters_sum']} pressure "
          f"{st['pressure_iters_sum']}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    dense_calls_since(dense0, "scaled dragon path")
    for name in ("boundary_volume", "dfsph_density_factor",
                 "nonpressure_kick"):
        if launches[name] != steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} steps")
    if any(launches[k] for k in launches if "[slots]" in k):
        raise AssertionError("a slot kernel ran")
    busy_ms = profile_steps(sim, 5)
    if busy_ms is not None:
        print(f"device busy {busy_ms:.4f} ms of the {step_ms:.4f} ms step: "
              f"idle share {100 * (1 - busy_ms / step_ms):.1f}%")
    check_state(sim)

    q, starts, nl, _, _, _ = dragon_state_kernels(params, sim.solver,
                                                  sim.state)
    volume_occupancy()
    masks = {"static": q.is_static_rigid(), "dynamic": q.is_dynamic_rigid()}
    err = 0.0
    for which, mask in masks.items():
        e, ms = volume_designs(starts, q, mask, params,
                               f"scaled dragon [{which}]", nl,
                               reps=20 if which == "dynamic" else 0)
        err = max(err, e)
    dyn = masks["dynamic"]
    k_ms = ms["shipped"]
    call_ms = time_ms(lambda: cp.boundary_volume(starts, q, dyn, params), 20)
    p_ms = time_ms(lambda: cp.boundary_volume_plain(nl, q, dyn, params), 3)
    b = volume_bound("boundary_volume", params, q, nl, dyn,
                     offset_bytes(params, q.x[dyn]))
    print(f"boundary_volume at the scaled dragon: kernel {k_ms:.4f} ms "
          f"(profiler), wrapper call {call_ms:.4f} ms (CUDA events, with "
          f"its target compaction), plain {p_ms:.4f} ms, bound {b[0]:.5f} "
          f"ms by {b[1]}")
    return [{"name": "boundary_volume", "route": "cuda",
             "source": "sph_taichi_torch/csrc/pairs.cu",
             "replaces": "sph_taichi_tpu/ops/pallas_blocks.py:718",
             "launches": launches["boundary_volume"], "max_abs_err": err,
             "ms": k_ms, "plain_ms": p_ms, "bound_ms": b[0],
             "bound_by": b[1], "library_ms": None}], step_ms


def slot_path(device, scene_path, warmup, steps, cell_step_ms):
    """dragon_bath (WCSPH) with ``backend="pallas_slots"`` through
    ``Simulation``: the slot instantiations of density_sum_list (writing
    the step's list) and wcsph_forces (reading it) once per step; device
    busy per step beside wcsph_forces' one-phase slot design (the control
    library) in the same run, and the state then bitwise the cell-run
    twin's; the map's build time and bytes; the slot kernels against
    their plain versions and the cell-run kernels at the dragon state, the
    list kernel beside the one-phase density_sum[slots] (on no step) and
    the forces beside their one-phase design on the same inputs; one slot
    step against one cell-run step from the same state.  Returns the three
    kernels' JSON entries."""
    from sph_taichi_torch import build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.slots import (
        build_slot_map, slot_neighbor_list)

    t0 = time.perf_counter()
    sim = simulation(scene_path, backend="pallas_slots")
    dense0 = DENSE_CALLS["dense"]
    params = sim.params
    print(f"dragon_bath with backend pallas_slots (slot_layers "
          f"{params.slot_layers}): scene + initialize "
          f"{time.perf_counter() - t0:.2f} s")
    # the cell-run twin, stepped alike, for the A/B in turns below
    cell_sim = simulation(scene_path)
    sim.run(warmup, export=False)
    cell_sim.run(warmup + steps, export=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    sim.solver.step(sim.state)
    torch.cuda.set_sync_debug_mode("default")
    print("one slot step under torch.cuda sync-debug mode 'error': no host "
          "sync")

    reset_all_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = all_launch_counts()
    step_ms = start.elapsed_time(end) / steps
    m = sim.metrics
    print(f"slot path (WCSPH, pallas_slots): {steps} steps, {step_ms:.4f} "
          f"ms/step, {1e3 / step_ms:.3f} steps/s (cell-run path "
          f"{cell_step_ms:.4f} ms/step, {1e3 / cell_step_ms:.3f} steps/s); "
          f"max_layers_used {int(m['max_layers_used'])}, max cell occupancy "
          f"{int(m['max_cell_occupancy_engine'])}, slot_overflow "
          f"{bool(m['slot_overflow'])}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    expect = {"density_sum_list[slots]": steps,
              "wcsph_forces[slots]": steps}
    for name, count in launches.items():
        if count != expect.get(name, 0):
            raise AssertionError(f"{name}: {count} launches in {steps} slot "
                                 f"steps, expected {expect.get(name, 0)}")
    dense_calls_since(dense0, "slot path")
    if bool(m["slot_overflow"]):
        raise AssertionError("slot_overflow on the dragon")

    # A/B on this card: 10 steps of each, in turns, in alternating order
    per = {"pallas_slots": [], "auto": []}
    for turn in range(6):
        order = [("pallas_slots", sim), ("auto", cell_sim)]
        for name, s in order[::1 if turn % 2 == 0 else -1]:
            start.record()
            s.run(10 // s.substeps, export=False)
            end.record()
            torch.cuda.synchronize()
            per[name].append(start.elapsed_time(end) / 10)
    print("step ms in 6 turns of 10 steps (slot, cell-run): " + json.dumps(
        {k: [round(t, 4) for t in v] for k, v in per.items()}) + "; medians "
        + json.dumps({k: round(float(np.median(v)), 4)
                      for k, v in per.items()}))
    busy_ms = profile_steps(sim, 10)
    if busy_ms is not None:
        print(f"dragon_bath WCSPH slot device busy {busy_ms:.4f} ms of the "
              f"{step_ms:.4f} ms step: idle share "
              f"{100 * (1 - busy_ms / step_ms):.1f}%")
    # b's earlier slot design (one phase, no list) in the same call,
    # between this design's runs; the results are equal bitwise, so the
    # state stays the twin's (5 steps each: the map holds the fullest
    # cell's 25-32 particles until step ~130)
    with control_kernels(0):
        one_phase_ms = profile_steps(sim, 5)
    again_ms = profile_steps(sim, 5)
    print(f"dragon_bath WCSPH slot device busy per step (profiler): "
          f"wcsph_forces over the step's list {busy_ms} (10 steps) / "
          f"{again_ms} ms (5 steps); one-phase wcsph_forces, no list "
          f"({control_name(0)}) {one_phase_ms} ms (5 steps)")
    cell_sim.run(20 // cell_sim.substeps, export=False)
    if bool(sim.metrics["slot_overflow"]):
        raise AssertionError(f"slot_overflow on the dragon by step "
                             f"{int(sim.state.step_count)}")
    same = all(torch.equal(a, getattr(cell_sim.state.p, f))
               for f, a in sim.state.p._asdict().items() if a is not None)
    print(f"after {int(sim.state.step_count)} steps each, the slot and "
          f"cell-run simulations hold the same state bitwise: {same}")
    if not same:
        raise AssertionError("dragon_bath WCSPH: slot and cell-run states "
                             "differ")
    check_state(sim)

    solver, state = sim.solver, sim.state
    q, smap, _ = base.bin_and_sort(state.p, params, solver.engine,
                                   solver.tables)
    starts = smap.starts
    map_ms = time_ms(lambda: build_slot_map(starts, params), 20)
    map_bytes = smap.idx.numel() * 4
    layers_used = int(smap.diag["max_layers_used"])
    print(f"slot map: {tuple(smap.idx.shape)} i32, {map_bytes} bytes, "
          f"built in {map_ms:.4f} ms; layers in use {layers_used}")
    caps = dataclasses.replace(params, neighbor_cap=max(
        params.neighbor_cap, 96))
    snl = slot_neighbor_list(smap, q.x, caps)
    if int(snl.diag["neighbor_overflow"]):
        raise AssertionError("plain slot lists overflowed")
    pairs = int(snl.cnt[:params.n_fluid + params.n_solid].long().sum())
    q = base.compute_densities(q, smap, solver.engine, params)
    q, dpi, p_r02, m_nc, rr0 = solver.force_inputs(q)
    dt = state.dt
    reset_all_launch_counts()
    ms, plain_ms, err = {}, {}, {}
    slot_buffers = {}
    den, slist = cp.density_sum_list(smap, q, params, slot_buffers)
    ms["density_sum_list[slots]"] = time_ms(
        lambda: cp.density_sum_list(smap, q, params, slot_buffers), 20)
    ms["density_sum[slots]"] = time_ms(
        lambda: cp.density_sum(smap, q, params), 20)
    ms["density_sum"] = time_ms(lambda: cp.density_sum(starts, q, params), 20)
    buffers = {}
    ms["density_sum_list"] = time_ms(
        lambda: cp.density_sum_list(starts, q, params, buffers), 20)
    plist = cp.density_sum_list(starts, q, params, buffers)[1]
    ms["wcsph_forces[slots]"] = time_ms(
        lambda: cp.wcsph_forces(slist, q, dpi, p_r02, m_nc, rr0, dt, params),
        20)
    # b's one-phase slot kernel without the list, same inputs
    with control_kernels(0):
        one_ms = time_ms(lambda: cp.wcsph_forces(slist, q, dpi, p_r02, m_nc,
                                                 rr0, dt, params), 20)
        one = cp.wcsph_forces(slist, q, dpi, p_r02, m_nc, rr0, dt, params)
    if not all(torch.equal(a, b) for a, b in zip(one, cp.wcsph_forces(
            slist, q, dpi, p_r02, m_nc, rr0, dt, params))):
        raise AssertionError("dragon wcsph_forces[slots]: the one-phase "
                             "slot kernel differs from the list kernel")
    print(f"wcsph_forces[slots]: over the step's list "
          f"{ms['wcsph_forces[slots]']:.4f} ms, the one-phase slot kernel "
          f"without it {one_ms:.4f} ms "
          f"({ms['wcsph_forces[slots]'] / one_ms - 1:+.1%}), equal bitwise")
    ms["wcsph_forces"] = time_ms(
        lambda: cp.wcsph_forces(plist, q, dpi, p_r02, m_nc, rr0, dt, params),
        20)
    plain_ms["density_sum[slots]"] = time_ms(
        lambda: cp.density_sum_plain(snl, q.x, q.material, q.m_V, params), 3)
    plain_ms["density_sum_list[slots]"] = time_ms(
        lambda: cp.density_sum_list_plain(snl, q, params), 3)
    plain_ms["wcsph_forces[slots]"] = time_ms(
        lambda: cp.wcsph_forces_plain(snl, q, dpi, p_r02, m_nc, rr0, dt,
                                      params), 3)
    print("slot and cell-run kernels at this state (ms): " + json.dumps(
        {k: round(v, 4) for k, v in ms.items()}))
    err["density_sum[slots]"] = max_errors(
        cp.density_sum(smap, q, params), cp.density_sum_plain(
            snl, q.x, q.material, q.m_V, params), "dragon density_sum[slots]")
    den, slist = cp.density_sum_list(smap, q, params, slot_buffers)
    err["density_sum_list[slots]"] = max(check_pair_list(
        slist, snl, q, params, "dragon density_sum_list[slots]")[0],
        max_errors(den, cp.density_sum_plain(snl, q.x, q.material, q.m_V,
                                             params),
                   "dragon density_sum_list[slots] (sums)"))
    fig = slot_list_profile(q, slist.cnt, False, "dragon_bath WCSPH")
    slot_occupancy(0)
    err["wcsph_forces[slots]"] = 0.0
    for name, a, b in zip(("x", "v", "acc"),
                          cp.wcsph_forces(slist, q, dpi, p_r02, m_nc, rr0,
                                          dt, params),
                          cp.wcsph_forces_plain(snl, q, dpi, p_r02, m_nc,
                                                rr0, dt, params)):
        err["wcsph_forces[slots]"] = max(
            err["wcsph_forces[slots]"],
            max_errors(a, b, f"dragon wcsph_forces[slots].{name}"))

    # one slot step against one cell-run step from the same state
    cell_solver = build_solver(dataclasses.replace(params, backend="auto"),
                               device=device)
    ss, _ = solver.step(state)
    cs, _ = cell_solver.step(state)
    real = cs.p.material != -1
    same = True
    for name in ("x", "v", "density", "pressure", "acc"):
        a, b = getattr(ss.p, name)[real], getattr(cs.p, name)[real]
        max_errors(a, b, f"slot step vs cell-run step: {name}")
        same = same and torch.equal(a, b)
    print(f"the slot step equals the cell-run step bitwise: {same}")

    # the slot walk reads the map's entries and no cell offsets; density
    # walks from every real centre, the forces from the fluid ones and the
    # dynamic rigids
    n = params.n_fluid + params.n_solid
    walkers = (q.material == 1) | q.is_dynamic_rigid()
    den_map = slot_map_bytes(params, smap, q.x[:n])
    frc_map = slot_map_bytes(params, smap, q.x[walkers])
    print(f"slot map bytes the walks read: density {den_map}, forces "
          f"{frc_map}")
    den_bytes = n * (12 + 4 + 4) + 4 * n + den_map
    frc_bytes = n * (12 + 12 + 4 + 4 + 4 + 4 + 4 + 4 + 4) + 4 + n * 36 \
        + frc_map
    # the list as the slot density kernel writes it (every real centre's
    # entries and count): a design figure beside the function's bound
    listed = int(torch.clamp_max(slist.cnt, slist.idx.shape[0]).long().sum())
    bound("density_sum_list[slots] design figure (writing the list, "
          f"{fig['accepted_max']} pairs at most per fluid centre; not the "
          "bound)", den_bytes + 4 * listed + 4 * n,
          pairs * DENSITY_FLOPS_PER_PAIR)
    # the list as the forces read it (their centres' counts and entries
    # instead of the map, no distance test): a design figure too
    listed_b = int(torch.clamp_max(slist.cnt[walkers], slist.idx.shape[0])
                   .long().sum())
    bound("wcsph_forces[slots] design figure (reading the list, "
          f"{fig['warps_over_list']} warps over it; not the bound)",
          frc_bytes - frc_map + 4 * int(walkers.sum()) + 4 * listed_b,
          int(snl.cnt[walkers].long().sum()) * (FORCES_FLOPS_PER_PAIR - 8))
    bounds = {
        "density_sum[slots]": bound("density_sum[slots]", den_bytes,
                                    pairs * DENSITY_FLOPS_PER_PAIR),
        "density_sum_list[slots]": bound("density_sum_list[slots]",
                                         den_bytes,
                                         pairs * DENSITY_FLOPS_PER_PAIR),
        "wcsph_forces[slots]": bound("wcsph_forces[slots]", frc_bytes,
                                     int(snl.cnt[walkers].long().sum())
                                     * FORCES_FLOPS_PER_PAIR)}
    return [{"name": name, "route": "cuda",
             "source": "sph_taichi_torch/csrc/pairs.cu",
             "replaces": "sph_taichi_tpu/ops/retired/pallas_slots.py:355",
             "launches": launches[name], "max_abs_err": err[name],
             "ms": ms[name], "plain_ms": plain_ms[name],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
             "library_ms": None}
            for name in ("density_sum_list[slots]", "density_sum[slots]",
                         "wcsph_forces[slots]")]


def slot_volume_path(device, warmup, steps):
    """The scaled dynamic dragon as WCSPH (dt 4e-4) with
    ``backend="pallas_slots"``: kernel c's slot instantiation in
    ``initialize`` and once per step, beside the slot density and the slot
    forces with the two-way reaction; device busy per step with the forces
    over the step's list and with their one-phase slot design (the control
    library), in the same run; the state bitwise that of a cell-run twin
    stepped alike; at that state the forces with the reaction over the
    list against their plain version and beside the one-phase design on
    the same inputs.  Returns (kernel c's JSON entry, the reaction
    forces' largest difference)."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.slots import slot_neighbor_list

    sim = simulation(config=scaled_dragon_config(method=0, dt=4e-4),
                     backend="pallas_slots")
    dense0 = DENSE_CALLS["dense"]
    params = sim.params
    sim.run(warmup, export=False)
    reset_all_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = all_launch_counts()
    step_ms = start.elapsed_time(end) / steps
    print(f"scaled dragon slot path (WCSPH): {steps} steps, "
          f"{step_ms:.4f} ms/step; max_layers_used "
          f"{int(sim.metrics['max_layers_used'])}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    dense_calls_since(dense0, "scaled dragon slot path")
    expect = {"boundary_volume[slots]": steps,
              "density_sum_list[slots]": steps,
              "wcsph_forces[slots]": steps}
    if {k: v for k, v in launches.items() if v} != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    # the forces' earlier slot design (one phase, no list) between
    # this design's runs, 5 steps each: the map overflows from step
    # ~58 (a cell past 32 particles at the contact)
    busy_ms = profile_steps(sim, 5)
    with control_kernels(0):
        one_phase_ms = profile_steps(sim, 5)
    again_ms = profile_steps(sim, 5)
    print(f"scaled dragon slot WCSPH device busy per step (profiler, 5 "
          f"steps each): wcsph_forces with the reaction over the "
          f"step's list {busy_ms} / {again_ms} ms; one-phase, no list "
          f"({control_name(0)}) {one_phase_ms} ms")
    cell = simulation(config=scaled_dragon_config(method=0, dt=4e-4))
    dense0 = DENSE_CALLS["dense"]
    cell.run(int(sim.state.step_count) // cell.substeps, export=False)
    if int(cell.state.step_count) != int(sim.state.step_count):
        raise AssertionError("the cell-run twin is not at the slot "
                             "run's step")
    dense_calls_since(dense0, "scaled dragon cell-run twin")
    if bool(sim.metrics["slot_overflow"]):
        raise AssertionError(f"scaled dragon: slot_overflow by step "
                             f"{int(sim.state.step_count)}")
    same = all(torch.equal(a, getattr(cell.state.p, f))
               for f, a in sim.state.p._asdict().items() if a is not None)
    print(f"after {int(sim.state.step_count)} steps each, the slot and "
          f"cell-run simulations hold the same state bitwise: {same}")
    if not same:
        raise AssertionError("scaled dragon WCSPH: slot and cell-run states "
                             "differ")
    del cell
    check_state(sim)

    q, smap, _ = base.bin_and_sort(sim.state.p, params, sim.solver.engine,
                                   sim.solver.tables)
    caps = dataclasses.replace(params, neighbor_cap=max(
        params.neighbor_cap, 96))
    snl = slot_neighbor_list(smap, q.x, caps)
    if int(snl.diag["neighbor_overflow"]) or bool(smap.diag["slot_overflow"]):
        raise AssertionError("slot lists or map overflowed")
    err = 0.0
    for which, mask in (("static", q.is_static_rigid()),
                        ("dynamic", q.is_dynamic_rigid())):
        e, ms = volume_designs(smap, q, mask, params,
                               f"scaled dragon [slots, {which}]", snl,
                               reps=20 if which == "dynamic" else 0)
        err = max(err, e)
    dyn = q.is_dynamic_rigid()
    k_ms = ms["shipped"]
    c_ms = kernel_ms(lambda: cp.boundary_volume(smap.starts, q, dyn, params),
                     VOLUME_KERNELS["CellRunWalk"], 20)
    p_ms = time_ms(lambda: cp.boundary_volume_plain(snl, q, dyn, params), 3)
    map_in_use = slot_map_bytes(params, smap, q.x[dyn])
    b = volume_bound("boundary_volume[slots]", params, q, snl, dyn,
                     map_in_use)
    print(f"boundary_volume[slots] at the scaled dragon: kernel "
          f"{k_ms:.4f} ms (cell-run kernel {c_ms:.4f} ms; profiler), plain "
          f"{p_ms:.4f} ms, bound {b[0]:.5f} ms by {b[1]}")

    # the forces with the reaction over the step's slot list
    q = base.compute_densities(q, smap, sim.solver.engine, params)
    q, dpi, p_r02, m_nc, rr0 = sim.solver.force_inputs(q)
    if rr0 is None:
        raise AssertionError("scaled dragon: no reaction variant")
    dt = sim.state.dt
    slist = cp.density_sum_list(smap, q, params, {})[1]
    check_pair_list(slist, snl, q, params, "scaled dragon WCSPH slot list")
    fig = slot_list_profile(q, slist.cnt, True, "scaled dragon WCSPH")
    if not fig["dynamic_rigid_centres"]:
        raise AssertionError("scaled dragon: no dynamic-rigid centre")

    def forces():
        return cp.wcsph_forces(slist, q, dpi, p_r02, m_nc, rr0, dt, params)

    f_ms = time_ms(forces, 20)
    with control_kernels(0):
        one_ms = time_ms(forces, 20)
        one = forces()
    got = forces()
    if not all(torch.equal(a, o) for a, o in zip(got, one)):
        raise AssertionError("scaled dragon wcsph_forces[slots]: the "
                             "one-phase slot kernel differs from the list "
                             "kernel")
    fp_ms = time_ms(lambda: cp.wcsph_forces_plain(
        snl, q, dpi, p_r02, m_nc, rr0, dt, params), 3)
    react_err = 0.0
    for name, a, ref in zip(("x", "v", "acc"), got, cp.wcsph_forces_plain(
            snl, q, dpi, p_r02, m_nc, rr0, dt, params)):
        react_err = max(react_err, max_errors(
            a, ref, f"scaled dragon wcsph_forces[slots] (reaction).{name}"))
    moved = (got[2] - torch.tensor(params.gravity, device=device))[
        q.is_dynamic_rigid()].abs().max()
    print(f"wcsph_forces[slots] with the reaction at the scaled dragon: "
          f"over the step's list {f_ms:.4f} ms, the one-phase slot kernel "
          f"without it {one_ms:.4f} ms ({f_ms / one_ms - 1:+.1%}), equal "
          f"bitwise; plain {fp_ms:.4f} ms; the reaction's largest |acc - g| "
          f"on the dynamic rigid {float(moved):.3e}")
    return [{"name": "boundary_volume[slots]", "route": "cuda",
             "source": "sph_taichi_torch/csrc/pairs.cu",
             "replaces": "sph_taichi_tpu/ops/retired/pallas_slots.py:355",
             "launches": launches["boundary_volume[slots]"],
             "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": b[0], "bound_by": b[1], "library_ms": None}], \
        react_err


# ---------------------------------------------------------------------------
# kernels d-g over the slot walk (DFSPH, IISPH and PCISPH under
# --backend pallas_slots)
# ---------------------------------------------------------------------------

# the entries of the kernels line, one per launch function, and the launch
# names each one weights by its launches on the path
SLOT_ENTRIES = {
    4: {"dfsph_density_factor": ("dfsph_density_factor",),
        "dfsph_divergence": ("dfsph_divergence_change",
                             "dfsph_divergence_adv"),
        "dfsph_solver_dv": ("dfsph_solver_dv",),
        "nonpressure_kick": ("nonpressure_kick",)},
    2: {"iisph_nonpressure_kick": ("iisph_nonpressure_kick",),
        "iisph_predict_advection": ("iisph_predict_advection",),
        "iisph_pressure_accel": ("iisph_pressure_accel",
                                 "iisph_pressure_accel_advect"),
        "iisph_apply_A": ("iisph_apply_A",)},
    1: {"nonpressure_accel": ("nonpressure_accel",),
        "pcisph_d_rho_correct": ("pcisph_d_rho_correct",),
        "pcisph_pressure_accel_predict": ("pcisph_pressure_accel_predict",)},
}
# The designs that the list kernels over the slot walk had before they read
# the step's list (one phase, no list), built beside the kernels: DFSPH's
# Jacobi kernels and the non-pressure kernel d (tools/jacobi_walk_control.cu,
# the control library of tools/jacobi_walk_control.py with d's slot list
# walk in one phase), IISPH's four kernels f1-f4
# (tools/iisph_walk_control.cu), PCISPH's loop kernels
# (tools/pcisph_walk_control.cu with ONE_PHASE) and WCSPH's forces b
# (tools/wcsph_walk_control.cu with ONE_PHASE, the control library of
# tools/wcsph_walk_control.py).  name -> (source, nvcc flags, the module
# whose launchers it serves, those launchers, what it is)
CONTROL_LIBS = {
    "dfsph": ("tools/jacobi_walk_control.cu", [], "cuda_dfsph",
              ("dfsph_density_factor_list_launch", "dfsph_divergence_launch",
               "dfsph_solver_dv_launch", "nonpressure_kick_launch",
               "nonpressure_accel_launch"),
              "the one-phase slot Jacobi kernels and d"),
    "iisph": ("tools/iisph_walk_control.cu", [], "cuda_iisph",
              ("iisph_nonpressure_kick_launch",
               "iisph_predict_advection_launch",
               "iisph_pressure_accel_launch", "iisph_apply_A_launch"),
              "the one-phase slot f1-f4 of IISPH"),
    "pcisph": ("tools/pcisph_walk_control.cu", ["-DONE_PHASE"], "cuda_pcisph",
               ("pcisph_d_rho_correct_launch",
                "pcisph_pressure_accel_predict_launch"),
               "the one-phase slot loop kernels of PCISPH"),
    "wcsph": ("tools/wcsph_walk_control.cu", ["-DONE_PHASE"], "cuda_pairs",
              ("density_sum_launch", "density_sum_list_launch",
               "wcsph_forces_launch", "boundary_volume_launch"),
              "the one-phase slot b of WCSPH"),
    "volume": ("tools/volume_walk_control.cu", [], "cuda_pairs",
               ("density_sum_launch", "density_sum_list_launch",
                "wcsph_forces_launch", "boundary_volume_launch"),
               "kernel c's one-thread design and lane groups of 8, 16 and "
               "32, over either walk"),
}
# simulationMethod -> the control libraries whose wrappers its slot step
# calls: the slot WCSPH, DFSPH, IISPH and PCISPH phases time the list
# readers and step with them (device busy) on the same inputs; kernel c's
# designs ("volume") are timed beside it (volume_designs)
CONTROLS = {4: ("dfsph",), 2: ("iisph",), 1: ("pcisph", "dfsph"),
            0: ("wcsph",)}
CONTROL = {}


def start_control_builds():
    """Starts nvcc on every library of ``CONTROL_LIBS``, all together:
    {name: (its library's path, the process)}."""
    from sph_taichi_torch.ops import _build

    out = os.path.join("build", "walk_control")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, (src, flags, *_) in CONTROL_LIBS.items():
        lib = os.path.abspath(os.path.join(out, f"libsmoke_control_{name}"
                                                f".so"))
        procs[name] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             *flags, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    return procs


def finish_control_builds(procs):
    """Waits for the controls' builds, loads each with the shipped
    launchers' signatures into ``CONTROL`` and prints its ptxas report."""
    for name, (lib, proc) in procs.items():
        src, flags, module, launchers, what = CONTROL_LIBS[name]
        log = proc.communicate(timeout=900)[0]
        label = " ".join([src, *flags])
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc exit {proc.returncode}\n{log}")
        shipped = importlib.import_module(
            f"sph_taichi_torch.ops.{module}")._lib()
        control = ctypes.CDLL(lib)
        for fn_name in launchers:
            fn = getattr(control, fn_name)
            fn.argtypes = getattr(shipped, fn_name).argtypes
            fn.restype = ctypes.c_int
        CONTROL[name] = control
        print(f"{label} ({what}) built: "
              + "; ".join(ln.strip() for ln in log.splitlines()
                          if "Used" in ln and "registers" in ln))


def control_name(method):
    return " and ".join(" ".join([CONTROL_LIBS[name][0],
                                  *CONTROL_LIBS[name][1]])
                        for name in CONTROLS[method])


def control_kernels(method):
    """The wrappers of ``method``'s control modules launching from their
    control libraries."""
    return control_libs(*CONTROLS[method])


@contextlib.contextmanager
def control_libs(*names):
    """The wrappers of the modules that the control libraries ``names``
    serve launching from those libraries."""
    mods = [(importlib.import_module(
        f"sph_taichi_torch.ops.{CONTROL_LIBS[name][2]}"), name)
        for name in names]
    real = [mod._lib for mod, _ in mods]
    for mod, name in mods:
        mod._lib = lambda name=name: CONTROL[name]
    try:
        yield
    finally:
        for (mod, _), lib in zip(mods, real):
            mod._lib = lib


SLOT_SOURCES = {"dfsph": "sph_taichi_torch/csrc/dfsph.cu",
                "nonpressure_accel": "sph_taichi_torch/csrc/dfsph.cu",
                "iisph": "sph_taichi_torch/csrc/iisph.cu",
                "pcisph": "sph_taichi_torch/csrc/pcisph.cu"}


def solver_calls(method, params, solver, p, nl, seeded=True):
    """The pair kernels that simulationMethod ``method`` runs, as (label,
    launch name, wrapper, plain version, the arguments after the
    context): DFSPH's six instantiations (the solver update with and
    without the reaction where the scene has a dynamic rigid), IISPH's
    five, and PCISPH's two with the un-kicked non-pressure kernel.  The
    inputs are built at the sorted state ``p`` by the plain chain over the
    lists ``nl``; with ``seeded`` the stiffness, pressure and prediction
    are seeded (both sides of every gate, pairs leaving the radius),
    otherwise they are those a step builds at this state."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_iisph as ci
    from sph_taichi_torch.ops import cuda_pcisph as cg

    dt = torch.full((), params.dt0, dtype=torch.float32, device=p.x.device)
    fluid = (p.material == 1)[:, None]
    if method == 4:
        density, factor = cd.density_factor_plain(nl, p, params)
        q = p._replace(density=density, dfsph_factor=factor)
        if seeded:
            kappa = random_kappa(q)
            rng = np.random.default_rng(2)
            acc = torch.tensor(rng.uniform(-5, 5, (p.n, 3))
                               .astype(np.float32), device=p.x.device)
        else:
            adv, _ = cd.divergence_plain(nl, q, q.v, None, None, "change",
                                         params)
            kappa = adv * (factor / dt)
            acc = cd.nonpressure_accel_plain(nl, q, params)
        calls = [
            ("dfsph_density_factor", cd.density_factor,
             cd.density_factor_plain, (p, params)),
            ("dfsph_divergence_change", cd.divergence, cd.divergence_plain,
             (q, q.v, None, None, "change", params)),
            ("dfsph_divergence_adv", cd.divergence, cd.divergence_plain,
             (q, q.v, q.density, dt, "adv", params)),
            ("dfsph_solver_dv", cd.solver_dv, cd.solver_dv_plain,
             (q, kappa, q.v, None, dt, False, params)),
            ("nonpressure_kick", cd.nonpressure_kick,
             cd.nonpressure_kick_plain, (q, dt, params))]
        if params.dynamic_rigid_ids:
            calls.append(("dfsph_solver_dv<REACT>", cd.solver_dv,
                          cd.solver_dv_plain,
                          (q, kappa, q.v, acc, dt, True, params)))
    elif method == 2:
        acc, v = ci.nonpressure_kick_plain(nl, p, dt, params)
        q = p._replace(acc=acc, v=v)
        a_ii, source, last_p = ci.predict_advection_plain(nl, q, dt, params)
        pressure = random_pressure(p) if seeded else last_p
        accel = ci.pressure_accel_plain(nl, q, pressure, params)
        calls = [
            ("iisph_nonpressure_kick", ci.nonpressure_kick,
             ci.nonpressure_kick_plain, (p, dt, params)),
            ("iisph_predict_advection", ci.predict_advection,
             ci.predict_advection_plain, (q, dt, params)),
            ("iisph_pressure_accel", ci.pressure_accel,
             ci.pressure_accel_plain, (q, pressure, params)),
            ("iisph_pressure_accel_advect", ci.pressure_accel,
             ci.pressure_accel_plain, (q, pressure, params, dt)),
            ("iisph_apply_A", ci.apply_A, ci.apply_A_plain,
             (q, accel, a_ii, source, pressure, dt, 0.5, params))]
    else:
        q = p._replace(acc=cd.nonpressure_accel_plain(nl, p, params))
        if seeded:
            xp, vp, pressure, dt, s_f = pcisph_inputs(params, solver, q)
        else:
            vp = torch.where(fluid, q.v + dt * q.acc, q.v)
            xp = torch.where(fluid, q.x + dt * vp, q.x)
            s_f = solver.scaling_factor(dt)
            pressure, _ = cg.d_rho_correct_plain(
                nl, q, xp, vp, torch.zeros_like(q.pressure), dt, s_f,
                params)
        calls = [
            ("nonpressure_accel", cd.nonpressure_accel,
             cd.nonpressure_accel_plain, (p, params)),
            ("pcisph_d_rho_correct", cg.d_rho_correct, cg.d_rho_correct_plain,
             (q, xp, vp, pressure, dt, s_f, params)),
            ("pcisph_pressure_accel_predict", cg.pressure_accel_predict,
             cg.pressure_accel_predict_plain, (q, xp, pressure, dt, params))]
    return [(label, label.split("<")[0], wrapper, plain, args)
            for label, wrapper, plain, args in calls]


def outputs(r):
    return (r,) if torch.is_tensor(r) else tuple(r)


def slot_contexts(method, smap, p, params, label=None, snl=None):
    """label -> the context of a slot instantiation of ``solver_calls`` at
    the sorted particles ``p``, as the slot step gives it: on the DFSPH
    step the step's list over their ``SlotMap`` (``density_factor_list``'s,
    e1 over the slot walk) for the Jacobi kernels and d, the map for e1;
    on the IISPH and PCISPH steps the step's list over it
    (``density_sum_list``'s, the density kernel over the slot walk) for
    every kernel (IISPH's f1-f4 and PCISPH's d, g1 and g2 read it).  With
    ``snl`` (the slot lists) the list is held
    against its plain version first, padding rows included.  Returns (that
    function, the list, the labels whose kernels read the list)."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pair_list import step_pairs_plain

    if method == 4:
        slist = cd.density_factor_list(smap, p, params)[2]
        plain = ("dfsph_density_factor[slots]'s list",
                 *step_pairs_plain(snl, p, "jacobi")) \
            if snl is not None else None
        readers = ("dfsph_divergence_change", "dfsph_divergence_adv",
                   "dfsph_solver_dv", "dfsph_solver_dv<REACT>",
                   "nonpressure_kick")
    else:
        slist = cp.density_sum_list(smap, p, params)[1]
        plain = ("density_sum_list[slots]'s list",
                 *cp.density_sum_list_plain(snl, p, params)[1:]) \
            if snl is not None else None
        readers = {2: ("iisph_nonpressure_kick", "iisph_predict_advection",
                       "iisph_pressure_accel", "iisph_pressure_accel_advect",
                       "iisph_apply_A"),
                   1: ("nonpressure_accel", "pcisph_d_rho_correct",
                       "pcisph_pressure_accel_predict")}[method]
    if snl is not None:
        check_pair_list(slist, snl, p, params, label, plain=plain)
    if method == 4:
        return ((lambda name: slist if name in readers else smap), slist,
                readers)
    return (lambda name: slist), slist, readers


def cell_run_contexts(method, starts, p, params):
    """label -> the context of a cell-run instantiation of ``solver_calls``
    at the sorted particles ``p``: their cell offsets, or for every PCISPH
    and IISPH kernel and DFSPH's d the step's list written over them
    (PCISPH's and IISPH's by density_sum_list, DFSPH's by e1)."""
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_pairs as cp

    if method in (1, 2):
        plist = cp.density_sum_list(starts, p, params)[1]
        return lambda label: plist
    plist = cd.density_factor_list(starts, p, params)[2]
    return lambda label: plist if label == "nonpressure_kick" else starts


def check_slot_solver_kernels_on_small_scenes(device):
    """The 14 slot instantiations of kernels d-g against their plain
    versions over the slot lists on the clumped DFSPH (a dynamic rigid
    block), IISPH (a static one) and PCISPH (a dynamic one) scenes: at a
    20-particle cell (three of the four layers), where each also equals
    its cell-run instantiation, and with the 40-particle overflow clump,
    where kernel and plain slot lists drop the same pairs.  DFSPH's Jacobi
    kernels and d take the step's list over the map that e1 writes, IISPH's
    and PCISPH's kernels the one the slot density kernel writes (f1-f4, d,
    g1 and g2 read it), each held against its plain version first.  Every
    comparison is bitwise."""
    from sph_taichi_torch.ops.pairs import GatherEngine
    from sph_taichi_torch.ops.slots import (
        build_slot_map, slot_neighbor_list)

    worst, labels = {}, set()
    for method, scene in ((4, dfsph_scene("two_way")),
                          (2, iisph_scene("rigid")),
                          (1, pcisph_scene("two_way"))):
        params, solver, p, _, starts, _ = prepared(scene, device, seed=0)
        caps = dataclasses.replace(params, neighbor_cap=256, cell_cap=64)
        for kind in ("layers", "overflow"):
            if kind == "overflow":
                p, starts = overflow_clump(params, p)
            smap = build_slot_map(starts, params)
            snl = slot_neighbor_list(smap, p.x, caps)
            full = GatherEngine(caps).prepare(p.x, starts)
            d = {k: int(v) for k, v in smap.diag.items()}
            if int(snl.diag["neighbor_overflow"]) or \
                    int(full.diag["neighbor_overflow"]):
                raise AssertionError("plain lists overflowed")
            if d["slot_overflow"] != (kind == "overflow") or \
                    d["max_layers_used"] < 2:
                raise AssertionError(f"slot map [{kind}]: {d}")
            dropped = int((snl.cnt != full.cnt).sum())
            if (dropped > 0) != (kind == "overflow"):
                raise AssertionError(f"{dropped} rows lose pairs [{kind}]")
            calls = solver_calls(method, params, solver, p, snl)
            cell_ctx = cell_run_contexts(method, starts, p, params)
            slot_ctx = slot_contexts(method, smap, p, params,
                                     f"method {method} [{kind}]", snl)[0]
            for label, _, wrapper, plain, args in calls:
                got = outputs(wrapper(slot_ctx(label), *args))
                ref = outputs(plain(snl, *args))
                cell = outputs(wrapper(cell_ctx(label), *args)) \
                    if kind == "layers" else ref
                for a, b, c in zip(got, ref, cell):
                    if b is None:
                        continue
                    err = float((a.double() - b.double()).abs().max())
                    worst[label + "[slots]"] = max(
                        worst.get(label + "[slots]", 0.0), err)
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"{label}[slots] [method {method}, {kind}]: "
                            f"not equal to its plain version ({err:.3e})")
                    if not torch.equal(a, c):
                        raise AssertionError(
                            f"{label}[slots] [method {method}]: not equal "
                            f"to its cell-run instantiation")
                labels.add(label)
            print(f"slot kernels d-g, method {method} [{kind}]: slot map "
                  f"{d}; {len(calls)} instantiations"
                  + {4: " (the Jacobi kernels and d over e1's slot list)",
                     2: " (f1-f4 over density_sum_list[slots]'s list)",
                     1: " (d, g1 and g2 over density_sum_list[slots]'s "
                        "list)"}[method]
                  + " equal to their plain versions over the slot lists"
                  + (" and to their cell-run instantiations"
                     if kind == "layers" else "")
                  + f" bitwise; rows whose slot lists lose pairs {dropped}")
    if len(labels) != 14:
        raise AssertionError(f"{len(labels)} slot instantiations checked, "
                             f"not 14: {sorted(labels)}")
    return worst


def slot_solver_path(device, config, label, warmup, steps, turns=6,
                     per_turn=5):
    """``config`` with ``backend="pallas_slots"`` through ``Simulation``,
    beside a cell-run twin of the same scene stepped alike: ``warmup``
    steps on both, then ``steps`` timed on each (launch counts set to 0
    just before each run and read just after), 5 steps of the slot run
    under the profiler (its device busy share; then 5 with the list
    readers' one-phase slot design of the control libraries and 5 more
    over the list, DFSPH two turns fewer) and as many of the twin,
    ``turns`` interleaved turns of ``per_turn`` steps.  The slot run must
    launch every kernel of the cell-run run as its ``[slots]``
    instantiation, as often; run the same iterations with the same host
    reads; and hold the same state bitwise while no cell overflows.
    Returns (slot simulation, its launches, its step ms)."""

    t0 = time.perf_counter()
    sim = simulation(config=config, scene_dir=".", backend="pallas_slots")
    cell = simulation(config=config, scene_dir=".")
    torch.cuda.synchronize()
    params = sim.params
    print(f"{label} with backend pallas_slots (slot_layers "
          f"{params.slot_layers}): {params.n_particles} particles (fluid "
          f"{params.n_fluid}, solid {params.n_solid}), dt {params.dt0}, "
          f"{type(sim.solver).__name__}; both scenes + initialize "
          f"{time.perf_counter() - t0:.2f} s")
    sim.run(warmup // sim.substeps, export=False)
    cell.run(warmup // cell.substeps, export=False)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = {}
    for name, s in (("slots", sim), ("cell-run", cell)):
        reset_all_launch_counts()
        s.reset_solver_stats()
        start.record()
        s.run(steps // s.substeps, export=False)
        end.record()
        torch.cuda.synchronize()
        runs[name] = ({k: v for k, v in all_launch_counts().items() if v},
                      s.read_solver_stats(), start.elapsed_time(end) / steps)
    launches, st, step_ms = runs["slots"]
    cell_launches, cst, cell_ms = runs["cell-run"]
    m = sim.metrics
    solves = [k[:-len("_iters_sum")] for k in st if k.endswith("_iters_sum")]
    per_step = "; ".join(
        f"{s} iterations {st[s + '_iters_sum'] / steps:.2f} (max "
        f"{st[s + '_iters_max']}), host reads "
        f"{st[s + '_host_reads'] / steps:.2f}" for s in solves)
    print(f"{label} slot path: {steps} steps, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s (cell-run twin {cell_ms:.4f} ms/step, "
          f"{1e3 / cell_ms:.3f} steps/s); per step: {per_step}; "
          f"max_layers_used {int(m['max_layers_used'])}, max cell "
          f"occupancy {int(m['max_cell_occupancy_engine'])}, slot_overflow "
          f"{bool(m['slot_overflow'])}; launches {launches}")
    if bool(m["slot_overflow"]):
        raise AssertionError(f"{label}: slot_overflow at step "
                             f"{int(sim.state.step_count)}")
    # every kernel of the cell-run run, the density kernel writing the
    # step's list included, as its slot instantiation
    expect = {k + "[slots]": v for k, v in cell_launches.items()}
    if launches != expect:
        raise AssertionError(f"{label}: slot launches {launches}, the "
                             f"cell-run run's {cell_launches}")
    if st != cst:
        raise AssertionError(f"{label}: solver stats {st}, cell-run {cst}")
    busy_ms = profile_steps(sim, 5)
    if busy_ms is not None:
        print(f"{label} slot device busy {busy_ms:.4f} ms of the "
              f"{step_ms:.4f} ms slot step: idle share "
              f"{100 * (1 - busy_ms / step_ms):.1f}%")
    profiled = 5
    method = params.simulation_method
    if method in CONTROLS:
        # the list kernels' earlier slot design (one phase, no list) in
        # the same call, between this design's runs; the results are equal
        # bitwise, so the state stays the twin's
        with control_kernels(method):
            one_phase_ms = profile_steps(sim, 5)
        again_ms = profile_steps(sim, 5)
        profiled += 10
        if method == 4:
            # the run keeps its length: the scaled dragon's slot map
            # overflows from step ~58 (a cell past 32 particles at the
            # contact)
            turns = max(1, turns - 10 // per_turn)
        kernels = {4: "Jacobi kernels and d", 2: "f1-f4",
                   1: "loop kernels and d"}[method]
        print(f"{label} slot device busy per step (profiler, 5 steps each): "
              f"{kernels} over the step's list {busy_ms} / {again_ms} ms; "
              f"one-phase {kernels}, no list ({control_name(method)}) "
              f"{one_phase_ms} ms")
    cell.run(profiled // cell.substeps, export=False)

    per = {"pallas_slots": [], "auto": []}
    for turn in range(turns):
        order = [("pallas_slots", sim), ("auto", cell)]
        for name, s in order[::1 if turn % 2 == 0 else -1]:
            start.record()
            s.run(per_turn // s.substeps, export=False)
            end.record()
            torch.cuda.synchronize()
            per[name].append(start.elapsed_time(end) / per_turn)
    print(f"{label} step ms in {turns} turns of {per_turn} steps (slot, "
          f"cell-run): " + json.dumps(
              {k: [round(t, 4) for t in v] for k, v in per.items()})
          + "; medians " + json.dumps(
              {k: round(float(np.median(v)), 4) for k, v in per.items()}))
    same = all(torch.equal(a, getattr(cell.state.p, f))
               for f, a in sim.state.p._asdict().items() if a is not None)
    print(f"after {int(sim.state.step_count)} steps each, the slot and "
          f"cell-run simulations hold the same state bitwise: {same}")
    if not same:
        raise AssertionError(f"{label}: slot and cell-run states differ")
    del cell
    check_state(sim)
    return sim, launches, step_ms


def slot_solver_kernels(sim, method, launches, label):
    """The slot instantiations of ``method``'s kernels at the state of
    ``sim``, on the inputs a step builds there: time (20 launches), the
    cell-run instantiation's time on the same inputs, the plain version's
    over the slot lists (3 calls), the error against it, and the bound
    (the map entries the walks read, no cell offsets).  Returns the
    kernels-line entries, one per launch function, the entries of several
    instantiations weighted by their launches on the path, and the error
    of each instantiation."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops.slots import slot_neighbor_list

    params, solver = sim.params, sim.solver
    q, smap, _ = base.bin_and_sort(sim.state.p, params, solver.engine,
                                   solver.tables)
    caps = dataclasses.replace(params, neighbor_cap=max(
        params.neighbor_cap, 96))
    snl = slot_neighbor_list(smap, q.x, caps)
    if int(snl.diag["neighbor_overflow"]):
        caps = dataclasses.replace(caps, neighbor_cap=int(snl.max_cnt))
        snl = slot_neighbor_list(smap, q.x, caps)
    n = params.n_fluid + params.n_solid
    fluid = q.material == 1
    real = q.material >= 0
    valid = snl.mask()
    fluid_j = valid & (q.material[snl.idx] == 1)
    pairs = {"fluid": int(snl.cnt[fluid].long().sum()),
             "fluid_ff": int(fluid_j[fluid].sum()),
             "real": int(snl.cnt[real].long().sum()),
             "real_fj": int(fluid_j[real].sum())}
    walkers = real if method == 2 else fluid
    map_bytes = slot_map_bytes(params, smap, q.x[walkers])
    print(f"{label} at step {int(sim.state.step_count)}: within-radius "
          f"pairs {pairs}; slot map bytes the walks read {map_bytes}")
    reset_all_launch_counts()     # comparison launches are not the path's
    ms, cell_ms, plain_ms, err, bounds = {}, {}, {}, {}, {}
    cell_ctx = cell_run_contexts(method, smap.starts, q, params)
    slot_ctx, slist, readers = slot_contexts(method, smap, q, params, label,
                                             snl)
    fig = slot_list_profile(
        q, slist.cnt, method == 4 and bool(params.dynamic_rigid_ids), label,
        walks=real if method == 2 else None)
    slot_occupancy(method)
    if method == 1:
        slot_density_at_state(q, smap, snl, params, label)
    for name, key, wrapper, plain, args in solver_calls(
            method, params, solver, q, snl, seeded=False):
        ctx, sctx = cell_ctx(name), slot_ctx(name)
        ms[name] = time_ms(lambda: wrapper(sctx, *args), 20)
        cell_ms[name] = time_ms(lambda: wrapper(ctx, *args), 20)
        plain_ms[name] = time_ms(lambda: plain(snl, *args), 3)
        got, ref = outputs(wrapper(sctx, *args)), outputs(plain(snl, *args))
        if name in readers:
            # the one-phase slot kernel without the list, same inputs
            with control_kernels(method):
                one_ms = time_ms(lambda: wrapper(sctx, *args), 20)
                one = outputs(wrapper(sctx, *args))
            if not all(b is None or torch.equal(a, b)
                       for a, b in zip(one, got)):
                raise AssertionError(f"{label} {name}: the one-phase slot "
                                     f"kernel differs from the list kernel")
            print(f"{name}[slots]: over the step's list {ms[name]:.4f} ms, "
                  f"the one-phase slot kernel without it {one_ms:.4f} ms "
                  f"({ms[name] / one_ms - 1:+.1%}), equal bitwise")
        cell = outputs(wrapper(ctx, *args))
        err[name] = 0.0
        for k, (a, b, c) in enumerate(zip(got, ref, cell)):
            if b is None:
                continue
            err[name] = max(err[name], max_errors(
                a[:n], b[:n], f"{label} {name}[slots] output {k}"))
            if not torch.equal(a, c):
                raise AssertionError(f"{label} {name}: slot and cell-run "
                                     f"instantiations differ")
        if name.endswith("<REACT>"):
            moved = (got[1] - args[3])[q.is_dynamic_rigid()].abs().max()
            print(f"  reaction on the dynamic rigid at this state: max "
                  f"|acc change| {float(moved):.3e}")
        if key == name:
            bounds[name] = row_bound(name, n, map_bytes, pairs,
                                     f"{name}[slots]")
        print(f"{name}[slots]: kernel {ms[name]:.4f} ms (cell-run "
              f"{cell_ms[name]:.4f} ms, {ms[name] / cell_ms[name] - 1:+.1%})"
              f", plain {plain_ms[name]:.4f} ms, equal to the cell-run "
              f"instantiation bitwise")
    # the list as the slot design writes (e1) and reads it (the readers:
    # the rows each walks), design figures beside the functions' bounds
    # (the slot density kernel's writes are phase 12's design figure)
    def listed(rows):
        return int(torch.clamp_max(slist.cnt[rows], slist.idx.shape[0])
                   .long().sum())

    if method == 4:
        row_bound("dfsph_density_factor_list", n,
                  map_bytes + 4 * listed(real), pairs,
                  "dfsph_density_factor[slots] design figure (writing the "
                  "list; not the bound)")
    for name in readers:
        if name.endswith("<REACT>"):
            continue
        rows = real if method == 2 or name.startswith("dfsph_") else fluid
        row_bound(name + "_list", n, 4 * listed(rows), pairs,
                  f"{name}[slots] design figure (reading the list, "
                  f"{fig['warps_over_list']} warps over it; not the bound)")
    kernels = []
    for entry, names in SLOT_ENTRIES[method].items():
        w = [launches.get(k + "[slots]", 0) for k in names]
        total = sum(w)
        if total == 0:
            raise AssertionError(f"{entry}[slots]: not launched on the path")

        def mixed(d):
            return sum(wi * d[k] for wi, k in zip(w, names)) / total

        source = SLOT_SOURCES.get(entry, SLOT_SOURCES[
            {4: "dfsph", 2: "iisph", 1: "pcisph"}[method]])
        kernels.append({
            "name": entry + "[slots]", "route": "cuda", "source": source,
            "replaces": "sph_taichi_tpu/ops/retired/pallas_slots.py:355",
            "launches": total, "max_abs_err": max(err[k] for k in names),
            "ms": mixed(ms), "plain_ms": mixed(plain_ms),
            "bound_ms": mixed({k: bounds[k][0] for k in names}),
            "bound_by": bounds[names[-1]][1], "library_ms": None})
    return kernels, err


def slot_scaled_dragon_path(device, warmup, steps):
    """The scaled dynamic dragon (34,058 dynamic solids) as DFSPH under
    ``backend="pallas_slots"`` beside its cell-run twin
    (``slot_solver_path``): kernel c's and the reaction solver update's
    slot instantiations every step, the dense path never; the reaction
    kernel against its plain version at that state.  Returns its largest
    difference."""
    dense0 = DENSE_CALLS["dense"]
    sim, launches, _ = slot_solver_path(
        device, scaled_dragon_config(), "scaled dynamic dragon (DFSPH)",
        warmup, steps)
    dense_calls_since(dense0, "scaled dragon slot and cell-run paths")
    if launches.get("boundary_volume[slots]") != steps:
        raise AssertionError(f"launches {launches}")
    _, err = slot_solver_kernels(sim, 4, launches, "scaled dragon")
    return err["dfsph_solver_dv<REACT>"]


LEGACY2D_METHODS = ("WCSPH", "PCISPH", "DFSPH")
LEGACY2D_MAX_TIME = 0.5      # simulated seconds: past the emission at 0.4
LEGACY2D_TRACE_STEPS = 20


def legacy2d_inside(sph):
    """Finite positions and velocities, the fluid inside the padded bounds
    that ``_enforce_boundary`` pushes it back to (1e-5 m for the push's
    rounding)."""
    s = sph.state
    x, v = s.x[:s.n], s.v[:s.n]
    if not bool(torch.isfinite(x).all() & torch.isfinite(v).all()):
        raise AssertionError("legacy2d: non-finite positions or velocities")
    xf = x[s.material[:s.n] == 1].cpu().numpy()
    eps = 1e-5
    lo = (sph.left_bound + 0.5 * sph.padding, sph.bottom_bound + sph.padding)
    hi = (sph.right_bound - 0.5 * sph.padding, sph.top_bound - sph.padding)
    if not ((xf >= np.array(lo) - eps).all() and
            (xf <= np.array(hi) + eps).all()):
        raise AssertionError("legacy2d: fluid outside the padded bounds")


def legacy2d_path(device, smi):
    """Phase 26: the legacy 2D engine through its driver, each method to
    t >= LEGACY2D_MAX_TIME, then a traced window and the card step against
    the CPU step from the state just after the emission."""
    from types import SimpleNamespace

    import tempfile

    from sph_taichi_torch import run_simulation_2d as r2d
    from sph_taichi_torch.convert import (
        DEVICE_STEP_TOL, state2d_errors, state2d_f64_witness,
        state2d_from_numpy, state2d_step_tolerances, state2d_to_numpy)
    from sph_taichi_torch.utils.profiling import StepTimer, trace

    for method in LEGACY2D_METHODS:
        opt = SimpleNamespace(method=method, adaptive=True, save=False,
                              max_frames=10 ** 6,
                              max_time=LEGACY2D_MAX_TIME, output_dir=None)
        emitted = {}
        progress = []
        timer = StepTimer(device)
        reset_all_launch_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r2d.run(opt, device=device, timer=timer,
                      on_emission=lambda sph: emitted.update(
                          state2d_to_numpy(sph.state)),
                      log=progress.append)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        launches = {k: v for k, v in all_launch_counts().items() if v}
        sph, steps = out["solver"], out["frames"]
        its = np.array(out["iterations"])
        print(f"legacy2d {method} (run_simulation_2d's scene, adaptive dt, "
              f"to t >= {LEGACY2D_MAX_TIME} s): {steps} steps to t = "
              f"{out['t']:.4f} s in {ms:.1f} ms, {steps / ms * 1e3:.1f} "
              f"steps/s (CUDA events around run(); {smi})")
        print(f"  host reads per step {sum(out['reads']) / steps:.3f} (the "
              f"loops' reads and step()'s one transfer of dt and "
              f"iterations); iterations per step mean {its.mean():.3f}, max "
              f"{its.max()}; n {out['n_before']} before the emission, "
              f"{out['n_after']} after; hand-kernel launches {launches}")
        print(f"  StepTimer (CUDA events; {smi}): "
              + timer.report().replace("\n", "; "))
        print(f"  the driver's last lines: {' | '.join(progress[-2:])}")
        if not out["emitted"] or (out["n_before"], out["n_after"]) != (
                1500, 2000):
            raise AssertionError(f"legacy2d {method}: emission {out['n_before']}"
                                 f" -> {out['n_after']}, not 1500 -> 2000")
        if launches:
            raise AssertionError(f"legacy2d {method} launched hand kernels: "
                                 f"{launches}")
        legacy2d_inside(sph)

        t_trace = time.perf_counter()
        with tempfile.TemporaryDirectory() as log_dir:
            with trace(log_dir) as prof:
                t0 = time.perf_counter()
                for _ in range(LEGACY2D_TRACE_STEPS):
                    sph.step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            trace_bytes = os.path.getsize(prof.trace_path)
        rows = kernel_rows(prof)
        if not rows:
            raise AssertionError(f"legacy2d {method}: the trace holds no "
                                 f"device time")
        busy_ms = sum(r[0] for r in rows) / LEGACY2D_TRACE_STEPS / 1e3
        t_trace = time.perf_counter() - t_trace
        print(f"  device busy per step {busy_ms:.4f} ms, "
              f"{sum(r[1] for r in rows) / LEGACY2D_TRACE_STEPS:.1f} kernels "
              f"per step, wall {wall_ms / LEGACY2D_TRACE_STEPS:.4f} ms per "
              f"step under the profiler, over {LEGACY2D_TRACE_STEPS} steps "
              f"(profiling.trace; Chrome trace {trace_bytes} bytes, "
              f"removed; the window with the trace's export and summary "
              f"{t_trace:.1f} s; {smi})")
        legacy2d_inside(sph)

        t_cpu = time.perf_counter()
        cpu = r2d.build_solver(method, True, 1, device="cpu")
        ref, ref_it = cpu._step(state2d_from_numpy(emitted, "cpu"))
        t_cpu = time.perf_counter() - t_cpu
        got, got_it = sph._step(state2d_from_numpy(emitted, device))
        ref64, it64 = cpu._step(state2d_from_numpy(emitted, "cpu",
                                                   torch.float64))
        ref, got = state2d_to_numpy(ref), state2d_to_numpy(got)
        ref64 = state2d_to_numpy(ref64)
        err = state2d_errors(got, ref)
        tol = state2d_step_tolerances(sph, ref, int(ref_it), emitted["dt"],
                                      *DEVICE_STEP_TOL)
        bad = {k: (err[k], tol[k]) for k in err if not err[k] <= tol[k]}
        print(f"  one step from the state just after the emission, card "
              f"against CPU (the CPU step {t_cpu:.1f} s): iterations "
              f"{int(got_it)} / {int(ref_it)}, max abs err (tolerance) "
              + ", ".join(f"{k} {err[k]:.3g} ({tol[k]:.3g})" for k in err
                          if tol[k] or err[k]))
        if bad or int(got_it) != int(ref_it):
            raise AssertionError(f"legacy2d {method}: the card step differs "
                                 f"from the CPU step: {bad}, iterations "
                                 f"{int(got_it)} / {int(ref_it)}")
        far, worse = state2d_f64_witness(cpu, got, ref, ref64, int(it64),
                                         emitted["dt"])
        print(f"  the same step in f64 on the CPU: iterations {int(it64)}; "
              f"max abs distance from it, card / CPU: "
              + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b)
                          in far.items() if a or b))
        if worse or int(it64) != int(ref_it):
            raise AssertionError(f"legacy2d {method}: the card's f32 step "
                                 f"lies further from the f64 step than the "
                                 f"CPU's allows: {worse}, iterations "
                                 f"{int(it64)} / {int(ref_it)}")
        del sph, out
        torch.cuda.empty_cache()


SHARDED_SCENE = "data/scenes/armadillo_bath_dynamic.json"
SHARDED_FIELDS = ("x", "v", "density", "material", "object_id")
# the hand kernels of a sharded WCSPH step with dynamic rigids, per rank
SHARDED_KERNELS = ("density_sum_list", "wcsph_forces", "boundary_volume")


def sharded_capacities(params, particles, world):
    """(halo_cap, loc_cap): the fullest x-layer of the scene with a quarter
    to spare, and the most particles a rank owns with 2% and 4,096 to
    spare, each rounded up to 256."""
    from sph_taichi_torch.ops.grid import pos_to_cell

    real = particles.material >= 0
    ix = pos_to_cell(particles.x[real], params.grid_size)[:, 0].long()
    layers = torch.bincount(ix, minlength=params.grid_num[0])
    nxd = -(-params.grid_num[0] // world)
    per_rank = [int(layers[r * nxd:(r + 1) * nxd].sum()) for r in range(world)]

    def up(n):
        return -(-int(n) // 256) * 256

    return (up(1.25 * int(layers.max())), up(1.02 * max(per_rank) + 4096),
            int(layers.max()), per_rank)


def rms_radii(state, ids):
    """{object id: rms distance of its particles from their centroid}."""
    out = {}
    for i in ids:
        xs = state["x"][state["object_id"] == i].astype(np.float64)
        out[i] = float(np.sqrt(((xs - xs.mean(0)) ** 2).sum(1).mean()))
    return out


def sharded_path(device, smi):
    """Phase 27: spatial slab sharding (sph_taichi_torch/parallel) on one
    card.  armadillo_bath_dynamic (WCSPH, three dynamic armadillos) at its
    full size in slabs of D = 2 (two processes sharing the card over gloo,
    staged through the host) and D = 1 (one process, NCCL), against the
    port's single-device step; then the small scene's methods 0, 1, 2
    and 4 at D = 2 against the single-device step.  The kernels were built
    in phase 1: the ranks load them."""
    from sph_taichi_torch import SimConfig, build_scene, build_solver, entry
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.parallel import comm as pcomm

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    params, particles, _ = build_scene(SimConfig(SHARDED_SCENE),
                                       device=device)
    halo_cap, loc_cap, layer_max, per_rank = sharded_capacities(
        params, particles, 2)
    print(f"{SHARDED_SCENE}: {params.n_fluid} fluid + {params.n_solid} solid "
          f"particles, dynamic rigids {params.dynamic_rigid_ids}, grid "
          f"{params.grid_num}; fullest x-layer {layer_max} particles, owned "
          f"per slab at D = 2 {per_rank}: halo_cap {halo_cap}, loc_cap "
          f"{loc_cap}; scene {time.perf_counter() - t0:.1f} s")

    # the single-device step: the reference after 1 step, and its time
    solver = build_solver(params, device=device)
    state = solver.initialize(particles)
    del particles
    state, _ = solver.step(state)
    real = state.p.material >= 0
    ref1 = {f: getattr(state.p, f)[real].cpu().numpy()
            for f in SHARDED_FIELDS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        state, _ = solver.step(state)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / 4 * 1e3
    del solver, state, real
    torch.cuda.empty_cache()

    spec = {"scene": SHARDED_SCENE, "steps": 5, "record": [0, 1, 5],
            "fields": SHARDED_FIELDS, "mig_cap": 4096, "halo_cap": halo_cap,
            "loc_cap": loc_cap, "time": True}
    small = []
    for m in (0, 1, 2, 4):
        scene = small_scene()
        scene["Configuration"]["simulationMethod"] = m
        scene["Configuration"]["timeStepSize"] = 4e-4 if m == 0 else 4e-3
        small.append({"scene": scene, "steps": 1, "record": [1],
                      "mig_cap": 128, "halo_cap": 512})
    t0 = time.perf_counter()
    d2 = pcomm.launch(entry.run_scenarios, 2, args=([spec] + small,),
                      backend="gloo", devices=["cuda:0", "cuda:0"],
                      timeout=600.0)[0]
    print(f"D = 2 (gloo, staged through the host, both ranks on cuda:0): "
          f"{time.perf_counter() - t0:.1f} s, processes started and joined")
    t0 = time.perf_counter()
    d1 = pcomm.launch(entry.run_scenarios, 1,
                      args=([dict(spec, loc_cap=params.n_pad)],),
                      backend="nccl", devices=["cuda:0"], timeout=600.0)[0]
    print(f"D = 1 (NCCL): {time.perf_counter() - t0:.1f} s")

    lo, hi = cp.box_limits(params)
    ids = params.dynamic_rigid_ids
    for world, rec in ((2, d2[0]), (1, d1[0])):
        label = f"armadillo_bath_dynamic sharded D = {world}"
        worst = entry.match_states(ref1, rec["states"][1], dict.fromkeys(
            ("x", "v", "density"), ATOL), RTOL)
        print(f"{label}: step 1 against the single-device step through the "
              f"nearest-position bijection: max |difference| {worst} (atol "
              f"{ATOL}, rtol {RTOL})")
        last, first = rec["states"][5], rec["states"][0]
        if last["x"].shape[0] != params.n_particles:
            raise AssertionError(f"{label}: {last['x'].shape[0]} particles "
                                 f"after 5 steps, {params.n_particles} "
                                 f"before")
        if not (np.isfinite(last["x"]).all() and np.isfinite(last["v"]).all()):
            raise AssertionError(f"{label}: non-finite state")
        if not ((last["x"] >= lo - 1e-4).all()
                and (last["x"] <= np.array(hi) + 1e-4).all()):
            raise AssertionError(f"{label}: a particle left the padded box")
        flags = [(i, k) for i, m in enumerate(rec["metrics"])
                 for k in ("migration_overflow", "halo_overflow")
                 if m.get(k)]
        if flags:
            raise AssertionError(f"{label}: overflow {flags}")
        r0, r5 = rms_radii(first, ids), rms_radii(last, ids)
        drift = {i: abs(r5[i] - r0[i]) / r0[i] for i in ids}
        if max(drift.values()) >= 1e-3:
            raise AssertionError(f"{label}: rigid shape not kept {drift}")
        print(f"{label}: after 5 steps {last['x'].shape[0]} particles, "
              f"finite, inside the padded box, no overflow flag; rigid rms "
              f"radius drift (relative) "
              + ", ".join(f"{i}: {d:.2e}" for i, d in drift.items()))
        for r, rr in enumerate(rec["ranks"]):
            per_step = rr["launches"]
            missing = [(i + 1, k) for i, c in enumerate(per_step)
                       for k in SHARDED_KERNELS if not c.get(k)]
            if missing:
                raise AssertionError(f"{label} rank {r}: no launch of "
                                     f"{missing}")
            ms = rr["ms"][1:]
            print(f"  rank {r}: owned rows per object id "
                  f"{rr['owned_by_object']}; hand-kernel launches per step "
                  f"{per_step[-1]}; "
                  f"collectives per step {rr['collectives'][-1]}, bytes "
                  f"hopped per step {rr['hop_bytes'][-1]}; step "
                  f"{np.median(ms):.2f} ms (median of steps 2-5), single "
                  f"device {single_ms:.2f} ms ({smi})")
        if world == 2:
            straddle = [i for i in ids if all(
                rr["owned_by_object"][i] > 0 for rr in rec["ranks"])]
            if not straddle:
                raise AssertionError(f"{label}: no rigid spans both slabs")
            print(f"  rigids owned by both slabs: {straddle} (the summed "
                  f"rigid solve and the ghost moving volumes)")

    for spec_m, rec in zip(small, d2[1:]):
        m = spec_m["scene"]["Configuration"]["simulationMethod"]
        sp, spart, _ = build_scene(SimConfig(config_dict=spec_m["scene"]),
                                   device=device)
        solver = build_solver(sp, device=device)
        ss, sm = solver.step(solver.initialize(spart))
        real = ss.p.material >= 0
        ref = {f: getattr(ss.p, f)[real].cpu().numpy()
               for f in SHARDED_FIELDS}
        worst = entry.match_states(ref, rec["states"][1], dict.fromkeys(
            ("x", "v", "density"), ATOL), RTOL)
        its = {k: (int(sm[k]), int(rec["metrics"][0][k]))
               for k in ("pressure_iters", "divergence_iters") if k in sm}
        if any(a != b for a, b in its.values()):
            raise AssertionError(f"small scene method {m} D = 2: iterations "
                                 f"{its} (single, sharded)")
        print(f"small scene method {m} D = 2 against the single-device step "
              f"on the card: max |difference| {worst}; iterations (single, "
              f"sharded) {its}; launches per rank "
              f"{[rr['launches'][0] for rr in rec['ranks']]}")
    print(f"sharded phase in {time.perf_counter() - t_phase:.1f} s ({smi}); "
          f"NCCL across two cards not run: one card")


# ---------------------------------------------------------------------------
# phases 28-30: the bundled scenes the earlier phases do not run
# ---------------------------------------------------------------------------

# steps of each run: high_fluid_wcsph to t = 0.24 s (the collapse front
# at the far wall), high_fluid_dfsph to the same t, and
# armadillo_bath_dynamic_dfsph until the fluid reaches an armadillo, then
# 5 timed steps
HIGH_FLUID_WCSPH_STEPS = 600
HIGH_FLUID_DFSPH_STEPS = 60
ARMADILLO_TIMED_STEPS = 5

class StepRecord:
    """Each step's metrics as ``Simulation`` folds them, kept on the device
    (references: no kernel added) and read once by ``read``: the Jacobi
    iterations, the fullest cell, the fastest fluid particle (NaN once the
    state is not finite) and the fatal flags."""

    KEYS = ("divergence_iters", "pressure_iters", "max_cell_occupancy",
            "max_velocity")

    def __init__(self, sim):
        from sph_taichi_torch.utils.profiling import FATAL_KEYS

        self.sim, self.rows = sim, []
        keys = self.KEYS + FATAL_KEYS
        fold = sim._fold_solver_stats

        def folding(metrics):
            self.rows.append({k: metrics[k] for k in keys if k in metrics})
            fold(metrics)

        sim._fold_solver_stats = folding

    def read(self):
        """{key: float64 numpy array over the recorded steps}."""
        keys = self.rows[0].keys()
        return {k: torch.stack([r[k].reshape(()).double() for r in self.rows])
                .cpu().numpy() for k in keys}

    def close(self):
        del self.sim._fold_solver_stats     # the class's method again


def timed_run(sim, steps):
    """``steps`` steps of ``Simulation.run`` between two CUDA events, the
    launch counts set to 0 just before and read just after.  Returns (ms
    per step, the launches, the solver's stats)."""
    reset_all_launch_counts()
    sim.reset_solver_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(steps // sim.substeps, export=False)
    end.record()
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launch_counts().items() if v}
    return start.elapsed_time(end) / steps, launches, sim.read_solver_stats()


def expect_launches(launches, expect, label):
    """Raises unless the path launched exactly ``expect``."""
    got = {k: v for k, v in launches.items() if v}
    want = {k: v for k, v in expect.items() if v}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def dfsph_launches(steps, st, volumes=0):
    """The launches of ``steps`` DFSPH steps over the cell runs whose
    loops read their tests ``st`` times (iterations queued after a loop's
    exit launch and return at once: each solve launches K per host read);
    ``volumes``: kernel c's (one per dynamic-rigid step)."""
    from sph_taichi_torch.models.base import JACOBI_CHECK_EVERY as K

    r_div, r_prs = st["divergence_host_reads"], st["pressure_host_reads"]
    return {"dfsph_density_factor": steps, "nonpressure_kick": steps,
            "dfsph_divergence_change": steps + K * r_div,
            "dfsph_divergence_adv": steps + K * r_prs,
            "dfsph_solver_dv": K * (r_div + r_prs),
            "boundary_volume": volumes}


def scene_checks(sim, record, label):
    """The correctness line of the run: a finite state, the fluid inside
    the padded box, the sort invariant intact (``check_state``) and no
    fatal flag in any recorded step."""
    from sph_taichi_torch.utils.profiling import FATAL_KEYS

    check_state(sim)
    fired = {k: int(np.count_nonzero(v)) for k, v in record.items()
             if k in FATAL_KEYS and np.count_nonzero(v)}
    if fired:
        raise AssertionError(f"{label}: fatal flags in {fired} steps")
    print(f"  {label}: state finite, fluid inside the padded box, sort "
          f"invariant intact, no fatal flag in {len(record['max_velocity'])} "
          f"steps ({', '.join(k for k in FATAL_KEYS if k in record)})")


def list_overflow(sim, label):
    """At the state of ``sim``: the fullest cell, and the centres of the
    step's pair list (the WCSPH density kernel's: every real row; e1's:
    the fluid rows) with more accepted pairs than the list's entries, at
    the bottom (y under 0.25 m above the padded floor) and above it."""
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops import cuda_dfsph as cd
    from sph_taichi_torch.ops import cuda_pairs as cp
    from sph_taichi_torch.ops.pair_list import PAIR_LIST_ENTRIES

    params, solver = sim.params, sim.solver
    q, starts, _ = base.bin_and_sort(sim.state.p, params, solver.engine,
                                     solver.tables)
    if params.simulation_method == 4:
        plist = cd.density_factor_list(starts, q, params, {})[2]
        centres = q.material == 1
    else:
        plist = cp.density_sum_list(starts, q, params, {})[1]
        centres = q.material >= 0
    over = centres & (plist.cnt > PAIR_LIST_ENTRIES)
    bottom = over & (q.x[:, 1] < params.padding + 0.25)
    occ = int(base.max_cell_occupancy(starts))
    print(f"  {label}: fullest cell {occ} particles; {int(over.sum())} "
          f"centres over the pair list's {PAIR_LIST_ENTRIES} entries "
          f"({int(bottom.sum())} at the bottom, {int((over & ~bottom).sum())}"
          f" above it; their own walk takes them in one phase), at most "
          f"{int(plist.cnt[centres].max())} accepted pairs per centre")
    reset_all_launch_counts()     # these launches are not the path's
    return occ, int(over.sum())


def held_step(device, sim, label, fields, iterations=False):
    """One kernel step of ``sim`` against one plain-engine step from the
    same state, index-wise at the tolerance, the plain engine's caps
    raised to what the state needs (its neighbour lists drop past them;
    the kernels have none); DFSPH's iteration counts equal."""
    from sph_taichi_torch import build_solver
    from sph_taichi_torch.models import base
    from sph_taichi_torch.ops.pairs import GatherEngine

    params, state = sim.params, sim.state
    q, starts, _ = base.bin_and_sort(state.p, params, sim.solver.engine,
                                     sim.solver.tables)
    caps = dataclasses.replace(params, cell_cap=max(
        params.cell_cap, int(base.max_cell_occupancy(starts))))
    nl = GatherEngine(caps).prepare(q.x, starts)
    caps = dataclasses.replace(caps, neighbor_cap=max(caps.neighbor_cap,
                                                      int(nl.max_cnt)))
    del q, starts, nl
    print(f"  {label}: the plain engine's caps neighbor_cap "
          f"{caps.neighbor_cap}, cell_cap {caps.cell_cap} (the scene's "
          f"{params.neighbor_cap}, {params.cell_cap})")
    plain = build_solver(caps, device=device, engine=GatherEngine(caps))
    ks, km = sim.solver.step(state)
    ps, pm = plain.step(state)
    if int(pm["neighbor_overflow"]) or int(pm["cell_overflow"]):
        raise AssertionError(f"{label}: the plain step overflowed its caps")
    if iterations:
        its = {k: (int(km[k]), int(pm[k]))
               for k in ("divergence_iters", "pressure_iters")}
        print(f"  {label}: iterations (kernel, plain) {its}")
        if any(a != b for a, b in its.values()):
            raise AssertionError(f"{label}: iteration counts differ")
    real = ps.p.material != -1
    for name in fields:
        max_errors(getattr(ks.p, name)[real], getattr(ps.p, name)[real],
                   f"{label} step kernel vs plain engine: {name}")
    reset_all_launch_counts()
    del plain, ks, ps


def replayed_busy(sim, start, steps, step_ms, label):
    """Device busy per step of the ``steps`` steps that ``sim`` just ran
    from the state ``start`` in ``step_ms`` each: the same steps again from
    ``start`` under the profiler (bitwise the same: the same kernels and
    iterations, so the busy share is of the timed steps' own work)."""
    end = sim.state
    sim.state = start
    busy_ms = profile_steps(sim, steps)
    if not all(torch.equal(a, b) for a, b in zip(sim.state.p, end.p)
               if a is not None):
        raise AssertionError(f"{label}: the replayed steps differ")
    if busy_ms is not None:
        print(f"{label}: device busy {busy_ms:.4f} ms of the {step_ms:.4f} "
              f"ms step (the same {steps} steps, replayed bitwise): idle "
              f"share {100 * (1 - busy_ms / step_ms):.1f}%")
    reset_all_launch_counts()
    return busy_ms


def busy_window(sim, steps, label):
    """``steps`` more steps timed with CUDA events, then replayed under the
    profiler (``replayed_busy``)."""
    start = sim.state
    step_ms = timed_run(sim, steps)[0]
    return replayed_busy(sim, start, steps, step_ms,
                         f"{label}, steps {int(start.step_count) + 1}-"
                         f"{int(sim.state.step_count)}")


def scene_counts(params, label):
    print(f"{label}: n_fluid {params.n_fluid}, n_solid {params.n_solid}, "
          f"dynamic rigids {params.dynamic_rigid_ids}, n_pad {params.n_pad}, "
          f"grid {params.grid_num}, dt {params.dt0}")


def high_fluid_wcsph_path(device, smi, warmup=5):
    """Phase 28: data/scenes/high_fluid_wcsph.json (a 0.6 x 5.4 x 0.6 m
    column, 243,000 fluid particles, WCSPH at dt 4e-4) through
    ``Simulation`` to step HIGH_FLUID_WCSPH_STEPS, every step after the
    warm-up timed; launches per step (density_sum_list = wcsph_forces =
    steps), the correctness line, the fullest cell and the centres over
    the pair list; one kernel step against one plain-engine step from that
    state; the same 5 steps twice from it, bitwise equal; device busy over
    10 more steps (``busy_window``)."""
    label = "high_fluid_wcsph"
    t_phase = time.perf_counter()
    sim = simulation("data/scenes/high_fluid_wcsph.json")
    scene_counts(sim.params, label)
    sim.run(warmup, export=False)
    record = StepRecord(sim)
    steps = HIGH_FLUID_WCSPH_STEPS - warmup
    step_ms, launches, _ = timed_run(sim, steps)
    record.close()
    rec = record.read()
    print(f"{label}: {steps} steps after {warmup} (t "
          f"{float(sim.state.t):.4f} s), {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s ({smi}); launches per step "
          f"{ {k: v / steps for k, v in launches.items()} }; fullest cell "
          f"over the run {int(rec['max_cell_occupancy'].max())}, fastest "
          f"fluid particle {rec['max_velocity'].max():.3f} m/s")
    expect_launches(launches, {"density_sum_list": steps,
                               "wcsph_forces": steps}, label)
    scene_checks(sim, rec, label)
    xf = sim.state.p.x[sim.state.p.material == 1]
    print(f"  {label}: fluid x from {float(xf[:, 0].min()):.4f} to "
          f"{float(xf[:, 0].max()):.4f} m, top at {float(xf[:, 1].max()):.4f}"
          f" m")
    list_overflow(sim, f"{label} at step {int(sim.state.step_count)}")
    held_step(device, sim, label, ("x", "v", "density", "pressure", "acc"))

    # no atomics: the same steps from the same state, twice, bitwise
    outs = []
    for _ in range(2):
        state = sim.state
        for _ in range(5):
            state, _ = sim.solver.step(state)
        outs.append(state.p)
    same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1])
               if a is not None)
    print(f"  {label}: 5 steps from step {int(sim.state.step_count)}, run "
          f"twice: bitwise equal {same}")
    if not same:
        raise AssertionError(f"{label}: two runs of the same steps differ")
    busy_window(sim, 10, label)
    print(f"{label} phase in {time.perf_counter() - t_phase:.1f} s")


def high_fluid_dfsph_path(device, smi, warmup=3):
    """Phase 29: data/scenes/high_fluid_dfsph.json (the same column, DFSPH
    at dt 4e-3) through ``Simulation`` to step HIGH_FLUID_DFSPH_STEPS,
    timed after the warm-up: launches per step, iterations and host reads
    per step, each step's iterations and the steps at the loops' cap of
    its solver (100 each), the first step whose state is not finite; the
    correctness line, the fullest cell and the centres over the pair list;
    one kernel step against one plain-engine step from that state,
    iterations equal; device busy over 5 more steps (``busy_window``)."""
    label = "high_fluid_dfsph"
    t_phase = time.perf_counter()
    sim = simulation("data/scenes/high_fluid_dfsph.json")
    scene_counts(sim.params, label)
    record = StepRecord(sim)
    sim.run(warmup, export=False)
    steps = HIGH_FLUID_DFSPH_STEPS - warmup
    step_ms, launches, st = timed_run(sim, steps)
    record.close()
    rec = record.read()
    reads = st["divergence_host_reads"] + st["pressure_host_reads"]
    print(f"{label}: {steps} steps after {warmup} (t "
          f"{float(sim.state.t):.4f} s), {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s ({smi}); iterations per step "
          f"divergence mean {st['divergence_iters_sum'] / steps:.2f} max "
          f"{st['divergence_iters_max']}, pressure mean "
          f"{st['pressure_iters_sum'] / steps:.2f} max "
          f"{st['pressure_iters_max']}; host reads per step "
          f"{reads / steps:.2f}; launches per step "
          f"{ {k: v / steps for k, v in launches.items()} }")
    expect_launches(launches, dfsph_launches(steps, st), label)
    its = {k: rec[k].astype(int) for k in ("divergence_iters",
                                           "pressure_iters")}
    cap = {"divergence_iters": sim.solver.m_max_iterations_v,
           "pressure_iters": sim.solver.m_max_iterations}
    capped = {k: [i + 1 for i in np.flatnonzero(v >= cap[k])]
              for k, v in its.items()}
    lost = np.flatnonzero(~np.isfinite(rec["max_velocity"]))
    print(f"  {label}: iterations of steps 1-{len(rec['max_velocity'])}: "
          + "; ".join(f"{k} {v.tolist()}" for k, v in its.items()))
    print(f"  {label}: steps at the loops' caps {cap}: {capped}; "
          f"first step with a non-finite state: "
          f"{int(lost[0]) + 1 if lost.size else None}; fastest fluid "
          f"particle per step (m/s) "
          f"{np.round(rec['max_velocity'], 2).tolist()}")
    scene_checks(sim, rec, label)
    list_overflow(sim, f"{label} at step {int(sim.state.step_count)}")
    held_step(device, sim, label, ("x", "v", "density", "density_adv",
                                   "acc"), iterations=True)
    busy_window(sim, 5, label)
    print(f"{label} phase in {time.perf_counter() - t_phase:.1f} s")
    return capped, lost


def armadillo_dfsph_path(device, smi, kernels, max_lead=60):
    """Phase 30: data/scenes/armadillo_bath_dynamic_dfsph.json (1,723,968
    fluid particles, three dynamic armadillos of 1,783 solids at densities
    7874, 1700 and 300, DFSPH at dt 4e-3) through ``Simulation`` until the
    fluid reaches an armadillo (``dragon_contact``), then
    ARMADILLO_TIMED_STEPS timed steps: launches per step (kernel c and e1 =
    d = steps, the reaction variant of e5), iterations, host reads, device
    busy (the timed steps replayed, ``replayed_busy``), the correctness
    line, each armadillo's rms radius drift and centre of mass; at the
    contact e1 (with its list), d, e3/e4 and e5 with and without the
    reaction against their plain versions over the whole 1,729,317 rows,
    kernel c against its plain versions over both walks and against the
    dense path (VOLUME_RTOL), its time, and one kernel step against one
    plain-engine step (``contact_volumes``).
    Folds the kernels' largest differences into ``kernels``."""
    label = "armadillo_bath_dynamic_dfsph"
    t_phase = time.perf_counter()
    sim = simulation("data/scenes/armadillo_bath_dynamic_dfsph.json")
    params = sim.params
    scene_counts(params, label)
    ids = params.dynamic_rigid_ids

    def rigid_geometry():
        p = sim.state.p
        out = {}
        for i in ids:
            xs = p.x[p.object_id == i].double()
            c = xs.mean(0)
            out[i] = (float(((xs - c) ** 2).sum(1).mean().sqrt()),
                      c.tolist(), float(p.v[p.object_id == i][:, 1].mean()))
        return out

    geo0 = rigid_geometry()
    record = StepRecord(sim)
    t0 = time.perf_counter()
    while dragon_contact(sim) == 0.0:
        if int(sim.state.step_count) >= max_lead:
            raise AssertionError(f"{label}: no fluid at an armadillo after "
                                 f"{max_lead} steps")
        sim.run(2 // sim.substeps, export=False)
    lead = int(sim.state.step_count)
    print(f"{label}: the fluid reaches an armadillo by step {lead} (t "
          f"{float(sim.state.t):.4f} s; {time.perf_counter() - t0:.1f} s)")
    steps = ARMADILLO_TIMED_STEPS
    start = sim.state
    step_ms, launches, st = timed_run(sim, steps)
    record.close()
    rec = record.read()
    reads = st["divergence_host_reads"] + st["pressure_host_reads"]
    print(f"{label}: {steps} steps after {lead}, {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s ({smi}); iterations per step "
          f"divergence mean {st['divergence_iters_sum'] / steps:.2f} max "
          f"{st['divergence_iters_max']}, pressure mean "
          f"{st['pressure_iters_sum'] / steps:.2f} max "
          f"{st['pressure_iters_max']}; host reads per step "
          f"{reads / steps:.2f}; launches per step "
          f"{ {k: v / steps for k, v in launches.items()} }; iterations of "
          f"steps 1-{len(rec['max_velocity'])}: "
          + "; ".join(f"{k} {rec[k].astype(int).tolist()}"
                      for k in ("divergence_iters", "pressure_iters")))
    expect_launches(launches, dfsph_launches(steps, st, volumes=steps),
                    label)
    replayed_busy(sim, start, steps, step_ms, label)
    scene_checks(sim, rec, label)
    geo = rigid_geometry()
    drift = {i: abs(geo[i][0] - geo0[i][0]) / geo0[i][0] for i in ids}
    print(f"  {label}: rigid rms radius drift (relative) after "
          f"{int(sim.state.step_count)} steps "
          + ", ".join(f"{i}: {d:.2e}" for i, d in drift.items())
          + "; centres of mass (m) and mean vertical velocity (m/s) "
          + ", ".join(f"{i} (density {params.obj_density0[i]:g}): "
                      f"{np.round(geo0[i][1], 4).tolist()} -> "
                      f"{np.round(geo[i][1], 4).tolist()}, "
                      f"{geo[i][2]:.4f}" for i in ids))
    if max(drift.values()) >= 1e-3:
        raise AssertionError(f"{label}: rigid shape not kept {drift}")
    list_overflow(sim, f"{label} at step {int(sim.state.step_count)}")

    # the kernels at the contact over the whole rows, against their plain
    # versions (the plain engine's caps raised to the state's)
    q, starts, nl, _, _, _ = dragon_state_kernels(params, sim.solver,
                                                  sim.state)
    reset_all_launch_counts()
    worst = {}
    compare_dfsph_kernels(params, sim.solver, q, nl, starts,
                          f"{label} at contact", worst)
    print(f"  {label} at contact, {int((q.material >= 0).sum())} rows: e1 "
          f"(with its list), d, e3/e4 and e5 with and without the reaction "
          f"against their plain versions, max abs err {json.dumps(worst)}")
    for k in kernels:
        if k["name"] in worst:
            k["max_abs_err"] = max(k["max_abs_err"], worst[k["name"]])
    c_ms, rel = contact_volumes(device, sim, q, starts, nl, label=label,
                                dense_step=False)
    print(f"  {label}: kernel c at {params.n_solid} solids {c_ms:.4f} ms "
          f"(profiler; {smi}), m_V {rel:.3e} from the dense path's (limit "
          f"{VOLUME_RTOL:g})")
    reset_all_launch_counts()
    del q, starts, nl
    print(f"{label} phase in {time.perf_counter() - t_phase:.1f} s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    from sph_taichi_torch.ops import _build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = t0 = time.perf_counter()
    sources = _build.SOURCES
    controls = start_control_builds()
    _build.build(sources)
    print(f"kernels built from sph_taichi_torch/csrc in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in sources:
        print(_build.build_log(name).strip())
    finish_control_builds(controls)
    restore = count_dense_calls()

    worst = check_kernels_on_small_scenes(device)
    worst.update(check_dfsph_on_small_scenes(device))
    worst.update(check_iisph_on_small_scenes(device))
    worst.update(check_pcisph_on_small_scenes(device))
    worst.update(check_volume_and_slot_kernels_on_small_scenes(device))
    worst.update(check_slot_solver_kernels_on_small_scenes(device))
    worst.update(check_compact_walk_on_edge_scene(device))
    worst.update(check_pcisph_on_edge_scene(device))
    worst.update(check_iisph_on_edge_scene(device))
    worst.update(check_wcsph_on_edge_scene(device))
    worst.update(check_dfsph_on_edge_scene(device))
    worst.update(check_dfsph_slot_list_on_edge_scenes(device))
    worst.update(check_pcisph_slot_list_on_edge_scenes(device))
    worst.update(check_slot_list_readers_on_edge_scenes(device))
    print(f"small-scene kernel vs plain max abs err: {json.dumps(worst)}")

    kernels, cell_step_ms = main_path(device, "data/scenes/dragon_bath.json",
                                      warmup=5, steps=50)
    torch.cuda.empty_cache()
    dfsph_kernels, _ = dfsph_path(device, "data/scenes/dragon_bath_dfsph.json",
                                  warmup=3, steps=20)
    kernels += dfsph_kernels
    torch.cuda.empty_cache()
    reaction_at_scale(device, "data/scenes/dragon_bath_dynamic_dfsph.json",
                      steps=5)
    torch.cuda.empty_cache()
    iisph_kernels, _ = iisph_path(device, warmup=5, steps=20)
    kernels += iisph_kernels
    torch.cuda.empty_cache()
    iisph_iterating(device, dt=2e-3, steps=5)
    torch.cuda.empty_cache()
    pcisph_kernels, _ = pcisph_path(device, warmup=5, steps=20)
    kernels += pcisph_kernels
    torch.cuda.empty_cache()
    armadillo_counts(device)
    torch.cuda.empty_cache()
    volume_kernels, _ = volume_path(device, warmup=5, steps=20)
    kernels += volume_kernels
    torch.cuda.empty_cache()
    kernels += slot_path(device, "data/scenes/dragon_bath.json", warmup=5,
                         steps=50, cell_step_ms=cell_step_ms)
    torch.cuda.empty_cache()
    volume_kernels, react_forces_err = slot_volume_path(device, warmup=2,
                                                        steps=10)
    kernels += volume_kernels
    from sph_taichi_torch import SimConfig
    for method, config, label, warmup in (
            (4, SimConfig("data/scenes/dragon_bath_dfsph.json"),
             "dragon_bath_dfsph", 3),
            (2, dragon_config(2), "dragon_bath IISPH", 5),
            (1, dragon_config(1), "dragon_bath PCISPH", 5)):
        torch.cuda.empty_cache()
        sim, launches, _ = slot_solver_path(device, config, label, warmup,
                                            steps=20)
        kernels += slot_solver_kernels(sim, method, launches, label)[0]
        del sim
    torch.cuda.empty_cache()
    react_err = slot_scaled_dragon_path(device, warmup=5, steps=20)
    for k in kernels:
        if k["name"] == "dfsph_solver_dv[slots]":
            k["max_abs_err"] = max(k["max_abs_err"], react_err)
        if k["name"] == "wcsph_forces[slots]":
            k["max_abs_err"] = max(k["max_abs_err"], react_forces_err)
    restore()
    print(f"the dense boundary-volume path: {DENSE_CALLS['dense']} calls, "
          f"all by the plain engines' comparisons; {DENSE_CALLS['fused']} by "
          f"a CUDA engine")
    if DENSE_CALLS["fused"]:
        raise AssertionError("a CUDA engine took the dense boundary-volume "
                             "path")
    t0 = time.perf_counter()
    legacy2d_path(device, smi)
    print(f"legacy2d phase in {time.perf_counter() - t0:.1f} s ({smi})")
    torch.cuda.empty_cache()
    sharded_path(device, smi)
    for phase in (high_fluid_wcsph_path, high_fluid_dfsph_path):
        torch.cuda.empty_cache()
        phase(device, smi)
    torch.cuda.empty_cache()
    armadillo_dfsph_path(device, smi, kernels)
    print(f"chip_smoke phases done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
