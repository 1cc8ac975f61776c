// The IISPH kernels of sph_taichi_torch/csrc/iisph.cu with the slot walk's
// list walk replaced by a one-phase control, for chip_smoke.py's slot IISPH
// phase: the kernels' source is included as it is, with the list walk of
// for_each_step_pair (PAIR_LIST_WALK, pair_common.cuh) defined to
// slot_one_phase_pair (tools/walk_control.cuh).  Over the slot walk all
// four kernels (f1, f2, f3 in both variants, f4) walk the map in one phase
// and read no list, as before they read the step's list; every kernel over
// the cell runs is the shipped one.  Every result equals the shipped
// kernels' bitwise.
// Build: nvcc <the flags of ops/_build.py> -I sph_taichi_torch/csrc
//        tools/iisph_walk_control.cu

#define PAIR_LIST_WALK slot_one_phase_pair
#include "pair_common.cuh"
#include "walk_control.cuh"

#include "iisph.cu"
