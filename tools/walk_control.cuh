#pragma once

// The one-phase walk of the list-walk controls (tools/*_walk_control.cu):
// the pairs that a kernel reads from the step's list
// (sph_taichi_torch/csrc/pair_common.cuh for_each_step_pair), found by
// walking the cells or the slot map in one phase, the list not read.  A
// control defines PAIR_LIST_WALK to its list walk before it includes
// pair_common.cuh, then includes this header and the kernels' source; the
// kernels' calls find the walk by argument-dependent lookup when they are
// instantiated.  Every walk here adds a centre's pairs in the list walk's
// order, so every result equals the shipped kernels' bitwise.

// The one-phase walk of centre i (if ``walks``) over the pairs of the
// positions x with the geometry at xg, as the list kernels walked before
// they read the list: for_each_neighbor_walk itself where xg is x (WCSPH's
// forces, IISPH's four kernels and the non-pressure kernel pass x twice,
// so the test folds away when they are compiled), for_each_neighbor_pinned
// otherwise (PCISPH's loop).
template <typename Walk, typename F>
__device__ __forceinline__ void one_phase_step_pairs(
    bool walks, int i, const float* __restrict__ x,
    const float* __restrict__ xg, const Walk& walk, const PairConsts& c,
    F&& f) {
  if (!walks) return;
  if (xg == x) {
    for_each_neighbor_walk(i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk,
                           c, f);
  } else {
    for_each_neighbor_pinned(i, x, xg, walk, c, f);
  }
}

// A PAIR_LIST_WALK: the shipped list walk over the cell runs, the one-phase
// walk over the slot map, the list not read (the slot kernels before they
// read the step's list).
template <typename Walk, typename F>
__device__ __forceinline__ void slot_one_phase_pair(
    bool walks, int i, const float* __restrict__ x, float gi0, float gi1,
    float gi2, const float* __restrict__ xg, const PairList& pl,
    const Walk& walk, const PairConsts& c, F&& f) {
  if constexpr (kCompactWalk<Walk>) {
    for_each_listed_pair(walks, i, x, gi0, gi1, gi2, xg, pl, walk, c, f);
  } else {
    one_phase_step_pairs(walks, i, x, xg, walk, c, f);
  }
}
