// The PCISPH loop kernels of sph_taichi_torch/csrc/pcisph.cu with the
// list walk replaced by a control, for
// tools/pcisph_walk_control.py: the kernels' source is included as it is,
// with the list walk of for_each_step_pair (PAIR_LIST_WALK,
// pair_common.cuh) defined to control_listed_pair, which the kernels'
// calls find by argument-dependent lookup when they are instantiated.
// - NO_LIST: the list is not read; every warp walks the cells in two phases
//   (the candidate phase of compact_cell_runs, the pair geometry at xg in
//   the body phase): the loop without the step-start list;
// - ONE_PHASE: the list is not read; every warp walks the cells in one
//   phase (for_each_neighbor_pinned): the kernels before the list;
// - LIST_UNROLL=n: the list walk loading n list entries before their
//   pairs' bodies (the shipped walk loads kListUnroll);
// - OVERFLOW_TWO_PHASE: a warp over the list walks the cells in two
//   phases, not in one.
// The slot instantiations reach the same hook: under NO_LIST and ONE_PHASE
// every warp walks the slot map in one phase, pinned (the slot kernels
// before they read the step's list; the slot walk has no two-phase form),
// and a warp over the list walks it in one phase under every control.  The
// one-phase walk is tools/walk_control.cuh's one_phase_step_pairs, which
// the IISPH and DFSPH controls share.  Every control adds each centre's
// pairs in the shipped walk's order, so every result equals the shipped
// kernels' bitwise.
// Build: nvcc <the flags of ops/_build.py> -I sph_taichi_torch/csrc
//        [-DNO_LIST | -DONE_PHASE] [-DLIST_UNROLL=n] [-DOVERFLOW_TWO_PHASE]
//        tools/pcisph_walk_control.cu

#define PAIR_LIST_WALK control_listed_pair
#include "pair_common.cuh"
#include "walk_control.cuh"

#ifndef LIST_UNROLL
#define LIST_UNROLL kListUnroll
#endif

// compact_cell_runs with the inclusion test at x and the pair geometry at
// xg from (gi0, gi1, gi2): the pairs of for_each_neighbor_pinned.
template <typename F>
__device__ __forceinline__ void pinned_compact_cell_runs(
    bool walks, int i, const float* __restrict__ x, float gi0, float gi1,
    float gi2, const float* __restrict__ xg, const CellRunWalk& walk,
    const PairConsts& c, F&& f) {
  __shared__ int lists[kListEntries * kBlock];
  float xi0 = 0.0f, xi1 = 0.0f, xi2 = 0.0f;
  if (walks) xi0 = x[3 * i], xi1 = x[3 * i + 1], xi2 = x[3 * i + 2];
  int* list = lists + threadIdx.x;
  int cnt = 0;
  auto flush = [&]() {
    for (int k = 0; k < cnt; ++k) {
      const int j = list[k * kBlock];
      const float d0 = gi0 - xg[3 * j];
      const float d1 = gi1 - xg[3 * j + 1];
      const float d2 = gi2 - xg[3 * j + 2];
      f(j, d0, d1, d2, d0 * d0 + d1 * d1 + d2 * d2);
    }
    cnt = 0;
  };
  cell_run_candidates(
      walks, i, xi0, xi1, xi2, x, walk, c,
      [&]() {
        if (__any_sync(0xffffffffu, cnt > kListEntries - kCompactUnroll)) {
          flush();
        }
      },
      [&](int j, float, float, float, float) {
        list[(cnt++) * kBlock] = j;
      });
  flush();
}

// pinned_compact_cell_runs over the cell runs; the one-phase pinned walk
// over the slot walk
template <typename Walk, typename F>
__device__ __forceinline__ void control_two_phase(
    bool walks, int i, const float* __restrict__ x, float gi0, float gi1,
    float gi2, const float* __restrict__ xg, const Walk& walk,
    const PairConsts& c, F&& f) {
  if constexpr (kCompactWalk<Walk>) {
    pinned_compact_cell_runs(walks, i, x, gi0, gi1, gi2, xg, walk, c, f);
  } else {
    one_phase_step_pairs(walks, i, x, xg, walk, c, f);
  }
}

template <typename Walk, typename F>
__device__ __forceinline__ void control_listed_pair(
    bool walks, int i, const float* __restrict__ x, float gi0, float gi1,
    float gi2, const float* __restrict__ xg, const PairList& pl,
    const Walk& walk, const PairConsts& c, F&& f) {
#if defined(NO_LIST)
  control_two_phase(walks, i, x, gi0, gi1, gi2, xg, walk, c, f);
#elif defined(ONE_PHASE)
  one_phase_step_pairs(walks, i, x, xg, walk, c, f);
#else
  const int n = walks ? pl.cnt[i] : 0;
  if (__any_sync(0xffffffffu, n > kPairListEntries)) {
#ifdef OVERFLOW_TWO_PHASE
    control_two_phase(walks, i, x, gi0, gi1, gi2, xg, walk, c, f);
#else
    one_phase_step_pairs(walks, i, x, xg, walk, c, f);
#endif
    return;
  }
  for (int k = 0; k < n; k += LIST_UNROLL) {
    int j[LIST_UNROLL];
#pragma unroll
    for (int u = 0; u < LIST_UNROLL; ++u) {
      j[u] = (k + u < n) ? pl.idx[(k + u) * pl.stride + i] : i;
    }
#pragma unroll
    for (int u = 0; u < LIST_UNROLL; ++u) {
      if (k + u >= n) break;
      const float d0 = gi0 - xg[3 * j[u]];
      const float d1 = gi1 - xg[3 * j[u] + 1];
      const float d2 = gi2 - xg[3 * j[u] + 2];
      f(j[u], d0, d1, d2, d0 * d0 + d1 * d1 + d2 * d2);
    }
  }
#endif
}

#include "pcisph.cu"
