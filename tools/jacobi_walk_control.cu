// The DFSPH Jacobi kernels of sph_taichi_torch/csrc/dfsph.cu with their
// walk replaced by a one-phase control, for tools/jacobi_walk_control.py
// and chip_smoke.py's slot DFSPH and PCISPH phases: the kernels' source is
// included as it is, with for_each_jacobi_pair renamed to
// control_jacobi_pair, which reads no pair list, and the list walk of
// for_each_step_pair (PAIR_LIST_WALK, pair_common.cuh) defined to
// slot_one_phase_pair (tools/walk_control.cuh): over the slot walk the
// non-pressure kernel walks the map in one phase and reads no list, over
// the cell runs it reads the list as shipped.
// - WALK_BATCHED: the one-phase walk over the cell runs, each lane loading
//   kCompactUnroll candidates' positions before testing them, the pair
//   body run where its test accepts (no list, no warp votes);
// - otherwise the one-phase walk of for_each_neighbor_walk.
// Over the slot walk both take for_each_neighbor_walk: the slot kernels'
// walk before they read the step's pair list.  Both add each centre's
// pairs in the shipped walks' order, so every result equals the shipped
// kernels' bitwise.
// Build: nvcc <the flags of ops/_build.py> -I sph_taichi_torch/csrc
//        [-DWALK_BATCHED] tools/jacobi_walk_control.cu

#define PAIR_LIST_WALK slot_one_phase_pair
#include "pair_common.cuh"
#include "walk_control.cuh"

template <typename Walk, typename F>
__device__ __forceinline__ void control_walk(
    bool walks, int i, float xi0, float xi1, float xi2,
    const float* __restrict__ x, const Walk& walk, const PairConsts& c,
    F&& f) {
  if (!walks) return;
#ifdef WALK_BATCHED
  if constexpr (kCompactWalk<Walk>) {
    const int ix = cell_x(xi0, c);
    const int iy = cell_coord(xi1, c);
    const int iz = cell_coord(xi2, c);
    const int zlo = max(iz - 1, 0);
    const int zhi = min(iz + 1, c.nz - 1);
    if (zlo > zhi) return;
    for (int k = 0; k < 9; ++k) {
      const int cx = ix + k / 3 - 1, cy = iy + k % 3 - 1;
      if (cx < 0 || cx >= c.nx || cy < 0 || cy >= c.ny) continue;
      const int base = (cx * c.ny + cy) * c.nz;
      const int b = walk.starts[base + zlo];
      const int len = walk.starts[base + zhi + 1] - b;
      for (int t = 0; t < len; t += kCompactUnroll) {
        float p[kCompactUnroll][3];
#pragma unroll
        for (int u = 0; u < kCompactUnroll; ++u) {
          const int j = b + t + u;
          if (t + u < len) {
            p[u][0] = x[3 * j];
            p[u][1] = x[3 * j + 1];
            p[u][2] = x[3 * j + 2];
          }
        }
#pragma unroll
        for (int u = 0; u < kCompactUnroll; ++u) {
          const int j = b + t + u;
          if (t + u >= len || j == i) continue;
          const float d0 = xi0 - p[u][0];
          const float d1 = xi1 - p[u][1];
          const float d2 = xi2 - p[u][2];
          const float s = d0 * d0 + d1 * d1 + d2 * d2;
          if (s < c.h2) f(j, d0, d1, d2, s);
        }
      }
    }
    return;
  }
#endif
  for_each_neighbor_walk(i, xi0, xi1, xi2, x, walk, c, f);
}

// for_each_jacobi_pair's signature; the step's list is not read
template <typename Walk, typename F>
__device__ __forceinline__ void control_jacobi_pair(
    bool walks, int i, float xi0, float xi1, float xi2,
    const float* __restrict__ x, const Walk& walk, const PairList&,
    const PairConsts& c, F&& f) {
  control_walk(walks, i, xi0, xi1, xi2, x, walk, c, f);
}

#define for_each_jacobi_pair control_jacobi_pair
#include "dfsph.cu"
