// The WCSPH kernels of sph_taichi_torch/csrc/pairs.cu with the force
// kernel's list walk replaced by a control, for
// tools/wcsph_walk_control.py and chip_smoke.py's slot WCSPH phases: the
// kernels' source is included as it is, with the list walk of
// for_each_step_pair (PAIR_LIST_WALK, pair_common.cuh) defined to
// control_listed_pair, which the kernels' calls find by argument-dependent
// lookup when they are instantiated, over either walk.
// - ONE_PHASE: the list is not read; every warp walks the cells or the
//   slot map in one phase (one_phase_step_pairs, tools/walk_control.cuh):
//   the force kernel before it read the list;
// - TWO_PHASE: over the cell runs the list is not read; every warp walks
//   the cells in two phases (compact_cell_runs: the candidate phase into a
//   list in shared memory, then the body): the force kernel without a
//   list.  The slot walk has no two-phase form and takes the shipped list
//   walk;
// - neither: the shipped list walk.
// Besides, control_density_pass_launch launches density_list_pass_kernel:
// density_sum_list with the density term in a pass over the centre's
// freshly written list (a centre over the list walks the cells in one
// phase for its sum) instead of inside the candidate phase; and
// control_build_launch launches list_build_kernel, a separate build of
// every real centre's list (the candidate phase alone).
// Every control adds each centre's pairs in the shipped walk's order, so
// every result equals the shipped kernels' bitwise.
// Build: nvcc <the flags of ops/_build.py> -I sph_taichi_torch/csrc
//        [-DONE_PHASE | -DTWO_PHASE] tools/wcsph_walk_control.cu

#define PAIR_LIST_WALK control_listed_pair
#include "pair_common.cuh"
#include "walk_control.cuh"

template <typename Walk, typename F>
__device__ __forceinline__ void control_listed_pair(
    bool walks, int i, const float* __restrict__ x, float gi0, float gi1,
    float gi2, const float* __restrict__ xg, const PairList& pl,
    const Walk& walk, const PairConsts& c, F&& f) {
#if defined(ONE_PHASE)
  one_phase_step_pairs(walks, i, x, xg, walk, c, f);
#elif defined(TWO_PHASE)
  if constexpr (kCompactWalk<Walk>) {
    compact_cell_runs(walks, i, gi0, gi1, gi2, x, walk, c, f);
  } else {
    for_each_listed_pair(walks, i, x, gi0, gi1, gi2, xg, pl, walk, c, f);
  }
#else
  for_each_listed_pair(walks, i, x, gi0, gi1, gi2, xg, pl, walk, c, f);
#endif
}

#include "pairs.cu"

// density_sum_list in two passes per centre: the candidate phase writes the
// list, then the centre's sum runs over its list as written (re-reading
// the entries and the neighbours' positions), or, for a centre with more
// accepted pairs than the list holds, over the one-phase walk.
__global__ void density_list_pass_kernel(const float* __restrict__ x,
                                         const int* __restrict__ material,
                                         const float* __restrict__ m_V,
                                         CellRunWalk walk,
                                         int* __restrict__ idx,
                                         int* __restrict__ cnt,
                                         float* __restrict__ out, int n_rows,
                                         PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool walks = i < c.n_real;
  build_pair_list(walks, i, x, walk, c, idx, cnt, n_rows,
                  [](int, float, float, float, float) {});
  float sum = 0.0f;
  auto term = [&](int j, float s) {
    if (material[j] >= 0) sum += m_V[j] * cubic_w(sqrtf(s), c);
  };
  if (walks) {
    const float xi0 = x[3 * i], xi1 = x[3 * i + 1], xi2 = x[3 * i + 2];
    const int n = cnt[i];
    if (n > kPairListEntries) {
      for_each_neighbor_walk(
          i, xi0, xi1, xi2, x, walk, c,
          [&](int j, float, float, float, float s) { term(j, s); });
    } else {
      for (int k = 0; k < n; ++k) {
        const int j = idx[k * n_rows + i];
        const float d0 = xi0 - x[3 * j];
        const float d1 = xi1 - x[3 * j + 1];
        const float d2 = xi2 - x[3 * j + 2];
        term(j, d0 * d0 + d1 * d1 + d2 * d2);
      }
    }
  }
  if (i < n_rows) out[i] = sum;
}

// density_sum_list_launch's signature; the cell runs only (slot_map and
// layers are not read)
extern "C" int control_density_pass_launch(const float* x,
                                           const int* material,
                                           const float* m_V,
                                           const int* starts, const int*,
                                           int, int* idx, int* cnt,
                                           float* out, int n_rows,
                                           PairConsts c, void* stream) {
  if (n_rows > 0) {
    density_list_pass_kernel<<<rows_grid(n_rows), kBlock, 0,
                               (cudaStream_t)stream>>>(
        x, material, m_V, CellRunWalk{starts}, idx, cnt, out, n_rows, c);
  }
  return (int)cudaGetLastError();
}

// The list of every real centre, written by the candidate phase alone
// (build_pair_list with no term; cnt 0 on padding rows).
__global__ void list_build_kernel(const float* __restrict__ x,
                                  CellRunWalk walk, int* __restrict__ idx,
                                  int* __restrict__ cnt, int n_rows,
                                  PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  build_pair_list(i < c.n_real, i, x, walk, c, idx, cnt, n_rows,
                  [](int, float, float, float, float) {});
}

extern "C" int control_build_launch(const float* x, const int* starts,
                                    int* idx, int* cnt, int n_rows,
                                    PairConsts c, void* stream) {
  if (n_rows > 0) {
    list_build_kernel<<<rows_grid(n_rows), kBlock, 0,
                        (cudaStream_t)stream>>>(x, CellRunWalk{starts}, idx,
                                                cnt, n_rows, c);
  }
  return (int)cudaGetLastError();
}
