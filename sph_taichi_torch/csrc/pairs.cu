// Pair traversals of the WCSPH step and the Akinci boundary volumes on
// Hopper (sm_90a), one thread per centre in cell-sorted order.
//
// Replaces: the Pallas TPU kernel BlockEngine._kernel
// (sph_taichi_tpu/ops/pallas_blocks.py, launched by BlockEngine.traverse) in
// three specializations:
//   density_sum      <- the density term of models/base.py compute_densities
//                       (one phase; no solver step launches it: the one-
//                       phase reference that chip_smoke and the control
//                       tools time)
//   density_sum_list <- the same term on the WCSPH, IISPH and PCISPH steps,
//                       writing the step's pair list as it sums (below):
//                       density_sum_list_kernel over the cell runs,
//                       density_sum_slot_kernel over the slot walk
//   wcsph_forces     <- the fused WCSPH force term of models/wcsph.py
//                       compute_forces with its advect + fluid-box-clamp
//                       epilogue (two-way reaction variant as REACT = true).
//   boundary_volume  <- the boundary-volume term of models/base.py
//                       _boundary_volume_engine (every scene with solids
//                       on the CUDA engines): a warp per target row over
//                       the cell runs, a thread per target row over the
//                       slot map (below)
// and the retired SlotEngine._kernel
// (sph_taichi_tpu/ops/retired/pallas_slots.py) in the same three: each
// kernel is a template over its candidate walk, CellRunWalk (the cell
// offsets) or SlotWalk (the slot map of ops/slots.py); the body is shared.
//
// The contract, the rounding rules and both walks are in pair_common.cuh,
// shared with dfsph.cu, iisph.cu and pcisph.cu.
//
// What bounds it on an H100: irregular loads.  Each centre reads the
// positions of every candidate in its 27 cells (about 3x more candidates
// than neighbours within h), and a warp's 32 centres lie in a few adjacent
// cells, so their candidate ranges overlap and mostly hit L1/L2; the
// floating-point work per real pair is ~60 operations, far below the
// card's 67 TFLOP/s f32.  Everything stays in registers and the candidate
// loads rely on the caches.  The slot walk reads the map (4 bytes per
// slot) instead of two offsets per column and stops at a cell's first
// empty slot: the same candidates, one more dependent load per candidate.
// boundary_volume launches only over the target rows (the solids), so its
// work is the solids' neighbourhoods (its note, below).
//
// The WCSPH step over the cell runs: the positions do not move from the
// sort to wcsph_forces' advect epilogue, and the force kernel's centres
// (the fluid and, with the reaction, the dynamic rigids) are a subset of
// the density kernel's (every real row), so both accept the same pairs.
// The same holds on the IISPH and PCISPH steps, whose pair kernels read
// the list too (iisph.cu, pcisph.cu, dfsph.cu's un-kicked non-pressure
// kernel).
// density_sum_list runs the candidate phase of the two-phase walk
// (pair_common.cuh build_pair_list: the warp steps through each column's
// runs together, 8 candidate loads in flight per lane), adds each
// accepted pair's density term in the walk's order (the sum of
// density_sum, bitwise) and writes every real centre's accepted j to the
// step's pair list; wcsph_forces then runs only the pair body over the list
// (for_each_step_pair), so the one-phase candidate walk, where most lanes
// of a warp sit masked off in the ~60-operation body, runs once per step,
// not twice.  A warp holding a centre with more accepted pairs than the
// list holds walks the cells in one phase (the same pairs in the same
// order).  Both kernels have a thread for every row, padding rows
// included, and write the padding rows themselves.
//
// Over the slot walk density_sum_slot_kernel keeps density_sum's one-phase
// walk and sum and writes every real centre's accepted j to the step's
// list as it walks (the slot walk has no two-phase form: its dependent
// map loads lose the L1 that the candidate lists' shared memory takes,
// pair_common.cuh).  wcsph_forces (both variants), PCISPH's loop kernels
// (pcisph.cu), IISPH's four kernels (iisph.cu) and the un-kicked
// non-pressure kernel (dfsph.cu) read that list (for_each_step_pair); a
// warp holding a centre over the list walks the slot map in one phase,
// pinned with xg = x, which gives the pairs, d and raw sum of squares of
// the one-phase walk.

#include "pair_common.cuh"

template <typename Walk>
__global__ void density_sum_kernel(const float* __restrict__ x,
                                   const int* __restrict__ material,
                                   const float* __restrict__ m_V, Walk walk,
                                   float* __restrict__ out, PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.n_real) return;
  float sum = 0.0f;
  for_each_neighbor_walk(i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk, c,
                         [&](int j, float, float, float, float s) {
                           if (material[j] >= 0) {
                             const float rn = sqrtf(s);
                             sum += m_V[j] * cubic_w(rn, c);
                           }
                         });
  out[i] = sum;
}

// density_sum over the cell runs for the WCSPH step: the same sum, and
// every real centre's accepted pairs written to the step's list (idx, cnt;
// cnt 0 and the density 0 on padding rows).  One thread per row.
__global__ void density_sum_list_kernel(const float* __restrict__ x,
                                        const int* __restrict__ material,
                                        const float* __restrict__ m_V,
                                        CellRunWalk walk,
                                        int* __restrict__ idx,
                                        int* __restrict__ cnt,
                                        float* __restrict__ out, int n_rows,
                                        PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float sum = 0.0f;
  build_pair_list(i < c.n_real, i, x, walk, c, idx, cnt, n_rows,
                  [&](int j, float, float, float, float s) {
                    if (material[j] >= 0) {
                      const float rn = sqrtf(s);
                      sum += m_V[j] * cubic_w(rn, c);
                    }
                  });
  if (i < n_rows) out[i] = sum;
}

// density_sum over the slot walk for the WCSPH, IISPH and PCISPH steps:
// the one-phase walk and sum of density_sum_kernel, and every real
// centre's accepted pairs written to the step's list as it walks (idx,
// cnt), as build_pair_list writes them over the cell runs.  One thread per
// row: cnt 0 and the density 0 on padding rows.
__global__ void density_sum_slot_kernel(const float* __restrict__ x,
                                        const int* __restrict__ material,
                                        const float* __restrict__ m_V,
                                        SlotWalk walk, int* __restrict__ idx,
                                        int* __restrict__ cnt,
                                        float* __restrict__ out, int n_rows,
                                        PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  float sum = 0.0f;
  int n = 0;
  if (i < c.n_real) {
    for_each_neighbor_walk(
        i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk, c,
        [&](int j, float, float, float, float s) {
          if (n < kPairListEntries) idx[n * n_rows + i] = j;
          ++n;
          if (material[j] >= 0) {
            const float rn = sqrtf(s);
            sum += m_V[j] * cubic_w(rn, c);
          }
        });
  }
  cnt[i] = n;
  out[i] = sum;
}

// One thread per row, padding rows included (x and v carried through, acc
// 0).  Over both walks the pairs come from the step's list ``pl``
// (density_sum_list over the cell runs, density_sum_slot over the slot
// walk), which holds every real centre: the fluid ones and, with REACT,
// the dynamic-rigid ones that the kernel walks.
template <bool REACT, typename Walk>
__global__ void wcsph_forces_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const int* __restrict__ material, const int* __restrict__ is_dyn,
    const float* __restrict__ m, const float* __restrict__ m_V,
    const float* __restrict__ dpi, const float* __restrict__ p_r02,
    const float* __restrict__ m_nc, const float* __restrict__ rr0, Walk walk,
    PairList pl, const float* __restrict__ dt_ptr, float* __restrict__ x_out,
    float* __restrict__ v_out, float* __restrict__ acc_out, int n_rows,
    PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < c.n_real;
  const int mat_i = real ? material[i] : -1;
  const bool fluid = mat_i == 1;
  const bool solid = mat_i == 0;
  const bool dyn = real && is_dyn[i] != 0;
  // the pair sum is read by fluid centres and, with the reaction, by
  // dynamic-rigid ones; every other centre's acceleration is fixed
  const bool walks = fluid || (REACT && solid && dyn);
  float vi[3] = {0.0f, 0.0f, 0.0f};
  float neg_st_mi = 0.0f, dpi_i = 0.0f, p_r02_i = 0.0f, m_V_i = 0.0f;
  float rr0_i = 0.0f;
  if (walks) {
    vi[0] = v[3 * i], vi[1] = v[3 * i + 1], vi[2] = v[3 * i + 2];
    neg_st_mi = -(c.st / m[i]);
    dpi_i = dpi[i];
    p_r02_i = p_r02[i];
    m_V_i = m_V[i];
    if (REACT) rr0_i = rr0[i];
  }
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for_each_step_pair(
      walks, i, x, x, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float s) {
        const float rn = sqrtf(s);
        const float r2 = rn * rn;
        const float inv = 1.0f / sqrtf(fmaxf(r2, 1e-38f));
        const float gradw = cubic_grad(rn, inv, c);
        const int mat_j = material[j];
        const bool fluid_j = mat_j == 1;
        const bool solid_j = mat_j == 0;
        float a;
        if (REACT && !fluid) {
          // reaction on a dynamic-rigid centre (gather form of the
          // reference's scatter, WCSPH.py:67-68)
          const float dpi_k = dpi[j] + p_r02[j];
          a = fluid_j ? -(c.rho0 * m_V_i * dpi_k) * rr0_i * gradw : 0.0f;
        } else {
          const float w_st = (r2 > c.diam2) ? cubic_w(rn, c) : c.wd;
          const float st_coef = fluid_j ? neg_st_mi * m[j] * w_st : 0.0f;
          const float v_xy = (vi[0] - v[3 * j]) * d0 +
                             (vi[1] - v[3 * j + 1]) * d1 +
                             (vi[2] - v[3 * j + 2]) * d2;
          const float visc_coef =
              fluid_j ? viscosity_coef(m_nc[j], v_xy, r2, gradw, c) : 0.0f;
          const float dpj = fluid_j ? dpi[j] : p_r02_i;
          const float press_coef =
              (fluid_j || solid_j)
                  ? pressure_coef(m_V[j], dpi_i, dpj, gradw, c)
                  : 0.0f;
          a = st_coef + visc_coef + press_coef;
        }
        s0 += a * d0;
        s1 += a * d1;
        s2 += a * d2;
      });
  if (i >= n_rows) return;
  float xs[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  // the centres that did not walk load their velocity here: loading every
  // row's before the walk took the slot walk's instantiation from 56 to 62
  // registers (9 to 8 resident blocks per SM)
  if (!walks) vi[0] = v[3 * i], vi[1] = v[3 * i + 1], vi[2] = v[3 * i + 2];
  if (!real) {
    // padding rows: as the plain path leaves them
    for (int k = 0; k < 3; ++k) {
      x_out[3 * i + k] = xs[k];
      v_out[3 * i + k] = vi[k];
      acc_out[3 * i + k] = 0.0f;
    }
    return;
  }
  // epilogue: acceleration select, symplectic Euler, fluid box clamp —
  // the unfused chain of models/wcsph.py and models/base.py, in order
  const float dt = *dt_ptr;
  const float g[3] = {c.g0, c.g1, c.g2};
  const float sums[3] = {s0, s1, s2};
  const float hi[3] = {c.hi0, c.hi1, c.hi2};
  float acc[3];
  for (int k = 0; k < 3; ++k) {
    float a = g[k] + (fluid ? sums[k] : 0.0f);
    if (REACT && solid && dyn) a = g[k] + sums[k];
    if (solid && !dyn) a = 0.0f;
    if (mat_i == -1) a = 0.0f;
    acc[k] = a;
    if (dyn) {
      vi[k] = vi[k] + dt * a;
      xs[k] = xs[k] + dt * vi[k];
    }
  }
  if (fluid && dyn) {
    float nrm[3], xn[3];
    for (int k = 0; k < 3; ++k) {
      const bool over = xs[k] > hi[k];
      const bool under = xs[k] <= c.lo;
      nrm[k] = (over ? 1.0f : 0.0f) - (under ? 1.0f : 0.0f);
      xn[k] = under ? c.lo : (over ? hi[k] : xs[k]);
    }
    const float nlen = sqrtf(nrm[0] * nrm[0] + nrm[1] * nrm[1] +
                             nrm[2] * nrm[2]);
    const float nd = fmaxf(nlen, 1e-30f);
    const float nh[3] = {nrm[0] / nd, nrm[1] / nd, nrm[2] / nd};
    const float vdotn = vi[0] * nh[0] + vi[1] * nh[1] + vi[2] * nh[2];
    if (nlen > 1e-6f) {
      for (int k = 0; k < 3; ++k) vi[k] = vi[k] - c.cf1 * vdotn * nh[k];
    }
    for (int k = 0; k < 3; ++k) xs[k] = xn[k];
  }
  for (int k = 0; k < 3; ++k) {
    x_out[3 * i + k] = xs[k];
    v_out[3 * i + k] = vi[k];
    acc_out[3 * i + k] = acc[k];
  }
}

// Akinci boundary volume of the target rows (sph_base.py:91-113):
// m_V[i] = 3 / (W(0) + sum over solid j within h of W(r_ij)), the 3.0 of
// the reference included, for each entry of ``targets``, the target rows
// compacted (ops/cuda_pairs.py target_rows; -1 pads the tail); other rows
// of m_V are not written.  Two designs: boundary_volume_warp_kernel, a
// warp per target, over the cell runs; boundary_volume_thread_kernel, a
// thread per target, over the slot map, where it measured faster
// (chip_smoke.py times both designs over both walks, and lane groups of
// 8 and 16: tools/volume_walk_control.cu).
//
// What bounds it on an H100: the latency of its loads.  A target reads
// ~200 candidates and keeps the few solid ones within h.  A thread per
// target leaves ~8 warps per SM for the scaled dragon's 34,058 targets
// (4-5 for the dynamic dragon's 18,506), each lane walking its candidates
// through a chain of loads (a column's offsets or a cell's slots, then
// each candidate).  In the warp design a target's 32 lanes share its walk:
// they load 32 candidates of a column's z-run (~24 of them) at once,
// coalesced, run the inclusion test, the solid test and W in parallel, and
// add the solid terms by shuffle in lane order, walking a ballot: the
// one-thread walk's adds in its order, so the volumes equal it and
// boundary_volume_plain bitwise.  It has 32 times the warps, and spends
// more instructions per candidate (idle lanes past a run's end, the
// ballot, one shuffle and add after another); over the slot map, where
// each round also waits on the map, that cost outweighs the warps.  The
// target, its cell and z-range come from lane 0; a padding target's warp
// walks nothing, and every lane reaches every ballot and shuffle, so no
// lane returns early.
__global__ void boundary_volume_warp_kernel(const float* __restrict__ x,
                                            const int* __restrict__ material,
                                            CellRunWalk walk,
                                            const int* __restrict__ targets,
                                            int n_targets,
                                            float* __restrict__ m_V,
                                            PairConsts c) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int i = -1, ix = 0, iy = 0, zlo = 0, zhi = -1;
  float xi0 = 0.0f, xi1 = 0.0f, xi2 = 0.0f;
  if (lane == 0 && t < n_targets) {
    i = targets[t];
    if (i >= 0) {
      xi0 = x[3 * i], xi1 = x[3 * i + 1], xi2 = x[3 * i + 2];
      ix = cell_x(xi0, c);
      iy = cell_coord(xi1, c);
      const int iz = cell_coord(xi2, c);
      zlo = max(iz - 1, 0);
      zhi = min(iz + 1, c.nz - 1);
    }
  }
  i = __shfl_sync(kAll, i, 0);
  ix = __shfl_sync(kAll, ix, 0), iy = __shfl_sync(kAll, iy, 0);
  zlo = __shfl_sync(kAll, zlo, 0), zhi = __shfl_sync(kAll, zhi, 0);
  xi0 = __shfl_sync(kAll, xi0, 0), xi1 = __shfl_sync(kAll, xi1, 0);
  xi2 = __shfl_sync(kAll, xi2, 0);
  float sum = 0.0f;
  if (i >= 0 && zlo <= zhi) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int cx = ix + dx;
      if (cx < 0 || cx >= c.nx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int cy = iy + dy;
        if (cy < 0 || cy >= c.ny) continue;
        const int base = (cx * c.ny + cy) * c.nz;
        const int b = walk.starts[base + zlo];
        const int e = walk.starts[base + zhi + 1];
        // lane k takes the run's k-th candidate of the round: the
        // inclusion test of for_each_neighbor_walk, the solid test and W,
        // then the round's solid terms added in lane order
        for (int j0 = b; j0 < e; j0 += 32) {
          const int j = j0 + lane;
          float w = 0.0f;
          bool take = false;
          if (j < e) {
            const float d0 = xi0 - x[3 * j];
            const float d1 = xi1 - x[3 * j + 1];
            const float d2 = xi2 - x[3 * j + 2];
            const int mat = material[j];
            const float s = d0 * d0 + d1 * d1 + d2 * d2;
            take = j != i && s < c.h2 && mat == 0;
            if (take) w = cubic_w(sqrtf(s), c);
          }
          for (unsigned bits = __ballot_sync(kAll, take); bits;
               bits &= bits - 1) {
            sum += __shfl_sync(kAll, w, __ffs(bits) - 1);
          }
        }
      }
    }
  }
  if (lane == 0 && i >= 0) m_V[i] = 3.0f / (c.w0 + sum);
}

// A thread per target, walking its candidates with for_each_neighbor_walk.
template <typename Walk>
__global__ void boundary_volume_thread_kernel(
    const float* __restrict__ x, const int* __restrict__ material, Walk walk,
    const int* __restrict__ targets, int n_targets, float* __restrict__ m_V,
    PairConsts c) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_targets) return;
  const int i = targets[t];
  if (i < 0) return;
  float sum = 0.0f;
  for_each_neighbor_walk(i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk, c,
                         [&](int j, float, float, float, float s) {
                           if (material[j] == 0) sum += cubic_w(sqrtf(s), c);
                         });
  m_V[i] = 3.0f / (c.w0 + sum);
}

// Launches the warp design over the cell runs.
__host__ void launch_volume_warp(const float* x, const int* material,
                                 CellRunWalk walk, const int* targets,
                                 int n_targets, float* m_V,
                                 const PairConsts& c, cudaStream_t stream) {
  const long long threads = (long long)n_targets * 32;
  const int grid = (int)((threads + kBlock - 1) / kBlock);
  boundary_volume_warp_kernel<<<grid, kBlock, 0, stream>>>(
      x, material, walk, targets, n_targets, m_V, c);
}

// Launches the one-thread design over ``walk``.
template <typename Walk>
__host__ void launch_volume_thread(const float* x, const int* material,
                                   Walk walk, const int* targets,
                                   int n_targets, float* m_V,
                                   const PairConsts& c, cudaStream_t stream) {
  boundary_volume_thread_kernel<Walk>
      <<<(n_targets + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
          x, material, walk, targets, n_targets, m_V, c);
}

// Each launcher's walk arguments (starts, slot_map, layers) select the
// instantiation (pair_common.cuh with_walk).

extern "C" int density_sum_launch(const float* x, const int* material,
                                  const float* m_V, const int* starts,
                                  const int* slot_map, int layers,
                                  float* out, PairConsts c, void* stream) {
  if (c.n_real > 0) {
    with_walk(starts, slot_map, layers, [&](auto walk) {
      density_sum_kernel<<<grid_for(c), kBlock, 0, (cudaStream_t)stream>>>(
          x, material, m_V, walk, out, c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int pairs_list_entries() { return kPairListEntries; }

// The density with the step's list, over the walk its arguments select
// (cell offsets ``starts``, or the slot map ``slot_map`` of ``layers``
// layers).  The list ``idx`` is i32[kPairListEntries, n_rows], ``cnt`` and
// ``out`` have n_rows rows.
extern "C" int density_sum_list_launch(const float* x, const int* material,
                                       const float* m_V, const int* starts,
                                       const int* slot_map, int layers,
                                       int* idx, int* cnt, float* out,
                                       int n_rows, PairConsts c,
                                       void* stream) {
  if (n_rows > 0) {
    with_walk(starts, slot_map, layers, [&](auto walk) {
      if constexpr (kCompactWalk<decltype(walk)>) {
        density_sum_list_kernel<<<rows_grid(n_rows), kBlock, 0,
                                  (cudaStream_t)stream>>>(
            x, material, m_V, walk, idx, cnt, out, n_rows, c);
      } else {
        density_sum_slot_kernel<<<rows_grid(n_rows), kBlock, 0,
                                  (cudaStream_t)stream>>>(
            x, material, m_V, walk, idx, cnt, out, n_rows, c);
      }
    });
  }
  return (int)cudaGetLastError();
}

// Over both walks the kernel reads the list (list_idx, list_cnt), the
// step's density_sum_list output over the same walk for the same rows; a
// launch without it is refused (cudaErrorInvalidValue, pair_common.cuh
// has_step_list).  It launches over n_rows rows, padding rows included.
extern "C" int wcsph_forces_launch(
    const float* x, const float* v, const int* material, const int* is_dyn,
    const float* m, const float* m_V, const float* dpi, const float* p_r02,
    const float* m_nc, const float* rr0, const int* starts,
    const int* slot_map, int layers, const int* list_idx, const int* list_cnt,
    const float* dt, float* x_out, float* v_out, float* acc_out, int react,
    int n_rows, PairConsts c, void* stream) {
  if (!has_step_list(list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      using Walk = decltype(walk);
      auto kernel = react ? wcsph_forces_kernel<true, Walk>
                          : wcsph_forces_kernel<false, Walk>;
      kernel<<<rows_grid(n_rows), kBlock, 0, (cudaStream_t)stream>>>(
          x, v, material, is_dyn, m, m_V, dpi, p_r02, m_nc, rr0, walk, pl,
          dt, x_out, v_out, acc_out, n_rows, c);
    });
  }
  return (int)cudaGetLastError();
}

// Kernel c over the walk its arguments select: the warp design over the
// cell runs, the one-thread design over the slot map.
extern "C" int boundary_volume_launch(const float* x, const int* material,
                                      const int* starts, const int* slot_map,
                                      int layers, const int* targets,
                                      int n_targets, float* m_V, PairConsts c,
                                      void* stream) {
  if (n_targets > 0) {
    with_walk(starts, slot_map, layers, [&](auto walk) {
      if constexpr (kCompactWalk<decltype(walk)>) {
        launch_volume_warp(x, material, walk, targets, n_targets, m_V, c,
                           (cudaStream_t)stream);
      } else {
        launch_volume_thread(x, material, walk, targets, n_targets, m_V, c,
                             (cudaStream_t)stream);
      }
    });
  }
  return (int)cudaGetLastError();
}

// Registers per thread, static shared memory per block and resident blocks
// per SM of kernel ``which``: 0 density_sum_list, 1 density_sum over the
// cell runs, 2 wcsph_forces<false>, 3 wcsph_forces<true> (over the cell
// runs; 4, 5 over the slot walk), 6 density_sum_slot (the list over the
// slot walk), 7 density_sum over the slot walk, 8 boundary_volume over the
// cell runs (a warp per target), 9 over the slot walk (a thread per target).
extern "C" int pairs_occupancy(int which, int* regs, int* smem_bytes,
                               int* blocks_per_sm) {
  const void* kernels[10] = {
      (const void*)density_sum_list_kernel,
      (const void*)density_sum_kernel<CellRunWalk>,
      (const void*)wcsph_forces_kernel<false, CellRunWalk>,
      (const void*)wcsph_forces_kernel<true, CellRunWalk>,
      (const void*)wcsph_forces_kernel<false, SlotWalk>,
      (const void*)wcsph_forces_kernel<true, SlotWalk>,
      (const void*)density_sum_slot_kernel,
      (const void*)density_sum_kernel<SlotWalk>,
      (const void*)boundary_volume_warp_kernel,
      (const void*)boundary_volume_thread_kernel<SlotWalk>};
  if (which < 0 || which > 9) return (int)cudaErrorInvalidValue;
  const void* kernel = kernels[which];
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        kBlock, 0);
  }
  *regs = attr.numRegs;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)err;
}
