// Pair traversals of the IISPH step on Hopper (sm_90a), one thread per
// centre in cell-sorted order, over either candidate walk of
// pair_common.cuh.
//
// Replaces: the Pallas TPU kernel BlockEngine._kernel
// (sph_taichi_tpu/ops/pallas_blocks.py, launched by BlockEngine.traverse) in
// its specializations on the IISPH path (sph_taichi_tpu/models/iisph.py):
//   iisph_nonpressure_kick  <- compute_non_pressure with its epilogue:
//                              acc = g + viscosity on every real centre, the
//                              fluid kick v* = v + dt * acc
//   iisph_predict_advection <- predict_advection: one walk, four sums
//                              (G, S radial; Q, div scalar), epilogue a_ii,
//                              source and the warm start 0.5 p
//   iisph_pressure_accel<ADVECT>
//                           <- _pressure_accel: the symmetric pressure
//                              acceleration of every real centre (in the
//                              Jacobi loop, ADVECT = false) or, with the
//                              advect epilogue, v' = v* + dt a_p and
//                              x' = x + dt v' on fluid rows (ADVECT = true)
//   iisph_apply_A           <- _apply_A with the relaxed-Jacobi update and
//                              the per-centre error column in its epilogue
// and the retired SlotEngine._kernel
// (sph_taichi_tpu/ops/retired/pallas_slots.py) in the same four: each is
// a template over its walk, CellRunWalk (the cell offsets) or SlotWalk (the
// slot map of ops/slots.py), as in pairs.cu.
//
// Each epilogue is the unfused chain of the plain versions in
// ops/cuda_iisph.py, in the same operation order.  The Jacobi kernels
// (pressure_accel without ADVECT, apply_A) take the loop's device flag
// `active` and return at once when it is 0 (models/base.py jacobi_while).
//
// The positions do not move from the sort to the advect epilogue: f1's
// kick moves v, not x.  So every pair kernel of the step walks the pairs
// that the step's density kernel accepted.  Over the cell runs the density
// kernel, density_sum_list (pairs.cu, pair_common.cuh build_pair_list),
// writes every real centre's accepted j (solids too: A reads their
// accelerations), in the walk's order, to the step's pair list as it sums,
// and f1, f2, f3 (both variants) and f4 run only their pair body over that
// list (for_each_step_pair), with the same d and raw sum of squares as the
// cell walk, so every output stays bitwise that of the plain version.  A
// warp holding a centre with more accepted pairs than the list holds walks
// the cells in one phase.  Over the cell runs every kernel has a thread for
// every row, padding rows included, and writes the padding rows itself (the
// acceleration, a_ii, the source, the warm start, p' and the error 0; v
// carried through f1, the advect's v' and x' from v and x, as restore_tail
// gives them), so each wrapper launches one kernel.
//
// Over the slot walk the density kernel (pairs.cu density_sum_slot_kernel)
// writes the same list of every real centre in its one-phase walk, and all
// four kernels run only their pair body over it (for_each_step_pair): a
// warp holding a centre over the list walks the slot map in one phase,
// pinned with xg = x, which gives the pairs, d and raw sum of squares of
// the one-phase walk.  The launchers refuse a launch without the list
// under both walks, and the slot instantiations write the padding rows
// too.
//
// As dfsph.cu, the list walks are bound by their gathers (a warp over the
// list, by irregular candidate loads that mostly hit L1/L2); the f32 work
// per real pair (25-50 operations) is far below the card's rate.
// Everything stays in registers.

#include "pair_common.cuh"

// f1's pair term (IISPH.py:236-249): the viscosity between centre i, of
// velocity vi, and a fluid j, added into s[0..2].
__device__ __forceinline__ void nonpressure_pair(
    int j, float d0, float d1, float d2, float sq, const float vi[3],
    const float* __restrict__ v, const int* __restrict__ material,
    const float* __restrict__ m, const float* __restrict__ density,
    const PairConsts& c, float s[3]) {
  if (material[j] != 1) return;
  const PairGeom p = pair_geom(sq);
  const float gradw = cubic_grad(p.rn, p.inv, c);
  const float v_xy = (vi[0] - v[3 * j]) * d0 +
                     (vi[1] - v[3 * j + 1]) * d1 +
                     (vi[2] - v[3 * j + 2]) * d2;
  const float a = viscosity_coef(m[j] / density[j], v_xy, p.r2, gradw, c);
  s[0] += a * d0;
  s[1] += a * d1;
  s[2] += a * d2;
}

// f2's pair terms: the four sums G, S (radial), Q and div (scalar) over
// real j, added into g[0..2], s[0..2], q and div.
__device__ __forceinline__ void predict_pair(
    int j, float d0, float d1, float d2, float sq, const float vi[3],
    const float* __restrict__ v, const int* __restrict__ material,
    const float* __restrict__ m_V, const float* __restrict__ density,
    const PairConsts& c, float g[3], float s[3], float& q, float& div) {
  if (material[j] < 0) return;
  const PairGeom p = pair_geom(sq);
  const float gradw = cubic_grad(p.rn, p.inv, c);
  const float mg = m_V[j] * gradw;
  const float rho_j = density[j];
  const float sj = mg / (rho_j * rho_j);
  const float v_xy = (vi[0] - v[3 * j]) * d0 +
                     (vi[1] - v[3 * j + 1]) * d1 +
                     (vi[2] - v[3 * j + 2]) * d2;
  g[0] += mg * d0;
  g[1] += mg * d1;
  g[2] += mg * d2;
  s[0] += sj * d0;
  s[1] += sj * d1;
  s[2] += sj * d2;
  q += mg * gradw * p.r2;
  div += mg * v_xy;
}

// f2's epilogue on a real row: a_ii = dt^2 rho0^2 (-S.G - (m_V_i /
// rho_i^2) Q), the source term and the warm start (IISPH.py:20-100), in
// the JAX package's operation order.
__device__ __forceinline__ void predict_out(
    int i, const float g[3], const float s[3], float q, float div, float dt,
    const float* __restrict__ m_V, const float* __restrict__ density,
    const float* __restrict__ pressure, float* __restrict__ a_ii_out,
    float* __restrict__ source_out, float* __restrict__ last_p_out,
    const PairConsts& c) {
  const float rho_i = density[i];
  const float dot_sg = s[0] * g[0] + s[1] * g[1] + s[2] * g[2];
  const float rho2 = rho_i * rho_i;
  a_ii_out[i] = (dt * dt) * c.rho0sq * (-dot_sg - (m_V[i] / rho2) * q);
  source_out[i] = c.rho0 - rho_i - dt * div * c.rho0;
  last_p_out[i] = 0.5f * pressure[i];
}

// f1 over the step's pair list ``pl`` (density_sum_list's, over either
// walk), one thread per row, padding rows included (acc 0, v carried
// through).  Every real centre walks, static solids included
// (IISPH.py:236-249); the viscosity acts between a centre and its fluid
// neighbours only.
template <typename Walk>
__global__ void iisph_nonpressure_kick_list_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const int* __restrict__ material, const float* __restrict__ m,
    const float* __restrict__ density, Walk walk, PairList pl,
    const float* __restrict__ dt_ptr, float* __restrict__ acc_out,
    float* __restrict__ v_out, int n_rows, PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < c.n_real;
  float vi[3] = {0.0f, 0.0f, 0.0f};
  if (real) vi[0] = v[3 * i], vi[1] = v[3 * i + 1], vi[2] = v[3 * i + 2];
  float s[3] = {0.0f, 0.0f, 0.0f};
  for_each_step_pair(
      real, i, x, x, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float sq) {
        nonpressure_pair(j, d0, d1, d2, sq, vi, v, material, m, density, c,
                         s);
      });
  if (i >= n_rows) return;
  if (!real) {
    for (int k = 0; k < 3; ++k) {
      acc_out[3 * i + k] = 0.0f;
      v_out[3 * i + k] = v[3 * i + k];
    }
    return;
  }
  const bool fluid = material[i] == 1;
  const float dt = *dt_ptr;
  const float g[3] = {c.g0, c.g1, c.g2};
  for (int k = 0; k < 3; ++k) {
    const float a = g[k] + s[k];
    acc_out[3 * i + k] = a;
    v_out[3 * i + k] = fluid ? vi[k] + dt * a : vi[k];
  }
}

// f2 over the step's pair list ``pl`` (density_sum_list's, over either
// walk), one thread per row, padding rows included (a_ii, the source and
// the warm start 0).
template <typename Walk>
__global__ void iisph_predict_advection_list_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const int* __restrict__ material, const float* __restrict__ m_V,
    const float* __restrict__ density, const float* __restrict__ pressure,
    Walk walk, PairList pl, const float* __restrict__ dt_ptr,
    float* __restrict__ a_ii_out, float* __restrict__ source_out,
    float* __restrict__ last_p_out, int n_rows, PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < c.n_real;
  float vi[3] = {0.0f, 0.0f, 0.0f};
  if (real) vi[0] = v[3 * i], vi[1] = v[3 * i + 1], vi[2] = v[3 * i + 2];
  float g[3] = {0.0f, 0.0f, 0.0f};
  float s[3] = {0.0f, 0.0f, 0.0f};
  float q = 0.0f, div = 0.0f;
  for_each_step_pair(
      real, i, x, x, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float sq) {
        predict_pair(j, d0, d1, d2, sq, vi, v, material, m_V, density, c, g,
                     s, q, div);
      });
  if (i >= n_rows) return;
  if (!real) {
    a_ii_out[i] = 0.0f;
    source_out[i] = 0.0f;
    last_p_out[i] = 0.0f;
    return;
  }
  predict_out(i, g, s, q, div, *dt_ptr, m_V, density, pressure, a_ii_out,
              source_out, last_p_out, c);
}

template <bool ADVECT, typename Walk>
__global__ void iisph_pressure_accel_kernel(
    const float* __restrict__ x, const int* __restrict__ material,
    const float* __restrict__ m_V, const float* __restrict__ density,
    const float* __restrict__ pr, Walk walk, PairList pl,
    const float* __restrict__ v, const float* __restrict__ dt_ptr,
    const unsigned char* __restrict__ active, float* __restrict__ out0,
    float* __restrict__ out1, int n_rows, PairConsts c) {
  if (active != nullptr && !*active) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // in the loop every real centre's acceleration is kept, solids' too:
  // _apply_A reads it in (a_i - a_j) . r_ij (iisph.py:340)
  const bool real = i < c.n_real;
  float s[3] = {0.0f, 0.0f, 0.0f};
  sym_pressure_sum(real, i, x, x, material, m_V, density, pr, walk, pl, c,
                   s);
  if (i >= n_rows) return;
  if (!ADVECT) {
    for (int k = 0; k < 3; ++k) out0[3 * i + k] = s[k];
    return;
  }
  // advect epilogue (IISPH.py:251-257): v holds v*; fluid rows only
  const bool fluid = real && material[i] == 1;
  const float dt = *dt_ptr;
  for (int k = 0; k < 3; ++k) {
    const float vk = fluid ? v[3 * i + k] + dt * s[k] : v[3 * i + k];
    const float xk = x[3 * i + k];
    out0[3 * i + k] = vk;
    out1[3 * i + k] = fluid ? xk + dt * vk : xk;
  }
}

template <typename Walk>
__global__ void iisph_apply_A_kernel(
    const float* __restrict__ x, const int* __restrict__ material,
    const float* __restrict__ m_V, const float* __restrict__ accel,
    const float* __restrict__ a_ii, const float* __restrict__ source,
    const float* __restrict__ last_p, Walk walk, PairList pl,
    const float* __restrict__ dt_ptr, const unsigned char* __restrict__ active,
    float omega, float* __restrict__ new_p_out, float* __restrict__ err_out,
    int n_rows, PairConsts c) {
  if (active != nullptr && !*active) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < c.n_real;
  float ai0 = 0.0f, ai1 = 0.0f, ai2 = 0.0f;
  if (real) ai0 = accel[3 * i], ai1 = accel[3 * i + 1], ai2 = accel[3 * i + 2];
  float sum = 0.0f;
  for_each_step_pair(
      real, i, x, x, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float sq) {
        if (material[j] < 0) return;
        const PairGeom p = pair_geom(sq);
        const float gradw = cubic_grad(p.rn, p.inv, c);
        const float a_xy = (ai0 - accel[3 * j]) * d0 +
                           (ai1 - accel[3 * j + 1]) * d1 +
                           (ai2 - accel[3 * j + 2]) * d2;
        sum += m_V[j] * gradw * a_xy;
      });
  if (i >= n_rows) return;
  if (!real) {
    new_p_out[i] = 0.0f;
    err_out[i] = 0.0f;
    return;
  }
  // relaxed Jacobi (IISPH.py:146-179): Ap = dt^2 rho0 sum; the error
  // column counts the rows whose pressure stays positive
  const float dt = *dt_ptr;
  const float ap = sum * (dt * dt) * c.rho0;
  const float aii = a_ii[i];
  const float src = source[i];
  const float new_p =
      (fabsf(aii) > 1e-6f)
          ? fmaxf(last_p[i] + omega * (src - ap) / aii, 0.0f)
          : 0.0f;
  new_p_out[i] = new_p;
  err_out[i] = (new_p != 0.0f) ? fabsf(ap - src) / c.rho0 : 0.0f;
}

// Each launcher's walk arguments (starts, slot_map, layers) select the
// kernel over that walk (pair_common.cuh with_walk).  Every kernel reads
// the step's list (list_idx, list_cnt: density_sum_list's output over the
// same walk for the same rows) over either walk; a launch without it is
// refused (cudaErrorInvalidValue: pair_common.cuh has_step_list).  Every
// kernel launches over n_rows rows, padding rows included.

extern "C" int iisph_nonpressure_kick_launch(
    const float* x, const float* v, const int* material, const float* m,
    const float* density, const int* starts, const int* slot_map, int layers,
    const int* list_idx, const int* list_cnt, const float* dt,
    float* acc_out, float* v_out, int n_rows, PairConsts c, void* stream) {
  if (!has_step_list(list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      iisph_nonpressure_kick_list_kernel<<<rows_grid(n_rows), kBlock, 0,
                                           (cudaStream_t)stream>>>(
          x, v, material, m, density, walk, pl, dt, acc_out, v_out, n_rows,
          c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int iisph_predict_advection_launch(
    const float* x, const float* v, const int* material, const float* m_V,
    const float* density, const float* pressure, const int* starts,
    const int* slot_map, int layers, const int* list_idx,
    const int* list_cnt, const float* dt, float* a_ii_out,
    float* source_out, float* last_p_out, int n_rows, PairConsts c,
    void* stream) {
  if (!has_step_list(list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      iisph_predict_advection_list_kernel<<<rows_grid(n_rows), kBlock, 0,
                                            (cudaStream_t)stream>>>(
          x, v, material, m_V, density, pressure, walk, pl, dt, a_ii_out,
          source_out, last_p_out, n_rows, c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int iisph_pair_list_entries() { return kPairListEntries; }

extern "C" int iisph_pressure_accel_launch(
    const float* x, const int* material, const float* m_V,
    const float* density, const float* pr, const int* starts,
    const int* slot_map, int layers, const int* list_idx,
    const int* list_cnt, const float* v, const float* dt,
    const unsigned char* active, float* out0, float* out1, int advect,
    int n_rows, PairConsts c, void* stream) {
  if (!has_step_list(list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      using Walk = decltype(walk);
      auto kernel = advect ? iisph_pressure_accel_kernel<true, Walk>
                           : iisph_pressure_accel_kernel<false, Walk>;
      kernel<<<rows_grid(n_rows), kBlock, 0, (cudaStream_t)stream>>>(
          x, material, m_V, density, pr, walk, pl, v, dt, active, out0, out1,
          n_rows, c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int iisph_apply_A_launch(
    const float* x, const int* material, const float* m_V,
    const float* accel, const float* a_ii, const float* source,
    const float* last_p, const int* starts, const int* slot_map, int layers,
    const int* list_idx, const int* list_cnt, const float* dt,
    const unsigned char* active, float omega, float* new_p_out,
    float* err_out, int n_rows, PairConsts c, void* stream) {
  if (!has_step_list(list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      iisph_apply_A_kernel<<<rows_grid(n_rows), kBlock, 0,
                             (cudaStream_t)stream>>>(
          x, material, m_V, accel, a_ii, source, last_p, walk, pl, dt, active,
          omega, new_p_out, err_out, n_rows, c);
    });
  }
  return (int)cudaGetLastError();
}

// Registers per thread, static shared memory per block and resident blocks
// per SM of kernel ``which``: 0 pressure_accel (loop), 1 pressure_accel
// with the advect, 2 apply_A, 3 nonpressure_kick, 4 predict_advection
// (over the cell runs; + 5: over the slot walk).
extern "C" int iisph_occupancy(int which, int* regs, int* smem_bytes,
                               int* blocks_per_sm) {
  const void* kernels[10] = {
      (const void*)iisph_pressure_accel_kernel<false, CellRunWalk>,
      (const void*)iisph_pressure_accel_kernel<true, CellRunWalk>,
      (const void*)iisph_apply_A_kernel<CellRunWalk>,
      (const void*)iisph_nonpressure_kick_list_kernel<CellRunWalk>,
      (const void*)iisph_predict_advection_list_kernel<CellRunWalk>,
      (const void*)iisph_pressure_accel_kernel<false, SlotWalk>,
      (const void*)iisph_pressure_accel_kernel<true, SlotWalk>,
      (const void*)iisph_apply_A_kernel<SlotWalk>,
      (const void*)iisph_nonpressure_kick_list_kernel<SlotWalk>,
      (const void*)iisph_predict_advection_list_kernel<SlotWalk>};
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
