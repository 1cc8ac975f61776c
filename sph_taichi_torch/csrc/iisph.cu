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
// (sph_taichi_tpu/ops/retired/pallas_slots.py) in the same four: each
// kernel is a template over its walk, CellRunWalk (the cell offsets) or
// SlotWalk (the slot map of ops/slots.py), as in pairs.cu.
//
// Each epilogue is the unfused chain of the plain versions in
// ops/cuda_iisph.py, in the same operation order.  Padding rows are not
// launched; the wrappers restore them.  The Jacobi kernels (pressure_accel
// without ADVECT, apply_A) take the loop's device flag `active` and return
// at once when it is 0 (models/base.py jacobi_while).
//
// As dfsph.cu, bound by irregular candidate loads that mostly hit L1/L2;
// the f32 work per real pair (25-50 operations) is far below the card's
// rate.  Everything stays in registers.

#include "pair_common.cuh"

template <typename Walk>
__global__ void iisph_nonpressure_kick_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const int* __restrict__ material, const float* __restrict__ m,
    const float* __restrict__ density, Walk walk,
    const float* __restrict__ dt_ptr, float* __restrict__ acc_out,
    float* __restrict__ v_out, PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.n_real) return;
  const bool fluid = material[i] == 1;
  const float vi[3] = {v[3 * i], v[3 * i + 1], v[3 * i + 2]};
  float s[3] = {0.0f, 0.0f, 0.0f};
  // every real centre, static solids included (IISPH.py:236-249); the
  // viscosity acts between a centre and its fluid neighbours only
  for_each_neighbor_walk(
      i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk, c,
      [&](int j, float d0, float d1, float d2, float sq) {
        if (material[j] != 1) return;
        const PairGeom p = pair_geom(sq);
        const float gradw = cubic_grad(p.rn, p.inv, c);
        const float v_xy = (vi[0] - v[3 * j]) * d0 +
                           (vi[1] - v[3 * j + 1]) * d1 +
                           (vi[2] - v[3 * j + 2]) * d2;
        const float a =
            viscosity_coef(m[j] / density[j], v_xy, p.r2, gradw, c);
        s[0] += a * d0;
        s[1] += a * d1;
        s[2] += a * d2;
      });
  const float dt = *dt_ptr;
  const float g[3] = {c.g0, c.g1, c.g2};
  for (int k = 0; k < 3; ++k) {
    const float a = g[k] + s[k];
    acc_out[3 * i + k] = a;
    v_out[3 * i + k] = fluid ? vi[k] + dt * a : vi[k];
  }
}

template <typename Walk>
__global__ void iisph_predict_advection_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const int* __restrict__ material, const float* __restrict__ m_V,
    const float* __restrict__ density, const float* __restrict__ pressure,
    Walk walk, const float* __restrict__ dt_ptr,
    float* __restrict__ a_ii_out, float* __restrict__ source_out,
    float* __restrict__ last_p_out, PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.n_real) return;
  const float vi[3] = {v[3 * i], v[3 * i + 1], v[3 * i + 2]};
  float g[3] = {0.0f, 0.0f, 0.0f};
  float s[3] = {0.0f, 0.0f, 0.0f};
  float q = 0.0f, div = 0.0f;
  for_each_neighbor_walk(
      i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk, c,
      [&](int j, float d0, float d1, float d2, float sq) {
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
      });
  // a_ii = dt^2 rho0^2 (-S.G - (m_V_i / rho_i^2) Q); source term and the
  // warm start (IISPH.py:20-100), in the JAX package's operation order
  const float dt = *dt_ptr;
  const float rho_i = density[i];
  const float dot_sg = s[0] * g[0] + s[1] * g[1] + s[2] * g[2];
  const float rho2 = rho_i * rho_i;
  a_ii_out[i] = (dt * dt) * c.rho0sq * (-dot_sg - (m_V[i] / rho2) * q);
  source_out[i] = c.rho0 - rho_i - dt * div * c.rho0;
  last_p_out[i] = 0.5f * pressure[i];
}

template <bool ADVECT, typename Walk>
__global__ void iisph_pressure_accel_kernel(
    const float* __restrict__ x, const int* __restrict__ material,
    const float* __restrict__ m_V, const float* __restrict__ density,
    const float* __restrict__ pr, Walk walk,
    const float* __restrict__ v, const float* __restrict__ dt_ptr,
    const unsigned char* __restrict__ active, float* __restrict__ out0,
    float* __restrict__ out1, PairConsts c) {
  if (active != nullptr && !*active) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.n_real) return;
  float s[3] = {0.0f, 0.0f, 0.0f};
  // in the loop every real centre's acceleration is kept, solids' too:
  // _apply_A reads it in (a_i - a_j) . r_ij (iisph.py:340)
  sym_pressure_sum(i, x, material, m_V, density, pr, walk, c, s);
  if (!ADVECT) {
    for (int k = 0; k < 3; ++k) out0[3 * i + k] = s[k];
    return;
  }
  // advect epilogue (IISPH.py:251-257): v holds v*; fluid rows only
  const bool fluid = material[i] == 1;
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
    const float* __restrict__ last_p, Walk walk,
    const float* __restrict__ dt_ptr, const unsigned char* __restrict__ active,
    float omega, float* __restrict__ new_p_out, float* __restrict__ err_out,
    PairConsts c) {
  if (active != nullptr && !*active) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.n_real) return;
  const float ai[3] = {accel[3 * i], accel[3 * i + 1], accel[3 * i + 2]};
  float sum = 0.0f;
  for_each_neighbor_walk(
      i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk, c,
      [&](int j, float d0, float d1, float d2, float sq) {
        if (material[j] < 0) return;
        const PairGeom p = pair_geom(sq);
        const float gradw = cubic_grad(p.rn, p.inv, c);
        const float a_xy = (ai[0] - accel[3 * j]) * d0 +
                           (ai[1] - accel[3 * j + 1]) * d1 +
                           (ai[2] - accel[3 * j + 2]) * d2;
        sum += m_V[j] * gradw * a_xy;
      });
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
// instantiation (pair_common.cuh with_walk).

extern "C" int iisph_nonpressure_kick_launch(
    const float* x, const float* v, const int* material, const float* m,
    const float* density, const int* starts, const int* slot_map, int layers,
    const float* dt, float* acc_out, float* v_out, PairConsts c,
    void* stream) {
  if (c.n_real > 0) {
    with_walk(starts, slot_map, layers, [&](auto walk) {
      iisph_nonpressure_kick_kernel<<<grid_for(c), kBlock, 0,
                                      (cudaStream_t)stream>>>(
          x, v, material, m, density, walk, dt, acc_out, v_out, c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int iisph_predict_advection_launch(
    const float* x, const float* v, const int* material, const float* m_V,
    const float* density, const float* pressure, const int* starts,
    const int* slot_map, int layers, const float* dt, float* a_ii_out,
    float* source_out, float* last_p_out, PairConsts c, void* stream) {
  if (c.n_real > 0) {
    with_walk(starts, slot_map, layers, [&](auto walk) {
      iisph_predict_advection_kernel<<<grid_for(c), kBlock, 0,
                                       (cudaStream_t)stream>>>(
          x, v, material, m_V, density, pressure, walk, dt, a_ii_out,
          source_out, last_p_out, c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int iisph_pressure_accel_launch(
    const float* x, const int* material, const float* m_V,
    const float* density, const float* pr, const int* starts,
    const int* slot_map, int layers, const float* v, const float* dt,
    const unsigned char* active, float* out0, float* out1, int advect,
    PairConsts c, void* stream) {
  if (c.n_real > 0) {
    with_walk(starts, slot_map, layers, [&](auto walk) {
      using Walk = decltype(walk);
      auto kernel = advect ? iisph_pressure_accel_kernel<true, Walk>
                           : iisph_pressure_accel_kernel<false, Walk>;
      kernel<<<grid_for(c), kBlock, 0, (cudaStream_t)stream>>>(
          x, material, m_V, density, pr, walk, v, dt, active, out0, out1, c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int iisph_apply_A_launch(
    const float* x, const int* material, const float* m_V,
    const float* accel, const float* a_ii, const float* source,
    const float* last_p, const int* starts, const int* slot_map, int layers,
    const float* dt, const unsigned char* active, float omega,
    float* new_p_out, float* err_out, PairConsts c, void* stream) {
  if (c.n_real > 0) {
    with_walk(starts, slot_map, layers, [&](auto walk) {
      iisph_apply_A_kernel<<<grid_for(c), kBlock, 0, (cudaStream_t)stream>>>(
          x, material, m_V, accel, a_ii, source, last_p, walk, dt, active,
          omega, new_p_out, err_out, c);
    });
  }
  return (int)cudaGetLastError();
}
