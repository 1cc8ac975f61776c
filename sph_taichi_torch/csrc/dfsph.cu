// Pair traversals of the DFSPH step on Hopper (sm_90a), one thread per
// centre in cell-sorted order, over either candidate walk of
// pair_common.cuh.
//
// Replaces: the Pallas TPU kernel BlockEngine._kernel
// (sph_taichi_tpu/ops/pallas_blocks.py, launched by BlockEngine.traverse) in
// its specializations on the DFSPH path:
//   dfsph_density_factor   <- models/dfsph.py density_and_factor (density
//                             and the alpha factor in one walk), which
//                             also writes the step's pair list (below):
//                             dfsph_density_factor_list over the cell runs,
//                             dfsph_density_factor_slot over the slot walk
//   dfsph_divergence<ADV>  <- models/dfsph.py _density_change (ADV = false)
//                             and _density_adv (ADV = true), each with the
//                             per-centre error column of the Jacobi test
//   dfsph_solver_dv<REACT> <- models/dfsph.py _solver_dv, with the unfused
//                             update v + (dt * dv) on fluid centres and,
//                             with REACT, acc + reaction on dynamic rigids
//   nonpressure_kick<KICK> <- models/base.py compute_non_pressure_forces
//                             with the acceleration select and, with KICK
//                             (DFSPH), the velocity kick v += dt * acc of
//                             its epilogue; without it (PCISPH) acc only
// and the retired SlotEngine._kernel
// (sph_taichi_tpu/ops/retired/pallas_slots.py) in the same four: each
// kernel is a template over its walk, CellRunWalk (the cell offsets) or
// SlotWalk (the slot map of ops/slots.py), as in pairs.cu.
//
// Each epilogue is the unfused chain of the plain versions in
// ops/cuda_dfsph.py, in the same operation order.  Every kernel has a
// thread for every row and writes the padding rows itself (density passed
// through and factor 0; 0 in adv and errt; v passed through and acc 0 or
// passed through), so its wrapper launches one kernel and nothing else.
//
// The Jacobi kernels (divergence, solver_dv) take an optional device flag
// `active`: when it is 0 the launch returns at once and writes nothing, and
// the solver's loop discards that iteration's outputs (models/dfsph.py
// jacobi_while).  Iterations queued past convergence then cost a launch,
// not a traversal.
//
// What bounds them on an H100: as pairs.cu, irregular candidate loads that
// mostly hit L1/L2; the f32 work per real pair (20-60 operations) is far
// below the card's rate.  Everything stays in registers.  The Jacobi
// kernels, which a DFSPH step launches ~15 times, walk the cell runs in two
// phases (pair_common.cuh compact_cell_runs): the inclusion test alone
// over the candidates, several candidates' loads in flight per lane, then
// the pair body over the compacted accepted pairs, so the warp runs the
// body with most lanes busy; over the slot walk they read the step's pair
// list (below).
//
// The step's pair list over the cell runs: the positions do not move from
// the density-and-factor kernel to the non-pressure kernel (the divergence
// solve between them moves v), and both walk the fluid centres, so both
// accept the same pairs.  dfsph_density_factor_list runs the candidate
// phase of the two-phase walk (pair_common.cuh build_pair_list), adds each
// accepted pair's density, gradient and squared-gradient terms in the
// walk's order (the sums of the one-phase walk, bitwise) and writes every
// fluid centre's accepted j to the step's pair list; nonpressure_kick then
// runs only its pair body over the list (for_each_step_pair), so the
// one-phase candidate walk, where most lanes of a warp sit masked off in
// the ~60-operation body, runs once per step, not twice.  On the PCISPH
// step nonpressure_kick<false> reads the fluid rows of the step's list,
// which density_sum_list (pairs.cu) writes.  A warp holding a centre with
// more accepted pairs than the list holds walks the cells in one phase
// (the same pairs in the same order).  Over the cell runs the Jacobi
// kernels keep their two-phase walk.  nonpressure_kick reads the list over
// both walks (for_each_step_pair, below).
//
// Over the slot walk the list goes to the Jacobi kernels too: the solves
// move v, not x, so every Jacobi launch of the step accepts e1's pairs.
// dfsph_density_factor_slot keeps its one-phase walk and its sums and
// writes the accepted j of every centre of the Jacobi kernels as it
// walks: the fluid centres and, for the reaction variant of solver_dv,
// the dynamic-rigid ones (which it walks for their list alone).
// dfsph_divergence and dfsph_solver_dv run only their pair body over the
// list (pair_common.cuh for_each_jacobi_pair), and so does nonpressure_kick
// after the divergence solve (its fluid rows: the centres it walks).  On
// the PCISPH step over the slot walk nonpressure_kick<false> reads the
// fluid rows of the list that density_sum_slot_kernel (pairs.cu) writes.
// A warp holding a centre over the list walks the slot map in one phase,
// pinned with xg = x (the pairs, d and raw sum of squares of the one-phase
// walk).

#include "pair_common.cuh"

// The density-and-factor terms of one accepted pair, added into the
// centre's sums (den, g0..g2, sq).
__device__ __forceinline__ void density_factor_pair(
    int j, float d0, float d1, float d2, float s,
    const int* __restrict__ material, const float* __restrict__ m_V,
    const PairConsts& c, float& den, float& g0, float& g1, float& g2,
    float& sq) {
  const int mat_j = material[j];
  if (mat_j < 0) return;
  const PairGeom p = pair_geom(s);
  const float mvj = m_V[j];
  den += mvj * cubic_w(p.rn, c);
  const float gcoef = -mvj * cubic_grad(p.rn, p.inv, c);
  const float ng = -gcoef;
  g0 += ng * d0;
  g1 += ng * d1;
  g2 += ng * d2;
  if (mat_j == 1) sq += gcoef * gcoef * p.r2;
}

// The epilogue of row i: the density and factor of a fluid centre from its
// sums; any other row keeps its density and gets factor 0.
__device__ __forceinline__ void density_factor_out(
    int i, bool fluid, float den, float g0, float g1, float g2, float sq,
    const float* __restrict__ m_V, const float* __restrict__ density_in,
    float* __restrict__ density_out, float* __restrict__ factor_out,
    const PairConsts& c) {
  if (fluid) {
    density_out[i] = (m_V[i] * c.w0 + den) * c.rho0;
    const float s = sq + g0 * g0 + g1 * g1 + g2 * g2;
    factor_out[i] = (s > 1e-6f) ? -1.0f / s : 0.0f;
  } else {
    density_out[i] = density_in[i];
    factor_out[i] = 0.0f;
  }
}

// Over the slot walk for the DFSPH step: the sums of the one-phase walk,
// and the accepted pairs of every fluid and dynamic-rigid centre (the
// Jacobi kernels' centres) written to the step's list as it walks, as
// build_pair_list writes them over the cell runs (idx, cnt; cnt 0 on
// other rows).  One thread per row: padding rows keep their density and
// get factor 0.
__global__ void dfsph_density_factor_slot_kernel(
    const float* __restrict__ x, const int* __restrict__ material,
    const int* __restrict__ is_dyn, const float* __restrict__ m_V,
    const float* __restrict__ density_in, SlotWalk walk,
    int* __restrict__ idx, int* __restrict__ cnt,
    float* __restrict__ density_out, float* __restrict__ factor_out,
    int n_rows, PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int mat_i = i < c.n_real ? material[i] : -1;
  const bool fluid = mat_i == 1;
  const bool listed = fluid || (mat_i == 0 && is_dyn[i] != 0);
  float den = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, sq = 0.0f;
  int n = 0;
  if (listed) {
    for_each_neighbor_walk(
        i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk, c,
        [&](int j, float d0, float d1, float d2, float s) {
          if (n < kPairListEntries) idx[n * n_rows + i] = j;
          ++n;
          if (fluid) {
            density_factor_pair(j, d0, d1, d2, s, material, m_V, c, den,
                                g0, g1, g2, sq);
          }
        });
  }
  cnt[i] = n;
  density_factor_out(i, fluid, den, g0, g1, g2, sq, m_V, density_in,
                     density_out, factor_out, c);
}

// Over the cell runs for the DFSPH step: the same sums, and every fluid
// centre's accepted pairs written to the step's list (idx, cnt; cnt 0 on
// other rows).  One thread per row: padding rows keep their density and
// get factor 0.
__global__ void dfsph_density_factor_list_kernel(
    const float* __restrict__ x, const int* __restrict__ material,
    const float* __restrict__ m_V, const float* __restrict__ density_in,
    CellRunWalk walk, int* __restrict__ idx, int* __restrict__ cnt,
    float* __restrict__ density_out, float* __restrict__ factor_out,
    int n_rows, PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool fluid = i < c.n_real && material[i] == 1;
  float den = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, sq = 0.0f;
  build_pair_list(fluid, i, x, walk, c, idx, cnt, n_rows,
                  [&](int j, float d0, float d1, float d2, float s) {
                    density_factor_pair(j, d0, d1, d2, s, material, m_V, c,
                                        den, g0, g1, g2, sq);
                  });
  if (i >= n_rows) return;
  density_factor_out(i, fluid, den, g0, g1, g2, sq, m_V, density_in,
                     density_out, factor_out, c);
}

// The Jacobi kernels take the step's list ``pl`` last: the cell-run
// instantiations do not read it.
template <bool ADV, typename Walk>
__global__ void dfsph_divergence_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const int* __restrict__ material, const float* __restrict__ m_V,
    const float* __restrict__ density, Walk walk,
    const float* __restrict__ dt_ptr, const unsigned char* __restrict__ active,
    float* __restrict__ adv_out, float* __restrict__ errt_out, int n_rows,
    PairConsts c, PairList pl) {
  if (active != nullptr && !*active) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool fluid = i < c.n_real && material[i] == 1;
  float div = 0.0f, cnt = 0.0f;
  float xi0 = 0.0f, xi1 = 0.0f, xi2 = 0.0f, vi0 = 0.0f, vi1 = 0.0f,
        vi2 = 0.0f;
  if (fluid) {
    xi0 = x[3 * i], xi1 = x[3 * i + 1], xi2 = x[3 * i + 2];
    vi0 = v[3 * i], vi1 = v[3 * i + 1], vi2 = v[3 * i + 2];
  }
  for_each_jacobi_pair(
      fluid, i, xi0, xi1, xi2, x, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float s) {
        if (material[j] < 0) return;
        const PairGeom p = pair_geom(s);
        const float gradw = cubic_grad(p.rn, p.inv, c);
        const float v_xy = (vi0 - v[3 * j]) * d0 +
                           (vi1 - v[3 * j + 1]) * d1 +
                           (vi2 - v[3 * j + 2]) * d2;
        div += m_V[j] * gradw * v_xy;
        cnt += 1.0f;
      });
  if (i >= n_rows) return;
  // padding rows (i >= n_real) are not fluid: adv and errt 0
  float adv, errt;
  if (ADV) {
    adv = density[i] / c.rho0 + *dt_ptr * div;
    adv = fmaxf(adv, 1.0f);
    adv = fluid ? adv : 0.0f;
    errt = fluid ? c.rho0 * adv - c.rho0 : 0.0f;
  } else {
    adv = fmaxf(div, 0.0f);
    if (cnt < c.min_nbr) adv = 0.0f;
    adv = fluid ? adv : 0.0f;
    errt = fluid ? c.rho0 * adv : 0.0f;
  }
  adv_out[i] = adv;
  errt_out[i] = errt;
}

template <bool REACT, typename Walk>
__global__ void dfsph_solver_dv_kernel(
    const float* __restrict__ x, const int* __restrict__ material,
    const int* __restrict__ is_dyn, const float* __restrict__ m_V,
    const float* __restrict__ kappa, const float* __restrict__ density,
    const float* __restrict__ v, const float* __restrict__ acc, Walk walk,
    const float* __restrict__ dt_ptr,
    const unsigned char* __restrict__ active, float* __restrict__ v_out,
    float* __restrict__ acc_out, int n_rows, PairConsts c, PairList pl) {
  if (active != nullptr && !*active) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int mat_i = i < c.n_real ? material[i] : -1;
  const bool fluid = mat_i == 1;
  // is_dynamic and density are read by the reaction variant only
  const bool dynr = REACT && mat_i == 0 && is_dyn[i] != 0;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  // the sum is read by fluid centres (dv) and, with the reaction, by
  // dynamic-rigid ones; one radial output carries either, selected by the
  // centre's material
  const bool walks = fluid || (REACT && dynr);
  float xi0 = 0.0f, xi1 = 0.0f, xi2 = 0.0f, k_i = 0.0f, q_i = 0.0f;
  if (walks) {
    xi0 = x[3 * i], xi1 = x[3 * i + 1], xi2 = x[3 * i + 2];
    k_i = kappa[i];
    q_i = REACT ? m_V[i] / fmaxf(density[i], 1e-30f) : 0.0f;
  }
  for_each_jacobi_pair(
      walks, i, xi0, xi1, xi2, x, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float s) {
        const int mat_j = material[j];
        const bool fluid_j = mat_j == 1;
        const bool solid_j = mat_j == 0;
        if (!fluid_j && !solid_j) return;
        const PairGeom p = pair_geom(s);
        const float gradw = cubic_grad(p.rn, p.inv, c);
        const float k_j = kappa[j];
        float a;
        if (REACT && !fluid) {
          // gather form of the reference's reaction scatter
          // (DFSPH.py:388-389)
          a = (fluid_j && fabsf(k_j) > c.m_eps)
                  ? (k_j * density[j]) * gradw * q_i
                  : 0.0f;
        } else {
          const float k_sum = k_i + k_j;
          const float cf = (fluid_j && fabsf(k_sum) > c.m_eps)
                               ? k_sum * m_V[j] * gradw
                               : 0.0f;
          const float cs = (solid_j && fabsf(k_i) > c.m_eps)
                               ? k_i * m_V[j] * gradw
                               : 0.0f;
          a = cf + cs;
        }
        s0 += a * d0;
        s1 += a * d1;
        s2 += a * d2;
      });
  if (i >= n_rows) return;
  // padding rows (i >= n_real) are neither fluid nor dynamic rigid: v and
  // acc pass through
  const float dt = *dt_ptr;
  const float sums[3] = {s0, s1, s2};
  for (int k = 0; k < 3; ++k) {
    const float vk = v[3 * i + k];
    v_out[3 * i + k] = fluid ? vk + dt * sums[k] : vk;
    if (REACT) {
      const float ak = acc[3 * i + k];
      acc_out[3 * i + k] = dynr ? ak + sums[k] : ak;
    }
  }
}

// One thread per row, padding rows included (acc 0, v carried through).
// Over both walks the pairs come from the step's list ``pl``: e1's on the
// DFSPH step (dfsph_density_factor_list over the cell runs,
// dfsph_density_factor_slot over the slot walk), the density kernel's on
// the PCISPH step (pairs.cu density_sum_list).
template <bool KICK, typename Walk>
__global__ void nonpressure_kick_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const int* __restrict__ material, const int* __restrict__ is_dyn,
    const float* __restrict__ m, const float* __restrict__ density,
    Walk walk, PairList pl, const float* __restrict__ dt_ptr,
    float* __restrict__ acc_out, float* __restrict__ v_out, int n_rows,
    PairConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < c.n_real;
  const int mat_i = real ? material[i] : -1;
  const bool fluid = mat_i == 1;
  float vi[3] = {0.0f, 0.0f, 0.0f};
  float neg_st_mi = 0.0f;
  if (fluid) {
    vi[0] = v[3 * i], vi[1] = v[3 * i + 1], vi[2] = v[3 * i + 2];
    neg_st_mi = -(c.st / m[i]);
  }
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for_each_step_pair(
      fluid, i, x, x, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float s) {
        // surface tension and viscosity act between fluid particles
        // only; the boundary viscosity is 0.0 (DFSPH.py:80)
        if (material[j] != 1) return;
        const PairGeom p = pair_geom(s);
        const float gradw = cubic_grad(p.rn, p.inv, c);
        const float w_st = (p.r2 > c.diam2) ? cubic_w(p.rn, c) : c.wd;
        const float st_coef = neg_st_mi * m[j] * w_st;
        const float v_xy = (vi[0] - v[3 * j]) * d0 +
                           (vi[1] - v[3 * j + 1]) * d1 +
                           (vi[2] - v[3 * j + 2]) * d2;
        const float visc_coef =
            viscosity_coef(m[j] / density[j], v_xy, p.r2, gradw, c);
        const float a = st_coef + visc_coef;
        s0 += a * d0;
        s1 += a * d1;
        s2 += a * d2;
      });
  if (i >= n_rows) return;
  // the rows that did not walk load their velocity here (read with KICK
  // only)
  if (KICK && !fluid) {
    vi[0] = v[3 * i], vi[1] = v[3 * i + 1], vi[2] = v[3 * i + 2];
  }
  const bool solid = mat_i == 0;
  const bool dyn = real && is_dyn[i] != 0;
  // epilogue: acceleration select (padding rows 0), then with KICK the
  // fluid kick v += dt * acc (dt and v_out are not read without it)
  const float dt = KICK ? *dt_ptr : 0.0f;
  const float g[3] = {c.g0, c.g1, c.g2};
  const float sums[3] = {s0, s1, s2};
  for (int k = 0; k < 3; ++k) {
    float a = g[k] + (fluid ? sums[k] : 0.0f);
    if (solid && !dyn) a = 0.0f;
    if (!real) a = 0.0f;
    acc_out[3 * i + k] = a;
    if (KICK) v_out[3 * i + k] = (fluid && dyn) ? vi[k] + dt * a : vi[k];
  }
}

extern "C" int dfsph_pair_list_entries() { return kPairListEntries; }

// e1 with the step's list, over the walk its arguments select (cell
// offsets ``starts``, or the slot map ``slot_map`` of ``layers`` layers;
// ``is_dyn`` is read over the slot walk only, whose list also holds the
// dynamic-rigid centres).  The list ``idx`` is i32[kPairListEntries,
// n_rows]; ``cnt``, the density and the factor have n_rows rows.
extern "C" int dfsph_density_factor_list_launch(
    const float* x, const int* material, const int* is_dyn,
    const float* m_V, const float* density_in, const int* starts,
    const int* slot_map, int layers, int* idx, int* cnt, float* density_out,
    float* factor_out, int n_rows, PairConsts c, void* stream) {
  if (n_rows > 0) {
    if (slot_map) {
      dfsph_density_factor_slot_kernel<<<rows_grid(n_rows), kBlock, 0,
                                         (cudaStream_t)stream>>>(
          x, material, is_dyn, m_V, density_in, SlotWalk{slot_map, layers},
          idx, cnt, density_out, factor_out, n_rows, c);
    } else {
      dfsph_density_factor_list_kernel<<<rows_grid(n_rows), kBlock, 0,
                                         (cudaStream_t)stream>>>(
          x, material, m_V, density_in, CellRunWalk{starts}, idx, cnt,
          density_out, factor_out, n_rows, c);
    }
  }
  return (int)cudaGetLastError();
}

// The Jacobi and non-pressure launchers' walk arguments (starts, slot_map,
// layers) select the instantiation (pair_common.cuh with_walk).  Over the
// slot walk the Jacobi kernels read the step's list (list_idx, list_cnt),
// which dfsph_density_factor_list_launch writes there, and a launch
// without it is refused (cudaErrorInvalidValue); over the cell runs they
// read no list.  The non-pressure kernel reads the list over both walks
// (nonpressure_launch, below).

// Whether a Jacobi launch has what its walk reads: the step's list over
// the slot walk; over the cell runs nothing beyond the offsets.
static bool has_jacobi_inputs(const int* slot_map, const int* list_idx,
                              const int* list_cnt) {
  return slot_map == nullptr || has_step_list(list_idx, list_cnt);
}

extern "C" int dfsph_divergence_launch(
    const float* x, const float* v, const int* material, const float* m_V,
    const float* density, const int* starts, const int* slot_map,
    int layers, const int* list_idx, const int* list_cnt, const float* dt,
    const unsigned char* active, float* adv_out, float* errt_out, int adv,
    int n_rows, PairConsts c, void* stream) {
  if (!has_jacobi_inputs(slot_map, list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      using Walk = decltype(walk);
      auto kernel = adv ? dfsph_divergence_kernel<true, Walk>
                        : dfsph_divergence_kernel<false, Walk>;
      kernel<<<rows_grid(n_rows), kBlock, 0, (cudaStream_t)stream>>>(
          x, v, material, m_V, density, walk, dt, active, adv_out, errt_out,
          n_rows, c, pl);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int dfsph_solver_dv_launch(
    const float* x, const int* material, const int* is_dyn, const float* m_V,
    const float* kappa, const float* density, const float* v,
    const float* acc, const int* starts, const int* slot_map, int layers,
    const int* list_idx, const int* list_cnt, const float* dt,
    const unsigned char* active, float* v_out, float* acc_out, int react,
    int n_rows, PairConsts c, void* stream) {
  if (!has_jacobi_inputs(slot_map, list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      using Walk = decltype(walk);
      auto kernel = react ? dfsph_solver_dv_kernel<true, Walk>
                          : dfsph_solver_dv_kernel<false, Walk>;
      kernel<<<rows_grid(n_rows), kBlock, 0, (cudaStream_t)stream>>>(
          x, material, is_dyn, m_V, kappa, density, v, acc, walk, dt, active,
          v_out, acc_out, n_rows, c, pl);
    });
  }
  return (int)cudaGetLastError();
}

// Registers per thread, static shared memory per block and resident blocks
// per SM of the Jacobi kernels' instantiation ``which`` (bit 0: ADV or
// REACT; bit 1: solver_dv; bit 2: slot walk, over the step's list).
extern "C" int dfsph_jacobi_occupancy(int which, int* regs, int* smem_bytes,
                                      int* blocks_per_sm) {
  const void* kernels[8] = {
      (const void*)dfsph_divergence_kernel<false, CellRunWalk>,
      (const void*)dfsph_divergence_kernel<true, CellRunWalk>,
      (const void*)dfsph_solver_dv_kernel<false, CellRunWalk>,
      (const void*)dfsph_solver_dv_kernel<true, CellRunWalk>,
      (const void*)dfsph_divergence_kernel<false, SlotWalk>,
      (const void*)dfsph_divergence_kernel<true, SlotWalk>,
      (const void*)dfsph_solver_dv_kernel<false, SlotWalk>,
      (const void*)dfsph_solver_dv_kernel<true, SlotWalk>};
  const void* kernel = kernels[which & 7];
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

// Registers per thread, static shared memory per block and resident blocks
// per SM of kernel ``which``: 0 density_factor_list, 1 density_factor_slot
// (both with the list), 2 nonpressure_kick<true>, 3
// nonpressure_kick<false> (over the cell runs; 4, 5 over the slot walk).
extern "C" int dfsph_occupancy(int which, int* regs, int* smem_bytes,
                               int* blocks_per_sm) {
  const void* kernels[6] = {
      (const void*)dfsph_density_factor_list_kernel,
      (const void*)dfsph_density_factor_slot_kernel,
      (const void*)nonpressure_kick_kernel<true, CellRunWalk>,
      (const void*)nonpressure_kick_kernel<false, CellRunWalk>,
      (const void*)nonpressure_kick_kernel<true, SlotWalk>,
      (const void*)nonpressure_kick_kernel<false, SlotWalk>};
  if (which < 0 || which > 5) return (int)cudaErrorInvalidValue;
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

// nonpressure_kick_launch (KICK) and nonpressure_accel_launch (acc only,
// dt and v_out null).  Over both walks the kernel reads the step's list
// (list_idx, list_cnt) for the same rows; a launch without it is refused
// (cudaErrorInvalidValue, pair_common.cuh has_step_list).  It launches over
// n_rows rows, padding rows included.
template <bool KICK>
static int nonpressure_launch(const float* x, const float* v,
                              const int* material, const int* is_dyn,
                              const float* m, const float* density,
                              const int* starts, const int* slot_map,
                              int layers, const int* list_idx,
                              const int* list_cnt, const float* dt,
                              float* acc_out, float* v_out, int n_rows,
                              PairConsts c, void* stream) {
  if (!has_step_list(list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      nonpressure_kick_kernel<KICK, decltype(walk)>
          <<<rows_grid(n_rows), kBlock, 0, (cudaStream_t)stream>>>(
              x, v, material, is_dyn, m, density, walk, pl, dt, acc_out,
              v_out, n_rows, c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int nonpressure_kick_launch(
    const float* x, const float* v, const int* material, const int* is_dyn,
    const float* m, const float* density, const int* starts,
    const int* slot_map, int layers, const int* list_idx,
    const int* list_cnt, const float* dt, float* acc_out, float* v_out,
    int n_rows, PairConsts c, void* stream) {
  return nonpressure_launch<true>(x, v, material, is_dyn, m, density, starts,
                                  slot_map, layers, list_idx, list_cnt, dt,
                                  acc_out, v_out, n_rows, c, stream);
}

extern "C" int nonpressure_accel_launch(
    const float* x, const float* v, const int* material, const int* is_dyn,
    const float* m, const float* density, const int* starts,
    const int* slot_map, int layers, const int* list_idx,
    const int* list_cnt, float* acc_out, int n_rows, PairConsts c,
    void* stream) {
  return nonpressure_launch<false>(x, v, material, is_dyn, m, density,
                                   starts, slot_map, layers, list_idx,
                                   list_cnt, nullptr, acc_out, nullptr,
                                   n_rows, c, stream);
}
