// Pair traversals of the PCISPH prediction-correction loop on Hopper
// (sm_90a), one thread per centre in cell-sorted order, over either
// candidate walk of pair_common.cuh.
//
// Replaces: the Pallas TPU kernel BlockEngine._kernel
// (sph_taichi_tpu/ops/pallas_blocks.py, launched by BlockEngine.traverse) in
// its two specializations on the PCISPH path (sph_taichi_tpu/models/pcisph.py):
//   pcisph_d_rho_correct           <- _d_rho with its correction epilogue:
//                                     div = sum_j m_V_j dW (v*_i - v*_j) . r_ij
//                                     over real j, then on fluid rows
//                                     rho_err = max(rho + dt rho0 div - rho0, 0)
//                                     and p' = max(p + s_f rho_err, 0)
//   pcisph_pressure_accel_predict  <- _pressure_accel with its predict
//                                     epilogue: the symmetric pressure
//                                     acceleration a_p (sym_pressure_pair,
//                                     solid mirror), then on fluid rows
//                                     v*' = v + dt (acc + a_p) and
//                                     x*' = x + dt v*' (x the step start)
// and the retired SlotEngine._kernel
// (sph_taichi_tpu/ops/retired/pallas_slots.py) in the same two: each kernel
// is a template over its walk, CellRunWalk (the cell offsets) or SlotWalk
// (the slot map of ops/slots.py), as in pairs.cu.
//
// Every traversal of the loop runs at the predicted positions x* while the
// binning stays that of the step start (the fixed-neighbour-list PCISPH):
// a pair counts if j != i and |x_i - x_j|^2 < h^2 at the step-start
// positions, and its term is evaluated at x*.
// That is the plain engine's contract: its neighbour lists are built once
// per step, and it evaluates the geometry at the positions it is given.
// The walk is the step's: the cell offsets or the slot map of the
// step-start positions, for every iteration of the loop.  (The TPU slot
// kernel masks on the distance at x*, pallas_slots.py:526; the port keeps
// the plain engine's pair set under both walks.)
//
// Each epilogue is the unfused chain of the plain versions in
// ops/cuda_pcisph.py, in the same operation order; dt and s_f are read from
// device memory.  Both kernels take the loop's device flag `active` and
// return at once when it is 0 (models/base.py jacobi_while).  Only fluid
// centres walk their neighbours.  Every row has a thread, padding rows
// included, and the kernels write the padding rows themselves (p' and
// rho_err 0, v*' and x*' from v and x, as restore_tail gives them), so each
// wrapper launches one kernel and nothing else.
//
// Over both walks the pairs come from the step's pair list
// (pair_common.cuh for_each_listed_pair): the loop's pair set is the step
// start's, which the step's density kernel accepted, so the density
// kernel (pairs.cu: density_sum_list_kernel over the cell runs,
// build_pair_list; density_sum_slot_kernel over the slot walk, in its
// one-phase walk) writes every real centre's accepted j, in the walk's
// order, to a fixed-stride list in device memory as it sums, and g1 and g2
// run only the pair body over the fluid rows of it, 8 list entries loaded
// ahead, every iteration.  A warp holding a centre with more accepted
// pairs than the list holds walks the cells or the slot map in one phase
// (for_each_neighbor_pinned), in the same order.  (The un-kicked
// non-pressure kernel before the loop, dfsph.cu, reads the same list over
// both walks.)
//
// What bounds them on an H100: the one-phase walk ran ~220 lockstep
// candidate iterations per warp for ~29 accepted pairs per lane at the
// dragon_bath state, latency-bound on candidate loads that mostly hit
// L1/L2, and ran the body in ~94 of them; the list walk runs max-over-lanes
// of the accepted count (~30.5 per warp there), latency-bound on the
// body's gathers, so its registers (46-52; the occupancy) and the list
// loads in flight set its time.  The f32 work per real pair (25-45
// operations) is far below the card's rate.  Everything stays in
// registers.  Over the slot walk the list instantiations take 55 and 62
// registers (9 and 8 resident blocks per SM; 52 and 48 over the cell
// runs).

#include "pair_common.cuh"

template <typename Walk>
__global__ void pcisph_d_rho_correct_kernel(
    const float* __restrict__ x, const float* __restrict__ xp,
    const float* __restrict__ vp, const int* __restrict__ material,
    const float* __restrict__ m_V, const float* __restrict__ density,
    const float* __restrict__ pr, Walk walk, PairList pl,
    const float* __restrict__ dt_ptr, const float* __restrict__ sf_ptr,
    const unsigned char* __restrict__ active, float* __restrict__ pr_out,
    float* __restrict__ err_out, int n_rows, PairConsts c) {
  if (active != nullptr && !*active) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool fluid = i < c.n_real && material[i] == 1;
  float vi0 = 0.0f, vi1 = 0.0f, vi2 = 0.0f;
  if (fluid) vi0 = vp[3 * i], vi1 = vp[3 * i + 1], vi2 = vp[3 * i + 2];
  float div = 0.0f;
  // the loop's walk: the pairs of the step-start positions x with the
  // geometry at the predicted positions xp
  for_each_step_pair(
      fluid, i, x, xp, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float s) {
        if (material[j] < 0) return;
        const PairGeom p = pair_geom(s);
        const float gradw = cubic_grad(p.rn, p.inv, c);
        const float v_xy = (vi0 - vp[3 * j]) * d0 +
                           (vi1 - vp[3 * j + 1]) * d1 +
                           (vi2 - vp[3 * j + 2]) * d2;
        div += m_V[j] * gradw * v_xy;
      });
  if (i >= n_rows) return;
  if (!fluid) {
    pr_out[i] = 0.0f;
    err_out[i] = 0.0f;
    return;
  }
  // the correction (pcisph.py:93-104): the free-surface clamp of the
  // density error, then the pressure update, in the plain order
  const float d_rho = div * c.rho0;
  const float rho_err = fmaxf(density[i] + *dt_ptr * d_rho - c.rho0, 0.0f);
  pr_out[i] = fmaxf(pr[i] + *sf_ptr * rho_err, 0.0f);
  err_out[i] = rho_err;
}

template <typename Walk>
__global__ void pcisph_pressure_accel_predict_kernel(
    const float* __restrict__ x, const float* __restrict__ xp,
    const int* __restrict__ material, const float* __restrict__ m_V,
    const float* __restrict__ density, const float* __restrict__ pr,
    const float* __restrict__ v, const float* __restrict__ acc, Walk walk,
    PairList pl, const float* __restrict__ dt_ptr,
    const unsigned char* __restrict__ active, float* __restrict__ v_out,
    float* __restrict__ x_out, int n_rows, PairConsts c) {
  if (active != nullptr && !*active) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // only the fluid rows' acceleration is read (pcisph.py:158-168, :245)
  const bool fluid = i < c.n_real && material[i] == 1;
  float s[3] = {0.0f, 0.0f, 0.0f};
  sym_pressure_sum(fluid, i, x, xp, material, m_V, density, pr, walk, pl,
                   c, s);
  if (i >= n_rows) return;
  const float dt = *dt_ptr;
  for (int k = 0; k < 3; ++k) {
    const float vk = v[3 * i + k];
    const float xk = x[3 * i + k];
    const float vn = fluid ? vk + dt * (acc[3 * i + k] + s[k]) : vk;
    v_out[3 * i + k] = vn;
    x_out[3 * i + k] = fluid ? xk + dt * vn : xk;
  }
}

extern "C" int pcisph_pair_list_entries() { return kPairListEntries; }

// Each loop launcher's walk arguments (starts, slot_map, layers) select the
// instantiation (pair_common.cuh with_walk); the list (list_idx,
// list_cnt) is the step's density_sum_list output over the same walk for
// the same rows, read over both walks, and a launch without it is refused
// (cudaErrorInvalidValue, pair_common.cuh has_step_list).

extern "C" int pcisph_d_rho_correct_launch(
    const float* x, const float* xp, const float* vp, const int* material,
    const float* m_V, const float* density, const float* pr,
    const int* starts, const int* slot_map, int layers, const int* list_idx,
    const int* list_cnt, const float* dt, const float* s_f,
    const unsigned char* active, float* pr_out, float* err_out, int n_rows,
    PairConsts c, void* stream) {
  if (!has_step_list(list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      pcisph_d_rho_correct_kernel<<<rows_grid(n_rows), kBlock, 0,
                                    (cudaStream_t)stream>>>(
          x, xp, vp, material, m_V, density, pr, walk, pl, dt, s_f, active,
          pr_out, err_out, n_rows, c);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int pcisph_pressure_accel_predict_launch(
    const float* x, const float* xp, const int* material, const float* m_V,
    const float* density, const float* pr, const float* v, const float* acc,
    const int* starts, const int* slot_map, int layers, const int* list_idx,
    const int* list_cnt, const float* dt, const unsigned char* active,
    float* v_out, float* x_out, int n_rows, PairConsts c, void* stream) {
  if (!has_step_list(list_idx, list_cnt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const PairList pl{list_idx, list_cnt, n_rows};
    with_walk(starts, slot_map, layers, [&](auto walk) {
      pcisph_pressure_accel_predict_kernel<<<rows_grid(n_rows), kBlock, 0,
                                             (cudaStream_t)stream>>>(
          x, xp, material, m_V, density, pr, v, acc, walk, pl, dt, active,
          v_out, x_out, n_rows, c);
    });
  }
  return (int)cudaGetLastError();
}

// Registers per thread, static shared memory per block and resident blocks
// per SM of kernel ``which``: 0 d_rho_correct, 1 pressure_accel_predict
// (+ 2: over the slot walk; both walks over the step's list).
extern "C" int pcisph_occupancy(int which, int* regs, int* smem_bytes,
                                int* blocks_per_sm) {
  const void* kernels[4] = {
      (const void*)pcisph_d_rho_correct_kernel<CellRunWalk>,
      (const void*)pcisph_pressure_accel_predict_kernel<CellRunWalk>,
      (const void*)pcisph_d_rho_correct_kernel<SlotWalk>,
      (const void*)pcisph_pressure_accel_predict_kernel<SlotWalk>};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
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
