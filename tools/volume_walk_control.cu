// Kernel c (the boundary volume) of sph_taichi_torch/csrc/pairs.cu with its
// launcher replaced by a control, for chip_smoke.py: the kernels' source is
// included as it is, its boundary_volume_launch renamed, and this file's
// boundary_volume_launch, with the same signature, launches the design that
// control_volume_group selects, over either walk:
// - 1: a thread per target (boundary_volume_thread_kernel: the shipped
//   design over the slot map, and kernel c's design over the cell runs
//   before it took a warp per target);
// - 8, 16 or 32: a group of that many lanes per target
//   (boundary_volume_group_kernel below: the shipped warp design over the
//   cell runs, boundary_volume_warp_kernel, written for any group and
//   either walk);
// - 0 (the default): the shipped launch.
// Every design adds a target's solid W terms in the walk's order, so every
// result equals the shipped kernel's bitwise.  The other launchers are the
// shipped ones.
// Build: nvcc <the flags of ops/_build.py> -I sph_taichi_torch/csrc
//        tools/volume_walk_control.cu

#define boundary_volume_launch shipped_boundary_volume_launch
#include "pairs.cu"
#undef boundary_volume_launch

// G lanes of a warp that share one target.
template <int G>
struct VolumeGroup {
  static_assert(G == 8 || G == 16 || G == 32, "a group is 8, 16 or 32 lanes");
  int lane;        // lane in the group
  int base;        // the group's first lane in the warp
  unsigned mask;   // the group's lanes in the warp

  __device__ VolumeGroup() {
    lane = threadIdx.x & (G - 1);
    base = (threadIdx.x & 31) & ~(G - 1);
    mask = (G == 32) ? 0xffffffffu : (((1u << (G & 31)) - 1u) << base);
  }
  // the lanes of the group where ``p`` holds, as bits of the group's lanes
  __device__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask, p) & mask) >> base;
  }
  template <typename T>
  __device__ T from(T v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
};

// The group's walk of column (cx, cy), z-cells zlo..zhi: step(has, j)
// gets the group's next G candidates in the walk's order, lane k the k-th
// (has false past the column's end), every lane of the group together.
// Over the cell runs: G candidates of the column's z-run a round.
template <int G, typename S>
__device__ __forceinline__ void group_column(const CellRunWalk& walk,
                                             const VolumeGroup<G>& g, int cx,
                                             int cy, int zlo, int zhi,
                                             const PairConsts& c, S&& step) {
  const int base = (cx * c.ny + cy) * c.nz;
  const int b = walk.starts[base + zlo];
  const int e = walk.starts[base + zhi + 1];
  for (int j0 = b; j0 < e; j0 += G) {
    const int j = j0 + g.lane;
    step(j < e, j);
  }
}

// Over the slot map: G / 8 layers of one cell a round, lane k at rank
// l0 * 8 + k; the cell ends at its first empty slot (a lane past the map's
// layers counts as empty), as SlotWalk::column ends it.
template <int G, typename S>
__device__ __forceinline__ void group_column(const SlotWalk& walk,
                                             const VolumeGroup<G>& g, int cx,
                                             int cy, int zlo, int zhi,
                                             const PairConsts& c, S&& step) {
  const long long layer_stride = 8LL * c.nx * c.ny * c.nz;
  const int* col = walk.map + 8LL * ((long long)cx * c.ny + cy) * c.nz;
  const int slot = g.lane & 7;
  for (int cz = zlo; cz <= zhi; ++cz) {
    for (int l0 = 0; l0 < walk.layers; l0 += G / 8) {
      const int l = l0 + (g.lane >> 3);
      const int j = (l < walk.layers) ? col[l * layer_stride + 8 * cz + slot]
                                      : -1;
      const unsigned empty = g.ballot(j < 0);
      const int first = empty ? __ffs(empty) - 1 : G;
      step(g.lane < first, j);
      if (empty) break;
    }
  }
}

// boundary_volume_warp_kernel for a group of G lanes over ``Walk``.
template <int G, typename Walk>
__global__ void boundary_volume_group_kernel(
    const float* __restrict__ x, const int* __restrict__ material, Walk walk,
    const int* __restrict__ targets, int n_targets, float* __restrict__ m_V,
    PairConsts c) {
  const VolumeGroup<G> g;
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  int i = -1, ix = 0, iy = 0, zlo = 0, zhi = -1;
  float xi0 = 0.0f, xi1 = 0.0f, xi2 = 0.0f;
  if (g.lane == 0 && t < n_targets) {
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
  i = g.from(i, 0);
  ix = g.from(ix, 0), iy = g.from(iy, 0);
  zlo = g.from(zlo, 0), zhi = g.from(zhi, 0);
  xi0 = g.from(xi0, 0), xi1 = g.from(xi1, 0), xi2 = g.from(xi2, 0);
  float sum = 0.0f;
  auto step = [&](bool has, int j) {
    float w = 0.0f;
    bool take = false;
    if (has) {
      const float d0 = xi0 - x[3 * j];
      const float d1 = xi1 - x[3 * j + 1];
      const float d2 = xi2 - x[3 * j + 2];
      const int mat = material[j];
      const float s = d0 * d0 + d1 * d1 + d2 * d2;
      take = j != i && s < c.h2 && mat == 0;
      if (take) w = cubic_w(sqrtf(s), c);
    }
    for (unsigned bits = g.ballot(take); bits; bits &= bits - 1) {
      sum += g.from(w, __ffs(bits) - 1);
    }
  };
  if (i >= 0 && zlo <= zhi) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int cx = ix + dx;
      if (cx < 0 || cx >= c.nx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int cy = iy + dy;
        if (cy < 0 || cy >= c.ny) continue;
        group_column(walk, g, cx, cy, zlo, zhi, c, step);
      }
    }
  }
  if (g.lane == 0 && i >= 0) m_V[i] = 3.0f / (c.w0 + sum);
}

template <int G, typename Walk>
__host__ void launch_volume_group(const float* x, const int* material,
                                  Walk walk, const int* targets,
                                  int n_targets, float* m_V,
                                  const PairConsts& c, cudaStream_t stream) {
  const long long threads = (long long)n_targets * G;
  const int grid = (int)((threads + kBlock - 1) / kBlock);
  boundary_volume_group_kernel<G, Walk><<<grid, kBlock, 0, stream>>>(
      x, material, walk, targets, n_targets, m_V, c);
}

static int control_group = 0;

extern "C" int control_volume_group(int group) {
  switch (group) {
    case 0: case 1: case 8: case 16: case 32:
      control_group = group;
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int boundary_volume_launch(const float* x, const int* material,
                                      const int* starts, const int* slot_map,
                                      int layers, const int* targets,
                                      int n_targets, float* m_V, PairConsts c,
                                      void* stream) {
  if (control_group == 0) {
    return shipped_boundary_volume_launch(x, material, starts, slot_map,
                                          layers, targets, n_targets, m_V, c,
                                          stream);
  }
  if (n_targets > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    with_walk(starts, slot_map, layers, [&](auto walk) {
      switch (control_group) {
        case 1:
          launch_volume_thread(x, material, walk, targets, n_targets, m_V, c,
                               s);
          break;
        case 8:
          launch_volume_group<8>(x, material, walk, targets, n_targets, m_V,
                                 c, s);
          break;
        case 16:
          launch_volume_group<16>(x, material, walk, targets, n_targets, m_V,
                                  c, s);
          break;
        default:
          launch_volume_group<32>(x, material, walk, targets, n_targets, m_V,
                                  c, s);
      }
    });
  }
  return (int)cudaGetLastError();
}

// Registers per thread, static shared memory per block and resident blocks
// per SM of the design not shipped on each walk: a thread per target over
// the cell runs (0), the group of 32 over the slot map (1).
extern "C" int control_volume_occupancy(int which, int* regs,
                                        int* smem_bytes, int* blocks_per_sm) {
  const void* kernels[2] = {
      (const void*)boundary_volume_thread_kernel<CellRunWalk>,
      (const void*)boundary_volume_group_kernel<32, SlotWalk>};
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernels[which]);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernels[which], kBlock, 0);
  }
  *regs = attr.numRegs;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)err;
}
