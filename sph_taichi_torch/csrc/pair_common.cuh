// Device code shared by the pair-traversal kernels (pairs.cu, dfsph.cu,
// iisph.cu, pcisph.cu): the constants struct, the cubic-spline kernel and
// its gradient, the neighbour walk (over cell runs or over the slot map,
// and its form with the pair geometry at other positions), its two-phase
// form (compact_cell_runs), the step's pair list (build_pair_list,
// for_each_listed_pair, for_each_step_pair, for_each_jacobi_pair), the
// viscosity and pressure pair terms, and the symmetric pressure
// acceleration of the implicit solvers.
//
// Contract (sph_taichi_torch/ops/pairs.py): out[i] = sum over j != i with
// |x_i - x_j|^2 < h^2 of term(i, j).  Each centre walks the 9 (dx, dy)
// neighbour columns; in each, the z-cells iz-1..iz+1 clipped to the grid.
// The cell-run walk reads them as ONE contiguous range of the sorted
// arrays, starts[flat(zlo)] .. starts[flat(zhi) + 1]; the slot walk reads
// the same particles from the slot map (ops/slots.py), z-cells ascending
// and each cell's slots in rank order, which is the sorted order.  That is
// exactly the candidate order of the plain engine's neighbour lists
// (ops/neighbors.py, ops/slots.py: offsets in itertools.product order, dz
// innermost, then sorted order within a cell), and sums go into registers
// in that order: no atomics, deterministic.  The cell-run walk has no cap;
// the slot walk sees the first 8 * layers particles of a cell.
//
// Rounding follows the plain path that pinned the goldens: inclusion on the
// raw sum of squares, self excluded by index, rn = sqrtf(sum), d2 = rn*rn,
// inv = 1/sqrtf(max(d2, 1e-38)), no rsqrtf; the centre's cell is computed
// unclipped from the host's f32 reciprocal of the cell size (cell_x for x).
// Built with -fmad=false and without fast math so no product is contracted
// into an FMA.

#pragma once

#include <type_traits>

#include <cuda_runtime.h>

// Mirror: PairConsts in sph_taichi_torch/ops/cuda_pairs.py, field for field.
struct PairConsts {
  int n_real, nx, ny, nz;
  int x_origin;     // the grid's first global x-layer (0 on one device)
  float inv_cell;   // f32(1) / f32(cell size), computed on the host
  float h2;         // f32(h * h)
  float inv_h;      // f32(1 / h)
  float kw, kw2;    // W normalization k and f32(k * 2)
  float kg, nkg;    // gradient prefactor 6k and f32(-6k)
  // WCSPH force term and the non-pressure term
  float diam2, wd;  // f32(diameter^2), W(diameter)
  float st;         // surface tension coefficient
  float dvisc;      // f32(2 (dim + 2) * viscosity)
  float eps_h2;     // f32(0.01 h h)
  float neg_rho0, rho0;
  // epilogue
  float g0, g1, g2;
  float lo, hi0, hi1, hi2;  // padded box: pad and f32(size) - f32(pad)
  float cf1;                // 1 + collision factor
  // DFSPH
  float w0;         // W(0)
  float min_nbr;    // particle-deficiency cutoff: 20 (3D) / 7 (2D)
  float m_eps;      // stiffness gate 1e-5
  // IISPH
  float rho0sq;     // f32(rho0 * rho0)
};

__device__ __forceinline__ float cubic_w(float rn, const PairConsts& c) {
  float q = rn * c.inv_h;
  float q2 = q * q;
  float q3 = q2 * q;
  float w_near = c.kw * (6.0f * q3 - 6.0f * q2 + 1.0f);
  float omq = 1.0f - q;
  float w_far = c.kw2 * omq * omq * omq;
  float res = (q <= 0.5f) ? w_near : w_far;
  return (q <= 1.0f) ? res : 0.0f;
}

__device__ __forceinline__ float cubic_grad(float rn, float inv_r,
                                            const PairConsts& c) {
  float q = rn * c.inv_h;
  float inv_rh = inv_r * c.inv_h;
  float near_ = c.kg * q * (3.0f * q - 2.0f) * inv_rh;
  float fac = 1.0f - q;
  float far_ = c.nkg * fac * fac * inv_rh;
  float res = (q <= 0.5f) ? near_ : far_;
  return (rn > 1e-5f && q <= 1.0f) ? res : 0.0f;
}

// (rn, d2, inv) of a pair from its raw sum of squares, as the plain
// engine's pair_geometry rounds them.
struct PairGeom {
  float rn, r2, inv;
};

__device__ __forceinline__ PairGeom pair_geom(float s) {
  PairGeom g;
  g.rn = sqrtf(s);
  g.r2 = g.rn * g.rn;
  g.inv = 1.0f / sqrtf(fmaxf(g.r2, 1e-38f));
  return g;
}

// The x-layer of a centre's cell on the grid the arrays are sorted over:
// trunc(x / cell) less the grid's first global x-layer (SimParams.x_origin:
// 0 on one device; a slab of a sharded run, parallel/sharding.py, sorts over
// its own extended grid).  The subtraction is an integer one after the f32
// product, so no position is shifted.  Each coordinate is capped first, so
// that a padding row parked at 1e9 (the cast saturates there), which a slab
// may walk as a centre (n_real is the global count), lies far outside every
// grid with no integer overflow.
constexpr int kFarCell = 1 << 29;

// trunc(x / cell), capped at kFarCell: the y and z coordinates of a cell.
__device__ __forceinline__ int cell_coord(float x, const PairConsts& c) {
  return min((int)(x * c.inv_cell), kFarCell);
}

__device__ __forceinline__ int cell_x(float x, const PairConsts& c) {
  return cell_coord(x, c) - c.x_origin;
}

// The two candidate walks.  column(cx, cy, zlo, zhi, c, g) calls g(j) for
// the particles of the z-cells zlo..zhi of column (cx, cy), in sorted order.

// The cell-run walk: the column's z-cells are one range of the sorted
// arrays, given by the cell offsets (ops/grid.py cell_offsets).
struct CellRunWalk {
  const int* starts;
  template <typename G>
  __device__ __forceinline__ void column(int cx, int cy, int zlo, int zhi,
                                         const PairConsts& c, G&& g) const {
    const int base = (cx * c.ny + cy) * c.nz;
    const int b = starts[base + zlo];
    const int e = starts[base + zhi + 1];
    for (int j = b; j < e; ++j) g(j);
  }
};

// The slot walk over the map i32[layers, nx, ny, nz * 8] of ops/slots.py:
// the particle of rank r in a cell sits in layer r / 8, slot r % 8, and an
// empty slot holds -1.  Ranks fill a cell's slots in order, so the first
// empty slot ends the cell.  A cell's 8 layer-0 slots are 32 contiguous
// bytes, and a column's z-run of three cells 96.
struct SlotWalk {
  const int* map;
  int layers;
  template <typename G>
  __device__ __forceinline__ void column(int cx, int cy, int zlo, int zhi,
                                         const PairConsts& c, G&& g) const {
    const long long layer_stride = 8LL * c.nx * c.ny * c.nz;
    const int* col = map + 8LL * ((long long)cx * c.ny + cy) * c.nz;
    for (int cz = zlo; cz <= zhi; ++cz) {
      const int* cell = col + 8 * cz;
      for (int l = 0; l < layers; ++l, cell += layer_stride) {
        int s = 0;
        for (; s < 8; ++s) {
          const int j = cell[s];
          if (j < 0) break;
          g(j);
        }
        if (s < 8) break;
      }
    }
  }
};

// Calls f(j, d0, d1, d2, s) for every j != i within h of centre i, in the
// plain engine's order, over the candidates of ``walk``.
template <typename Walk, typename F>
__device__ __forceinline__ void for_each_neighbor_walk(
    int i, float xi0, float xi1, float xi2, const float* __restrict__ x,
    const Walk& walk, const PairConsts& c, F&& f) {
  const int ix = cell_x(xi0, c);
  const int iy = cell_coord(xi1, c);
  const int iz = cell_coord(xi2, c);
  const int zlo = max(iz - 1, 0);
  const int zhi = min(iz + 1, c.nz - 1);
  if (zlo > zhi) return;
  for (int dx = -1; dx <= 1; ++dx) {
    const int cx = ix + dx;
    if (cx < 0 || cx >= c.nx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int cy = iy + dy;
      if (cy < 0 || cy >= c.ny) continue;
      walk.column(cx, cy, zlo, zhi, c, [&](int j) {
        if (j == i) return;
        const float d0 = xi0 - x[3 * j];
        const float d1 = xi1 - x[3 * j + 1];
        const float d2 = xi2 - x[3 * j + 2];
        const float s = d0 * d0 + d1 * d1 + d2 * d2;
        if (!(s < c.h2)) return;
        f(j, d0, d1, d2, s);
      });
    }
  }
}

// The pairs of for_each_neighbor_walk at the positions x (cell and
// inclusion), with the pair geometry taken at the positions xg: f(j, d0,
// d1, d2, s) gets d = xg_i - xg_j and its raw sum of squares.  PCISPH
// evaluates its loop's terms at the predicted positions over the step-start
// pair set (the plain engine's step-start neighbour lists); a pair that
// moves beyond h gets a zero gradient from cubic_grad.  ``walk`` is over the
// step-start candidates (cell offsets or slot map of x).
template <typename Walk, typename F>
__device__ __forceinline__ void for_each_neighbor_pinned(
    int i, const float* __restrict__ x, const float* __restrict__ xg,
    const Walk& walk, const PairConsts& c, F&& f) {
  const float g0 = xg[3 * i], g1 = xg[3 * i + 1], g2 = xg[3 * i + 2];
  for_each_neighbor_walk(
      i, x[3 * i], x[3 * i + 1], x[3 * i + 2], x, walk, c,
      [&](int j, float, float, float, float) {
        const float d0 = g0 - xg[3 * j];
        const float d1 = g1 - xg[3 * j + 1];
        const float d2 = g2 - xg[3 * j + 2];
        f(j, d0, d1, d2, d0 * d0 + d1 * d1 + d2 * d2);
      });
}

// ---------------------------------------------------------------------------
// The two-phase walk: the pairs of for_each_neighbor_walk, in the same order
// and with the same (d0, d1, d2, s), with the accepted pairs compacted
// before the pair body (compact_cell_runs).
//
// One thread per centre walking its candidates and running the pair body
// wherever its test accepts leaves most lanes of a warp masked off in the
// body: at dragon_bath_dfsph a warp's 32 centres accept ~30 of ~220
// candidates each, at different iterations, and the warp runs the body in
// ~120 of its ~227 candidate iterations.  Over the cell-run walk
// (compact_cell_runs) the walk has two phases:
// - the candidate phase runs the inclusion test alone (j != i, raw sum of
//   squares < h^2) over the columns in for_each_neighbor_walk's order and
//   appends each accepted candidate to the thread's list in shared memory;
//   the warp steps through each column's runs together, kCompactUnroll
//   candidates per lane at a time, their loads in flight together;
// - the body phase runs f over each lane's list in list order, for the
//   whole warp: at the end of the walk, and before a block of candidates
//   where a list has fewer than kCompactUnroll entries free (one vote per
//   block), so a centre has any number of neighbours and keeps its order.
// tools/jacobi_walk_control.py times the Jacobi kernels over this walk
// against one-phase walks with and without the batched candidate loads.
// The slot walk does not take it: with a list, its dependent map loads
// lose the L1 that the list's shared memory takes, and it measured several
// times slower on an H100.  Over the slot walk the Jacobi kernels read the
// step's pair list instead (for_each_jacobi_pair, below).
//
// Every thread of a block calls it, with ``walks`` false where the thread
// has no centre: the warp-wide votes need all 32 lanes.
// ---------------------------------------------------------------------------

// Threads per block of every pair kernel.
static const int kBlock = 128;
// Candidates a lane tests between two checks of the lists: their positions
// are loaded together, before the tests, so their loads are in flight
// together.
constexpr int kCompactUnroll = 8;
// Accepted pairs a thread's list holds: ~31 per centre at
// dragon_bath_dfsph, so most lists flush only at the end; 20,480 bytes of
// shared memory per block.
constexpr int kListEntries = 40;
static_assert(kListEntries >= kCompactUnroll,
              "a block of candidates must fit an emptied list");

// Whether ``Walk`` takes the two-phase walk: the cell-run walk (above).
template <typename Walk>
constexpr bool kCompactWalk = std::is_same<Walk, CellRunWalk>::value;

// The candidate phase of the two-phase walk over the cell runs: the
// inclusion test at the positions x, over the columns in
// for_each_neighbor_walk's order, the warp stepping through each column's
// runs together.  accept(j, d0, d1, d2, s) takes each accepted candidate,
// its displacement x_i - x_j and its raw sum of squares in that order, as
// for_each_neighbor_walk gives them to its body; before_block() runs,
// warp-uniform, before each block of kCompactUnroll candidates, whose loads
// are in flight together.
template <typename B, typename A>
__device__ __forceinline__ void cell_run_candidates(
    bool walks, int i, float xi0, float xi1, float xi2,
    const float* __restrict__ x, const CellRunWalk& walk,
    const PairConsts& c, B&& before_block, A&& accept) {
  const unsigned kFull = 0xffffffffu;
  int ix = 0, iy = 0, zlo = 0, zhi = -1;
  if (walks) {
    ix = cell_x(xi0, c);
    iy = cell_coord(xi1, c);
    const int iz = cell_coord(xi2, c);
    zlo = max(iz - 1, 0);
    zhi = min(iz + 1, c.nz - 1);
    walks = zlo <= zhi;
  }
  for (int k = 0; k < 9; ++k) {
    // the warp steps through the lanes' runs of column k together, so that
    // a list that may fill flushes every lane's list at once
    const int cx = ix + k / 3 - 1, cy = iy + k % 3 - 1;
    int b = 0, len = 0;
    if (walks && cx >= 0 && cx < c.nx && cy >= 0 && cy < c.ny) {
      const int base = (cx * c.ny + cy) * c.nz;
      b = walk.starts[base + zlo];
      len = walk.starts[base + zhi + 1] - b;
    }
    const int steps = __reduce_max_sync(kFull, len);
    for (int t = 0; t < steps; t += kCompactUnroll) {
      before_block();
      // the block's positions loaded together, then the test alone
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
        if (s < c.h2) accept(j, d0, d1, d2, s);
      }
    }
  }
}

// The two-phase walk over the cell runs (see above).
template <typename F>
__device__ __forceinline__ void compact_cell_runs(
    bool walks, int i, float xi0, float xi1, float xi2,
    const float* __restrict__ x, const CellRunWalk& walk,
    const PairConsts& c, F&& f) {
  // entry k of thread t at lists[k * kBlock + t]: the lanes of a warp hit
  // 32 banks
  __shared__ int lists[kListEntries * kBlock];
  const unsigned kFull = 0xffffffffu;
  int* list = lists + threadIdx.x;
  int cnt = 0;
  // the body phase over this lane's list
  auto flush = [&]() {
    for (int k = 0; k < cnt; ++k) {
      const int j = list[k * kBlock];
      const float d0 = xi0 - x[3 * j];
      const float d1 = xi1 - x[3 * j + 1];
      const float d2 = xi2 - x[3 * j + 2];
      f(j, d0, d1, d2, d0 * d0 + d1 * d1 + d2 * d2);
    }
    cnt = 0;
  };
  cell_run_candidates(
      walks, i, xi0, xi1, xi2, x, walk, c,
      [&]() {
        // room for the block's candidates in every list
        if (__any_sync(kFull, cnt > kListEntries - kCompactUnroll)) flush();
      },
      [&](int j, float, float, float, float) {
        list[(cnt++) * kBlock] = j;
      });
  flush();
}

// ---------------------------------------------------------------------------
// The step's pair list.  On the WCSPH, IISPH and PCISPH steps the
// positions stay the sort's from the density kernel to the advect (IISPH's
// f1 kick and PCISPH's loop move v or the predicted positions, not x), and
// every later pair kernel's centres are a subset of the density kernel's
// (every real row), so they all accept the density kernel's pairs: PCISPH's
// loop (inclusion at the step-start positions, each iteration evaluating
// its terms at new positions) and non-pressure kernel, IISPH's four
// kernels, WCSPH's force kernel.  The density kernel, density_sum_list
// (pairs.cu), runs the candidate phase of the two-phase walk
// (build_pair_list), sums the density in its accept and writes each real
// centre's accepted j, in the walk's order, to a list in device memory;
// the later kernels run only their body phase over it
// (for_each_listed_pair), every loop iteration too.  The same holds on the
// DFSPH step from the density-and-factor kernel to the non-pressure kernel
// (the solves before it move v, not x): dfsph_density_factor_list
// (dfsph.cu) writes the fluid centres' list as it sums, and
// nonpressure_kick reads it; over the slot walk the DFSPH step's
// density-and-factor kernel writes a list of the fluid and dynamic-rigid
// centres in its one-phase walk, and the Jacobi kernels (divergence,
// solver_dv) and the non-pressure kernel read it (for_each_jacobi_pair,
// for_each_step_pair).  Over the slot walk the WCSPH, IISPH and PCISPH
// steps' density kernel (density_sum_slot_kernel, pairs.cu) writes every
// real centre's list in its one-phase walk, and every later pair kernel of
// those steps reads it (for_each_step_pair): WCSPH's forces (b), PCISPH's
// loop kernels (g1, g2) and un-kicked non-pressure kernel (d), IISPH's
// four kernels (f1-f4).
//
// Layout: entry k of centre i at idx[k * stride + i] (stride: the rows of
// the arrays), so a warp's load of entry k is one 128-byte line; cnt[i] is
// the centre's number of accepted pairs, also beyond kPairListEntries,
// where the list holds the first kPairListEntries.  A warp holding such a
// centre walks the cells instead (the same pairs in the same order): no
// pair is dropped and no centre has a limit.  A kernel reads the counts of
// the centres it walks only, so a list of every real centre serves a
// kernel over the fluid centres.
// ---------------------------------------------------------------------------

// Accepted pairs the list holds per centre: a dragon_bath state accepts at
// most 32 per fluid centre (chip_smoke's walk profiles; 58 at the dynamic
// dragon's contact); 64 leaves room for compression and contact at 256
// bytes per row.
constexpr int kPairListEntries = 64;

struct PairList {
  const int* idx;   // i32[kPairListEntries, stride]
  const int* cnt;   // i32[stride]
  int stride;
};

// The candidate phase of compact_cell_runs for centre i (if ``walks``),
// writing its accepted j to the list and its count to cnt[i] (0 where the
// centre does not walk; rows i >= stride write nothing), and calling
// f(j, d0, d1, d2, s) on each accepted pair, in the walk's order, with
// for_each_neighbor_walk's displacement and raw sum of squares (WCSPH's
// density_sum_list sums its density there, DFSPH's
// dfsph_density_factor_list its density and factor terms).  Every thread
// of a block calls it: the walk steps warp-wide.
template <typename F>
__device__ __forceinline__ void build_pair_list(
    bool walks, int i, const float* __restrict__ x, const CellRunWalk& walk,
    const PairConsts& c, int* __restrict__ idx, int* __restrict__ cnt,
    int stride, F&& f) {
  float xi0 = 0.0f, xi1 = 0.0f, xi2 = 0.0f;
  if (walks) xi0 = x[3 * i], xi1 = x[3 * i + 1], xi2 = x[3 * i + 2];
  int n = 0;
  cell_run_candidates(
      walks, i, xi0, xi1, xi2, x, walk, c, []() {},
      [&](int j, float d0, float d1, float d2, float s) {
        if (n < kPairListEntries) idx[n * stride + i] = j;
        ++n;
        f(j, d0, d1, d2, s);
      });
  if (i < stride) cnt[i] = n;
}

// List entries a lane loads before their pairs' bodies: their neighbours'
// loads then do not wait on one list load each (1, 4 and 8 measured: 8 the
// fastest, tools/pcisph_walk_control.py).
constexpr int kListUnroll = 8;

// f(j, d0, d1, d2, s) over the pairs of for_each_neighbor_pinned, in its
// order: read from the step's list ``pl``, or, in a warp that holds a
// centre beyond the list, by the one-phase pinned walk over ``walk`` (the
// cell runs or the slot map).
// (The two-phase walk there took the kernels to 70-74 registers and their
// list walk a third slower; tools/pcisph_walk_control.py.)  Every thread
// of a block calls it, with ``walks`` false where the thread has no
// centre; (gi0, gi1, gi2) is xg_i.
template <typename Walk, typename F>
__device__ __forceinline__ void for_each_listed_pair(
    bool walks, int i, const float* __restrict__ x, float gi0, float gi1,
    float gi2, const float* __restrict__ xg, const PairList& pl,
    const Walk& walk, const PairConsts& c, F&& f) {
  const int n = walks ? pl.cnt[i] : 0;
  if (__any_sync(0xffffffffu, n > kPairListEntries)) {
    if (walks) for_each_neighbor_pinned(i, x, xg, walk, c, f);
    return;
  }
  for (int k = 0; k < n; k += kListUnroll) {
    int j[kListUnroll];
#pragma unroll
    for (int u = 0; u < kListUnroll; ++u) {
      j[u] = (k + u < n) ? pl.idx[(k + u) * pl.stride + i] : i;
    }
#pragma unroll
    for (int u = 0; u < kListUnroll; ++u) {
      if (k + u >= n) break;
      const float d0 = gi0 - xg[3 * j[u]];
      const float d1 = gi1 - xg[3 * j[u] + 1];
      const float d2 = gi2 - xg[3 * j[u] + 2];
      f(j[u], d0, d1, d2, d0 * d0 + d1 * d1 + d2 * d2);
    }
  }
}

// The list walk of for_each_step_pair (the tools/*_walk_control.cu
// controls define it to theirs before including this header).
#ifndef PAIR_LIST_WALK
#define PAIR_LIST_WALK for_each_listed_pair
#endif

// The walk of a loop over the step start's pair set: the pairs of the
// positions x with the geometry at xg (for_each_neighbor_pinned; WCSPH's
// forces, IISPH and the non-pressure kernel pass xg = x, and then d and the
// raw sum of squares are those of for_each_neighbor_walk), read from the
// step's list ``pl`` over either walk.  b (pairs.cu), g1 and g2
// (pcisph.cu) and f1-f4 (iisph.cu) read the list that the density kernel
// writes (pairs.cu density_sum_list, density_sum_slot_kernel over the slot
// walk), d (dfsph.cu) that one on the PCISPH step and e1's on the DFSPH
// step.  A warp that holds a centre beyond the list walks the cells or the
// slot map in one phase, pinned (for_each_listed_pair), which with xg = x
// gives the pairs, d and raw sum of squares of for_each_neighbor_walk.
// Their launchers refuse a launch without the list (has_step_list).  Every
// thread of a block calls it, with ``walks`` false where the thread has no
// centre.
template <typename Walk, typename F>
__device__ __forceinline__ void for_each_step_pair(
    bool walks, int i, const float* __restrict__ x,
    const float* __restrict__ xg, const Walk& walk, const PairList& pl,
    const PairConsts& c, F&& f) {
  float gi0 = 0.0f, gi1 = 0.0f, gi2 = 0.0f;
  if (walks) gi0 = xg[3 * i], gi1 = xg[3 * i + 1], gi2 = xg[3 * i + 2];
  PAIR_LIST_WALK(walks, i, x, gi0, gi1, gi2, xg, pl, walk, c, f);
}

// f(j, d0, d1, d2, s) for the pairs of for_each_neighbor_walk, in its
// order, for DFSPH's Jacobi kernels: in two phases over the cell-run walk
// (compact_cell_runs; no list), and over the slot walk read from the
// step's list ``pl``, which the step's density-and-factor kernel writes
// for the Jacobi kernels' centres, fluid and dynamic rigid
// (for_each_listed_pair with xg = x: the same displacement and raw sum of
// squares; a warp that holds a centre beyond the list walks the slot map
// in one phase).  Every thread of a block calls it, with ``walks`` false
// where the thread has no centre; (xi0, xi1, xi2) is x_i where it walks.
template <typename Walk, typename F>
__device__ __forceinline__ void for_each_jacobi_pair(
    bool walks, int i, float xi0, float xi1, float xi2,
    const float* __restrict__ x, const Walk& walk, const PairList& pl,
    const PairConsts& c, F&& f) {
  if constexpr (kCompactWalk<Walk>) {
    compact_cell_runs(walks, i, xi0, xi1, xi2, x, walk, c, f);
  } else {
    for_each_listed_pair(walks, i, x, xi0, xi1, xi2, x, pl, walk, c, f);
  }
}

// Viscosity coefficient of a fluid pair (sph_base.py:70-78), in the
// operation order of every solver's term: 2 (dim + 2) mu (m_j / rho_j)
// (v_ij . r_ij) / (r^2 + 0.01 h^2) * dW/r.  ``m_over_rho`` is m_j / rho_j.
__device__ __forceinline__ float viscosity_coef(float m_over_rho, float v_xy,
                                                float r2, float gradw,
                                                const PairConsts& c) {
  return c.dvisc * m_over_rho * v_xy / (r2 + c.eps_h2) * gradw;
}

// Pressure coefficient of a pair: -rho0 m_V_j (dpi + dpj) dW/r, where dpi
// is p_i / rho_i^2 and dpj is p_j / rho_j^2 for a fluid neighbour or the
// boundary mirror for a solid one (WCSPH.py:47-66).
__device__ __forceinline__ float pressure_coef(float m_V_j, float dpi,
                                               float dpj, float gradw,
                                               const PairConsts& c) {
  return c.neg_rho0 * m_V_j * (dpi + dpj) * gradw;
}

// The pair term of the symmetric pressure acceleration (IISPH's and
// PCISPH's _pressure_accel): adds pressure_coef * r_ij into s[0..2] for a
// fluid or solid j, with dpi = p_i / rho_i^2 and the solid mirror
// p_j / rho_j^2 := p_i / rho0^2 (``mirror``).
__device__ __forceinline__ void sym_pressure_pair(
    int j, float d0, float d1, float d2, float sq, float dpi, float mirror,
    const int* __restrict__ material, const float* __restrict__ m_V,
    const float* __restrict__ density, const float* __restrict__ pr,
    const PairConsts& c, float s[3]) {
  const int mat_j = material[j];
  if (mat_j != 0 && mat_j != 1) return;
  const PairGeom p = pair_geom(sq);
  const float gradw = cubic_grad(p.rn, p.inv, c);
  const float rho_j = density[j];
  const float dpj = (mat_j == 1) ? pr[j] / (rho_j * rho_j) : mirror;
  const float a = pressure_coef(m_V[j], dpi, dpj, gradw, c);
  s[0] += a * d0;
  s[1] += a * d1;
  s[2] += a * d2;
}

// Symmetric pressure acceleration of centre i (if ``walks``) from the
// pressure field pr (IISPH's and PCISPH's _pressure_accel, one term) over
// the pairs of for_each_step_pair: adds into s[0..2].  Every thread of a
// block calls it.
template <typename Walk>
__device__ __forceinline__ void sym_pressure_sum(
    bool walks, int i, const float* __restrict__ x,
    const float* __restrict__ xg, const int* __restrict__ material,
    const float* __restrict__ m_V, const float* __restrict__ density,
    const float* __restrict__ pr, const Walk& walk, const PairList& pl,
    const PairConsts& c, float s[3]) {
  float dpi = 0.0f, mirror = 0.0f;
  if (walks) {
    const float pr_i = pr[i];
    const float rho_i = density[i];
    dpi = pr_i / (rho_i * rho_i);
    mirror = pr_i / c.rho0sq;
  }
  for_each_step_pair(
      walks, i, x, xg, walk, pl, c,
      [&](int j, float d0, float d1, float d2, float sq) {
        sym_pressure_pair(j, d0, d1, d2, sq, dpi, mirror, material, m_V,
                          density, pr, c, s);
      });
}


__host__ inline int grid_for(const PairConsts& c) {
  return (c.n_real + kBlock - 1) / kBlock;
}

// Grid of a kernel over ``n_rows`` rows, padding rows included.
__host__ inline int rows_grid(int n_rows) {
  return (n_rows + kBlock - 1) / kBlock;
}

// Whether a launch of a kernel that reads the step's list (b, d, f1-f4,
// g1, g2) has it: list_idx and list_cnt.
__host__ inline bool has_step_list(const int* list_idx, const int* list_cnt) {
  return list_idx != nullptr && list_cnt != nullptr;
}

// The walk a launcher's arguments select: every launcher takes the cell
// offsets ``starts`` and, for the slot walk, the slot map and its layer
// count.  Calls go(walk) with the SlotWalk for a non-null ``slot_map``,
// else with the CellRunWalk, so ``go`` launches the kernel's instantiation
// over that walk.
template <typename Go>
__host__ inline void with_walk(const int* starts, const int* slot_map,
                               int layers, Go&& go) {
  if (slot_map) {
    go(SlotWalk{slot_map, layers});
  } else {
    go(CellRunWalk{starts});
  }
}
