// K3: one Jacobi pass of circle separation over the legacy bordered solver
// grid, returning displacements, as a tiled pass over occupied slots.
//
// Replaces the TPU kernel multithreadedgameengine_tpu/ops/pallas_kernels.py
// `pair_pass_pallas` -> `_pair_kernel`, the pair pass of
// ops/physics_grid.py::run_solver_substeps with solver="pallas" (the
// spatial-domain halo step's solver). It computes what that kernel computes,
// in the same order: for each slot i of an interior cell, the 9 cell offsets
// (dr, dc in -1..1, row-major), then neighbour slots j ascending,
// accumulating each overlapping pair's push into a register. The caller adds
// the displacement to the positions.
//
// One deliberate difference: the TPU wrapper cuts the grid's one-row border
// away and pads zero rows in its place (pallas_kernels.py:814-825), so the
// TPU kernel never sees the halo rows the halo step writes there and misses
// every contact across a slab seam. This kernel reads rows 0 and R+1 as
// neighbours, as the XLA formulation of the same solver does
// (physics_grid.py:247-252).
//
// Layout: the reference's grid, cell-major with the slot fastest.
// x, y: f32 [R+2, C+2, cap]; attrs: f32 [R+2, C+2, cap, 3] holding the
// radius, the flags as an exact small float (bits 1 collider, 2 trigger,
// 4 static, 8 moving; 0 = empty slot) and the global id as an exact float
// (-1 = empty). Outputs dx, dy (f32) and count (i32) of the grid's shape;
// every slot of the one-cell border, and every slot without a collider, gets
// 0.
//
// What bounds it on an H100: the function reads the flags of every slot
// (4 bytes) and x, y, radius and gid of each collider slot (16 bytes), and
// writes dx, dy and count for every slot (12 bytes): about 46 MB for one
// slab grid [136, 1203, 16] of the 1M-ball halo scene with four slabs (2.6M
// slots, some 250k of them colliders), about 14 us at 3.35 TB/s
// (chip_smoke.py::grid_bound). The pair work is far below the card's
// float32 rate: some 1.55 entities a cell, so about 14 candidate pairs a
// collider.
//
// The design (pair_tile.cuh):
// - A block takes a tile of TR x TC interior cells and stages the tile and
//   its one-cell ring (the box) in shared memory: x, y and attrs of every
//   slot, each box row one contiguous run of the grid, copied with 4-byte
//   cp.async so that a warp's copies coalesce into whole lines and every
//   copy of the block is in flight at once. The tile is chosen from cap so
//   that every box cell can be full, and made smaller for a grid too small
//   to give every SM a block (pair_tile::plan_tile); above what a 1 x 1
//   tile stages, the wrapper refuses the capacity.
// - Not TMA: a TMA box's inner dimension is at most 256 elements and a
//   multiple of 16 bytes, which `x` at a capacity that is not a multiple of
//   4 and `attrs` above capacity 85 are not; cp.async stages every
//   capacity the solver takes along one path.
// - While staging, one thread per box cell counts the cell's occupants:
//   ranks are dense within a cell (bin_entities; the halo step's border
//   fill copies whole rows), so occupied slots form a prefix, ended by the
//   first slot whose gid is -1. An occupied slot may hold a non-collider
//   (flags without bit 1); the slots after it still count. The same pass
//   decodes flags and gid to integers once.
// - A block-wide prefix sum over the tile's counts gives every thread an
//   occupied slot. It scans the 9 neighbour cells up to their counts, from
//   shared memory, and keeps its sums in shared memory. A cell's slots are
//   an odd number of words apart there, so that a warp's threads, reading
//   the same slot of different cells, do not collide on a bank.
// - The block then writes dx, dy and count for every slot of its tile, and
//   of the border cells next to it, in coalesced stores: zeros for empty
//   and non-collider slots. Every output has one writer; no atomics.
//
// Numerics: built with --fmad=false and without --use_fast_math, and the
// inverse distance is 1.0f / sqrtf(d2) (IEEE sqrt and division), so each
// operation rounds as the plain PyTorch version's does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_tile.cuh"

namespace {

using namespace pair_tile;

// A cell's slots in shared memory are `cap | 1` words apart for x, y and
// the results, and `3 cap | 1` for attrs: an odd stride, so that the threads
// of a warp, which read the same slot of different cells, hit different
// banks.
__host__ __device__ constexpr int slot_stride(int cap) { return cap | 1; }
__host__ __device__ constexpr int attr_stride(int cap) { return (3 * cap) | 1; }
// shared-memory words of a box cell (x, y, attrs) and of a tile cell (dx,
// dy, count)
size_t box_words(int cap) { return 2 * (size_t)slot_stride(cap) + attr_stride(cap); }
size_t tile_words(int cap) { return 3 * (size_t)slot_stride(cap); }

size_t g_granted[kMaxDevices];

__global__ void __launch_bounds__(kThreads) pair_pass_grid_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ attrs, float* __restrict__ disp_x,
    float* __restrict__ disp_y, int32_t* __restrict__ count, int rows,
    int cols, int cap, int tile_rows, int tile_cols, uint32_t salt,
    float strength) {
  extern __shared__ __align__(16) float smem[];
  const Box box(rows, cols, tile_rows, tile_cols);
  const int nb = box.nb;
  const int nt = box.nt;
  const int cs = slot_stride(cap);
  const int as = attr_stride(cap);
  float* sx = smem;                  // [nb][cs]
  float* sy = sx + nb * cs;          // [nb][cs]
  float* sa = sy + nb * cs;          // [nb][as]: (radius, flags, gid) per slot
  float* rx = sa + nb * as;          // [nt][cs]
  float* ry = rx + nt * cs;          // [nt][cs]
  int* rc = (int*)(ry + nt * cs);    // [nt][cs]
  int* gcell = rc + nt * cs;         // [nb]
  int* own = gcell + nb;             // [nb]
  int* cnt = own + nb;               // [nb]
  int* incl = cnt + nb;              // [nt]
  int* wsum = incl + nt;             // [32]

  // 1. stage the box: x and y slot by slot, attrs word by word
  box.index_cells(gcell, own);
  __syncthreads();
  for (Walk w(cap); w.outer < nb; w.next()) {
    const int g = gcell[w.outer];
    if (g >= 0) {
      const int e = w.outer * cs + w.inner;
      cp_async4(sx + e, x + g * cap + w.inner);
      cp_async4(sy + e, y + g * cap + w.inner);
    }
  }
  for (Walk w(3 * cap); w.outer < nb; w.next()) {
    const int g = gcell[w.outer];
    if (g >= 0) cp_async4(sa + w.outer * as + w.inner, attrs + g * 3 * cap + w.inner);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. each box cell's occupants: the slots before the first gid -1, whose
  //    flags and gid are decoded to integers in place
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int n = 0;
    if (gcell[b] >= 0) {
      n = cap;
      for (int j = 0; j < cap; ++j) {
        float* a = sa + b * as + 3 * j;
        if (a[2] == -1.0f) {
          n = j;
          break;
        }
        a[1] = __int_as_float((int32_t)a[1]);
        a[2] = __int_as_float((int32_t)a[2]);
      }
    }
    cnt[b] = n;
  }
  __syncthreads();

  // 3. hand out the tile's occupied slots
  const int t_self = threadIdx.x;
  int v = 0;
  if (t_self < nt) {
    const int b = box.box_cell(t_self);
    if (own[b] >= 0) v = cnt[b];
  }
  const int inc = block_inclusive_scan(v, wsum);
  if (t_self < nt) incl[t_self] = inc;
  const int total = wsum[(blockDim.x >> 5) - 1];
  __syncthreads();

  // 4. one thread per occupied slot: the 9 neighbour cells, row-major, each
  //    scanned to its count
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int t = find_cell(incl, nt, k);
    const int i = k - (t > 0 ? incl[t - 1] : 0);
    const int b = box.box_cell(t);
    const float* ai = sa + b * as + 3 * i;
    const int32_t fi = __float_as_int(ai[1]);
    float acc_x = 0.0f;
    float acc_y = 0.0f;
    int32_t acc_c = 0;
    if ((fi & 1) != 0) {
      const float xi = sx[b * cs + i];
      const float yi = sy[b * cs + i];
      const float ri = ai[0];
      const int32_t id_i = __float_as_int(ai[2]);
      const bool trig_i = (fi & 2) != 0;
      const bool st_i = (fi & 4) != 0;
      for (int dr = -1; dr <= 1; ++dr) {
        for (int dc = -1; dc <= 1; ++dc) {
          // border rows 0 and R+1 are read: they hold the neighbour slabs' rows
          const int nbc = b + dr * box.bc + dc;
          const int n_nb = cnt[nbc];
          const float* xn = sx + nbc * cs;
          const float* yn = sy + nbc * cs;
          const float* an = sa + nbc * as;
          for (int j = 0; j < n_nb; ++j) {
            // every field first, so that the loads issue together
            const int32_t fj = __float_as_int(an[3 * j + 1]);
            const int32_t id_j = __float_as_int(an[3 * j + 2]);
            const float rj = an[3 * j];
            const float dx = xi - xn[j];
            const float dy = yi - yn[j];
            if ((fj & 1) == 0 || id_j == id_i) continue;  // no collider, or itself
            const float d2 = dx * dx + dy * dy;
            const float min_d = ri + rj;
            if (!(d2 < min_d * min_d)) continue;

            const bool trig = trig_i || (fj & 2) != 0;
            const bool st_j = (fj & 4) != 0;
            float push_x, push_y;
            if (d2 == 0.0f) {
              // exactly coincident: pair-consistent hash direction
              float ux, uy;
              pair_hash_dir(id_i, id_j, salt, &ux, &uy);
              const float zmag = (trig || st_i) ? 0.0f : (st_j ? 2.0f : 1.0f);
              const float sign = id_i < id_j ? 1.0f : -1.0f;
              const float zshare = zmag * sign * 0.001f;
              push_x = ux * zshare;
              push_y = uy * zshare;
            } else {
              const float share = (trig || st_i) ? 0.0f : (st_j ? 1.0f : 0.5f);
              const float inv_dist = 1.0f / sqrtf(d2);
              const float dist = d2 * inv_dist;
              const float corr = (min_d - dist) * strength * share;
              push_x = dx * inv_dist * corr;
              push_y = dy * inv_dist * corr;
            }
            acc_x = acc_x + push_x;
            acc_y = acc_y + push_y;
            acc_c += 1;
          }
        }
      }
    }
    const int o = t * cs + i;
    rx[o] = acc_x;
    ry[o] = acc_y;
    rc[o] = acc_c;
  }
  __syncthreads();

  // 5. every slot of the tile and of its border cells, in coalesced stores
  for (Walk w(cap); w.outer < nb; w.next()) {
    const int b = w.outer;
    const int t = own[b];
    if (t == -2) continue;  // outside the grid, or another tile's
    float vx = 0.0f;
    float vy = 0.0f;
    int32_t vc = 0;
    if (t >= 0 && w.inner < cnt[b]) {
      const int o = t * cs + w.inner;
      vx = rx[o];
      vy = ry[o];
      vc = rc[o];
    }
    const int g = gcell[b] * cap + w.inner;
    disp_x[g] = vx;
    disp_y[g] = vy;
    count[g] = vc;
  }
}

}  // namespace

// The largest capacity the kernel stages (a 1 x 1 tile in the current
// device's shared memory), or -1 with the CUDA error unread.
extern "C" int pair_pass_grid_max_cap() {
  DeviceLimits dev;
  if (device_limits(&dev) != cudaSuccess) return -1;
  return max_capacity(box_words, tile_words, dev.max_smem);
}

// The tile a launch over a layout of `rows` x `cols` cells with `cap`
// slots a cell takes: its rows and columns of cells into tile[0] and
// tile[1]. Returns the planning's CUDA error (0 on success).
extern "C" int pair_pass_grid_tile(int cap, int rows, int cols, int* tile) {
  TilePlan plan;
  dim3 grid;
  const cudaError_t err =
      plan_launch(box_words(cap), tile_words(cap), cap, rows, cols, &plan, &grid);
  if (err == cudaSuccess) {
    tile[0] = plan.tr;
    tile[1] = plan.tc;
  }
  return (int)err;
}

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of the shared-memory
// attribute; it neither allocates nor synchronises.
extern "C" int pair_pass_grid_launch(const float* x, const float* y,
                                     const float* attrs, float* disp_x,
                                     float* disp_y, int32_t* count, int rows,
                                     int cols, int cap, uint32_t salt,
                                     float strength, void* stream) {
  TilePlan plan;
  dim3 grid;
  cudaError_t err = plan_launch(box_words(cap), tile_words(cap), cap, rows, cols, &plan, &grid);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(pair_pass_grid_kernel, plan.smem, g_granted);
  if (err != cudaSuccess) return (int)err;
  pair_pass_grid_kernel<<<grid, kThreads, plan.smem, (cudaStream_t)stream>>>(
      x, y, attrs, disp_x, disp_y, count, rows, cols, cap, plan.tr, plan.tc,
      salt, strength);
  return (int)cudaGetLastError();
}
