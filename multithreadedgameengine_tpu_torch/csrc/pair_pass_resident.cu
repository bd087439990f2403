// K1: one Jacobi pass of circle separation over the solver's slot-major
// layout, two-sided over the 3x3 cell neighbourhood, as a tiled pass over
// occupied slots.
//
// Replaces the TPU kernel multithreadedgameengine_tpu/ops/pallas_kernels.py
// `pair_pass_resident(symmetric=False)` -> `_resident_kernel` ->
// `_resident_body`. It computes what that kernel computes, in the same
// order: for each occupied slot i holding a collider, the 9 cell offsets
// (dr, dc in -1..1, row-major), then neighbour slots j ascending,
// accumulating each overlapping pair's push into a register. Each pair is
// evaluated from both of its sides, as the reference's XLA order defines
// it. The TPU structure (VMEM row tiles, pltpu.roll shifts, the 8-row halo
// and the 128-lane pad) is not carried over.
//
// Layout: every field is [cap, R+2, C+2] (slot plane, row, col) with a
// one-cell empty border. Empty slots hold meta == 0; an occupied slot holds
// meta = gid | flags << 24 (flag bits 1 collider, 2 trigger, 4 static,
// 8 moving). Every slot that is not an occupied interior collider (border,
// empty, non-collider) passes its x/y through bit for bit (-0.0 and NaN
// kept) with count 0; an occupied collider gets x + acc.
//
// What bounds it on an H100: each pass must read x, y and meta and write
// x, y and count for every slot (24 bytes), and read the radius of every
// collider slot (4 bytes) -- about 0.19 GB at the 1M-ball layout
// [12, 536, 1203] with 1M balls, about 57 us at 3.35 TB/s
// (chip_smoke.py::bound). The pair work is far below the card's float32
// rate: some 1.56 entities a cell, so about 14 candidate pairs a collider.
//
// The design is K2's (pair_pass_symmetric.cu, pair_tile.cuh):
// - A block takes a tile of TR x TC interior cells and stages the tile and
//   its one-cell ring (the box) in shared memory, every plane: meta, x, y
//   and radius of every box slot, in one round of 4-byte cp.async copies
//   (a layout row is (C+2) x 4 bytes, not a multiple of 16, so neither TMA
//   nor 16-byte copies take it as it is). The ring holds all 9 neighbours.
//   The tile is chosen from the capacity so that every cell may be full (4
//   x 32 cells at capacity 8 to 12), and made smaller for a grid too small
//   to give every SM a block: the 10k demo layout [8, 56, 123] takes 4 x 8
//   cells, 224 blocks, not 56 (pair_tile::plan_tile).
// - One thread per box cell counts the cell's occupants
//   (pair_tile::count_occupants); occupied slots form a prefix of the cell's
//   planes, so a scan that stops at the count reads every occupant.
// - A block-wide prefix sum over the tile's counts gives every thread an
//   occupied slot. A collider slot scans its 9 neighbour cells up to their
//   counts, from shared memory, and keeps its result in shared memory; a
//   non-collider keeps its raw x/y.
// - The block then writes x, y and count for every slot of its tile, and
//   of the border cells next to it, in coalesced stores: the raw staged
//   x/y for slots that are not occupied (and for border cells). Every
//   output has one writer; no atomics.
//
// Numerics: built with --fmad=false and without --use_fast_math, and the
// inverse distance is 1.0f / sqrtf(d2) (IEEE sqrt and division), so each
// operation rounds as the plain PyTorch version's does
// (ops/cuda_kernels.py::pair_pass_resident_plain).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_tile.cuh"

namespace {

using namespace pair_tile;

// shared-memory words of a box cell (meta, x, y and radius of each slot)
// and of a tile cell (x, y and count out)
size_t box_words(int cap) { return 4 * (size_t)cap; }
size_t tile_words(int cap) { return 3 * (size_t)cap; }

size_t g_granted[kMaxDevices];

__global__ void __launch_bounds__(kThreads) pair_pass_resident_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ radius, const int32_t* __restrict__ meta,
    float* __restrict__ new_x, float* __restrict__ new_y,
    int32_t* __restrict__ count, int cap, int rows, int cols, int tile_rows,
    int tile_cols, uint32_t salt, float strength) {
  extern __shared__ __align__(16) float smem[];
  const Box box(rows, cols, tile_rows, tile_cols);
  const int nb = box.nb;
  const int nt = box.nt;
  const int plane = rows * cols;
  int* sm = (int*)smem;              // [cap][nb] meta
  float* sx = smem + cap * nb;       // [cap][nb]
  float* sy = sx + cap * nb;         // [cap][nb]
  float* sr = sy + cap * nb;         // [cap][nb]
  float* rx = sr + cap * nb;         // [cap][nt]
  float* ry = rx + cap * nt;         // [cap][nt]
  int* rc = (int*)(ry + cap * nt);   // [cap][nt]
  int* gcell = rc + cap * nt;        // [nb]
  int* own = gcell + nb;             // [nb]
  int* cnt = own + nb;               // [nb]
  int* incl = cnt + nb;              // [nt]
  int* wsum = incl + nt;             // [32]

  // 1. meta, x, y and radius of every box slot (meta 0 outside the grid)
  box.index_cells(gcell, own);
  __syncthreads();
  for (Walk wk(nb); wk.outer < cap; wk.next()) {
    const int g = gcell[wk.inner];
    const int e = wk.outer * nb + wk.inner;
    if (g >= 0) {
      const int gs = wk.outer * plane + g;
      cp_async4(sm + e, meta + gs);
      cp_async4(sx + e, x + gs);
      cp_async4(sy + e, y + gs);
      cp_async4(sr + e, radius + gs);
    } else {
      sm[e] = 0;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. each box cell's occupants
  count_occupants(sm, nb, cap, cnt);
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

  // 4. one thread per occupied slot: a collider scans the 9 neighbour
  //    cells, row-major, each up to its count
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int t = find_cell(incl, nt, k);
    const int p = k - (t > 0 ? incl[t - 1] : 0);
    const int q = box.box_cell(t);
    const int s = p * nb + q;
    const int32_t mi = sm[s];
    const int32_t fi = mi >> 24;
    const float xi = sx[s];
    const float yi = sy[s];
    const int out = p * nt + t;
    if ((fi & 1) == 0) {
      // no collider: its position passes through as it is
      rx[out] = xi;
      ry[out] = yi;
      rc[out] = 0;
      continue;
    }
    const float ri = sr[s];
    const int32_t id_i = mi & 0xFFFFFF;
    const bool trig_i = (fi & 2) != 0;
    const bool st_i = (fi & 4) != 0;
    float acc_x = 0.0f;
    float acc_y = 0.0f;
    int32_t acc_c = 0;
    for (int dr = -1; dr <= 1; ++dr) {
      for (int dc = -1; dc <= 1; ++dc) {
        const int nbc = q + dr * box.bc + dc;
        const int n_nb = cnt[nbc];
        for (int j = 0; j < n_nb; ++j) {
          const int u = j * nb + nbc;
          const int32_t mj = sm[u];
          const int32_t fj = mj >> 24;
          const int32_t id_j = mj & 0xFFFFFF;
          if ((fj & 1) == 0 || id_j == id_i) continue;  // no collider, or itself
          const float dx = xi - sx[u];
          const float dy = yi - sy[u];
          const float d2 = dx * dx + dy * dy;
          const float min_d = ri + sr[u];
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
    rx[out] = xi + acc_x;
    ry[out] = yi + acc_y;
    rc[out] = acc_c;
  }
  __syncthreads();

  // 5. every slot of the tile and of its border cells, in coalesced stores
  for (Walk wk(nb); wk.outer < cap; wk.next()) {
    const int b = wk.inner;
    const int t = own[b];
    if (t == -2) continue;  // outside the grid, or another tile's
    const int g = wk.outer * plane + gcell[b];
    if (t >= 0 && wk.outer < cnt[b]) {
      const int o = wk.outer * nt + t;
      new_x[g] = rx[o];
      new_y[g] = ry[o];
      count[g] = rc[o];
    } else {
      // an empty slot, or a border cell's: x/y as they are, bit for bit
      const int e = wk.outer * nb + b;
      new_x[g] = sx[e];
      new_y[g] = sy[e];
      count[g] = 0;
    }
  }
}

}  // namespace

// The largest capacity the kernel stages (a 1 x 1 tile in the current
// device's shared memory), or -1 with the CUDA error unread.
extern "C" int pair_pass_resident_max_cap() {
  DeviceLimits dev;
  if (device_limits(&dev) != cudaSuccess) return -1;
  return max_capacity(box_words, tile_words, dev.max_smem);
}

// The tile a launch over a layout of `rows` x `cols` cells with `cap`
// slots a cell takes: its rows and columns of cells into tile[0] and
// tile[1]. Returns the planning's CUDA error (0 on success).
extern "C" int pair_pass_resident_tile(int cap, int rows, int cols, int* tile) {
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
extern "C" int pair_pass_resident_launch(
    const float* x, const float* y, const float* radius, const int32_t* meta,
    float* new_x, float* new_y, int32_t* count, int cap, int rows, int cols,
    uint32_t salt, float strength, void* stream) {
  TilePlan plan;
  dim3 grid;
  cudaError_t err = plan_launch(box_words(cap), tile_words(cap), cap, rows, cols, &plan, &grid);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(pair_pass_resident_kernel, plan.smem, g_granted);
  if (err != cudaSuccess) return (int)err;
  pair_pass_resident_kernel<<<grid, kThreads, plan.smem, (cudaStream_t)stream>>>(
      x, y, radius, meta, new_x, new_y, count, cap, rows, cols, plan.tr,
      plan.tc, salt, strength);
  return (int)cudaGetLastError();
}
