// K2: one Jacobi pass of circle separation over the solver's slot-major
// layout, in the occupancy-predicated Newton-symmetric form, optionally with
// the world-boundary position clamp folded in; a tiled pass over occupied
// slots.
//
// Replaces the TPU kernel multithreadedgameengine_tpu/ops/pallas_kernels.py
// `pair_pass_resident(symmetric=True)` -> `_resident_kernel_sym` ->
// `_resident_body_pred`, with `_acc_back` and the spill `combine`. On the
// TPU each row tile owns its rows: the i side of every pair over the 5
// forward offsets (0,0), (0,1), (1,0), (1,1), (1,-1) is added to the i
// slots, and the reciprocal is summed over i into a back-sum that is added
// to slot j (through spill rows when it crosses into the next tile).
//
// On the GPU those reciprocal writes would race between threads. This
// kernel does not use float atomics (their order, and so the sums, would
// change from run to run). Instead one thread per occupied slot computes
// everything its slot receives, in the reference's per-slot order: for each
// forward offset, for each neighbour plane j ascending,
//   1. its own push from the pair (self, slot j at +offset), when it takes
//      the i side (p > j in the same cell, any p otherwise);
//   2. when p == j, the back-sum: the reciprocal pushes of the slots at
//      -offset (i > j in the same cell), summed in order from 0.0.
// Each pair is thus evaluated twice, once by each of its slots; the
// reciprocal reuses the reference's arithmetic (-(pxc * share_j)), so both
// evaluations round exactly as the reference's one does.
//
// Predication: cells fill their slots rank-ascending (ranks follow the
// entity id, so the only slot whose meta can be 0 while occupied is gid 0,
// which is always rank 0). A cell's occupants therefore end at its first
// slot above plane 0 whose meta is 0. Skipped slots contribute exactly zero
// in the reference, so this changes no value.
//
// Clamp: with `clamp` set, every position the pass reads is first clamped
// to [r, extent - r] when the slot is moving (meta flag 8), as the
// reference clamps its VMEM tile right after the DMA; the output is clamped
// x + acc for every slot.
//
// What bounds it on an H100: each pass must read x, y and meta and write
// x, y and count for every slot (24 bytes), and read the radius of every
// collider slot (4 bytes) -- about 0.19 GB at the 1M-ball layout
// [12, 536, 1203] with 1M balls, about 57 us at 3.35 TB/s
// (chip_smoke.py::bound). The pair work is below the card's float32 rate.
//
// The design (pair_tile.cuh):
// - A block takes a tile of TR x TC interior cells and stages the tile and
//   its one-cell ring (the box) in shared memory, plane by plane: meta, x,
//   y and radius of every box slot, in one round of copies (a second round
//   for only the occupied slots, after counting them, measured slower: the
//   wait between the rounds costs more than the bytes it saves). Copies are
//   4-byte cp.async: a layout row is (C+2) x 4 bytes, 4812 at the 1M
//   layout, not a multiple of 16, so TMA, which needs 16-byte strides,
//   cannot take the layout as it is, and the layout is not padded since
//   the solver caches share it.
// - One thread per box cell counts the cell's occupants. With `clamp`, each
//   moving slot is then clamped once, in shared memory; the values equal
//   clamping at every read.
// - A block-wide prefix sum over the tile's counts gives every thread an
//   occupied slot, which scans its 5 forward and 5 backward neighbour cells
//   up to their counts, from shared memory, and keeps its result in shared
//   memory.
// - The block then writes x, y and count for every slot of its tile, and of
//   the border cells next to it, in coalesced stores: `x + 0.0f` (so -0.0
//   becomes +0.0 and NaN is kept) for slots that take part in no pair.
//   Every output has one writer.
// - Each pair is still evaluated by both of its slots; evaluating it once
//   and handing the reciprocal over in shared memory is later work.
//
// Numerics: built with --fmad=false and without --use_fast_math; the
// inverse distance is 1.0f / sqrtf(d2), so every operation rounds as the
// plain PyTorch version's does (ops/cuda_kernels.py::pair_pass_symmetric_plain).

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

// The share factors of one slot: A = (1-trig)(1-static) and
// B = (1-trig)(0.5+0.5*static) (pallas_kernels.py:285-302).
__device__ __forceinline__ float share_a(int32_t flags) {
  const float nt = 1.0f - (float)((flags >> 1) & 1);
  return nt * (1.0f - (float)((flags >> 2) & 1));
}

__device__ __forceinline__ float share_b(int32_t flags) {
  const float nt = 1.0f - (float)((flags >> 1) & 1);
  return nt * (0.5f + 0.5f * (float)((flags >> 2) & 1));
}

// The pair (slot I, slot J), I on the i side: whether it overlaps and, if
// so, the push on I (`*px`, `*py`) or, with `reciprocal`, the push on J.
__device__ __forceinline__ bool pair_push(
    float xi, float yi, float ri, int32_t mi, float xj, float yj, float rj,
    int32_t mj, uint32_t salt, float strength, bool reciprocal, float* px,
    float* py) {
  const int32_t fi = mi >> 24;
  const int32_t fj = mj >> 24;
  if ((fi & 1) == 0 || (fj & 1) == 0) return false;
  const float dx = xi - xj;
  const float dy = yi - yj;
  const float d2 = dx * dx + dy * dy;
  const float min_d = ri + rj;
  if (!(d2 < min_d * min_d)) return false;
  const float share =
      reciprocal ? share_a(fj) * share_b(fi) : share_a(fi) * share_b(fj);
  if (d2 == 0.0f) {
    // exactly coincident: pair-consistent hash direction
    const int32_t id_i = mi & 0xFFFFFF;
    const int32_t id_j = mj & 0xFFFFFF;
    float ux, uy;
    pair_hash_dir(id_i, id_j, salt, &ux, &uy);
    const float sign = id_i < id_j ? 1.0f : -1.0f;
    const float zs = (2.0f * share) * (reciprocal ? -sign : sign) * 0.001f;
    *px = ux * zs;
    *py = uy * zs;
  } else {
    const float inv_dist = 1.0f / sqrtf(d2);
    const float dist = d2 * inv_dist;
    const float base = (min_d - dist) * strength * inv_dist;
    const float pxc = dx * base;
    const float pyc = dy * base;
    *px = reciprocal ? -(pxc * share) : pxc * share;
    *py = reciprocal ? -(pyc * share) : pyc * share;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) pair_pass_symmetric_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ radius, const int32_t* __restrict__ meta,
    float* __restrict__ new_x, float* __restrict__ new_y,
    int32_t* __restrict__ count, int cap, int rows, int cols, int tile_rows,
    int tile_cols, uint32_t salt, float strength, int clamp, float w,
    float h) {
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

  // 2. each box cell's occupants: the slots before its first empty slot
  //    above plane 0 (none when planes 0 and 1 are both empty)
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int n = 0;
    if (sm[b] != 0 || (cap > 1 && sm[nb + b] != 0)) {
      n = cap;
      for (int j = 1; j < cap; ++j) {
        if (sm[j * nb + b] == 0) {
          n = j;
          break;
        }
      }
    }
    cnt[b] = n;
  }
  __syncthreads();

  // 3. with the clamp, each moving slot is clamped once, here
  if (clamp) {
    for (Walk wk(nb); wk.outer < cap; wk.next()) {
      const int b = wk.inner;
      const int e = wk.outer * nb + b;
      if (gcell[b] >= 0 && (wk.outer < cnt[b] || own[b] != -2) && ((sm[e] >> 24) & 8) != 0) {
        const float r = sr[e];
        sx[e] = clamp_to(sx[e], r, w - r);
        sy[e] = clamp_to(sy[e], r, h - r);
      }
    }
    __syncthreads();
  }

  // 4. hand out the tile's occupied slots
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

  // 5. one thread per occupied slot, in the reference's per-slot order
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int t = find_cell(incl, nt, k);
    const int p = k - (t > 0 ? incl[t - 1] : 0);
    const int q = box.box_cell(t);
    const int s = p * nb + q;
    const int32_t ms = sm[s];
    const float xs = sx[s];
    const float ys = sy[s];
    float acc_x = 0.0f;
    float acc_y = 0.0f;
    int32_t acc_c = 0;
    if (((ms >> 24) & 1) != 0) {
      const float rs = sr[s];
      // the i side for neighbour planes j in [j0, j1): slot j at +offset
      auto i_side = [&](int fwd, int j0, int j1) {
        for (int j = j0; j < j1; ++j) {
          const int u = j * nb + fwd;
          float px, py;
          if (pair_push(xs, ys, rs, ms, sx[u], sy[u], sr[u], sm[u], salt,
                        strength, false, &px, &py)) {
            acc_x = acc_x + px;
            acc_y = acc_y + py;
            acc_c += 1;
          }
        }
      };
      // the forward offsets (0,0), (0,1), (1,0), (1,1), (1,-1); one copy
      // of the body, not five, keeps the code small
#pragma unroll 1
      for (int o = 0; o < 5; ++o) {
        const int dr = o >= 2 ? 1 : 0;
        const int dc = (o == 1 || o == 3) ? 1 : (o == 4 ? -1 : 0);
        const int step = dr * box.bc + dc;
        const bool same_cell = o == 0;
        const int fwd = q + step;  // the j cell
        const int bwd = q - step;  // the back-sum's i cell
        const int n_fwd = cnt[fwd];
        // 1. planes j before the back-sum's turn: j < p in the same cell
        //    (the i side there is p > j), j <= p across cells
        i_side(fwd, 0, min(same_cell ? p : p + 1, n_fwd));
        // 2. j == p: the back-sum of the reciprocals from the slots at -offset
        float b_x = 0.0f;
        float b_y = 0.0f;
        for (int i = same_cell ? p + 1 : 0; i < cnt[bwd]; ++i) {
          const int u = i * nb + bwd;
          float px, py;
          if (pair_push(sx[u], sy[u], sr[u], sm[u], xs, ys, rs, ms, salt,
                        strength, true, &px, &py)) {
            b_x = b_x + px;
            b_y = b_y + py;
            acc_c += 1;
          }
        }
        acc_x = acc_x + b_x;
        acc_y = acc_y + b_y;
        // 3. the remaining planes j > p (none in the same cell)
        if (!same_cell) i_side(fwd, p + 1, n_fwd);
      }
    }
    const int out = p * nt + t;
    rx[out] = xs + acc_x;
    ry[out] = ys + acc_y;
    rc[out] = acc_c;
  }
  __syncthreads();

  // 6. every slot of the tile and of its border cells, in coalesced stores
  for (Walk wk(nb); wk.outer < cap; wk.next()) {
    const int b = wk.inner;
    const int t = own[b];
    if (t == -2) continue;  // outside the grid, or another tile's
    const int e = wk.outer * nb + b;
    const int g = wk.outer * plane + gcell[b];
    if (t >= 0 && wk.outer < cnt[b]) {
      const int o = wk.outer * nt + t;
      new_x[g] = rx[o];
      new_y[g] = ry[o];
      count[g] = rc[o];
    } else {
      // a slot that takes part in no pair (border, empty)
      new_x[g] = sx[e] + 0.0f;
      new_y[g] = sy[e] + 0.0f;
      count[g] = 0;
    }
  }
}

}  // namespace

// The largest capacity the kernel stages (a 1 x 1 tile in the current
// device's shared memory), or -1 with the CUDA error unread.
extern "C" int pair_pass_symmetric_max_cap() {
  size_t max_smem = 0;
  if (device_max_smem(&max_smem) != cudaSuccess) return -1;
  return max_capacity(box_words, tile_words, max_smem);
}

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of the shared-memory
// attribute; it neither allocates nor synchronises.
extern "C" int pair_pass_symmetric_launch(
    const float* x, const float* y, const float* radius, const int32_t* meta,
    float* new_x, float* new_y, int32_t* count, int cap, int rows, int cols,
    uint32_t salt, float strength, int clamp, float clamp_w, float clamp_h,
    void* stream) {
  if (rows < 3 || cols < 3 || cap < 1) return (int)cudaErrorInvalidValue;
  size_t max_smem = 0;
  cudaError_t err = device_max_smem(&max_smem);
  if (err != cudaSuccess) return (int)err;
  TilePlan plan;
  if (!plan_tile(box_words(cap), tile_words(cap), max_smem, &plan)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((cols - 2 + plan.tc - 1) / plan.tc),
                  (unsigned)((rows - 2 + plan.tr - 1) / plan.tr));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  err = allow_smem(pair_pass_symmetric_kernel, plan.smem, g_granted);
  if (err != cudaSuccess) return (int)err;
  pair_pass_symmetric_kernel<<<grid, kThreads, plan.smem, (cudaStream_t)stream>>>(
      x, y, radius, meta, new_x, new_y, count, cap, rows, cols, plan.tr,
      plan.tc, salt, strength, clamp, clamp_w, clamp_h);
  return (int)cudaGetLastError();
}
