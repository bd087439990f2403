// K2: one Jacobi pass of circle separation over the solver's slot-major
// layout, in the occupancy-predicated Newton-symmetric form, optionally with
// the world-boundary position clamp folded in.
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
// change from run to run). Instead one thread per slot computes everything
// its slot receives, in the reference's per-slot order: for each forward
// offset, for each neighbour plane j = 0..cap-1,
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
// which is always rank 0). A thread therefore stops scanning a cell at its
// first empty slot above plane 0. Skipped slots contribute exactly zero in
// the reference, so this changes no value.
//
// Clamp: with `clamp` set, every position the thread reads -- its own and
// its neighbours' -- is first clamped to [r, extent - r] when the slot is
// moving (meta flag 8), as the reference clamps its VMEM tile right after
// the DMA; the output is clamped x + acc for every slot.
//
// What bounds it on an H100: each pass must read x, y and meta and write
// x, y and count for every slot (24 bytes), and read the radius of every
// collider slot (4 bytes) -- about 0.19 GB at the 1M-ball layout
// [12, 536, 1203] with 1M balls, about 57 us at 3.35 TB/s. The pair work
// is below the card's rates; the neighbour reads, which hit L1/L2 because neighbouring
// threads read neighbouring columns of one plane, are what the thread
// waits on. Evaluating each pair once, with the reciprocal exchanged through
// shared memory, is later work.
//
// Numerics: built with --fmad=false and without --use_fast_math; the
// inverse distance is 1.0f / sqrtf(d2), so every operation rounds as the
// plain PyTorch version's does (ops/cuda_kernels.py::pair_pass_symmetric_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void pair_hash_dir(int32_t i, int32_t j,
                                              uint32_t salt, float* ux,
                                              float* uy) {
  // ops/physics.py::_pair_hash_dir in native uint32 arithmetic.
  uint32_t a = (uint32_t)min(i, j);
  uint32_t b = (uint32_t)max(i, j);
  uint32_t h = (a * 0x9E3779B1u) ^ (b * 0x85EBCA77u) ^ salt;
  h = h ^ (h >> 15);
  h = h * 0x2C1B3C6Du;
  h = h ^ (h >> 12);
  float hx = (float)(int32_t)(h & 0xFFFFu) - 32767.5f;
  float hy = (float)(int32_t)((h >> 16) & 0xFFFFu) - 32767.5f;
  float inv = 1.0f / sqrtf(hx * hx + hy * hy);
  *ux = hx * inv;
  *uy = hy * inv;
}

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

// torch.clamp(v, lo, hi) = min(max(v, lo), hi), NaN kept.
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

struct Layout {
  const float* x;
  const float* y;
  const float* radius;
  const int32_t* meta;
  int clamp;
  float w, h;

  __device__ __forceinline__ void pos(int64_t t, int32_t m, float* px,
                                      float* py) const {
    float vx = x[t];
    float vy = y[t];
    if (clamp && ((m >> 24) & 8) != 0) {
      const float r = radius[t];
      vx = clamp_to(vx, r, w - r);
      vy = clamp_to(vy, r, h - r);
    }
    *px = vx;
    *py = vy;
  }
};

// The pair (slot I, slot J), I on the i side: whether it overlaps and, if
// so, the push on I (`*ix`, `*iy`) or, with `reciprocal`, the push on J.
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

__global__ void pair_pass_symmetric_kernel(
    Layout L, float* __restrict__ new_x, float* __restrict__ new_y,
    int32_t* __restrict__ count, int cap, int rows, int cols, uint32_t salt,
    float strength) {
  // rows/cols include the border: the layout is [cap, rows, cols]
  const int64_t plane = (int64_t)rows * cols;
  const int64_t total = plane * cap;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= total) return;

  const int p = (int)(s / plane);
  const int c = (int)(s % cols);
  const int r = (int)((s / cols) % rows);
  const int32_t ms = L.meta[s];
  float xs, ys;
  L.pos(s, ms, &xs, &ys);
  const bool interior = r >= 1 && r < rows - 1 && c >= 1 && c < cols - 1;
  if (!interior || ((ms >> 24) & 1) == 0) {
    // border, empty or non-collider slot: it takes part in no pair
    new_x[s] = xs + 0.0f;
    new_y[s] = ys + 0.0f;
    count[s] = 0;
    return;
  }

  const float rs = L.radius[s];
  const int64_t cell = s - (int64_t)p * plane;
  float acc_x = 0.0f;
  float acc_y = 0.0f;
  int32_t acc_c = 0;

  const int offs[5][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}, {1, -1}};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int dr = offs[k][0];
    const int dc = offs[k][1];
    const bool same_cell = k == 0;
    const int64_t fwd = cell + (int64_t)dr * cols + dc;  // the j cell
    const int64_t bwd = cell - (int64_t)dr * cols - dc;  // the back-sum's i cell
    // the i side for neighbour planes j in [j0, j1): slot j at +offset.
    // Returns false at the cell's first empty slot above plane 0.
    auto i_side = [&](int j0, int j1) {
      for (int j = j0; j < j1; ++j) {
        const int64_t t = (int64_t)j * plane + fwd;
        const int32_t mj = L.meta[t];
        if (mj == 0) {
          if (j > 0) return false;  // the rest of the cell is empty too
          continue;
        }
        float xj, yj, px, py;
        L.pos(t, mj, &xj, &yj);
        if (pair_push(xs, ys, rs, ms, xj, yj, L.radius[t], mj, salt,
                      strength, false, &px, &py)) {
          acc_x = acc_x + px;
          acc_y = acc_y + py;
          acc_c += 1;
        }
      }
      return true;
    };
    // 1. planes j before the back-sum's turn: j < p in the same cell (the
    //    i side there is p > j), j <= p across cells
    const bool more = i_side(0, same_cell ? p : p + 1);
    // 2. j == p: the back-sum of the reciprocals from the slots at -offset
    float b_x = 0.0f;
    float b_y = 0.0f;
    for (int i = same_cell ? p + 1 : 0; i < cap; ++i) {
      const int64_t t = (int64_t)i * plane + bwd;
      const int32_t mi = L.meta[t];
      if (mi == 0) {
        if (i > 0) break;
        continue;
      }
      float xi, yi, px, py;
      L.pos(t, mi, &xi, &yi);
      if (pair_push(xi, yi, L.radius[t], mi, xs, ys, rs, ms, salt, strength,
                    true, &px, &py)) {
        b_x = b_x + px;
        b_y = b_y + py;
        acc_c += 1;
      }
    }
    acc_x = acc_x + b_x;
    acc_y = acc_y + b_y;
    // 3. the remaining planes j > p (none in the same cell)
    if (more && !same_cell) i_side(p + 1, cap);
  }
  new_x[s] = xs + acc_x;
  new_y[s] = ys + acc_y;
  count[s] = acc_c;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int pair_pass_symmetric_launch(
    const float* x, const float* y, const float* radius, const int32_t* meta,
    float* new_x, float* new_y, int32_t* count, int cap, int rows, int cols,
    uint32_t salt, float strength, int clamp, float clamp_w, float clamp_h,
    void* stream) {
  const int64_t total = (int64_t)cap * rows * cols;
  if (total <= 0) return 0;
  const Layout L{x, y, radius, meta, clamp, clamp_w, clamp_h};
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pair_pass_symmetric_kernel<<<(unsigned int)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      L, new_x, new_y, count, cap, rows, cols, salt, strength);
  return (int)cudaGetLastError();
}
