// K1: one Jacobi pass of circle separation over the solver's slot-major
// layout, two-sided over the 3x3 cell neighbourhood.
//
// Replaces the TPU kernel multithreadedgameengine_tpu/ops/pallas_kernels.py
// `pair_pass_resident(symmetric=False)` -> `_resident_kernel` ->
// `_resident_body`. It computes what that kernel computes, in the same
// order: for each occupied slot i, the 9 cell offsets (dr, dc in -1..1,
// row-major), then neighbour slots j = 0..cap-1, accumulating each
// overlapping pair's push into a register. The TPU structure (VMEM row
// tiles, pltpu.roll shifts, the 8-row halo and the 128-lane pad) is not
// carried over.
//
// Layout: every field is [cap, R+2, C+2] (slot plane, row, col) with a
// one-cell empty border, so the neighbourhood of an interior cell never
// leaves the array. Empty slots hold meta == 0; an occupied slot holds
// meta = gid | flags << 24 (flag bits 1 collider, 2 trigger, 4 static,
// 8 moving). Border and empty slots pass their x/y through with count 0.
//
// What bounds it on an H100: each pass streams 16 bytes in (x, y, radius,
// meta) and 12 bytes out (x, y, count) per slot -- 0.22 GB at the 1M-ball
// layout [12, 536, 1202], about 65 us at 3.35 TB/s -- while each occupied
// slot makes 9*cap neighbour meta reads and a full pair evaluation for each
// occupied neighbour slot. The neighbour reads are the cost: they hit L1/L2
// because neighbouring threads read neighbouring columns. The design keeps
// them cheap and coalesced (one thread per slot, column fastest, so a warp
// reads 32 consecutive floats of one plane), skips empty neighbour slots on
// their meta alone, and lets slots without a collider exit after one load.
// Shared-memory staging, skipping by occupancy prefix and the
// Newton-symmetric form (K2) are left for later work.
//
// Numerics: built with --fmad=false and without --use_fast_math, and the
// inverse distance is 1.0f / sqrtf(d2) (IEEE sqrt and division), so each
// operation rounds as the plain PyTorch version's does.

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

__global__ void pair_pass_resident_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ radius, const int32_t* __restrict__ meta,
    float* __restrict__ new_x, float* __restrict__ new_y,
    int32_t* __restrict__ count, int cap, int rows, int cols, uint32_t salt,
    float strength) {
  // rows/cols include the border: the layout is [cap, rows, cols]
  const int64_t plane = (int64_t)rows * cols;
  const int64_t total = plane * cap;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= total) return;

  const int c = (int)(s % cols);
  const int r = (int)((s / cols) % rows);
  const float xi = x[s];
  const float yi = y[s];
  const int32_t mi = meta[s];
  const int32_t fi = mi >> 24;
  const bool interior = r >= 1 && r < rows - 1 && c >= 1 && c < cols - 1;
  if (!interior || (fi & 1) == 0) {
    new_x[s] = xi;
    new_y[s] = yi;
    count[s] = 0;
    return;
  }

  const float ri = radius[s];
  const int32_t id_i = mi & 0xFFFFFF;
  const bool trig_i = (fi & 2) != 0;
  const bool st_i = (fi & 4) != 0;
  float acc_x = 0.0f;
  float acc_y = 0.0f;
  int32_t acc_c = 0;

  for (int dr = -1; dr <= 1; ++dr) {
    for (int dc = -1; dc <= 1; ++dc) {
      const int64_t cell = (int64_t)(r + dr) * cols + (c + dc);
      for (int j = 0; j < cap; ++j) {
        const int64_t t = (int64_t)j * plane + cell;
        const int32_t mj = meta[t];
        if (mj == 0) continue;  // empty slot
        const int32_t fj = mj >> 24;
        const int32_t id_j = mj & 0xFFFFFF;
        if ((fj & 1) == 0 || id_j == id_i) continue;
        const float dx = xi - x[t];
        const float dy = yi - y[t];
        const float d2 = dx * dx + dy * dy;
        const float min_d = ri + radius[t];
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
  new_x[s] = xi + acc_x;
  new_y[s] = yi + acc_y;
  count[s] = acc_c;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int pair_pass_resident_launch(
    const float* x, const float* y, const float* radius, const int32_t* meta,
    float* new_x, float* new_y, int32_t* count, int cap, int rows, int cols,
    uint32_t salt, float strength, void* stream) {
  const int64_t total = (int64_t)cap * rows * cols;
  if (total <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pair_pass_resident_kernel<<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      x, y, radius, meta, new_x, new_y, count, cap, rows, cols, salt,
      strength);
  return (int)cudaGetLastError();
}
