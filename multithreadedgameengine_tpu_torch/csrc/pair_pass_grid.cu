// K3: one Jacobi pass of circle separation over the legacy bordered solver
// grid, returning displacements.
//
// Replaces the TPU kernel multithreadedgameengine_tpu/ops/pallas_kernels.py
// `pair_pass_pallas` -> `_pair_kernel`, the pair pass of
// ops/physics_grid.py::run_solver_substeps with solver="pallas" (the
// spatial-domain halo step's solver). It computes what that kernel computes,
// in the same order: for each slot i of an interior cell, the 9 cell offsets
// (dr, dc in -1..1, row-major), then neighbour slots j = 0..cap-1,
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
// slots, some 250k of them colliders), about 14 us at 3.35 TB/s. Each occupied
// slot then makes 9*cap neighbour flag reads and a full pair evaluation for
// each occupied neighbour. One thread per slot: the cap threads of a cell
// read the same neighbour slot at once (one broadcast load), and the cells
// of a warp are consecutive, so neighbour reads hit L1/L2. Slots without a
// collider exit after one load; empty neighbour slots are skipped on their
// flags alone. Shared-memory staging is left for later work.
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

__global__ void pair_pass_grid_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ attrs, float* __restrict__ disp_x,
    float* __restrict__ disp_y, int32_t* __restrict__ count, int rows,
    int cols, int cap, uint32_t salt, float strength) {
  // rows/cols include the border: the grid is [rows, cols, cap]
  const int64_t total = (int64_t)rows * cols * cap;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= total) return;

  const int64_t cell = s / cap;
  const int c = (int)(cell % cols);
  const int r = (int)(cell / cols);
  const bool interior = r >= 1 && r < rows - 1 && c >= 1 && c < cols - 1;
  // flags and gid decode once per slot (exact small floats)
  const int32_t fi = interior ? (int32_t)attrs[3 * s + 1] : 0;
  if ((fi & 1) == 0) {
    disp_x[s] = 0.0f;
    disp_y[s] = 0.0f;
    count[s] = 0;
    return;
  }

  const float xi = x[s];
  const float yi = y[s];
  const float ri = attrs[3 * s];
  const int32_t id_i = (int32_t)attrs[3 * s + 2];
  const bool trig_i = (fi & 2) != 0;
  const bool st_i = (fi & 4) != 0;
  float acc_x = 0.0f;
  float acc_y = 0.0f;
  int32_t acc_c = 0;

  for (int dr = -1; dr <= 1; ++dr) {
    for (int dc = -1; dc <= 1; ++dc) {
      // border rows 0 and R+1 are read: they hold the neighbour slabs' rows
      const int64_t base = ((int64_t)(r + dr) * cols + (c + dc)) * cap;
      for (int j = 0; j < cap; ++j) {
        const int64_t t = base + j;
        const int32_t fj = (int32_t)attrs[3 * t + 1];
        if ((fj & 1) == 0) continue;  // empty slot or no collider
        const int32_t id_j = (int32_t)attrs[3 * t + 2];
        if (id_j == id_i) continue;
        const float dx = xi - x[t];
        const float dy = yi - y[t];
        const float d2 = dx * dx + dy * dy;
        const float min_d = ri + attrs[3 * t];
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
  disp_x[s] = acc_x;
  disp_y[s] = acc_y;
  count[s] = acc_c;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int pair_pass_grid_launch(const float* x, const float* y,
                                     const float* attrs, float* disp_x,
                                     float* disp_y, int32_t* count, int rows,
                                     int cols, int cap, uint32_t salt,
                                     float strength, void* stream) {
  const int64_t total = (int64_t)rows * cols * cap;
  if (total <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pair_pass_grid_kernel<<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      x, y, attrs, disp_x, disp_y, count, rows, cols, cap, salt, strength);
  return (int)cudaGetLastError();
}
