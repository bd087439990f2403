// The neighbour build, for Hopper (sm_90a): each row's (2r+1)^2 candidate
// cells of the binned table, their acceptance and the max_neighbors cap in
// one pass, writing the lists every consumer reads.
//
// What it computes (ops/spatial.py, demos/predators/spatial_worker.js:
// 157-270): for each of M rows (entities start .. start + M - 1) whose cell
// is (row, col), the cells (row + dr, col + dc), dr and dc in -r..r, row
// outer, each of `cap` slots of the binned table `[cells + 1, cap, F]` (f32
// records: channel 0 the id, -1 in an empty slot, then x, y and the
// declared fields). A cell outside the world reads as the table's all-empty
// sentinel row `cells`, and so does every cell of a row whose entity is not
// valid (its cell_id is `cells`). A slot is accepted when its id is >= 0
// and not the row's own, and 0 < d2 < visual_range^2 with dx and dy the
// record's x and y less the row's, d2 = dx*dx + dy*dy and visual_range^2
// in float32, each product rounded (nvcc runs with --fmad=false). The cap
// keeps the first k accepted slots in scan order. Outputs, S = (2r+1)^2 cap
// slots a row: ids int32 [M, S] (-1 where not kept), d2 f32 [M, S] (0
// where not kept), count int32 [M] (the accepted slots, at most k) and the
// payload f32 [M, S, F], the candidates' records as they lie in the table.
// Its plain version is ops/cuda_kernels.py::neighbor_build_plain, the
// cell-major assembly (ops/spatial.py::cellmajor_table) then
// accept_candidates and _cap_first_k; every output equals it bit for bit.
//
// It replaces no Pallas kernel: the JAX package builds its lists in XLA
// (multithreadedgameengine_tpu/ops/spatial.py). It exists because the
// build written as torch operations first writes every row's whole
// candidate payload by an indexed gather, then runs some twenty
// elementwise passes over [M, S] for the acceptance and the cap: 8.0 ms of
// the boids benchmark's 9.4 ms device frame (102,400 rows of 800 slots of
// 6 channels) and 57.6 of the 1M mixed one's 75 ms (1M prey rows of 576
// slots of 7).
//
// What bounds it: bytes written. The outputs are (F + 2) x 4 B a slot and
// 4 B a row, written once: 2.62 GB at 102,400 x 800 x 6 (0.78 ms at the
// card's 3.35 TB/s), 20.7 GB at 1M x 576 x 7 (6.19 ms). The table is small
// (21 MB for the boids cell, 47 MB for the mixed cell's) and each of its
// cells is read by every row of the 9 or 25 cells around it, so the reads
// should come from L2, if the rows that share cells run together.
//
// Design:
// - One warp a row, lanes on neighbouring words, so every load and store
//   is coalesced and the row's cap needs no shared counter: the running
//   rank is a ballot and __popc over 32 slots at a time, with the carry in
//   a register (the same in every lane).
// - Warps take the rows in the order `order` gives: the binning's stable
//   sort by cell (or a class's own sort of its cells), so the rows of one
//   cell run side by side and re-read the same table cells from L2.
// - A cell's record block, cap x F floats, is contiguous in the table and
//   in the row's payload (1,792 B for the prey, 768 B for the boids). The
//   warp copies it into shared memory with cp.async, 16 bytes a lane (4
//   when cap x F is not a multiple of 4), two blocks deep: the next cell's
//   copy is in flight while the current one is stored and tested. From
//   shared memory the block is stored to the payload with 16-byte streaming
//   stores (.cs: the outputs are read next by a tick, not by this kernel,
//   so they should not push the table out of L2), and the acceptance reads
//   channels 0-2 of each slot from the same copy.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const float* table;      // f32[cells + 1, cap, f]
  const int* cell_id;      // int32[N]: the entity's cell, `cells` if not valid
  const long long* order;  // int64[m]: the rows, start-relative, in visiting order
  const float* x;          // f32[N]
  const float* y;
  const float* vr;         // visual_range, f32[N]
  int* ids;                // int32[m, slots]
  float* d2;               // f32[m, slots]
  int* count;              // int32[m]
  float* payload;          // f32[m, slots, f]
  int start, m, rows, cols, radius, cap, f, k;
};

// One 4V-byte word from device memory into shared memory.
template <int V>
__device__ __forceinline__ void copy_in(float* dst, const float* src) {
  if constexpr (V == 4) {
    pair_tile::cp_async16(dst, src);
  } else {
    pair_tile::cp_async4(dst, src);
  }
}

// One 4V-byte word from shared memory to the payload, streaming.
template <int V>
__device__ __forceinline__ void copy_out(float* dst, const float* src) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));
  } else {
    __stcs(dst, *src);
  }
}

// V: floats a lane moves at once, 4 when cap * f is a multiple of 4 and the
// table and the payload are 16-byte aligned, else 1.
template <int V>
__global__ void __launch_bounds__(kWarps * 32) neighbor_build_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= a.m) return;  // the whole warp leaves together

  const int rec = a.cap * a.f;  // floats a cell
  const int words = rec / V;
  float* const bufs = smem + warp * 2 * rec;  // the warp's two blocks

  const long long i = __ldg(a.order + w);  // the row, start-relative
  const int g = a.start + static_cast<int>(i);  // its entity
  const int cells = a.rows * a.cols;
  const int cell = __ldg(a.cell_id + g);
  const bool valid = cell < cells;
  const int crow = valid ? cell / a.cols : 0;
  const int ccol = valid ? cell - crow * a.cols : 0;
  const float x = __ldg(a.x + g), y = __ldg(a.y + g);
  const float vr = __ldg(a.vr + g);
  const float vr2 = vr * vr;
  const int side = 2 * a.radius + 1;
  const int blocks = side * side;
  const long long slots = static_cast<long long>(blocks) * a.cap;
  int* out_ids = a.ids + i * slots;
  float* out_d2 = a.d2 + i * slots;
  float* out_p = a.payload + i * slots * a.f;

  // block b's cell of the table: the sentinel outside the world or for a
  // row that is not valid
  auto fetch = [&](int b) {
    const int r = crow + b / side - a.radius;
    const int c = ccol + b % side - a.radius;
    const bool in = valid && r >= 0 && r < a.rows && c >= 0 && c < a.cols;
    const float* src = a.table + static_cast<long long>(in ? r * a.cols + c : cells) * rec;
    float* dst = bufs + (b & 1) * rec;
    for (int j = lane; j < words; j += 32) copy_in<V>(dst + j * V, src + j * V);
    pair_tile::cp_async_commit();
  };

  fetch(0);
  int carry = 0;  // accepted slots so far (every lane holds the same)
  for (int b = 0; b < blocks; ++b) {
    if (b + 1 < blocks) {
      fetch(b + 1);  // its buffer was last read in block b - 1
      pair_tile::cp_async_wait_group<1>();
    } else {
      pair_tile::cp_async_wait_group<0>();
    }
    __syncwarp();
    const float* cur = bufs + (b & 1) * rec;
    float* dst = out_p + static_cast<long long>(b) * rec;
    for (int j = lane; j < words; j += 32) copy_out<V>(dst + j * V, cur + j * V);

    const long long base = static_cast<long long>(b) * a.cap;
    for (int s0 = 0; s0 < a.cap; s0 += 32) {
      const int s = s0 + lane;
      int id = -1;
      float dd = 0.0f;
      bool ok = false;
      if (s < a.cap) {
        const float* r = cur + s * a.f;
        id = static_cast<int>(r[0]);  // truncation, as .to(torch.int32)
        const float dx = r[1] - x;
        const float dy = r[2] - y;
        dd = dx * dx + dy * dy;
        ok = valid && id >= 0 && id != g && dd < vr2 && dd > 0.0f;
      }
      const unsigned took = __ballot_sync(kAll, ok);
      const int rank = carry + __popc(took & ((1u << lane) - 1u)) + 1;  // 1-based
      const bool keep = ok && rank <= a.k;
      if (s < a.cap) {
        __stcs(out_ids + base + s, keep ? id : -1);
        __stcs(out_d2 + base + s, keep ? dd : 0.0f);
      }
      carry += __popc(took);
    }
    __syncwarp();  // every lane is done with `cur` before block b + 2 refills it
  }
  if (lane == 0) a.count[i] = carry < a.k ? carry : a.k;
}

}  // namespace

// Build the lists of rows start .. start + m - 1 on `stream`: `order` the
// rows (start-relative) in the order the warps take them, a permutation of
// 0 .. m - 1 (any order gives the same outputs); rows x cols the grid,
// `radius` the scan radius in cells, cap the table's slots a cell, f its
// channels, k max_neighbors. Returns the launch's cudaError_t (0 on
// success).
extern "C" int neighbor_build_launch(const void* table, const void* cell_id, const void* order,
                                     const void* x, const void* y, const void* vr, void* ids,
                                     void* d2, void* count, void* payload, int start, int m,
                                     int rows, int cols, int radius, int cap, int f, int k,
                                     void* stream) {
  if (m <= 0 || start < 0 || rows <= 0 || cols <= 0 || radius < 0 || cap <= 0 || f < 3 ||
      k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.table = static_cast<const float*>(table);
  a.cell_id = static_cast<const int*>(cell_id);
  a.order = static_cast<const long long*>(order);
  a.x = static_cast<const float*>(x);
  a.y = static_cast<const float*>(y);
  a.vr = static_cast<const float*>(vr);
  a.ids = static_cast<int*>(ids);
  a.d2 = static_cast<float*>(d2);
  a.count = static_cast<int*>(count);
  a.payload = static_cast<float*>(payload);
  a.start = start;
  a.m = m;
  a.rows = rows;
  a.cols = cols;
  a.radius = radius;
  a.cap = cap;
  a.f = f;
  a.k = k;
  const int rec = cap * f;
  const bool wide = rec % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(payload) % 16 == 0;
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(rec) * kWarps;
  const int grid = (m + kWarps - 1) / kWarps;
  void (*kernel)(const Args) = wide ? &neighbor_build_kernel<4> : &neighbor_build_kernel<1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
