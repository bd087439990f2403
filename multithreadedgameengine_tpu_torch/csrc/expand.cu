// K4: the "expand" placement, for Hopper (sm_90a).
//
// Replaces the Pallas kernel benchmarks/probe_expand_kernel.py::expand
// (pl.pallas_call at :92, body _expand_kernel at :49). Given N entities'
// x, y (f32), each entity's distinct flat slot `flat` in [0, total), the
// entities sorted by slot (`order`, so flat[order[k]] ascends with k) and
// each output chunk's range [bounds[t], bounds[t+1]) in that order, it
// writes two f32 outputs of `total` slots ([n_chunks * 8, chunk / 8] as
// the reference lays them out, which is the flat slot order): x[g] at
// flat[g] for every entity of a chunk's range, 0.0 in every other slot.
// It only moves words (as uint32), so it is bit-equal with its plain
// version (zeros, then index_copy_).
//
// What bounds it: bytes. It reads x, y, order and flat once (16 B an
// entity) and writes both outputs (8 B a slot); at the probe's shapes
// (1,000,000 entities, 66 chunks of 131,072 slots) that is 85 MB, 25 us at
// the card's 3.35 TB/s, 69 MB of it the outputs. There are no operations to
// speak of. The reads through `order` are random: each of flat[g], x[g] and
// y[g] moves a 32-byte sector for its 4-byte word, so the entity side costs
// about 100 B an entity in practice.
//
// Design: every output byte is written once, in whole lines.
// - The grid is persistent: two blocks an SM, each owning one span of
//   consecutive slots (a multiple of 8), cut into tiles of kTile slots.
//   Tiles ignore chunk boundaries: the placed entities are those of
//   [bounds[0], bounds[n_chunks]), and their slots ascend over the whole
//   order, so a span's entities are one run of k.
// - A tile of both outputs is staged in shared memory: the tile's entities
//   are written into it (their slots are distinct: no atomics), then every
//   thread stores its 16-byte pieces of the tile with streaming stores and
//   zeroes them in shared memory for the next tile as it reads them.
// - Two warps find the span's first and end k by a 32-way search of the
//   sorted slots inside the chunk each span edge falls in; that is the only
//   search. The block then walks its entities in batches of kBatch, each
//   thread holding kPer of them, and places each batch into the tiles in
//   turn: a tile is finished when a loaded entity lies beyond it (or none
//   is left), which __syncthreads_or tells the block, so the next tile's
//   first entity needs no search.
// - The gathers are pipelined three deep: while batch i is placed, batch
//   i+1's flat, x and y loads and batch i+2's order loads are in flight.
// The sizes are measured choices (PERF.md): 256 threads and tiles of
// 2,048 slots beat 512 threads and 4,096; a third block on an SM, or a
// bulk asynchronous copy (cp.async.bulk) for the store, made it slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "pair_tile.cuh"  // device_limits

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                  // entities a thread holds of each batch
constexpr int kBatch = kThreads * kPer;  // entities a block loads at once
constexpr int kTile = 2048;              // slots of a tile, a multiple of 8
constexpr int kBlocksPerSm = 2;

int g_blocks_per_sm[pair_tile::kMaxDevices];

// The first k in [lo, hi) with flat[order[k]] >= key, or hi. flat[order[k]]
// ascends with k. Run by a whole warp; every lane returns the answer.
__device__ int warp_lower_bound(const int* __restrict__ order, const int* __restrict__ flat,
                                int lo, int hi, int key) {
  const int lane = threadIdx.x & 31;
  // the answer lies in [lo, hi], and hi is either the end or a k that
  // satisfies the test
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + lane * step;
    const bool ge = probe >= hi || flat[order[probe]] >= key;
    const unsigned m = __ballot_sync(0xffffffffu, ge);
    const int j = m ? __ffs(m) - 1 : 32;  // the first lane whose probe passes
    if (j == 0) return lo;
    if (j < 32) hi = min(lo + j * step, hi);
    lo = lo + (j - 1) * step + 1;
  }
  const int probe = lo + lane;
  const bool ge = probe >= hi || flat[order[probe]] >= key;
  const unsigned m = __ballot_sync(0xffffffffu, ge);
  return m ? lo + __ffs(m) - 1 : hi;
}

// The first placed entity (k in [bounds[0], bounds[n_chunks])) whose slot
// is s or more, for a slot s in [0, total]. Entities of chunk c's range lie
// in chunk c's slots, so only the range of the chunk holding s is searched.
// Warp-wide.
__device__ int first_at(const int* __restrict__ order, const int* __restrict__ flat,
                        const int* __restrict__ bounds, int n_chunks, int chunk, int s) {
  const int c = s / chunk;
  if (c >= n_chunks) return bounds[n_chunks];
  return warp_lower_bound(order, flat, bounds[c], bounds[c + 1], s);
}

// kPer entities of one batch, as a thread holds them: entity j is
// k = base + j * kThreads + threadIdx.x, valid while k < end.
struct Batch {
  int f[kPer];
  uint32_t x[kPer], y[kPer];
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
expand_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const int* __restrict__ order, const int* __restrict__ flat,
              const int* __restrict__ bounds, uint32_t* __restrict__ ox,
              uint32_t* __restrict__ oy, int n_chunks, int chunk) {
  __shared__ uint4 tile4[2 * kTile / 4];  // the tile of x, then of y: 16 KB
  __shared__ int range[2];
  uint32_t* const tx = reinterpret_cast<uint32_t*>(tile4);
  uint32_t* const ty = tx + kTile;

  // the block's span of slots, in whole groups of 8 (total < 2^31)
  const long long groups = static_cast<long long>(n_chunks) * (chunk / 8);
  const int span_lo = static_cast<int>(groups * blockIdx.x / gridDim.x) * 8;
  const int span_hi = static_cast<int>(groups * (blockIdx.x + 1) / gridDim.x) * 8;
  const int n_tiles = (span_hi - span_lo + kTile - 1) / kTile;
  if (n_tiles == 0) return;

  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int k = first_at(order, flat, bounds, n_chunks, chunk, warp == 0 ? span_lo : span_hi);
    if ((threadIdx.x & 31) == 0) range[warp] = k;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < 2 * kTile / 4; i += kThreads) tile4[i] = zero;
  __syncthreads();
  const int end = range[1];

  // the pipeline: `cur` is being placed (`left`: its entities not placed
  // yet), `nxt` gathered from `ord`, `ord` the order of the batch after
  int ord[kPer];
  Batch cur, nxt;
  unsigned left = 0;
  int base = range[0];  // nxt's first k; ord's is base + kBatch

  auto load_order = [&](int b) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = b + j * kThreads + static_cast<int>(threadIdx.x);
      ord[j] = k < end ? order[k] : -1;
    }
  };
  auto gather = [&]() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (ord[j] >= 0) {
        nxt.f[j] = flat[ord[j]];
        nxt.x[j] = x[ord[j]];
        nxt.y[j] = y[ord[j]];
      }
    }
  };
  load_order(base);
  gather();
  load_order(base + kBatch);

  for (int tile = 0;;) {
    const int lo = span_lo + tile * kTile;
    const int hi = min(lo + kTile, span_hi);
    bool pending = false;  // an entity of cur lies beyond this tile
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (left >> j & 1u) {
        const int f = cur.f[j];
        if (f < hi) {
          if (f >= lo) {  // always, for sorted slots
            tx[f - lo] = cur.x[j];
            ty[f - lo] = cur.y[j];
          }
          left &= ~(1u << j);
        } else {
          pending = true;
        }
      }
    }
    if (!__syncthreads_or(pending) && base < end) {
      // cur is placed and entities remain: move the pipeline on a batch
      cur = nxt;
      left = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        left |= static_cast<unsigned>(base + j * kThreads + static_cast<int>(threadIdx.x) < end)
                << j;
      }
      base += kBatch;
      gather();
      load_order(base + kBatch);
      continue;
    }
    // the tile is finished: store it in 16-byte pieces (lo and hi are
    // multiples of 8 slots), zeroing each in shared memory as it is read
    uint4* const sx = tile4;
    uint4* const sy = tile4 + kTile / 4;
    uint4* const gx = reinterpret_cast<uint4*>(ox + lo);
    uint4* const gy = reinterpret_cast<uint4*>(oy + lo);
    for (int i = threadIdx.x; i < (hi - lo) / 4; i += kThreads) {
      __stcs(gx + i, sx[i]);
      __stcs(gy + i, sy[i]);
      sx[i] = zero;
      sy[i] = zero;
    }
    if (++tile == n_tiles) break;
    __syncthreads();
  }
}

// Blocks of one launch over `total` slots: kBlocksPerSm on every SM (fewer
// if fewer fit), and at most one a tile.
cudaError_t plan_grid(long long total, int* grid) {
  pair_tile::DeviceLimits dev;
  cudaError_t err = pair_tile::device_limits(&dev);
  if (err != cudaSuccess) return err;
  int d = 0;
  err = cudaGetDevice(&d);  // device_limits checked it is below kMaxDevices
  if (err != cudaSuccess) return err;
  if (g_blocks_per_sm[d] == 0) {
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, expand_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (fit == 0) return cudaErrorInvalidConfiguration;
    g_blocks_per_sm[d] = min(fit, kBlocksPerSm);
  }
  const long long tiles = (total + kTile - 1) / kTile;
  const long long resident = static_cast<long long>(dev.sms) * g_blocks_per_sm[d];
  *grid = static_cast<int>(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

}  // namespace

// The launch's plan for `total` slots on the current device: plan[0] slots
// a tile, plan[1] blocks, plan[2] threads a block, plan[3] bytes of shared
// memory a block. Returns a cudaError_t (0 on success).
extern "C" int expand_plan(int total, int* plan) {
  int grid = 0;
  const cudaError_t err = plan_grid(total, &grid);
  if (err == cudaSuccess) {
    plan[0] = kTile;
    plan[1] = grid;
    plan[2] = kThreads;
    plan[3] = static_cast<int>(2 * kTile * sizeof(uint32_t) + 2 * sizeof(int));
  }
  return static_cast<int>(err);
}

// One K4 pass on `stream`. Pointers are device pointers: x, y (f32[n]),
// order, flat (int32[n]), bounds (int32[n_chunks + 1]); ox, oy (f32[n_chunks
// * chunk], 16-byte aligned). chunk must be a positive multiple of 8 and
// n_chunks * chunk below 2^31. Returns the launch's cudaError_t (0 on
// success), or that of the grid's planning.
extern "C" int expand_launch(const void* x, const void* y, const void* order, const void* flat,
                             const void* bounds, void* ox, void* oy, int n_chunks, int chunk,
                             void* stream) {
  if (n_chunks <= 0 || chunk <= 0 || chunk % 8 != 0 ||
      static_cast<long long>(n_chunks) * chunk >= INT_MAX ||
      (reinterpret_cast<uintptr_t>(ox) | reinterpret_cast<uintptr_t>(oy)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  const cudaError_t err = plan_grid(static_cast<long long>(n_chunks) * chunk, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const int*>(order), static_cast<const int*>(flat),
      static_cast<const int*>(bounds), static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      n_chunks, chunk);
  return static_cast<int>(cudaGetLastError());
}
