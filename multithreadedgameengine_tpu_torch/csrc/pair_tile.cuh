// What the tiled pair passes K1 (pair_pass_resident.cu), K2
// (pair_pass_symmetric.cu) and K3 (pair_pass_grid.cu) share: the cell tile
// a block stages, the walk of a block's threads over the staged slots, the
// occupant count of a staged slot-major cell (K1, K2), the block-wide
// prefix sum that hands every thread an occupied slot, the choice of the
// tile and the grid of blocks from the capacity, the grid and the card, and
// the coincident-pair hash direction.
//
// A block owns a tile of TR x TC interior cells of the grid (blockIdx.x the
// column tile, blockIdx.y the row tile) and stages the tile plus its
// one-cell ring, the "box" of (TR+2) x (TC+2) cells, in shared memory. All
// index arithmetic is 32-bit: the wrappers refuse grids of 2^31 words or
// more.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"

namespace pair_tile {

constexpr int kThreads = 256;  // threads per block; every tile has at most 256 cells
constexpr int kMaxDevices = 64;

// Tiles tried in order, (rows, cols) of cells: wide first, since a box row
// is one contiguous run of memory in both layouts. Each needs less shared
// memory than the one before it.
constexpr int kTiles[][2] = {{8, 32}, {4, 32}, {8, 16}, {4, 16}, {8, 8}, {4, 8},
                             {2, 8},  {2, 4},  {1, 4},  {1, 2},  {1, 1}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);
// A tile whose staging fits in this much shared memory leaves room for
// three blocks on one SM; larger ones are taken only when no tile fits it.
constexpr size_t kPreferredSmem = 64 * 1024;

// The shared memory of a tile, in bytes: the kernel's `box_words` 4-byte
// words for each box cell and `tile_words` for each tile cell, plus per box
// cell its grid cell, owner code and occupant count (3 words), per tile cell
// its prefix sum (1 word), and 32 warp totals.
inline size_t tile_smem_bytes(int tr, int tc, size_t box_words, size_t tile_words) {
  const size_t nb = (size_t)(tr + 2) * (tc + 2);
  const size_t nt = (size_t)tr * tc;
  return 4 * (nb * (box_words + 3) + nt * (tile_words + 1) + 32);
}

// What a tile is planned against on the current device, read once per
// device: a block's dynamic shared memory (227 KB on an H100) and the
// number of SMs (132 on an H100 SXM).
struct DeviceLimits {
  size_t max_smem;
  int sms;
};

inline cudaError_t device_limits(DeviceLimits* out) {
  static DeviceLimits known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[dev].sms == 0) {
    int bytes = 0;
    int sms = 0;
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    known[dev] = DeviceLimits{(size_t)bytes, sms};
  }
  *out = known[dev];
  return cudaSuccess;
}

struct TilePlan {
  int tr, tc;
  size_t smem;
};

// Blocks of a tr x tc tile over the interior of a grid of rows x cols cells
// (border included).
inline int64_t tile_blocks(int tr, int tc, int rows, int cols) {
  return (int64_t)((rows - 2 + tr - 1) / tr) * ((cols - 2 + tc - 1) / tc);
}

// The tile for a kernel that stages `box_words` words a box cell and keeps
// `tile_words` a tile cell, both sized for full cells, over a grid of rows x
// cols cells: the first of kTiles within kPreferredSmem, else the first
// within the device's limit; then, while that tile's blocks would leave SMs
// of the card without a block, the next smaller tile: a grid too small to
// fill the card runs faster on more, smaller blocks (measured in PERF.md
// for K1 on the 10k demo layout). Every cell of the box may be full at
// once, so no staged array can overflow.
// False when even a 1 x 1 tile does not fit.
inline bool plan_tile(size_t box_words, size_t tile_words, const DeviceLimits& dev, int rows,
                      int cols, TilePlan* out) {
  int i = -1;
  for (int pass = 0; pass < 2 && i < 0; ++pass) {
    const size_t limit = pass == 0 ? std::min(kPreferredSmem, dev.max_smem) : dev.max_smem;
    for (int k = 0; k < kNumTiles && i < 0; ++k) {
      if (tile_smem_bytes(kTiles[k][0], kTiles[k][1], box_words, tile_words) <= limit) i = k;
    }
  }
  if (i < 0) return false;
  while (i + 1 < kNumTiles && tile_blocks(kTiles[i][0], kTiles[i][1], rows, cols) < dev.sms) ++i;
  const int tr = kTiles[i][0];
  const int tc = kTiles[i][1];
  *out = TilePlan{tr, tc, tile_smem_bytes(tr, tc, box_words, tile_words)};
  return true;
}

// The tile and the grid of blocks of one launch over a grid of rows x cols
// cells (border included) with `cap` slots a cell; an error when the grid
// has no interior cell, when no tile fits, or when it needs too many rows
// of blocks.
inline cudaError_t plan_launch(size_t box_words, size_t tile_words, int cap, int rows, int cols,
                               TilePlan* plan, dim3* grid) {
  if (rows < 3 || cols < 3 || cap < 1) return cudaErrorInvalidValue;
  DeviceLimits dev;
  const cudaError_t err = device_limits(&dev);
  if (err != cudaSuccess) return err;
  if (!plan_tile(box_words, tile_words, dev, rows, cols, plan)) return cudaErrorInvalidValue;
  *grid = dim3((unsigned)((cols - 2 + plan->tc - 1) / plan->tc),
               (unsigned)((rows - 2 + plan->tr - 1) / plan->tr));
  if (grid->y > 65535u) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// The largest capacity whose 1 x 1 tile fits in `max_smem`, for a kernel
// whose cells take `box_words(cap)` and `tile_words(cap)` words.
template <typename BoxWords, typename TileWords>
inline int max_capacity(BoxWords box_words, TileWords tile_words, size_t max_smem) {
  int lo = 0;
  int hi = 1 << 20;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_smem_bytes(1, 1, box_words(mid), tile_words(mid)) <= max_smem) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device
// (needed above 48 KB); `granted[dev]` remembers what was set.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

// A block's tile and box. `rows`/`cols` count the grid's one-cell border;
// the interior cells are rows 1..rows-2, cols 1..cols-2.
struct Box {
  int rows, cols, tr, tc;
  int r0, c0;  // the tile's first cell, in grid coordinates
  int bc;      // box width, tc + 2
  int nb, nt;  // cells of the box and of the tile

  __device__ Box(int rows_, int cols_, int tr_, int tc_)
      : rows(rows_), cols(cols_), tr(tr_), tc(tc_) {
    r0 = 1 + (int)blockIdx.y * tr;
    c0 = 1 + (int)blockIdx.x * tc;
    bc = tc + 2;
    nb = (tr + 2) * bc;
    nt = tr * tc;
  }

  // Fills, for every box cell b, `gcell[b]`: its grid cell (row * cols +
  // col), -1 outside the grid; and `own[b]`: the tile cell it is (>= 0)
  // for a tile cell inside the grid's interior, -1 for a border cell whose
  // outputs this block writes (a border cell belongs to the tile of the
  // nearest interior cell), -2 for every other box cell.
  __device__ void index_cells(int* gcell, int* own) const {
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      const int br = b / bc;
      const int bcol = b - br * bc;
      const int rr = r0 - 1 + br;
      const int cc = c0 - 1 + bcol;
      const bool in_grid = rr < rows && cc < cols;
      gcell[b] = in_grid ? rr * cols + cc : -1;
      const int ir = min(max(rr, 1), rows - 2);
      const int ic = min(max(cc, 1), cols - 2);
      const bool mine = in_grid && ir >= r0 && ir < r0 + tr && ic >= c0 && ic < c0 + tc;
      own[b] = !mine ? -2 : (rr == ir && cc == ic) ? (br - 1) * tc + (bcol - 1) : -1;
    }
  }

  // The box cell of tile cell t.
  __device__ int box_cell(int t) const {
    const int r = t / tc;
    return (r + 1) * bc + (t - r * tc) + 1;
  }
};

// The walk of a block's threads over `n_outer x n_inner` elements, element
// e = outer * n_inner + inner, thread t starting at e = t and stepping by
// blockDim.x, with no division after the start.
struct Walk {
  int outer, inner;
  int n_inner, d_outer, d_inner;

  __device__ explicit Walk(int n_inner_) : n_inner(n_inner_) {
    outer = (int)threadIdx.x / n_inner;
    inner = (int)threadIdx.x - outer * n_inner;
    d_outer = (int)blockDim.x / n_inner;
    d_inner = (int)blockDim.x - d_outer * n_inner;
  }

  __device__ void next() {
    outer += d_outer;
    inner += d_inner;
    if (inner >= n_inner) {
      inner -= n_inner;
      ++outer;
    }
  }
};

// The occupants of every box cell of a slot-major stage, `sm` the staged
// meta [cap][nb] (0 = empty slot): the slots before the cell's first empty
// slot above plane 0, none when planes 0 and 1 are both empty, into
// `cnt[b]`. Cells fill their slots rank-ascending and the only occupied
// slot whose meta can be 0 is entity 0's, always on plane 0, so the
// occupied slots are exactly these. Every thread of the block calls it.
__device__ __forceinline__ void count_occupants(const int* sm, int nb, int cap, int* cnt) {
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
}

// Inclusive prefix sum of one int per thread over the block. Every thread
// of the block calls it; blockDim.x is a multiple of 32. `wsum` is 32 ints
// of shared memory; on return wsum[w] is the sum through warp w, so the
// block's total is wsum[blockDim.x / 32 - 1].
__device__ __forceinline__ int block_inclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int s = lane < n_warps ? wsum[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += u;
    }
    if (lane < n_warps) wsum[lane] = s;
  }
  __syncthreads();
  return warp > 0 ? v + wsum[warp - 1] : v;
}

// The tile cell holding occupied slot k of the tile: the first t with
// incl[t] > k, `incl` the inclusive prefix sum of the tile's counts.
__device__ __forceinline__ int find_cell(const int* incl, int nt, int k) {
  int lo = 0;
  int hi = nt - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (incl[mid] > k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// torch.clamp(v, lo, hi) = min(max(v, lo), hi), NaN kept.
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// ops/physics.py::_pair_hash_dir in native uint32 arithmetic: the unit
// direction of an exactly coincident pair.
__device__ __forceinline__ void pair_hash_dir(int32_t i, int32_t j, uint32_t salt, float* ux,
                                              float* uy) {
  const uint32_t a = (uint32_t)min(i, j);
  const uint32_t b = (uint32_t)max(i, j);
  uint32_t h = (a * 0x9E3779B1u) ^ (b * 0x85EBCA77u) ^ salt;
  h = h ^ (h >> 15);
  h = h * 0x2C1B3C6Du;
  h = h ^ (h >> 12);
  const float hx = (float)(int32_t)(h & 0xFFFFu) - 32767.5f;
  const float hy = (float)(int32_t)((h >> 16) & 0xFFFFu) - 32767.5f;
  const float inv = 1.0f / sqrtf(hx * hx + hy * hy);
  *ux = hx * inv;
  *uy = hy * inv;
}

}  // namespace pair_tile
