// What the tiled pair passes K2 (pair_pass_symmetric.cu) and K3
// (pair_pass_grid.cu) share: the cell tile a block stages, the walk of a
// block's threads over the staged slots, the block-wide prefix sum that
// hands every thread an occupied slot, the choice of the tile from the
// capacity, and the coincident-pair hash direction.
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
// is one contiguous run of memory in both layouts.
constexpr int kTiles[][2] = {{8, 32}, {4, 32}, {8, 16}, {4, 16}, {8, 8}, {4, 8},
                             {2, 8},  {2, 4},  {1, 4},  {1, 2},  {1, 1}};
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

struct TilePlan {
  int tr, tc;
  size_t smem;
};

// The tile for a kernel that stages `box_words` words a box cell and keeps
// `tile_words` a tile cell, both sized for full cells: the first of kTiles
// within kPreferredSmem, else the first within `max_smem`. Every cell of
// the box may be full at once, so no staged array can overflow. False when
// even a 1 x 1 tile does not fit.
inline bool plan_tile(size_t box_words, size_t tile_words, size_t max_smem, TilePlan* out) {
  for (int pass = 0; pass < 2; ++pass) {
    const size_t limit = pass == 0 ? std::min(kPreferredSmem, max_smem) : max_smem;
    for (const auto& t : kTiles) {
      const size_t bytes = tile_smem_bytes(t[0], t[1], box_words, tile_words);
      if (bytes <= limit) {
        *out = TilePlan{t[0], t[1], bytes};
        return true;
      }
    }
  }
  return false;
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

// The current device's dynamic shared memory limit for one block (227 KB
// on an H100), read once per device.
inline cudaError_t device_max_smem(size_t* out) {
  static size_t known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    int bytes = 0;
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    known[dev] = (size_t)bytes;
  }
  *out = known[dev];
  return cudaSuccess;
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
