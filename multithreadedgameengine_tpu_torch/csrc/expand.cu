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
// It only moves words, so it is bit-equal with its plain version (zeros,
// then index_copy_).
//
// What bounds it: bytes. It reads x, y, order and flat once (16 B an
// entity) and writes both outputs (8 B a slot); at the probe's shapes
// (1,000,000 entities, 66 chunks of 131,072 slots) that is 85 MB, 25 us at
// the card's 3.35 TB/s. There are no operations to speak of. The reads
// through `order` are random (one 32-byte sector for a 4-byte word), so the
// entity side costs more than its 16 B an entity in practice.
//
// Design. The TPU kernel runs one program per chunk, in order, zeroing its
// block and then walking its range. The probe's 66 chunks are half the
// H100's 132 SMs, and a slot must be zeroed before it is written, which
// only one block can order (with __syncthreads). So each chunk is split
// over blocks of kSubSlots slots, and each block owns its slots outright:
// - two warps find the block's entity range, the first and the last k of
//   [bounds[t], bounds[t+1]) whose slot falls in the block's slots, by a
//   32-way search over the ascending flat[order[k]] (three rounds of two
//   dependent loads at the probe's ~15,000 entities a chunk);
// - meanwhile every thread zeroes its share of the block's slots with
//   16-byte stores;
// - after __syncthreads, the threads write the range's entities, one each
//   in turn.
// No slot is zeroed after it was written and no two blocks touch one slot,
// so there are no atomics.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
// slots a block owns: 64 KB of each output (16 blocks a chunk at the probe)
constexpr int kSubSlots = 8192;

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

__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const int* __restrict__ order, const int* __restrict__ flat,
              const int* __restrict__ bounds, float* __restrict__ ox,
              float* __restrict__ oy, int chunk, int blocks_per_chunk) {
  const int t = blockIdx.x / blocks_per_chunk;
  const int s_lo = (blockIdx.x % blocks_per_chunk) * kSubSlots;
  const int s_hi = min(s_lo + kSubSlots, chunk);
  const int base = t * chunk;  // total < 2^31 (the wrapper checks)
  __shared__ int range[2];

  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int k = warp_lower_bound(order, flat, bounds[t], bounds[t + 1],
                                   base + (warp == 0 ? s_lo : s_hi));
    if ((threadIdx.x & 31) == 0) range[warp] = k;
  }

  // zero the block's slots: chunk is a multiple of 8 and kSubSlots of 4,
  // so the block's first slot is 16-byte aligned and its count a multiple
  // of 4 (the scalar loop covers any rest)
  const int n_slots = s_hi - s_lo;
  const int n4 = n_slots / 4;
  float4* ox4 = reinterpret_cast<float4*>(ox + base + s_lo);
  float4* oy4 = reinterpret_cast<float4*>(oy + base + s_lo);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    ox4[i] = zero;
    oy4[i] = zero;
  }
  for (int i = 4 * n4 + threadIdx.x; i < n_slots; i += kThreads) {
    ox[base + s_lo + i] = 0.f;
    oy[base + s_lo + i] = 0.f;
  }
  // the zeros land before any entity's word, and the range is known
  __syncthreads();

  for (int k = range[0] + threadIdx.x; k < range[1]; k += kThreads) {
    const int g = order[k];
    const int f = flat[g];
    ox[f] = x[g];
    oy[f] = y[g];
  }
}

}  // namespace

// One K4 pass on `stream`. Pointers are device pointers: x, y (f32[n]),
// order, flat (int32[n]), bounds (int32[n_chunks + 1]); ox, oy (f32[n_chunks
// * chunk]). chunk must be a positive multiple of 8 and n_chunks * chunk
// below 2^31. Returns the launch's cudaError_t (0 on success).
extern "C" int expand_launch(const void* x, const void* y, const void* order, const void* flat,
                             const void* bounds, void* ox, void* oy, int n_chunks, int chunk,
                             void* stream) {
  if (n_chunks <= 0 || chunk <= 0 || chunk % 8 != 0 ||
      static_cast<long long>(n_chunks) * chunk >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (chunk + kSubSlots - 1) / kSubSlots;
  const long long blocks = static_cast<long long>(n_chunks) * per;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  expand_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int*>(order), static_cast<const int*>(flat),
      static_cast<const int*>(bounds), static_cast<float*>(ox), static_cast<float*>(oy),
      chunk, per);
  return static_cast<int>(cudaGetLastError());
}
