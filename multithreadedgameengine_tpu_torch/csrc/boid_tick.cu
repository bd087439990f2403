// The boid tick, for Hopper (sm_90a): one pass over each boid's neighbour
// slots that gives the row's new rigid_body.ax and rigid_body.ay. One
// template serves Boid and Prey: the prey tick is the boid tick plus Prey's
// neighbour hook, the flee from predators (kFlee).
//
// What it computes (demos/predators/boid.js:116-125): ax + flocking + mouse
// + margin, for x and for y, with
// - applyFlockingBehaviors (boid.js:137-240): over the live slots (id >= 0)
//   whose neighbour is not the mouse (entity type 0, boid.js:180), the
//   separation sums -d/d2 of those with 0 < d2 < protected_range^2
//   (boid.js:192-196), and, over the rest of the same entity type, the
//   count and the sums of x, y, vx and vy for cohesion (boid.js:221-226)
//   and alignment (boid.js:228-231);
// - the prey tick only (prey.js:154-169): over the same rest, the sums of
//   -d/d2 of the neighbours of the predators' entity type with d2 > 0,
//   added as flee * (predator_avoid_factor * dt) after the separation;
// - avoidMouse (boid.js:281-316): a push of 1000 / d2 away from world row
//   0 when button 0 is down, inputs.mouse_x != 0 and the mouse (id 0) is in
//   the list with d2 > 0;
// - keepWithinBounds (boid.js:322-341): turn_factor at either margin.
// Its plain versions are ops/cuda_kernels.py::boid_tick_plain and
// prey_tick_plain, which restate models/boids.py's flocking_forces,
// avoid_mouse_force and keep_within_bounds_force, and Prey's flee hook, on
// tensors. Every operation is the plain
// version's, in float32, in its order (nvcc runs with --fmad=false and IEEE
// division): 1 / d2, then the product; the entity type truncated from its
// float channel. Only the order in which each row's sums add their terms
// differs from torch.sum.
//
// It replaces no Pallas kernel: the JAX package writes the ticks in XLA
// (multithreadedgameengine_tpu/models/boids.py, predators.py). It exists
// because a tick written as torch operations is some 150 (Boid) or 290
// (Prey) masked [N, S] operations, each reading strided payload channels
// and writing [N, S] temporaries: half the device frame of the boids
// benchmark (102,400 rows of 800 slots) and of the 1M mixed one (1M prey
// rows of 576 slots).
//
// What bounds it: bytes. It must read every slot's id (4 B) and, for the
// live slots alone, d2 (4 B) and the neighbour's five payload channels (20
// B of its 24- or 28-byte record), plus the row's fields (13 for Boid, 14
// for Prey) and 8 B of output. At 102,400 x 800 slots with 10% of them live
// that is 328 MB of ids and about 200 MB of the rest, about 0.16 ms at the
// card's 3.35 TB/s; reading every slot's d2 and payload instead would be
// 2.6 GB, 0.78 ms. At 1M x 576 slots with 9.4% live: 2.30 GB of ids and
// 1.36 GB of the rest, about 1.1 ms.
//
// Design: one warp a row, so the row's sums need no shared memory and no
// atomics, and lanes on neighbouring slots make every load coalesced.
// - The lanes stride over the slots, kUnroll x 32 at a time: first the ids
//   of all kUnroll slots a lane holds, then, for the live ones only, d2 and
//   the five channels in one round, so an empty slot costs its 4 id bytes
//   and two rounds of loads are in flight for kUnroll slots. vx and vy are
//   loaded with x and y: they lie in the same 32-byte sectors of the
//   record, so loading them only for same-type neighbours would save no
//   bytes and add a round.
// - Each lane keeps nine sums (separation x and y, cohesion x and y,
//   alignment x and y, the same-type count, the mouse's presence and d2),
//   and the prey tick two more (flee x and y); five butterfly shuffles
//   reduce them, and lane 0 finishes the row in the plain version's order
//   and writes it.
// - Live slots of a cell form a prefix of its slots, so the live slots a
//   warp loads lie close together and most sectors it touches are full.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // rows a block
constexpr int kUnroll = 4;   // slots a lane holds at once
constexpr int kMouse = 0;    // the mouse: entity type 0 and row 0 (gameEngine.js:278-281)
constexpr unsigned kAll = 0xffffffffu;

// The neighbour columns, in this order: x, y, vx, vy, entity type (f32).
enum Col { kX, kY, kVx, kVy, kType, kCols };

struct Args {
  const int* ids;                // int32[count, slots], -1 = empty
  const float* d2;               // f32[count, slots]
  const float* col[kCols];       // element (row, slot) at col + row * col_row + slot * col_slot
  long long col_row[kCols];
  long long col_slot[kCols];
  const float* own[6];           // the row's x, y, vx, vy, ax, ay (f32[count])
  const int* type;               // the row's entity type (int32[count])
  const float* flock[6];         // protected_range, centering, avoid, matching, turn, margin
  const unsigned char* mouse_down;  // bool: button 0
  const float* mouse_x;          // inputs.mouse_x
  const float* mouse_px;         // world row 0's x and y
  const float* mouse_py;
  float* out_ax;                 // f32[count]
  float* out_ay;
  int count, slots;
  float dt, world_w, world_h;
  const float* flee_factor;      // the prey tick's predator_avoid_factor (f32[count])
  int predator_type;             // the prey tick's predators' entity type
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// kFlee: the prey tick (Prey's flee hook); without it, Boid's tick.
template <bool kFlee>
__global__ void __launch_bounds__(kWarps * 32) boid_tick_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.count) return;  // the whole warp leaves together

  const float x = ld(a.own[0] + row), y = ld(a.own[1] + row);
  const int type = __ldg(a.type + row);
  const float pr = ld(a.flock[0] + row);
  const float prot2 = pr * pr;
  const int* ids = a.ids + static_cast<long long>(row) * a.slots;
  const float* d2s = a.d2 + static_cast<long long>(row) * a.slots;
  const float* col[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) col[c] = a.col[c] + row * a.col_row[c];

  float sep_x = 0.0f, sep_y = 0.0f, cen_x = 0.0f, cen_y = 0.0f;
  float vel_x = 0.0f, vel_y = 0.0f, mouse_d2 = 0.0f;
  float flee_x = 0.0f, flee_y = 0.0f;
  int same_n = 0, mouse_in = 0;
  for (int base = lane; base < a.slots; base += 32 * kUnroll) {
    int id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + 32 * u;
      id[u] = s < a.slots ? __ldg(ids + s) : -1;
    }
    float d2[kUnroll], v[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = base + 32 * u;
      d2[u] = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[u][c] = 0.0f;
      if (id[u] >= 0) {
        d2[u] = ld(d2s + s);
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[u][c] = ld(col[c] + s * a.col_slot[c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (id[u] < 0) continue;
      if (id[u] == kMouse) {
        mouse_in = 1;
        mouse_d2 += d2[u];
      }
      const int ntype = static_cast<int>(v[u][kType]);  // truncation, as .to(torch.int32)
      if (ntype == kMouse) continue;
      if (d2[u] < prot2 && d2[u] > 0.0f) {
        // separation; the neighbour then takes no part in the same-type sums
        const float inv = 1.0f / d2[u];
        const float dx = v[u][kX] - x;
        const float dy = v[u][kY] - y;
        sep_x += -dx * inv;
        sep_y += -dy * inv;
      } else {
        if (ntype == type) {
          ++same_n;
          cen_x += v[u][kX];
          cen_y += v[u][kY];
          vel_x += v[u][kVx];
          vel_y += v[u][kVy];
        }
        if constexpr (kFlee) {
          // Prey's hook sees the rest: not the mouse, not separated
          if (ntype == a.predator_type && d2[u] > 0.0f) {
            const float inv = 1.0f / d2[u];
            const float dx = v[u][kX] - x;
            const float dy = v[u][kY] - y;
            flee_x += -dx * inv;
            flee_y += -dy * inv;
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sep_x += __shfl_xor_sync(kAll, sep_x, o);
    sep_y += __shfl_xor_sync(kAll, sep_y, o);
    cen_x += __shfl_xor_sync(kAll, cen_x, o);
    cen_y += __shfl_xor_sync(kAll, cen_y, o);
    vel_x += __shfl_xor_sync(kAll, vel_x, o);
    vel_y += __shfl_xor_sync(kAll, vel_y, o);
    mouse_d2 += __shfl_xor_sync(kAll, mouse_d2, o);
    same_n += __shfl_xor_sync(kAll, same_n, o);
    mouse_in |= __shfl_xor_sync(kAll, mouse_in, o);
    if constexpr (kFlee) {
      flee_x += __shfl_xor_sync(kAll, flee_x, o);
      flee_y += __shfl_xor_sync(kAll, flee_y, o);
    }
  }
  if (lane != 0) return;

  // flocking_forces: cohesion, alignment, separation
  const float dt = a.dt;
  const float vx = ld(a.own[2] + row), vy = ld(a.own[3] + row);
  const float centering = ld(a.flock[1] + row), avoid = ld(a.flock[2] + row);
  const float matching = ld(a.flock[3] + row);
  const bool has_same = same_n > 0;
  const float inv_n = has_same ? 1.0f / static_cast<float>(same_n) : 0.0f;
  float fx = has_same ? (cen_x * inv_n - x) * centering * dt : 0.0f;
  float fy = has_same ? (cen_y * inv_n - y) * centering * dt : 0.0f;
  fx = fx + (has_same ? (vel_x * inv_n - vx) * matching * dt : 0.0f);
  fy = fy + (has_same ? (vel_y * inv_n - vy) * matching * dt : 0.0f);
  fx = fx + sep_x * avoid * dt;
  fy = fy + sep_y * avoid * dt;
  if constexpr (kFlee) {
    // Prey.tick: predator_avoid_factor * dt first, then the product
    const float flee = ld(a.flee_factor + row) * dt;
    fx = fx + flee_x * flee;
    fy = fy + flee_y * flee;
  }

  // avoid_mouse_force
  const bool engaged = (*a.mouse_down != 0) && (*a.mouse_x != 0.0f) && mouse_in &&
                       mouse_d2 > 0.0f;
  const float mdx = *a.mouse_px - x;
  const float mdy = *a.mouse_py - y;
  const float safe_d2 = mouse_d2 > 0.0f ? mouse_d2 : 1.0f;
  const float mx = engaged ? -(mdx / safe_d2) * 1000.0f * dt : 0.0f;
  const float my = engaged ? -(mdy / safe_d2) * 1000.0f * dt : 0.0f;

  // keep_within_bounds_force
  const float margin = ld(a.flock[5] + row);
  const float turn = ld(a.flock[4] + row) * dt;
  const float bx = (x < margin ? turn : 0.0f) - (x > a.world_w - margin ? turn : 0.0f);
  const float by = (y < margin ? turn : 0.0f) - (y > a.world_h - margin ? turn : 0.0f);

  a.out_ax[row] = ld(a.own[4] + row) + fx + mx + bx;
  a.out_ay[row] = ld(a.own[5] + row) + fy + my + by;
}

// The tick's arguments from the launch's: `ptrs`, device pointers in this
// order: ids, d2, the five neighbour columns (x, y, vx, vy, entity type), the
// row's x, y, vx, vy, ax, ay and entity type, the six flocking fields
// (protected_range, centering_factor, avoid_factor, matching_factor,
// turn_factor, margin), mouse_down (bool), inputs.mouse_x, world row 0's x
// and y, the outputs ax and ay, then, with kFlee, the row's
// predator_avoid_factor. `strides`: each column's row stride, then each
// column's slot stride, in elements.
template <bool kFlee>
int launch(const void* const* ptrs, const long long* strides, int count, int slots, float dt,
           float world_w, float world_h, int predator_type, void* stream) {
  if (count <= 0 || slots < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  int k = 0;
  a.ids = static_cast<const int*>(ptrs[k++]);
  a.d2 = static_cast<const float*>(ptrs[k++]);
  for (int c = 0; c < kCols; ++c) {
    a.col[c] = static_cast<const float*>(ptrs[k++]);
    a.col_row[c] = strides[c];
    a.col_slot[c] = strides[kCols + c];
  }
  for (int f = 0; f < 6; ++f) a.own[f] = static_cast<const float*>(ptrs[k++]);
  a.type = static_cast<const int*>(ptrs[k++]);
  for (int f = 0; f < 6; ++f) a.flock[f] = static_cast<const float*>(ptrs[k++]);
  a.mouse_down = static_cast<const unsigned char*>(ptrs[k++]);
  a.mouse_x = static_cast<const float*>(ptrs[k++]);
  a.mouse_px = static_cast<const float*>(ptrs[k++]);
  a.mouse_py = static_cast<const float*>(ptrs[k++]);
  a.out_ax = static_cast<float*>(const_cast<void*>(ptrs[k++]));
  a.out_ay = static_cast<float*>(const_cast<void*>(ptrs[k++]));
  a.count = count;
  a.slots = slots;
  a.dt = dt;
  a.world_w = world_w;
  a.world_h = world_h;
  a.flee_factor = kFlee ? static_cast<const float*>(ptrs[k++]) : nullptr;
  a.predator_type = predator_type;
  const int grid = (count + kWarps - 1) / kWarps;
  boid_tick_kernel<kFlee><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One boid tick on `stream` (`ptrs` and `strides` as `launch` reads them).
// Returns the launch's cudaError_t (0 on success).
extern "C" int boid_tick_launch(const void* const* ptrs, const long long* strides, int count,
                                int slots, float dt, float world_w, float world_h,
                                void* stream) {
  return launch<false>(ptrs, strides, count, slots, dt, world_w, world_h, -1, stream);
}

// One prey tick on `stream`: the boid tick with Prey's flee from the
// neighbours of entity type `predator_type` (`ptrs` ending in the rows'
// predator_avoid_factor). Returns the launch's cudaError_t (0 on success).
extern "C" int prey_tick_launch(const void* const* ptrs, const long long* strides, int count,
                                int slots, float dt, float world_w, float world_h,
                                int predator_type, void* stream) {
  return launch<true>(ptrs, strides, count, slots, dt, world_w, world_h, predator_type,
                      stream);
}
