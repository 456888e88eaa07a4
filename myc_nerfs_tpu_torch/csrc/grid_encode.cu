// Brick3 multiresolution grid encode for Hopper (sm_90a): the forward and its
// scatter-add backward, for ops/brick_grid.py::paired_encode.
//
// Replaces the Pallas TPU probes that prototyped this operation on the TPU:
// the chunked gather + hat interpolation k_fwd (scripts/probe_r2d_chunked.py:79,
// scripts/probe_r2f_scale.py:40) and k_gi (scripts/probe_r2c_rates.py:187) for
// the forward, and the contribution scatter k_scatter2
// (scripts/probe_r2d_chunked.py:162) for the backward. It does not copy their
// layout: on the TPU a sample gathers one wide 128-lane row per level group and
// weights all 128 lanes with selector matmuls. Here a thread touches only the 8
// live vertices of its sample's cell in its group's row, for each of the F
// features (the port's torch version does the same,
// ops/brick_grid.py::_level_taps).
//
// Table layout (the JAX package's): one f32 table per level group,
// [rows, len(group) * F * 128]; a row holds the 5^3 vertices of a 4^3-cell
// brick (lane ix*25 + iy*5 + iz) for each member level, feature-major. The
// group's key (finest) level picks the row: dense key levels row-major with a
// clip, hashed ones by the prime-XOR hash masked to the power-of-two row count.
// A coarser member reads the window of its own vertices that covers the key
// brick.
//
// What bounds them on this card: each (sample, level) reads (forward) or adds
// (backward) 8*F scattered floats and does ~60 flops, so neither arithmetic
// nor device-memory bandwidth binds (the byte bounds are 0.014 and 0.022 ms
// at 262144 samples of the Car config). The forward is bound by the rate at
// which the L1 and the L2 serve scattered 4-byte reads from the 52 MB of
// tables (about the 50 MB L2); the backward by the rate at which the L2
// retires f32 reductions, worst where many hit one address: the coarse
// levels, whose few cells all the samples of a ray fall into, and rays that
// hit nothing, whose samples pile up on one clamped position. Measured on an
// H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md section 6), bf16, 262144
// samples of a Car render chunk: the one-thread-per-(sample, level) kernels
// these replace took 0.147 ms and 1.73 ms (67 M scalar atomics, 39 G/s);
// these take 0.10 ms and 0.29 ms. On an 800x800 frame's chunks, whose
// samples are all distinct and spread through the volume, the forward
// averages 0.17 ms a launch (0.20 before): there the hashed levels'
// scattered reads, which no ordering of the samples makes coherent, set the
// time.
//
// The design: one thread per sample, looping over the levels, so a warp
// holds 32 consecutive samples (neighbours along one ray) at one level:
// - the level is warp-uniform: its constants are shared-memory broadcasts and
//   its dense/hashed and key/member branches do not diverge; at coarse levels
//   neighbouring lanes read and add the same brick row;
// - a sample's position is read once, not once per level;
// - the forward computes the levels in chunks whose outputs fill 32 bytes
//   (8 levels at F = 2 in bf16, 4 in f32) in at most 64 registers: a
//   chunk's 8*F corner loads per level are all issued before its first
//   multiply, and its outputs leave by 16-byte stores from registers.
//   Nothing is staged in shared memory: an output tile there ran slower,
//   taking L1 from the corner loads;
// - the backward stages its tile's output gradient in shared memory by
//   coalesced 16-byte loads, and aggregates within the warp before adding:
//   the lanes whose cell (its first vertex in the table) is the same find
//   each other with __match_any_sync and sum their 8*F contributions in f32
//   by a shuffle tree over their ranks; the group's first lane adds the sums
//   with PTX red.global (no value returned; a float atomicAdd on a pointer
//   read from shared memory compiled to a test of the address space with
//   CAS loops), four floats at a time (red...v4.f32, zeros in the two lanes
//   outside the pair) for each pair of corners dz = 0, 1 that lies in one
//   aligned 16-byte chunk, else one float at a time. Lanes with a zero
//   gradient join every warp-collective step with zero contributions; a
//   level no lane of the warp has a gradient for is skipped.
//
// Exactness: the cell decision must match the torch version bit for bit, or a
// sample lands in another cell (an O(1) error). torch evaluates pos*scale+0.5
// and (4*brick-0.5)*inv_r+0.5 as separately rounded f32 operations with the
// Python scalars rounded to f32 once; the coordinate math here uses
// __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts into an FMA, and the
// host passes the scalars already rounded to f32. In bf16 (compute dtype) the
// rounding sequence is torch's: tent weights rounded to bf16,
// w = bf16(bf16(wx*wy)*wz), table values rounded to bf16, each product rounded
// to bf16, the 8 products summed in f32 in corner order (the plain version's
// order too, so the two agree bit for bit) and the sum rounded to bf16. The
// backward adds, in f32, each contribution w*g (rounded to bf16 in bf16, as
// the plain autograd's product is); a contribution is skipped only where g is
// exactly 0, so a NaN or inf g reaches the table. The warp sums and the
// reductions add in no fixed order across warps.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (ops/cuda/_build.py). Plain C entry points,
//             loaded with ctypes by ops/cuda/grid_encode.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxGroups = 32;
constexpr int kMaxTile = 128;        // samples (threads) per CTA
constexpr int kSmemCap = 48 * 1024;  // the backward's gradient tile, at most
constexpr int kChunkBytes = 32;      // forward outputs per chunk of levels
constexpr int kFwdMinCtas = 8;       // forward CTAs resident per SM, at least
constexpr int kRowVerts = 128;
constexpr int kLevelInts = 9;    // per-level ints the host passes (see make_encoding)
constexpr int kLevelFloats = 3;  // per-level floats
constexpr uint32_t kPrime1 = 19349663u;  // the reference's hash primes (1, P1, P2)
constexpr uint32_t kPrime2 = 83492791u;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxLevels <= 32 && kMaxGroups <= 32, "warp 0 stages one entry a lane");

struct Level {
  int group;     // index of the group's table
  int is_key;    // 1 for the group's key (finest) member
  int dense;     // the key level indexes bricks row-major (else hashed)
  int bx, by, bz;  // the key level's brick grid (dense)
  uint32_t mask;   // hashed: rows - 1
  int width;     // floats per row of the group's table
  int off;       // this member's first float in the row
  float key_scale;  // f32 scales: the key level's and this level's
  float scale;
  float inv_r;   // coarser member: f32(1 / (key_scale / scale)) from doubles
};

struct Encoding {
  float* table[kMaxGroups];  // the tables (forward) or their gradients (backward)
  Level lv[kMaxLevels];
  int n_levels;
};

// The backward's tile of output gradients in shared memory: one row per
// sample, padded to `stride` bytes (a multiple of 16 plus 16, so that the
// 16-byte copies stay aligned and a warp's per-level reads spread over the
// banks).
struct Tile {
  int row_bytes;  // n_levels * F * element size: one sample's row in global memory
  int stride;     // its row in shared memory
};

__host__ __device__ inline Tile tile_rows(int n_levels, int n_features, int elem) {
  const int row = n_levels * n_features * elem;
  return {row, (row + 15) / 16 * 16 + 16};
}

// The parameter struct is copied into shared memory with static indices, so
// that the level lookups read shared memory (warp 0, one entry a lane).
__device__ __forceinline__ void stage(const Encoding& enc, Encoding* s) {
  if (threadIdx.x < 32) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l)
      if (threadIdx.x == l) s->lv[l] = enc.lv[l];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
      if (threadIdx.x == g) s->table[g] = enc.table[g];
    if (threadIdx.x == 0) s->n_levels = enc.n_levels;
  }
}

// Copies `count` contiguous rows of `row_bytes` from global memory into the
// shared tile (rows `stride` apart): 16-byte vectors when the rows and the
// address allow, else elements of `elem` bytes. All threads of the CTA
// take part.
__device__ __forceinline__ void load_rows(unsigned char* tile, const unsigned char* global,
                                          int count, const Tile& t, int elem) {
  if (t.row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(global) % 16 == 0) {
    const int chunks = t.row_bytes / 16;
    const uint4* g = reinterpret_cast<const uint4*>(global);
    for (int k = threadIdx.x; k < count * chunks; k += blockDim.x) {
      const int r = k / chunks;
      reinterpret_cast<uint4*>(tile + r * t.stride)[k - r * chunks] = g[k];
    }
  } else {
    const int per_row = t.row_bytes / elem;
    for (int k = threadIdx.x; k < count * per_row; k += blockDim.x) {
      const int r = k / per_row;
      unsigned char* s = tile + r * t.stride + (k - r * per_row) * elem;
      if (elem == 2)
        *reinterpret_cast<uint16_t*>(s) = reinterpret_cast<const uint16_t*>(global)[k];
      else
        *reinterpret_cast<uint32_t*>(s) = reinterpret_cast<const uint32_t*>(global)[k];
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// torch.clamp_min(v, 0): NaN stays NaN
__device__ __forceinline__ float clamp_min0(float v) { return v < 0.f ? 0.f : v; }

// The sample's cell in its group's row for one level: the flat index of
// corner 0, feature 0, and the 8 corner weights (corner c = 4dx + 2dy + dz at
// lane +25dx +5dy +dz). Every index is kept inside the table whatever the
// position (outside [0, 1], inf or NaN).
template <bool kBf16>
__device__ __forceinline__ long long taps(const Level& L, const float* p, float* w) {
  float brick[3], u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pk = __fadd_rn(__fmul_rn(p[a], L.key_scale), 0.5f);
    const float b = floorf(__fmul_rn(floorf(pk), 0.25f));
    brick[a] = b;
    if (L.is_key) {
      u[a] = __fsub_rn(pk, __fmul_rn(b, 4.0f));
    } else {
      const float base_c =
          floorf(__fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(4.0f, b), 0.5f), L.inv_r), 0.5f));
      u[a] = __fsub_rn(__fadd_rn(__fmul_rn(p[a], L.scale), 0.5f), base_c);
    }
  }
  long long row;
  if (L.dense) {
    // f32 with a clip, as the torch and JAX versions (exact: counts < 2^24)
    const float b0 = fminf(fmaxf(brick[0], 0.f), float(L.bx - 1));
    const float b1 = fminf(fmaxf(brick[1], 0.f), float(L.by - 1));
    const float b2 = fminf(fmaxf(brick[2], 0.f), float(L.bz - 1));
    row = (long long)(b0 + b1 * float(L.bx) + b2 * float(L.bx * L.by));
  } else {
    // uint32 wraparound of the int64-truncated coordinate, as the torch version
    const uint32_t h = (uint32_t)(long long)brick[0] ^
                       (uint32_t)(long long)brick[1] * kPrime1 ^
                       (uint32_t)(long long)brick[2] * kPrime2;
    row = h & L.mask;
  }
  float lo[3], hi[3];
  int lane0 = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float i0 = fminf(fmaxf(floorf(u[a]), 0.f), 3.f);
    lo[a] = rnd<kBf16>(clamp_min0(__fsub_rn(1.f, fabsf(__fsub_rn(u[a], i0)))));
    hi[a] = rnd<kBf16>(clamp_min0(__fsub_rn(1.f, fabsf(__fsub_rn(u[a], i0 + 1.f)))));
    lane0 = lane0 * 5 + int(i0);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wx = (c & 4) ? hi[0] : lo[0];
    const float wy = (c & 2) ? hi[1] : lo[1];
    const float wz = (c & 1) ? hi[2] : lo[2];
    w[c] = rnd<kBf16>(__fmul_rn(rnd<kBf16>(__fmul_rn(wx, wy)), wz));
  }
  return row * L.width + L.off + lane0;
}

__device__ __forceinline__ int corner_lane(int c) {
  return (c >> 2) * 25 + ((c >> 1) & 1) * 5 + (c & 1);
}

// The lane of the j-th (from 0) set bit of m; j < popc(m).
__device__ __forceinline__ int nth_lane(unsigned m, int j) {
  int pos = 0;
#pragma unroll
  for (int b = 16; b > 0; b >>= 1)
    if (__popc(m & ((1u << (pos + b)) - 1u)) <= j) pos += b;
  return pos;
}

template <bool kBf16>
using Elem = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The F outputs of one level for the sample at p, in f32 (in bf16 compute the
// sum is still to be rounded): the 8*F corner loads go out before the first
// multiply.
template <int F, bool kBf16>
__device__ __forceinline__ void encode_level(const Level& L, float* const* tables,
                                             const float* p, float* out) {
  float w[8];
  const float* tab = tables[L.group] + taps<kBf16>(L, p, w);
  float v[F][8];
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int c = 0; c < 8; ++c) v[f][c] = __ldg(tab + f * kRowVerts + corner_lane(c));
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc = __fadd_rn(acc, rnd<kBf16>(__fmul_rn(rnd<kBf16>(v[f][c]), w[c])));
    out[f] = acc;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// One thread per sample, looping over the levels in chunks of kChunkBytes of
// output; out [n, L*F] in the compute dtype. A minimum of CTAs per SM in its
// launch bounds (8 here: at most 64 registers) ran faster on a frame's spread
// samples than none, the compiler's own choice; 16 (32 registers) and
// 16-byte chunks ran slower.
template <int F, bool kBf16>
__global__ void __launch_bounds__(kMaxTile, kFwdMinCtas)
brick_encode_fwd_kernel(const float* __restrict__ pos, void* __restrict__ out, Encoding enc,
                        int n) {
  __shared__ Encoding s;
  using T = Elem<kBf16>;
  constexpr int kLevelBytes = F * int(sizeof(T));
  constexpr int kChunk = kLevelBytes >= kChunkBytes ? 1 : kChunkBytes / kLevelBytes;
  constexpr int kElems = kChunk * F;
  constexpr int kWords = kElems * int(sizeof(T)) / 4;
  stage(enc, &s);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {__ldg(pos + 3 * i), __ldg(pos + 3 * i + 1), __ldg(pos + 3 * i + 2)};
  const int n_levels = s.n_levels;
  T* row = static_cast<T*>(out) + i * n_levels * F;
  // whole chunks start 16-byte aligned when the rows do
  const bool vec = (n_levels * kLevelBytes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int lv = 0;
  for (; lv + kChunk <= n_levels; lv += kChunk) {
    float acc[kElems];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) encode_level<F, kBf16>(s.lv[lv + j], s.table, p, acc + j * F);
    if (vec) {
      uint32_t wd[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        if constexpr (kBf16) wd[q] = pack_bf16(acc[2 * q], acc[2 * q + 1]);
        else wd[q] = __float_as_uint(acc[q]);
      }
      uint4* dst = reinterpret_cast<uint4*>(row + lv * F);
#pragma unroll
      for (int q = 0; q < kWords / 4; ++q)
        dst[q] = make_uint4(wd[4 * q], wd[4 * q + 1], wd[4 * q + 2], wd[4 * q + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        if constexpr (kBf16) row[lv * F + e] = __float2bfloat16_rn(acc[e]);
        else row[lv * F + e] = acc[e];
      }
    }
  }
  for (; lv < n_levels; ++lv) {  // the levels after the last whole chunk
    float acc[F];
    encode_level<F, kBf16>(s.lv[lv], s.table, p, acc);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if constexpr (kBf16) row[lv * F + f] = __float2bfloat16_rn(acc[f]);
      else row[lv * F + f] = acc[f];
    }
  }
}

// Reductions into global memory (cudaMalloc'd pointers are global addresses).
__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void red_add4(float* p, float x, float y, float z, float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(x), "f"(y),
               "f"(z), "f"(w)
               : "memory");
}

// Adds one aggregated cell: the 8 corners of F feature planes. Corners k and
// k + 1 (dz = 0, 1) are neighbours in the row; a pair inside one aligned
// 16-byte chunk (at m = 0, 1 or 2 of its 4 floats) goes as one 4-float add.
template <int F>
__device__ __forceinline__ void add_cell(float* grad, const float (&c)[F][8]) {
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      float* q = grad + f * kRowVerts + corner_lane(k);
      const float a = c[f][k], b = c[f][k + 1];
      const int m = int(reinterpret_cast<uintptr_t>(q) / 4 % 4);
      if (m != 3) {
        if (a != 0.f || b != 0.f)  // NaN compares unequal: it is added
          red_add4(q - m, m == 0 ? a : 0.f, m == 0 ? b : (m == 1 ? a : 0.f),
                   m == 1 ? b : (m == 2 ? a : 0.f), m == 2 ? b : 0.f);
      } else {
        if (a != 0.f) red_add(q, a);
        if (b != 0.f) red_add(q + 1, b);
      }
    }
}

// One CTA per tile of blockDim.x consecutive samples, one thread per sample,
// looping over the levels; g [n, L*F] in the compute dtype; enc.table holds
// the f32 gradients (zeroed by the caller). Every lane of a warp reaches
// every warp-collective step: lanes past the ragged end, or with a zero
// gradient, take part with zero contributions.
template <int F, bool kBf16>
__global__ void __launch_bounds__(kMaxTile)
brick_encode_bwd_kernel(const float* __restrict__ pos, const void* __restrict__ g,
                        Encoding enc, int n) {
  __shared__ Encoding s;
  extern __shared__ __align__(16) unsigned char rows[];
  using T = Elem<kBf16>;
  const long long first = (long long)blockIdx.x * blockDim.x;
  const int count = int(min((long long)blockDim.x, n - first));
  const int n_levels = enc.n_levels;
  const Tile t = tile_rows(n_levels, F, sizeof(T));
  stage(enc, &s);
  load_rows(rows, static_cast<const unsigned char*>(g) + first * t.row_bytes, count, t,
            sizeof(T));
  __syncthreads();
  const bool valid = int(threadIdx.x) < count;
  const long long i = first + threadIdx.x;
  float p[3] = {0.f, 0.f, 0.f};
  if (valid) {
#pragma unroll
    for (int a = 0; a < 3; ++a) p[a] = __ldg(pos + 3 * i + a);
  }
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const T* grow = reinterpret_cast<const T*>(rows + threadIdx.x * t.stride);
  for (int lv = 0; lv < n_levels; ++lv) {
    float gv[F];
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      gv[f] = valid ? to_f32(grow[lv * F + f]) : 0.f;
      any |= gv[f] != 0.f;  // NaN compares unequal: it is added
    }
    if (!__any_sync(kFull, any)) continue;  // warp-uniform
    const Level L = s.lv[lv];
    float w[8];
    const long long base = taps<kBf16>(L, p, w);
    float c[F][8];
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        c[f][k] = gv[f] != 0.f ? rnd<kBf16>(__fmul_rn(gv[f], w[k])) : 0.f;
    // lanes in the same cell of this level's table form a group; the lanes
    // without a gradient form one of their own, which adds nothing
    const unsigned m = __match_any_sync(kFull, any ? base : -1ll);
    const int size = __popc(m);
    const int rank = __popc(m & below);
    const int most = __reduce_max_sync(kFull, unsigned(size));
    for (int o = 1; o < most; o <<= 1) {  // warp-uniform trip count
      const bool take = (rank & (2 * o - 1)) == 0 && rank + o < size;
      const int src = take ? nth_lane(m, rank + o) : lane;
#pragma unroll
      for (int f = 0; f < F; ++f)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float other = __shfl_sync(kFull, c[f][k], src);
          if (take) c[f][k] += other;
        }
    }
    if (any && rank == 0) add_cell<F>(s.table[L.group] + base, c);
  }
}

// ilv: kLevelInts per level (group, is_key, dense, bx, by, bz, rows mask,
// width, member offset); flv: kLevelFloats per level (key scale, scale, inv_r).
int make_encoding(void* const* tables, int n_groups, const int* ilv, const float* flv,
                  int n_levels, int n_features, Encoding* e) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_groups < 1 || n_groups > kMaxGroups) return -1;
  for (int g = 0; g < kMaxGroups; ++g)
    e->table[g] = g < n_groups ? static_cast<float*>(tables[g]) : nullptr;
  for (int l = 0; l < n_levels; ++l) {
    const int* q = ilv + kLevelInts * l;
    Level& L = e->lv[l];
    L.group = q[0];
    L.is_key = q[1];
    L.dense = q[2];
    L.bx = q[3];
    L.by = q[4];
    L.bz = q[5];
    L.mask = uint32_t(q[6]);
    L.width = q[7];
    L.off = q[8];
    L.key_scale = flv[kLevelFloats * l];
    L.scale = flv[kLevelFloats * l + 1];
    L.inv_r = flv[kLevelFloats * l + 2];
    if (L.group < 0 || L.group >= n_groups || L.bx < 1 || L.by < 1 || L.bz < 1 ||
        L.off < 0 || L.off + n_features * kRowVerts > L.width)
      return -1;
  }
  e->n_levels = n_levels;
  return 0;
}

template <bool kBwd, int F, bool kBf16>
int launch(const float* pos, void* io, const Encoding& e, int n, cudaStream_t stream) {
  if constexpr (!kBwd) {
    const unsigned blocks = unsigned((n + (long long)kMaxTile - 1) / kMaxTile);
    brick_encode_fwd_kernel<F, kBf16><<<blocks, kMaxTile, 0, stream>>>(pos, io, e, n);
  } else {
    // the largest tile (a multiple of a warp) whose gradient rows fit the
    // cap: 128 samples for the Car config (10 KB in bf16), fewer for wide rows
    const Tile t = tile_rows(e.n_levels, F, kBf16 ? 2 : 4);
    int tile = kMaxTile;
    while (tile > 32 && tile * t.stride > kSmemCap) tile /= 2;
    if (tile * t.stride > kSmemCap) return -1;
    const unsigned blocks = unsigned((n + (long long)tile - 1) / tile);
    brick_encode_bwd_kernel<F, kBf16><<<blocks, tile, tile * t.stride, stream>>>(pos, io, e, n);
  }
  return int(cudaGetLastError());
}

template <bool kBwd>
int dispatch(const float* pos, void* io, void* const* tables, int n_groups, const int* ilv,
             const float* flv, int n_levels, int n_features, long long n, int bf16,
             void* stream) {
  Encoding e;
  if (n < 0 || n * n_levels > INT_MAX ||
      make_encoding(tables, n_groups, ilv, flv, n_levels, n_features, &e) != 0)
    return -1;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRID_ENCODE_CASE(F)                                              \
  case F:                                                                \
    return bf16 ? launch<kBwd, F, true>(pos, io, e, int(n), s)           \
                : launch<kBwd, F, false>(pos, io, e, int(n), s);
  switch (n_features) {
    GRID_ENCODE_CASE(1)
    GRID_ENCODE_CASE(2)
    GRID_ENCODE_CASE(4)
    GRID_ENCODE_CASE(8)
    default:
      return -1;
  }
#undef GRID_ENCODE_CASE
}

}  // namespace

// Returns 0 on success, a cudaError_t code on a CUDA failure, or -1 for
// arguments outside what the kernels take (the Python wrapper checks them
// first: F in {1, 2, 4, 8}, at most 32 levels and 32 groups, n * levels <
// 2^31). pos is [n, 3] f32; tables[g] is the f32 table of group g; out is
// [n, n_levels * n_features] in f32 (bf16 = 0) or bf16 (bf16 = 1).
extern "C" int brick_encode_fwd(const float* pos, void* out, void* const* tables, int n_groups,
                                const int* ilv, const float* flv, int n_levels,
                                int n_features, long long n, int bf16, void* stream) {
  return dispatch<false>(pos, out, tables, n_groups, ilv, flv, n_levels, n_features, n, bf16,
                         stream);
}

// Backward of brick_encode_fwd: adds each (sample, level, corner, feature)
// contribution of g [n, n_levels * n_features] (f32 or bf16 as bf16 says)
// into grads[g], f32 tensors shaped as the tables and zeroed by the caller.
extern "C" int brick_encode_bwd(const float* pos, const void* g, void* const* grads,
                                int n_groups, const int* ilv, const float* flv, int n_levels,
                                int n_features, long long n, int bf16, void* stream) {
  return dispatch<true>(pos, const_cast<void*>(g), grads, n_groups, ilv, flv, n_levels,
                        n_features, n, bf16, stream);
}

extern "C" const char* grid_encode_error_string(int code) {
  return code == -1 ? "arguments outside what the kernel takes"
                    : cudaGetErrorString(static_cast<cudaError_t>(code));
}
