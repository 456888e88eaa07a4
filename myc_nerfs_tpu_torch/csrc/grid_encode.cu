// Brick3 multiresolution grid encode for Hopper (sm_90a): the forward and its
// scatter-add backward, for ops/brick_grid.py::paired_encode.
//
// Replaces the Pallas TPU probes that prototyped this operation on the TPU:
// the chunked gather + hat interpolation k_fwd (scripts/probe_r2d_chunked.py:79,
// scripts/probe_r2f_scale.py:40) and k_gi (scripts/probe_r2c_rates.py:187) for
// the forward, and the contribution scatter k_scatter2
// (scripts/probe_r2d_chunked.py:162) for the backward. It does not copy their
// layout: on the TPU a sample gathers one wide 128-lane row per level group and
// weights all 128 lanes with selector matmuls. Here a thread owns one
// (sample, level) and touches only the 8 live vertices of the sample's cell in
// its group's row, for each of the F features (the port's torch version does
// the same, ops/brick_grid.py::_level_taps).
//
// Table layout (the JAX package's): one f32 table per level group,
// [rows, len(group) * F * 128]; a row holds the 5^3 vertices of a 4^3-cell
// brick (lane ix*25 + iy*5 + iz) for each member level, feature-major. The
// group's key (finest) level picks the row: dense key levels row-major with a
// clip, hashed ones by the prime-XOR hash masked to the power-of-two row count.
// A coarser member reads the window of its own vertices that covers the key
// brick.
//
// What bounds it: each (sample, level) reads (forward) or atomically adds
// (backward) 8*F scattered floats and does ~60 flops, so both kernels are bound
// by the memory system's random-access rate (L2 hits for the 52 MB of the Car
// config's tables, which lie mostly in the 50 MB L2), not by arithmetic or
// device-memory bandwidth. All groups go in one launch, so the card sees
// N*L independent threads.
//
// Exactness: the cell decision must match the torch version bit for bit, or a
// sample lands in another cell (an O(1) error). torch evaluates pos*scale+0.5
// and (4*brick-0.5)*inv_r+0.5 as separately rounded f32 operations with the
// Python scalars rounded to f32 once; the coordinate math here uses
// __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts into an FMA, and the
// host passes the scalars already rounded to f32. In bf16 (compute dtype) the
// rounding sequence is torch's: tent weights rounded to bf16,
// w = bf16(bf16(wx*wy)*wz), table values rounded to bf16, each product rounded
// to bf16, the 8 products summed in f32 and the sum rounded to bf16. The
// backward adds, in f32, each contribution w*g (rounded to bf16 in bf16, as
// the plain autograd's product is); its atomics sum in no fixed order.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (ops/cuda/_build.py). Plain C entry points,
//             loaded with ctypes by ops/cuda/grid_encode.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxGroups = 32;
constexpr int kThreads = 256;
constexpr int kRowVerts = 128;
constexpr int kLevelInts = 9;    // per-level ints the host passes (see make_encoding)
constexpr int kLevelFloats = 3;  // per-level floats
constexpr uint32_t kPrime1 = 19349663u;  // the reference's hash primes (1, P1, P2)
constexpr uint32_t kPrime2 = 83492791u;

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

// The parameter struct is copied into shared memory with static indices, so
// that the per-thread (dynamic) level lookups read shared memory.
__device__ __forceinline__ void stage(const Encoding& enc, Encoding* s) {
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (threadIdx.x == l) s->lv[l] = enc.lv[l];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g)
    if (threadIdx.x == kMaxLevels + g) s->table[g] = enc.table[g];
  if (threadIdx.x == 0) s->n_levels = enc.n_levels;
  __syncthreads();
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

// One thread per (sample i, level lv), t = i * n_levels + lv; out [n, L*F] in
// the compute dtype, so the thread's F outputs start at t * F.
template <int F, bool kBf16>
__global__ void __launch_bounds__(kThreads)
brick_encode_fwd_kernel(const float* __restrict__ pos, void* __restrict__ out, Encoding enc,
                        int total) {
  __shared__ Encoding s;
  stage(enc, &s);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int i = t / s.n_levels;
  const Level& L = s.lv[t - i * s.n_levels];
  const float p[3] = {pos[3 * (long long)i], pos[3 * (long long)i + 1],
                      pos[3 * (long long)i + 2]};
  float w[8];
  const float* tab = s.table[L.group] + taps<kBf16>(L, p, w);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float v = rnd<kBf16>(__ldg(tab + f * kRowVerts + corner_lane(c)));
      acc = __fadd_rn(acc, rnd<kBf16>(__fmul_rn(v, w[c])));
    }
    if (kBf16)
      static_cast<__nv_bfloat16*>(out)[(long long)t * F + f] = __float2bfloat16_rn(acc);
    else
      static_cast<float*>(out)[(long long)t * F + f] = acc;
  }
}

// Same threads; g [n, L*F] in the compute dtype; enc.table holds the f32
// gradients (zeroed by the caller). A contribution is skipped only where g is
// exactly 0 (NaN compares unequal, so a non-finite g still reaches the table).
template <int F, bool kBf16>
__global__ void __launch_bounds__(kThreads)
brick_encode_bwd_kernel(const float* __restrict__ pos, const void* __restrict__ g,
                        Encoding enc, int total) {
  __shared__ Encoding s;
  stage(enc, &s);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  float gv[F];
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    gv[f] = kBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(g)[(long long)t * F + f])
                  : static_cast<const float*>(g)[(long long)t * F + f];
    any |= gv[f] != 0.f;
  }
  if (!any) return;
  const int i = t / s.n_levels;
  const Level& L = s.lv[t - i * s.n_levels];
  const float p[3] = {pos[3 * (long long)i], pos[3 * (long long)i + 1],
                      pos[3 * (long long)i + 2]};
  float w[8];
  float* grad = s.table[L.group] + taps<kBf16>(L, p, w);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    if (gv[f] == 0.f) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      atomicAdd(grad + f * kRowVerts + corner_lane(c), rnd<kBf16>(__fmul_rn(gv[f], w[c])));
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
int launch(const float* pos, void* io, const Encoding& e, int total, cudaStream_t stream) {
  const unsigned blocks = unsigned((total + kThreads - 1) / kThreads);
  if constexpr (kBwd)
    brick_encode_bwd_kernel<F, kBf16><<<blocks, kThreads, 0, stream>>>(pos, io, e, total);
  else
    brick_encode_fwd_kernel<F, kBf16><<<blocks, kThreads, 0, stream>>>(pos, io, e, total);
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
  const int total = int(n * n_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRID_ENCODE_CASE(F)                                              \
  case F:                                                                \
    return bf16 ? launch<kBwd, F, true>(pos, io, e, total, s)            \
                : launch<kBwd, F, false>(pos, io, e, total, s);
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
