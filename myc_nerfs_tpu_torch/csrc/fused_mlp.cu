// Fused bias-free MLP for Hopper (sm_90a): y = Wn(...relu(W1 relu(W0 x))...),
// forward and backward, in bf16 on the tensor cores and in f32 on the CUDA
// cores or, for the wide chains' forward and dW, on the TF32 tensor cores in
// three passes.
//
// The forward replaces myc_nerfs_tpu/ops/pallas/fused_mlp.py::_fwd_kernel and
// the backward replaces _bwd_kernel (the Pallas TPU kernels reached through
// fused_mlp / _fused_mlp_fwd_impl / _fused_mlp_bwd). The function is the
// Pallas one:
//   forward   h = round(relu(h @ W_i)), f32 accumulation, no ReLU after the
//             last layer, round = cast to the input dtype;
//   backward  recompute the post-activations post[0] = x, post[i+1] as above,
//             then from the top layer down with g in f32 (it arrives rounded):
//               dW_i += post[i]^T g                  (g as it is, unrounded)
//               g     = round(g) @ W_i^T, masked by post[i] > 0 for i > 0
//             dx = round(g); each dW is cast to the weight dtype at the end.
// ReLU is `v < 0 ? 0 : v`, which keeps a NaN (fmaxf would turn it into 0 and
// hide a non-finite step from the trainer's skip).
//
// What bounds it: at the NGP widths (32->64->16, 32->64->64->16) a row costs
// 6-14 kflop against 96 bytes of x and y (bf16), so a kernel that keeps every
// intermediate on chip is bound by those bytes: 7.5 us for 262144 rows on an
// H100 (3.35 TB/s), against 1.6-3.8 us of bf16 tensor-core time (989
// TFLOP/s). No tensor core keeps f32 operands (TF32 keeps 10 mantissa
// bits); f32-accurate products cost three TF32 passes (3 x flops at 495
// TFLOP/s, the bound utils/timing.py states) or FMAs at 67 TFLOP/s, which
// the narrow f32 kernels below use (24-160 us).
//
// bf16 design (mma.sync.m16n8k16 bf16 -> f32, ldmatrix):
//   - each CTA stages all weights once in shared memory as bf16, [din][dout+8]
//     per layer: the 8-element pad puts the 8 rows of every ldmatrix in
//     distinct banks. The forward reads B = W with ldmatrix.trans, the
//     backward's dgrad reads B = W^T from the same layout without .trans;
//   - forward: each warp walks 32-row chunks (two 16-row strips, so every B
//     fragment feeds two mma) of a persistent grid. x arrives by 16-byte
//     cp.async into a warp-private double buffer (the next chunk loads while
//     this one computes); the ragged last chunk is zero-filled, not padded.
//     Activations stay in registers between layers: the f32 accumulators of
//     two adjacent n8 tiles, after ReLU and packing to bf16x2, are exactly the
//     A fragment of the next layer's k16 step, so no shared memory and no
//     __syncthreads() lie between layers. y leaves through the warp's buffer
//     as 16-byte stores, masked to the rows that exist;
//   - backward: a CTA takes 128-row tiles (one 16-row strip per warp),
//     recomputes the post-activations with the forward's mma chain and keeps
//     them in shared memory as bf16 (they are the ReLU mask and the dW
//     operand). dgrad round(g) @ W^T is an mma whose A fragments are g
//     rounded to bf16 once per element. dW_i += post_i^T g contracts over
//     rows: post and g are read with ldmatrix.trans. To keep g unrounded (as
//     the Pallas kernel does) g is split into g_hi = bf16(g) and g_lo =
//     bf16(g - g_hi), two mma into one f32 accumulator: the dW product keeps
//     about 16 of g's 24 mantissa bits (post is bf16 by the function's
//     definition);
//   - dW is deterministic: each warp owns a fixed set of 16x8 dW tiles (at
//     most 8, so 64 per CTA in one pass; a larger chain runs in passes) and
//     accumulates them in registers over the CTA's row tiles in order. The
//     CTA writes its partial to a [ctas, sum |W_i|] f32 workspace and a
//     second kernel sums the partials in CTA order.
//
// narrow f32 design (CUDA cores, register blocking): activations in shared memory,
// stored k-major ([k][row]) so that a thread's 4 rows at one k are one
// float4; each thread computes a 4 x 4 micro-tile, so one weight float4 and
// one activation float4 feed 16 FMAs (the backward's dW and dgrad read
// 4 float4 of each operand per 64 FMAs). The backward keeps each CTA's
// partial dW in shared memory, reduced as in bf16.
//
// CTA counts (a persistent grid: SMs x resident CTAs) and the dynamic
// shared-memory limit are worked out once per (widths, dtype, direction) by
// fused_mlp_plan; the Python wrapper caches them.
//
// Chains wider than 64 (up to 272) take the wide kernels further down
// (fused_mlp_wide_fwd / fused_mlp_wide_bwd_*): weights streamed through
// shared memory a chunk at a time, and a backward through global scratch;
// on wgmma with TMA and bulk copies (hopper.cuh), bf16 directly and f32 as
// 3xTF32 where the f32 limits allow it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see ops/cuda/_build.py). Plain C entry
// points, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_text.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 64;
constexpr int kPad = 8;  // bf16 row pad (16 bytes)

struct Net {
  const void* w[kMaxLayers];
  int width[kMaxLayers + 1];
  int n_layers;
  int dw_off[kMaxLayers];        // offset (floats) of dW_i in the concatenated dW,
  int dw_floats;                 // and in f32 of W_i, unpadded, in shared memory
  // bf16: staged weights [din][dout + kPad]
  int w_off[kMaxLayers];         // element offset in shared memory
  int w_elems;
  int post_off[kMaxLayers];      // backward: post[i] tile [kBwdRows][din + kPad]
  int post_elems;
  int g_ld;                      // backward: g tiles [kBwdRows][g_ld]
  int tile_off[kMaxLayers + 1];  // backward: first 16x8 dW tile of layer i
  int io_ld;                     // forward: x/y chunk row stride
};

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// ---------------------------------------------------------------------------
// PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// two floats -> bf16x2 (round to nearest even); lo in the low half, as the
// mma fragments hold the lower column there
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// every layer's W [din][dout] (bf16, global) -> shared [din][dout + kPad],
// 16 bytes at a time
__device__ __forceinline__ void stage_weights_bf16(bf16* wsm, const Net& net) {
  for (int l = 0; l < net.n_layers; ++l) {
    const bf16* w = static_cast<const bf16*>(net.w[l]);
    const int dout = net.width[l + 1], c8 = dout / 8, ld = dout + kPad;
    const int n = net.width[l] * c8;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int k = i / c8, c = i - k * c8;
      *reinterpret_cast<uint4*>(wsm + net.w_off[l] + k * ld + 8 * c) =
          *reinterpret_cast<const uint4*>(w + k * dout + 8 * c);
    }
  }
}

// One layer of a 16-row strip per entry of `a` (S strips): acc[s] = a[s] @ W,
// din / 16 k-steps and dout / 8 n8 tiles (both warp-uniform). B fragments for
// two n8 tiles come from one ldmatrix.x4.trans of the staged [din][dout+8] W.
template <int S>
__device__ __forceinline__ void layer_mma(float (&acc)[S][8][4], const uint32_t (&a)[S][4][4],
                                          const bf16* wl, int din, int dout, int lane) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
  const int ld = dout + kPad;
  const int q = lane >> 3, r = lane & 7;
  const uint32_t base = smem_addr(wl + ((q & 1) * 8 + r) * ld + (q >> 1) * 8);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (16 * ks >= din) break;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (16 * jp >= dout) break;
      uint32_t b[4];
      ldsm_x4_t(b, base + 2u * (16 * ks * ld + 16 * jp));
#pragma unroll
      for (int s = 0; s < S; ++s) {
        mma_bf16(acc[s][2 * jp], a[s][ks], b[0], b[1]);
        mma_bf16(acc[s][2 * jp + 1], a[s][ks], b[2], b[3]);
      }
    }
  }
}

// acc (16 x dout, C fragments) -> round(relu(acc)) as the next layer's A
// fragments: n8 tiles 2ks and 2ks+1 make k-step ks
template <int S>
__device__ __forceinline__ void relu_to_a(uint32_t (&a)[S][4][4], const float (&acc)[S][8][4],
                                          int dout) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (16 * ks >= dout) break;
      const float* lo = acc[s][2 * ks];
      const float* hi = acc[s][2 * ks + 1];
      a[s][ks][0] = pack_bf16(relu(lo[0]), relu(lo[1]));
      a[s][ks][1] = pack_bf16(relu(lo[2]), relu(lo[3]));
      a[s][ks][2] = pack_bf16(relu(hi[0]), relu(hi[1]));
      a[s][ks][3] = pack_bf16(relu(hi[2]), relu(hi[3]));
    }
}

// ---------------------------------------------------------------------------
// bf16 forward

constexpr int kFwdWarps = 8;
constexpr int kFwdStrips = 2;
constexpr int kChunkRows = 16 * kFwdStrips;  // rows a warp takes at a time

__host__ __device__ inline size_t fwd_bf16_smem(const Net& net) {
  return (size_t(net.w_elems) + size_t(kFwdWarps) * 2 * kChunkRows * net.io_ld) * sizeof(bf16);
}

__global__ void __launch_bounds__(kFwdWarps * 32, 2)
fused_mlp_fwd_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, Net net,
                          long long m) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* wsm = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* io = smem + net.w_elems + warp * 2 * kChunkRows * net.io_ld;
  const int n = net.n_layers, d_in = net.width[0], d_out = net.width[n];
  const int io_ld = net.io_ld;

  stage_weights_bf16(wsm, net);
  __syncthreads();

  const long long n_chunks = (m + kChunkRows - 1) / kChunkRows;
  const long long stride = (long long)gridDim.x * kFwdWarps;
  long long chunk = (long long)blockIdx.x * kFwdWarps + warp;

  // cp.async of a chunk's rows of x into buffer b; rows past m are zeroed
  auto load = [&](long long c, int b) {
    const int c8 = d_in / 8;
    bf16* dst = io + b * kChunkRows * io_ld;
    for (int i = lane; i < kChunkRows * c8; i += 32) {
      const int r = i / c8, k = i - r * c8;
      const long long row = c * kChunkRows + r;
      const bool in = row < m;
      cp_async16(smem_addr(dst + r * io_ld + 8 * k), x + (in ? row : 0) * d_in + 8 * k,
                 in ? 16 : 0);
    }
  };

  if (chunk < n_chunks) load(chunk, 0);
  cp_async_commit();
  int buf = 0;
  for (; chunk < n_chunks; chunk += stride, buf ^= 1) {
    if (chunk + stride < n_chunks) load(chunk + stride, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncwarp();
    bf16* tile = io + buf * kChunkRows * io_ld;

    uint32_t a[kFwdStrips][4][4];
#pragma unroll
    for (int s = 0; s < kFwdStrips; ++s) {
      const uint32_t base =
          smem_addr(tile + (16 * s + (lane & 15)) * io_ld + (lane >> 4) * 8);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (16 * ks < d_in) ldsm_x4(a[s][ks], base + 2u * 16 * ks);
    }
    __syncwarp();  // x is in registers: the buffer takes y next

    float acc[kFwdStrips][8][4];
    for (int l = 0; l < n; ++l) {
      const int dout = net.width[l + 1];
      layer_mma<kFwdStrips>(acc, a, wsm + net.w_off[l], net.width[l], dout, lane);
      if (l + 1 < n) relu_to_a<kFwdStrips>(a, acc, dout);
    }

    // y: fragments -> the warp's buffer -> 16-byte stores of the rows < m
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < kFwdStrips; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= d_out) break;
        uint32_t* p0 = reinterpret_cast<uint32_t*>(tile + (16 * s + g) * io_ld + 8 * j + 2 * t);
        uint32_t* p1 = reinterpret_cast<uint32_t*>(tile + (16 * s + g + 8) * io_ld + 8 * j + 2 * t);
        *p0 = pack_bf16(acc[s][j][0], acc[s][j][1]);
        *p1 = pack_bf16(acc[s][j][2], acc[s][j][3]);
      }
    __syncwarp();
    const int c8 = d_out / 8;
    for (int i = lane; i < kChunkRows * c8; i += 32) {
      const int r = i / c8, k = i - r * c8;
      const long long row = chunk * kChunkRows + r;
      if (row < m)
        *reinterpret_cast<uint4*>(y + row * d_out + 8 * k) =
            *reinterpret_cast<const uint4*>(tile + r * io_ld + 8 * k);
    }
    __syncwarp();  // the buffer is free for the chunk after next
  }
  cp_async_wait_0();
}

// ---------------------------------------------------------------------------
// bf16 backward

constexpr int kBwdWarps = 8;
constexpr int kBwdRows = 16 * kBwdWarps;   // rows of a CTA tile: a strip per warp
constexpr int kDwTilesPerWarp = 8;         // 16x8 dW tiles a warp keeps in registers
constexpr int kDwTilesPerPass = kDwTilesPerWarp * kBwdWarps;

__host__ __device__ inline size_t bwd_bf16_smem(const Net& net) {
  return (size_t(net.w_elems) + net.post_elems + 2 * size_t(kBwdRows) * net.g_ld) *
         sizeof(bf16);
}

// rows [0, kBwdRows) of a [m, d] bf16 matrix from row0 on -> shared [.][ld];
// rows past m are zeroed
__device__ __forceinline__ void load_tile_bf16(bf16* dst, int ld, const bf16* src, int d,
                                               long long row0, long long m) {
  const int c8 = d / 8;
  for (int i = threadIdx.x; i < kBwdRows * c8; i += blockDim.x) {
    const int r = i / c8, k = i - r * c8;
    const long long row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < m) v = *reinterpret_cast<const uint4*>(src + row * d + 8 * k);
    *reinterpret_cast<uint4*>(dst + r * ld + 8 * k) = v;
  }
}

// Pass `tile_begin / kDwTilesPerPass` of the backward: dW tiles
// [tile_begin, tile_begin + kDwTilesPerPass) go to `partial`; dx (may be null)
// is written by the first pass only.
__global__ void __launch_bounds__(kBwdWarps * 32, 2)
fused_mlp_bwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                          bf16* __restrict__ dx, float* __restrict__ partial, Net net,
                          long long m, int tile_begin) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* wsm = smem;
  bf16* post = smem + net.w_elems;
  bf16* ghi = post + net.post_elems;
  bf16* glo = ghi + kBwdRows * net.g_ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r8 = lane & 7;
  const int n = net.n_layers, d_in = net.width[0], d_out = net.width[n];
  const int g_ld = net.g_ld;
  const int srow = 16 * warp;  // the warp's strip in the tile

  stage_weights_bf16(wsm, net);

  float dacc[kDwTilesPerWarp][4];
#pragma unroll
  for (int s = 0; s < kDwTilesPerWarp; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[s][e] = 0.f;

  const long long n_tiles = (m + kBwdRows - 1) / kBwdRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kBwdRows;
    load_tile_bf16(post + net.post_off[0], d_in + kPad, x, d_in, row0, m);
    load_tile_bf16(ghi, g_ld, gy, d_out, row0, m);
    __syncthreads();

    // recompute post[1..n-1] for the warp's strip with the forward's chain
    {
      uint32_t a[1][4][4];
      float acc[1][8][4];
      const int ld0 = d_in + kPad;
      const uint32_t base = smem_addr(post + net.post_off[0] + (srow + (lane & 15)) * ld0 +
                                      (lane >> 4) * 8);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (16 * ks < d_in) ldsm_x4(a[0][ks], base + 2u * 16 * ks);
      for (int l = 0; l + 1 < n; ++l) {
        const int dout = net.width[l + 1];
        layer_mma<1>(acc, a, wsm + net.w_off[l], net.width[l], dout, lane);
        relu_to_a<1>(a, acc, dout);
        bf16* p = post + net.post_off[l + 1];
        const int ld = dout + kPad;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (16 * ks >= dout) break;
          const int c = 16 * ks + 2 * t;
          *reinterpret_cast<uint32_t*>(p + (srow + g) * ld + c) = a[0][ks][0];
          *reinterpret_cast<uint32_t*>(p + (srow + g + 8) * ld + c) = a[0][ks][1];
          *reinterpret_cast<uint32_t*>(p + (srow + g) * ld + c + 8) = a[0][ks][2];
          *reinterpret_cast<uint32_t*>(p + (srow + g + 8) * ld + c + 8) = a[0][ks][3];
        }
      }
    }
    __syncthreads();

    for (int l = n - 1; l >= 0; --l) {
      const int din = net.width[l], dout = net.width[l + 1];
      const bf16* pl = post + net.post_off[l];
      const int pld = din + kPad;
      const bool split = l + 1 < n;  // the top layer's g arrives rounded: g_lo = 0

      // dW_l += post_l^T g over the tile's rows, for the warp's tiles, one
      // tile's row steps after another (interleaving the tiles per row step
      // ran slower on an H100 80GB HBM3 at 700 W)
      const int nt = dout / 8;
#pragma unroll
      for (int s = 0; s < kDwTilesPerWarp; ++s) {
        const int tl = tile_begin + warp + kBwdWarps * s;
        if (tl < net.tile_off[l] || tl >= net.tile_off[l + 1]) continue;
        const int lt = tl - net.tile_off[l];
        const int mi = lt / nt, nj = lt - mi * nt;
        const uint32_t a_base =
            smem_addr(pl + ((q >> 1) * 8 + r8) * pld + 16 * mi + (q & 1) * 8);
        const int b_off = ((q & 1) * 8 + r8) * g_ld + 8 * nj;
        const uint32_t bh_base = smem_addr(ghi + b_off);
        const uint32_t bl_base = smem_addr(glo + b_off);
#pragma unroll 2
        for (int kr = 0; kr < kBwdRows / 16; ++kr) {
          uint32_t a[4], b0, b1;
          ldsm_x4_t(a, a_base + 2u * 16 * kr * pld);
          ldsm_x2_t(b0, b1, bh_base + 2u * 16 * kr * g_ld);
          mma_bf16(dacc[s], a, b0, b1);
          if (split) {
            ldsm_x2_t(b0, b1, bl_base + 2u * 16 * kr * g_ld);
            mma_bf16(dacc[s], a, b0, b1);
          }
        }
      }

      // dgrad for the warp's strip: round(g) @ W_l^T, masked by post_l > 0
      float acc[8][4];
      const bool dgrad = l > 0 || dx != nullptr;
      if (dgrad) {
        uint32_t a[4][4];
        const uint32_t gbase =
            smem_addr(ghi + (srow + (lane & 15)) * g_ld + (lane >> 4) * 8);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (16 * ks < dout) ldsm_x4(a[ks], gbase + 2u * 16 * ks);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        const int wld = dout + kPad;
        const uint32_t wbase = smem_addr(wsm + net.w_off[l] + ((q >> 1) * 8 + r8) * wld +
                                         (q & 1) * 8);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (16 * ks >= dout) break;
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (16 * jp >= din) break;
            uint32_t b[4];
            ldsm_x4(b, wbase + 2u * (16 * jp * wld + 16 * ks));
            mma_bf16(acc[2 * jp], a[ks], b[0], b[1]);
            mma_bf16(acc[2 * jp + 1], a[ks], b[2], b[3]);
          }
        }
        if (l > 0) {
          // g * (post > 0): a product, so a non-finite g stays non-finite
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (8 * j >= din) break;
            const int c = 8 * j + 2 * t;
            const float2 p0 = unpack_bf16(
                *reinterpret_cast<const uint32_t*>(pl + (srow + g) * pld + c));
            const float2 p1 = unpack_bf16(
                *reinterpret_cast<const uint32_t*>(pl + (srow + g + 8) * pld + c));
            acc[j][0] *= p0.x > 0.f ? 1.f : 0.f;
            acc[j][1] *= p0.y > 0.f ? 1.f : 0.f;
            acc[j][2] *= p1.x > 0.f ? 1.f : 0.f;
            acc[j][3] *= p1.y > 0.f ? 1.f : 0.f;
          }
        }
      }
      __syncthreads();  // every warp is done with this layer's g

      if (l > 0) {
        // the next g, split into its bf16 head and the bf16 rounding of the rest
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j >= din) break;
          const int c = 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
            const uint32_t hi = pack_bf16(v0, v1);
            const float2 hf = unpack_bf16(hi);
            // a non-finite head (NaN, inf, overflow) carries the value alone
            const float l0 = fabsf(hf.x) <= 3.0e38f ? v0 - hf.x : 0.f;
            const float l1 = fabsf(hf.y) <= 3.0e38f ? v1 - hf.y : 0.f;
            const int row = srow + g + 8 * h;
            *reinterpret_cast<uint32_t*>(ghi + row * g_ld + c) = hi;
            *reinterpret_cast<uint32_t*>(glo + row * g_ld + c) = pack_bf16(l0, l1);
          }
        }
        __syncthreads();
      } else if (dx != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j >= din) break;
          const int c = 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = row0 + srow + g + 8 * h;
            if (row < m)
              *reinterpret_cast<uint32_t*>(dx + row * d_in + c) =
                  pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
          }
        }
      }
    }
  }

  // the CTA's partial dW of this pass's tiles
  float* out = partial + (long long)blockIdx.x * net.dw_floats;
#pragma unroll
  for (int s = 0; s < kDwTilesPerWarp; ++s) {
    const int tl = tile_begin + warp + kBwdWarps * s;
    if (tl >= net.tile_off[n]) continue;
    int l = 0;
    while (tl >= net.tile_off[l + 1]) ++l;
    const int dout = net.width[l + 1], nt = dout / 8;
    const int lt = tl - net.tile_off[l];
    const int mi = lt / nt, nj = lt - mi * nt;
    float* d = out + net.dw_off[l] + (16 * mi + g) * dout + 8 * nj + 2 * t;
    *reinterpret_cast<float2*>(d) = make_float2(dacc[s][0], dacc[s][1]);
    *reinterpret_cast<float2*>(d + 8 * dout) = make_float2(dacc[s][2], dacc[s][3]);
  }
}

// ---------------------------------------------------------------------------
// f32 forward and backward (CUDA cores, 4x4 register micro-tiles)

constexpr int kF32Threads = 256;
constexpr int kF32FwdRows = 128;
constexpr int kF32BwdRows = 64;

__host__ __device__ inline int f32_ld(int rows) { return rows + 4; }

__host__ __device__ inline size_t fwd_f32_smem(const Net& net) {
  return (size_t(net.dw_floats) + 2 * size_t(kMaxWidth) * f32_ld(kF32FwdRows)) * sizeof(float);
}

__host__ __device__ inline size_t bwd_f32_smem(const Net& net) {
  size_t post = 0;
  for (int l = 0; l < net.n_layers; ++l) post += size_t(net.width[l]) * f32_ld(kF32BwdRows);
  return (2 * size_t(net.dw_floats) + post + 2 * size_t(kMaxWidth) * f32_ld(kF32BwdRows)) *
         sizeof(float);
}

__device__ __forceinline__ void stage_weights_f32(float* wsm, const Net& net) {
  for (int l = 0; l < net.n_layers; ++l) {
    const float4* w = static_cast<const float4*>(net.w[l]);
    const int n4 = net.width[l] * net.width[l + 1] / 4;
    float4* dst = reinterpret_cast<float4*>(wsm + net.dw_off[l]);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = w[i];
  }
}

// rows [row0, row0 + rows) of a [m, d] f32 matrix -> shared k-major [d][ld];
// rows past m are zeroed
__device__ __forceinline__ void load_tile_f32_t(float* dst, int ld, const float* src, int d,
                                                int rows, long long row0, long long m) {
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < rows * d4; i += blockDim.x) {
    const int r = i / d4, k = i - r * d4;
    const long long row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < m) v = *reinterpret_cast<const float4*>(src + row * d + 4 * k);
    dst[(4 * k + 0) * ld + r] = v.x;
    dst[(4 * k + 1) * ld + r] = v.y;
    dst[(4 * k + 2) * ld + r] = v.z;
    dst[(4 * k + 3) * ld + r] = v.w;
  }
}

// o[i][j] = sum_k act[k][r + i] * w[k][c + j], k ascending
__device__ __forceinline__ void micro_fwd(float (&o)[4][4], const float* act, int ld,
                                          const float* w, int dout, int din, int r, int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < din; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(act + k * ld + r);
    const float4 b = *reinterpret_cast<const float4*>(w + k * dout + c);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = fmaf(av[i], bv[j], o[i][j]);
  }
}

__global__ void __launch_bounds__(kF32Threads)
fused_mlp_fwd_f32_kernel(const float* __restrict__ x, float* __restrict__ y, Net net,
                         long long m) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int kLd = kF32FwdRows + 4;
  constexpr int kGroups = kF32FwdRows / 4;
  float* wsm = fsm;
  float* act0 = fsm + net.dw_floats;
  float* act1 = act0 + kMaxWidth * kLd;
  const int n = net.n_layers, d_in = net.width[0], d_out = net.width[n];

  stage_weights_f32(wsm, net);

  const long long n_tiles = (m + kF32FwdRows - 1) / kF32FwdRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kF32FwdRows;
    __syncthreads();  // the previous tile's readers of act0 are done
    load_tile_f32_t(act0, kLd, x, d_in, kF32FwdRows, row0, m);
    __syncthreads();
    float* hin = act0;
    float* hout = act1;
    for (int l = 0; l < n; ++l) {
      const int din = net.width[l], dout = net.width[l + 1];
      const float* wl = wsm + net.dw_off[l];
      const bool last = l + 1 == n;
      for (int it = threadIdx.x; it < kGroups * (dout / 4); it += kF32Threads) {
        const int r = 4 * (it % kGroups), c = 4 * (it / kGroups);
        float o[4][4];
        micro_fwd(o, hin, kLd, wl, dout, din, r, c);
        if (!last) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(hout + (c + j) * kLd + r) =
                make_float4(relu(o[0][j]), relu(o[1][j]), relu(o[2][j]), relu(o[3][j]));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long row = row0 + r + i;
            if (row < m)
              *reinterpret_cast<float4*>(y + row * d_out + c) =
                  make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
          }
        }
      }
      __syncthreads();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
  }
}

__global__ void __launch_bounds__(kF32Threads)
fused_mlp_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                         float* __restrict__ dx, float* __restrict__ partial, Net net,
                         long long m) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int kLd = kF32BwdRows + 4;
  constexpr int kGroups = kF32BwdRows / 4;
  const int n = net.n_layers, d_in = net.width[0], d_out = net.width[n];
  float* wsm = fsm;
  float* dwsm = wsm + net.dw_floats;
  float* post = dwsm + net.dw_floats;  // post[l]: [width[l]][kLd]
  int post_off[kMaxLayers];
  int off = 0;
  for (int l = 0; l < n; ++l) {
    post_off[l] = off;
    off += net.width[l] * kLd;
  }
  float* gbuf0 = post + off;
  float* gbuf1 = gbuf0 + kMaxWidth * kLd;

  stage_weights_f32(wsm, net);
  for (int i = threadIdx.x; i < net.dw_floats; i += kF32Threads) dwsm[i] = 0.f;

  const long long n_tiles = (m + kF32BwdRows - 1) / kF32BwdRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kF32BwdRows;
    __syncthreads();
    load_tile_f32_t(post + post_off[0], kLd, x, d_in, kF32BwdRows, row0, m);
    load_tile_f32_t(gbuf0, kLd, gy, d_out, kF32BwdRows, row0, m);
    __syncthreads();

    for (int l = 0; l + 1 < n; ++l) {
      const int din = net.width[l], dout = net.width[l + 1];
      const float* hin = post + post_off[l];
      float* hout = post + post_off[l + 1];
      for (int it = threadIdx.x; it < kGroups * (dout / 4); it += kF32Threads) {
        const int r = 4 * (it % kGroups), c = 4 * (it / kGroups);
        float o[4][4];
        micro_fwd(o, hin, kLd, wsm + net.dw_off[l], dout, din, r, c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(hout + (c + j) * kLd + r) =
              make_float4(relu(o[0][j]), relu(o[1][j]), relu(o[2][j]), relu(o[3][j]));
      }
      __syncthreads();
    }

    float* gin = gbuf0;
    float* gout = gbuf1;
    for (int l = n - 1; l >= 0; --l) {
      const int din = net.width[l], dout = net.width[l + 1];
      const float* pl = post + post_off[l];
      const float* wl = wsm + net.dw_off[l];
      // dW_l[k][c] += sum_r post_l[k][r] g[c][r]: a thread owns 4 x 4 of W_l
      float* dwl = dwsm + net.dw_off[l];
      const int kq = din / 4;
      for (int it = threadIdx.x; it < kq * (dout / 4); it += kF32Threads) {
        const int k = 4 * (it % kq), c = 4 * (it / kq);
        float o[4][4] = {};
#pragma unroll 2
        for (int r = 0; r < kF32BwdRows; r += 4) {
          float4 p[4], gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[i] = *reinterpret_cast<const float4*>(pl + (k + i) * kLd + r);
            gv[i] = *reinterpret_cast<const float4*>(gin + (c + i) * kLd + r);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              o[i][j] = fmaf(p[i].x, gv[j].x, o[i][j]);
              o[i][j] = fmaf(p[i].y, gv[j].y, o[i][j]);
              o[i][j] = fmaf(p[i].z, gv[j].z, o[i][j]);
              o[i][j] = fmaf(p[i].w, gv[j].w, o[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* d = reinterpret_cast<float4*>(dwl + (k + i) * dout + c);
          float4 v = *d;
          v.x += o[i][0];
          v.y += o[i][1];
          v.z += o[i][2];
          v.w += o[i][3];
          *d = v;
        }
      }
      // g' [r][k] = sum_c g[c][r] W_l[k][c], masked by post_l > 0 below the top
      if (l > 0 || dx != nullptr) {
        for (int it = threadIdx.x; it < kGroups * kq; it += kF32Threads) {
          const int r = 4 * (it % kGroups), k = 4 * (it / kGroups);
          float o[4][4] = {};
#pragma unroll 2
          for (int c = 0; c < dout; c += 4) {
            float4 gv[4], w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              gv[i] = *reinterpret_cast<const float4*>(gin + (c + i) * kLd + r);
              w[i] = *reinterpret_cast<const float4*>(wl + (k + i) * dout + c);
            }
            const float gr[4][4] = {{gv[0].x, gv[0].y, gv[0].z, gv[0].w},
                                    {gv[1].x, gv[1].y, gv[1].z, gv[1].w},
                                    {gv[2].x, gv[2].y, gv[2].z, gv[2].w},
                                    {gv[3].x, gv[3].y, gv[3].z, gv[3].w}};
            const float wr[4][4] = {{w[0].x, w[0].y, w[0].z, w[0].w},
                                    {w[1].x, w[1].y, w[1].z, w[1].w},
                                    {w[2].x, w[2].y, w[2].z, w[2].w},
                                    {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) o[i][j] = fmaf(gr[u][i], wr[j][u], o[i][j]);
          }
          if (l > 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 pv = *reinterpret_cast<const float4*>(pl + (k + j) * kLd + r);
              *reinterpret_cast<float4*>(gout + (k + j) * kLd + r) =
                  make_float4(o[0][j] * (pv.x > 0.f ? 1.f : 0.f),
                              o[1][j] * (pv.y > 0.f ? 1.f : 0.f),
                              o[2][j] * (pv.z > 0.f ? 1.f : 0.f),
                              o[3][j] * (pv.w > 0.f ? 1.f : 0.f));
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const long long row = row0 + r + i;
              if (row < m)
                *reinterpret_cast<float4*>(dx + row * d_in + k) =
                    make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
            }
          }
        }
      }
      __syncthreads();
      float* tmp = gin;
      gin = gout;
      gout = tmp;
    }
  }

  __syncthreads();
  float* out = partial + (long long)blockIdx.x * net.dw_floats;
  for (int i = threadIdx.x; i < net.dw_floats; i += kF32Threads) out[i] = dwsm[i];
}

__device__ __forceinline__ void store_dw(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_dw(bf16* p, float v) { *p = __float2bfloat16(v); }

// dw[j] = the sum over CTAs b of partial[b, j], cast to T, in a fixed order:
// thread row y sums b = y, y + 8, ... in turn, then row 0 adds the 8 sums in
// turn, so the result is the same from run to run
constexpr int kReduceCols = 32, kReduceRows = 8;

template <typename T>
__global__ void __launch_bounds__(kReduceCols * kReduceRows)
fused_mlp_bwd_reduce_kernel(const float* __restrict__ partial, int n_parts, int n_cols,
                            T* __restrict__ dw) {
  __shared__ float part[kReduceRows][kReduceCols];
  const int j = blockIdx.x * kReduceCols + threadIdx.x;
  float s = 0.f;
  if (j < n_cols)
    for (int b = threadIdx.y; b < n_parts; b += kReduceRows)
      s += partial[(long long)b * n_cols + j];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < n_cols) {
    float t = 0.f;
    for (int y = 0; y < kReduceRows; ++y) t += part[y][threadIdx.x];
    store_dw(dw + j, t);
  }
}

// ---------------------------------------------------------------------------
// Wide chains: widths above kMaxWidth, up to kWideMax (OriginNeRF's backbone,
// 64 -> 257 x 8 with the biases folded in, padded to 64 -> 272 x 8 by the
// wrapper). The same function as above; at 272 the bf16 weights of every
// layer (1.07 MB) and one CTA's f32 dW (2.1 MB) no longer fit on chip, so a
// chain kernel runs one layer after another over a CTA's row tile, which
// stays in shared memory, and streams each layer's weights through shared
// memory. Each step of a chain has its own epilogue (ReLU, a mask by another
// tensor > 0, copies of the result), so one kernel is the forward, the
// backward's recompute of the post-activations, and its dgrad chain
// (round(g) @ W^T masked by post > 0). The backward writes what its dW
// product needs (post_i, g_i) to global scratch, then dW_i = post_i^T g_i
// over row splits and the fixed-order sum of the splits above, so the result
// does not change from run to run.
//
// What bounds it: 2 x 1.07 Mflop per row forward (140 Gflop at 131072 rows,
// 0.14 ms at 989 TFLOP/s bf16), against 0.7 KB of x and y per row (0.03 ms):
// the tensor cores. The backward moves its scratch (post_i and g_i of the
// hidden layers) through device memory: written once and read once, 1.6 GB
// each way at 131072 rows in bf16, about 1 ms at 3.35 TB/s. In f32 the
// products take three TF32 passes: 3 x 125.5 Gflop forward and 3 x 359.2
// backward at 131072 rows of the 257-wide chain, 0.761 and 2.18 ms at 495
// TFLOP/s, against 1.87 and 5.36 ms of FMA at 67; the f32 scratch (post_i
// and g_i, 2.0 GB each way) is 1.2 ms of memory time.
//
// bf16 design (wgmma, TMA, mbarriers; hopper.cuh):
//   - chain kernels (kind 0 the forward, 2 the recompute, 1 the dgrad): a
//     persistent grid of one CTA per SM walking 128-row tiles, three
//     warpgroups. One producer warp streams every step's weights in 64-row
//     (k) chunks through a 3-slot ring with TMA and full/empty mbarriers, in
//     boxes of 128-byte rows with the 128-byte swizzle (boxes of 16-byte
//     columns, one line per row, kept the TMA unit busy longer than the
//     tensor cores). Two consumer warpgroups each own 64 rows of the tile.
//     Their activations stay in shared memory as the wgmma A operand, in
//     8 x 8 core-matrix cells ([8-row group][k/8][8][8], K-major, no
//     swizzle), and each k16 step is one wgmma.m64n256k16 (bf16 -> f32) plus
//     an m64n16k16 for columns 256..271 (m64n64 for N <= 64), B the staged
//     chunk. The forward reads W [k][n] as an MN-major B; the dgrad reads the
//     same W [n][k] as a K-major B, so no W^T copy is made. Accumulators stay
//     in registers (136 f32 a thread; setmaxnreg moves registers from the
//     producer to the consumers). After a step's last wgmma a warpgroup
//     writes ReLU/mask/round back over its own 64 rows, in place (in the
//     step's output width), with no barrier across warpgroups, while the
//     producer already fetches the next step's chunks. Inputs arrive and the
//     last output leaves by TMA (a box per 8-row group), and what the
//     backward keeps leaves by one bulk copy of the block;
//   - backward scratch: each plane in the same cell layout, 64-row block
//     after block, so a block moves by one bulk copy each way and any 8-row
//     groups of it are contiguous. The recompute writes post_i (bf16, post_0
//     a copy of x) and a bit plane of post_i > 0 per thread (2.5 KB a block:
//     the dgrad's threads hold the same elements and read only their bits,
//     not the 34 KB of post_i); the dgrad writes g_i as two bf16 planes,
//     g_hi = bf16(g) and g_lo = bf16(g - g_hi) (split_bf16: a non-finite head
//     carries the value alone), g_hi being the next dgrad step's input, and
//     the top g as it came;
//   - dW kernel: dW_i = post_i^T g_hi + post_i^T g_lo, two wgmma into one f32
//     accumulator, contracting over rows (post_i the MN-major A, the g
//     planes the MN-major B). A CTA holds 128 din rows (a slice) x all dout
//     columns (two consumer warpgroups of 64 x 272) of one layer over one row
//     split; a producer warp keeps four 32-row slots in flight, each four
//     contiguous bulk copies of the CTA's post slice and one of each g
//     plane. Each split writes its partial dW; the fixed-order sum follows.
//     The slices of a layer each read the g planes from L2 (no cluster
//     multicast: a cluster of the slices sharing them ran slower on an H100
//     than independent CTAs in several waves).
//
// f32 design (replaces the wide chains' first CUDA-core kernels, which ran
// 4x4 register micro-tiles with every weight re-read from L2 per 64-row CTA
// and a dW of 64 x 64 tiles that read the scratch five times):
//   - 3xTF32 arithmetic, for the forward and dW: every f32 operand v is
//     split as v = big + small (tf32_split), big v with its low 13 mantissa
//     bits cleared, small the TF32 rounding of v - big (exact in f32). Each
//     product is three TF32 wgmma into one f32 accumulator, small terms
//     first: small(a) big(b) + big(a) small(b) + big(a) big(b). Lost are
//     small(a) small(b) (below 2^-20 of the product) and the rounding of
//     small, and the tensor cores' accumulation is not f32's rounding to
//     nearest: the forward reads ~3e-6 of its scale off the plain version
//     (chip_smoke.py), against 1e-4 allowed forward and in dW.
//     Exact where one operand has at most 11 significant bits and the other
//     at most 22. A non-finite a takes part through big alone (its small and
//     its `fin` copy of big are 0), so inf times a b whose small is 0 does
//     not become NaN;
//   - TF32 wgmma reads K-major operands only, so A comes from registers:
//     each consumer loads its k8 fragment (4 floats) from its block in
//     shared memory and splits it there, and one f32 activation plane is
//     kept (two 64 x 272 blocks, 139 KB). The forward's B is prepared per
//     call by fused_mlp_wide_tf32_prep_kernel, each layer's W^T as big and
//     small planes of K-major cells in k8 chunks padded to the wgmma's N
//     (8.6 MB at 272 wide); one chunk (17 KB) is one ring slot filled by one
//     bulk copy, five in the ring. The wgmma read their A registers after
//     they are issued, which the compiler does not know: a consumer splits
//     two k8 steps, issues their six products, waits for them and only then
//     lets the registers go (keep_fragments), the other consumer warpgroup
//     keeping the tensor cores busy meanwhile;
//   - forward (fused_mlp_wide_tf32_kernel): the bf16 kernels' skeleton
//     (persistent grid, a producer thread, two consumer warpgroups of 64
//     rows, setmaxnreg, full/empty mbarriers), activations in the
//     feature-major cells of fm_off, x in by plain loads, y out from
//     registers;
//   - backward: the recompute and the dgrad on the CUDA cores, summed in
//     the order the plain version's GEMM took at the sizes measured
//     (fused_mlp_wide_fma_kernel: 3xTF32 would move ReLU masks and dx
//     beyond the f32 limit on dx, see there), each writing its
//     blocks to planes in the feature-major layout that dW reads K-major
//     without a transpose, the recompute a bit plane of post_i > 0 that the
//     dgrad reads instead of post_i;
//   - dW kernel (fused_mlp_wide_dw_tf32_kernel): dW_i = post_i^T g_i in
//     3xTF32, post from registers (split there), g from the ring: the
//     producer warpgroup's first thread copies 16-row slots (the CTA's
//     128-din slice of post, all of g), its other three warps split each
//     slot's g into big (in place) and small planes. The scratch is f32
//     written once and read once (about 4 GB at 131072 rows; split planes
//     from the dgrad would have made it 6 GB). The tensor cores round the
//     accumulator toward zero, an error that grew with the rows one
//     accumulator summed (5.2e-5 of scale at 6016 rows on the H100); each 256
//     rows' sum is added to the split's partial by f32 reductions in L2
//     (kT32DwFlush, t32_dw_flush: the consumer does not wait; loading the
//     partial back to add in registers cost far more), so the error no longer
//     grows with a split's rows. Row splits and the fixed-order sum as in
//     bf16.

constexpr int kWideMax = 272;                 // widest layer the wide kernels take

// v0, v1 -> their bf16 head and the bf16 rounding of the rest
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 hf = unpack_bf16(hi);
  // a non-finite head (NaN, inf, overflow) carries the value alone
  lo = pack_bf16(fabsf(hf.x) <= 3.0e38f ? v0 - hf.x : 0.f,
                 fabsf(hf.y) <= 3.0e38f ? v1 - hf.y : 0.f);
}

// ---- bf16 wide kernels (wgmma) ----

namespace hp = hopper;

constexpr int kWgThreads = 128;               // a warpgroup
constexpr int kWsThreads = 3 * kWgThreads;    // producer warpgroup + two consumer warpgroups
constexpr int kBlk = 64;                      // rows of a consumer warpgroup's block
constexpr int kTile = 2 * kBlk;               // rows of a CTA's tile
constexpr int kQ = kBlk / 8;                  // 8-row groups of a block
constexpr uint32_t kCell = 128;               // one core matrix: 8 rows x 8 columns of bf16
constexpr uint32_t kActBytes = kBlk * kWideMax * 2;  // a warpgroup's block, 272 wide
constexpr int kChunkK = 64;                   // weight rows (k) per ring slot
constexpr int kStages = 3;
constexpr int kBoxN = 64;                     // W [k][n]: boxes of 64 n (128 B, swizzled) x 64 k
constexpr uint32_t kMnBoxBytes = kChunkK * 128;
constexpr int kKBoxRows = 136;                // W [n][k]: boxes of 64 k (128 B) x 136 n
constexpr uint32_t kKBoxBytes = kKBoxRows * 128;
constexpr uint32_t kSlotBytes = ((kWideMax + kBoxN - 1) / kBoxN) * kMnBoxBytes;
static_assert(2 * kKBoxBytes <= kSlotBytes, "both chunk layouts fit a slot");
constexpr int kDwRows = 32;                   // dW: rows (K) per ring slot
constexpr int kDwQ = kDwRows / 8;
constexpr int kDwSlice = 2 * kBlk;            // dW: din rows of one CTA
constexpr uint32_t kDwPostBytes = kDwQ * (kDwSlice / 8) * kCell;
constexpr uint32_t kDwPlaneBytes = kDwQ * (kWideMax / 8) * kCell;
constexpr uint32_t kDwSlotBytes = kDwPostBytes + 2 * kDwPlaneBytes;  // post, g_hi, g_lo
constexpr int kDwStages = 4;
constexpr int kRegsProducer = 56, kRegsConsumer = 224;

constexpr size_t kChainSmem = 1024 + 2 * size_t(kActBytes) + kStages * size_t(kSlotBytes) +
                              (2 * kStages + 2) * 8;
constexpr size_t kDwSmem = 1024 + kDwStages * size_t(kDwSlotBytes) + 2 * kDwStages * 8;
constexpr size_t kSmemOptin = 232448;  // the H100's opt-in dynamic shared memory per block
static_assert(kChainSmem <= kSmemOptin && kDwSmem <= kSmemOptin,
              "a wide kernel's CTA fits an SM");

// The accumulators of a warpgroup's 64 rows x up to 272 columns: wgmma
// m64n256 into a (m64n64 into its first 32 for N <= 64) and m64n16 into b
// for columns 256..271. Fragment layout of both: for each 8-column group j,
// [4j + 2e + i] is row 16 * warp + lane / 4 + 8e, column 8j + 2 (lane % 4) + i.
struct Acc {
  float a[128];
  float b[8];
};

// the wgmma a product of N columns takes: 0 (N <= 64), 1 (N <= 256), 2
__host__ __device__ constexpr int wgmma_kind(int n) { return n <= 64 ? 0 : n <= 256 ? 1 : 2; }

template <int TA, int TB, int NI>
__device__ __forceinline__ void mma(Acc& acc, uint64_t da, uint64_t db, uint64_t db16,
                                    int scale) {
  if (NI == 0)
    hp::wgmma_m64n64k16<TA, TB>(reinterpret_cast<float(&)[32]>(acc.a), da, db, scale);
  else
    hp::wgmma_m64n256k16<TA, TB>(acc.a, da, db, scale);
  if (NI == 2) hp::wgmma_m64n16k16<TA, TB>(acc.b, da, db16, scale);
}

__device__ __forceinline__ void acc_fence(Acc& acc) {
  hp::reg_fence(acc.a);
  hp::reg_fence(acc.b);
}

// accumulators of 8-column group gi (compile-time), row half e, columns 2 (lane % 4) + {0, 1}
__device__ __forceinline__ float2 acc_pair(const Acc& acc, int gi, int e) {
  return gi < 32 ? make_float2(acc.a[4 * gi + 2 * e], acc.a[4 * gi + 2 * e + 1])
                 : make_float2(acc.b[4 * (gi - 32) + 2 * e], acc.b[4 * (gi - 32) + 2 * e + 1]);
}

// Layout of a 64-row block of width w, in shared memory and in the backward's
// scratch planes alike: [8-row group q][w/8 column groups][8 rows][8 columns]
// of bf16, each [8][8] cell one wgmma core matrix (128 contiguous bytes).
// Row r, column c of the block is element (r/8) * 8w + (c/8) * 64 + (r%8) * 8
// + c%8. A plane is its blocks one after another.
__device__ __forceinline__ int cell_off(int w, int q, int gi) { return q * 8 * w + gi * 64; }

// One step of a bf16 chain: out = A_s @ B_s over a warpgroup's 64 rows, then
// the epilogue.
struct ChainStep {
  int k, n;          // B_s is k x n
  int relu;          // forward: ReLU on the product
  uint32_t* bits;    // or null: forward, writes round(out) > 0 to a bit plane; dgrad,
                     // reads the mask (times 1 or 0) from one
  bf16* hi;          // or null: round(out) to an [n] plane
  bf16* lo;          // dgrad: or null, bf16(out - round(out)) to an [n] plane
};

// A bit plane holds, per 64-row block, each consumer thread's 136 bits of
// (column group gi, row half e, column i) > 0, bit (2 gi + e) * 2 + i, in
// kBitWords words, word-major: [block][word][128 threads]. The forward writes
// it where the dgrad, whose threads hold the same elements, reads it: 2.5 KB
// a block against the 34 KB of the post-activations themselves.
constexpr int kBitWords = (kWideMax / 8 * 4 + 31) / 32;
__host__ __device__ constexpr long long bit_plane_words(long long blocks) {
  return blocks * kBitWords * kWgThreads;
}

// bf16 bits h > 0 (not NaN, not -0)
__device__ __forceinline__ uint32_t bf16_positive(uint32_t h) { return h - 1u < 0x7F80u; }

// A chain of one kind: 0 (the forward) and 2 (the backward's recompute,
// which also writes the bit planes) read W [k][n]; 1 (the dgrad) reads
// W [n][k], masks and splits.
struct ChainArgs {
  CUtensorMap w[kMaxLayers];  // B_s's weight: boxes of 64 x 64 (W [k][n]) or 64 x 136 (W [n][k])
  CUtensorMap in;             // the input [m][k0] as (8 columns, rows, k0/8 groups), 8 x 8 x k0/8
  CUtensorMap out;            // round(out) of the last step [m][n] when has_out, as in
  ChainStep st[kMaxLayers];
  bf16* in_copy;              // or null: the input to a [k0] plane
  long long m;
  int steps, k0, has_out;
};

// The producer warp: every step's weight chunks of every tile the CTA takes,
// in the order the consumers use them, into the ring. Rows past the weight
// arrive as zeros and count.
template <int KIND>
__device__ __forceinline__ void chain_producer(const ChainArgs& a, uint32_t ring, uint32_t bars,
                                               long long tiles) {
  const int lane = threadIdx.x & 31;
  int slot = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int s = 0; s < a.steps; ++s) {
      const ChainStep& st = a.st[s];
      const bool kmajor = KIND == 1;
      const int boxes = kmajor ? (st.n + kKBoxRows - 1) / kKBoxRows : (st.n + kBoxN - 1) / kBoxN;
      for (int kc = 0; kc < st.k; kc += kChunkK) {
        hp::mbar_wait(bars + 8u * (kStages + slot), phase ^ 1);
        const uint32_t dst = ring + slot * kSlotBytes, full = bars + 8u * slot;
        if (lane == 0) hp::mbar_expect_tx(full, boxes * (kmajor ? kKBoxBytes : kMnBoxBytes));
        __syncwarp();
        if (lane < boxes) {
          if (kmajor)  // [272 n][64 k]: rows continue from box to box
            hp::tma_load_2d(dst + lane * kKBoxBytes, &a.w[s], kc, kKBoxRows * lane, full);
          else         // [n / 64][64 k][64 n]
            hp::tma_load_2d(dst + lane * kMnBoxBytes, &a.w[s], kBoxN * lane, kc, full);
        }
        if (++slot == kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
}

// acc = A @ B_s for a consumer warpgroup's block `act`, over the step's
// chunks in the ring. TB: 1 for W [k][n] (MN-major B), 0 for W [n][k]; NI:
// wgmma_kind(n).
template <int TB, int NI>
__device__ __forceinline__ void chain_mma(Acc& acc, const ChainStep& st, uint32_t act,
                                          uint32_t ring, uint32_t bars, int& slot,
                                          uint32_t& phase) {
  const bool signal = (threadIdx.x & 31) == 0;  // one arrival per warp
  const uint32_t q_stride = st.k / 8 * kCell;   // A: between 8-row groups
  int prev = -1;
  acc_fence(acc);
  for (int kc = 0; kc < st.k; kc += kChunkK) {
    hp::mbar_wait(bars + 8u * slot, phase);
    const uint32_t b = ring + slot * kSlotBytes;
    const int nks = min(kChunkK, st.k - kc) / 16;
    hp::wgmma_fence();
#pragma unroll 1
    for (int ks = 0; ks < nks; ++ks) {
      // A: core matrices 128 B apart along k, q_stride along rows
      const uint64_t da = hp::gmma_desc(act + (kc + 16 * ks) / 8 * kCell, kCell, q_stride);
      uint64_t db, db16;
      if (TB) {  // 64-column blocks 8 KB apart, 8-row groups 1 KB apart
        db = hp::gmma_desc(b + 2048 * ks, kMnBoxBytes, 1024, true);
        db16 = hp::gmma_desc(b + 4 * kMnBoxBytes + 2048 * ks, kMnBoxBytes, 1024, true);
      } else {  // 8-row groups 1 KB apart, k16 at 32 bytes within the row
        db = hp::gmma_desc(b + 32 * ks, 16, 1024, true);
        db16 = hp::gmma_desc(b + 256 * 128 + 32 * ks, 16, 1024, true);
      }
      mma<0, TB, NI>(acc, da, db, db16, kc + ks > 0);  // the first product overwrites acc
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();  // the previous chunk's products are done: free its slot
    if (prev >= 0 && signal) hp::mbar_arrive(bars + 8u * (kStages + prev));
    prev = slot;
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  hp::wgmma_wait<0>();
  acc_fence(acc);
  if (prev >= 0 && signal) hp::mbar_arrive(bars + 8u * (kStages + prev));
}

// A consumer warpgroup: the 64-row block `c` of each tile, every step.
template <int KIND>
__device__ __forceinline__ void chain_consumer(const ChainArgs& a, uint32_t act, uint32_t ring,
                                               uint32_t bars, int c, long long tiles) {
  const int tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;
  const bool leader = tid == 0;
  const uint32_t in_bar = bars + 8u * (2 * kStages + c);
  const uint32_t bar_id = 1 + c;  // the warpgroup's named barrier
  // the thread's accumulators: rows 16 warp + lane / 4 + 8e (8-row group
  // 2 warp + e, row lane / 4 in it), columns cq, cq + 1 of each group
  const int rq = lane >> 2, cq = 2 * (lane & 3);
  int slot = 0;
  uint32_t phase = 0, in_phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kTile + c * kBlk, blk = row0 / kBlk;
    if (leader) {  // the input block, once the last stores have read the block
      hp::bulk_wait_read();
      hp::mbar_expect_tx(in_bar, a.k0 * kBlk * 2);
      for (int q = 0; q < kQ; ++q)
        hp::tma_load_3d(act + q * (a.k0 / 8) * kCell, &a.in, 0, int(row0) + 8 * q, 0, in_bar);
    }
    hp::mbar_wait(in_bar, in_phase);
    in_phase ^= 1;
    if (leader && a.in_copy) {
      hp::bulk_store(a.in_copy + blk * kBlk * a.k0, act, a.k0 * kBlk * 2);
      hp::bulk_commit();
    }
    for (int s = 0; s < a.steps; ++s) {
      const ChainStep& st = a.st[s];
      const int groups = st.n / 8;
      const long long boff = blk * kBlk * st.n;  // the block in an [n] plane
      // the thread's words of the step's bit plane: the dgrad's mask, loaded
      // while the products run (all ones without a mask)
      uint32_t* bits = st.bits ? st.bits + bit_plane_words(blk) + tid : nullptr;
      uint32_t wb[kBitWords];
#pragma unroll
      for (int k = 0; k < kBitWords; ++k)
        wb[k] = KIND == 1 ? hp::ld_global_if(bits + k * kWgThreads, bits != nullptr, ~0u) : 0u;
      Acc acc;
      const int kind = wgmma_kind(st.n);
      constexpr int TB = KIND == 1 ? 0 : 1;
      if (kind == 2) chain_mma<TB, 2>(acc, st, act, ring, bars, slot, phase);
      else if (kind == 1) chain_mma<TB, 1>(acc, st, act, ring, bars, slot, phase);
      else chain_mma<TB, 0>(acc, st, act, ring, bars, slot, phase);

      // epilogue, in place over the block (now [8-row group][n/8][8][8]) once
      // its last stores have read it; straight-line over all 34 column
      // groups, the accesses predicated
      if (leader) hp::bulk_wait_read();
      hp::named_barrier(bar_id, kWgThreads);
      const bool relu_on = st.relu, has_lo = st.lo != nullptr;
#pragma unroll
      for (int gi = 0; gi < kWideMax / 8; ++gi)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int off = cell_off(st.n, 2 * warp + e, gi) + rq * 8 + cq;
          const bool in = gi < groups;
          const int b = (2 * gi + e) * 2;  // the pair's bits in the plane
          float2 v = acc_pair(acc, gi, e);
          uint32_t hi;
          if (KIND != 1) {
            v.x = relu_on && v.x < 0.f ? 0.f : v.x;
            v.y = relu_on && v.y < 0.f ? 0.f : v.y;
            hi = pack_bf16(v.x, v.y);
            if (KIND == 2)
              wb[b / 32] |= (bf16_positive(hi & 0xFFFFu) | bf16_positive(hi >> 16) << 1) << (b % 32);
          } else {  // times the mask: a product, so a non-finite value stays non-finite
            v.x *= (wb[b / 32] >> (b % 32)) & 1u ? 1.f : 0.f;
            v.y *= (wb[b / 32] >> (b % 32 + 1)) & 1u ? 1.f : 0.f;
            uint32_t lo;
            split_bf16(v.x, v.y, hi, lo);
            hp::st_global_if(st.lo + boff + off, lo, has_lo && in);
          }
          hp::st_shared_if(act + 2 * off, hi, in);
        }
      if (KIND == 2 && bits)
#pragma unroll
        for (int k = 0; k < kBitWords; ++k) bits[k * kWgThreads] = wb[k];
      hp::fence_async_shared();
      hp::named_barrier(bar_id, kWgThreads);
      if (leader) {
        if (st.hi) hp::bulk_store(st.hi + boff, act, st.n * kBlk * 2);
        if (a.has_out && s + 1 == a.steps)
          for (int q = 0; q < kQ; ++q)
            hp::tma_store_3d(&a.out, act + q * groups * kCell, 0, int(row0) + 8 * q, 0);
        hp::bulk_commit();
      }
    }
  }
  if (leader) hp::bulk_wait();
}

template <int KIND>
__global__ void __launch_bounds__(kWsThreads, 1)
fused_mlp_wide_bf16_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + 2 * kActBytes;
  const uint32_t bars = ring + kStages * kSlotBytes;  // full[kStages], empty[kStages], in[2]
  const long long tiles = (a.m + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(bars + 8u * s, 1);
      hp::mbar_init(bars + 8u * (kStages + s), 2 * kWgThreads / 32);
    }
    hp::mbar_init(bars + 8u * 2 * kStages, 1);
    hp::mbar_init(bars + 8u * (2 * kStages + 1), 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    hp::regs_dec<kRegsProducer>();
    if (threadIdx.x < 32) chain_producer<KIND>(a, ring, bars, tiles);
  } else {
    hp::regs_inc<kRegsConsumer>();
    chain_consumer<KIND>(a, base + (wg - 1) * kActBytes, ring, bars, wg - 1, tiles);
  }
}

// One layer of the bf16 dW product. Planes are blocked, as the chain's; a
// ring slot takes 32 rows (four 8-row groups) of a 64-row block: of g, one
// contiguous piece; of post, the CTA's din slice of each 8-row group.
struct DwLayer {
  const bf16* post;  // [din] plane of post_i (post_0 = x)
  const bf16* hi;    // [dout] planes of g_i's bf16 head
  const bf16* lo;    // and of the rest; null for the top layer (g arrives rounded)
  int din, dout, dw_off;
};

struct DwArgs {
  DwLayer l[kMaxLayers];
  float* partial;        // [splits][dw_floats]
  long long blocks;      // 64-row blocks to sum over
  long long per_split;   // blocks of one row split (blockIdx.y)
  int dw_floats;
  int slices;            // CTAs of one layer along din (blockIdx.x = layer x slices + slice)
};

// acc += post^T g over a slot's 32 rows: post [4 row groups][16 din groups]
// (A) and the g planes [4 row groups][dout/8] (B) of [8 rows][8] cells, both
// MN-major, with the 8-row groups along K
template <int NI>
__device__ __forceinline__ void dw_mma(Acc& acc, uint32_t s0, int c, int gout, bool has_lo) {
  const uint32_t g_q = gout * kCell;  // B: between 8-row groups
#pragma unroll
  for (int ks = 0; ks < kDwRows / 16; ++ks) {
    const uint64_t da = hp::gmma_desc(s0 + 8 * c * kCell + 2 * ks * (kDwSlice / 8) * kCell,
                                      (kDwSlice / 8) * kCell, kCell);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p == 1 && !has_lo) break;
      const uint32_t g0 = s0 + kDwPostBytes + p * kDwPlaneBytes + 2 * ks * g_q;
      mma<1, 1, NI>(acc, da, hp::gmma_desc(g0, g_q, kCell),
                    hp::gmma_desc(g0 + 32 * kCell, g_q, kCell), 1);
    }
  }
}

// dW_i rows [128 slice, 128 slice + 128) x all columns of one layer, over
// the row split blockIdx.y, 32 rows per ring slot.
__global__ void __launch_bounds__(kWsThreads, 1)
fused_mlp_wide_dw_bf16_kernel(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kDwStages * kDwSlotBytes;  // full[kDwStages], empty[kDwStages]
  const int rank = int(blockIdx.x) % a.slices;               // the slice
  const DwLayer& L = a.l[blockIdx.x / a.slices];
  const int n_active = (L.din + kDwSlice - 1) / kDwSlice;  // slices with rows
  const bool active = rank < n_active;
  constexpr int kParts = kBlk / kDwRows;                    // slots of a 64-row block
  const long long h0 = kParts * blockIdx.y * a.per_split;  // the split's slots
  const long long h1 = kParts * min(a.blocks, (blockIdx.y + 1) * a.per_split);
  const int warps_per_cta = 2 * kWgThreads / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      hp::mbar_init(bars + 8u * s, 1);
      hp::mbar_init(bars + 8u * (kDwStages + s), warps_per_cta);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    hp::regs_dec<kRegsProducer>();
    if (active && threadIdx.x == 0) {
      const int gin = L.din / 8, gout = L.dout / 8, planes = L.lo ? 2 : 1;
      const int np = min(kDwSlice / 8, gin - kDwSlice / 8 * rank);  // the CTA's din groups
      const uint32_t g_bytes = kDwQ * gout * kCell;
      int slot = 0;
      uint32_t phase = 0;
      for (long long h = h0; h < h1; ++h) {
        hp::mbar_wait(bars + 8u * (kDwStages + slot), phase ^ 1);
        const uint32_t dst = base + slot * kDwSlotBytes, full = bars + 8u * slot;
        const long long blk = h / kParts;
        const int q0 = kDwQ * int(h % kParts);
        hp::mbar_expect_tx(full, kDwQ * np * kCell + planes * g_bytes);
        for (int q = 0; q < kDwQ; ++q)
          hp::bulk_load(dst + q * (kDwSlice / 8) * kCell,
                        L.post + blk * kBlk * L.din + cell_off(L.din, q0 + q, kDwSlice / 8 * rank),
                        np * kCell, full);
        for (int p = 0; p < planes; ++p)
          hp::bulk_load(dst + kDwPostBytes + p * kDwPlaneBytes,
                        (p ? L.lo : L.hi) + blk * kBlk * L.dout + cell_off(L.dout, q0, 0),
                        g_bytes, full);
        if (++slot == kDwStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    hp::regs_inc<kRegsConsumer>();
    const int c = wg - 1, tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;
    const int m0 = kDwSlice * rank + kBlk * c;  // the warpgroup's first din row
    const bool computes = active && m0 < L.din;
    const int kind = wgmma_kind(L.dout), gout = L.dout / 8;
    const bool signal = lane == 0, has_lo = L.lo != nullptr;
    Acc acc;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc.a[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc.b[i] = 0.f;
    auto release = [&](int s) {
      if (signal) hp::mbar_arrive(bars + 8u * (kDwStages + s));
    };
    if (active) {
      int slot = 0, prev = -1;
      uint32_t phase = 0;
      acc_fence(acc);
      for (long long h = h0; h < h1; ++h) {
        hp::mbar_wait(bars + 8u * slot, phase);
        if (computes) {
          const uint32_t s0 = base + slot * kDwSlotBytes;
          hp::wgmma_fence();
          if (kind == 2) dw_mma<2>(acc, s0, c, gout, has_lo);
          else if (kind == 1) dw_mma<1>(acc, s0, c, gout, has_lo);
          else dw_mma<0>(acc, s0, c, gout, has_lo);
          hp::wgmma_commit();
          hp::wgmma_wait<1>();
          if (prev >= 0) release(prev);
          prev = slot;
        } else {
          release(slot);
        }
        if (++slot == kDwStages) {
          slot = 0;
          phase ^= 1;
        }
      }
      hp::wgmma_wait<0>();
      acc_fence(acc);
      if (prev >= 0) release(prev);
    }
    if (computes) {  // the split's partial of the warpgroup's 64 rows
      float* out = a.partial + blockIdx.y * (long long)a.dw_floats + L.dw_off;
      const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
      for (int gi = 0; gi < kWideMax / 8; ++gi)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = m0 + r0 + 8 * e, col = 8 * gi + cq;
          if (d < L.din && col < L.dout)
            *reinterpret_cast<float2*>(out + d * L.dout + col) = acc_pair(acc, gi, e);
        }
    }
  }
}

// ---- f32 wide kernels (3xTF32 on wgmma) ----

constexpr int kT32Stages = 5;                              // chain ring: one k8 step of B a slot
constexpr uint32_t kT32ActBytes = kBlk * kWideMax * 4;     // a warpgroup's f32 block, 272 wide
constexpr uint32_t kT32PlaneBytes = 8 * kWideMax * 4;      // one k8 step of B, 272 columns
constexpr uint32_t kT32SlotBytes = 2 * kT32PlaneBytes;     // its big and small planes
constexpr int kT32DwRows = 16;                             // dW: rows (K) per ring slot
constexpr uint32_t kT32DwPostBytes = (kT32DwRows / 4) * (kDwSlice / 8) * kCell;
constexpr uint32_t kT32DwPlaneBytes = kT32DwRows * kWideMax * 4;
constexpr uint32_t kT32DwSlotBytes = kT32DwPostBytes + 2 * kT32DwPlaneBytes;  // post, g big, g small
constexpr int kT32DwStages = 5;
// dW: slots (256 rows) one accumulator sums before it is added to the
// split's partial. The tensor cores round the accumulator toward zero at
// every k8 step, an error that grows with the rows summed into it; f32
// adds (to nearest) of the 256-row sums keep it from growing with the rows
// a split holds.
constexpr int kT32DwFlush = 16;
constexpr int kSplitThreads = kWgThreads - 32;             // dW: the producer warpgroup's other warps

constexpr size_t kT32ChainSmem = 1024 + 2 * size_t(kT32ActBytes) +
                                 kT32Stages * size_t(kT32SlotBytes) + 2 * kT32Stages * 8;
constexpr size_t kT32DwSmem = 1024 + kT32DwStages * size_t(kT32DwSlotBytes) + 3 * kT32DwStages * 8;
static_assert(kT32ChainSmem <= kSmemOptin && kT32DwSmem <= kSmemOptin,
              "an f32 wide kernel's CTA fits an SM");

// v -> big, its TF32 head (v with the low 13 mantissa bits cleared; a NaN
// keeps a payload bit, so it stays a NaN), small, the TF32 rounding
// (nearest, ties away) of v - big, which f32 holds exactly, and fin, big
// where v is finite and 0 elsewhere. A non-finite v is carried by big
// alone (small = 0, not inf - inf).
__device__ __forceinline__ void tf32_split(float v, uint32_t& big, uint32_t& small,
                                           uint32_t& fin) {
  const uint32_t u = __float_as_uint(v);
  const bool finite = (u & 0x7F800000u) != 0x7F800000u;
  big = (u & 0xFFFFE000u) | (!finite && (u & 0x007FFFFFu) ? 0x00400000u : 0u);
  fin = finite ? big : 0u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(finite ? v - __uint_as_float(big) : 0.f));
}

// Layout of an f32 64-row block of width w, in shared memory and in the
// backward's scratch planes alike: [4-row group][w/8 feature groups][8
// features][4 rows], each [8][4] cell a TF32 core matrix (128 contiguous
// bytes) with the rows along K, as dW = post^T g contracts them. Row r,
// feature f of the block is float ((r/4) (w/8) + f/8) 32 + (f%8) 4 + r%4;
// a plane is its blocks one after another.
__device__ __forceinline__ int fm_off(int w, int r, int f) {
  return ((r >> 2) * (w >> 3) + (f >> 3)) * 32 + (f & 7) * 4 + (r & 3);
}

// columns a step's B is padded to: the N of its wgmma (wgmma_kind)
__host__ __device__ constexpr int tf32_np(int n) { return n <= 64 ? 64 : n <= 256 ? 256 : kWideMax; }

// floats of one layer's prepared B for a step of n columns and depth k: k/8
// chunks (one ring slot each) of a big and a small plane, each [k/4 in the
// chunk (2)][np/8 column groups][8 columns][4 k], K-major core matrices
__host__ __device__ inline long long tf32_prep_floats(int n, int k) {
  return (long long)(k / 8) * 16 * tf32_np(n);
}

// The weights as the f32 forward reads them, split once per call: layer i
// as its B (W_i^T: n = dout, k = din) at off[i] floats.
struct T32Prep {
  const float* w[kMaxLayers];
  int din[kMaxLayers], dout[kMaxLayers];
  long long off[kMaxLayers];
};

__global__ void __launch_bounds__(256)
fused_mlp_wide_tf32_prep_kernel(const __grid_constant__ T32Prep p, float* __restrict__ out) {
  const int l = blockIdx.y, din = p.din[l], dout = p.dout[l], np = tf32_np(dout);
  const float* w = p.w[l];
  float* dst = out + p.off[l];
  const long long total = (long long)np * din;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int n = int(i % np), k = int(i / np);
    uint32_t big, small, fin;
    tf32_split(n < dout ? w[k * dout + n] : 0.f, big, small, fin);
    const long long o = (long long)(k >> 3) * 16 * np + ((k & 7) >> 2) * 4 * np + (n >> 3) * 32 +
                        (n & 7) * 4 + (k & 3);
    dst[o] = __uint_as_float(big);
    dst[o + 8 * np] = __uint_as_float(small);
  }
}

template <int NI>
__device__ __forceinline__ void t32_mma(Acc& acc, const uint32_t (&a)[4], uint64_t db,
                                        uint64_t db16, int scale) {
  if (NI == 0)
    hp::wgmma_m64n64k8_tf32(reinterpret_cast<float(&)[32]>(acc.a), a, db, scale);
  else
    hp::wgmma_m64n256k8_tf32(acc.a, a, db, scale);
  if (NI == 2) hp::wgmma_m64n16k8_tf32(acc.b, a, db16, scale);
}

// A's fragment v (a[0..3] of the register layout) of one k8 step -> a:
// small, fin and big (tf32_split), in their registers before the next asm
// (the compiler would otherwise be free to compute them after the
// wgmma.fence, and the wgmma would read stale registers).
__device__ __forceinline__ void t32_split(const float (&v)[4], uint32_t (&a)[12]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(v[i], a[8 + i], a[i], a[4 + i]);
#pragma unroll
  for (int i = 0; i < 12; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The wgmma read their A registers after they are issued, and the compiler
// does not know it: a register it reused before the wgmma_wait<0> that
// covers them would feed them other values. Uses the fragments after that
// wait, so they stay in their registers until then.
template <int N>
__device__ __forceinline__ void keep_fragments(const uint32_t (&a)[N][12]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 12; ++i) asm volatile("" ::"r"(a[j][i]));
}

// acc (+)= A @ B over one k8 step (after a wgmma_fence): A's split fragment
// a, B's big and small planes at shared addresses big_b and small_b
// (K-major cells, lbo bytes apart along k, 128 along n). Three products,
// small terms first: small(A) big(B) + fin(A) small(B) + big(A) big(B);
// fin(A) is 0 where A is not finite, so a non-finite A meets B's big alone
// (inf times a small of 0 would be NaN where the function's product is inf).
template <int NI>
__device__ __forceinline__ void t32_mma3(Acc& acc, const uint32_t (&a)[12], uint32_t big_b,
                                         uint32_t small_b, uint32_t lbo, int scale) {
  const uint32_t(&small)[4] = *reinterpret_cast<const uint32_t(*)[4]>(a);
  const uint32_t(&fin)[4] = *reinterpret_cast<const uint32_t(*)[4]>(a + 4);
  const uint32_t(&big)[4] = *reinterpret_cast<const uint32_t(*)[4]>(a + 8);
  const uint64_t bb = hp::gmma_desc(big_b, lbo, kCell), bb16 = hp::gmma_desc(big_b + 32 * kCell, lbo, kCell);
  const uint64_t sb = hp::gmma_desc(small_b, lbo, kCell), sb16 = hp::gmma_desc(small_b + 32 * kCell, lbo, kCell);
  t32_mma<NI>(acc, small, bb, bb16, scale);
  t32_mma<NI>(acc, fin, sb, sb16, 1);
  t32_mma<NI>(acc, big, bb, bb16, 1);
}

// One step of the f32 forward: out = A_s @ B_s over a warpgroup's 64 rows,
// ReLU below the top.
struct T32Step {
  int k, n;          // B_s is k x n
  long long b;       // floats: B_s in the prepared weights (tf32_prep_floats(n, k))
};

struct T32Chain {
  T32Step st[kMaxLayers];
  const float* prep;  // the prepared weights
  const float* in;    // x [m][k0], row-major
  float* out;         // y [m][n of the last step], row-major
  long long m;
  int steps, k0;
};

// The producer thread: every step's k8 chunks of B of every tile the CTA
// takes, in the order the consumers use them, one bulk copy a slot.
__device__ __forceinline__ void t32_producer(const T32Chain& a, uint32_t ring, uint32_t bars,
                                             long long tiles) {
  int slot = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int s = 0; s < a.steps; ++s) {
      const T32Step& st = a.st[s];
      const int np = tf32_np(st.n);
      const uint32_t bytes = 64u * np;
      for (int kc = 0; kc < st.k; kc += 8) {
        hp::mbar_wait(bars + 8u * (kT32Stages + slot), phase ^ 1);
        const uint32_t full = bars + 8u * slot;
        hp::mbar_expect_tx(full, bytes);
        hp::bulk_load(ring + slot * kT32SlotBytes, a.prep + st.b + (long long)(kc / 8) * 16 * np,
                      bytes, full);
        if (++slot == kT32Stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
}

// acc = A @ B_s for a consumer warpgroup's block `act` (st.k wide), A's
// fragments loaded from the block and split in registers, B's planes from
// the ring, two k8 steps (two slots) per commit group; the warpgroup waits
// for its products before it splits the next fragments (keep_fragments), while
// the other consumer warpgroup keeps the tensor cores busy. NI:
// wgmma_kind(n).
template <int NI>
__device__ __forceinline__ void t32_chain_mma(Acc& acc, const T32Step& st, const float* act,
                                              uint32_t ring, uint32_t bars, int& slot,
                                              uint32_t& phase) {
  const int tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;
  const bool signal = lane == 0;  // one arrival per warp
  const int kg = st.k >> 3, np = tf32_np(st.n);
  // a[0] at row 16 warp + lane / 4, feature lane % 4 of each k8 group;
  // a[1] 8 rows below (two 4-row groups), a[2] 4 features right
  const float* p = act + fm_off(st.k, 16 * warp + (lane >> 2), lane & 3);
  const int down = 2 * kg * 32;
  acc_fence(acc);
  for (int ks = 0; ks < kg; ks += 2) {  // k is a multiple of 16
    uint32_t a[2][12], b[2];
    int slots[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* q = p + 32 * (ks + j);
      const float v[4] = {q[0], q[down], q[16], q[down + 16]};
      t32_split(v, a[j]);
      hp::mbar_wait(bars + 8u * slot, phase);
      b[j] = ring + slot * kT32SlotBytes;
      slots[j] = slot;
      if (++slot == kT32Stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    hp::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j)  // the first product overwrites acc
      t32_mma3<NI>(acc, a[j], b[j], b[j] + 32u * np, 16u * np, ks + j > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    keep_fragments(a);
    if (signal) {
      hp::mbar_arrive(bars + 8u * (kT32Stages + slots[0]));
      hp::mbar_arrive(bars + 8u * (kT32Stages + slots[1]));
    }
  }
  acc_fence(acc);
}

// A consumer warpgroup: the 64-row block `c` of each tile, every step.
__device__ __forceinline__ void t32_consumer(const T32Chain& a, float* act, uint32_t ring,
                                             uint32_t bars, int c, long long tiles) {
  const int tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;
  const uint32_t bar_id = 1 + c;  // the warpgroup's named barrier
  const uint32_t act_s = hp::smem_u32(act);
  // the thread's accumulators: rows 16 warp + lane / 4 + 8e, columns cq, cq + 1 of each group
  const int rq = lane >> 2, cq = 2 * (lane & 3);
  const int kq = a.k0 / 4;
  int slot = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kTile + c * kBlk;
    // the input block, feature-major: a quad of lanes takes 4 rows of one
    // float4 column
    hp::named_barrier(bar_id, kWgThreads);
    for (int i = tid; i < kBlk * kq; i += kWgThreads) {
      const int rg = i / (4 * kq), rem = i - rg * 4 * kq;
      const int r = 4 * rg + (rem & 3), f = 4 * (rem >> 2);
      const long long row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < a.m) v = __ldg(reinterpret_cast<const float4*>(a.in + row * a.k0 + f));
      float* d = act + fm_off(a.k0, r, f);
      d[0] = v.x;
      d[4] = v.y;
      d[8] = v.z;
      d[12] = v.w;
    }
    hp::named_barrier(bar_id, kWgThreads);
    for (int s = 0; s < a.steps; ++s) {
      const T32Step& st = a.st[s];
      const int groups = st.n / 8;
      Acc acc;
      const int kind = wgmma_kind(st.n);
      if (kind == 2) t32_chain_mma<2>(acc, st, act, ring, bars, slot, phase);
      else if (kind == 1) t32_chain_mma<1>(acc, st, act, ring, bars, slot, phase);
      else t32_chain_mma<0>(acc, st, act, ring, bars, slot, phase);

      // epilogue: ReLU in place over the block (now n wide) once every
      // thread's fragments are loaded, or y from registers; straight-line
      // over all 34 column groups, the accesses predicated
      hp::named_barrier(bar_id, kWgThreads);
      const bool last = s + 1 == a.steps;
#pragma unroll
      for (int gi = 0; gi < kWideMax / 8; ++gi)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 16 * warp + rq + 8 * e, f = 8 * gi + cq;
          const bool in = gi < groups;
          float2 v = acc_pair(acc, gi, e);
          v.x = !last && v.x < 0.f ? 0.f : v.x;
          v.y = !last && v.y < 0.f ? 0.f : v.y;
          const uint32_t o = act_s + 4u * fm_off(st.n, r, f);
          hp::st_shared_if(o, __float_as_uint(v.x), in && !last);
          hp::st_shared_if(o + 16, __float_as_uint(v.y), in && !last);  // feature f + 1
          hp::st_global_v2_if(a.out + (row0 + r) * st.n + f, v, last && in && row0 + r < a.m);
        }
      hp::named_barrier(bar_id, kWgThreads);
    }
  }
}

__global__ void __launch_bounds__(kWsThreads, 1)
fused_mlp_wide_tf32_kernel(const __grid_constant__ T32Chain a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hp::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* base_p = smem_raw + (base - raw);
  const uint32_t ring = base + 2 * kT32ActBytes;
  const uint32_t bars = ring + kT32Stages * kT32SlotBytes;  // full[kT32Stages], empty[kT32Stages]
  const long long tiles = (a.m + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kT32Stages; ++s) {
      hp::mbar_init(bars + 8u * s, 1);
      hp::mbar_init(bars + 8u * (kT32Stages + s), 2 * kWgThreads / 32);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    hp::regs_dec<kRegsProducer>();
    if (threadIdx.x == 0) t32_producer(a, ring, bars, tiles);
  } else {
    hp::regs_inc<kRegsConsumer>();
    t32_consumer(a, reinterpret_cast<float*>(base_p + (wg - 1) * kT32ActBytes), ring, bars,
                 wg - 1, tiles);
  }
}

// One layer of the f32 dW product. Planes are blocked as the chain's; a ring
// slot takes 16 rows (four 4-row groups) of a 64-row block: of g, one
// contiguous piece; of post, the CTA's din slice of each 4-row group.
struct T32DwLayer {
  const float* post;  // [din] plane of post_i (post_0 = x)
  const float* g;     // [dout] plane of g_i
  int din, dout, dw_off;
};

struct T32DwArgs {
  T32DwLayer l[kMaxLayers];
  float* partial;       // [splits][dw_floats]
  long long blocks;     // 64-row blocks to sum over
  long long per_split;  // blocks of one row split (blockIdx.y)
  int dw_floats;
  int slices;           // CTAs of one layer along din (blockIdx.x = layer x slices + slice)
};

// acc (+)= post^T g over one slot's 16 rows (two k8 steps; scale 0: acc =):
// post (A, the warpgroup's 64 din rows, from registers) and g's big and
// small planes (B, K-major cells along the rows)
template <int NI>
__device__ __forceinline__ void t32_dw_slot(Acc& acc, const float* post, uint32_t g, int a_off,
                                            int gout, int scale) {
  constexpr int kPostGroup = (kDwSlice / 8) * 32;  // floats between 4-row groups of post
  constexpr int kSteps = kT32DwRows / 8;
  uint32_t a[kSteps][12];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const float* q = post + a_off + 2 * ks * kPostGroup;
    // a[0] din row lane / 4, row lane % 4; a[1] 8 din rows on; a[2] 4 rows on
    const float v[4] = {q[0], q[32], q[kPostGroup], q[kPostGroup + 32]};
    t32_split(v, a[ks]);
  }
  hp::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const uint32_t b = g + 2 * ks * gout * kCell;
    t32_mma3<NI>(acc, a[ks], b, b + kT32DwPlaneBytes, gout * kCell, ks == 0 ? scale : 1);
  }
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  keep_fragments(a);
}

// out += acc: a warpgroup's 64 din rows (from m0) of its split's partial
// dW, the layer's din x dout at out, by reductions in L2 (red: the thread
// does not wait for them). Each element has this one thread adding to it,
// in program order, so its sum and its bits do not change from run to run.
__device__ __forceinline__ void t32_dw_flush(const Acc& acc, float* out, int m0, int din,
                                             int dout) {
  const int tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int gi = 0; gi < kWideMax / 8; ++gi)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = m0 + r0 + 8 * e, col = 8 * gi + cq;
      if (d < din && col < dout) {
        const float2 v = acc_pair(acc, gi, e);
        asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(out + d * dout + col),
                     "f"(v.x), "f"(v.y)
                     : "memory");
      }
    }
}

// dW_i rows [128 slice, 128 slice + 128) x all columns of one layer, over
// the row split blockIdx.y, 16 rows per ring slot, in sums of kT32DwFlush
// slots added in order to the split's partial (zeroed before the kernel).
// The producer warpgroup's
// first thread issues the copies and its other warps split each slot's g
// into its big (in place) and small planes for the consumers.
__global__ void __launch_bounds__(kWsThreads, 1)
fused_mlp_wide_dw_tf32_kernel(const __grid_constant__ T32DwArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hp::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* base_p = smem_raw + (base - raw);
  // full[kT32DwStages], split[kT32DwStages], empty[kT32DwStages]
  const uint32_t bars = base + kT32DwStages * kT32DwSlotBytes;
  const uint32_t full0 = bars, split0 = bars + 8u * kT32DwStages, empty0 = bars + 16u * kT32DwStages;
  const int rank = int(blockIdx.x) % a.slices;  // the slice
  const T32DwLayer& L = a.l[blockIdx.x / a.slices];
  const int n_active = (L.din + kDwSlice - 1) / kDwSlice;  // slices with rows
  const bool active = rank < n_active;
  constexpr int kParts = kBlk / kT32DwRows;                 // slots of a 64-row block
  const long long h0 = kParts * blockIdx.y * a.per_split;  // the split's slots
  const long long h1 = kParts * min(a.blocks, (blockIdx.y + 1) * a.per_split);
  const int gin = L.din / 8, gout = L.dout / 8;
  const uint32_t g_bytes = kT32DwRows * L.dout * 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kT32DwStages; ++s) {
      hp::mbar_init(full0 + 8u * s, 1);
      hp::mbar_init(split0 + 8u * s, kSplitThreads / 32);
      hp::mbar_init(empty0 + 8u * s, 2 * kWgThreads / 32);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    hp::regs_dec<kRegsProducer>();
    if (!active) return;
    int slot = 0;
    uint32_t phase = 0;
    if (threadIdx.x == 0) {
      const int np = min(kDwSlice / 8, gin - kDwSlice / 8 * rank);  // the CTA's din groups
      for (long long h = h0; h < h1; ++h) {
        hp::mbar_wait(empty0 + 8u * slot, phase ^ 1);
        const uint32_t dst = base + slot * kT32DwSlotBytes, full = full0 + 8u * slot;
        const long long blk = h / kParts;
        const int q0 = (kT32DwRows / 4) * int(h % kParts);
        hp::mbar_expect_tx(full, (kT32DwRows / 4) * np * kCell + g_bytes);
        for (int q = 0; q < kT32DwRows / 4; ++q)
          hp::bulk_load(dst + q * (kDwSlice / 8) * kCell,
                        L.post + blk * kBlk * L.din + ((q0 + q) * gin + kDwSlice / 8 * rank) * 32,
                        np * kCell, full);
        hp::bulk_load(dst + kT32DwPostBytes, L.g + blk * kBlk * L.dout + q0 * gout * 32, g_bytes,
                      full);
        if (++slot == kT32DwStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    } else if (threadIdx.x >= 32) {
      const int st = threadIdx.x - 32;
      for (long long h = h0; h < h1; ++h) {
        hp::mbar_wait(full0 + 8u * slot, phase);
        uint4* gb = reinterpret_cast<uint4*>(base_p + slot * kT32DwSlotBytes + kT32DwPostBytes);
        uint4* gs = reinterpret_cast<uint4*>(base_p + slot * kT32DwSlotBytes + kT32DwPostBytes +
                                             kT32DwPlaneBytes);
        for (int i = st; i < int(g_bytes / 16); i += kSplitThreads) {
          const uint4 v = gb[i];
          uint4 big, small;
          uint32_t fin;
          tf32_split(__uint_as_float(v.x), big.x, small.x, fin);
          tf32_split(__uint_as_float(v.y), big.y, small.y, fin);
          tf32_split(__uint_as_float(v.z), big.z, small.z, fin);
          tf32_split(__uint_as_float(v.w), big.w, small.w, fin);
          gb[i] = big;
          gs[i] = small;
        }
        hp::fence_async_shared();
        __syncwarp();
        if ((threadIdx.x & 31) == 0) hp::mbar_arrive(split0 + 8u * slot);
        if (++slot == kT32DwStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    hp::regs_inc<kRegsConsumer>();
    const int c = wg - 1, tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;
    const int m0 = kDwSlice * rank + kBlk * c;  // the warpgroup's first din row
    const bool computes = active && m0 < L.din;
    const int kind = wgmma_kind(L.dout);
    const bool signal = lane == 0;
    // the thread's a[0]: din row kBlk c + 16 warp + lane / 4 of the slice, row lane % 4
    const int dl = kBlk * c + 16 * warp + (lane >> 2);
    const int a_off = (dl >> 3) * 32 + (dl & 7) * 4 + (lane & 3);
    Acc acc;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc.a[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc.b[i] = 0.f;
    auto release = [&](int s) {
      if (signal) hp::mbar_arrive(empty0 + 8u * s);
    };
    float* out = a.partial + blockIdx.y * (long long)a.dw_floats + L.dw_off;
    if (active) {
      int slot = 0;
      uint32_t phase = 0;
      acc_fence(acc);
      for (long long h = h0; h < h1; ++h) {
        hp::mbar_wait(full0 + 8u * slot, phase);
        hp::mbar_wait(split0 + 8u * slot, phase);
        const long long j = h - h0;  // the slot's place in the split
        if (computes) {
          const float* post = reinterpret_cast<const float*>(base_p + slot * kT32DwSlotBytes);
          const uint32_t g = base + slot * kT32DwSlotBytes + kT32DwPostBytes;
          const int scale = j % kT32DwFlush != 0;  // a sum's first slot starts it
          if (kind == 2) t32_dw_slot<2>(acc, post, g, a_off, gout, scale);
          else if (kind == 1) t32_dw_slot<1>(acc, post, g, a_off, gout, scale);
          else t32_dw_slot<0>(acc, post, g, a_off, gout, scale);
        }
        release(slot);
        if (computes && (j % kT32DwFlush == kT32DwFlush - 1 || h + 1 == h1)) {
          acc_fence(acc);
          t32_dw_flush(acc, out, m0, L.din, L.dout);
          acc_fence(acc);
        }
        if (++slot == kT32DwStages) {
          slot = 0;
          phase ^= 1;
        }
      }
      acc_fence(acc);
    }
  }
}

// The f32 backward's chains on the CUDA cores: the recompute of the
// post-activations (DGRAD 0) and the dgrad (DGRAD 1). chip_smoke.py holds
// dx to a max-abs limit (1e-5 of scale), which one ReLU mask that differs
// from the plain version's fails (it moves a whole term of the gradient).
// So each element sums one fmaf per k in order from k = 0: the order in
// which the H100's f32 GEMM summed OriginNeRF's chain at 131072 and 16384
// rows, where dx read 0 error. That order is the library's choice per
// shape, not a property of these chains: at 1000 rows dx read 3.4e-7 of
// scale (within the limit). 3xTF32 would be further off: its forward
// reads ~3e-6 of the output's scale off the plain version on the H100
// (chip_smoke.py's kernel_wide line), and a recompute that far off flips
// the mask of every pre-activation within it of zero. Two CTAs of 256
// threads per SM walk 64-row blocks (a persistent grid); the block stays
// in shared memory in fm_off's layout (a thread's 4 rows at one feature
// are one float4), and each layer's result replaces it once every thread
// is past the layer's last read. A thread computes 4 rows x 17 columns (cg + 16 j; 4 columns for outputs
// up to 64 wide): per 4 k, four float4 of activations and a float4 of B^T
// per column (staged [n][16 k] by cp.async into a double buffer) feed the
// FMAs. The recompute writes each block to its post plane and each
// thread's 68 bits of post > 0 to a bit plane (fma_bit_words); the dgrad's
// same thread reads them back as its mask, writes g_i to its plane and dx
// from registers.
constexpr int kFmaThreads = 256;
constexpr int kFmaCtasPerSm = 2;
constexpr int kFmaKc = 16;                 // k of one staged chunk of B^T
constexpr int kFmaLd = kFmaKc + 4;         // floats between staged columns (banks spread)
constexpr int kFmaCols = kWideMax / 16;    // 17 columns a thread
constexpr int kFmaBitWords = (4 * kFmaCols + 31) / 32;
constexpr size_t kFmaSmem = (size_t(kBlk) * kWideMax + 2 * size_t(kWideMax) * kFmaLd) * 4;
static_assert(kFmaCtasPerSm * (kFmaSmem + 1024) <= 233472, "two CUDA-core chain CTAs fit an SM");

// words of an f32 bit plane of `blocks` 64-row blocks: [block][word][thread]
__host__ __device__ constexpr long long fma_bit_words(long long blocks) {
  return blocks * kFmaBitWords * kFmaThreads;
}

struct FmaStep {
  const float* bt;  // B^T [n][k], row-major: the recompute's W^T, the dgrad's W
  int k, n;
  uint32_t* bits;   // or null: the recompute writes post > 0, the dgrad reads its mask
  float* plane;     // or null: the result block to an [n] plane
};

struct FmaChain {
  FmaStep st[kMaxLayers];
  const float* in;  // the input [m][k0], row-major
  float* in_copy;   // or null: the input block to a [k0] plane
  float* out;       // or null: the last step's result [m][n], row-major
  long long m;
  int steps, k0;
};

// acc[i][j] += act rows 4 rg + i, B^T column cg + 16 j, over k of one
// staged chunk, k ascending for every element
template <int COLS>
__device__ __forceinline__ void fma_chunk(float (&acc)[4][kFmaCols], const float* act, int K,
                                          int k0, const float* ws, int rg, int cg) {
#pragma unroll 1
  for (int k4 = 0; k4 < kFmaKc; k4 += 4) {
    float4 a[4];  // rows 4 rg.. at k0 + k4 + u
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a[u] = *reinterpret_cast<const float4*>(act + fm_off(K, 4 * rg, k0 + k4 + u));
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(ws + (cg + 16 * j) * kFmaLd + k4);
      const float wk[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[0][j] = fmaf(a[u].x, wk[u], acc[0][j]);
        acc[1][j] = fmaf(a[u].y, wk[u], acc[1][j]);
        acc[2][j] = fmaf(a[u].z, wk[u], acc[2][j]);
        acc[3][j] = fmaf(a[u].w, wk[u], acc[3][j]);
      }
    }
  }
}

template <int DGRAD>
__global__ void __launch_bounds__(kFmaThreads, kFmaCtasPerSm)
fused_mlp_wide_fma_kernel(const __grid_constant__ FmaChain c) {
  extern __shared__ __align__(16) float fx[];
  float* act = fx;                      // the block, [k or n] wide, fm_off
  float* wst = fx + kBlk * kWideMax;    // [2][kWideMax][kFmaLd]
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = c.k0;
  const long long blocks = (c.m + kBlk - 1) / kBlk;
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long row0 = blk * kBlk;
    __syncthreads();  // the previous block's copies have read the block
    for (int i = tid; i < kBlk * k0 / 4; i += kFmaThreads) {
      const int r = i / (k0 / 4), f = 4 * (i % (k0 / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < c.m) v = __ldg(reinterpret_cast<const float4*>(c.in + (row0 + r) * k0 + f));
      float* d = act + fm_off(k0, r, f);
      d[0] = v.x;
      d[4] = v.y;
      d[8] = v.z;
      d[12] = v.w;
    }
    __syncthreads();
    if (c.in_copy)
      for (int i = tid; i < kBlk * k0 / 4; i += kFmaThreads)
        reinterpret_cast<float4*>(c.in_copy + blk * kBlk * k0)[i] =
            reinterpret_cast<const float4*>(act)[i];
    for (int s = 0; s < c.steps; ++s) {
      const FmaStep& st = c.st[s];
      const int K = st.k, N = st.n;
      uint32_t mask[kFmaBitWords];
#pragma unroll
      for (int w = 0; w < kFmaBitWords; ++w)
        mask[w] = DGRAD && st.bits ? st.bits[fma_bit_words(blk) + w * kFmaThreads + tid] : ~0u;
      auto stage = [&](int kc, int b) {  // B^T [n][kc, kc + 16) -> stage b
        for (int i = tid; i < N * (kFmaKc / 4); i += kFmaThreads) {
          const int n = i >> 2, q = i & 3;
          cp_async16(smem_addr(wst + (b * kWideMax + n) * kFmaLd + 4 * q),
                     st.bt + (long long)n * K + kc + 4 * q, 16);
        }
        cp_async_commit();
      };
      float acc[4][kFmaCols];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kFmaCols; ++j) acc[i][j] = 0.f;
      stage(0, 0);
      for (int kc = 0, b = 0; kc < K; kc += kFmaKc, b ^= 1) {
        if (kc + kFmaKc < K) stage(kc + kFmaKc, b ^ 1);
        else cp_async_commit();
        cp_async_wait_1();
        __syncthreads();
        const float* ws = wst + b * kWideMax * kFmaLd;
        if (N <= 64) fma_chunk<4>(acc, act, K, kc, ws, rg, cg);
        else fma_chunk<kFmaCols>(acc, act, K, kc, ws, rg, cg);
        __syncthreads();  // the stage is free, and after the last chunk the block
      }
      const bool to_out = c.out != nullptr && s + 1 == c.steps;
      uint32_t bw[kFmaBitWords] = {};
#pragma unroll
      for (int j = 0; j < kFmaCols; ++j) {
        const int col = cg + 16 * j;
        if (col >= N) continue;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bit = 4 * j + i;
          if (DGRAD) {  // times the mask: a product, so a non-finite value stays non-finite
            v[i] = acc[i][j] * ((mask[bit >> 5] >> (bit & 31)) & 1u ? 1.f : 0.f);
          } else {
            v[i] = relu(acc[i][j]);
            bw[bit >> 5] |= uint32_t(v[i] > 0.f) << (bit & 31);
          }
          if (to_out && row0 + 4 * rg + i < c.m) c.out[(row0 + 4 * rg + i) * N + col] = v[i];
        }
        *reinterpret_cast<float4*>(act + fm_off(N, 4 * rg, col)) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      if (!DGRAD && st.bits)
#pragma unroll
        for (int w = 0; w < kFmaBitWords; ++w)
          st.bits[fma_bit_words(blk) + w * kFmaThreads + tid] = bw[w];
      __syncthreads();
      if (st.plane)
        for (int i = tid; i < kBlk * N / 4; i += kFmaThreads)
          reinterpret_cast<float4*>(st.plane + blk * kBlk * N)[i] =
              reinterpret_cast<const float4*>(act)[i];
    }
  }
  cp_async_wait_0();
}

// W_i^T of the layers below the top ([dout][din], row-major) for the
// recompute's B^T, at off[i] floats into out
struct FmaTranspose {
  const float* w[kMaxLayers];
  int din[kMaxLayers], dout[kMaxLayers];
  long long off[kMaxLayers];
};

__global__ void __launch_bounds__(256)
fused_mlp_wide_transpose_kernel(const __grid_constant__ FmaTranspose t, float* __restrict__ out) {
  const int l = blockIdx.y, din = t.din[l], dout = t.dout[l];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < din * dout; i += gridDim.x * blockDim.x) {
    const int n = i / din, k = i - n * din;  // out [n][k] = W [k][n]
    out[t.off[l] + i] = t.w[l][k * dout + n];
  }
}

bool wide_widths_ok(const int* widths, int n_layers) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int i = 0; i <= n_layers; ++i)
    if (widths[i] <= 0 || widths[i] % 16 != 0 || widths[i] > kWideMax) return false;
  return true;
}

// The dW kernel's `splits` row splits of `per_split` 64-row blocks cover m
// rows, and none is empty
bool splits_ok(long long m, int splits, long long per_split) {
  const long long blocks = (m + kBlk - 1) / kBlk;
  return (long long)splits * per_split >= blocks && (long long)(splits - 1) * per_split < blocks;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map of `rank` dimensions (innermost first; strides in bytes
// of dimensions 1..) with boxes of `box`; returns 0, or -4 when
// cuTensorMapEncodeTiled refuses it
int map_bf16(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
             const long long* strides, const int* box, bool swizzle128) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return -4;
  cuuint64_t d[3], st[2];
  cuuint32_t b[3], elem[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = cuuint64_t(dims[i]);
    b[i] = cuuint32_t(box[i]);
    if (i + 1 < rank) st[i] = cuuint64_t(strides[i]);
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, st,
                        b, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}

// a row-major [rows][cols] matrix in boxes of box_cols x box_rows
int map_matrix(CUtensorMap* map, const void* ptr, long long cols, long long rows, int box_cols,
               int box_rows, bool swizzle128) {
  const long long dims[2] = {cols, rows}, strides[1] = {cols * 2};
  const int box[2] = {box_cols, box_rows};
  return map_bf16(map, ptr, 2, dims, strides, box, swizzle128);
}

// a row-major [rows][cols] matrix as (8 columns, rows, cols/8 groups), in
// boxes of 8 rows x all groups: one box is one 8-row group of a block
int map_rows(CUtensorMap* map, const void* ptr, long long cols, long long rows) {
  const long long dims[3] = {8, rows, cols / 8}, strides[2] = {cols * 2, 16};
  const int box[3] = {8, 8, int(cols / 8)};
  return map_bf16(map, ptr, 3, dims, strides, box, false);
}

// W_i [din][dout] as a chain step reads it: W [k][n] in 64 x 64 boxes, or
// W [n][k] (the dgrad) in boxes of 64 k x 136 n
int map_weight(CUtensorMap* map, const void* w, int din, int dout, bool kmajor) {
  return map_matrix(map, w, dout, din, kmajor ? 64 : kBoxN, kmajor ? kKBoxRows : kChunkK, true);
}

int launch_chain_bf16(const ChainArgs& a, int kind, int ctas, cudaStream_t s) {
  if (kind == 0)
    fused_mlp_wide_bf16_kernel<0><<<ctas, kWsThreads, kChainSmem, s>>>(a);
  else if (kind == 1)
    fused_mlp_wide_bf16_kernel<1><<<ctas, kWsThreads, kChainSmem, s>>>(a);
  else
    fused_mlp_wide_bf16_kernel<2><<<ctas, kWsThreads, kChainSmem, s>>>(a);
  return int(cudaGetLastError());
}

// Splits every layer's weights into `prep` (prep_floats floats) as the f32
// forward reads them and fills p's offsets. Returns 0, a cudaError_t code,
// or -1 when prep is too small.
int launch_prep_tf32(const void* const* weights, const int* widths, int n, float* prep,
                     long long prep_floats, T32Prep* p, cudaStream_t s) {
  long long off = 0;
  for (int i = 0; i < n; ++i) {
    p->w[i] = static_cast<const float*>(weights[i]);
    p->din[i] = widths[i];
    p->dout[i] = widths[i + 1];
    p->off[i] = off;
    off += tf32_prep_floats(widths[i + 1], widths[i]);
  }
  if (!prep || off > prep_floats) return -1;
  fused_mlp_wide_tf32_prep_kernel<<<dim3(64, n), 256, 0, s>>>(*p, prep);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// host side

int make_net(const void* const* weights, const int* widths, int n_layers, Net* net) {

  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  int max_g = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] <= 0 || widths[i] % 16 != 0 || widths[i] > kMaxWidth) return -1;
    net->width[i] = widths[i];
    if (i > 0 && widths[i] > max_g) max_g = widths[i];
  }
  int w_off = 0, dw_off = 0, post = 0, tiles = 0;
  for (int i = 0; i < n_layers; ++i) {
    const int din = widths[i], dout = widths[i + 1];
    net->w[i] = weights ? weights[i] : nullptr;
    net->w_off[i] = w_off;
    w_off += din * (dout + kPad);
    net->dw_off[i] = dw_off;
    dw_off += din * dout;
    net->post_off[i] = post;
    post += kBwdRows * (din + kPad);
    net->tile_off[i] = tiles;
    tiles += (din / 16) * (dout / 8);
  }
  net->tile_off[n_layers] = tiles;
  net->n_layers = n_layers;
  net->w_elems = w_off;
  net->dw_floats = dw_off;
  net->post_elems = post;
  net->g_ld = max_g + kPad;
  net->io_ld = (widths[0] > widths[n_layers] ? widths[0] : widths[n_layers]) + kPad;
  return 0;
}

// the kernel, its threads, dynamic shared memory and rows per CTA step
struct Launch {
  const void* kernel;
  int threads;
  size_t smem;
  int rows;
};

Launch launch_of(const Net& net, int dtype, int backward) {
  if (dtype == 0)
    return backward ? Launch{(const void*)fused_mlp_bwd_f32_kernel, kF32Threads,
                             bwd_f32_smem(net), kF32BwdRows}
                    : Launch{(const void*)fused_mlp_fwd_f32_kernel, kF32Threads,
                             fwd_f32_smem(net), kF32FwdRows};
  return backward ? Launch{(const void*)fused_mlp_bwd_bf16_kernel, kBwdWarps * 32,
                           bwd_bf16_smem(net), kBwdRows}
                  : Launch{(const void*)fused_mlp_fwd_bf16_kernel, kFwdWarps * 32,
                           fwd_bf16_smem(net), kFwdWarps * kChunkRows};
}

}  // namespace

// The launch plan of one kernel for a layer chain: *ctas, the persistent grid
// (SMs x the CTAs that fit on one), and *tile_rows, the rows a CTA takes per
// step; a call launches min(*ctas, ceil(m / *tile_rows)) CTAs. Also lifts the
// kernel's dynamic shared-memory limit to the device's maximum. dtype: 0 =
// float32, 1 = bfloat16; backward: 0 or 1. Returns 0, a cudaError_t code, -1
// for arguments the kernels do not take, or -2 when the chain needs more
// shared memory than a CTA can have.
extern "C" int fused_mlp_plan(const int* widths, int n_layers, int dtype, int backward,
                              int* ctas, int* tile_rows) {
  Net net;
  if ((dtype != 0 && dtype != 1) || make_net(nullptr, widths, n_layers, &net) != 0) return -1;
  const Launch plan = launch_of(net, dtype, backward);
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return int(err);
  if (plan.smem > size_t(max_smem)) return -2;
  if ((err = cudaFuncSetAttribute(plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_smem)) != cudaSuccess)
    return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan.kernel, plan.threads,
                                                           plan.smem)) != cudaSuccess)
    return int(err);
  *ctas = sms * (per_sm > 0 ? per_sm : 1);
  *tile_rows = plan.rows;
  return 0;
}

// Forward over m rows with `ctas` CTAs (from fused_mlp_plan). x is [m,
// widths[0]], y is [m, widths[n_layers]], weights[i] is [widths[i],
// widths[i+1]] row-major, all in the dtype and 16-byte aligned. Returns 0, a
// cudaError_t code, or -1 for arguments the kernel does not take.
extern "C" int fused_mlp_fwd(const void* x, void* y, const void* const* weights,
                             const int* widths, int n_layers, long long m, int dtype, int ctas,
                             void* stream) {
  Net net;
  if (m < 0 || ctas < 1 || make_net(weights, widths, n_layers, &net) != 0) return -1;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    fused_mlp_fwd_f32_kernel<<<ctas, kF32Threads, fwd_f32_smem(net), s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), net, m);
  else if (dtype == 1)
    fused_mlp_fwd_bf16_kernel<<<ctas, kFwdWarps * 32, fwd_bf16_smem(net), s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), net, m);
  else
    return -1;
  return int(cudaGetLastError());
}

// Backward of fused_mlp_fwd for m >= 1 rows, with `ctas` CTAs (from
// fused_mlp_plan). g is dL/dy [m, widths[n_layers]] in the dtype; dx [m,
// widths[0]] may be null (not wanted); dw receives every layer's dW,
// concatenated row-major in layer order, in the dtype; partial is a [ctas,
// sum_i widths[i]*widths[i+1]] f32 workspace. Returns as fused_mlp_fwd.
extern "C" int fused_mlp_bwd(const void* x, const void* g, void* dx, void* dw, float* partial,
                             int ctas, const void* const* weights, const int* widths,
                             int n_layers, long long m, int dtype, void* stream) {
  Net net;
  if (m < 1 || ctas < 1 || make_net(weights, widths, n_layers, &net) != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const dim3 threads(kReduceCols, kReduceRows);
  const int blocks = (net.dw_floats + kReduceCols - 1) / kReduceCols;
  if (dtype == 0) {
    fused_mlp_bwd_f32_kernel<<<ctas, kF32Threads, bwd_f32_smem(net), s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dx),
        partial, net, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    fused_mlp_bwd_reduce_kernel<float><<<blocks, threads, 0, s>>>(partial, ctas, net.dw_floats,
                                                                  static_cast<float*>(dw));
  } else if (dtype == 1) {
    // a pass per kDwTilesPerPass dW tiles (one pass for up to 64, e.g. both
    // NGP MLPs); only the first writes dx
    for (int t0 = 0; t0 < net.tile_off[n_layers]; t0 += kDwTilesPerPass) {
      fused_mlp_bwd_bf16_kernel<<<ctas, kBwdWarps * 32, bwd_bf16_smem(net), s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(g),
          t0 == 0 ? static_cast<bf16*>(dx) : nullptr, partial, net, m, t0);
      if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    }
    fused_mlp_bwd_reduce_kernel<bf16><<<blocks, threads, 0, s>>>(partial, ctas, net.dw_floats,
                                                                 static_cast<bf16*>(dw));
  } else {
    return -1;
  }
  return int(cudaGetLastError());
}


// Lifts the dynamic shared-memory limit of the wide kernels on the current
// device; call once per device before fused_mlp_wide_fwd / _bwd_*. Returns
// 0, a cudaError_t code, or -2 when the device has too little shared memory.
extern "C" int fused_mlp_wide_init() {
  int dev = 0, max_smem = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return int(err);
  if (kChainSmem > size_t(max_smem) || kDwSmem > size_t(max_smem) ||
      kT32ChainSmem > size_t(max_smem) || kT32DwSmem > size_t(max_smem) ||
      kFmaSmem > size_t(max_smem))
    return -2;
  if ((err = cudaFuncSetAttribute(fused_mlp_wide_bf16_kernel<0>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kChainSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_bf16_kernel<1>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kChainSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_bf16_kernel<2>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kChainSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_dw_bf16_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(kDwSmem))) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_tf32_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kT32ChainSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_fma_kernel<0>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kFmaSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_fma_kernel<1>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kFmaSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_fma_kernel<0>,
                                  cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_fma_kernel<1>,
                                  cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_mlp_wide_dw_tf32_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kT32DwSmem))) != cudaSuccess)
    return int(err);
  return 0;
}

// Forward of a wide chain (widths multiples of 16 up to 272, at most 8
// layers) over m rows, as fused_mlp_fwd, with `ctas` CTAs (the wrapper's
// plan: at most one per SM). f32 splits the weights first into prep
// (prep_floats floats: the wrapper's plan); bf16 takes no prep (null).
// Tensors are 16-byte aligned. Returns 0, a cudaError_t code, -1 for
// arguments the kernels do not take, or -4 when a tensor map is refused.
extern "C" int fused_mlp_wide_fwd(const void* x, void* y, const void* const* weights,
                                  const int* widths, int n_layers, long long m, int dtype,
                                  int ctas, float* prep, long long prep_floats, void* stream) {
  if (m < 0 || ctas < 1 || (dtype != 0 && dtype != 1) || !wide_widths_ok(widths, n_layers))
    return -1;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = n_layers;
  if (dtype == 0) {
    T32Prep p = {};
    int err;
    if ((err = launch_prep_tf32(weights, widths, n, prep, prep_floats, &p, s)) != 0) return err;
    T32Chain c = {};
    c.prep = prep;
    c.in = static_cast<const float*>(x);
    c.out = static_cast<float*>(y);
    c.m = m;
    c.k0 = widths[0];
    c.steps = n;
    for (int i = 0; i < n; ++i) c.st[i] = T32Step{widths[i], widths[i + 1], p.off[i]};
    fused_mlp_wide_tf32_kernel<<<ctas, kWsThreads, kT32ChainSmem, s>>>(c);
    return int(cudaGetLastError());
  }
  ChainArgs a = {};
  a.m = m;
  a.k0 = widths[0];
  a.steps = n;
  a.has_out = 1;
  int err;
  for (int i = 0; i < n; ++i) {
    if ((err = map_weight(&a.w[i], weights[i], widths[i], widths[i + 1], false)) != 0) return err;
    a.st[i] = ChainStep{widths[i], widths[i + 1], i + 1 < n, nullptr, nullptr, nullptr};
  }
  if ((err = map_rows(&a.in, x, widths[0], m)) != 0 ||
      (err = map_rows(&a.out, y, widths[n], m)) != 0)
    return err;
  return launch_chain_bf16(a, 0, ctas, s);
}

// f32 backward of fused_mlp_wide_fwd for m >= 1 rows: the recompute and
// the dgrad chains on the CUDA cores (each with `ctas` CTAs; the recompute
// reads W^T, which it writes into prep first), the dW kernel over `splits`
// row splits of `per_split` 64-row blocks and `slices` CTAs of 128 din rows
// per layer, and the sum of the splits. g, dx (may be null: not wanted) and
// dw as fused_mlp_bwd. planes holds 3 n pointers into the scratch, planes
// of ceil(m / 128) * 128 rows in 64-row blocks (fm_off): post_0..post_{n-1}
// (widths[i] wide), g of layers 0..n-1 (widths[i+1] wide; the top one a
// copy of g), and the bit planes of post_1..post_{n-1} (fma_bit_words; the
// first entry is unused), each of bit_words words. partial is
// [splits][sum_i widths[i]*widths[i+1]] floats; every split holds rows.
// Returns as fused_mlp_wide_fwd.
extern "C" int fused_mlp_wide_bwd_f32(const void* x, const void* g, void* dx, void* dw,
                                      const void* const* weights, const int* widths,
                                      int n_layers, long long m, void* const* planes,
                                      long long bit_words, float* prep,
                                      long long prep_floats, float* partial, int splits,
                                      long long per_split, int slices, int ctas,
                                      void* stream) {
  const int n = n_layers;
  if (m < 1 || splits < 1 || per_split < 1 || ctas < 1 || slices < 1 ||
      !wide_widths_ok(widths, n) || !splits_ok(m, splits, per_split) ||
      bit_words < fma_bit_words(2 * ((m + kTile - 1) / kTile)))
    return -1;
  for (int i = 0; i < n; ++i)
    if ((widths[i] + kDwSlice - 1) / kDwSlice > slices) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const* post = reinterpret_cast<float* const*>(planes);
  float* const* gp = post + n;
  uint32_t* const* bits = reinterpret_cast<uint32_t* const*>(planes + 2 * n);
  int err;
  {  // post_0 = x and post_1 .. post_{n-1}: the forward's hidden layers again
    FmaTranspose t = {};
    FmaChain c = {};
    long long off = 0;
    for (int l = 0; l + 1 < n; ++l) {
      t.w[l] = static_cast<const float*>(weights[l]);
      t.din[l] = widths[l];
      t.dout[l] = widths[l + 1];
      t.off[l] = off;
      c.st[l] = FmaStep{prep + off, widths[l], widths[l + 1], bits[l + 1], post[l + 1]};
      off += (long long)widths[l] * widths[l + 1];
    }
    if (!prep || off > prep_floats) return -1;
    if (n > 1) {
      fused_mlp_wide_transpose_kernel<<<dim3(64, n - 1), 256, 0, s>>>(t, prep);
      if ((err = int(cudaGetLastError())) != 0) return err;
    }
    c.in = static_cast<const float*>(x);
    c.in_copy = post[0];
    c.m = m;
    c.k0 = widths[0];
    c.steps = n - 1;
    fused_mlp_wide_fma_kernel<0><<<kFmaCtasPerSm * ctas, kFmaThreads, kFmaSmem, s>>>(c);
    if ((err = int(cudaGetLastError())) != 0) return err;
  }
  {  // from the top, g_{n-1} = g and g_{i-1} = g_i @ W_i^T masked by post_i > 0; then dx
    FmaChain c = {};
    c.in = static_cast<const float*>(g);
    c.in_copy = gp[n - 1];
    c.out = static_cast<float*>(dx);
    c.m = m;
    c.k0 = widths[n];
    c.steps = dx ? n : n - 1;
    for (int st = 0; st < c.steps; ++st) {
      const int i = n - 1 - st;
      c.st[st] = FmaStep{static_cast<const float*>(weights[i]), widths[i + 1], widths[i],
                         i > 0 ? bits[i] : nullptr, i > 0 ? gp[i - 1] : nullptr};
    }
    fused_mlp_wide_fma_kernel<1><<<kFmaCtasPerSm * ctas, kFmaThreads, kFmaSmem, s>>>(c);
    if ((err = int(cudaGetLastError())) != 0) return err;
  }
  T32DwArgs d = {};
  int off = 0;
  for (int i = 0; i < n; ++i) {
    d.l[i] = T32DwLayer{post[i], gp[i], widths[i], widths[i + 1], off};
    off += widths[i] * widths[i + 1];
  }
  d.partial = partial;
  d.blocks = (m + kBlk - 1) / kBlk;
  d.per_split = per_split;
  d.dw_floats = off;
  d.slices = slices;
  if ((err = int(cudaMemsetAsync(partial, 0, sizeof(float) * size_t(splits) * off, s))) != 0)
    return err;
  fused_mlp_wide_dw_tf32_kernel<<<dim3(slices * n, splits), kWsThreads, kT32DwSmem, s>>>(d);
  if ((err = int(cudaGetLastError())) != 0) return err;
  const dim3 threads(kReduceCols, kReduceRows);
  fused_mlp_bwd_reduce_kernel<float><<<(off + kReduceCols - 1) / kReduceCols, threads, 0, s>>>(
      partial, splits, off, static_cast<float*>(dw));
  return int(cudaGetLastError());
}

// bf16 backward of fused_mlp_wide_fwd for m >= 1 rows: the recompute chain,
// the dgrad chain (each with `ctas` CTAs), the dW kernel over `splits` row
// splits of `per_split` 64-row blocks, `slices` CTAs of 128 din rows per
// layer, and the sum of the splits. g, dx (may be null: not wanted) and dw as
// fused_mlp_bwd. planes holds 4 n pointers into the scratch, planes of
// ceil(m / 128) * 128 rows in blocks of 64: post_0..post_{n-1} (widths[i]
// wide), g_hi of layers 0..n-1, g_lo of layers 0..n-2 (widths[i+1] wide; the
// last entry is unused), each [64-row block][8-row group][width/8][8][8], and
// the bit planes of post_1..post_{n-1} (bit_plane_words; the first entry is
// unused), each of bit_words words. partial is [splits][sum_i
// widths[i]*widths[i+1]] floats; every split holds rows. Returns as
// fused_mlp_wide_fwd.
extern "C" int fused_mlp_wide_bwd_bf16(const void* x, const void* g, void* dx, void* dw,
                                       const void* const* weights, const int* widths,
                                       int n_layers, long long m, void* const* planes,
                                       long long bit_words, float* partial, int splits,
                                       long long per_split, int slices, int ctas,
                                       void* stream) {
  const int n = n_layers;
  if (m < 1 || splits < 1 || per_split < 1 || ctas < 1 || slices < 1 ||
      !wide_widths_ok(widths, n) || !splits_ok(m, splits, per_split) ||
      bit_words < bit_plane_words(2 * ((m + kTile - 1) / kTile)))
    return -1;
  for (int i = 0; i < n; ++i)
    if ((widths[i] + kDwSlice - 1) / kDwSlice > slices) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* const* post = reinterpret_cast<bf16* const*>(planes);
  bf16* const* hi = post + n;
  bf16* const* lo = post + 2 * n;
  uint32_t* const* bits = reinterpret_cast<uint32_t* const*>(planes + 3 * n);
  int err;
  {  // post_0 = x and post_1 .. post_{n-1}: the forward's hidden layers again
    ChainArgs a = {};
    a.m = m;
    a.k0 = widths[0];
    a.steps = n - 1;
    a.in_copy = post[0];
    for (int l = 0; l + 1 < n; ++l) {
      if ((err = map_weight(&a.w[l], weights[l], widths[l], widths[l + 1], false)) != 0)
        return err;
      a.st[l] = ChainStep{widths[l], widths[l + 1], 1, bits[l + 1], post[l + 1], nullptr};
    }
    if ((err = map_rows(&a.in, x, widths[0], m)) != 0) return err;
    if ((err = launch_chain_bf16(a, 2, ctas, s)) != 0) return err;
  }
  {  // from the top, g_hi_{n-1} = g and g_{i-1} = g_hi_i @ W_i^T masked by
     // post_i > 0, split into g_hi_{i-1} and g_lo_{i-1}; then dx
    ChainArgs a = {};
    a.m = m;
    a.k0 = widths[n];
    a.steps = dx ? n : n - 1;
    a.in_copy = hi[n - 1];
    for (int st = 0; st < a.steps; ++st) {
      const int i = n - 1 - st;
      if ((err = map_weight(&a.w[st], weights[i], widths[i], widths[i + 1], true)) != 0) return err;
      a.st[st] = i > 0 ? ChainStep{widths[i + 1], widths[i], 0, bits[i], hi[i - 1], lo[i - 1]}
                       : ChainStep{widths[1], widths[0], 0, nullptr, nullptr, nullptr};
    }
    if ((err = map_rows(&a.in, g, widths[n], m)) != 0) return err;
    if (dx) {
      a.has_out = 1;
      if ((err = map_rows(&a.out, dx, widths[0], m)) != 0) return err;
    }
    if ((err = launch_chain_bf16(a, 1, ctas, s)) != 0) return err;
  }
  DwArgs d = {};
  int off = 0;
  for (int i = 0; i < n; ++i) {
    d.l[i] = DwLayer{post[i], hi[i], i + 1 < n ? lo[i] : nullptr, widths[i], widths[i + 1], off};
    off += widths[i] * widths[i + 1];
  }
  d.partial = partial;
  d.blocks = (m + kBlk - 1) / kBlk;
  d.per_split = per_split;
  d.dw_floats = off;
  d.slices = slices;
  fused_mlp_wide_dw_bf16_kernel<<<dim3(slices * n, splits), kWsThreads, kDwSmem, s>>>(d);
  if ((err = int(cudaGetLastError())) != 0) return err;
  const dim3 threads(kReduceCols, kReduceRows);
  fused_mlp_bwd_reduce_kernel<bf16><<<(off + kReduceCols - 1) / kReduceCols, threads, 0, s>>>(
      partial, splits, off, static_cast<bf16*>(dw));
  return int(cudaGetLastError());
}
