// Fused bias-free MLP for Hopper (sm_90a): y = Wn(...relu(W1 relu(W0 x))...),
// forward and backward, in bf16 on the tensor cores and in f32 on the CUDA
// cores.
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
// TFLOP/s). In f32 there are no tensor cores that keep f32 (TF32 keeps 10
// mantissa bits), and 67 TFLOP/s of FMA bound it instead (24-160 us).
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
// f32 design (CUDA cores, register blocking): activations in shared memory,
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
// in bf16 on wgmma with TMA (hopper.cuh).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see ops/cuda/_build.py). Plain C entry
// points, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// each way at 131072 rows in bf16, about 1 ms at 3.35 TB/s.
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
// f32 design (CUDA cores): 64-row tiles of k-major activations, 4x4
// register micro-tiles, weights read through the cache and W^T from the
// wrapper; the backward's scratch in f32 (post_i, the masked g_i), and a
// tiled dW_i = post_i^T g_i of 64 x 64 tiles.

constexpr int kWideMax = 272;                 // widest layer the wide kernels take
constexpr int kWideF32Rows = 64;              // f32 rows of a CTA's tile
constexpr int kWideF32Ld = kWideF32Rows + 4;  // k-major row stride
constexpr int kWideF32Threads = 256;
constexpr int kDwF32Tile = 64;                // f32 dW tile of one CTA
constexpr int kDwF32Rows = 32;
constexpr int kDwF32Ld = kDwF32Tile + 4;

constexpr size_t kWideF32Smem = 2 * size_t(kWideMax) * kWideF32Ld * sizeof(float);

// f32: a chain of `steps` products over the rows: out_s = epilogue(in_s @
// B_s), in_0 the kernel's input, in_{s+1} = out_s.
struct WideChain {
  const void* w[kMaxLayers];     // B_s [k[s]][n[s]], row-major
  int k[kMaxLayers];
  int n[kMaxLayers];
  int steps;
  unsigned relu;                 // bit s: ReLU on out_s
  const void* mask[kMaxLayers];  // or null: out_s times (mask > 0), mask [m][n[s]]
  float* gout[kMaxLayers];       // or null: out_s [m][n[s]]
  void* dst[kMaxLayers];         // or null: out_s [m][n[s]]
};

__global__ void __launch_bounds__(kWideF32Threads, 1)
fused_mlp_wide_f32_kernel(const float* __restrict__ in, WideChain c, long long m) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int kLd = kWideF32Ld;
  constexpr int kGroups = kWideF32Rows / 4;
  float* hin = fsm;                     // k-major [kWideMax][kLd]
  float* hout = fsm + kWideMax * kLd;
  const long long row0 = (long long)blockIdx.x * kWideF32Rows;
  load_tile_f32_t(hin, kLd, in, c.k[0], kWideF32Rows, row0, m);
  __syncthreads();
  for (int s = 0; s < c.steps; ++s) {
    const int K = c.k[s], N = c.n[s];
    const float* w = static_cast<const float*>(c.w[s]);
    const bool relu_s = (c.relu >> s) & 1u;
    const float* mk = static_cast<const float*>(c.mask[s]);
    float* go = c.gout[s];
    float* d = static_cast<float*>(c.dst[s]);
    for (int it = threadIdx.x; it < kGroups * (N / 4); it += kWideF32Threads) {
      const int r = 4 * (it % kGroups), col = 4 * (it / kGroups);
      float o[4][4];
      micro_fwd(o, hin, kLd, w, N, K, r, col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (relu_s)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = relu(o[i][j]);
        const long long row = row0 + r + i;
        if (row < m) {
          if (mk) {
            const float4 p = *reinterpret_cast<const float4*>(mk + row * N + col);
            o[i][0] *= p.x > 0.f ? 1.f : 0.f;
            o[i][1] *= p.y > 0.f ? 1.f : 0.f;
            o[i][2] *= p.z > 0.f ? 1.f : 0.f;
            o[i][3] *= p.w > 0.f ? 1.f : 0.f;
          }
          const float4 v = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
          if (go) *reinterpret_cast<float4*>(go + row * N + col) = v;
          if (d) *reinterpret_cast<float4*>(d + row * N + col) = v;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(hout + (col + j) * kLd + r) =
            make_float4(o[0][j], o[1][j], o[2][j], o[3][j]);
    }
    __syncthreads();
    float* tmp = hin;
    hin = hout;
    hout = tmp;
  }
}

// f32: dW_i = post_i^T g_i of every layer, one 64 x 64 block of one layer
// per CTA (blockIdx.x over all layers' tiles) and one row split per
// blockIdx.y, into partial[split][the concatenated dW].
struct WideDw {
  const void* post[kMaxLayers];  // post_i [m][width[i]] (post_0 = x)
  const void* g[kMaxLayers];     // g_i [m][width[i+1]]
  int width[kMaxLayers + 1];
  int n_layers;
  int dw_off[kMaxLayers];
  int dw_floats;
  int tile_off[kMaxLayers + 1];
  long long rows_per_split;
};

struct DwTile {
  int l, din, dout, k0, c0;
  long long rbeg, rend;
};

__device__ __forceinline__ DwTile dw_tile(const WideDw& d, long long m) {
  DwTile tl;
  tl.l = 0;
  while (int(blockIdx.x) >= d.tile_off[tl.l + 1]) ++tl.l;
  tl.din = d.width[tl.l];
  tl.dout = d.width[tl.l + 1];
  const int tn = (tl.dout + kDwF32Tile - 1) / kDwF32Tile;
  const int lt = blockIdx.x - d.tile_off[tl.l];
  tl.k0 = kDwF32Tile * (lt / tn);
  tl.c0 = kDwF32Tile * (lt % tn);
  tl.rbeg = blockIdx.y * d.rows_per_split;
  tl.rend = min(m, tl.rbeg + d.rows_per_split);
  return tl;
}

__global__ void __launch_bounds__(256)
fused_mlp_wide_dw_f32_kernel(WideDw d, long long m, float* __restrict__ partial) {
  __shared__ __align__(16) float ps[kDwF32Rows * kDwF32Ld];
  __shared__ __align__(16) float gs[kDwF32Rows * kDwF32Ld];
  const DwTile tl = dw_tile(d, m);
  const float* P = static_cast<const float*>(d.post[tl.l]);
  const float* G = static_cast<const float*>(d.g[tl.l]);
  const int kk = 4 * (threadIdx.x >> 4), cc = 4 * (threadIdx.x & 15);  // a 4 x 4 of the tile
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;

  for (long long rc = tl.rbeg; rc < tl.rend; rc += kDwF32Rows) {
    for (int i = threadIdx.x; i < kDwF32Rows * (kDwF32Tile / 4); i += 256) {
      const int r = i / (kDwF32Tile / 4), j = i % (kDwF32Tile / 4);
      const long long row = rc + r;
      const int kc = tl.k0 + 4 * j, gc = tl.c0 + 4 * j;
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f), v = p;
      if (row < tl.rend && kc < tl.din) p = *reinterpret_cast<const float4*>(P + row * tl.din + kc);
      if (row < tl.rend && gc < tl.dout) v = *reinterpret_cast<const float4*>(G + row * tl.dout + gc);
      *reinterpret_cast<float4*>(ps + r * kDwF32Ld + 4 * j) = p;
      *reinterpret_cast<float4*>(gs + r * kDwF32Ld + 4 * j) = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kDwF32Rows; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(ps + r * kDwF32Ld + kk);
      const float4 v = *reinterpret_cast<const float4*>(gs + r * kDwF32Ld + cc);
      const float pv[4] = {p.x, p.y, p.z, p.w}, gv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv[i], gv[j], o[i][j]);
    }
    __syncthreads();
  }
  if (tl.k0 + kk < tl.din && tl.c0 + cc < tl.dout) {
    float* out = partial + (long long)blockIdx.y * d.dw_floats + d.dw_off[tl.l];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + (tl.k0 + kk + i) * tl.dout + tl.c0 + cc) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
  }
}

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
static_assert(kChainSmem <= kSmemOptin && kDwSmem <= kSmemOptin && kWideF32Smem <= kSmemOptin,
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

bool wide_widths_ok(const int* widths, int n_layers) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int i = 0; i <= n_layers; ++i)
    if (widths[i] <= 0 || widths[i] % 16 != 0 || widths[i] > kWideMax) return false;
  return true;
}

int launch_chain_f32(const void* in, const WideChain& c, long long m, cudaStream_t s) {
  fused_mlp_wide_f32_kernel<<<int((m + kWideF32Rows - 1) / kWideF32Rows), kWideF32Threads,
                              kWideF32Smem, s>>>(static_cast<const float*>(in), c, m);
  return int(cudaGetLastError());
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
      kWideF32Smem > size_t(max_smem))
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
      (err = cudaFuncSetAttribute(fused_mlp_wide_f32_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kWideF32Smem))) != cudaSuccess)
    return int(err);
  return 0;
}

// Forward of a wide chain (widths multiples of 16 up to 272, at most 8
// layers) over m rows, as fused_mlp_fwd; bf16 takes `ctas` CTAs (the
// wrapper's plan: at most one per SM), f32 one CTA per 64 rows. bf16
// tensors are 16-byte aligned. Returns 0, a cudaError_t code, -1 for
// arguments the kernels do not take, or -4 when a tensor map is refused.
extern "C" int fused_mlp_wide_fwd(const void* x, void* y, const void* const* weights,
                                  const int* widths, int n_layers, long long m, int dtype,
                                  int ctas, void* stream) {
  if (m < 0 || ctas < 1 || (dtype != 0 && dtype != 1) || !wide_widths_ok(widths, n_layers))
    return -1;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = n_layers;
  if (dtype == 0) {
    WideChain c = {};
    c.steps = n;
    for (int i = 0; i < n; ++i) {
      c.w[i] = weights[i];
      c.k[i] = widths[i];
      c.n[i] = widths[i + 1];
      if (i + 1 < n) c.relu |= 1u << i;
    }
    c.dst[n - 1] = y;
    return launch_chain_f32(x, c, m, s);
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

// f32 backward of fused_mlp_wide_fwd for m >= 1 rows. g, dx (may be null:
// not wanted) and dw as fused_mlp_bwd; weights_t[i] is W_i^T
// [widths[i+1]][widths[i]]. Scratch: post holds m * sum_{i=1}^{n-1} widths[i]
// floats (the recomputed post-activations), gscr as many (the masked g of
// each layer below the top), partial [splits][sum_i widths[i]*widths[i+1]].
// Returns as fused_mlp_wide_fwd.
extern "C" int fused_mlp_wide_bwd_f32(const void* x, const void* g, void* dx, void* dw,
                                      const void* const* weights, const void* const* weights_t,
                                      const int* widths, int n_layers, long long m, void* post,
                                      float* gscr, float* partial, int splits, void* stream) {
  if (m < 1 || splits < 1 || !wide_widths_ok(widths, n_layers)) return -1;
  const int n = n_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* posts[kMaxLayers];  // post_i, post_0 = x
  float* gs[kMaxLayers];          // g_i below the top
  posts[0] = x;
  float* pp = static_cast<float*>(post);
  float* gp = gscr;
  for (int i = 1; i < n; ++i) {
    posts[i] = pp;
    pp += size_t(m) * widths[i];
    gs[i - 1] = gp;
    gp += size_t(m) * widths[i];
  }
  int err;
  if (n > 1) {  // post_1 .. post_{n-1}: the forward's hidden layers again
    WideChain c = {};
    c.steps = n - 1;
    for (int l = 0; l + 1 < n; ++l) {
      c.w[l] = weights[l];
      c.k[l] = widths[l];
      c.n[l] = widths[l + 1];
      c.relu |= 1u << l;
      c.dst[l] = const_cast<void*>(posts[l + 1]);
    }
    if ((err = launch_chain_f32(x, c, m, s)) != 0) return err;
  }
  const int steps = dx ? n : n - 1;  // the last step makes dx alone
  if (steps > 0) {  // from the top: g_{i-1} = g_i @ W_i^T masked by post_i > 0
    WideChain c = {};
    c.steps = steps;
    for (int st = 0; st < steps; ++st) {
      const int i = n - 1 - st;
      c.w[st] = weights_t[i];
      c.k[st] = widths[i + 1];
      c.n[st] = widths[i];
      if (i > 0) {
        c.mask[st] = posts[i];
        c.gout[st] = gs[i - 1];
      } else {
        c.dst[st] = dx;
      }
    }
    if ((err = launch_chain_f32(g, c, m, s)) != 0) return err;
  }
  WideDw d = {};
  d.n_layers = n;
  int off = 0, tiles = 0;
  for (int i = 0; i < n; ++i) {
    d.post[i] = posts[i];
    d.g[i] = i + 1 < n ? static_cast<const void*>(gs[i]) : g;
    d.dw_off[i] = off;
    off += widths[i] * widths[i + 1];
    d.tile_off[i] = tiles;
    tiles += ((widths[i] + kDwF32Tile - 1) / kDwF32Tile) *
             ((widths[i + 1] + kDwF32Tile - 1) / kDwF32Tile);
  }
  for (int i = 0; i <= n; ++i) d.width[i] = widths[i];
  d.tile_off[n] = tiles;
  d.dw_floats = off;
  d.rows_per_split = (m + splits - 1) / splits;
  fused_mlp_wide_dw_f32_kernel<<<dim3(tiles, splits), 256, 0, s>>>(d, m, partial);
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
// unused). partial is [splits][sum_i widths[i]*widths[i+1]] floats. Returns
// as fused_mlp_wide_fwd.
extern "C" int fused_mlp_wide_bwd_bf16(const void* x, const void* g, void* dx, void* dw,
                                       const void* const* weights, const int* widths,
                                       int n_layers, long long m, void* const* planes,
                                       float* partial, int splits, long long per_split,
                                       int slices, int ctas, void* stream) {
  const int n = n_layers;
  if (m < 1 || splits < 1 || per_split < 1 || ctas < 1 || slices < 1 ||
      !wide_widths_ok(widths, n) || (long long)splits * per_split * kBlk < m)
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
