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
// (fused_mlp_wide_fwd / fused_mlp_wide_bwd): weights streamed through shared
// memory a chunk at a time, and a backward through global scratch.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see ops/cuda/_build.py). Plain C entry
// points, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// layer (1.07 MB) and one CTA's f32 dW (2.1 MB) no longer fit on chip, so:
//   - a chain kernel runs one layer after another over a CTA's row tile,
//     which stays in shared memory, and streams each layer's weights through
//     shared memory in 32-row chunks (cp.async, double-buffered, the next
//     chunk loading while this one computes). bf16: 128-row tiles, 8 warps as
//     4 row groups of 32 x 2 column halves, mma.sync m16n8k16 with f32
//     accumulators in registers; a layer's output overwrites its input in
//     place once every warp is past its last read. f32: 64-row tiles of k-major
//     activations, 4x4 register micro-tiles on the CUDA cores, weights read
//     through the cache. Each step has its own epilogue (ReLU, a mask by
//     another tensor > 0, an f32 copy, a rounded copy), so one kernel is the
//     forward, the backward's recompute of the post-activations, and its
//     dgrad chain (round(g) @ W^T masked by post > 0, with W^T from the
//     wrapper);
//   - the backward writes post_i (dtype) and the masked g_i (f32) of every
//     layer to global scratch, then a tiled dW_i = post_i^T g_i over row
//     splits (bf16: 128 x 128 tiles, g as bf16 hi + lo, two mma into one f32
//     accumulator, as the narrow kernel; f32: 64 x 64 tiles of 4x4
//     micro-tiles), and the fixed-order sum of the splits above, so the
//     result does not change from run to run.
// What bounds it: 2 x 1.07 Mflop per row forward (140 Gflop at 131072 rows,
// 0.14 ms at 989 TFLOP/s bf16), against 0.7 KB of x and y per row (0.03 ms):
// the tensor cores. The backward's scratch (post_i and g_i of 7 hidden layers,
// 11.4 KB per row in bf16) is written once and read once or twice; a later
// design keeps it on chip.

constexpr int kWideMax = 272;                        // widest layer the wide kernels take
constexpr int kWideLd = kWideMax + kPad;             // bf16 row stride of tile and chunks
constexpr int kWideRows = 128;                       // bf16 rows of a CTA's tile
constexpr int kWideWarps = 8;                        // 4 row groups x 2 column halves
constexpr int kWideKc = 32;                          // weight rows per staged chunk
constexpr int kWidePairs = (kWideMax / 16 + 1) / 2;  // 16-column pairs of one half
constexpr int kWideF32Rows = 64;                     // f32 rows of a CTA's tile
constexpr int kWideF32Ld = kWideF32Rows + 4;         // k-major row stride
constexpr int kWideF32Threads = 256;
constexpr int kDwTile = 128;                         // bf16 dW tile (din x dout) of one CTA
constexpr int kDwWarps = 8;                          // 4 x 2 warps of 32 x 64
constexpr int kDwRows = 32;                          // bf16 rows per staged step of dW
constexpr int kDwLd = kDwTile + kPad;
constexpr int kDwF32Tile = 64;                       // f32 dW tile of one CTA
constexpr int kDwF32Rows = 32;
constexpr int kDwF32Ld = kDwF32Tile + 4;

constexpr size_t kWideBf16Smem = size_t(kWideRows + 2 * kWideKc) * kWideLd * sizeof(bf16);
constexpr size_t kWideF32Smem = 2 * size_t(kWideMax) * kWideF32Ld * sizeof(float);

// A chain of `steps` products over the rows: out_s = epilogue(in_s @ B_s),
// in_0 the kernel's input, in_{s+1} = round(out_s).
struct WideChain {
  const void* w[kMaxLayers];     // B_s [k[s]][n[s]], row-major, in the dtype
  int k[kMaxLayers];
  int n[kMaxLayers];
  int steps;
  unsigned relu;                 // bit s: ReLU on out_s
  const void* mask[kMaxLayers];  // or null: out_s times (mask > 0), mask [m][n[s]]
  float* gout[kMaxLayers];       // or null: out_s in f32 [m][n[s]], before rounding
  void* dst[kMaxLayers];         // or null: round(out_s) [m][n[s]]
};

__global__ void __launch_bounds__(kWideWarps * 32, 1)
fused_mlp_wide_bf16_kernel(const bf16* __restrict__ in, WideChain c, long long m) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* act = smem;                         // [kWideRows][kWideLd]
  bf16* wbuf = smem + kWideRows * kWideLd;  // 2 x [kWideKc][kWideLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, half = warp >> 2;
  const int q = lane >> 3, r8 = lane & 7, g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * kWideRows;

  {  // the input tile; rows past m are zeroed
    const int k0 = c.k[0], c8 = k0 / 8;
    for (int i = threadIdx.x; i < kWideRows * c8; i += blockDim.x) {
      const int r = i / c8, j = i - r * c8;
      const long long row = row0 + r;
      const bool ok = row < m;
      cp_async16(smem_addr(act + r * kWideLd + 8 * j), in + (ok ? row : 0) * k0 + 8 * j,
                 ok ? 16 : 0);
    }
  }
  // weight chunks in the order the steps take them; (ls, lk) loads next
  int ls = 0, lk = 0;
  auto load_next = [&](int b) {
    if (ls >= c.steps) return;
    const bf16* w = static_cast<const bf16*>(c.w[ls]);
    const int n = c.n[ls], n8 = n / 8;
    const int rows = min(kWideKc, c.k[ls] - lk);
    bf16* dst = wbuf + b * kWideKc * kWideLd;
    for (int i = threadIdx.x; i < rows * n8; i += blockDim.x) {
      const int r = i / n8, j = i - r * n8;
      cp_async16(smem_addr(dst + r * kWideLd + 8 * j), w + (long long)(lk + r) * n + 8 * j, 16);
    }
    lk += kWideKc;
    if (lk >= c.k[ls]) {
      lk = 0;
      ++ls;
    }
  };
  load_next(0);
  cp_async_commit();

  int buf = 0;
  for (int s = 0; s < c.steps; ++s) {
    const int K = c.k[s], N = c.n[s];
    const int pairs = N / 16, split = (pairs + 1) / 2;
    const int p0 = half ? split : 0, np = half ? pairs - split : split;
    float acc[2][2 * kWidePairs][4];
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int j = 0; j < 2 * kWidePairs; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[st][j][e] = 0.f;

    for (int kc = 0; kc < K; kc += kWideKc, buf ^= 1) {
      load_next(buf ^ 1);
      cp_async_commit();
      cp_async_wait_1();
      __syncthreads();
      const bf16* wb = wbuf + buf * kWideKc * kWideLd;
      const uint32_t bbase =
          smem_addr(wb + ((q & 1) * 8 + r8) * kWideLd + (q >> 1) * 8 + 16 * p0);
#pragma unroll
      for (int kk = 0; kk < kWideKc; kk += 16) {
        if (kc + kk >= K) break;
        uint32_t a[2][4];
#pragma unroll
        for (int st = 0; st < 2; ++st)
          ldsm_x4(a[st], smem_addr(act + (32 * rg + 16 * st + (lane & 15)) * kWideLd + kc + kk +
                                   (lane >> 4) * 8));
#pragma unroll
        for (int pp = 0; pp < kWidePairs; ++pp) {
          if (pp >= np) break;
          uint32_t b[4];
          ldsm_x4_t(b, bbase + 2u * (kk * kWideLd + 16 * pp));
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            mma_bf16(acc[st][2 * pp], a[st], b[0], b[1]);
            mma_bf16(acc[st][2 * pp + 1], a[st], b[2], b[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this chunk (after the last, with act)
    }

    // epilogue, in place over act
    const bool relu_s = (c.relu >> s) & 1u;
    const bf16* mk = static_cast<const bf16*>(c.mask[s]);
    float* go = c.gout[s];
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int pp = 0; pp < kWidePairs; ++pp) {
        if (pp >= np) break;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rl = 32 * rg + 16 * st + g + 8 * e;
            const int col = 16 * (p0 + pp) + 8 * h + 2 * t;
            const long long row = row0 + rl;
            float v0 = acc[st][2 * pp + h][2 * e], v1 = acc[st][2 * pp + h][2 * e + 1];
            if (relu_s) {
              v0 = relu(v0);
              v1 = relu(v1);
            }
            if (row < m) {
              if (mk) {  // a product, so a non-finite value stays non-finite
                const float2 p =
                    unpack_bf16(*reinterpret_cast<const uint32_t*>(mk + row * N + col));
                v0 *= p.x > 0.f ? 1.f : 0.f;
                v1 *= p.y > 0.f ? 1.f : 0.f;
              }
              if (go) *reinterpret_cast<float2*>(go + row * N + col) = make_float2(v0, v1);
            }
            *reinterpret_cast<uint32_t*>(act + rl * kWideLd + col) = pack_bf16(v0, v1);
          }
      }
    if (c.dst[s]) {  // the rounded output by 16-byte stores of the rows < m
      __syncthreads();
      bf16* d = static_cast<bf16*>(c.dst[s]);
      const int n8 = N / 8;
      for (int i = threadIdx.x; i < kWideRows * n8; i += blockDim.x) {
        const int r = i / n8, j = i - r * n8;
        const long long row = row0 + r;
        if (row < m)
          *reinterpret_cast<uint4*>(d + row * N + 8 * j) =
              *reinterpret_cast<const uint4*>(act + r * kWideLd + 8 * j);
      }
    }
  }
  cp_async_wait_0();
}

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

// dW_i = post_i^T g_i of every layer, one tile x tile block of one layer per
// CTA (blockIdx.x over all layers' tiles) and one row split per blockIdx.y,
// into partial[split][the concatenated dW]. A larger tile reads post_i and
// g_i fewer times: at 272 wide, 128 x 128 tiles read each 3 times, 64 x 64
// ones 5 times.
struct WideDw {
  const void* post[kMaxLayers];  // post_i [m][width[i]] in the dtype (post_0 = x)
  const void* g[kMaxLayers];     // g_i [m][width[i+1]]: f32, except the top layer's in bf16
  int width[kMaxLayers + 1];
  int n_layers;
  int dw_off[kMaxLayers];
  int dw_floats;
  int tile;                      // kDwTile (bf16) or kDwF32Tile
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
  const int tn = (tl.dout + d.tile - 1) / d.tile;
  const int lt = blockIdx.x - d.tile_off[tl.l];
  tl.k0 = d.tile * (lt / tn);
  tl.c0 = d.tile * (lt % tn);
  tl.rbeg = blockIdx.y * d.rows_per_split;
  tl.rend = min(m, tl.rbeg + d.rows_per_split);
  return tl;
}

// bf16 rows [rc, rc + kDwRows) x columns [c0, c0 + kDwTile) of a [m][d]
// matrix -> shared [kDwRows][kDwLd]; zeros outside the rows and columns
__device__ __forceinline__ void stage_dw_bf16(bf16* dst, const bf16* src, int d, int c0,
                                              long long rc, long long rend) {
  for (int i = threadIdx.x; i < kDwRows * (kDwTile / 8); i += blockDim.x) {
    const int r = i / (kDwTile / 8), j = i % (kDwTile / 8);
    const long long row = rc + r;
    const int col = c0 + 8 * j;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < rend && col < d) v = *reinterpret_cast<const uint4*>(src + row * d + col);
    *reinterpret_cast<uint4*>(dst + r * kDwLd + 8 * j) = v;
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

__global__ void __launch_bounds__(kDwWarps * 32)
fused_mlp_wide_dw_bf16_kernel(WideDw d, long long m, float* __restrict__ partial) {
  __shared__ __align__(16) bf16 ps[kDwRows * kDwLd];
  __shared__ __align__(16) bf16 gh[kDwRows * kDwLd];
  __shared__ __align__(16) bf16 gl[kDwRows * kDwLd];
  const DwTile tl = dw_tile(d, m);
  const bool gf32 = tl.l + 1 < d.n_layers;  // the top layer's g arrives rounded: g_lo = 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;  // a 32 x 64 block of the tile
  const int q = lane >> 3, r8 = lane & 7, g = lane >> 2, t = lane & 3;
  bool mv[2], nv[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) mv[i] = tl.k0 + 32 * wm + 16 * i < tl.din;
#pragma unroll
  for (int p = 0; p < 4; ++p) nv[p] = tl.c0 + 64 * wn + 16 * p < tl.dout;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (long long rc = tl.rbeg; rc < tl.rend; rc += kDwRows) {
    stage_dw_bf16(ps, static_cast<const bf16*>(d.post[tl.l]), tl.din, tl.k0, rc, tl.rend);
    if (gf32) {
      const float* G = static_cast<const float*>(d.g[tl.l]);
      for (int i = threadIdx.x; i < kDwRows * (kDwTile / 4); i += blockDim.x) {
        const int r = i / (kDwTile / 4), j = i % (kDwTile / 4);
        const long long row = rc + r;
        const int col = tl.c0 + 4 * j;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < tl.rend && col < tl.dout)
          v = *reinterpret_cast<const float4*>(G + row * tl.dout + col);
        uint2 hi, lo;
        split_bf16(v.x, v.y, hi.x, lo.x);
        split_bf16(v.z, v.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(gh + r * kDwLd + 4 * j) = hi;
        *reinterpret_cast<uint2*>(gl + r * kDwLd + 4 * j) = lo;
      }
    } else {
      stage_dw_bf16(gh, static_cast<const bf16*>(d.g[tl.l]), tl.dout, tl.c0, rc, tl.rend);
    }
    __syncthreads();
#pragma unroll
    for (int kr = 0; kr < kDwRows / 16; ++kr) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (mv[i])
          ldsm_x4_t(a[i], smem_addr(ps + (16 * kr + (q >> 1) * 8 + r8) * kDwLd + 32 * wm +
                                    16 * i + (q & 1) * 8));
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (!nv[pp]) continue;
        const int off = (16 * kr + (q & 1) * 8 + r8) * kDwLd + 64 * wn + 16 * pp + (q >> 1) * 8;
        uint32_t b[4];
        ldsm_x4_t(b, smem_addr(gh + off));
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (mv[i]) {
            mma_bf16(acc[i][2 * pp], a[i], b[0], b[1]);
            mma_bf16(acc[i][2 * pp + 1], a[i], b[2], b[3]);
          }
        if (gf32) {
          ldsm_x4_t(b, smem_addr(gl + off));
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (mv[i]) {
              mma_bf16(acc[i][2 * pp], a[i], b[0], b[1]);
              mma_bf16(acc[i][2 * pp + 1], a[i], b[2], b[3]);
            }
        }
      }
    }
    __syncthreads();
  }

  float* out = partial + (long long)blockIdx.y * d.dw_floats + d.dw_off[tl.l];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!mv[i] || !nv[j >> 1]) continue;
      const int row = tl.k0 + 32 * wm + 16 * i + g;
      const int col = tl.c0 + 64 * wn + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + row * tl.dout + col) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + (row + 8) * tl.dout + col) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
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

bool wide_widths_ok(const int* widths, int n_layers) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int i = 0; i <= n_layers; ++i)
    if (widths[i] <= 0 || widths[i] % 16 != 0 || widths[i] > kWideMax) return false;
  return true;
}

int launch_chain(const void* in, const WideChain& c, long long m, int dtype, cudaStream_t s) {
  if (dtype == 1)
    fused_mlp_wide_bf16_kernel<<<int((m + kWideRows - 1) / kWideRows), kWideWarps * 32,
                                 kWideBf16Smem, s>>>(static_cast<const bf16*>(in), c, m);
  else
    fused_mlp_wide_f32_kernel<<<int((m + kWideF32Rows - 1) / kWideF32Rows), kWideF32Threads,
                                kWideF32Smem, s>>>(static_cast<const float*>(in), c, m);
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

// Lifts the dynamic shared-memory limit of the wide chain kernels on the
// current device; call once per device before fused_mlp_wide_fwd/_bwd.
// Returns 0, a cudaError_t code, or -2 when the device has too little shared
// memory for them.
extern "C" int fused_mlp_wide_init() {
  int dev = 0, max_smem = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return int(err);
  if (kWideBf16Smem > size_t(max_smem) || kWideF32Smem > size_t(max_smem)) return -2;
  if ((err = cudaFuncSetAttribute(fused_mlp_wide_bf16_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kWideBf16Smem))) != cudaSuccess)
    return int(err);
  return int(cudaFuncSetAttribute(fused_mlp_wide_f32_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kWideF32Smem)));
}

// Forward of a wide chain (widths multiples of 16 up to 272, at most 8
// layers) over m rows, as fused_mlp_fwd. Returns 0, a cudaError_t code, or -1
// for arguments the kernels do not take.
extern "C" int fused_mlp_wide_fwd(const void* x, void* y, const void* const* weights,
                                  const int* widths, int n_layers, long long m, int dtype,
                                  void* stream) {
  if (m < 0 || (dtype != 0 && dtype != 1) || !wide_widths_ok(widths, n_layers)) return -1;
  if (m == 0) return 0;
  WideChain c = {};
  c.steps = n_layers;
  for (int s = 0; s < n_layers; ++s) {
    c.w[s] = weights[s];
    c.k[s] = widths[s];
    c.n[s] = widths[s + 1];
    if (s + 1 < n_layers) c.relu |= 1u << s;
  }
  c.dst[n_layers - 1] = y;
  return launch_chain(x, c, m, dtype, static_cast<cudaStream_t>(stream));
}

// Backward of fused_mlp_wide_fwd for m >= 1 rows. g, dx (may be null: not
// wanted) and dw as fused_mlp_bwd; weights_t[i] is W_i^T [widths[i+1]][widths[i]].
// Scratch: post holds m * sum_{i=1}^{n-1} widths[i] elements of the dtype (the
// recomputed post-activations), gscr as many floats (the masked f32 g of each
// layer below the top), partial [splits][sum_i widths[i]*widths[i+1]] floats.
// Returns as fused_mlp_wide_fwd.
extern "C" int fused_mlp_wide_bwd(const void* x, const void* g, void* dx, void* dw,
                                  const void* const* weights, const void* const* weights_t,
                                  const int* widths, int n_layers, long long m, int dtype,
                                  void* post, float* gscr, float* partial, int splits,
                                  void* stream) {
  if (m < 1 || splits < 1 || (dtype != 0 && dtype != 1) || !wide_widths_ok(widths, n_layers))
    return -1;
  const int n = n_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t es = dtype == 1 ? sizeof(bf16) : sizeof(float);
  const void* posts[kMaxLayers];  // post_i, post_0 = x
  float* gs[kMaxLayers];          // g_i below the top, f32
  posts[0] = x;
  char* pp = static_cast<char*>(post);
  float* gp = gscr;
  for (int i = 1; i < n; ++i) {
    posts[i] = pp;
    pp += size_t(m) * widths[i] * es;
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
    if ((err = launch_chain(x, c, m, dtype, s)) != 0) return err;
  }
  const int steps = dx ? n : n - 1;  // the last step makes dx alone
  if (steps > 0) {  // from the top: g_{i-1} = round(g_i) @ W_i^T masked by post_i > 0
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
    if ((err = launch_chain(g, c, m, dtype, s)) != 0) return err;
  }
  WideDw d = {};
  d.n_layers = n;
  d.tile = dtype == 1 ? kDwTile : kDwF32Tile;
  int off = 0, tiles = 0;
  for (int i = 0; i < n; ++i) {
    d.post[i] = posts[i];
    d.g[i] = i + 1 < n ? static_cast<const void*>(gs[i]) : g;
    d.dw_off[i] = off;
    off += widths[i] * widths[i + 1];
    d.tile_off[i] = tiles;
    tiles += ((widths[i] + d.tile - 1) / d.tile) * ((widths[i + 1] + d.tile - 1) / d.tile);
  }
  for (int i = 0; i <= n; ++i) d.width[i] = widths[i];
  d.tile_off[n] = tiles;
  d.dw_floats = off;
  const long long per = (m + splits - 1) / splits;
  d.rows_per_split = (per + kDwRows - 1) / kDwRows * kDwRows;
  const dim3 grid(tiles, splits);
  if (dtype == 1)
    fused_mlp_wide_dw_bf16_kernel<<<grid, kDwWarps * 32, 0, s>>>(d, m, partial);
  else
    fused_mlp_wide_dw_f32_kernel<<<grid, 256, 0, s>>>(d, m, partial);
  if ((err = int(cudaGetLastError())) != 0) return err;
  const dim3 threads(kReduceCols, kReduceRows);
  const int blocks = (off + kReduceCols - 1) / kReduceCols;
  if (dtype == 1)
    fused_mlp_bwd_reduce_kernel<bf16><<<blocks, threads, 0, s>>>(partial, splits, off,
                                                                 static_cast<bf16*>(dw));
  else
    fused_mlp_bwd_reduce_kernel<float><<<blocks, threads, 0, s>>>(partial, splits, off,
                                                                  static_cast<float*>(dw));
  return int(cudaGetLastError());
}
