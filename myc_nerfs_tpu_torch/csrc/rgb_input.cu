// The NGP rgb MLP's input for Hopper (sm_90a): x = [h | SH(dirs * 2 - 1)],
// for models/ngp.py::NGPModel.forward on CUDA tensors (ops/cuda/rgb_input.py).
//
// It replaces no Pallas kernel: the JAX package encodes the directions and
// concatenates them with the density MLP's output in XLA
// (myc_nerfs_tpu/models/ngp.py, ops/sh.py::sh_encode). The port's plain
// version (ops/cuda/rgb_input.py::rgb_input_plain) runs it as ~60 eager
// torch ops per call: the warp, the degree-4 SH products over [M] f32
// columns, a 16-way stack, the cast and the concatenation. On a 4096-ray x
// 64-sample render chunk their launches, not their device time, held the
// host. One launch here writes the same x.
//
// What it computes, per row m: x[m, 0:16] = h[m, :] (a copy of the bits),
// x[m, 16:32] = the 16 real SH bases of degree 0-3 at d = dirs[m] * 2 - 1
// (ops/sh.py::eval_sh_bases(3, d)), in f32, rounded to h's dtype.
//
// Exactness. x equals the plain version's on CUDA tensors bit for bit: each
// torch op is one rounding, so every product, sum and difference here is a
// separately rounded __fmul_rn / __fsub_rn, which nvcc never contracts into
// an FMA, in eval_sh_bases's order (Python's left-to-right: C * y * (a - b)
// is (C * y) * (a - b)); each Python constant is rounded to f32, as torch
// rounds a scalar operand into an f32 op; the cast to bf16 is
// __float2bfloat16_rn, the rounding torch's CUDA .to(bfloat16) uses.
//
// What bounds it on this card: bytes. Per row it reads h (32 bytes in bf16,
// 64 in f32) and the direction (12), and writes x (64 or 128): at 262,144
// rows in bf16 ~28 MB, ~8 us at 3.35 TB/s. The ~60 products and
// differences per row are far below the card's rate.
//
// The design: one thread per row. The thread reads its direction through
// the strides it is given (a view need not be copied), copies h's row in
// 16-byte words, computes the 16 bases in registers and stores them as
// 16-byte words of x's row; a warp's rows are contiguous, so its loads and
// stores cover whole sectors.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (ops/cuda/_build.py). Plain C entry points,
//             loaded with ctypes by ops/cuda/rgb_input.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "error_text.cuh"

namespace {

constexpr int kWidth = 16;     // h's columns, and the SH bases'
constexpr int kThreads = 256;  // rows per CTA

// ops/sh.py's C0-C3 (scalars: device code reads no host array), each
// rounded to f32 from the same decimal literal
constexpr float kC0 = float(0.28209479177387814);
constexpr float kC1 = float(0.4886025119029199);
constexpr float kNegC1 = float(-0.4886025119029199);
constexpr float kC2_0 = float(1.0925484305920792);
constexpr float kC2_1 = float(-1.0925484305920792);
constexpr float kC2_2 = float(0.31539156525252005);
constexpr float kC2_3 = float(-1.0925484305920792);
constexpr float kC2_4 = float(0.5462742152960396);
constexpr float kC3_0 = float(-0.5900435899266435);
constexpr float kC3_1 = float(2.890611442640554);
constexpr float kC3_2 = float(-0.4570457994644658);
constexpr float kC3_3 = float(0.3731763325901154);
constexpr float kC3_4 = float(-0.4570457994644658);
constexpr float kC3_5 = float(1.445305721320277);
constexpr float kC3_6 = float(-0.5900435899266435);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// eval_sh_bases(3, dirs * 2.0 - 1.0) at one direction, op for op
__device__ __forceinline__ void sh_bases(float dx, float dy, float dz, float s[kWidth]) {
  const float x = sub(mul(dx, 2.0f), 1.0f);
  const float y = sub(mul(dy, 2.0f), 1.0f);
  const float z = sub(mul(dz, 2.0f), 1.0f);
  s[0] = kC0;
  s[1] = mul(kNegC1, y);
  s[2] = mul(kC1, z);
  s[3] = mul(kNegC1, x);
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
  s[4] = mul(kC2_0, xy);
  s[5] = mul(kC2_1, yz);
  s[6] = mul(kC2_2, sub(sub(mul(2.0f, zz), xx), yy));
  s[7] = mul(kC2_3, xz);
  s[8] = mul(kC2_4, sub(xx, yy));
  const float zz4 = sub(sub(mul(4.0f, zz), xx), yy);  // 4 * zz - xx - yy
  s[9] = mul(mul(kC3_0, y), sub(mul(3.0f, xx), yy));
  s[10] = mul(mul(kC3_1, xy), z);
  s[11] = mul(mul(kC3_2, y), zz4);
  s[12] = mul(mul(kC3_3, z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
  s[13] = mul(mul(kC3_4, x), zz4);
  s[14] = mul(mul(kC3_5, z), sub(xx, yy));
  s[15] = mul(mul(kC3_6, x), sub(xx, mul(3.0f, yy)));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// the bases in x's dtype, as 16-byte words: 2 in bf16, 4 in f32
template <bool kBf16>
__device__ __forceinline__ void store_bases(uint4* dst, const float s[kWidth]) {
  if constexpr (kBf16) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float* v = s + 8 * w;
      dst[w] = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                          bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
    }
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* v = s + 4 * w;
      dst[w] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                          __float_as_uint(v[2]), __float_as_uint(v[3]));
    }
  }
}

// h [n, 16] and x [n, 32] contiguous and 16-byte aligned, in bf16 or f32;
// dirs [n, 3] f32 at element strides (d_row, d_col)
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    rgb_input_kernel(const uint4* __restrict__ h, const float* __restrict__ dirs,
                     long long d_row, long long d_col, uint4* __restrict__ x, long long n) {
  constexpr int kWords = kWidth * (kBf16 ? 2 : 4) / 16;  // 16-byte words in h's row
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (m >= n) return;
  const float* d = dirs + m * d_row;
  float s[kWidth];
  sh_bases(d[0], d[d_col], d[2 * d_col], s);
  const uint4* src = h + m * kWords;
  uint4* dst = x + m * 2 * kWords;
#pragma unroll
  for (int w = 0; w < kWords; ++w) dst[w] = src[w];
  store_bases<kBf16>(dst + kWords, s);
}

}  // namespace

// Returns 0 on success, a cudaError_t code on a CUDA failure, or -1 for
// arguments outside what the kernel takes. h [n, 16] (bf16 where bf16 != 0,
// else f32) and x [n, 32] of the same dtype are contiguous device memory,
// 16-byte aligned; dirs [n, 3] is f32 device memory read at element strides
// (d_row, d_col).
extern "C" int rgb_input(const void* h, const float* dirs, long long d_row, long long d_col,
                         void* x, long long n, int bf16, void* stream) {
  if (n < 0 || (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(x)) % 16)
    return -1;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return -1;
  const auto* src = static_cast<const uint4*>(h);
  auto* dst = static_cast<uint4*>(x);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rgb_input_kernel<true><<<unsigned(blocks), kThreads, 0, s>>>(src, dirs, d_row, d_col, dst, n);
  else
    rgb_input_kernel<false><<<unsigned(blocks), kThreads, 0, s>>>(src, dirs, d_row, d_col, dst, n);
  return int(cudaGetLastError());
}
