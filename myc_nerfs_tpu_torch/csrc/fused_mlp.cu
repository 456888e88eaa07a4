// Fused bias-free MLP forward for Hopper (sm_90a): y = Wn(...relu(W1 relu(W0 x))...).
//
// Replaces myc_nerfs_tpu/ops/pallas/fused_mlp.py::_fwd_kernel (the Pallas
// TPU kernel reached through fused_mlp / _fused_mlp_fwd_impl). It computes the
// same function: bias-free layers, ReLU between layers and none after the
// last, f32 accumulation, and a cast back to the input dtype after every
// layer (fused_mlp.py:40-43). Inputs and weights are f32 or bf16.
//
// What bounds it: at the NGP widths (32->64->16 and 32->64->64->16) a row
// costs about 2*(32*64 + 64*64 + 64*16) = 14k flops against 64-128 bytes of
// input and output per row, so the kernel is bound by the bytes it moves in
// and out, not by arithmetic, as long as no intermediate activation goes
// back to device memory. The design keeps every intermediate on chip:
//   - all layer weights are staged once per CTA into shared memory (f32);
//   - a CTA walks tiles of kTileRows rows (grid-stride), holding the tile's
//     activations in two ping-pong shared-memory buffers between layers;
//   - only x is read from and y written to device memory; the ragged last
//     tile is masked in the kernel, nothing is padded.
// Each thread computes 4 adjacent output columns of one row with an FMA loop
// over the layer's input width (float4 weight reads). Tensor cores (mma.sync,
// wgmma) and TMA are left for later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see ops/cuda/fused_mlp.py). Plain C entry
// point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 64;
constexpr int kTileRows = 64;
constexpr int kThreads = 256;
// activation row stride in floats: 16-byte aligned, and rows r and r+1 fall
// in different shared-memory banks (68 mod 32 = 4)
constexpr int kLd = kMaxWidth + 4;

struct Net {
  const void* w[kMaxLayers];
  int width[kMaxLayers + 1];
  int w_off[kMaxLayers];  // offset (floats) of layer i's weights in smem
  int n_layers;
  int w_floats;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
    p[i] = __float2bfloat16(v);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, Net net, long long m) {
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;
  float* act0 = smem + net.w_floats;
  float* act1 = act0 + kTileRows * kLd;
  const int tid = threadIdx.x;

  for (int l = 0; l < net.n_layers; ++l) {
    const T* w = static_cast<const T*>(net.w[l]);
    const int n = net.width[l] * net.width[l + 1];
    for (int i = tid; i < n; i += kThreads) wsm[net.w_off[l] + i] = Io<T>::load(w, i);
  }

  const int d_in = net.width[0];
  const long long n_tiles = (m + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    for (int i = tid; i < kTileRows * d_in; i += kThreads) {
      const int r = i / d_in;
      const int k = i - r * d_in;
      const long long row = row0 + r;
      act0[r * kLd + k] = row < m ? Io<T>::load(x, row * d_in + k) : 0.f;
    }
    __syncthreads();

    float* hin = act0;
    float* hout = act1;
    for (int l = 0; l < net.n_layers; ++l) {
      const int din = net.width[l];
      const int dout = net.width[l + 1];
      const int groups = dout / 4;
      const bool last = l == net.n_layers - 1;
      const float* wl = wsm + net.w_off[l];
      for (int i = tid; i < kTileRows * groups; i += kThreads) {
        const int r = i / groups;
        const int c = (i - r * groups) * 4;
        const float* hr = hin + r * kLd;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
        for (int k = 0; k < din; ++k) {
          const float a = hr[k];
          const float4 wv = *reinterpret_cast<const float4*>(wl + k * dout + c);
          a0 = fmaf(a, wv.x, a0);
          a1 = fmaf(a, wv.y, a1);
          a2 = fmaf(a, wv.z, a2);
          a3 = fmaf(a, wv.w, a3);
        }
        float v[4] = {a0, a1, a2, a3};
        if (!last) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // max(v, 0) that keeps NaN, like jnp.maximum / torch.relu
            const float h = v[j] < 0.f ? 0.f : v[j];
            hout[r * kLd + c + j] = Io<T>::round(h);
          }
        } else {
          const long long row = row0 + r;
          if (row < m) {
#pragma unroll
            for (int j = 0; j < 4; ++j) Io<T>::store(y, row * dout + c + j, v[j]);
          }
        }
      }
      __syncthreads();
      float* t = hin;
      hin = hout;
      hout = t;
    }
  }
}

template <typename T>
int launch(const void* x, void* y, const Net& net, long long m, cudaStream_t stream) {
  const size_t smem = (size_t(net.w_floats) + 2 * kTileRows * kLd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_fwd_kernel<T>,
                                                           kThreads, smem)) != cudaSuccess)
    return int(err);
  const long long n_tiles = (m + kTileRows - 1) / kTileRows;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  fused_mlp_fwd_kernel<T><<<unsigned(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), net, m);
  return int(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, a cudaError_t code on a CUDA failure, or -1 when the
// arguments are outside what the kernel takes (the Python wrapper checks them
// first). dtype: 0 = float32, 1 = bfloat16. weights[i] is [widths[i],
// widths[i+1]] row-major; x is [m, widths[0]], y is [m, widths[n_layers]].
extern "C" int fused_mlp_fwd(const void* x, void* y, const void* const* weights,
                             const int* widths, int n_layers, long long m, int dtype,
                             void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || m < 0) return -1;
  Net net;
  int off = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] <= 0 || widths[i] % 16 != 0 || widths[i] > kMaxWidth) return -1;
    net.width[i] = widths[i];
  }
  for (int i = 0; i < n_layers; ++i) {
    net.w[i] = weights[i];
    net.w_off[i] = off;
    off += widths[i] * widths[i + 1];
  }
  net.n_layers = n_layers;
  net.w_floats = off;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, net, m, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, net, m, s);
  return -1;
}
