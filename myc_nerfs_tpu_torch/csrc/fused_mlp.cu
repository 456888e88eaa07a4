// Fused bias-free MLP for Hopper (sm_90a): y = Wn(...relu(W1 relu(W0 x))...),
// forward (this comment) and backward (further down).
//
// The forward replaces myc_nerfs_tpu/ops/pallas/fused_mlp.py::_fwd_kernel (the Pallas
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

// ---------------------------------------------------------------------------
// Backward. Replaces myc_nerfs_tpu/ops/pallas/fused_mlp.py::_bwd_kernel
// (reached through _fused_mlp_bwd). Per 64-row tile it recomputes the
// forward's post-activations post[0] = x, post[i+1] = round(relu(post[i] W_i))
// with the forward kernel's exact FMA order, then walks the layers from the
// last to the first with g (f32; it arrives rounded to x's dtype):
//   dW_i += post[i]^T g                       (f32, g as it is)
//   g     = round(g) W_i^T, masked by post[i] > 0 for i > 0
// and stores dx = round(g). Each dW is cast to the weights' dtype at the end.
//
// What bounds it: three passes of the layer chain per row (recompute, dW,
// dgrad), 3 x 7168 FMAs per row for the rgb MLP, against 64-128 bytes of x,
// g and dx per row: arithmetic, fed from shared memory. The design keeps
// every intermediate on chip and makes dW deterministic:
//   - a CTA stages the weights (rows padded to dout+4 floats, so the dgrad's
//     row-wise float4 reads of W fall in distinct banks), keeps the tile's
//     post-activations of every layer and two ping-pong g buffers in shared
//     memory, and accumulates its own partial dW in shared memory while it
//     walks 64-row tiles grid-stride;
//   - CTAs run in no order, so instead of the TPU's sequential-grid
//     accumulator each CTA writes its partial dW to a [n_ctas, sum |W_i|]
//     f32 workspace, and a second kernel sums the partials in CTA order:
//     the result is the same from run to run.
// dW's thread owns a fixed (k, 4 columns) block of W_i, so its shared-memory
// accumulation needs no atomics. Tensor cores and TMA are left for later.

// 512 threads: with one CTA per SM (the rgb MLP's 144 KB of shared memory)
// 16 warps hide the shared-memory latency better than 8 (rgb bf16 1.38 vs
// 1.62 ms on an H100 at 262144 rows)
constexpr int kBwdThreads = 512;

struct BwdNet {
  const void* w[kMaxLayers];
  int width[kMaxLayers + 1];
  int w_off[kMaxLayers];   // offset (floats) of layer i's padded weights in smem
  int w_ld[kMaxLayers];    // padded row stride of layer i's weights
  int dw_off[kMaxLayers];  // offset (floats) of layer i's dW (unpadded)
  int n_layers;
  int w_floats;
  int dw_floats;
};

__host__ __device__ inline size_t bwd_smem_floats(int w_floats, int dw_floats, int n_layers) {
  return size_t(w_floats) + dw_floats + size_t(n_layers + 2) * kTileRows * kLd;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
fused_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ dx,
                     float* __restrict__ partial, BwdNet net, long long m) {
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;
  float* dwsm = wsm + net.w_floats;
  float* post = dwsm + net.dw_floats;                   // n_layers tiles
  float* gbuf0 = post + net.n_layers * kTileRows * kLd;
  float* gbuf1 = gbuf0 + kTileRows * kLd;
  const int tid = threadIdx.x;
  const int n = net.n_layers;

  for (int l = 0; l < n; ++l) {
    const T* w = static_cast<const T*>(net.w[l]);
    const int din = net.width[l], dout = net.width[l + 1], ld = net.w_ld[l];
    for (int i = tid; i < din * dout; i += kBwdThreads) {
      const int k = i / dout;
      wsm[net.w_off[l] + k * ld + (i - k * dout)] = Io<T>::load(w, i);
    }
  }
  for (int i = tid; i < net.dw_floats; i += kBwdThreads) dwsm[i] = 0.f;

  const int d_in = net.width[0];
  const int d_out = net.width[n];
  const long long n_tiles = (m + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    for (int i = tid; i < kTileRows * d_in; i += kBwdThreads) {
      const int r = i / d_in;
      const int k = i - r * d_in;
      const long long row = row0 + r;
      post[r * kLd + k] = row < m ? Io<T>::load(x, row * d_in + k) : 0.f;
    }
    for (int i = tid; i < kTileRows * d_out; i += kBwdThreads) {
      const int r = i / d_out;
      const int c = i - r * d_out;
      const long long row = row0 + r;
      gbuf0[r * kLd + c] = row < m ? Io<T>::load(gy, row * d_out + c) : 0.f;
    }
    __syncthreads();

    // recompute post[1..n-1], as the forward kernel computes them
    for (int l = 0; l + 1 < n; ++l) {
      const int din = net.width[l];
      const int dout = net.width[l + 1];
      const int groups = dout / 4;
      const int ld = net.w_ld[l];
      const float* wl = wsm + net.w_off[l];
      const float* hin = post + l * kTileRows * kLd;
      float* hout = post + (l + 1) * kTileRows * kLd;
      for (int i = tid; i < kTileRows * groups; i += kBwdThreads) {
        const int r = i / groups;
        const int c = (i - r * groups) * 4;
        const float* hr = hin + r * kLd;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
        for (int k = 0; k < din; ++k) {
          const float a = hr[k];
          const float4 wv = *reinterpret_cast<const float4*>(wl + k * ld + c);
          a0 = fmaf(a, wv.x, a0);
          a1 = fmaf(a, wv.y, a1);
          a2 = fmaf(a, wv.z, a2);
          a3 = fmaf(a, wv.w, a3);
        }
        float v[4] = {a0, a1, a2, a3};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float h = v[j] < 0.f ? 0.f : v[j];
          hout[r * kLd + c + j] = Io<T>::round(h);
        }
      }
      __syncthreads();
    }

    float* gin = gbuf0;
    float* gout = gbuf1;
    for (int l = n - 1; l >= 0; --l) {
      const int din = net.width[l];
      const int dout = net.width[l + 1];
      const int ld = net.w_ld[l];
      const float* wl = wsm + net.w_off[l];
      const float* hl = post + l * kTileRows * kLd;
      // dW_l += post[l]^T g: a thread owns W_l[k, c..c+3]
      const int groups = dout / 4;
      float* dwl = dwsm + net.dw_off[l];
      for (int i = tid; i < din * groups; i += kBwdThreads) {
        const int k = i / groups;
        const int c = (i - k * groups) * 4;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
        for (int r = 0; r < kTileRows; ++r) {
          const float h = hl[r * kLd + k];
          const float4 gv = *reinterpret_cast<const float4*>(gin + r * kLd + c);
          a0 = fmaf(h, gv.x, a0);
          a1 = fmaf(h, gv.y, a1);
          a2 = fmaf(h, gv.z, a2);
          a3 = fmaf(h, gv.w, a3);
        }
        float* d = dwl + k * dout + c;
        d[0] += a0;
        d[1] += a1;
        d[2] += a2;
        d[3] += a3;
      }
      // g <- round(g) W_l^T (masked by post[l] > 0 below the top layer); the
      // layer-0 product is dx, skipped when dx is not wanted
      if (l > 0 || dx != nullptr) {
        for (int i = tid; i < kTileRows * din; i += kBwdThreads) {
          const int r = i / din;
          const int k = i - r * din;
          const float* gr = gin + r * kLd;
          const float* wr = wl + k * ld;
          float a = 0.f;
#pragma unroll 4
          for (int c = 0; c < dout; c += 4) {
            const float4 gv = *reinterpret_cast<const float4*>(gr + c);
            const float4 wv = *reinterpret_cast<const float4*>(wr + c);
            a = fmaf(Io<T>::round(gv.x), wv.x, a);
            a = fmaf(Io<T>::round(gv.y), wv.y, a);
            a = fmaf(Io<T>::round(gv.z), wv.z, a);
            a = fmaf(Io<T>::round(gv.w), wv.w, a);
          }
          if (l > 0) {
            gout[r * kLd + k] = a * (hl[r * kLd + k] > 0.f ? 1.f : 0.f);
          } else {
            const long long row = row0 + r;
            if (row < m) Io<T>::store(dx, row * d_in + k, a);
          }
        }
      }
      __syncthreads();
      float* t = gin;
      gin = gout;
      gout = t;
    }
  }

  __syncthreads();
  float* out = partial + (long long)blockIdx.x * net.dw_floats;
  for (int i = tid; i < net.dw_floats; i += kBwdThreads) out[i] = dwsm[i];
}

// dw[j] = sum over CTAs b, in order, of partial[b, j], cast to T
template <typename T>
__global__ void fused_mlp_bwd_reduce_kernel(const float* __restrict__ partial, int n_parts,
                                            int n_cols, T* __restrict__ dw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_cols) return;
  float s = 0.f;
  for (int b = 0; b < n_parts; ++b) s += partial[(long long)b * n_cols + j];
  Io<T>::store(dw, j, s);
}

template <typename T>
int bwd_ctas(const BwdNet& net, long long m, int* ctas) {
  const size_t smem = bwd_smem_floats(net.w_floats, net.dw_floats, net.n_layers) * sizeof(float);
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return int(err);
  if (smem > size_t(max_smem)) return -2;
  if ((err = cudaFuncSetAttribute(fused_mlp_bwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))) !=
      cudaSuccess)
    return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_kernel<T>,
                                                           kBwdThreads, smem)) != cudaSuccess)
    return int(err);
  const long long n_tiles = (m + kTileRows - 1) / kTileRows;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) grid = 1;
  *ctas = int(grid);
  return 0;
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, void* dw, float* partial, int ctas,
               const BwdNet& net, long long m, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(net.w_floats, net.dw_floats, net.n_layers) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  fused_mlp_bwd_kernel<T><<<unsigned(ctas), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), partial, net, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int threads = 256;
  const int blocks = (net.dw_floats + threads - 1) / threads;
  fused_mlp_bwd_reduce_kernel<T><<<blocks, threads, 0, stream>>>(partial, ctas, net.dw_floats,
                                                                 static_cast<T*>(dw));
  return int(cudaGetLastError());
}

int make_net(const void* const* weights, const int* widths, int n_layers, Net* net) {
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  int off = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] <= 0 || widths[i] % 16 != 0 || widths[i] > kMaxWidth) return -1;
    net->width[i] = widths[i];
  }
  for (int i = 0; i < n_layers; ++i) {
    net->w[i] = weights ? weights[i] : nullptr;
    net->w_off[i] = off;
    off += widths[i] * widths[i + 1];
  }
  net->n_layers = n_layers;
  net->w_floats = off;
  return 0;
}

int make_bwd_net(const void* const* weights, const int* widths, int n_layers, BwdNet* net) {
  Net fwd;
  if (make_net(weights, widths, n_layers, &fwd) != 0) return -1;
  int off = 0, dw_off = 0;
  for (int i = 0; i <= n_layers; ++i) net->width[i] = widths[i];
  for (int i = 0; i < n_layers; ++i) {
    net->w[i] = fwd.w[i];
    net->w_ld[i] = widths[i + 1] + 4;
    net->w_off[i] = off;
    net->dw_off[i] = dw_off;
    off += widths[i] * net->w_ld[i];
    dw_off += widths[i] * widths[i + 1];
  }
  net->n_layers = n_layers;
  net->w_floats = off;
  net->dw_floats = dw_off;
  return 0;
}

}  // namespace

// Returns 0 on success, a cudaError_t code on a CUDA failure, or -1 when the
// arguments are outside what the kernel takes (the Python wrapper checks them
// first). dtype: 0 = float32, 1 = bfloat16. weights[i] is [widths[i],
// widths[i+1]] row-major; x is [m, widths[0]], y is [m, widths[n_layers]].
extern "C" int fused_mlp_fwd(const void* x, void* y, const void* const* weights,
                             const int* widths, int n_layers, long long m, int dtype,
                             void* stream) {
  Net net;
  if (m < 0 || make_net(weights, widths, n_layers, &net) != 0) return -1;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, net, m, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, net, m, s);
  return -1;
}

// The number of CTAs fused_mlp_bwd launches for m rows: the rows of the
// partial-dW workspace the caller allocates. Returns 0 and sets *ctas, a
// cudaError_t code, -1 for arguments the kernel does not take, or -2 when
// the layer chain needs more shared memory than a CTA can have.
extern "C" int fused_mlp_bwd_ctas(const int* widths, int n_layers, long long m, int dtype,
                                  int* ctas) {
  BwdNet net;
  if (m < 1 || make_bwd_net(nullptr, widths, n_layers, &net) != 0) return -1;
  if (dtype == 0) return bwd_ctas<float>(net, m, ctas);
  if (dtype == 1) return bwd_ctas<__nv_bfloat16>(net, m, ctas);
  return -1;
}

// Backward of fused_mlp_fwd for m >= 1 rows. g is dL/dy [m, widths[n_layers]]
// in the input dtype; dx [m, widths[0]] may be null (not wanted); dw receives
// every layer's dW, concatenated row-major in layer order, in the input
// dtype; partial is a [ctas, sum_i widths[i]*widths[i+1]] f32 workspace with
// ctas from fused_mlp_bwd_ctas. Return codes as fused_mlp_bwd_ctas.
extern "C" int fused_mlp_bwd(const void* x, const void* g, void* dx, void* dw, float* partial,
                             int ctas, const void* const* weights, const int* widths,
                             int n_layers, long long m, int dtype, void* stream) {
  BwdNet net;
  if (m < 1 || ctas < 1 || make_bwd_net(weights, widths, n_layers, &net) != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, g, dx, dw, partial, ctas, net, m, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(x, g, dx, dw, partial, ctas, net, m, s);
  return -1;
}
