// Gather and scatter-add rate probes for Hopper (sm_90a): the counterparts of
// the Pallas TPU probe kernels under scripts/probe_r2*.py, which measured how
// fast a TPU gathers and scatter-adds the grid encode's table rows. Each kernel
// here is the simple Hopper form of one operation those probes time; the
// unroll, chunking and bisection variants of the TPU kernels were ways through
// one compiler and have no counterpart.
//
//   gather_rows       out[i, :] = tab[idx[i], :]  (f32 or bf16; any dtype whose
//                     row is a whole number of 16-byte vectors).
//                     Replaces k_sub_gather, k_ds_loop, make_onehot_gather
//                     (probe_r2_pallas.py:83,108,138), k_dyn_gather,
//                     k_gather_rate (probe_r2b_kernel.py:60,87), k_g1, k_g8,
//                     k_g8t, k_g1b (probe_r2c_rates.py:41,62,85,162), k_gather
//                     (probe_r2d_chunked.py:46), gather_kernel/probe_A-D
//                     (probe_r2e_bisect.py).
//   gather_lanes      out[r, k] = tab[r, idx[r, k]]  (take_along_axis, axis 1).
//                     Replaces k_lane_gather, k_lane_gather_big
//                     (probe_r2_pallas.py:38,62).
//   scatter_add_rows  out[idx[i], :] += val[i, :]  (f32, 16-byte atomics).
//                     Replaces k_dyn_scatter, k_scatter_rate
//                     (probe_r2b_kernel.py:115,141), k_s1, k_s8
//                     (probe_r2c_rates.py:113,135), k_scatter
//                     (probe_r2d_chunked.py:126), probe_F/k_rmw
//                     (probe_r2e_bisect.py:121), k_s (probe_r2f_scale.py:111).
//   smem_scratch      the largest scratch a block can hold: n bytes of dynamic
//                     shared memory; writes the first and last 128-float rows
//                     and returns the sum of their first elements (2). The
//                     card's analogue of k_cap's VMEM scratch
//                     (probe_r2b_kernel.py:36).
//
// What bounds them: the gathers and the scatter-add move whole rows, so they
// are bound by the random-access rate of L2 and device memory (the 4 MB
// table of the probes lies in the 50 MB L2); each thread moves one 16-byte
// vector, so a warp reads or writes 512 contiguous bytes of one row or two.
// The scatter-add uses Hopper's 16-byte float4 atomicAdd on global memory.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (ops/cuda/_build.py). Plain C entry points,
//             loaded with ctypes by ops/cuda/grid_probe.py.
//
// An index outside the table leaves its output row (or lane) zero in the
// gathers and adds nothing in the scatter; the plain versions raise instead.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kScratchThreads = 128;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ tab, const int* __restrict__ idx,
                   uint4* __restrict__ out, long long total, int vecs, int rows) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long i = t / vecs;
  const int v = int(t - i * vecs);
  const int r = __ldg(idx + i);
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (r >= 0 && r < rows) val = __ldg(tab + (long long)r * vecs + v);
  out[t] = val;
}

__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                    float* __restrict__ out, long long total, int k, int cols) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long r = t / k;
  const int c = __ldg(idx + t);
  out[t] = (c >= 0 && c < cols) ? __ldg(tab + r * cols + c) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const int* __restrict__ idx, const float4* __restrict__ val,
                        float4* __restrict__ out, long long total, int vecs, int rows) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long i = t / vecs;
  const int v = int(t - i * vecs);
  const int r = __ldg(idx + i);
  if (r >= 0 && r < rows) atomicAdd(out + (long long)r * vecs + v, __ldg(val + t));
}

__global__ void __launch_bounds__(kScratchThreads)
smem_scratch_kernel(float* __restrict__ out, int rows) {
  extern __shared__ float scratch[];
  const int t = threadIdx.x;
  scratch[t] = 1.f;
  scratch[(rows - 1) * kScratchThreads + t] = 1.f;
  __syncthreads();
  if (t == 0) out[0] = scratch[0] + scratch[(rows - 1) * kScratchThreads];
}

unsigned blocks_for(long long total) { return unsigned((total + kThreads - 1) / kThreads); }

}  // namespace

// Each entry point returns 0 on success, a cudaError_t code on a CUDA failure,
// or -1 for arguments outside what the kernel takes (the Python wrapper
// checks them first). Pointers are device pointers; idx is int32.

// tab [rows, vecs * 16 bytes], idx [n], out [n, vecs * 16 bytes]
extern "C" int gather_rows(const void* tab, const int* idx, void* out, long long n, int vecs,
                           int rows, void* stream) {
  if (n < 0 || vecs < 1 || rows < 1 || n > LLONG_MAX / vecs) return -1;
  const long long total = n * vecs;
  if (total == 0) return 0;
  if (blocks_for(total) > unsigned(INT_MAX)) return -1;
  gather_rows_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), idx, static_cast<uint4*>(out), total, vecs, rows);
  return int(cudaGetLastError());
}

// tab [r, cols] f32, idx [r, k], out [r, k] f32
extern "C" int gather_lanes(const float* tab, const int* idx, float* out, long long r, int k,
                            int cols, void* stream) {
  if (r < 0 || k < 1 || cols < 1 || r > LLONG_MAX / k) return -1;
  const long long total = r * k;
  if (total == 0) return 0;
  if (blocks_for(total) > unsigned(INT_MAX)) return -1;
  gather_lanes_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, idx, out, total, k, cols);
  return int(cudaGetLastError());
}

// idx [n], val [n, 4 * vecs] f32, out [rows, 4 * vecs] f32 (added into)
extern "C" int scatter_add_rows(const int* idx, const float* val, float* out, long long n,
                                int vecs, int rows, void* stream) {
  if (n < 0 || vecs < 1 || rows < 1 || n > LLONG_MAX / vecs) return -1;
  const long long total = n * vecs;
  if (total == 0) return 0;
  if (blocks_for(total) > unsigned(INT_MAX)) return -1;
  scatter_add_rows_kernel<<<blocks_for(total), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      idx, reinterpret_cast<const float4*>(val), reinterpret_cast<float4*>(out), total, vecs,
      rows);
  return int(cudaGetLastError());
}

// out [1] f32; bytes a multiple of 512 (one 128-float row). A size above
// what a block may have is refused by cudaFuncSetAttribute: its error is
// returned, and cleared so that it does not surface at a later launch. The
// attribute is set only when a size above the largest granted so far on this
// device is asked for, so that repeated launches (a CUDA graph's capture
// among them) make no other call than the launch.
extern "C" int smem_scratch(float* out, long long bytes, void* stream) {
  constexpr int kMaxDevices = 64;
  static int granted[kMaxDevices] = {};
  if (bytes < 512 || bytes % 512 != 0 || bytes > INT_MAX) return -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return err != cudaSuccess ? int(err) : -1;
  if (bytes > granted[dev]) {
    err = cudaFuncSetAttribute(smem_scratch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return int(err);
    }
    granted[dev] = int(bytes);
  }
  smem_scratch_kernel<<<1, kScratchThreads, size_t(bytes), static_cast<cudaStream_t>(stream)>>>(
      out, int(bytes / 512));
  err = cudaGetLastError();
  return int(err);
}

extern "C" const char* grid_probe_error_string(int code) {
  return code == -1 ? "arguments outside what the kernel takes"
                    : cudaGetErrorString(static_cast<cudaError_t>(code));
}
