// The NGP compositor for Hopper (sm_90a), for
// render/ngp_render.py::composite_marched on CUDA tensors, and its backward.
//
// It replaces no Pallas kernel: the JAX package composites in XLA
// (myc_nerfs_tpu/render/composite.py::composite_weights, composite_rgb). The
// port's plain version (ngp_render.py::composite_marched_plain) runs it as
// ~28 eager torch ops per call over [N, K] f32 intermediates (the
// activations, the masked optical depth, an exclusive scan through a
// concatenation, the early stop, four reductions and valid.sum()), and
// autograd records ~40 nodes for its backward; on a 4096-ray render chunk
// their launches, not their device time, held the host. One launch here
// computes the same NGPRenderOut, and one more its gradient to raw.
//
// What it computes, per ray of K samples (composite_marched_plain's steps):
// - sigma = exp(min(raw_d, 30)), colour c = sigmoid(raw_rgb);
// - sd = sigma * dt where valid, else 0;
// - T_i = exp(-S_i), S_i the exclusive prefix sum of sd (not a running
//   product of 1 - alpha, so the early stop decides as the plain version);
// - w_i = T_i * (1 - exp(-sd_i)) where T_i > eps and valid, else 0;
// - T_left = clamp(1 - sum w, 0, 1) (NaN passes, as torch.clamp's);
// - rgb = sum w c + T_left * bg, depth = sum w t, opacity = 1 - T_left.
// A ray leaves its loop over 32-sample chunks once exp(-S) after a chunk is
// at most eps / 2: every later S is no smaller, so every later weight is 0.
//
// The backward (ngp_composite_bwd_kernel) is the VJP to raw, dt and t of the
// above, as autograd differentiates the plain version, given the gradients
// of rgb, depth and opacity (each may be null: zero):
// - g_W = -(g_rgb . bg - g_opacity) where 0 <= 1 - W <= 1, else 0 (clamp's
//   derivative passes at its bounds);
// - per sample gw_i = g_rgb . c_i + g_depth * t_i + g_W;
// - g_sd_j = gw_j * T_j * exp(-sd_j) where T_j > eps and valid, minus
//   sum_{i > j} gw_i * w_i (T_i depends on every earlier sd);
// - g_raw_d = (g_sd * dt where valid) * exp(clamp(raw_d, -15, 15)), the
//   reference's clamped density derivative (models/ngp.py::
//   _DensityActivation), and g_raw_rgb = (g_rgb * w) * (1 - c) * c;
// - g_dt = g_sd * sigma where valid, else 0, and g_t = g_depth * w (test-
//   time pose optimisation carries them on through the march's backward).
// The background's gradient, T_left * g_rgb, is the wrapper's.
// It saves nothing from the forward: pass 1 recomputes each chunk's S
// before it (kept in shared memory) and W, pass 2 walks the chunks
// backwards with the same arithmetic, so T and every mask equal the
// forward's, and sums the suffix of gw * w by reverse warp scans.
//
// Exactness. Sums run in another order than torch's (a warp scan for S, lane
// partials and a butterfly for the reductions), so outputs equal the plain
// version's to rounding, not bit for bit; a ray whose T lies within that
// rounding of eps at some sample may keep or drop that sample's weight on
// one side only (tests/test_torch_cuda_composite.py finds such rays).
//
// What bounds it on this card: nothing here is heavy. Per sample it reads
// raw (16 bytes, one 16-byte load a lane), dt, t and valid (9; a dt
// broadcast over the samples is one address), and per ray it writes 20
// bytes: ~6.5 MB for a 4096-ray x 64-sample chunk, ~2 us at 3.35 TB/s; the
// launch is what mattered.
//
// The design: one warp per ray, as csrc/march.cu: sample k = chunk * 32 +
// lane, so a warp's raw loads cover 512 contiguous bytes; the exclusive
// prefix is a Hillis-Steele scan over the warp (shuffles at 1, 2, 4, 8,
// 16) plus the chunks before; the sums are lane partials reduced by xor
// shuffles. Rays past N leave as a whole warp, so every shuffle has its
// full warp.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (ops/cuda/_build.py). Plain C entry points,
//             loaded with ctypes by ops/cuda/composite.py.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "error_text.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;                 // rays per CTA
constexpr int kThreads = kWarp * kWarps;
constexpr int kSmemCap = 48 * 1024;       // the backward's chunk prefixes, at most
constexpr unsigned kFull = 0xffffffffu;

// The inputs: raw [n, k, 4] f32 contiguous; dt, t [n, k] f32 and valid
// [n, k] bool at element strides (row, col); bg [n, 3] f32 at (row, col)
// (row 0: one colour for every ray).
struct Inputs {
  const float4* raw;
  const float* dt;
  long long dt_r, dt_c;
  const float* t;
  long long t_r, t_c;
  const unsigned char* valid;
  long long v_r, v_c;
  const float* bg;
  long long bg_r, bg_c;
  float eps;
  long long n;
  int k;
};

// one sample's forward quantities
struct Sample {
  bool v, m;     // valid; weighted (valid and T > eps)
  float dt, t;
  float raw_d;
  float sigma;
  float sd;      // masked optical depth
  float T, e;    // exp(-S), exp(-sd)
  float w;
  float3 c;
};

__device__ __forceinline__ float min_nan(float x, float hi) { return x != x ? x : fminf(x, hi); }

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// sum of x over lanes 0..lane
__device__ __forceinline__ float scan_inclusive(float x, int lane) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// sum of x over lanes lane..31
__device__ __forceinline__ float scan_suffix(float x, int lane) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float y = __shfl_down_sync(kFull, x, o);
    if (lane + o < kWarp) x += y;
  }
  return x;
}

__device__ __forceinline__ bool valid_at(const Inputs& a, long long ray, int k) {
  return a.valid[ray * a.v_r + k * a.v_c] != 0;
}

// The chunk of samples base + lane (the whole warp calls it): its samples'
// quantities, S taken as carry (the optical depth of the chunks before) plus
// the exclusive scan. Returns the chunk's optical depth, in every lane.
__device__ __forceinline__ float chunk(const Inputs& a, long long ray, int base, int lane,
                                       float carry, Sample& s) {
  const int k = base + lane;
  const bool in = k < a.k;
  const float4 r = in ? a.raw[ray * a.k + k] : make_float4(0.f, 0.f, 0.f, 0.f);
  s.v = in && valid_at(a, ray, k);
  s.dt = in ? a.dt[ray * a.dt_r + k * a.dt_c] : 0.f;
  s.t = in ? a.t[ray * a.t_r + k * a.t_c] : 0.f;
  s.raw_d = r.w;
  s.sigma = expf(min_nan(r.w, 30.f));
  s.sd = s.v ? s.sigma * s.dt : 0.f;
  const float incl = scan_inclusive(s.sd, lane);
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  s.T = expf(-(carry + excl));
  s.e = expf(-s.sd);
  s.m = s.v && s.T > a.eps;
  s.w = s.m ? s.T * (1.f - s.e) : 0.f;
  s.c = make_float3(sigmoid(r.x), sigmoid(r.y), sigmoid(r.z));
  return __shfl_sync(kFull, incl, kWarp - 1);
}

// after a chunk whose S ends at carry: no later sample can have T > eps
__device__ __forceinline__ bool spent(const Inputs& a, float carry) {
  return expf(-carry) <= 0.5f * a.eps;
}

__device__ __forceinline__ float3 bg_of(const Inputs& a, long long ray) {
  const float* b = a.bg + ray * a.bg_r;
  return make_float3(b[0], b[a.bg_c], b[2 * a.bg_c]);
}

// one warp per ray: rgb [n, 3], depth [n], opacity [n]
__global__ void __launch_bounds__(kThreads)
    ngp_composite_fwd_kernel(Inputs a, float* __restrict__ rgb, float* __restrict__ depth,
                             float* __restrict__ opacity) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long ray = (long long)blockIdx.x * kWarps + warp;
  if (ray >= a.n) return;
  float carry = 0.f, sr = 0.f, sg = 0.f, sb = 0.f, st = 0.f, sw = 0.f;
  for (int base = 0; base < a.k; base += kWarp) {
    Sample s;
    carry += chunk(a, ray, base, lane, carry, s);
    sr += s.w * s.c.x;
    sg += s.w * s.c.y;
    sb += s.w * s.c.z;
    st += s.w * s.t;
    sw += s.w;
    if (spent(a, carry)) break;
  }
  sr = warp_sum(sr);
  sg = warp_sum(sg);
  sb = warp_sum(sb);
  st = warp_sum(st);
  sw = warp_sum(sw);
  if (lane == 0) {
    const float t_left = clamp_nan(1.f - sw, 0.f, 1.f);
    const float3 b = bg_of(a, ray);
    rgb[3 * ray] = sr + t_left * b.x;
    rgb[3 * ray + 1] = sg + t_left * b.y;
    rgb[3 * ray + 2] = sb + t_left * b.z;
    depth[ray] = st;
    opacity[ray] = 1.f - t_left;
  }
}

// one warp per ray: g_raw [n, k, 4], g_dt and g_t [n, k] contiguous, each
// or null (not wanted); g_rgb [n, 3], g_depth [n], g_opacity [n]
// contiguous, or null
__global__ void __launch_bounds__(kThreads)
    ngp_composite_bwd_kernel(Inputs a, const float* __restrict__ g_rgb,
                             const float* __restrict__ g_depth,
                             const float* __restrict__ g_opacity, float4* __restrict__ g_raw,
                             float* __restrict__ g_dt, float* __restrict__ g_t) {
  extern __shared__ float prefix_smem[];  // [kWarps][chunks]: S before each chunk
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long ray = (long long)blockIdx.x * kWarps + warp;
  if (ray >= a.n) return;
  const int chunks = (a.k + kWarp - 1) / kWarp;
  float* before = prefix_smem + warp * chunks;

  // pass 1: the chunks' prefixes, W, and the chunks that carry weight
  float carry = 0.f, sw = 0.f;
  int live = 0;
  while (live < chunks) {
    if (lane == 0) before[live] = carry;
    Sample s;
    carry += chunk(a, ray, live * kWarp, lane, carry, s);
    sw += s.w;
    ++live;
    if (spent(a, carry)) break;
  }
  __syncwarp();
  sw = warp_sum(sw);

  const float3 gr = g_rgb ? make_float3(g_rgb[3 * ray], g_rgb[3 * ray + 1], g_rgb[3 * ray + 2])
                          : make_float3(0.f, 0.f, 0.f);
  const float gd = g_depth ? g_depth[ray] : 0.f;
  const float go = g_opacity ? g_opacity[ray] : 0.f;
  const float3 b = bg_of(a, ray);
  const float one_minus = 1.f - sw;
  const float g_t_left = gr.x * b.x + gr.y * b.y + gr.z * b.z - go;
  const float g_w_sum = (one_minus >= 0.f && one_minus <= 1.f) ? -g_t_left : 0.f;

  // every gradient past the last chunk that carries weight is 0
  const long long row = ray * a.k;
  for (int k = live * kWarp + lane; k < a.k; k += kWarp) {
    if (g_raw) g_raw[row + k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g_dt) g_dt[row + k] = 0.f;
    if (g_t) g_t[row + k] = 0.f;
  }

  // pass 2, last chunk first: after = sum over later samples of gw * w
  float after = 0.f;
  for (int c = live - 1; c >= 0; --c) {
    Sample s;
    chunk(a, ray, c * kWarp, lane, before[c], s);
    const float gw = gr.x * s.c.x + gr.y * s.c.y + gr.z * s.c.z + gd * s.t + g_w_sum;
    const float suffix = scan_suffix(gw * s.w, lane);
    float later = __shfl_down_sync(kFull, suffix, 1);
    if (lane == kWarp - 1) later = 0.f;
    const float g_sd = (s.m ? gw * s.T * s.e : 0.f) - (later + after);
    const float g_sigma = s.v ? g_sd * s.dt : 0.f;
    const int k = c * kWarp + lane;
    if (k < a.k) {
      if (g_raw)
        g_raw[row + k] = make_float4((gr.x * s.w) * (1.f - s.c.x) * s.c.x,
                                     (gr.y * s.w) * (1.f - s.c.y) * s.c.y,
                                     (gr.z * s.w) * (1.f - s.c.z) * s.c.z,
                                     g_sigma * expf(clamp_nan(s.raw_d, -15.f, 15.f)));
      if (g_dt) g_dt[row + k] = s.v ? g_sd * s.sigma : 0.f;
      if (g_t) g_t[row + k] = gd * s.w;
    }
    after += __shfl_sync(kFull, suffix, 0);
  }
}

// -1 for what the kernels do not take: n < 0, k < 1, raw not 16-byte
// aligned, too many CTAs
int make_inputs(const float* raw, const float* dt, long long dt_r, long long dt_c,
                const float* t, long long t_r, long long t_c, const unsigned char* valid,
                long long v_r, long long v_c, const float* bg, long long bg_r, long long bg_c,
                float eps, long long n, int k, Inputs* a, unsigned* blocks) {
  if (n < 0 || k < 1 || reinterpret_cast<uintptr_t>(raw) % 16) return -1;
  const long long b = (n + kWarps - 1) / kWarps;
  if (b > INT_MAX) return -1;
  *blocks = unsigned(b);
  *a = Inputs{reinterpret_cast<const float4*>(raw), dt, dt_r, dt_c, t, t_r, t_c, valid,
              v_r, v_c, bg, bg_r, bg_c, eps, n, k};
  return 0;
}

}  // namespace

// Each returns 0 on success, a cudaError_t code on a CUDA failure, or -1 for
// arguments outside what the kernel takes. raw [n, k, 4] f32 is contiguous
// and 16-byte aligned device memory; dt, t [n, k] f32, valid [n, k] bool and
// bg [n, 3] f32 are device memory read at the element strides given (a
// stride may be 0: a value broadcast).

// rgb [n, 3], depth [n], opacity [n] f32 out
extern "C" int ngp_composite_fwd(const float* raw, const float* dt, long long dt_r,
                                 long long dt_c, const float* t, long long t_r, long long t_c,
                                 const unsigned char* valid, long long v_r, long long v_c,
                                 const float* bg, long long bg_r, long long bg_c, float eps,
                                 long long n, int k, float* rgb, float* depth, float* opacity,
                                 void* stream) {
  Inputs a;
  unsigned blocks;
  const int bad = make_inputs(raw, dt, dt_r, dt_c, t, t_r, t_c, valid, v_r, v_c, bg, bg_r,
                              bg_c, eps, n, k, &a, &blocks);
  if (bad || n == 0) return bad;
  ngp_composite_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, rgb, depth, opacity);
  return int(cudaGetLastError());
}

// g_raw [n, k, 4], g_dt and g_t [n, k] f32 contiguous out, each or null
// (not written); g_rgb [n, 3], g_depth [n], g_opacity [n] f32 contiguous,
// or null for a zero gradient
extern "C" int ngp_composite_bwd(const float* raw, const float* dt, long long dt_r,
                                 long long dt_c, const float* t, long long t_r, long long t_c,
                                 const unsigned char* valid, long long v_r, long long v_c,
                                 const float* bg, long long bg_r, long long bg_c, float eps,
                                 long long n, int k, const float* g_rgb, const float* g_depth,
                                 const float* g_opacity, float* g_raw, float* g_dt, float* g_t,
                                 void* stream) {
  Inputs a;
  unsigned blocks;
  const int bad = make_inputs(raw, dt, dt_r, dt_c, t, t_r, t_c, valid, v_r, v_c, bg, bg_r,
                              bg_c, eps, n, k, &a, &blocks);
  const long long smem = (long long)kWarps * ((k + kWarp - 1) / kWarp) * sizeof(float);
  if (bad || smem > kSmemCap || reinterpret_cast<uintptr_t>(g_raw) % 16) return -1;
  if (n == 0) return 0;
  ngp_composite_bwd_kernel<<<blocks, kThreads, size_t(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      a, g_rgb, g_depth, g_opacity, reinterpret_cast<float4*>(g_raw), g_dt, g_t);
  return int(cudaGetLastError());
}
