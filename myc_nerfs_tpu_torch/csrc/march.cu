// The fused NGP occupancy march for Hopper (sm_90a), for
// render/ngp_render.py::march_rays_fused on CUDA tensors, and its backward.
//
// It replaces no Pallas kernel: the JAX package computes the march in XLA
// (myc_nerfs_tpu/render/ngp_render.py::march_rays_fused). The port's plain
// version (ngp_render.py::march_rays_fused_plain) runs it as ~90 eager torch
// ops per call over [N, n_coarse] and [N, n_coarse, 3] f32 intermediates,
// with two scans, a searchsorted and a concatenation; on a 4096-ray render
// chunk its host time, not its device time, set the frame rate. One launch
// here computes the same MarchedRays.
//
// What it computes, per ray (the plain version's steps, in its order):
// - the cascade AABB's entry, clamped to near_distance, and exit; span, and
//   the coarse bin width wb = span / n_coarse;
// - n_coarse density-grid probes at tmin + span * (j + 0.5) / n_coarse: the
//   cascade from the position (floor(log2(max |p - 0.5|)) + 2, clamped), or
//   cascade 0 without mip math where aabb_scale == 1; the int cast truncates
//   toward zero, as grid_value_at does;
// - occupancy, value > min(mean_density, 0.01), mean_density read from
//   device memory;
// - the coarse optical depth of the occupied bins, sigma * wb, and its
//   exclusive prefix sum logT_prev; with trunc_eps > 0 a bin is live only
//   where logT_prev > log(f32 eps);
// - the live bins' inclusive counts c, n_occ, arc = n_occ * wb, and
//   dt = max(arc / K, calc_dt(tmin + span / 2)), both const_dt forms;
// - per sample k the arc rank r = (k + xi) * (dt * (1 / wb)), its bin (the
//   count of c <= r: searchsorted(right=True), here a binary search of the
//   same form over c in shared memory), t = tmin + (bin + frac(r)) * wb, the
//   re-probe, the AABB test, any_occ, r < n_occ and span > 0: valid;
// - the warp to [0, 1] of positions and directions.
//
// Exactness. Every decision (probe position, cascade, cell, occupancy bit,
// live count, r, bin, t, valid) equals the plain version's on CUDA tensors
// bit for bit: each torch op is one rounding, so the arithmetic here is
// written as separately rounded __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn,
// which nvcc never contracts into an FMA; log2f, exp2f and floorf are the
// functions torch's CUDA kernels call; min, max and clamp propagate NaN as
// torch's do. The scalars are the plain version's, rounded to f32 by the
// host as torch rounds them: torch on CUDA divides a tensor by a CPU scalar
// as a product with the scalar's f32 reciprocal (span / n_coarse,
// arc / K, (pos - lo) / (hi - lo)), so the host passes those reciprocals.
// The one sum whose order differs is the optical-depth prefix: here each lane
// sums its own bins left to right, the lanes' sums are combined by a
// Hillis-Steele scan over the warp (shuffles at distances 1, 2, 4, 8, 16),
// and a bin's prefix is its lane's exclusive prefix plus the lane's running
// sum before it; torch's CUDA cumsum adds in another tree. So a ray whose
// logT_prev lies within rounding of log(eps) at the bin where truncation
// starts may keep or drop that bin on one side only
// (tests/test_torch_cuda_march.py counts such rays). With trunc_eps == 0
// there is no truncation and every output is bit-equal.
//
// What bounds it on this card: per ray n_coarse + K scattered 4-byte reads
// of the density grid (5 cascades x 128^3 f32, 42 MB, under the 50 MB L2)
// behind a log2f each, two warp scans and K binary searches of log2(n_coarse)
// shared-memory steps; it writes 17 bytes per sample (~4.5 MB for a 4096-ray
// x 64-sample chunk, 1.3 us at 3.35 TB/s). It is bound by the latency of the
// dependent probe chain, not by bytes.
//
// The design: one warp per ray (a 4096-ray chunk is 4096 warps, where one
// thread per ray would give the card 4096 threads). Lane l takes the
// contiguous coarse bins [l * B, l * B + B), B = ceil(n_coarse / 32): it
// probes them first (independent loads, stored in its slice of the warp's
// shared-memory row), then walks them in order for the optical depth and the
// live counts. The warp's row of n_coarse floats (2 KB at 512) holds the
// probed values, then the inclusive live counts; the samples k = lane,
// lane + 32, ... each search it, and the warp stores consecutive samples'
// t and valid coalesced. Rays past N leave as a whole warp, so every shuffle
// has its full warp.
//
// The backward (march_rays_fused_bwd_kernel) carries the gradients of the
// positions, dirs, t and dt to rays_o, rays_d and xi, with every decision of
// the forward held fixed, as autograd differentiates the plain version: t =
// tmin + u * wb with u = bin + frac(r) (the forward saves u per sample, and
// n_occ per ray), r = (k + xi) * dt * (1 / wb), dt = max(n_occ * wb / K,
// calc_dt(tmin + span / 2)), wb = span / n_coarse, and tmin, tmax from the
// slabs. A tie in torch.minimum / maximum sends half the gradient each way,
// one in amax / amin splits it evenly, and clamp passes it at its bounds,
// as torch's derivatives do. One warp per ray: lanes take samples k = lane,
// lane + 32, ..., reduce their sums by shuffles, and lane 0 runs the ray's
// chain. Its sums are in another order than autograd's, so the gradient
// equals the plain version's to rounding, not bit for bit.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (ops/cuda/_build.py). Plain C entry points,
//             loaded with ctypes by ops/cuda/march.py, which passes March
//             as a ctypes.Structure of the same layout (MarchConstants).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "error_text.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;          // rays per CTA
constexpr int kSmemCap = 48 * 1024;   // a CTA's rows of n_coarse floats, at most
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// ops/cuda/march.py::MarchConstants, field for field
struct March {
  int n_coarse, n_samples, grid_size, n_cascades;
  int single_mip;  // aabb_scale == 1: cascade 0, no mip math
  int const_dt;
  int truncate;    // trunc_eps > 0
  float lo, hi, near;
  float inv_coarse;    // f32(1 / f32(n_coarse))
  float inv_samples;   // f32(1 / f32(K))
  float inv_extent;    // f32(1 / f32(hi - lo))
  float inv_min_cone;  // f32(1 / min_cone_stepsize)
  float dt_const;      // f32(min_stepsize * 0.5)
  float dt_min, dt_max;
  float cone;          // f32(cone_angle_constant)
  float log_eps;       // f32(log(f32(trunc_eps)))
};

namespace {

// torch.minimum / maximum / clamp on CUDA: NaN propagates (the first NaN
// operand is returned)
__device__ __forceinline__ float tmin_f(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax_f(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_f(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// ray_aabb_range: inv = 1 / where(d == 0, 1e-10, d), the slabs t1, t2, and
// the entry and exit before their clamps (raw_tmin, raw_tmax)
struct Slabs {
  float inv[3], t1[3], t2[3];
  float raw_tmin, raw_tmax;
};

__device__ __forceinline__ Slabs slabs(const float o[3], const float d[3], const March& m) {
  Slabs s;
  for (int a = 0; a < 3; ++a) {
    s.inv[a] = __fdiv_rn(1.0f, d[a] == 0.0f ? 1e-10f : d[a]);
    s.t1[a] = __fmul_rn(__fsub_rn(m.lo, o[a]), s.inv[a]);
    s.t2[a] = __fmul_rn(__fsub_rn(m.hi, o[a]), s.inv[a]);
    const float lo_a = tmin_f(s.t1[a], s.t2[a]), hi_a = tmax_f(s.t1[a], s.t2[a]);
    s.raw_tmin = a == 0 ? lo_a : tmax_f(s.raw_tmin, lo_a);
    s.raw_tmax = a == 0 ? hi_a : tmin_f(s.raw_tmax, hi_a);
  }
  return s;
}

// calc_dt at the middle of the span
__device__ __forceinline__ float dt_ref(float tmin, float span, const March& m) {
  const float t_mid = __fadd_rn(tmin, __fmul_rn(0.5f, span));
  return m.const_dt ? m.dt_const : clamp_f(__fmul_rn(t_mid, m.cone), m.dt_min, m.dt_max);
}

// occupancy.grid_value_at: the density grid's value at world position p
__device__ __forceinline__ float grid_value(const float* __restrict__ grid, float px, float py,
                                            float pz, const March& m) {
  const int G = m.grid_size;
  const float gf = float(G);
  int mip = 0;
  if (!m.single_mip) {
    // mip_from_pos: floor(log2(clamp_min(max |p - 0.5|, 1e-10))) + 1, to
    // int32 (truncating; NaN gives 0), + 1, clamped to the cascades
    const float ax = fabsf(__fsub_rn(px, 0.5f));
    const float ay = fabsf(__fsub_rn(py, 0.5f));
    const float az = fabsf(__fsub_rn(pz, 0.5f));
    const float mx = tmax_f(tmax_f(tmax_f(ax, ay), az), 1e-10f);
    const float e = __fadd_rn(floorf(log2f(mx)), 1.0f);
    const int ei = int(unsigned(int(e)) + 1u);  // torch's int32 add wraps
    mip = min(max(ei, 0), m.n_cascades - 1);
    const float scale = exp2f(-float(mip));
    px = __fadd_rn(__fmul_rn(__fsub_rn(px, 0.5f), scale), 0.5f);
    py = __fadd_rn(__fmul_rn(__fsub_rn(py, 0.5f), scale), 0.5f);
    pz = __fadd_rn(__fmul_rn(__fsub_rn(pz, 0.5f), scale), 0.5f);
  }
  const int ix = min(max(int(__fmul_rn(px, gf)), 0), G - 1);
  const int iy = min(max(int(__fmul_rn(py, gf)), 0), G - 1);
  const int iz = min(max(int(__fmul_rn(pz, gf)), 0), G - 1);
  const long long cell = ((long long)ix * G + iy) * G + iz;
  return __ldg(grid + (long long)mip * G * G * G + cell);
}

// out_u [n, K] (bin + frac(r) per sample) and out_n_occ [n] are written only
// where given: the backward's saved values
__global__ void __launch_bounds__(kMaxWarps * kWarp)
march_rays_fused_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                        const float* __restrict__ xi, const float* __restrict__ grid,
                        const float* __restrict__ mean_density, float* __restrict__ out_pos,
                        float* __restrict__ out_t, bool* __restrict__ out_valid,
                        float* __restrict__ out_dt, float* __restrict__ out_dirs,
                        float* __restrict__ out_u, float* __restrict__ out_n_occ,
                        const March m, long long n) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long ray = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (ray >= n) return;  // the whole warp
  const int Mc = m.n_coarse;
  float* c = rows + (size_t)warp * Mc;

  const float o[3] = {rays_o[3 * ray], rays_o[3 * ray + 1], rays_o[3 * ray + 2]};
  const float d[3] = {rays_d[3 * ray], rays_d[3 * ray + 1], rays_d[3 * ray + 2]};
  const float mean = *mean_density;
  const float thresh = mean != mean ? mean : fminf(mean, 0.01f);  // clamp_max(mean, 0.01)

  const Slabs s = slabs(o, d, m);
  const float tmin = tmax_f(s.raw_tmin, m.near);
  const float tmax = tmax_f(s.raw_tmax, tmin);
  const float span = __fsub_rn(tmax, tmin);
  const float wb = __fmul_rn(span, m.inv_coarse);

  // the coarse probes of this lane's bins, into its slice of the row
  const int per_lane = (Mc + kWarp - 1) / kWarp;
  const int b0 = min(lane * per_lane, Mc), b1 = min(b0 + per_lane, Mc);
#pragma unroll 4
  for (int j = b0; j < b1; ++j) {
    const float frac = __fmul_rn(__fadd_rn(float(j), 0.5f), m.inv_coarse);
    const float tc = __fadd_rn(tmin, __fmul_rn(span, frac));
    c[j] = grid_value(grid, __fadd_rn(o[0], __fmul_rn(d[0], tc)),
                      __fadd_rn(o[1], __fmul_rn(d[1], tc)),
                      __fadd_rn(o[2], __fmul_rn(d[2], tc)), m);
  }
  // occupied bins' optical depth where(occ, clamp_min(v, 0) * (1 / mcs) * wb, 0)
  auto depth = [&](float v) {
    const float sigma = __fmul_rn(v != v ? v : fmaxf(v, 0.0f), m.inv_min_cone);
    return v > thresh ? __fmul_rn(sigma, wb) : 0.0f;
  };
  float lane_sum = 0.0f;
  for (int j = b0; j < b1; ++j) lane_sum = __fadd_rn(lane_sum, depth(c[j]));
  // the lanes' exclusive prefix (Hillis-Steele over the lanes' sums)
  float incl = lane_sum;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(y, incl);
  }
  float before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) before = 0.0f;

  // live bins (occupied, and logT_prev > log eps where truncating), the
  // lane's inclusive live counts in place of the probed values
  int live = 0;
  float run = 0.0f;
  for (int j = b0; j < b1; ++j) {
    const float v = c[j];
    const float log_t_prev = -__fadd_rn(before, run);
    run = __fadd_rn(run, depth(v));
    live += (v > thresh) && (!m.truncate || log_t_prev > m.log_eps);
    c[j] = float(live);
  }
  int live_incl = live;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, live_incl, off);
    if (lane >= off) live_incl += y;
  }
  const float live_before = float(live_incl - live);
  for (int j = b0; j < b1; ++j) c[j] = c[j] + live_before;  // exact: counts < 2^24
  const float n_occ = float(__shfl_sync(kFull, live_incl, kWarp - 1));
  __syncwarp();

  // the step and the placement
  const float arc = __fmul_rn(n_occ, wb);
  const float dt = tmax_f(__fmul_rn(arc, m.inv_samples), dt_ref(tmin, span, m));
  const bool hit = span > 0.0f;
  const bool any_occ = n_occ > 0.0f;
  const float inv_wb = hit ? __fdiv_rn(1.0f, wb) : 0.0f;
  const float step = __fmul_rn(dt, inv_wb);
  const float x = xi != nullptr ? xi[ray] : 0.5f;
  const float lo = m.lo, hi = m.hi;
  const long long first = ray * m.n_samples;
  for (int k = lane; k < m.n_samples; k += kWarp) {
    const float r = __fmul_rn(__fadd_rn(float(k), x), step);
    // searchsorted(c, r, right=True): torch's upper_bound
    int lo_b = 0, hi_b = Mc;
    while (lo_b < hi_b) {
      const int mid = lo_b + ((hi_b - lo_b) >> 1);
      if (!(c[mid] > r)) lo_b = mid + 1;
      else hi_b = mid;
    }
    const float u = __fadd_rn(float(lo_b), __fsub_rn(r, floorf(r)));
    const float t = __fadd_rn(tmin, __fmul_rn(u, wb));
    const float px = __fadd_rn(o[0], __fmul_rn(d[0], t));
    const float py = __fadd_rn(o[1], __fmul_rn(d[1], t));
    const float pz = __fadd_rn(o[2], __fmul_rn(d[2], t));
    const bool inbox = px >= lo && px <= hi && py >= lo && py <= hi && pz >= lo && pz <= hi;
    const bool valid = grid_value(grid, px, py, pz, m) > thresh && inbox && any_occ &&
                       r < n_occ && hit;
    const long long i = first + k;
    out_t[i] = t;
    out_valid[i] = valid;
    out_pos[3 * i] = clamp_f(__fmul_rn(__fsub_rn(px, lo), m.inv_extent), 0.0f, 1.0f);
    out_pos[3 * i + 1] = clamp_f(__fmul_rn(__fsub_rn(py, lo), m.inv_extent), 0.0f, 1.0f);
    out_pos[3 * i + 2] = clamp_f(__fmul_rn(__fsub_rn(pz, lo), m.inv_extent), 0.0f, 1.0f);
    if (out_u != nullptr) out_u[i] = u;
  }
  if (lane == 0) {
    out_dt[ray] = dt;
    if (out_n_occ != nullptr) out_n_occ[ray] = n_occ;
  }
  if (lane < 3)
    out_dirs[3 * ray + lane] = __fmul_rn(__fadd_rn(rays_d[3 * ray + lane], 1.0f), 0.5f);
}

// the share of a gradient that torch.maximum(a, b) sends to a
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.0f : (a < b ? 0.0f : 0.5f);
}

// g_pos [n, K, 3], g_t [n, K], g_dt [n] and g_dirs [n, 3] in; g_o, g_d [n, 3]
// and g_xi [n] (written only where given) out
__global__ void __launch_bounds__(kMaxWarps * kWarp)
march_rays_fused_bwd_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                            const float* __restrict__ xi, const float* __restrict__ t_in,
                            const float* __restrict__ u_in, const float* __restrict__ dt_in,
                            const float* __restrict__ n_occ_in, const float* __restrict__ g_pos,
                            const float* __restrict__ g_t, const float* __restrict__ g_dt,
                            const float* __restrict__ g_dirs, float* __restrict__ g_o,
                            float* __restrict__ g_d, float* __restrict__ g_xi, const March m,
                            long long n) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long ray = (long long)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (ray >= n) return;  // the whole warp

  const float o[3] = {rays_o[3 * ray], rays_o[3 * ray + 1], rays_o[3 * ray + 2]};
  const float d[3] = {rays_d[3 * ray], rays_d[3 * ray + 1], rays_d[3 * ray + 2]};
  const Slabs s = slabs(o, d, m);
  const float tmin = tmax_f(s.raw_tmin, m.near);
  const float tmax = tmax_f(s.raw_tmax, tmin);
  const float span = __fsub_rn(tmax, tmin);
  const float wb = __fmul_rn(span, m.inv_coarse);
  const float dt = dt_in[ray];
  const bool hit = span > 0.0f;
  const float inv_wb = hit ? __fdiv_rn(1.0f, wb) : 0.0f;
  const float x = xi != nullptr ? xi[ray] : 0.5f;

  // per sample: the position's gradient (through the [0, 1] clamp) to o, d
  // and t; then t's to tmin, wb and r: sum G, sum G u, sum G (k + xi)
  float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
  float sum_g = 0.0f, sum_gu = 0.0f, sum_gk = 0.0f;
  const long long first = ray * m.n_samples;
  for (int k = lane; k < m.n_samples; k += kWarp) {
    const long long i = first + k;
    const float t = t_in[i];
    float g = g_t[i];
    for (int a = 0; a < 3; ++a) {
      const float p = __fadd_rn(o[a], __fmul_rn(d[a], t));
      const float w = __fmul_rn(__fsub_rn(p, m.lo), m.inv_extent);
      const float gp = (w >= 0.0f && w <= 1.0f) ? g_pos[3 * i + a] * m.inv_extent : 0.0f;
      go[a] += gp;
      gd[a] += gp * t;
      g += gp * d[a];
    }
    sum_g += g;
    sum_gu += g * u_in[i];
    sum_gk += g * (float(k) + x);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    for (int a = 0; a < 3; ++a) {
      go[a] += __shfl_xor_sync(kFull, go[a], off);
      gd[a] += __shfl_xor_sync(kFull, gd[a], off);
    }
    sum_g += __shfl_xor_sync(kFull, sum_g, off);
    sum_gu += __shfl_xor_sync(kFull, sum_gu, off);
    sum_gk += __shfl_xor_sync(kFull, sum_gk, off);
  }
  if (lane != 0) return;

  // r = (k + xi) * step, step = dt * inv_wb, inv_wb = 1 / wb (where hit)
  const float g_step = wb * sum_gk;
  float g_dt_all = g_dt[ray] + g_step * inv_wb;
  float g_wb = sum_gu - (hit ? g_step * dt * inv_wb * inv_wb : 0.0f);
  float g_tmin = sum_g, g_span = 0.0f;
  // dt = maximum(n_occ * wb / K, calc_dt(tmin + span / 2))
  const float n_occ = n_occ_in[ray];
  const float ref = dt_ref(tmin, span, m);
  const float share = max_share(__fmul_rn(__fmul_rn(n_occ, wb), m.inv_samples), ref);
  g_wb += n_occ * (g_dt_all * share * m.inv_samples);
  if (!m.const_dt) {
    const float cx = __fmul_rn(__fadd_rn(tmin, __fmul_rn(0.5f, span)), m.cone);
    if (cx >= m.dt_min && cx <= m.dt_max) {
      const float g_mid = g_dt_all * (1.0f - share) * m.cone;
      g_tmin += g_mid;
      g_span += 0.5f * g_mid;
    }
  }
  // wb = span / n_coarse, span = tmax - tmin, tmax = maximum(raw_tmax, tmin),
  // tmin = clamp_min(raw_tmin, near)
  g_span += g_wb * m.inv_coarse;
  g_tmin -= g_span;
  const float to_raw = max_share(s.raw_tmax, tmin);
  const float g_raw_tmax = g_span * to_raw;
  g_tmin += g_span * (1.0f - to_raw);
  const float g_raw_tmin = s.raw_tmin >= m.near ? g_tmin : 0.0f;
  // raw_tmin = amax(minimum(t1, t2)), raw_tmax = amin(maximum(t1, t2))
  int n_lo = 0, n_hi = 0;
  for (int a = 0; a < 3; ++a) {
    n_lo += tmin_f(s.t1[a], s.t2[a]) == s.raw_tmin;
    n_hi += tmax_f(s.t1[a], s.t2[a]) == s.raw_tmax;
  }
  for (int a = 0; a < 3; ++a) {
    float g1 = 0.0f, g2 = 0.0f;
    if (tmin_f(s.t1[a], s.t2[a]) == s.raw_tmin) {
      const float gl = g_raw_tmin / float(n_lo), to_t1 = max_share(s.t2[a], s.t1[a]);
      g1 += gl * to_t1;
      g2 += gl * (1.0f - to_t1);
    }
    if (tmax_f(s.t1[a], s.t2[a]) == s.raw_tmax) {
      const float gh = g_raw_tmax / float(n_hi), to_t1 = max_share(s.t1[a], s.t2[a]);
      g1 += gh * to_t1;
      g2 += gh * (1.0f - to_t1);
    }
    // t1 = (lo - o) * inv, t2 = (hi - o) * inv, inv = 1 / d where d != 0
    go[a] -= (g1 + g2) * s.inv[a];
    if (d[a] != 0.0f)
      gd[a] -= (g1 * (m.lo - o[a]) + g2 * (m.hi - o[a])) * s.inv[a] * s.inv[a];
    gd[a] += 0.5f * g_dirs[3 * ray + a];
    g_o[3 * ray + a] = go[a];
    g_d[3 * ray + a] = gd[a];
  }
  if (g_xi != nullptr) g_xi[ray] = sum_g * wb * __fmul_rn(dt, inv_wb);
}

bool outside(const March* m, long long n) {
  return m == nullptr || n < 0 || m->n_coarse < 1 || m->n_samples < 1 || m->grid_size < 1 ||
         m->n_cascades < 1 || (long long)m->n_coarse * 4 > kSmemCap ||
         n > LLONG_MAX / (3LL * m->n_samples);
}

}  // namespace

extern "C" int march_constants_size() { return int(sizeof(March)); }

// Returns 0 on success, a cudaError_t code on a CUDA failure, or -1 for
// arguments outside what the kernel takes (n_coarse above what a CTA's 48 KB
// of shared memory hold among them). rays_o, rays_d [n, 3], xi [n] (or
// null: 0.5), grid [n_cascades, G, G, G] and mean_density (one float) are f32
// device memory; the outputs are positions [n, K, 3], t [n, K], valid [n, K]
// (one byte each), dt [n] and dirs [n, 3], and where not null the
// backward's u [n, K] and n_occ [n].
extern "C" int march_rays_fused(const float* rays_o, const float* rays_d, const float* xi,
                                const float* grid, const float* mean_density, float* out_pos,
                                float* out_t, void* out_valid, float* out_dt, float* out_dirs,
                                float* out_u, float* out_n_occ, const March* m, long long n,
                                void* stream) {
  if (outside(m, n)) return -1;
  if (n == 0) return 0;
  int warps = kMaxWarps;
  while (warps > 1 && warps * m->n_coarse * 4 > kSmemCap) warps /= 2;
  const long long blocks = (n + warps - 1) / warps;
  if (blocks > INT_MAX) return -1;
  march_rays_fused_kernel<<<unsigned(blocks), warps * kWarp, size_t(warps) * m->n_coarse * 4,
                            static_cast<cudaStream_t>(stream)>>>(
      rays_o, rays_d, xi, grid, mean_density, out_pos, out_t, static_cast<bool*>(out_valid),
      out_dt, out_dirs, out_u, out_n_occ, *m, n);
  return int(cudaGetLastError());
}

// The backward: rays_o, rays_d, xi (or null) as the forward took them, its
// t [n, K], u [n, K], dt [n] and n_occ [n], and the gradients of its
// positions [n, K, 3], t [n, K], dt [n] and dirs [n, 3]; writes g_o and g_d
// [n, 3], and g_xi [n] where not null. Returns as march_rays_fused.
extern "C" int march_rays_fused_bwd(const float* rays_o, const float* rays_d, const float* xi,
                                    const float* t, const float* u, const float* dt,
                                    const float* n_occ, const float* g_pos, const float* g_t,
                                    const float* g_dt, const float* g_dirs, float* g_o,
                                    float* g_d, float* g_xi, const March* m, long long n,
                                    void* stream) {
  if (outside(m, n)) return -1;
  if (n == 0) return 0;
  const long long blocks = (n + kMaxWarps - 1) / kMaxWarps;
  if (blocks > INT_MAX) return -1;
  march_rays_fused_bwd_kernel<<<unsigned(blocks), kMaxWarps * kWarp, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      rays_o, rays_d, xi, t, u, dt, n_occ, g_pos, g_t, g_dt, g_dirs, g_o, g_d, g_xi, *m, n);
  return int(cudaGetLastError());
}
