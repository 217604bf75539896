// Lennard-Jones log-probability and closed-form force, one pass (K1, sm_90a).
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/lj.py:_lj_kernel
// (called from lj_log_prob_and_force, lj.py:79, pallas_call at :108). The
// function is the same:
//   E = energy_factor * sum_{i != j} eps*((rm/r)^12 - 2 (rm/r)^6)
//       + 0.5 * osc * sum_i |x_i - xbar|^2
// with an optional first-segment cubic spline below r_min, log_prob = -E/T,
// and force = -(4 * sum_j e'(r^2) (x_i - x_j) + osc (x_i - xbar)) / T.
//
// Two kernels. pita_lj_log_prob_and_force runs lj_pairs_kernel below, the
// one every caller gets. pita_lj_log_prob_and_force_scalar keeps the first
// version (lj_scalar_kernel, at the end of this file) as a yardstick only.
//
// What bounds it on the H100: at LJ55 a configuration is 55*54 ordered
// pairs of ~20 f32 instructions and one reciprocal each against 1.3 KB of
// coordinates in and out, so the work is f32 instructions; at the sampler's
// 256-2048 chains the whole launch is a few microseconds, so latency (warps
// in flight, dependent chains, barriers) and the launch's fixed part weigh
// as much as the issue rate. The first kernel gave each particle one thread
// and walked its 55 partners serially with an IEEE division, an IEEE sqrt
// and a divergent branch per pair, eight block barriers, and 64 threads per
// configuration (9 idle). The design here:
//  - L lanes per particle (L in {1, 2, 4, 8}, chosen by the wrapper from N
//    and B, pita_torch/ops/lj.py:lanes_per_particle: the fewest that put a
//    warp on every scheduler; chip_smoke.py phase 2 times every L beside
//    it): lane s of particle i takes the partners j = i + k,
//    k = 1 + s + m*L, from a doubled copy of the configuration in shared
//    memory, so no lane meets its diagonal and none needs a mask; only the
//    last partner of a lane can be missing, and that one is a select. The
//    L partial sums meet by shuffles. A configuration's group is N*L lanes
//    rounded up to a power of two (N*L <= 32: several configurations share
//    a warp, as LJ13 does) or to whole warps. The block is (group,
//    configurations), so no index needs a division.
//  - 1/r^2 by one rcp.approx.ftz (one SFU operation, relative error at most
//    2^-23); coordinates are staged divided by rm, so (rm/r)^2 is that
//    reciprocal itself, and eps, energy_factor, 1/T and rm are folded into
//    the packed constants (ops/lj.py:pack_params). The r^-12 term carries
//    six times the reciprocal's error, ~7e-7 relative, inside the GPU test's
//    1e-5 and chip_smoke.py's TOL_LJ = 2e-4.
//  - Four pairs in flight per lane (kUnroll); with the spline one warp vote
//    per four pairs asks whether any lane's pair lies below r_min, and only
//    then does the warp compute r (rsqrt.approx) and the cubic for them and
//    select. The branch is uniform across the warp, so no lane diverges;
//    pairs below r_min are rare on the sampler's data. ptxas: 32 registers
//    without the spline, 57 with it, no spills; ~22 instructions a pair.
//  - The centre of mass and the energy come from shuffle sums; the
//    oscillator's sum |x_i - xbar|^2 is taken as sum |u_i|^2 - |sum u_i|^2/N
//    with u_i = x_i - x_0, so it needs no second pass once xbar is known.
//    Two block barriers in all (staging, warp partials), and none for a
//    group of one warp or less.
//  - What holds it now (chip_smoke.py phase 2 prints the numbers): the
//    launch and the fixed part of a configuration (staging, shuffles, the
//    stores), which LJ13 pays at every batch, then the pair loop at about
//    half the issue rate. Not shared memory: four pairs issue ~90
//    instructions against four loads of at most four wavefronts each, and
//    lanes that all read one partner (one wavefront, a select on the
//    diagonal) were no faster when tried; nor were eight pairs in flight.
//  - Each unordered pair is computed twice, once from each end. Taking it
//    once leaves the reaction force on j to be summed without atomics (two
//    launches must stay bitwise equal): a slot per (offset, particle) in
//    shared memory, 27 x 55 x 3 floats (18 KB) a configuration at LJ55, and
//    a second pass that sums them in order. That is ~31 instructions an
//    unordered pair against 44 now, six shared-memory operations instead of
//    two, a barrier, and ~11 configurations an SM instead of 16; it does not
//    fit N = 256 at all. Not taken.
//  - Determinism: every sum runs in a fixed order, no atomics.
//  - Limits: 1 <= N <= 256 and N * L <= 512 (ops/lj.py raises on a larger
//    N for a CUDA tensor); rm > 0 and eps != 0 for the folded constants.

#include <cuda_runtime.h>

// The packed constants; the layout of pita_torch/ops/lj.py:_LJParams (outside
// the anonymous namespace: the C entry takes a pointer to it).
// Coordinates are used as x' = x / rm, so s = (rm/r)^2 = 1/r'^2.
struct LJParams {
  float inv_rm;
  float rmin2;           // (r_min / rm)^2: a pair takes the spline below it
  float ke, ko;          // log_prob = ke * sum e + ko * sum |x' - xbar'|^2
  float kg, kc;          // force = kg * g + kc * (x' - xbar')
  float rm, r_min;       // the spline's dx = r' * rm - r_min
  float c0, c1, c2, c3;  // the spline's energy, over eps
  float q0, q1, q2;      // its derivative in the units of g
  int spline;
};

namespace {

constexpr int kMaxN = 256;
constexpr int kMaxGroup = 512;  // threads of one configuration's group
constexpr int kBlock = 256;     // target threads of a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;      // pairs of a lane in flight at once

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// U pairs of one lane, its partners at xj[0], xj[step], ...: e += the pair
// energy over eps, g += the pair force over 6 eps / rm. A pair with
// !valid adds nothing.
template <int U, bool SPLINE>
__device__ __forceinline__ void pairs(const float4* xj, int step, float4 xi, bool valid,
                                      const LJParams& p, float& e, float& g0, float& g1,
                                      float& g2) {
  float d0[U], d1[U], d2[U], r2[U], ep[U], gd[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 q = xj[u * step];
    d0[u] = xi.x - q.x;
    d1[u] = xi.y - q.y;
    d2[u] = xi.z - q.z;
    r2[u] = fmaf(d2[u], d2[u], fmaf(d1[u], d1[u], d0[u] * d0[u]));
    const float s = rcp_approx(r2[u]);
    const float s3 = s * s * s;
    const float s6 = s3 * s3;
    ep[u] = fmaf(-2.f, s3, s6);
    gd[u] = s * (s3 - s6);
  }
  if (SPLINE) {
    bool close = false;
#pragma unroll
    for (int u = 0; u < U; ++u) close |= r2[u] < p.rmin2;
    if (__any_sync(kFull, close)) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float rs = rsqrt_approx(r2[u]);
        const float dx = fmaf(r2[u] * rs, p.rm, -p.r_min);
        const float es = fmaf(fmaf(fmaf(p.c0, dx, p.c1), dx, p.c2), dx, p.c3);
        const float gs = fmaf(fmaf(p.q0, dx, p.q1), dx, p.q2) * rs;
        const bool c = r2[u] < p.rmin2;
        ep[u] = c ? es : ep[u];
        gd[u] = c ? gs : gd[u];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    e += valid ? ep[u] : 0.f;
    const float w = valid ? gd[u] : 0.f;
    g0 = fmaf(w, d0[u], g0);
    g1 = fmaf(w, d1[u], g1);
    g2 = fmaf(w, d2[u], g2);
  }
}

// One configuration per group of `seg` threads (see the note above): the
// block is (seg, configurations), lane t = threadIdx.x = i * L + s with
// L = 1 << lg. out: force (B, N*3) then log_prob (B,).
template <bool SPLINE>
__global__ void __launch_bounds__(kMaxGroup)
lj_pairs_kernel(const float* __restrict__ x, float* __restrict__ out, int B, int N, int lg,
                LJParams p) {
  extern __shared__ float4 smem4[];
  const int seg = blockDim.x, cpb = blockDim.y, L = 1 << lg;
  const int c = threadIdx.y, t = threadIdx.x;
  const int b = blockIdx.x * cpb + c;
  // a spare group of the last block recomputes the last configuration and
  // writes nothing, so every lane of a warp takes part in its shuffles
  const int bl = min(b, B - 1);
  float4* xs = smem4 + c * 2 * N;  // xs[q] = xs[q + N] = x'_q
  float* xsf = reinterpret_cast<float*>(xs);
  const float* xb = x + (size_t)bl * N * 3;
  for (int k = t; k < 3 * N; k += seg) {
    const float v = xb[k] * p.inv_rm;
    const int q = k / 3, comp = k - 3 * q;
    xsf[4 * q + comp] = v;
    xsf[4 * (q + N) + comp] = v;
  }
  if (seg > 32) __syncthreads();
  else __syncwarp();

  const int i = t >> lg, s = t & (L - 1);
  const bool own = i < N;
  // a spare lane (i >= N) shadows particle i - N; its sums are dropped
  const int ii = own ? i : i - N;
  const float4 xi = xs[ii];
  float e = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
  const int full = (N - 1) >> lg;  // partners every slice has
  const float4* xj = xs + ii + 1 + s;
  int m = 0;
  for (; m + kUnroll <= full; m += kUnroll)
    pairs<kUnroll, SPLINE>(xj + m * L, L, xi, true, p, e, g0, g1, g2);
  for (; m < full; ++m) pairs<1, SPLINE>(xj + m * L, L, xi, true, p, e, g0, g1, g2);
  const int rem = (N - 1) - (full << lg);  // slices s < rem have one partner more
  if (rem > 0) {
    const bool valid = s < rem;
    pairs<1, SPLINE>(valid ? xj + full * L : xs + ii + 1, L, xi, valid, p, e, g0, g1, g2);
  }
  for (int o = L >> 1; o > 0; o >>= 1) {
    e += __shfl_xor_sync(kFull, e, o);
    g0 += __shfl_xor_sync(kFull, g0, o);
    g1 += __shfl_xor_sync(kFull, g1, o);
    g2 += __shfl_xor_sync(kFull, g2, o);
  }

  // per particle (slice 0 only): its pair energy, u = x'_i - x'_0, |u|^2
  const bool lead = own && s == 0;
  const float4 x0 = xs[0];
  const float u0 = xi.x - x0.x, u1 = xi.y - x0.y, u2 = xi.z - x0.z;
  float v[5] = {lead ? e : 0.f, lead ? u0 : 0.f, lead ? u1 : 0.f, lead ? u2 : 0.f,
                lead ? fmaf(u2, u2, fmaf(u1, u1, u0 * u0)) : 0.f};
  // a group of one warp or less sums into every lane; a larger one into
  // each warp's lane 0 (a slice-0 lane), then over its warps in order
  const int span = seg < 32 ? seg : 32;
  const int low = seg > 32 ? L : 1;
  for (int o = span >> 1; o >= low; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] += __shfl_xor_sync(kFull, v[k], o);
  }
  if (seg > 32) {
    const int nw = seg / 32, w = t / 32;
    float* red = reinterpret_cast<float*>(smem4 + cpb * 2 * N) + c * nw * 5;
    if ((t & 31) == 0) {
#pragma unroll
      for (int k = 0; k < 5; ++k) red[w * 5 + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] = red[k];
    for (int ww = 1; ww < nw; ++ww) {
#pragma unroll
      for (int k = 0; k < 5; ++k) v[k] += red[ww * 5 + k];
    }
  }
  if (b >= B) return;
  const float inv_n = 1.f / N;
  if (own) {
    const float c0 = u0 - v[1] * inv_n, c1 = u1 - v[2] * inv_n, c2 = u2 - v[3] * inv_n;
    float* f = out + (size_t)b * N * 3 + 3 * i;
    for (int comp = s; comp < 3; comp += L) {
      const float gc = comp == 0 ? g0 : (comp == 1 ? g1 : g2);
      const float cc = comp == 0 ? c0 : (comp == 1 ? c1 : c2);
      f[comp] = fmaf(p.kg, gc, p.kc * cc);
    }
  }
  if (t == 0) {
    const float osc = v[4] - fmaf(v[3], v[3], fmaf(v[2], v[2], v[1] * v[1])) * inv_n;
    out[(size_t)B * N * 3 + b] = fmaf(p.ke, v[0], p.ko * osc);
  }
}

int group_threads(int N, int L) {
  const int nl = N * L;
  if (nl > 32) return (nl + 31) / 32 * 32;
  int seg = 1;
  while (seg < nl) seg <<= 1;
  return seg;
}

// ---------------------------------------------------------------------------
// The first kernel, kept as the yardstick: one thread per particle,
// a group of ceil(N/32) warps per configuration, several configurations per
// 256-thread block, the neighbour loop serial with an IEEE division, an IEEE
// sqrt and a branch for the spline, block reductions for the centre of mass
// and the energy. Reached by pita_lj_log_prob_and_force_scalar alone.

struct LJScalarParams {
  float eps, rm2, osc, energy_factor, temperature;
  int spline;
  float c0, c1, c2, c3, r_min;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum of v over one configuration's group of nw warps; every thread of the
// block must call it (it holds two block barriers). Same value in every
// thread of the group, summed in a fixed order.
__device__ float group_sum(float v, float* red, int c, int w, int lane, int nw) {
  v = warp_sum(v);
  if (lane == 0) red[c * nw + w] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < nw; ++k) s += red[c * nw + k];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kBlock)
lj_scalar_kernel(const float* __restrict__ x, float* __restrict__ logp,
                 float* __restrict__ force, int B, int N, int tpc, LJScalarParams p) {
  extern __shared__ float smem[];
  const int cpb = blockDim.x / tpc;
  const int nw = tpc / 32;
  const int c = threadIdx.x / tpc;
  const int i = threadIdx.x % tpc;
  const int w = i / 32, lane = i % 32;
  const int b = blockIdx.x * cpb + c;
  const bool live = b < B;
  float* xs = smem + c * N * 3;
  float* red = smem + cpb * N * 3;

  for (int k = i; k < N * 3; k += tpc)
    xs[k] = live ? x[(size_t)b * N * 3 + k] : 0.f;
  __syncthreads();

  const bool own = live && i < N;
  const float xi0 = own ? xs[3 * i] : 0.f;
  const float xi1 = own ? xs[3 * i + 1] : 0.f;
  const float xi2 = own ? xs[3 * i + 2] : 0.f;
  const float m0 = group_sum(xi0, red, c, w, lane, nw) / N;
  const float m1 = group_sum(xi1, red, c, w, lane, nw) / N;
  const float m2 = group_sum(xi2, red, c, w, lane, nw) / N;

  float e = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
  if (own) {
    for (int j = 0; j < N; ++j) {
      const float d0 = xi0 - xs[3 * j];
      const float d1 = xi1 - xs[3 * j + 1];
      const float d2 = xi2 - xs[3 * j + 2];
      // the diagonal is kept finite (r2 := 1) and masked out, as lj.py:45
      const bool diag = j == i;
      const float r2 = diag ? 1.f : d0 * d0 + d1 * d1 + d2 * d2;
      const float inv_r2 = 1.f / r2;
      const float s = p.rm2 * inv_r2;
      const float x3 = s * s * s;
      const float x6 = x3 * x3;
      float ep = p.eps * (x6 - 2.f * x3);
      float de = (6.f * p.eps * inv_r2) * (x3 - x6);
      if (p.spline) {
        const float r = sqrtf(r2);
        if (r < p.r_min) {
          const float dx = r - p.r_min;
          ep = ((p.c0 * dx + p.c1) * dx + p.c2) * dx + p.c3;
          de = ((3.f * p.c0 * dx + 2.f * p.c1) * dx + p.c2) / (2.f * r);
        }
      }
      if (!diag) {
        e += ep;
        g0 += de * d0;
        g1 += de * d1;
        g2 += de * d2;
      }
    }
  }
  const float c0 = xi0 - m0, c1 = xi1 - m1, c2 = xi2 - m2;
  float ei = 0.f;
  if (own) {
    ei = e * p.energy_factor;
    ei += 0.5f * p.osc * c0 * c0;
    ei += 0.5f * p.osc * c1 * c1;
    ei += 0.5f * p.osc * c2 * c2;
  }
  const float energy = group_sum(ei, red, c, w, lane, nw);
  if (own) {
    const float ef4 = 4.f * p.energy_factor;
    float* f = force + (size_t)b * N * 3 + 3 * i;
    f[0] = -(ef4 * g0 + p.osc * c0) / p.temperature;
    f[1] = -(ef4 * g1 + p.osc * c1) / p.temperature;
    f[2] = -(ef4 * g2 + p.osc * c2) / p.temperature;
  }
  if (live && i == 0) logp[b] = -energy / p.temperature;
}

}  // namespace

extern "C" int pita_lj_max_n() { return kMaxN; }
extern "C" int pita_lj_max_group() { return kMaxGroup; }
extern "C" int pita_lj_params_bytes() { return (int)sizeof(LJParams); }

// x: (B, N*3) f32 contiguous; out: B*N*3 + B floats, the force (B, N*3)
// then log_prob (B,); lanes: L, a power of two <= 32 with N*L <= 512; p:
// the packed constants. Returns the cudaError_t of the launch (0 on success).
extern "C" int pita_lj_log_prob_and_force(const float* x, float* out, int B, int N, int lanes,
                                          const LJParams* p, void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || N > kMaxN || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      N * lanes > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  const int seg = group_threads(N, lanes);
  const int cpb = seg < kBlock ? kBlock / seg : 1;
  const size_t shm = (size_t)cpb * 2 * N * sizeof(float4) +
                     (seg > 32 ? (size_t)cpb * (seg / 32) * 5 * sizeof(float) : 0);
  const dim3 grid((B + cpb - 1) / cpb), block(seg, cpb);
  int lg = 0;
  while ((1 << lg) < lanes) ++lg;
  if (p->spline)
    lj_pairs_kernel<true><<<grid, block, shm, (cudaStream_t)stream>>>(x, out, B, N, lg, *p);
  else
    lj_pairs_kernel<false><<<grid, block, shm, (cudaStream_t)stream>>>(x, out, B, N, lg, *p);
  return (int)cudaGetLastError();
}

// The first kernel, with its first interface. x: (B, N*3) f32 contiguous;
// logp: (B,); force: (B, N*3). Returns the cudaError_t of the launch.
extern "C" int pita_lj_log_prob_and_force_scalar(
    const float* x, float* logp, float* force, int B, int N, float eps,
    float rm, float osc, float energy_factor, float temperature, int spline,
    float c0, float c1, float c2, float c3, float r_min, void* stream) {
  if (B <= 0) return 0;
  const int tpc = ((N + 31) / 32) * 32;
  if (N <= 0 || tpc > kBlock) return (int)cudaErrorInvalidValue;
  const int cpb = kBlock / tpc;
  const size_t shm = (size_t)(cpb * N * 3 + cpb * (tpc / 32)) * sizeof(float);
  LJScalarParams p{eps, rm * rm, osc, energy_factor, temperature, spline,
                   c0, c1, c2, c3, r_min};
  lj_scalar_kernel<<<(B + cpb - 1) / cpb, cpb * tpc, shm, (cudaStream_t)stream>>>(
      x, logp, force, B, N, tpc, p);
  return (int)cudaGetLastError();
}
