// Lennard-Jones log-probability and closed-form force, one pass (sm_90a).
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/lj.py:_lj_kernel
// (called from lj_log_prob_and_force, lj.py:79). Semantics are the same:
//   E = energy_factor * sum_{i != j} eps*((rm/r)^12 - 2 (rm/r)^6)
//       + 0.5 * osc * sum_i |x_i - xbar|^2
// with an optional first-segment cubic spline below r_min, log_prob = -E/T,
// and force = -(4 * sum_j e'(r^2) (x_i - x_j) + osc (x_i - xbar)) / T.
//
// What bounds it on the H100: at LJ55 a configuration is 55*54 ordered pairs
// of ~30 scalar f32 operations each against 1.3 KB of coordinates in and
// out, so the kernel is bound by f32 operations, not by device memory.
// Design: one thread per particle i, a group of ceil(N/32) warps per
// configuration and several configurations per 256-thread block. The
// coordinates of a configuration are staged once in shared memory; thread i
// loops over j and accumulates its energy and its 3-vector force in
// registers, so no (B, N, N) tensor ever exists. The centre of mass and the
// total energy come from a deterministic block reduction (warp shuffles,
// then the warp partials summed in a fixed order).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

struct LJParams {
  float eps, rm2, osc, energy_factor, temperature;
  int spline;
  float c0, c1, c2, c3, r_min;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
lj_kernel(const float* __restrict__ x, float* __restrict__ logp,
          float* __restrict__ force, int B, int N, int tpc, LJParams p) {
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

// x: (B, N*3) f32 contiguous; logp: (B,); force: (B, N*3). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pita_lj_log_prob_and_force(
    const float* x, float* logp, float* force, int B, int N, float eps,
    float rm, float osc, float energy_factor, float temperature, int spline,
    float c0, float c1, float c2, float c3, float r_min, void* stream) {
  if (B <= 0) return 0;
  const int tpc = ((N + 31) / 32) * 32;
  if (N <= 0 || tpc > kBlock) return (int)cudaErrorInvalidValue;
  const int cpb = kBlock / tpc;
  const size_t shm = (size_t)(cpb * N * 3 + cpb * (tpc / 32)) * sizeof(float);
  LJParams p{eps, rm * rm, osc, energy_factor, temperature, spline,
             c0, c1, c2, c3, r_min};
  lj_kernel<<<(B + cpb - 1) / cpb, cpb * tpc, shm, (cudaStream_t)stream>>>(
      x, logp, force, B, N, tpc, p);
  return (int)cudaGetLastError();
}
