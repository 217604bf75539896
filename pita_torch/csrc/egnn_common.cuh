// Shared device code of the EGCL layer kernels: the packed weight layout, the
// scalar helpers and the per-edge chain of pita_tpu/ops/pallas/egnn_fwd.py:85-136
// _layer_step. Included by egnn_layer.cu (K2 forward, K3 VJP) and
// egnn_tangent.cu (K4 tangent).

#pragma once


#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Offsets of the 15 weight arrays in the packed buffer, each padded to a
// multiple of 4 floats (order of egnn_fwd.py:79-82 _W_FIELDS; weights in
// the JAX (in, out) layout). Mirrored by pita_torch/ops/egnn_layer.py.
struct WOff {
  int src, bsrc, dst, scal, e2, be2, att, batt, c1, bc1, c2, n1, bn1, n2, bn2,
      total;
};

__host__ __device__ inline WOff woff(int F) {
  WOff o;
  int p = 0;
  o.src = p;  p += pad4(F * F);
  o.bsrc = p; p += pad4(F);
  o.dst = p;  p += pad4(F * F);
  o.scal = p; p += pad4(2 * F);
  o.e2 = p;   p += pad4(F * F);
  o.be2 = p;  p += pad4(F);
  o.att = p;  p += pad4(F);
  o.batt = p; p += pad4(1);
  o.c1 = p;   p += pad4(F * F);
  o.bc1 = p;  p += pad4(F);
  o.c2 = p;   p += pad4(F);
  o.n1 = p;   p += pad4(2 * F * F);
  o.bn1 = p;  p += pad4(F);
  o.n2 = p;   p += pad4(F * F);
  o.bn2 = p;  p += pad4(F);
  o.total = p;
  return o;
}

struct Cfg {
  int N, bf16, attention, tanh;
  float coords_range;
};

__device__ __forceinline__ float rnd(float v, int bf) {
  return bf ? __bfloat162float(__float2bfloat16(v)) : v;
}

// overflow-safe logistic of egnn_fwd.py:67-72, exp(min(z,0)) / (1+exp(-|z|)),
// with the one exponential shared by both branches (same values)
__device__ __forceinline__ float sigm(float z) {
  const float e = expf(-fabsf(z));
  return (z >= 0.f ? 1.f : e) / (1.f + e);
}

__device__ __forceinline__ float silu(float z) { return z * sigm(z); }

__device__ __forceinline__ float dsilu(float z) {
  const float s = sigm(z);
  return s * (1.f + z * (1.f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row sum over the warp's 32 edges of feature g, kept by lane g: every lane
// of the warp must call it (valid = 0 for a lane without an edge).
__device__ __forceinline__ void row_sum_to_lane(float v, float valid, int g, int lane,
                                                float& mine) {
  v = warp_sum(v * valid);
  if (lane == g) mine += v;
}

// Register budget: a lane holds at most one F-vector in registers at a time.
// A loop whose index selects a register element is fully unrolled; a loop
// over weight rows is not (unroll 2), so the compiler does not hoist many
// rows of loads. A vector needed by a later stage waits in the thread's
// slot in shared memory, element k at slot[k * kThreads] (consecutive
// threads on consecutive banks).

// z2[g] = sum_f R(silu(z1_f)) We2[f][g] + be2[g], z1 built on the fly from
// the node projections of the edge's two ends and its two scalars; z2 goes
// to the thread's slot zs. Returns the attention gate.
template <int F>
__device__ __forceinline__ float edge_z2_att(const float* w, const WOff& o,
                                             const float* si, const float* dj,
                                             float rad, float ea, const Cfg& c,
                                             float* zs) {
  float z2[F];
#pragma unroll
  for (int g = 0; g < F; ++g) z2[g] = 0.f;
#pragma unroll 2
  for (int f = 0; f < F; ++f) {
    const float z1 = (si[f] + dj[f]) + (rad * w[o.scal + f] + ea * w[o.scal + F + f]);
    const float m1 = rnd(silu(z1), c.bf16);
    const float4* row = reinterpret_cast<const float4*>(w + o.e2 + f * F);
#pragma unroll
    for (int g4 = 0; g4 < F / 4; ++g4) {
      const float4 v = row[g4];
      z2[4 * g4 + 0] += m1 * v.x;
      z2[4 * g4 + 1] += m1 * v.y;
      z2[4 * g4 + 2] += m1 * v.z;
      z2[4 * g4 + 3] += m1 * v.w;
    }
  }
  float l = 0.f;
#pragma unroll
  for (int g = 0; g < F; ++g) {
    z2[g] += w[o.be2 + g];
    zs[g * kThreads] = z2[g];
    l += silu(z2[g]) * w[o.att + g];
  }
  return c.attention ? sigm(l + w[o.batt]) : 1.f;
}

// cz[k] = sum_g R(m_g) Wc1[g][k] + bc1[k], m_g = silu(z2_g) * att with z2
// read from the slot zs; with AGG the unrounded m is also summed over the
// row into lane g's ``agg``
template <int F, bool AGG>
__device__ __forceinline__ void edge_cz(const float* w, const WOff& o, const float* zs,
                                        float att, int bf, float valid, int lane,
                                        float (&cz)[F], float& agg) {
#pragma unroll
  for (int k = 0; k < F; ++k) cz[k] = 0.f;
#pragma unroll 2
  for (int g = 0; g < F; ++g) {
    const float m = silu(zs[g * kThreads]) * att;
    if (AGG) row_sum_to_lane(m, valid, g, lane, agg);
    const float mr = rnd(m, bf);
    const float4* row = reinterpret_cast<const float4*>(w + o.c1 + g * F);
#pragma unroll
    for (int k4 = 0; k4 < F / 4; ++k4) {
      const float4 v = row[k4];
      cz[4 * k4 + 0] += mr * v.x;
      cz[4 * k4 + 1] += mr * v.y;
      cz[4 * k4 + 2] += mr * v.z;
      cz[4 * k4 + 3] += mr * v.w;
    }
  }
#pragma unroll
  for (int k = 0; k < F; ++k) cz[k] += w[o.bc1 + k];
}

template <int F>
__device__ __forceinline__ float edge_cm(const float* w, const WOff& o,
                                         const float (&cz)[F]) {
  float cm = 0.f;
#pragma unroll
  for (int k = 0; k < F; ++k) cm += silu(cz[k]) * w[o.c2 + k];
  return cm;
}

// Shared prologue: weights, node features and coordinates of chain b into
// shared memory, then src = R(h) Ws + bs and dst = R(h) Wd (row stride F+1).
template <int F>
__device__ __forceinline__ void load_chain(const float* __restrict__ h,
                                           const float* __restrict__ x,
                                           const float* __restrict__ wts,
                                           float4* smem4, const WOff& o,
                                           const Cfg& c, int b, float* sh,
                                           float* sx, float* ssrc, float* sdst) {
  const int N = c.N, FP = F + 1, tid = threadIdx.x;
  const float4* wg = reinterpret_cast<const float4*>(wts);
  for (int k = tid; k < o.total / 4; k += kThreads) smem4[k] = wg[k];
  const float* hb = h + (size_t)b * N * F;
  for (int k = tid; k < N * F; k += kThreads) sh[k] = hb[k];
  const float* xb = x + (size_t)b * N * 3;
  for (int k = tid; k < N * 3; k += kThreads) sx[k] = xb[k];
  __syncthreads();
  const float* w = reinterpret_cast<const float*>(smem4);
  for (int k = tid; k < N * F; k += kThreads) {
    const int n = k / F, f = k % F;
    float s = 0.f, d = 0.f;
#pragma unroll 8
    for (int q = 0; q < F; ++q) {
      const float hv = rnd(sh[n * F + q], c.bf16);
      s += hv * w[o.src + q * F + f];
      d += hv * w[o.dst + q * F + f];
    }
    ssrc[n * FP + f] = s + w[o.bsrc + f];
    sdst[n * FP + f] = d;
  }
  __syncthreads();
}

// Raise the kernel's dynamic shared memory limit (needed above 48 KB).
template <typename K>
int prepare(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace
