// G-operator tangent contraction for the exact score divergence (K5), sm_90a.
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/g_op.py: _kernel, called
// through g_operator_contract (g_op.py:91, pallas_call at :133):
//
//   t2[t,b,n,g] = sum_{m,f} G[b,n,m,f,g] * bv[t,b,m,f]
//   G[b,n,m,f,g] = att_mask[b,n,m] * sp1[b,n,m,f] * W2[f,g] * sp2[b,n,m,g]
//                  + satq[b,n,m,f] * m_pre[b,n,m,g]
//
// with G built on chip from the primal edge activations, so the
// (B, N, N, F, F) operator never exists in device memory. As in the TPU
// kernel, G and bv are rounded to bf16 for the product whatever the model's
// compute dtype, and the sum accumulates in f32.
//
// Form taken: G itself, element by element (not the factored sum through
// W2), so the rounding is the TPU kernel's: each G[m,f,g] is formed in f32 as
// (att_mask*sp2[g]) * (sp1[f]*W2[f,g]) + satq[f]*m_pre[g], rounded to bf16,
// and multiplied by the bf16-rounded bv. The TPU kernel's blocks do not carry
// over: no (Np*F, F) slab per receiver row, no padding of N to 16 or of the
// receiver rows to 8, no transposed-reshape workaround.
//
// What bounds it on the H100: 2*(N*F)^2*T operations per chain against
// (4*N*N*F + 2*T*N*F) floats moved, about 290 operations per byte at N=55,
// F=32, T=165: at the bf16 tensor-core rate the two bounds are about equal
// (0.26 ms of operations, 0.30 ms of bytes for 256 chains); this first
// version multiplies with scalar f32 FMAs and is bound by those (3.9 ms at
// 67 TFLOP/s). Design: one block per (chain, tile of 16 tangents). The
// chain's tangent panel for the tile, bv[t, b, :, :] as (N*F, 16) f32 already
// rounded to bf16, sits in shared memory (110 KB at N*F = 1760; the whole
// panel of 165 tangents would be 1.1 MB), so two blocks share an SM. A warp
// takes receiver row n and lane g the output feature g: the lane keeps
// column g of W2 and its 16 accumulators in registers, streams the row's
// primal activations over the senders m (one coalesced 128-byte load per
// array and sender, staged per warp in shared memory so that sp1 and satq
// can be read as broadcasts), builds G[m,f,g] in a register and spends it on
// 16 FMAs against four 16-byte broadcast loads of the panel. The inner loop
// has no block-wide barrier. Every sum runs in a fixed order, so the result
// is deterministic. Tensor cores (mma/wgmma on the bf16 operands) are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;            // tangents per block
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

size_t smem_floats(int N, int F) {
  return (size_t)N * F * kTile + (size_t)kWarps * 2 * F;
}

template <int F>
__global__ void __launch_bounds__(kThreads, 2)
g_op_kernel(const float* __restrict__ sp1, const float* __restrict__ sp2,
            const float* __restrict__ attm, const float* __restrict__ satq,
            const float* __restrict__ mpre, const float* __restrict__ w2,
            const float* __restrict__ bv, float* __restrict__ out, int T, int B,
            int N) {
  static_assert(F % 4 == 0 && F <= 32, "F must be a multiple of 4, at most 32");
  extern __shared__ float4 smem4[];
  float* panel = reinterpret_cast<float*>(smem4);  // [(m*F + f) * kTile + tt]
  float* stage = panel + (size_t)N * F * kTile;    // per warp: sp1[F], satq[F]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int nt = min(kTile, T - t0);
  const int NF = N * F;

  // the tile of the tangent panel, rounded to bf16; a tangent past T is 0
  for (int tt = 0; tt < kTile; ++tt) {
    const float* src = bv + ((size_t)(t0 + tt) * B + b) * NF;
    for (int k = tid; k < NF; k += kThreads)
      panel[k * kTile + tt] = tt < nt ? rnd_bf16(src[k]) : 0.f;
  }

  // lane g keeps column g of W2 (lanes past F copy column 0 and never write)
  const int g = lane < F ? lane : 0;
  float w2c[F];
#pragma unroll
  for (int f = 0; f < F; ++f) w2c[f] = w2[f * F + g];
  __syncthreads();

  float* st = stage + warp * 2 * F;
  for (int n = warp; n < N; n += kWarps) {
    const size_t row = ((size_t)b * N + n) * N;  // edge (b, n, 0)
    float acc[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) acc[tt] = 0.f;
    for (int m = 0; m < N; ++m) {
      const size_t e = (row + m) * F;
      const float a_g = attm[row + m] * sp2[e + g];
      const float mp_g = mpre[e + g];
      __syncwarp();  // the previous sender's reads of the stage are done
      if (lane < F) {
        st[lane] = sp1[e + lane];
        st[F + lane] = satq[e + lane];
      }
      __syncwarp();
      const float4* pm = reinterpret_cast<const float4*>(panel + (size_t)m * F * kTile);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float gv = rnd_bf16(a_g * (st[f] * w2c[f]) + st[F + f] * mp_g);
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          const float4 v = pm[f * (kTile / 4) + q];
          acc[4 * q + 0] += gv * v.x;
          acc[4 * q + 1] += gv * v.y;
          acc[4 * q + 2] += gv * v.z;
          acc[4 * q + 3] += gv * v.w;
        }
      }
    }
    if (lane < F) {
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt)
        if (tt < nt) out[(((size_t)(t0 + tt) * B + b) * N + n) * F + lane] = acc[tt];
    }
  }
}

template <int F>
int launch(const float* sp1, const float* sp2, const float* attm, const float* satq,
           const float* mpre, const float* w2, const float* bv, float* out, int T,
           int B, int N, cudaStream_t s) {
  const size_t bytes = smem_floats(N, F) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(
      g_op_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  const dim3 grid((T + kTile - 1) / kTile, B);
  g_op_kernel<F><<<grid, kThreads, bytes, s>>>(sp1, sp2, attm, satq, mpre, w2, bv, out,
                                               T, B, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes one block needs (0 if F is not supported).
extern "C" long long pita_g_op_smem_bytes(int N, int F) {
  if (F != 16 && F != 32) return 0;
  return (long long)(smem_floats(N, F) * sizeof(float));
}

// sp1, sp2, satq, mpre: (B, N, N, F); attm: (B, N, N); w2: (F, F);
// bv: (T, B, N, F) -> out (T, B, N, F). All f32, contiguous.
extern "C" int pita_g_op_contract(const float* sp1, const float* sp2, const float* attm,
                                  const float* satq, const float* mpre, const float* w2,
                                  const float* bv, float* out, int T, int B, int N, int F,
                                  void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16: return launch<16>(sp1, sp2, attm, satq, mpre, w2, bv, out, T, B, N, s);
    case 32: return launch<32>(sp1, sp2, attm, satq, mpre, w2, bv, out, T, B, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
