// One EGCL layer's tangent map for a chunk of coordinate-basis tangents (K4),
// sm_90a.
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/egnn_fwd.py:
// _layer_tan_kernel (:195-239), called through _layer_tan_call (:360,
// pallas_call at :365). The layer of _layer_step (:85-136) is linearized at
// its primal inputs (h, x, edge_attr) and each tangent (dh_t, dx_t, dea_t) of
// the chunk is pushed through the linear map to (dh_out_t, dx_out_t). The
// edge-attribute tangent is rebuilt on chip from the original coordinates
// xs0 and the one-hot basis e_t:
//   dea_t[i,j] = 2 * sum_d (xs0[i,d] - xs0[j,d]) * (e_t[i,d] - e_t[j,d]).
// No tangent edge tensor ever reaches device memory. As under jax.linearize,
// the tangent of a matmul input is itself rounded to the compute dtype (bf16
// when bf16 != 0), products accumulate in f32 and elementwise math is f32.
//
// What bounds it on the H100: per chain, layer and tangent the two F x F
// edge products cost 2*2*F*F*N*(N-1) operations against 2*N*(F+3) floats
// in and out, about 900 operations per byte at N=55, F=32: arithmetic, not
// memory. Design: K2 with dual numbers. Forward mode sums only over the
// senders j of a receiver row, as K2 does, so there are no cross-row sums
// and no atomics. One 256-thread block takes one chain and `tc` consecutive
// tangents: the weights, the primal node state and src/dst are loaded and
// computed once per block, then for each tangent the block loads its node
// tangents, projects them (dsrc, ddst), and runs K2's edge chain with the
// primal and the tangent side by side: a warp per receiver row, a lane per
// edge, both F-vectors accumulated against the same weight-row loads, the
// vectors a later stage needs parked in two per-thread shared-memory slots
// (registers: one primal and one tangent F-vector at a time). The primal
// edge activations are therefore recomputed for every tangent: about 1.6x
// the work of parking them per edge, which would need 512 B of shared memory
// per thread; that and tensor cores are later work. The primal aggregation
// and silu'(node hidden) are taken from the block's first tangent and kept.
// Row sums are warp shuffles in a fixed order: the result is deterministic.

#include "egnn_common.cuh"

namespace {

// Primal z2 and tangent d_m_pre of one edge, both to the thread's slots:
//   z1 = src_i + dst_j + rad*w_r + ea*w_e,   dz1 = dsrc_i + ddst_j + c*w_r + e*w_e
//   z2 = R(silu(z1)) We2 + be2,              dz2 = R(silu'(z1) dz1) We2
// ms <- m_pre = silu(z2), ds <- d_m_pre = silu'(z2) dz2. Returns the
// attention gate and, in datt, its tangent.
template <int F>
__device__ __forceinline__ float edge_z2_att_tan(const float* w, const WOff& o,
                                                 const float* si, const float* dj,
                                                 const float* dsi, const float* ddj,
                                                 float rad, float ea, float ct, float et,
                                                 const Cfg& c, float* ms, float* ds,
                                                 float& datt) {
  float z2[F], dz2[F];
#pragma unroll
  for (int g = 0; g < F; ++g) {
    z2[g] = 0.f;
    dz2[g] = 0.f;
  }
#pragma unroll 2
  for (int f = 0; f < F; ++f) {
    const float wr = w[o.scal + f], we = w[o.scal + F + f];
    const float z1 = (si[f] + dj[f]) + (rad * wr + ea * we);
    const float dz1 = (dsi[f] + ddj[f]) + (ct * wr + et * we);
    const float s = sigm(z1);
    const float m1 = rnd(z1 * s, c.bf16);
    const float dm1 = rnd(s * (1.f + z1 * (1.f - s)) * dz1, c.bf16);
    const float4* row = reinterpret_cast<const float4*>(w + o.e2 + f * F);
#pragma unroll
    for (int g4 = 0; g4 < F / 4; ++g4) {
      const float4 v = row[g4];
      z2[4 * g4 + 0] += m1 * v.x;
      z2[4 * g4 + 1] += m1 * v.y;
      z2[4 * g4 + 2] += m1 * v.z;
      z2[4 * g4 + 3] += m1 * v.w;
      dz2[4 * g4 + 0] += dm1 * v.x;
      dz2[4 * g4 + 1] += dm1 * v.y;
      dz2[4 * g4 + 2] += dm1 * v.z;
      dz2[4 * g4 + 3] += dm1 * v.w;
    }
  }
  float l = 0.f, dl = 0.f;
#pragma unroll
  for (int g = 0; g < F; ++g) {
    const float z = z2[g] + w[o.be2 + g];
    const float s = sigm(z);
    const float mp = z * s;
    const float dmp = s * (1.f + z * (1.f - s)) * dz2[g];
    ms[g * kThreads] = mp;
    ds[g * kThreads] = dmp;
    const float wa = w[o.att + g];
    l += mp * wa;
    dl += dmp * wa;
  }
  if (!c.attention) {
    datt = 0.f;
    return 1.f;
  }
  const float att = sigm(l + w[o.batt]);
  datt = att * (1.f - att) * dl;
  return att;
}

// Coordinate-MLP scalar cm and its tangent dcm of one edge:
//   m = m_pre*att, dm = d_m_pre*att + m_pre*datt (from the slots),
//   cz = R(m) Wc1 + bc1, dcz = R(dm) Wc1, cm = sum_k silu(cz_k) wc2_k,
//   dcm = sum_k silu'(cz_k) dcz_k wc2_k.
// The row sums of dm go to lane g's ``dagg``; with ``with_agg`` (uniform over
// the warp) those of m to ``agg``.
template <int F>
__device__ __forceinline__ float edge_cm_tan(const float* w, const WOff& o,
                                             const float* ms, const float* ds, float att,
                                             float datt, int bf, float valid, int lane,
                                             bool with_agg, float& agg, float& dagg,
                                             float& dcm) {
  float cz[F], dcz[F];
#pragma unroll
  for (int k = 0; k < F; ++k) {
    cz[k] = 0.f;
    dcz[k] = 0.f;
  }
#pragma unroll 2
  for (int g = 0; g < F; ++g) {
    const float mp = ms[g * kThreads];
    const float m = mp * att;
    const float dm = ds[g * kThreads] * att + mp * datt;
    if (with_agg) row_sum_to_lane(m, valid, g, lane, agg);
    row_sum_to_lane(dm, valid, g, lane, dagg);
    const float mr = rnd(m, bf), dmr = rnd(dm, bf);
    const float4* row = reinterpret_cast<const float4*>(w + o.c1 + g * F);
#pragma unroll
    for (int k4 = 0; k4 < F / 4; ++k4) {
      const float4 v = row[k4];
      cz[4 * k4 + 0] += mr * v.x;
      cz[4 * k4 + 1] += mr * v.y;
      cz[4 * k4 + 2] += mr * v.z;
      cz[4 * k4 + 3] += mr * v.w;
      dcz[4 * k4 + 0] += dmr * v.x;
      dcz[4 * k4 + 1] += dmr * v.y;
      dcz[4 * k4 + 2] += dmr * v.z;
      dcz[4 * k4 + 3] += dmr * v.w;
    }
  }
  float cm = 0.f;
  dcm = 0.f;
#pragma unroll
  for (int k = 0; k < F; ++k) {
    const float z = cz[k] + w[o.bc1 + k];
    const float s = sigm(z);
    const float wc = w[o.c2 + k];
    cm += z * s * wc;
    dcm += s * (1.f + z * (1.f - s)) * dcz[k] * wc;
  }
  return cm;
}

template <int F>
size_t tan_smem_floats(int N) {
  const WOff o = woff(F);
  return (size_t)o.total + 5 * N * F + 4 * N * (F + 1) + 4 * pad4(3 * N) + kWarps * F +
         (size_t)2 * kThreads * F;
}

// Receiver row i: the lane's edges, then the row's outputs. ``first`` (the
// block's first tangent) also sums the primal aggregation.
template <int F>
__device__ __forceinline__ void row_pass(const float* w, const WOff& o, const Cfg& c,
                                         const float* sx, const float* sxs0,
                                         const float* sdx, const float* se,
                                         const float* ssrc, const float* sdst,
                                         const float* sdsrc, const float* sddst,
                                         const float* eab, float* ms, float* ds, int i,
                                         int lane, bool first, float* sagg,
                                         float* sdagg, float* dxo) {
  const int N = c.N, FP = F + 1;
  const int npass = (N + 31) / 32;
  const float xi0 = sx[3 * i], xi1 = sx[3 * i + 1], xi2 = sx[3 * i + 2];
  const float dxi0 = sdx[3 * i], dxi1 = sdx[3 * i + 1], dxi2 = sdx[3 * i + 2];
  float agg = 0.f, dagg = 0.f;  // lane g keeps feature g of the row sums
  float sw = 0.f, sdw = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int p = 0; p < npass; ++p) {
    // every lane runs an edge so the row sums can shuffle; a lane past N, or
    // on the masked diagonal, runs the diagonal and contributes 0
    const int j = lane + 32 * p;
    const bool valid = j < N && j != i;
    const int jj = valid ? j : i;
    const float xj0 = sx[3 * jj], xj1 = sx[3 * jj + 1], xj2 = sx[3 * jj + 2];
    const float dxj0 = sdx[3 * jj], dxj1 = sdx[3 * jj + 1], dxj2 = sdx[3 * jj + 2];
    const float d0 = xi0 - xj0, d1 = xi1 - xj1, d2 = xi2 - xj2;
    const float rad = d0 * d0 + d1 * d1 + d2 * d2;
    const float nrm = sqrtf(rad + 1e-8f);
    const float den = nrm + 1.f;
    // tangents of the radial and of the edge attribute
    const float ct = 2.f * (d0 * (dxi0 - dxj0) + d1 * (dxi1 - dxj1) + d2 * (dxi2 - dxj2));
    const float et =
        2.f * ((sxs0[3 * i] - sxs0[3 * jj]) * (se[3 * i] - se[3 * jj]) +
               (sxs0[3 * i + 1] - sxs0[3 * jj + 1]) * (se[3 * i + 1] - se[3 * jj + 1]) +
               (sxs0[3 * i + 2] - sxs0[3 * jj + 2]) * (se[3 * i + 2] - se[3 * jj + 2]));
    float datt;
    const float att = edge_z2_att_tan<F>(w, o, ssrc + i * FP, sdst + jj * FP, sdsrc + i * FP,
                                         sddst + jj * FP, rad, eab[i * N + jj], ct, et, c,
                                         ms, ds, datt);
    float dcm;
    const float cm = edge_cm_tan<F>(w, o, ms, ds, att, datt, c.bf16, valid ? 1.f : 0.f,
                                    lane, first, agg, dagg, dcm);
    const float th = c.tanh ? tanhf(cm) : 0.f;
    const float a = c.tanh ? th * c.coords_range : cm;
    const float da = c.tanh ? c.coords_range * (1.f - th * th) * dcm : dcm;
    // w = a / (norm + 1), d_w = (d_a - w * d_norm) / (norm + 1)
    const float wij = valid ? a / den : 0.f;
    const float dwij = valid ? (da - wij * (ct / (2.f * nrm))) / den : 0.f;
    sw += wij;
    sdw += dwij;
    s0 += dwij * xj0 + wij * dxj0;
    s1 += dwij * xj1 + wij * dxj1;
    s2 += dwij * xj2 + wij * dxj2;
  }
  if (first && lane < F) sagg[i * F + lane] = agg;
  if (lane < F) sdagg[i * F + lane] = dagg;
  sw = warp_sum(sw);
  sdw = warp_sum(sdw);
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    // x_out_i = x_i + x_i sum_j w_ij - sum_j w_ij x_j, differentiated
    dxo[3 * i + 0] = dxi0 + dxi0 * sw + xi0 * sdw - s0;
    dxo[3 * i + 1] = dxi1 + dxi1 * sw + xi1 * sdw - s1;
    dxo[3 * i + 2] = dxi2 + dxi2 * sw + xi2 * sdw - s2;
  }
}

// ------------------------------------------------------------------ K4

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
egcl_tan_kernel(const float* __restrict__ h, const float* __restrict__ x,
                const float* __restrict__ ea, const float* __restrict__ xs0,
                const float* __restrict__ basis, const float* __restrict__ dh,
                const float* __restrict__ dx, const float* __restrict__ wts,
                float* __restrict__ dh_out, float* __restrict__ dx_out, Cfg c, int Tc,
                int tc) {
  static_assert(F % 4 == 0 && F <= 32, "F must be a multiple of 4, at most 32");
  extern __shared__ float4 smem4[];
  const WOff o = woff(F);
  const int N = c.N, FP = F + 1, X3 = pad4(3 * N);
  float* w = reinterpret_cast<float*>(smem4);
  float* sh = w + o.total;
  float* ssrc = sh + N * F;
  float* sdst = ssrc + N * FP;
  float* sx = sdst + N * FP;
  float* sxs0 = sx + X3;
  float* sagg = sxs0 + X3;      // primal aggregation
  float* sdh = sagg + N * F;    // this tangent's dh
  float* sdsrc = sdh + N * F;
  float* sddst = sdsrc + N * FP;
  float* sdx = sddst + N * FP;
  float* se = sdx + X3;
  float* sdagg = se + X3;
  float* snz = sdagg + N * F;   // silu'(nz), from the block's first tangent
  float* stmp = snz + N * F;
  float* ms = stmp + kWarps * F + threadIdx.x;  // this thread's m_pre slot
  float* ds = ms + kThreads * F;                // this thread's d_m_pre slot
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t_begin = blockIdx.y * tc;
  const int t_end = min(Tc, t_begin + tc);
  load_chain<F>(h, x, wts, smem4, o, c, b, sh, sx, ssrc, sdst);
  const float* xs0b = xs0 + (size_t)b * N * 3;
  for (int k = tid; k < N * 3; k += kThreads) sxs0[k] = xs0b[k];
  const float* eab = ea + (size_t)b * N * N;

  for (int t = t_begin; t < t_end; ++t) {
    const bool first = t == t_begin;
    const size_t bt = (size_t)b * Tc + t;
    const float* dhb = dh + bt * N * F;
    const float* dxb = dx + bt * N * 3;
    const float* eb = basis + (size_t)t * N * 3;
    __syncthreads();  // the previous tangent's node phase has read sdh, sdagg
    for (int k = tid; k < N * F; k += kThreads) sdh[k] = dhb[k];
    for (int k = tid; k < N * 3; k += kThreads) {
      sdx[k] = dxb[k];
      se[k] = eb[k];
    }
    __syncthreads();
    // dsrc = R(dh) Wsrc, ddst = R(dh) Wdst
    for (int k = tid; k < N * F; k += kThreads) {
      const int n = k / F, f = k % F;
      float s = 0.f, d = 0.f;
#pragma unroll 8
      for (int q = 0; q < F; ++q) {
        const float hv = rnd(sdh[n * F + q], c.bf16);
        s += hv * w[o.src + q * F + f];
        d += hv * w[o.dst + q * F + f];
      }
      sdsrc[n * FP + f] = s;
      sddst[n * FP + f] = d;
    }
    __syncthreads();

    float* dxo = dx_out + bt * N * 3;
    for (int i = warp; i < N; i += kWarps)
      row_pass<F>(w, o, c, sx, sxs0, sdx, se, ssrc, sdst, sdsrc, sddst, eab, ms, ds, i, lane,
                  first, sagg, sdagg, dxo);
    __syncthreads();

    // node MLP tangent: warp per node, lane per output feature
    //   d_nz = R([dh, d_agg]) Wn1, dh_out = dh + R(silu'(nz) d_nz) Wn2
    float* tmp = stmp + warp * F;
    float* dho = dh_out + bt * N * F;
    for (int n = warp; n < N; n += kWarps) {
      if (lane < F) {
        if (first) {
          float nz = 0.f;
          for (int q = 0; q < F; ++q) nz += rnd(sh[n * F + q], c.bf16) * w[o.n1 + q * F + lane];
          for (int q = 0; q < F; ++q)
            nz += rnd(sagg[n * F + q], c.bf16) * w[o.n1 + (F + q) * F + lane];
          snz[n * F + lane] = dsilu(nz + w[o.bn1 + lane]);
        }
        float s = 0.f;
        for (int q = 0; q < F; ++q) s += rnd(sdh[n * F + q], c.bf16) * w[o.n1 + q * F + lane];
        for (int q = 0; q < F; ++q)
          s += rnd(sdagg[n * F + q], c.bf16) * w[o.n1 + (F + q) * F + lane];
        tmp[lane] = rnd(snz[n * F + lane] * s, c.bf16);
      }
      __syncwarp();
      if (lane < F) {
        float s = 0.f;
        for (int q = 0; q < F; ++q) s += tmp[q] * w[o.n2 + q * F + lane];
        dho[n * F + lane] = sdh[n * F + lane] + s;
      }
      __syncwarp();
    }
  }
}

template <int F>
int launch_tan(const float* h, const float* x, const float* ea, const float* xs0,
               const float* basis, const float* dh, const float* dx, const float* wts,
               float* dh_out, float* dx_out, int B, int Tc, int tc, const Cfg& c,
               cudaStream_t s) {
  const size_t bytes = tan_smem_floats<F>(c.N) * sizeof(float);
  const int err = prepare(egcl_tan_kernel<F>, bytes);
  if (err) return err;
  const dim3 grid(B, (Tc + tc - 1) / tc);
  egcl_tan_kernel<F><<<grid, kThreads, bytes, s>>>(h, x, ea, xs0, basis, dh, dx, wts,
                                                   dh_out, dx_out, c, Tc, tc);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes one block needs (0 if F is not supported).
extern "C" long long pita_egcl_tangent_smem_bytes(int N, int F) {
  switch (F) {
    case 16: return (long long)(tan_smem_floats<16>(N) * sizeof(float));
    case 32: return (long long)(tan_smem_floats<32>(N) * sizeof(float));
    default: return 0;
  }
}

// Primal h: (B, N, F), x, xs0: (B, N, 3), ea: (B, N, N); basis: (Tc, N, 3);
// tangents dh: (B, Tc, N, F), dx: (B, Tc, N, 3); wts: packed weights (16-byte
// aligned, layout of egnn_common.cuh) -> dh_out (B, Tc, N, F), dx_out
// (B, Tc, N, 3). All f32, contiguous. A block takes `tc` tangents of a chain.
extern "C" int pita_egcl_tangent(const float* h, const float* x, const float* ea,
                                 const float* xs0, const float* basis, const float* dh,
                                 const float* dx, const float* wts, float* dh_out,
                                 float* dx_out, int B, int Tc, int tc, int N, int F,
                                 int bf16, int attention, int tanh, float coords_range,
                                 void* stream) {
  if (B <= 0 || Tc <= 0) return 0;
  if (tc <= 0 || (Tc + tc - 1) / tc > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const Cfg c{N, bf16, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16:
      return launch_tan<16>(h, x, ea, xs0, basis, dh, dx, wts, dh_out, dx_out, B, Tc, tc, c, s);
    case 32:
      return launch_tan<32>(h, x, ea, xs0, basis, dh, dx, wts, dh_out, dx_out, B, Tc, tc, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
