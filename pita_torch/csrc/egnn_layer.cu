// One EGCL layer of the EGNN backbone: forward (K2) and its VJP (K3), sm_90a.
//
// Replaces the Pallas TPU kernels pita_tpu/ops/pallas/egnn_fwd.py:
//   _layer_fwd_kernel (called through _layer_fwd_call, egnn_fwd.py:311) and
//   _layer_bwd_kernel (called through _layer_bwd_call, egnn_fwd.py:335).
// The math is egnn_fwd.py:85-136 _layer_step: node-factored first edge layer
// (src_i + dst_j + radial*w_r + edge_attr*w_e), SiLU, second edge layer,
// SiLU, sigmoid attention gate, off-diagonal mask, coordinate MLP with
// tanh(cm)*range / (|x_i - x_j| + 1) weights, edge aggregation and the
// recurrent node MLP. Matmul inputs are rounded to the compute dtype (bf16
// when bf16 != 0) and products accumulate in f32; all elementwise math and
// the scalar-headed reductions (attention logit, coordinate scalar) are f32.
//
// What bounds them on the H100: per chain and layer the two F x F edge
// products cost 2*2*F*F*N*N FLOP (12.4 MFLOP at F=32, N=55) against a few
// KB of node state in and out, so both kernels are bound by arithmetic; each
// (B, N, N, F) edge tensor of the plain version is 0.8 GB at B=2048 and
// none is ever written. Design: one 256-thread block per chain. The
// layer's weights (7F^2 + 8F floats, ~30 KB) and the chain's node state sit
// in shared memory. A warp takes receiver row i and each lane takes edges
// (i, j = lane + 32p): the lane runs the whole edge chain for its edge,
// reading weight rows as float4 broadcasts, so the edge tensors exist only
// in registers and in a per-thread slot of shared memory. A lane keeps one
// F-vector in registers at a time (more spilled to local memory and made
// the backward 8x slower); the vector a later stage needs waits in the
// slot. Row sums over j (aggregation, coordinate update, src cotangent) are
// warp shuffles; a lane without an edge runs the finite diagonal and
// contributes 0. This first version uses scalar f32 FMAs; tensor cores
// (mma/wgmma) are later work.
//
// K3 is the VJP with respect to (h, x, edge_attr), derived by hand through
// the chain above; weight cotangents are not computed (inference only). The
// bf16 rounding of matmul inputs is treated as the identity in the backward
// (straight-through), so cotangents stay f32. The node MLP's backward needs
// the aggregation, so K3 first recomputes agg (one edge product per edge),
// then runs the node backward, then recomputes each edge forward and runs
// its backward (four more edge products): about 2.5x the work of K2. The
// cotangents of dst_j and x_j sum over all receivers i; those column sums
// stay inside the block: each warp accumulates into its own slab in shared
// memory (lane j owns row j of the slab, so no atomics), and the slabs are
// summed in a fixed order at the end. The result is deterministic.

#include "egnn_common.cuh"

namespace {

template <int F>
size_t fwd_smem_floats(int N) {
  const WOff o = woff(F);
  return (size_t)o.total + N * F + 2 * N * (F + 1) + pad4(3 * N) + N * F +
         kWarps * F + (size_t)kThreads * F;
}

template <int F>
size_t bwd_smem_floats(int N) {
  const WOff o = woff(F);
  return (size_t)o.total + N * F + 2 * N * (F + 1) + pad4(3 * N) + 4 * N * F +
         (size_t)kWarps * N * (F + 1) + kWarps * pad4(3 * N) + pad4(3 * N) +
         (size_t)2 * kThreads * F;
}

// ------------------------------------------------------------------ K2

template <int F>
__global__ void __launch_bounds__(kThreads, 2)
egcl_fwd_kernel(const float* __restrict__ h, const float* __restrict__ x,
                const float* __restrict__ ea, const float* __restrict__ wts,
                float* __restrict__ h_out, float* __restrict__ x_out, Cfg c) {
  static_assert(F % 4 == 0 && F <= 32, "F must be a multiple of 4, at most 32");
  extern __shared__ float4 smem4[];
  const WOff o = woff(F);
  const int N = c.N, FP = F + 1;
  float* w = reinterpret_cast<float*>(smem4);
  float* sh = w + o.total;
  float* ssrc = sh + N * F;
  float* sdst = ssrc + N * FP;
  float* sx = sdst + N * FP;
  float* sagg = sx + pad4(3 * N);
  float* stmp = sagg + N * F;
  float* zs = stmp + kWarps * F + threadIdx.x;  // this thread's z2 slot
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_chain<F>(h, x, wts, smem4, o, c, b, sh, sx, ssrc, sdst);

  const float* eab = ea + (size_t)b * N * N;
  float* xo = x_out + (size_t)b * N * 3;
  const int npass = (N + 31) / 32;
  for (int i = warp; i < N; i += kWarps) {
    const float* si = ssrc + i * FP;
    const float xi0 = sx[3 * i], xi1 = sx[3 * i + 1], xi2 = sx[3 * i + 2];
    float agg = 0.f;  // lane g keeps feature g of the row's aggregation
    float sw = 0.f, swx0 = 0.f, swx1 = 0.f, swx2 = 0.f;
    for (int p = 0; p < npass; ++p) {
      // every lane runs an edge so the row sums can shuffle; a lane past N,
      // or on the masked diagonal, runs the diagonal and contributes 0
      const int j = lane + 32 * p;
      const bool valid = j < N && j != i;
      const int jj = valid ? j : i;
      const float xj0 = sx[3 * jj], xj1 = sx[3 * jj + 1], xj2 = sx[3 * jj + 2];
      const float d0 = xi0 - xj0, d1 = xi1 - xj1, d2 = xi2 - xj2;
      const float rad = d0 * d0 + d1 * d1 + d2 * d2;
      const float den = sqrtf(rad + 1e-8f) + 1.f;
      const float att = edge_z2_att<F>(w, o, si, sdst + jj * FP, rad, eab[i * N + jj], c, zs);
      float cz[F];
      edge_cz<F, true>(w, o, zs, att, c.bf16, valid ? 1.f : 0.f, lane, cz, agg);
      const float cm = edge_cm<F>(w, o, cz);
      const float a = c.tanh ? tanhf(cm) * c.coords_range : cm;
      const float wij = valid ? a / den : 0.f;
      sw += wij;
      swx0 += wij * xj0;
      swx1 += wij * xj1;
      swx2 += wij * xj2;
    }
    if (lane < F) sagg[i * F + lane] = agg;
    sw = warp_sum(sw);
    swx0 = warp_sum(swx0);
    swx1 = warp_sum(swx1);
    swx2 = warp_sum(swx2);
    if (lane == 0) {
      xo[3 * i + 0] = xi0 + xi0 * sw - swx0;
      xo[3 * i + 1] = xi1 + xi1 * sw - swx1;
      xo[3 * i + 2] = xi2 + xi2 * sw - swx2;
    }
  }
  __syncthreads();

  // node MLP: warp per node, lane per output feature
  float* t = stmp + warp * F;
  for (int n = warp; n < N; n += kWarps) {
    if (lane < F) {
      float s = 0.f;
      for (int q = 0; q < F; ++q) s += rnd(sh[n * F + q], c.bf16) * w[o.n1 + q * F + lane];
      for (int q = 0; q < F; ++q)
        s += rnd(sagg[n * F + q], c.bf16) * w[o.n1 + (F + q) * F + lane];
      t[lane] = rnd(silu(s + w[o.bn1 + lane]), c.bf16);
    }
    __syncwarp();
    if (lane < F) {
      float s = 0.f;
      for (int q = 0; q < F; ++q) s += t[q] * w[o.n2 + q * F + lane];
      h_out[((size_t)b * N + n) * F + lane] = sh[n * F + lane] + s + w[o.bn2 + lane];
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------ K3

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
egcl_bwd_kernel(const float* __restrict__ h, const float* __restrict__ x,
                const float* __restrict__ ea, const float* __restrict__ gh,
                const float* __restrict__ gx, const float* __restrict__ wts,
                float* __restrict__ dh, float* __restrict__ dx,
                float* __restrict__ dea, Cfg c) {
  static_assert(F % 4 == 0 && F <= 32, "F must be a multiple of 4, at most 32");
  extern __shared__ float4 smem4[];
  const WOff o = woff(F);
  const int N = c.N, FP = F + 1, X3 = pad4(3 * N);
  float* w = reinterpret_cast<float*>(smem4);
  float* sh = w + o.total;
  float* ssrc = sh + N * F;
  float* sdst = ssrc + N * FP;  // dst, later the cotangent of dst
  float* sx = sdst + N * FP;
  float* sagg = sx + X3;
  float* sghd = sagg + N * F;   // gh + cotangent of h through the node MLP
  float* sgagg = sghd + N * F;  // cotangent of agg
  float* sgsrc = sgagg + N * F; // cotangent of src (row sums over j)
  float* slab = sgsrc + N * F;  // per-warp column sums of the dst cotangent
  float* slabx = slab + kWarps * N * FP;  // per-warp column sums for x_j
  float* sdxr = slabx + kWarps * X3;      // row part of dx
  float* zs = sdxr + X3 + threadIdx.x;    // this thread's z2 slot
  float* gs = zs + kThreads * F;          // this thread's slot for dL/dm
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < kWarps * N * FP; k += kThreads) slab[k] = 0.f;
  for (int k = tid; k < kWarps * X3; k += kThreads) slabx[k] = 0.f;
  load_chain<F>(h, x, wts, smem4, o, c, b, sh, sx, ssrc, sdst);

  const float* eab = ea + (size_t)b * N * N;
  const float* ghb = gh + (size_t)b * N * F;
  const float* gxb = gx + (size_t)b * N * 3;
  float* deab = dea + (size_t)b * N * N;
  const int npass = (N + 31) / 32;

  // P1: recompute the aggregation (first edge product only); lanes without
  // an edge run the diagonal and contribute 0, as in the forward
  for (int i = warp; i < N; i += kWarps) {
    const float* si = ssrc + i * FP;
    float agg = 0.f;
    for (int p = 0; p < npass; ++p) {
      const int j = lane + 32 * p;
      const bool valid = j < N && j != i;
      const int jj = valid ? j : i;
      const float d0 = sx[3 * i] - sx[3 * jj], d1 = sx[3 * i + 1] - sx[3 * jj + 1],
                  d2 = sx[3 * i + 2] - sx[3 * jj + 2];
      const float rad = d0 * d0 + d1 * d1 + d2 * d2;
      const float att = edge_z2_att<F>(w, o, si, sdst + jj * FP, rad, eab[i * N + jj], c, zs);
#pragma unroll 4
      for (int g = 0; g < F; ++g)
        row_sum_to_lane(silu(zs[g * kThreads]) * att, valid ? 1.f : 0.f, g, lane, agg);
    }
    if (lane < F) sagg[i * F + lane] = agg;
  }
  __syncthreads();

  // P2: node MLP backward, warp per node, lane per feature
  for (int n = warp; n < N; n += kWarps) {
    float nz = 0.f;
    if (lane < F) {
      for (int q = 0; q < F; ++q) nz += rnd(sh[n * F + q], c.bf16) * w[o.n1 + q * F + lane];
      for (int q = 0; q < F; ++q)
        nz += rnd(sagg[n * F + q], c.bf16) * w[o.n1 + (F + q) * F + lane];
      nz += w[o.bn1 + lane];
    }
    const float ghn = lane < F ? ghb[n * F + lane] : 0.f;
    // cotangent of silu(nz)_k = sum_g gh_g Wn2[k][g]; lane k keeps it
    float gnz = 0.f;
    for (int k = 0; k < F; ++k) {
      const float v = warp_sum(lane < F ? ghn * w[o.n2 + k * F + lane] : 0.f);
      if (lane == k) gnz = v;
    }
    gnz = lane < F ? gnz * dsilu(nz) : 0.f;
    // cotangent of node_in = [h, agg]: sum_k gnz_k Wn1[q][k]
    for (int q = 0; q < 2 * F; ++q) {
      const float v = warp_sum(lane < F ? gnz * w[o.n1 + q * F + lane] : 0.f);
      if (lane == 0) {
        if (q < F)
          sghd[n * F + q] = ghb[n * F + q] + v;
        else
          sgagg[n * F + q - F] = v;
      }
    }
  }
  __syncthreads();

  // P3: edge backward, warp per receiver row i, lane per edge (i, j); lanes
  // without an edge run the diagonal (finite) and their results are masked
  for (int i = warp; i < N; i += kWarps) {
    const float* si = ssrc + i * FP;
    const float* gai = sgagg + i * F;
    const float xi0 = sx[3 * i], xi1 = sx[3 * i + 1], xi2 = sx[3 * i + 2];
    const float gxi0 = gxb[3 * i], gxi1 = gxb[3 * i + 1], gxi2 = gxb[3 * i + 2];
    float dxr0 = 0.f, dxr1 = 0.f, dxr2 = 0.f;
    float gsrc = 0.f;  // lane f keeps feature f of the row's src cotangent
    for (int p = 0; p < npass; ++p) {
      const int j = lane + 32 * p;
      const bool valid = j < N && j != i;
      const float vm = valid ? 1.f : 0.f;
      const int jj = valid ? j : i;
      const float* dj = sdst + jj * FP;
      const float d0 = xi0 - sx[3 * jj], d1 = xi1 - sx[3 * jj + 1], d2 = xi2 - sx[3 * jj + 2];
      const float rad = d0 * d0 + d1 * d1 + d2 * d2;
      const float nrm = sqrtf(rad + 1e-8f);
      const float den = nrm + 1.f;
      const float eij = eab[i * N + jj];
      const float att = edge_z2_att<F>(w, o, si, dj, rad, eij, c, zs);
      float cz[F];
      float unused = 0.f;
      edge_cz<F, false>(w, o, zs, att, c.bf16, vm, lane, cz, unused);
      const float cm = edge_cm<F>(w, o, cz);
      const float th = c.tanh ? tanhf(cm) : 0.f;
      const float a = c.tanh ? th * c.coords_range : cm;
      const float wij = a / den;
      // x_out_i = x_i + sum_j w_ij (x_i - x_j)
      const float g_w = (gxi0 * d0 + gxi1 * d1 + gxi2 * d2) * vm;
      const float g_den = -g_w * wij / den;
      const float g_cm = (g_w / den) * (c.tanh ? c.coords_range * (1.f - th * th) : 1.f);
#pragma unroll
      for (int k = 0; k < F; ++k) cz[k] = g_cm * w[o.c2 + k] * dsilu(cz[k]);
      // cotangent of m: the row's aggregation plus the coordinate MLP
      float g_att = 0.f;
#pragma unroll 2
      for (int g = 0; g < F; ++g) {
        const float4* row = reinterpret_cast<const float4*>(w + o.c1 + g * F);
        float s = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < F / 4; ++k4) {
          const float4 v = row[k4];
          s += cz[4 * k4] * v.x + cz[4 * k4 + 1] * v.y + cz[4 * k4 + 2] * v.z +
               cz[4 * k4 + 3] * v.w;
        }
        const float gm = (gai[g] + s) * vm;
        gs[g * kThreads] = gm;
        g_att += gm * silu(zs[g * kThreads]);
      }
      const float g_l = c.attention ? g_att * att * (1.f - att) : 0.f;
      float gz2[F];
#pragma unroll
      for (int g = 0; g < F; ++g)
        gz2[g] = (gs[g * kThreads] * att + g_l * w[o.att + g]) * dsilu(zs[g * kThreads]);
      float g_rad = 0.f, g_ea = 0.f;
      float* sdj = slab + (warp * N + jj) * FP;
#pragma unroll 2
      for (int f = 0; f < F; ++f) {
        const float4* row = reinterpret_cast<const float4*>(w + o.e2 + f * F);
        float s = 0.f;
#pragma unroll
        for (int g4 = 0; g4 < F / 4; ++g4) {
          const float4 v = row[g4];
          s += gz2[4 * g4] * v.x + gz2[4 * g4 + 1] * v.y + gz2[4 * g4 + 2] * v.z +
               gz2[4 * g4 + 3] * v.w;
        }
        const float wr = w[o.scal + f], we = w[o.scal + F + f];
        const float z1 = (si[f] + dj[f]) + (rad * wr + eij * we);
        const float gz1 = s * dsilu(z1);
        g_rad += gz1 * wr;
        g_ea += gz1 * we;
        row_sum_to_lane(gz1, 1.f, f, lane, gsrc);
        if (valid) sdj[f] += gz1;
      }
      if (j < N) deab[i * N + j] = g_ea;  // 0 on the diagonal
      g_rad += g_den / (2.f * nrm);
      const float gd0 = 2.f * g_rad * d0 + wij * gxi0 * vm;
      const float gd1 = 2.f * g_rad * d1 + wij * gxi1 * vm;
      const float gd2 = 2.f * g_rad * d2 + wij * gxi2 * vm;
      dxr0 += gd0;
      dxr1 += gd1;
      dxr2 += gd2;
      if (valid) {
        float* sxj = slabx + warp * X3 + 3 * j;
        sxj[0] -= gd0;
        sxj[1] -= gd1;
        sxj[2] -= gd2;
      }
    }
    if (lane < F) sgsrc[i * F + lane] = gsrc;
    dxr0 = warp_sum(dxr0);
    dxr1 = warp_sum(dxr1);
    dxr2 = warp_sum(dxr2);
    if (lane == 0) {
      sdxr[3 * i] = dxr0;
      sdxr[3 * i + 1] = dxr1;
      sdxr[3 * i + 2] = dxr2;
    }
  }
  __syncthreads();

  // P4: column sums in a fixed warp order, then dh and dx
  for (int k = tid; k < N * F; k += kThreads) {
    const int n = k / F, f = k % F;
    float s = 0.f;
    for (int q = 0; q < kWarps; ++q) s += slab[(q * N + n) * FP + f];
    sdst[n * FP + f] = s;
  }
  float* dxb = dx + (size_t)b * N * 3;
  for (int k = tid; k < N * 3; k += kThreads) {
    float s = gxb[k] + sdxr[k];
    for (int q = 0; q < kWarps; ++q) s += slabx[q * X3 + k];
    dxb[k] = s;
  }
  __syncthreads();
  for (int n = warp; n < N; n += kWarps) {
    const float gs = lane < F ? sgsrc[n * F + lane] : 0.f;
    const float gd = lane < F ? sdst[n * FP + lane] : 0.f;
    float out = 0.f;
    for (int k = 0; k < F; ++k) {
      const float v = warp_sum(
          lane < F ? gs * w[o.src + k * F + lane] + gd * w[o.dst + k * F + lane] : 0.f);
      if (lane == k) out = v;
    }
    if (lane < F) dh[((size_t)b * N + n) * F + lane] = sghd[n * F + lane] + out;
  }
}

template <int F>
int launch_fwd(const float* h, const float* x, const float* ea, const float* wts,
               float* h_out, float* x_out, int B, const Cfg& c, cudaStream_t s) {
  const size_t bytes = fwd_smem_floats<F>(c.N) * sizeof(float);
  const int err = prepare(egcl_fwd_kernel<F>, bytes);
  if (err) return err;
  egcl_fwd_kernel<F><<<B, kThreads, bytes, s>>>(h, x, ea, wts, h_out, x_out, c);
  return (int)cudaGetLastError();
}

template <int F>
int launch_bwd(const float* h, const float* x, const float* ea, const float* gh,
               const float* gx, const float* wts, float* dh, float* dx, float* dea,
               int B, const Cfg& c, cudaStream_t s) {
  const size_t bytes = bwd_smem_floats<F>(c.N) * sizeof(float);
  const int err = prepare(egcl_bwd_kernel<F>, bytes);
  if (err) return err;
  egcl_bwd_kernel<F><<<B, kThreads, bytes, s>>>(h, x, ea, gh, gx, wts, dh, dx, dea, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Length in floats of the packed weight buffer for hidden width F.
extern "C" int pita_egcl_weights_len(int F) { return woff(F).total; }

// Shared memory bytes one block needs (0 if F is not supported).
extern "C" long long pita_egcl_smem_bytes(int N, int F, int backward) {
  switch (F) {
    case 16: return (long long)((backward ? bwd_smem_floats<16>(N) : fwd_smem_floats<16>(N)) * sizeof(float));
    case 32: return (long long)((backward ? bwd_smem_floats<32>(N) : fwd_smem_floats<32>(N)) * sizeof(float));
    default: return 0;
  }
}

// h: (B, N, F), x: (B, N, 3), ea: (B, N, N), wts: packed weights (16-byte
// aligned) → h_out (B, N, F), x_out (B, N, 3). All f32, contiguous.
extern "C" int pita_egcl_forward(const float* h, const float* x, const float* ea,
                                 const float* wts, float* h_out, float* x_out,
                                 int B, int N, int F, int bf16, int attention,
                                 int tanh, float coords_range, void* stream) {
  if (B <= 0) return 0;
  const Cfg c{N, bf16, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16: return launch_fwd<16>(h, x, ea, wts, h_out, x_out, B, c, s);
    case 32: return launch_fwd<32>(h, x, ea, wts, h_out, x_out, B, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The VJP of pita_egcl_forward with respect to (h, x, ea) for cotangents
// gh (B, N, F) and gx (B, N, 3) → dh (B, N, F), dx (B, N, 3), dea (B, N, N).
extern "C" int pita_egcl_backward(const float* h, const float* x, const float* ea,
                                  const float* gh, const float* gx, const float* wts,
                                  float* dh, float* dx, float* dea, int B, int N,
                                  int F, int bf16, int attention, int tanh,
                                  float coords_range, void* stream) {
  if (B <= 0) return 0;
  const Cfg c{N, bf16, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16: return launch_bwd<16>(h, x, ea, gh, gx, wts, dh, dx, dea, B, c, s);
    case 32: return launch_bwd<32>(h, x, ea, gh, gx, wts, dh, dx, dea, B, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
