// K3 in f32 on tensor cores: the VJP of one EGCL layer with respect to (h, x,
// edge_attr) in f32 compute, its products in 3xTF32, sm_90a.
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/egnn_fwd.py:169
// _layer_bwd_kernel (called through _layer_bwd_call, egnn_fwd.py:335,
// pallas_call at :342) for compute dtype f32, as egnn_layer_tc.cu's K3 does
// for bf16. The function is the scalar egcl_bwd_kernel's (egnn_layer.cu) in
// f32: nothing is rounded; every product is f32, taken as three TF32
// products (mma_tf32.cuh, ~2^-21 relative), and every sigmoid keeps the
// overflow-safe form of egnn_fwd.py:67 in f32 (sigm_fast: an exponential and
// a reciprocal, ~1e-6 relative; the bf16 kernels' tanh.approx would err by
// 2^-11). Weight cotangents are not computed (inference only).
//
// What bounds it on the H100: per edge the VJP needs the forward's two F x F
// products and their two transposes; with the node products 5.2e10
// operations at 2,048 chains, N = 55, F = 32, 0.32 ms at a third of the TF32
// dense peak, while the 3F + 2 sigmoids and tanhs per edge take 0.14 ms at
// one SFU operation each. The scalar K3 ran the products on the FP32 pipes
// at 1 block an SM: 9.9-10.2 ms at 2,048 chains against this kernel's 2.58
// (chip_smoke.py phase 3, H100 80GB HBM3 at 700 W). The design is the bf16
// K3's (egnn_layer_tc.cu) with the products of the f32 K2
// (egnn_layer_f32tc.cu):
//  - One block of 4 warps per chain; warp w owns the senders j of tile w
//    (16 edges, one m16 tile; N <= 64) and walks over all receivers i.
//  - Three passes: the aggregation agg_i = sum_j m_ij (one edge product per
//    edge), the node MLP backward (one 16-node tile per warp), then the edge
//    pass, which rebuilds the edge chain z1 -> silu -> .W_e2 -> z2 -> silu*att
//    -> .W_c1 -> cz and runs its backward through .W_c1^T and .W_e2^T. Every
//    product is m16n8k8 TF32 mma.sync, three a product (mm3: lo hi, hi lo,
//    hi hi), with f32 accumulators; each accumulator tile is split into TF32
//    hi + lo A fragments in registers (to_frag_tf32) for the next product,
//    so no edge vector goes through shared memory. A lane holds 2 edges x
//    F/4 features of every F-vector.
//  - Each pass computes every sigmoid once and keeps it for its derivative:
//    2F + 1 per edge in the aggregation pass, 3F + 2 in the edge pass.
//  - Sums over a tile's senders for a fixed receiver (agg_i, the src
//    cotangent) are in-lane adds plus a 3-level reduce-scatter (col_sum),
//    after which each lane owns one feature. The x_j cotangent stays in the
//    owning warp's registers across all i, the dst cotangent in its own rows
//    of shared memory. The warps visit the receivers in lockstep with their
//    start points N/T apart, so at each step they add into distinct rows of
//    the per-chain sums: no atomics, a fixed order, two launches bitwise
//    equal.
//  - The weights in TF32 hi + lo are four times the bf16 ones: W_e2, W_c1,
//    W_c1^T and W_e2^T (32 KB at F = 32) wait in shared memory, where a lane
//    reads its B fragment as one float4; the node matrices (W_src | W_dst,
//    W_n1, W_n2^T, W_n1^T and [W_src^T ; W_dst^T]) are read from global
//    memory (L2) once a block.
//  - Shared memory: those four matrices, the vectors and the chain's node
//    state, 74.3 KB at F = 32, N = 55, so three blocks fit on an SM. The
//    kernel asks for three, at 168 registers a thread (44 bytes spilled): at
//    2,000 chains 2.53-2.57 ms against 2.85-2.91 at two blocks and 214
//    registers with no spill; at the fill's 256 chains, one wave either way,
//    0.36-0.37 against 0.35-0.36 (tests/f32tc_variants.py, two runs, H100
//    80GB HBM3 at 700 W). The lj55 preset's fills run 5,000 chains.
//  - Padded rows (j >= N) and the diagonal run the diagonal's finite values
//    and are masked out of every sum.

#include "egnn_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

#include <cstdint>

namespace {

constexpr int kB32Warps = 4;
constexpr int kB32Threads = 32 * kB32Warps;
constexpr int kB32MaxN = 16 * kB32Warps;  // one 16-sender tile per warp
// three blocks (12 warps) an SM: 168 registers a thread, 44 bytes spilled;
// the shared memory (74.3 KB at F = 32, N = 55) fits three times
constexpr int kB32MinBlocks = 3;

template <int F>
size_t bwd_f32tc_smem_floats(int N) {
  const int FS = F + 8;
  return (size_t)8 * F * F + 6 * F + 4 + (size_t)N * (3 * F + 2 * FS) + 3 * pad4(3 * N);
}

struct Smem {
  const float4 *e2, *c1, *c1t, *e2t;  // fragment layout (mma_tf32.cuh)
  const float *wr, *we, *be2, *watt, *bc1, *wc2, *batt;
  // rows of F floats: src, agg, gagg (a warp reads one row at a time);
  // rows of F + 8: dst, gdst (a warp reads 8 rows at once, on distinct banks)
  float *src, *dst, *gdst, *agg, *gagg, *x, *gx, *dxr;
};

// The front of the edge chain for receiver i and the lane's edges: z1 and
// its sigmoid derivative (ds1, if wanted), the product to z2, m_pre =
// silu(z2), its derivative (ds2, if wanted) and the attention gate per row.
template <int F, bool GRAD>
__device__ __forceinline__ void edge_front(const Smem& s, const Geo& e, int i, const Cfg& c,
                                           int lane, float (&ds1)[2][F / 4],
                                           float (&mp)[2][F / 4], float (&ds2)[2][F / 4],
                                           float (&att)[2]) {
  constexpr int V = F / 4, FS = F + 8, K8 = F / 8;
  const int t = lane & 3;
  uint32_t ah[K8][4], al[K8][4];
  {
    float z[2][V];
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      const int col = col_of(v, t);
      const float2 si = *reinterpret_cast<const float2*>(s.src + i * F + col);
      const float2 wr = *reinterpret_cast<const float2*>(s.wr + col);
      const float2 we = *reinterpret_cast<const float2*>(s.we + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 dj = *reinterpret_cast<const float2*>(s.dst + e.jj[r] * FS + col);
        z[r][v] = (si.x + dj.x) + (e.rad[r] * wr.x + e.eij[r] * we.x);
        z[r][v + 1] = (si.y + dj.y) + (e.rad[r] * wr.y + e.eij[r] * we.y);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float sg = sigm_fast(z[r][v]);
        if (GRAD) ds1[r][v] = sg * (1.f + z[r][v] * (1.f - sg));
        z[r][v] *= sg;  // silu(z1)
      }
    to_frag_tf32<F>(z, ah, al);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) mp[0][v] = mp[1][v] = s.be2[col_of(v, t)];
  mm3<F, F>(mp, ah, al, s.e2, lane);  // z2
  float lg[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float z2 = mp[r][v];
      const float sg = sigm_fast(z2);
      mp[r][v] = z2 * sg;
      if (GRAD) ds2[r][v] = sg * (1.f + z2 * (1.f - sg));
      lg[r] += mp[r][v] * s.watt[col_of(v, t)];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    att[r] = c.attention ? sigm_fast(quad_sum(lg[r]) + s.batt[0]) : 1.f;
}

template <int F>
__global__ void __launch_bounds__(kB32Threads, kB32MinBlocks)
egcl_bwd_f32tc_kernel(const float* __restrict__ h, const float* __restrict__ x,
                      const float* __restrict__ ea, const float* __restrict__ gh,
                      const float* __restrict__ gx, const float* __restrict__ wts,
                      const float* __restrict__ wtf, float* __restrict__ dh,
                      float* __restrict__ dx, float* __restrict__ dea, Cfg c) {
  static_assert(F == 16 || F == 32, "F must be 16 or 32");
  constexpr int V = F / 4, FS = F + 8, K8 = F / 8;
  extern __shared__ float4 smem4[];
  const WOff o = woff(F);
  const TfOff q = tfoff(F);
  const int N = c.N, X3 = pad4(3 * N), tid = threadIdx.x;
  const int b = blockIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3;
  const int T = (N + 15) / 16;      // sender tiles, one per warp
  const int off = (N + T - 1) / T;  // lockstep offset between the warps' receivers
  const float4* wg4 = reinterpret_cast<const float4*>(wtf);

  // W_e2, W_c1, W_c1^T, W_e2^T: 2 F^2 floats (F^2 / 2 float4) each
  float* vec = reinterpret_cast<float*>(smem4 + 2 * F * F);
  Smem s;
  s.e2 = smem4;
  s.c1 = smem4 + F * F / 2;
  s.c1t = smem4 + F * F;
  s.e2t = smem4 + 3 * F * F / 2;
  s.wr = vec;
  s.we = vec + F;
  s.be2 = vec + 2 * F;
  s.watt = vec + 3 * F;
  s.bc1 = vec + 4 * F;
  s.wc2 = vec + 5 * F;
  s.batt = vec + 6 * F;
  s.src = vec + 6 * F + 4;
  s.dst = s.src + N * F;
  s.gdst = s.dst + N * FS;
  s.agg = s.gdst + N * FS;  // later the src cotangent
  s.gagg = s.agg + N * F;
  s.x = s.gagg + N * F;
  s.gx = s.x + X3;
  s.dxr = s.gx + X3;

  // prologue: edge matrices, vectors, coordinates; zeroed sums
  {
    for (int k = tid; k < 3 * F * F / 2; k += kB32Threads) smem4[k] = wg4[k];  // e2, c1, c1t
    for (int k = tid; k < F * F / 2; k += kB32Threads)
      smem4[3 * F * F / 2 + k] = wg4[q.e2t / 4 + k];
    for (int k = tid; k < F; k += kB32Threads) {
      vec[k] = wts[o.scal + k];
      vec[F + k] = wts[o.scal + F + k];
      vec[2 * F + k] = wts[o.be2 + k];
      vec[3 * F + k] = wts[o.att + k];
      vec[4 * F + k] = wts[o.bc1 + k];
      vec[5 * F + k] = wts[o.c2 + k];
    }
    if (tid == 0) vec[6 * F] = wts[o.batt];
    const float* xb = x + (size_t)b * N * 3;
    const float* gxb = gx + (size_t)b * N * 3;
    for (int k = tid; k < 3 * N; k += kB32Threads) {
      s.x[k] = xb[k];
      s.gx[k] = gxb[k];
      s.dxr[k] = 0.f;
    }
    for (int k = tid; k < N * F; k += kB32Threads) s.agg[k] = 0.f;
    for (int k = tid; k < N * FS; k += kB32Threads) s.gdst[k] = 0.f;
  }
  const float* hb = h + (size_t)b * N * F;
  const float* ghb = gh + (size_t)b * N * F;
  float* dhb = dh + (size_t)b * N * F;
  const int n0 = 16 * warp;  // this warp's node tile and sender tile
  if (warp < T) {  // src | dst = h [W_src | W_dst] + [b_src | 0]
    float hv[2][V];
    load_tile<F>(hv, hb, F, n0, N, lane);
    uint32_t ah[K8][4], al[K8][4];
    to_frag_tf32<F>(hv, ah, al);
    float sd[2][2 * V];
#pragma unroll
    for (int v = 0; v < 2 * V; ++v) {
      const int col = col_of(v, t);
      sd[0][v] = sd[1][v] = col < F ? wts[o.bsrc + col] : 0.f;
    }
    mm3<F, 2 * F>(sd, ah, al, wg4 + q.sd / 4, lane);
    store_tile<F, 2 * F>(sd, 0, s.src, F, n0, N, lane);
    store_tile<F, 2 * F>(sd, F, s.dst, FS, n0, N, lane);
  }
  __syncthreads();

  const float* eab = ea + (size_t)b * N * N;
  float ds_unused[2][V];

  // P1: the aggregation agg_i = sum_j m_ij (first edge product only)
  for (int step = 0; step < N; ++step) {
    if (warp < T) {
      const int i = (step + warp * off) % N;
      Geo e;
      edge_geo(e, s.x, eab, i, n0, N, lane);
      float mp[2][V], att[2];
      edge_front<F, false>(s, e, i, c, lane, ds_unused, mp, ds_unused, att);
      float p[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        p[v] = mp[0][v] * (att[0] * e.vm[0]) + mp[1][v] * (att[1] * e.vm[1]);
      int vi;
      const float tot = col_sum<V>(p, lane, vi);
      if (V == 8 || !(lane & 4)) s.agg[i * F + col_of(vi, t)] += tot;
    }
    __syncthreads();
  }

  // P2: node MLP backward, one 16-node tile per warp; dh gets gh + its part
  if (warp < T) {
    float nz[2][V];
    {
      uint32_t ah[2 * K8][4], al[2 * K8][4];
      float hv[2][V], av[2][V];
      load_tile<F>(hv, hb, F, n0, N, lane);
      load_tile<F>(av, s.agg, F, n0, N, lane);
      to_frag_tf32<F>(hv, ah, al);
      to_frag_tf32<F>(av, ah + K8, al + K8);
#pragma unroll
      for (int v = 0; v < V; ++v) nz[0][v] = nz[1][v] = wts[o.bn1 + col_of(v, t)];
      mm3<2 * F, F>(nz, ah, al, wg4 + q.n1 / 4, lane);
    }
    float ghv[2][V], gs[2][V];
    load_tile<F>(ghv, ghb, F, n0, N, lane);
    uint32_t ah[K8][4], al[K8][4];
    to_frag_tf32<F>(ghv, ah, al);
#pragma unroll
    for (int v = 0; v < V; ++v) gs[0][v] = gs[1][v] = 0.f;
    mm3<F, F>(gs, ah, al, wg4 + q.n2t / 4, lane);  // gh W_n2^T
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) gs[r][v] *= dsilu(nz[r][v]);
    to_frag_tf32<F>(gs, ah, al);
    float gin[2][2 * V];
#pragma unroll
    for (int v = 0; v < 2 * V; ++v) gin[0][v] = gin[1][v] = 0.f;
    mm3<F, 2 * F>(gin, ah, al, wg4 + q.n1t / 4, lane);  // [g_h | g_agg] = g_nz W_n1^T
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) gin[r][v] += ghv[r][v];
    store_tile<F, 2 * F>(gin, 0, dhb, F, n0, N, lane);
    store_tile<F, 2 * F>(gin, F, s.gagg, F, n0, N, lane);
  }
  __syncthreads();
  for (int k = tid; k < N * F; k += kB32Threads) s.agg[k] = 0.f;  // now the src cotangent
  __syncthreads();

  // P3: edge backward; the sender tile's x cotangent in registers, its dst
  // cotangent in the warp's own rows of gdst
  float dxj[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) dxj[r][0] = dxj[r][1] = dxj[r][2] = 0.f;
  float* deab = dea + (size_t)b * N * N;
  for (int step = 0; step < N; ++step) {
    if (warp < T) {
      const int i = (step + warp * off) % N;
      Geo e;
      edge_geo(e, s.x, eab, i, n0, N, lane);
      float ds1[2][V], mp[2][V], ds2[2][V], att[2];
      edge_front<F, true>(s, e, i, c, lane, ds1, mp, ds2, att);
      // cz = (m_pre * att) W_c1 + b_c1, its sigmoid kept as silu'(cz)
      float cz[2][V];
      {
        uint32_t ah[K8][4], al[K8][4];
        {
          float m[2][V];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int v = 0; v < V; ++v) m[r][v] = mp[r][v] * att[r];
          to_frag_tf32<F>(m, ah, al);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) cz[0][v] = cz[1][v] = s.bc1[col_of(v, t)];
        mm3<F, F>(cz, ah, al, s.c1, lane);
      }
      float cm[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float z = cz[r][v];
          const float sg = sigm_fast(z);
          cm[r] += z * sg * s.wc2[col_of(v, t)];
          cz[r][v] = sg * (1.f + z * (1.f - sg));  // silu'(cz)
        }
      const float gxi0 = s.gx[3 * i], gxi1 = s.gx[3 * i + 1], gxi2 = s.gx[3 * i + 2];
      float nrm[2], wij[2], gden[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float cmr = quad_sum(cm[r]);
        nrm[r] = sqrtf(e.rad[r] + 1e-8f);
        const float den = nrm[r] + 1.f;
        const float th = c.tanh ? tanhf(cmr) : 0.f;
        wij[r] = (c.tanh ? th * c.coords_range : cmr) / den;
        // x_out_i = x_i + sum_j w_ij (x_i - x_j); masked before any derivative
        const float g_w = (gxi0 * e.d[r][0] + gxi1 * e.d[r][1] + gxi2 * e.d[r][2]) * e.vm[r];
        gden[r] = -g_w * wij[r] / den;
        const float g_cm = (g_w / den) * (c.tanh ? c.coords_range * (1.f - th * th) : 1.f);
#pragma unroll
        for (int v = 0; v < V; ++v) cz[r][v] *= g_cm * s.wc2[col_of(v, t)];  // g_cz
      }
      // g_m = g_agg_i + g_cz W_c1^T, masked; then the attention's cotangent
      float gm[2][V];
      {
        uint32_t ah[K8][4], al[K8][4];
        to_frag_tf32<F>(cz, ah, al);
#pragma unroll
        for (int v = 0; v < V; ++v) gm[0][v] = gm[1][v] = s.gagg[i * F + col_of(v, t)];
        mm3<F, F>(gm, ah, al, s.c1t, lane);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ga = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          gm[r][v] *= e.vm[r];
          ga += gm[r][v] * mp[r][v];
        }
        const float g_l = c.attention ? quad_sum(ga) * att[r] * (1.f - att[r]) : 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v)
          gm[r][v] = (gm[r][v] * att[r] + g_l * s.watt[col_of(v, t)]) * ds2[r][v];  // g_z2
      }
      // g_z1 = (g_z2 W_e2^T) * silu'(z1)
      float gz[2][V];
      {
        uint32_t ah[K8][4], al[K8][4];
        to_frag_tf32<F>(gm, ah, al);
#pragma unroll
        for (int v = 0; v < V; ++v) gz[0][v] = gz[1][v] = 0.f;
        mm3<F, F>(gz, ah, al, s.e2t, lane);
      }
      float grad[2], gea[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        grad[r] = gea[r] = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          gz[r][v] *= ds1[r][v];
          grad[r] += gz[r][v] * s.wr[col_of(v, t)];
          gea[r] += gz[r][v] * s.we[col_of(v, t)];
        }
        grad[r] = quad_sum(grad[r]);
        gea[r] = quad_sum(gea[r]);
        if (e.j[r] < N) {
#pragma unroll
          for (int v = 0; v < V; v += 2) {
            float2* gd = reinterpret_cast<float2*>(s.gdst + e.j[r] * FS + col_of(v, t));
            const float2 o2 = *gd;
            *gd = make_float2(o2.x + gz[r][v], o2.y + gz[r][v + 1]);
          }
        }
      }
      {
        float p[V];
#pragma unroll
        for (int v = 0; v < V; ++v) p[v] = gz[0][v] + gz[1][v];
        int vi;
        const float tot = col_sum<V>(p, lane, vi);
        if (V == 8 || !(lane & 4)) s.agg[i * F + col_of(vi, t)] += tot;
      }
      float dr[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (t == 0 && e.j[r] < N) deab[i * N + e.j[r]] = gea[r];  // 0 on the diagonal
        const float gr = grad[r] + gden[r] / (2.f * nrm[r]);
        const float gd0 = 2.f * gr * e.d[r][0] + wij[r] * gxi0 * e.vm[r];
        const float gd1 = 2.f * gr * e.d[r][1] + wij[r] * gxi1 * e.vm[r];
        const float gd2 = 2.f * gr * e.d[r][2] + wij[r] * gxi2 * e.vm[r];
        dxj[r][0] -= gd0;
        dxj[r][1] -= gd1;
        dxj[r][2] -= gd2;
        dr[0] += gd0;
        dr[1] += gd1;
        dr[2] += gd2;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dr[k] += __shfl_xor_sync(0xffffffffu, dr[k], 4);
        dr[k] += __shfl_xor_sync(0xffffffffu, dr[k], 8);
        dr[k] += __shfl_xor_sync(0xffffffffu, dr[k], 16);
      }
      if (lane == 0) {
        s.dxr[3 * i] += dr[0];
        s.dxr[3 * i + 1] += dr[1];
        s.dxr[3 * i + 2] += dr[2];
      }
    }
    __syncthreads();
  }

  // dx of the senders
  if (warp < T) {
    float* dxb = dx + (size_t)b * N * 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = n0 + (lane >> 2) + 8 * r;
      if (t == 0 && j < N)
        for (int k = 0; k < 3; ++k) dxb[3 * j + k] = s.gx[3 * j + k] + s.dxr[3 * j + k] + dxj[r][k];
    }
  }
  __syncthreads();

  // dh += [g_src | g_dst] [W_src^T ; W_dst^T]
  if (warp < T) {
    uint32_t ah[2 * K8][4], al[2 * K8][4];
    {
      float gv[2][V], dv[2][V];
      load_tile<F>(gv, s.agg, F, n0, N, lane);
      load_tile<F>(dv, s.gdst, FS, n0, N, lane);
      to_frag_tf32<F>(gv, ah, al);
      to_frag_tf32<F>(dv, ah + K8, al + K8);
    }
    float out[2][V];
    load_tile<F>(out, dhb, F, n0, N, lane);
    mm3<2 * F, F>(out, ah, al, wg4 + q.sdt / 4, lane);
    store_tile<F, F>(out, 0, dhb, F, n0, N, lane);
  }
}

template <int F>
int launch_bwd_f32tc(const float* h, const float* x, const float* ea, const float* gh,
                     const float* gx, const float* wts, const float* wtf, float* dh, float* dx,
                     float* dea, int B, const Cfg& c, cudaStream_t s) {
  if (c.N < 1 || c.N > kB32MaxN) return (int)cudaErrorInvalidValue;
  const size_t bytes = bwd_f32tc_smem_floats<F>(c.N) * sizeof(float);
  const int err = prepare(egcl_bwd_f32tc_kernel<F>, bytes);
  if (err) return err;
  egcl_bwd_f32tc_kernel<F><<<B, kB32Threads, bytes, s>>>(h, x, ea, gh, gx, wts, wtf, dh, dx,
                                                         dea, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest N the kernel takes (one 16-sender tile per warp).
extern "C" int pita_egcl_bwd_tf32_max_n() { return kB32MaxN; }

// The VJP of pita_egcl_forward (csrc/egnn_layer.cu) in f32, on tensor cores:
// h (B, N, F), x (B, N, 3), ea (B, N, N) and the cotangents gh (B, N, F), gx
// (B, N, 3) -> dh (B, N, F), dx (B, N, 3), dea (B, N, N), all f32 and
// contiguous (h, gh and dh 8-byte aligned); wts is the f32 buffer of
// pack_weights(w), of which the vectors are read, wtf the matrices of
// pack_weights_tf32 (16-byte aligned). N <= pita_egcl_bwd_tf32_max_n().
extern "C" int pita_egcl_backward_tf32(const float* h, const float* x, const float* ea,
                                       const float* gh, const float* gx, const float* wts,
                                       const float* wtf, float* dh, float* dx, float* dea, int B,
                                       int N, int F, int attention, int tanh, float coords_range,
                                       void* stream) {
  if (B <= 0) return 0;
  const Cfg c{N, 0, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16: return launch_bwd_f32tc<16>(h, x, ea, gh, gx, wts, wtf, dh, dx, dea, B, c, s);
    case 32: return launch_bwd_f32tc<32>(h, x, ea, gh, gx, wts, wtf, dh, dx, dea, B, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
