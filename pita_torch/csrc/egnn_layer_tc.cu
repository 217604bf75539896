// The EGCL layer on tensor cores in bf16 compute, sm_90a: K3, the VJP with
// respect to (h, x, edge_attr) (this note), and K2, the forward (its note is
// at egcl_fwd_tc_kernel below). Both take the tile helpers of mma_bf16.cuh
// and the bf16 weight buffer of egnn_common.cuh (TcOff), as K4's
// egnn_tangent_tc.cu does.
//
// K3 replaces the Pallas TPU kernel pita_tpu/ops/pallas/egnn_fwd.py:169
// _layer_bwd_kernel (called through _layer_bwd_call, egnn_fwd.py:335) for
// compute dtype bf16; egnn_layer_bwd_f32tc.cu is the f32 one (3xTF32). The
// function is that of egnn_layer.cu's K3: matmul inputs rounded to bf16 in
// value, f32 accumulation, f32 elementwise math, and in the VJP the rounding
// counts as the identity, so cotangents stay f32.
//
// What bounds it on the H100: per chain the edge chain runs four F x F
// products per edge (two forward and two transposed), 0.06 ms at 2048 chains
// on bf16 tensor cores, while the sigmoids the function cannot avoid
// (sigma(z1), sigma(z2), sigma(cz), the attention gate and a tanh per edge,
// each an exponential and a reciprocal) take ~0.3 ms on the SFUs (16 per
// clock per SM). So the design keeps the elementwise work minimal and the
// products on mma.sync:
//  - The node MLP's backward needs agg_i = sum_j m_ij, which the forward
//    K2 already summed: K2 stores it (f32, as summed) for every launch that
//    records a backward, and K3 reads it. K3 no longer rebuilds it in a
//    pass of its own over every edge, which cost 2F+1 sigmoids an edge, a
//    block barrier a receiver and about a quarter of the instructions a
//    lane issued.
//  - One block of 4 warps per chain; warp w owns the senders j of tile w
//    (16 edges, one m16 tile; N <= 64) and walks over all receivers i.
//  - The edge chain z1 -> silu -> .W_e2 -> z2 -> silu*att -> .W_c1 -> cz runs
//    as m16n8k16 bf16 products with f32 accumulators. The accumulator layout
//    of two adjacent n8 tiles is the A-fragment layout of one k16 step, so
//    each product feeds the next in registers; no edge vector goes through
//    shared memory. A lane holds 2 edges x F/4 features of every F-vector.
//  - The transposed products (.W_c1^T, .W_e2^T) take f32 cotangents split
//    into hi = bf16(g) and lo = bf16(g - hi): two mmas against the exact bf16
//    weights give the f32 product to ~2^-16 relative.
//  - The edge pass computes each of its 3F+2 sigmoids an edge once and keeps
//    it for its derivative, with __expf and __fdividef in the overflow-safe
//    form of egnn_common.cuh.
//  - Scalar heads (attention logit, cm, the radial and edge_attr cotangents)
//    are quad shuffles; the sum over a tile's edges (the src cotangent) is
//    in-lane adds plus a 3-level reduce-scatter, after which each lane
//    owns one feature. The x_j cotangent stays in the owning warp's registers
//    across all i, the dst cotangent in its own rows of shared memory (in
//    registers it pushed the kernel past 128 registers, into spills). The
//    warps visit the receivers in lockstep with their start points N/T
//    apart, so at each step they add into distinct rows of the per-chain sums
//    in shared memory: no atomics, a fixed order, a deterministic result.
//  - The node parts (src/dst projection, node MLP backward, the final dh)
//    run on mma.sync too, one 16-node tile per warp.
//  - Shared memory: the four edge weight matrices as bf16 (the node ones are
//    read once per block from global memory) and the chain's node state,
//    51.8 KB at F=32, N=55, so four blocks (16 warps) fit on an SM.

#include "egnn_common.cuh"
#include "mma_bf16.cuh"

#include <cstdint>

namespace {

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMaxN = 16 * kTcWarps;  // one 16-sender tile per warp
// four blocks (16 warps) an SM: 128 registers a thread; the shared memory
// (51.8 KB at F=32, N=55) still fits four times
constexpr int kTcMinBlocks = 4;

template <int F>
size_t tc_smem_floats(int N) {
  const int FS = F + 8;
  return (size_t)2 * F * FS + 6 * F + 4 + (size_t)N * (3 * F + 2 * FS) + 3 * pad4(3 * N);
}

struct Smem {
  const __nv_bfloat16 *e2f, *c1f, *e2b, *c1b;
  const float *wr, *we, *be2, *watt, *bc1, *wc2, *batt;
  // rows of F floats: src, gsrc, gagg (a warp reads one row at a time);
  // rows of F + 8: dst, gdst (a warp reads 8 rows at once, on distinct banks)
  float *src, *dst, *gdst, *gsrc, *gagg, *x, *gx, *dxr;
};

// The front of the edge chain for receiver i and the lane's edges: z1 and
// its sigmoid derivative ds1, the products to z2, m_pre = silu(z2), its
// derivative ds2 and the attention gate per row.
template <int F>
__device__ __forceinline__ void edge_front(const Smem& s, const Geo& e, int i, const Cfg& c,
                                           int lane, float (&ds1)[2][F / 4],
                                           float (&mp)[2][F / 4], float (&ds2)[2][F / 4],
                                           float (&att)[2]) {
  constexpr int V = F / 4, FS = F + 8;
  const int t = lane & 3;
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
      ds1[r][v] = sg * (1.f + z[r][v] * (1.f - sg));
      z[r][v] *= sg;  // silu(z1)
    }
  uint32_t a[F / 16][4];
  to_frag<F>(z, a);
#pragma unroll
  for (int v = 0; v < V; ++v) mp[0][v] = mp[1][v] = s.be2[col_of(v, t)];
  mm<F, F>(mp, a, s.e2f, lane);  // z2
  float lg[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float z2 = mp[r][v];
      const float sg = sigm_fast(z2);
      mp[r][v] = z2 * sg;
      ds2[r][v] = sg * (1.f + z2 * (1.f - sg));
      lg[r] += mp[r][v] * s.watt[col_of(v, t)];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    att[r] = c.attention ? sigm_fast(quad_sum(lg[r]) + s.batt[0]) : 1.f;
}

template <int F>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
egcl_bwd_tc_kernel(const float* __restrict__ h, const float* __restrict__ x,
                   const float* __restrict__ ea, const float* __restrict__ agg,
                   const float* __restrict__ gh,
                   const float* __restrict__ gx, const float* __restrict__ wts,
                   const __nv_bfloat16* __restrict__ wtc, float* __restrict__ dh,
                   float* __restrict__ dx, float* __restrict__ dea, Cfg c) {
  static_assert(F == 16 || F == 32, "F must be 16 or 32");
  constexpr int V = F / 4, FS = F + 8, KS = F / 16;
  extern __shared__ float4 smem4[];
  const WOff o = woff(F);
  const TcOff q = tcoff(F);
  const int N = c.N, X3 = pad4(3 * N), tid = threadIdx.x;
  const int b = blockIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3;
  const int T = (N + 15) / 16;      // sender tiles, one per warp
  const int off = (N + T - 1) / T;  // lockstep offset between the warps' receivers

  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* vec = reinterpret_cast<float*>(wsm + 4 * F * FS);
  Smem s;
  s.e2f = wsm + q.e2f;
  s.c1f = wsm + q.c1f;
  s.e2b = wsm + q.e2b;
  s.c1b = wsm + q.c1b;
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
  s.gsrc = s.gdst + N * FS;
  s.gagg = s.gsrc + N * F;
  s.x = s.gagg + N * F;
  s.gx = s.x + X3;
  s.dxr = s.gx + X3;

  // prologue: edge weights, vectors, coordinates; zeroed sums
  {
    const uint4* wg = reinterpret_cast<const uint4*>(wtc);
    uint4* ws = reinterpret_cast<uint4*>(wsm);
    for (int k = tid; k < 4 * F * FS / 8; k += kTcThreads) ws[k] = wg[k];
    for (int k = tid; k < F; k += kTcThreads) {
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
    for (int k = tid; k < 3 * N; k += kTcThreads) {
      s.x[k] = xb[k];
      s.gx[k] = gxb[k];
      s.dxr[k] = 0.f;
    }
    for (int k = tid; k < N * F; k += kTcThreads) s.gsrc[k] = 0.f;
    for (int k = tid; k < N * FS; k += kTcThreads) s.gdst[k] = 0.f;
  }
  const float* hb = h + (size_t)b * N * F;
  const float* ghb = gh + (size_t)b * N * F;
  float* dhb = dh + (size_t)b * N * F;
  const int n0 = 16 * warp;  // this warp's node tile and sender tile
  if (warp < T) {  // src | dst = R(h) [W_src | W_dst] + [b_src | 0]
    float hv[2][V];
    load_tile<F>(hv, hb, F, n0, N, lane);
    uint32_t a[KS][4];
    to_frag<F>(hv, a);
    float sd[2][2 * V];
#pragma unroll
    for (int v = 0; v < 2 * V; ++v) {
      const int col = col_of(v, t);
      sd[0][v] = sd[1][v] = col < F ? wts[o.bsrc + col] : 0.f;
    }
    mm<F, 2 * F>(sd, a, wtc + q.sd, lane);
    store_tile<F, 2 * F>(sd, 0, s.src, F, n0, N, lane);
    store_tile<F, 2 * F>(sd, F, s.dst, FS, n0, N, lane);
  }
  __syncthreads();

  // node MLP backward, one 16-node tile per warp, on K2's f32 agg; dh gets
  // gh + its part
  if (warp < T) {
    uint32_t a[2 * KS][4];
    {
      float hv[2][V], av[2][V];
      load_tile<F>(hv, hb, F, n0, N, lane);
      load_tile<F>(av, agg + (size_t)b * N * F, F, n0, N, lane);
      to_frag<F>(hv, a);
      to_frag<F>(av, a + KS);
    }
    float nz[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) nz[0][v] = nz[1][v] = wts[o.bn1 + col_of(v, t)];
    mm<2 * F, F>(nz, a, wtc + q.n1f, lane);
    float ghv[2][V], gs[2][V];
    load_tile<F>(ghv, ghb, F, n0, N, lane);
    uint32_t hi[KS][4], lo[KS][4];
    to_frag_split<F>(ghv, hi, lo);
#pragma unroll
    for (int v = 0; v < V; ++v) gs[0][v] = gs[1][v] = 0.f;
    mm<F, F>(gs, hi, wtc + q.n2b, lane);
    mm<F, F>(gs, lo, wtc + q.n2b, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) gs[r][v] *= dsilu(nz[r][v]);
    to_frag_split<F>(gs, hi, lo);
    float gin[2][2 * V];
#pragma unroll
    for (int v = 0; v < 2 * V; ++v) gin[0][v] = gin[1][v] = 0.f;
    mm<F, 2 * F>(gin, hi, wtc + q.n1b, lane);
    mm<F, 2 * F>(gin, lo, wtc + q.n1b, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) gin[r][v] += ghv[r][v];
    store_tile<F, 2 * F>(gin, 0, dhb, F, n0, N, lane);
    store_tile<F, 2 * F>(gin, F, s.gagg, F, n0, N, lane);
  }
  __syncthreads();

  // edge backward; the sender tile's x cotangent in registers, its dst
  // cotangent in the warp's own rows of gdst, the src cotangent in gsrc
  float dxj[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) dxj[r][0] = dxj[r][1] = dxj[r][2] = 0.f;
  const float* eab = ea + (size_t)b * N * N;
  float* deab = dea + (size_t)b * N * N;
  for (int step = 0; step < N; ++step) {
    if (warp < T) {
      const int i = (step + warp * off) % N;
      Geo e;
      edge_geo(e, s.x, eab, i, n0, N, lane);
      float ds1[2][V], mp[2][V], ds2[2][V], att[2];
      edge_front<F>(s, e, i, c, lane, ds1, mp, ds2, att);
      // cz = R(m_pre * att) W_c1 + b_c1, its sigmoid kept as silu'(cz)
      float cz[2][V];
      {
        float m[2][V];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) m[r][v] = mp[r][v] * att[r];
        uint32_t a[KS][4];
        to_frag<F>(m, a);
#pragma unroll
        for (int v = 0; v < V; ++v) cz[0][v] = cz[1][v] = s.bc1[col_of(v, t)];
        mm<F, F>(cz, a, s.c1f, lane);
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
        uint32_t hi[KS][4], lo[KS][4];
        to_frag_split<F>(cz, hi, lo);
#pragma unroll
        for (int v = 0; v < V; ++v) gm[0][v] = gm[1][v] = s.gagg[i * F + col_of(v, t)];
        mm<F, F>(gm, hi, s.c1b, lane);
        mm<F, F>(gm, lo, s.c1b, lane);
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
        uint32_t hi[KS][4], lo[KS][4];
        to_frag_split<F>(gm, hi, lo);
#pragma unroll
        for (int v = 0; v < V; ++v) gz[0][v] = gz[1][v] = 0.f;
        mm<F, F>(gz, hi, s.e2b, lane);
        mm<F, F>(gz, lo, s.e2b, lane);
      }
      float p[V];
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
#pragma unroll
      for (int v = 0; v < V; ++v) p[v] = gz[0][v] + gz[1][v];
      int vi;
      const float tot = col_sum<V>(p, lane, vi);
      if (V == 8 || !(lane & 4)) s.gsrc[i * F + col_of(vi, t)] += tot;
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
    float gv[2][V], dv[2][V], out[2][V];
    load_tile<F>(gv, s.gsrc, F, n0, N, lane);
    load_tile<F>(dv, s.gdst, FS, n0, N, lane);
    load_tile<F>(out, dhb, F, n0, N, lane);
    uint32_t hi[2 * KS][4], lo[2 * KS][4];
    to_frag_split<F>(gv, hi, lo);
    to_frag_split<F>(dv, hi + KS, lo + KS);
    mm<2 * F, F>(out, hi, wtc + q.sdb, lane);
    mm<2 * F, F>(out, lo, wtc + q.sdb, lane);
    store_tile<F, F>(out, 0, dhb, F, n0, N, lane);
  }
}

template <int F>
int launch_bwd_tc(const float* h, const float* x, const float* ea, const float* agg,
                  const float* gh, const float* gx, const float* wts, const __nv_bfloat16* wtc,
                  float* dh, float* dx, float* dea, int B, const Cfg& c, cudaStream_t s) {
  if (c.N < 1 || c.N > kTcMaxN) return (int)cudaErrorInvalidValue;
  const size_t bytes = tc_smem_floats<F>(c.N) * sizeof(float);
  const int err = prepare(egcl_bwd_tc_kernel<F>, bytes);
  if (err) return err;
  egcl_bwd_tc_kernel<F><<<B, kTcThreads, bytes, s>>>(h, x, ea, agg, gh, gx, wts, wtc, dh, dx,
                                                      dea, c);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K2
//
// K2 on tensor cores: one EGCL layer forward in bf16 compute. Replaces the
// Pallas TPU kernel pita_tpu/ops/pallas/egnn_fwd.py:153 _layer_fwd_kernel
// (called through _layer_fwd_call, egnn_fwd.py:311) for compute dtype bf16;
// egnn_layer_f32tc.cu is the f32 one (3xTF32). The function is that of the
// scalar K2: matmul inputs rounded to bf16 in value, f32 accumulation, f32
// elementwise math.
//
// What bounds it on the H100: each edge needs 3F+2 sigmoids (sigma(z1),
// sigma(z2), sigma(cz), the attention gate, and the tanh), each at least one
// operation on the SFUs (16 a clock per SM): 0.14 ms at 2048 chains, N = 55,
// F = 32, against 0.03 ms for the two F x F edge products on bf16 tensor
// cores and 0.02 ms for the bytes. The design keeps the SFU work to that one
// operation a sigmoid and the rest of the work off the critical pipes:
//  - One block per chain, one warp per tile of 16 receivers i (one m16 tile;
//    N <= 64, so at most 4 warps); the warp walks over all senders j.
//  - The edge chain z1 -> silu -> .W_e2 -> z2 -> silu -> gate -> .W_c1 -> cz
//    runs as m16n8k16 bf16 mmas with f32 accumulators, each accumulator pair
//    feeding the next product as its A fragment in registers (to_frag, mm).
//    A lane holds 2 receivers x F/4 features of each F-vector.
//  - Every sum of the forward runs over senders for a fixed receiver (agg_i,
//    sum_j w_ij, sum_j w_ij x_j), so each stays in the lane's registers for
//    the whole walk: after the prologue there is no __syncthreads, no sum in
//    shared memory and no atomic, and the order is fixed (deterministic).
//    The node MLP then takes agg_i from those registers as A fragments for
//    the warp's own 16 nodes. Given agg_out (a launch that records a
//    backward), the warp also stores agg_i there, in f32 as summed, for K3.
//  - Each edge sigmoid is computed once, as sigm_tanh: one tanh.approx.f32
//    (one SFU operation; exp and reciprocal, as sigm_fast, take two). Its
//    error (~2^-12 absolute) is below the bf16 rounding of the products'
//    inputs: chip_smoke.py phase 3 holds the kernel to layer_step at its
//    bf16 tolerance. The node MLP's sigmoids (per node, not per edge) and
//    the coordinate tanh stay exact (silu, tanhf). The attention logit and
//    cm are quad sums reduce-scattered by row: lane t of a quad finishes row
//    t & 1, so the gate is computed by two lanes a quad (not four) and
//    exchanged, and the coordinate weight (tanh, 1 / (|x_i - x_j| + 1)) by
//    the lanes that keep that row's sums.
//  - The src/dst projection and the node MLP run on mma.sync too, their
//    weights read from global memory once per block.
//  - Shared memory holds what the warps read at every step: W_e2 and W_c1 as
//    bf16, the per-feature vectors, src (rows of F + 8: a warp reads 8 rows
//    at once, on distinct banks), dst and x; 22.4 KB at F = 32, N = 55.
//    edge_attr is read from global memory. Registers set the occupancy:
//    kFwdMinBlocks blocks (chains) an SM.
//  - Padded rows (i >= N) run row N - 1's values and are not stored; the
//    diagonal runs finite values and is masked out of every sum.

constexpr int kFwdMinBlocks = 6;

template <int F>
size_t fwd_tc_smem_bytes(int N) {
  const int FS = F + 8;
  return (size_t)2 * F * FS * sizeof(__nv_bfloat16) +
         ((size_t)6 * F + 4 + (size_t)N * (FS + F) + pad4(3 * N)) * sizeof(float);
}

template <int F>
__global__ void __launch_bounds__(kTcThreads, kFwdMinBlocks)
egcl_fwd_tc_kernel(const float* __restrict__ h, const float* __restrict__ x,
                   const float* __restrict__ ea, const float* __restrict__ wts,
                   const __nv_bfloat16* __restrict__ wtc, float* __restrict__ h_out,
                   float* __restrict__ x_out, float* __restrict__ agg_out, Cfg c) {
  static_assert(F == 16 || F == 32, "F must be 16 or 32");
  constexpr int V = F / 4, FS = F + 8, KS = F / 16;
  extern __shared__ float4 smem4[];
  const WOff o = woff(F);
  const TcOff q = tcoff(F);
  const int N = c.N, tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;

  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const __nv_bfloat16* e2f = wsm + q.e2f;
  const __nv_bfloat16* c1f = wsm + q.c1f;
  float* vec = reinterpret_cast<float*>(wsm + 2 * F * FS);
  const float *wr = vec, *we = vec + F, *be2 = vec + 2 * F, *watt = vec + 3 * F,
              *bc1 = vec + 4 * F, *wc2 = vec + 5 * F;
  float* src = vec + 6 * F + 4;  // rows of FS
  float* dst = src + N * FS;     // rows of F
  float* sx = dst + N * F;

  // prologue: the two edge matrices, the vectors, the coordinates
  {
    const uint4* wg = reinterpret_cast<const uint4*>(wtc + q.e2f);
    uint4* ws = reinterpret_cast<uint4*>(wsm);
    for (int k = tid; k < 2 * F * FS / 8; k += nthr) ws[k] = wg[k];
    for (int k = tid; k < F; k += nthr) {
      vec[k] = wts[o.scal + k];
      vec[F + k] = wts[o.scal + F + k];
      vec[2 * F + k] = wts[o.be2 + k];
      vec[3 * F + k] = wts[o.att + k];
      vec[4 * F + k] = wts[o.bc1 + k];
      vec[5 * F + k] = wts[o.c2 + k];
    }
    if (tid == 0) vec[6 * F] = wts[o.batt];
    const float* xb = x + (size_t)b * N * 3;
    for (int k = tid; k < 3 * N; k += nthr) sx[k] = xb[k];
  }
  const float* hb = h + (size_t)b * N * F;
  const int i0 = 16 * warp;  // the warp's receivers, later its nodes
  {  // src | dst = R(h) [W_src | W_dst] + [b_src | 0]
    float hv[2][V];
    load_tile<F>(hv, hb, F, i0, N, lane);
    uint32_t a[KS][4];
    to_frag<F>(hv, a);
    float sd[2][2 * V];
#pragma unroll
    for (int v = 0; v < 2 * V; ++v) {
      const int col = col_of(v, t);
      sd[0][v] = sd[1][v] = col < F ? wts[o.bsrc + col] : 0.f;
    }
    mm<F, 2 * F>(sd, a, wtc + q.sd, lane);
    store_tile<F, 2 * F>(sd, 0, src, FS, i0, N, lane);
    store_tile<F, 2 * F>(sd, F, dst, F, i0, N, lane);
  }
  __syncthreads();

  // the walk over senders j; the lane's rows are receivers i0 + g + 8r
  const float batt = vec[6 * F];
  const float* eab = ea + (size_t)b * N * N;
  const int me = t & 1;  // the row whose coordinate weight and sums this lane keeps
  int ii[2];
  float xi[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    ii[r] = i < N ? i : N - 1;
#pragma unroll
    for (int k = 0; k < 3; ++k) xi[r][k] = sx[3 * ii[r] + k];
  }
  const int i_me = i0 + g + 8 * me;
  float agg[2][V];
#pragma unroll
  for (int v = 0; v < V; ++v) agg[0][v] = agg[1][v] = 0.f;
  float sw = 0.f, swx0 = 0.f, swx1 = 0.f, swx2 = 0.f;
  for (int j = 0; j < N; ++j) {
    const float xj0 = sx[3 * j], xj1 = sx[3 * j + 1], xj2 = sx[3 * j + 2];
    float rad[2], eij[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float d0 = xi[r][0] - xj0, d1 = xi[r][1] - xj1, d2 = xi[r][2] - xj2;
      rad[r] = d0 * d0 + d1 * d1 + d2 * d2;
      eij[r] = eab[ii[r] * N + j];
    }
    uint32_t a[KS][4];
    {  // silu(z1), z1 = (src_i + dst_j) + (radial w_r + edge_attr w_e)
      float z[2][V];
#pragma unroll
      for (int v = 0; v < V; v += 2) {
        const int col = col_of(v, t);
        const float2 dj = *reinterpret_cast<const float2*>(dst + j * F + col);
        const float2 wr2 = *reinterpret_cast<const float2*>(wr + col);
        const float2 we2 = *reinterpret_cast<const float2*>(we + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 si = *reinterpret_cast<const float2*>(src + ii[r] * FS + col);
          z[r][v] = (si.x + dj.x) + (rad[r] * wr2.x + eij[r] * we2.x);
          z[r][v + 1] = (si.y + dj.y) + (rad[r] * wr2.y + eij[r] * we2.y);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) z[r][v] *= sigm_tanh(z[r][v]);
      to_frag<F>(z, a);
    }
    // m_pre = silu(z2), z2 = R(silu(z1)) W_e2 + b_e2; the attention logit
    float mp[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) mp[0][v] = mp[1][v] = be2[col_of(v, t)];
    mm<F, F>(mp, a, e2f, lane);
    float lg[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        mp[r][v] *= sigm_tanh(mp[r][v]);
        lg[r] += mp[r][v] * watt[col_of(v, t)];
      }
    float att[2] = {1.f, 1.f};
    if (c.attention) {  // lane t finishes row t & 1, then the pair swaps gates
      float l = (me ? lg[1] : lg[0]) + __shfl_xor_sync(0xffffffffu, me ? lg[0] : lg[1], 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float mine = sigm_tanh(l + batt);
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      att[0] = me ? other : mine;
      att[1] = me ? mine : other;
    }
    // m = m_pre * att, off the diagonal; agg_i += m; cz = R(m) W_c1 + b_c1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float gate = j != i0 + g + 8 * r ? att[r] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        mp[r][v] *= gate;
        agg[r][v] += mp[r][v];
      }
    }
    to_frag<F>(mp, a);
    float cz[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) cz[0][v] = cz[1][v] = bc1[col_of(v, t)];
    mm<F, F>(cz, a, c1f, lane);
    float cm[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) cm[r] += cz[r][v] * sigm_tanh(cz[r][v]) * wc2[col_of(v, t)];
    // cm of row me; the coordinate weight w_ij = a(cm) / (|x_i - x_j| + 1)
    float cmr = (me ? cm[1] : cm[0]) + __shfl_xor_sync(0xffffffffu, me ? cm[0] : cm[1], 1);
    cmr += __shfl_xor_sync(0xffffffffu, cmr, 2);
    const float den = sqrtf((me ? rad[1] : rad[0]) + 1e-8f) + 1.f;
    const float av = c.tanh ? tanhf(cmr) * c.coords_range : cmr;
    const float wij = j != i_me ? av / den : 0.f;
    sw += wij;
    swx0 += wij * xj0;
    swx1 += wij * xj1;
    swx2 += wij * xj2;
  }
  if (agg_out) store_tile<F, F>(agg, 0, agg_out + (size_t)b * N * F, F, i0, N, lane);

  // x_out_i = x_i + x_i sum_j w_ij - sum_j w_ij x_j: lanes t = 0, 1 of a quad
  if (t < 2 && i_me < N) {
    float* xo = x_out + ((size_t)b * N + i_me) * 3;
    const float x0 = me ? xi[1][0] : xi[0][0], x1 = me ? xi[1][1] : xi[0][1],
                x2 = me ? xi[1][2] : xi[0][2];
    xo[0] = x0 + x0 * sw - swx0;
    xo[1] = x1 + x1 * sw - swx1;
    xo[2] = x2 + x2 * sw - swx2;
  }

  // node MLP of the warp's 16 nodes: h_out = h + R(silu(R([h, agg]) W_n1 + b_n1)) W_n2 + b_n2
  {
    uint32_t a[2 * KS][4];
    float hv[2][V];
    load_tile<F>(hv, hb, F, i0, N, lane);
    to_frag<F>(hv, a);
    to_frag<F>(agg, a + KS);
    float nz[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) nz[0][v] = nz[1][v] = wts[o.bn1 + col_of(v, t)];
    mm<2 * F, F>(nz, a, wtc + q.n1f, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) nz[r][v] = silu(nz[r][v]);
    to_frag<F>(nz, a);
    float y[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) y[0][v] = y[1][v] = 0.f;
    mm<F, F>(y, a, wtc + q.n2f, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) y[r][v] = hv[r][v] + y[r][v] + wts[o.bn2 + col_of(v, t)];
    store_tile<F, F>(y, 0, h_out + (size_t)b * N * F, F, i0, N, lane);
  }
}

template <int F>
int launch_fwd_tc(const float* h, const float* x, const float* ea, const float* wts,
                  const __nv_bfloat16* wtc, float* h_out, float* x_out, float* agg_out, int B,
                  const Cfg& c, cudaStream_t s) {
  if (c.N < 1 || c.N > kTcMaxN) return (int)cudaErrorInvalidValue;
  const size_t bytes = fwd_tc_smem_bytes<F>(c.N);
  const int err = prepare(egcl_fwd_tc_kernel<F>, bytes);
  if (err) return err;
  const int warps = (c.N + 15) / 16;  // one per 16-receiver tile
  egcl_fwd_tc_kernel<F><<<B, 32 * warps, bytes, s>>>(h, x, ea, wts, wtc, h_out, x_out, agg_out,
                                                      c);
  return (int)cudaGetLastError();
}

}  // namespace

// Length in bf16 elements of the tensor-core kernel's weight buffer.
extern "C" int pita_egcl_tc_weights_len(int F) { return tcoff(F).total; }

// Largest N the tensor-core kernel takes (one 16-sender tile per warp).
extern "C" int pita_egcl_tc_max_n() { return kTcMaxN; }

// The VJP of pita_egcl_forward in bf16 compute, on tensor cores: the
// arguments of pita_egcl_backward (csrc/egnn_layer.cu) plus agg, the (B, N,
// F) f32 aggregate that pita_egcl_forward_tc stored for the same inputs, and
// wtc, the bf16 matrices of pack_weights_tc (16-byte aligned); wts is the f32
// buffer of pack_weights(w, bf16), of which the vectors are read.
extern "C" int pita_egcl_backward_tc(const float* h, const float* x, const float* ea,
                                     const float* agg, const float* gh, const float* gx,
                                     const float* wts, const void* wtc, float* dh, float* dx,
                                     float* dea, int B, int N, int F, int attention, int tanh,
                                     float coords_range, void* stream) {
  if (B <= 0) return 0;
  const Cfg c{N, 1, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wtc);
  switch (F) {
    case 16: return launch_bwd_tc<16>(h, x, ea, agg, gh, gx, wts, w, dh, dx, dea, B, c, s);
    case 32: return launch_bwd_tc<32>(h, x, ea, agg, gh, gx, wts, w, dh, dx, dea, B, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// pita_egcl_forward (csrc/egnn_layer.cu) in bf16 compute, on tensor cores:
// h (B, N, F), x (B, N, 3), ea (B, N, N) -> h_out (B, N, F), x_out (B, N, 3)
// and, unless agg_out is null, the aggregate agg_i = sum_j m_ij (B, N, F)
// that pita_egcl_backward_tc reads; all f32 and contiguous. wts is the f32
// buffer of pack_weights(w, bf16), of which the vectors are read, wtc the
// bf16 matrices of pack_weights_tc (16-byte aligned). N <=
// pita_egcl_tc_max_n().
extern "C" int pita_egcl_forward_tc(const float* h, const float* x, const float* ea,
                                    const float* wts, const void* wtc, float* h_out,
                                    float* x_out, float* agg_out, int B, int N, int F,
                                    int attention, int tanh, float coords_range, void* stream) {
  if (B <= 0) return 0;
  const Cfg c{N, 1, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wtc);
  switch (F) {
    case 16: return launch_fwd_tc<16>(h, x, ea, wts, w, h_out, x_out, agg_out, B, c, s);
    case 32: return launch_fwd_tc<32>(h, x, ea, wts, w, h_out, x_out, agg_out, B, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
