// K4 on tensor cores: one EGCL layer's tangent map for a chunk of
// coordinate-basis tangents in bf16 compute, sm_90a.
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/egnn_fwd.py:
// _layer_tan_kernel (:195-239, called through _layer_tan_call :360,
// pallas_call at :365) for compute dtype bf16; the scalar egcl_tan_kernel of
// egnn_tangent.cu stays the kernel for f32 (tensor cores would change f32
// results). The function is the scalar kernel's: the layer linearized at
// (h, x, edge_attr), a chunk of tangents (dh, dx) pushed through, the
// edge-attribute tangent rebuilt on chip from xs0 and the basis. As under
// jax.linearize every matmul input of the tangent map is rounded to bf16:
// R(dh) W_src, R(dh) W_dst, R(sp1 dz1) W_e2, R(dm) W_c1, R([dh, dagg]) W_n1,
// R(sp_n dnz) W_n2. Those products take bf16 operands by definition, so
// m16n8k16 bf16 mma.sync with f32 accumulators computes the same function;
// only the order of the f32 sums changes.
//
// What bounds it on the H100: per chain, tangent and edge two F x F products
// (2e11 operations a launch at 256 chains x 64 tangents, N = 55, F = 32:
// 0.21 ms on bf16 tensor cores) and 9F + 23 f32 operations around them
// (dz1, the sp1 scale, the gated dm, the dl and dcm row sums, dagg, the
// edge scalars and the dx sums): 0.45 ms on the FP32 pipes, the bound. The
// scalar kernel also recomputed the primal edge chain (3F+1 sigmoids) for
// every tangent. The design:
//  - One block of 8 warps per chain and chunk of `tc` tangents (tc <= 16).
//    Warp w owns the receivers i = w, w + 8, ... and walks the sender tiles
//    of receiver i (16 senders, one m16 tile: rows are senders).
//  - For each (receiver, sender tile) the primal edge chain runs once, as
//    the tensor-core K2 runs it (sigm_tanh: one SFU operation a sigmoid),
//    and leaves in registers what the tangent map needs: silu'(z1),
//    silu'(z2), m_pre, silu'(cz) w_c2, the gate and its derivative, and the
//    coordinate weight's two terms. The tile's 16 edges then take every
//    tangent of the chunk in turn, with no SFU operation.
//  - A tangent's edge chain is three products chained in registers: dz1 =
//    R(dh_j) W_dst with the accumulator started at dsrc_i + c w_r + e w_e,
//    then R(sp1 dz1) W_e2 and R(dm) W_c1. dl and dcm are quad sums.
//  - Sums over the senders of the fixed receiver (dagg_i, sum_j dw_ij and
//    sum_j (dw_ij x_j + w_ij dx_j)) are column sums of the tile: a
//    reduce-scatter leaves one value a lane, which the lane adds to its own
//    slot in the warp's shared memory, tile after tile. No atomics, a fixed
//    order, and one warp writes each output: two launches are bitwise equal.
//  - Receiver i's node part runs at the end of its walk with the chunk's
//    tangents as rows: R(dh_i) W_src before the walk (dsrc_i), and after it
//    R([dh_i, dagg_i]) W_n1, times silu'(nz_i), then R(.) W_n2.
//  - The B fragments of W_e2, W_c1 and W_dst stay in each lane's registers
//    for the whole block (48 a lane at F = 32), so a tangent's products read
//    no weights, and so do w_r, w_e and w_att of the lane's columns. That
//    takes 229 registers at F = 32, so one block of 8 warps an SM.
//  - Shared memory: the chunk's dh as bf16 (the A operand of R(dh) W_dst),
//    its dx and basis; src, dst, x, xs0 and edge_attr of the chain; per warp
//    the tile's edge geometry, the dsrc rows and the sum slots: 183,936
//    bytes at N = 55, F = 32, tc = 16. No load from device memory is left
//    in the walk over the senders.
//  - The primal chain is paid once per block, so the chunk is as large as
//    the node products' one m16 tile allows (16, pita_tpu's own
//    pallas_tangent_chunk).
//  - Padding: a sender row past N, or on the diagonal, runs the diagonal's
//    finite values and is masked out of every sum; tangent rows past the
//    chunk in the node products compute on the chunk's last row and are not
//    stored.

#include "egnn_common.cuh"
#include "mma_bf16.cuh"

#include <cstdint>

namespace {

constexpr int kTanWarps = 8;
constexpr int kTanThreads = 32 * kTanWarps;
constexpr int kTanMaxN = 64;   // four 16-sender tiles
constexpr int kTanMaxTc = 16;  // the chunk is one m16 tile of the node products
constexpr int kTanMinBlocks = 1;

__host__ __device__ inline int pad16(int bytes) { return (bytes + 15) & ~15; }

// Byte offsets of the pieces of a block's shared memory.
struct TanSmem {
  int vec, src, dst, x, xs0, dh, dxs, es, ea, warp, warp_bytes, total;
};

template <int F>
__host__ __device__ inline TanSmem tan_smem(int N, int tc) {
  constexpr int FS = F + 8;
  TanSmem s;
  int p = 0;
  s.vec = p; p += pad16((6 * F + 4) * 4);   // w_r, w_e, b_e2, w_att, b_c1, w_c2, b_att
  s.src = p; p += pad16(N * F * 4);         // src_i (with b_src), rows of F
  s.dst = p; p += pad16(N * FS * 4);        // dst_j, rows of F + 8
  s.x = p;   p += pad16(3 * N * 4);
  s.xs0 = p; p += pad16(3 * N * 4);
  s.dh = p;  p += pad16(tc * N * FS * 2);   // R(dh) of the chunk, [tangent][node], rows of F + 8
  s.dxs = p; p += pad16(tc * N * 16);       // dx of the chunk, (x, y, z, 0) per [tangent][node]
  s.es = p;  p += pad16(tc * N * 16);       // basis of the chunk, the same
  s.ea = p;  p += pad16(N * N * 4);         // edge_attr of the chain
  // per warp: the tile's edge geometry (x_i - x_j and xs0_i - xs0_j of its
  // 16 rows, float4 each), rows[tc][F] (dsrc_i, later dagg_i), two slots
  // [tc][32] a lane (dagg and the dx sums), agg_i and silu'(nz_i)
  s.warp_bytes = pad16(2 * 16 * 16 + (tc * F + 2 * tc * 32 + 2 * F) * 4);
  s.warp = p; p += kTanWarps * s.warp_bytes;
  s.total = p;
  return s;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of a 16 x K tile from bf16 rows: row0 for the lane's row g,
// row1 for g + 8
template <int K>
__device__ __forceinline__ void frag_rows(uint32_t (*a)[4], const __nv_bfloat16* row0,
                                          const __nv_bfloat16* row1, int t) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    a[ks][0] = ld32(row0 + 16 * ks + 2 * t);
    a[ks][1] = ld32(row1 + 16 * ks + 2 * t);
    a[ks][2] = ld32(row0 + 16 * ks + 8 + 2 * t);
    a[ks][3] = ld32(row1 + 16 * ks + 8 + 2 * t);
  }
}

// rows min(g + 8r, nrows - 1) of a row-major f32 array, C columns, in the
// accumulator layout
template <int C>
__device__ __forceinline__ void clamped_tile(float (&v)[2][C / 4], const float* base, int ld,
                                             int nrows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = base + min(g + 8 * r, nrows - 1) * ld;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const float2 p = *reinterpret_cast<const float2*>(row + nt * 8 + 2 * t);
      v[r][2 * nt] = p.x;
      v[r][2 * nt + 1] = p.y;
    }
  }
}

// B fragments of the lane for M (K x NO), given as M^T with rows of K + 8
template <int K, int NO>
__device__ __forceinline__ void load_b(uint32_t (&b)[NO / 8][K / 16][2], const __nv_bfloat16* mt,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NO / 8; ++nt)
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      const __nv_bfloat16* row = mt + (nt * 8 + g) * (K + 8) + 2 * t + ks * 16;
      b[nt][ks][0] = ld32(row);
      b[nt][ks][1] = ld32(row + 8);
    }
}

// acc (16 x NO) += A (16 x K, fragments a) . M, M's B fragments in registers
template <int K, int NO>
__device__ __forceinline__ void mm_b(float (&acc)[2][NO / 4], const uint32_t (*a)[4],
                                     const uint32_t (&b)[NO / 8][K / 16][2]) {
#pragma unroll
  for (int nt = 0; nt < NO / 8; ++nt) {
    float d[4] = {acc[0][2 * nt], acc[0][2 * nt + 1], acc[1][2 * nt], acc[1][2 * nt + 1]};
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) mma16816(d, a[ks], b[nt][ks][0], b[nt][ks][1]);
    acc[0][2 * nt] = d[0];
    acc[0][2 * nt + 1] = d[1];
    acc[1][2 * nt] = d[2];
    acc[1][2 * nt + 1] = d[3];
  }
}

template <int F>
__global__ void __launch_bounds__(kTanThreads, kTanMinBlocks)
egcl_tan_tc_kernel(const float* __restrict__ h, const float* __restrict__ x,
                   const float* __restrict__ ea, const float* __restrict__ xs0,
                   const float* __restrict__ basis, const float* __restrict__ dh,
                   const float* __restrict__ dx, const float* __restrict__ wts,
                   const __nv_bfloat16* __restrict__ wtc, float* __restrict__ dh_out,
                   float* __restrict__ dx_out, Cfg c, int Tc, int tc) {
  static_assert(F == 16 || F == 32, "F must be 16 or 32");
  constexpr int V = F / 4, FS = F + 8, KS = F / 16;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const WOff o = woff(F);
  const TcOff q = tcoff(F);
  const int N = c.N, tid = threadIdx.x;
  const int b = blockIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.y * tc;
  const int nt = min(tc, Tc - t0);  // tangents of this block
  const TanSmem L = tan_smem<F>(N, tc);

  float* vec = reinterpret_cast<float*>(smem + L.vec);
  const float *wr = vec, *we = vec + F, *be2 = vec + 2 * F, *watt = vec + 3 * F,
              *bc1 = vec + 4 * F, *wc2 = vec + 5 * F;
  float* src = reinterpret_cast<float*>(smem + L.src);
  float* dst = reinterpret_cast<float*>(smem + L.dst);
  float* sx = reinterpret_cast<float*>(smem + L.x);
  float* sx0 = reinterpret_cast<float*>(smem + L.xs0);
  __nv_bfloat16* sdh = reinterpret_cast<__nv_bfloat16*>(smem + L.dh);
  float4* sdx = reinterpret_cast<float4*>(smem + L.dxs);
  float4* se = reinterpret_cast<float4*>(smem + L.es);
  float* sea = reinterpret_cast<float*>(smem + L.ea);

  // prologue: the vectors, the chain's coordinates, the chunk's tangents
  {
    for (int k = tid; k < F; k += kTanThreads) {
      vec[k] = wts[o.scal + k];
      vec[F + k] = wts[o.scal + F + k];
      vec[2 * F + k] = wts[o.be2 + k];
      vec[3 * F + k] = wts[o.att + k];
      vec[4 * F + k] = wts[o.bc1 + k];
      vec[5 * F + k] = wts[o.c2 + k];
    }
    if (tid == 0) vec[6 * F] = wts[o.batt];
    const float* xb = x + (size_t)b * N * 3;
    const float* x0b = xs0 + (size_t)b * N * 3;
    for (int k = tid; k < N * N; k += kTanThreads) sea[k] = ea[(size_t)b * N * N + k];
    for (int k = tid; k < 3 * N; k += kTanThreads) {
      sx[k] = xb[k];
      sx0[k] = x0b[k];
    }
    const size_t bt0 = (size_t)b * Tc + t0;
    const float4* dhg = reinterpret_cast<const float4*>(dh + bt0 * N * F);
    for (int k = tid; k < nt * N * F / 4; k += kTanThreads) {
      const float4 v = dhg[k];
      const int row = (4 * k) / F, f = (4 * k) % F;  // row = tangent * N + node
      uint2 p;
      p.x = pack2(v.x, v.y);
      p.y = pack2(v.z, v.w);
      *reinterpret_cast<uint2*>(sdh + row * FS + f) = p;
    }
    const float* dxg = dx + bt0 * N * 3;
    const float* eg = basis + (size_t)t0 * N * 3;
    for (int k = tid; k < nt * N; k += kTanThreads) {
      sdx[k] = make_float4(dxg[3 * k], dxg[3 * k + 1], dxg[3 * k + 2], 0.f);
      se[k] = make_float4(eg[3 * k], eg[3 * k + 1], eg[3 * k + 2], 0.f);
    }
  }
  const float* hb = h + (size_t)b * N * F;
  if (16 * warp < N) {  // src | dst = R(h) [W_src | W_dst] + [b_src | 0], a node tile a warp
    const int n0 = 16 * warp;
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
    store_tile<F, 2 * F>(sd, 0, src, F, n0, N, lane);
    store_tile<F, 2 * F>(sd, F, dst, FS, n0, N, lane);
  }
  __syncthreads();

  // the lane's B fragments of the three edge matrices, for the whole block
  uint32_t b_e2[F / 8][KS][2], b_c1[F / 8][KS][2], b_dst[F / 8][KS][2];
  load_b<F, F>(b_e2, wtc + q.e2f, lane);
  load_b<F, F>(b_c1, wtc + q.c1f, lane);
  load_b<F, F>(b_dst, wtc + q.sd + F * FS, lane);
  // the warp's own shared memory
  float4* gd = reinterpret_cast<float4*>(smem + L.warp + warp * L.warp_bytes);
  float4* gd0 = gd + 16;
  float* rows = reinterpret_cast<float*>(gd0 + 16);
  float* sdag = rows + tc * F;    // [tangent][lane]: the lane's column of dagg_i
  float* sdxs = sdag + tc * 32;   // [tangent][lane]: the lane's part of the dx sums
  float* sagg = sdxs + tc * 32;   // agg_i
  float* sspn = sagg + F;         // silu'(nz_i)
  const float batt = vec[6 * F];
  float wr_r[V], we_r[V], wa_r[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    wr_r[v] = wr[col_of(v, t)];
    we_r[v] = we[col_of(v, t)];
    wa_r[v] = watt[col_of(v, t)];
  }

  for (int i = warp; i < N; i += kTanWarps) {
    // dsrc_i = R(dh_i) W_src, one row per tangent of the chunk
    {
      uint32_t a[KS][4];
      frag_rows<F>(a, sdh + (min(g, nt - 1) * N + i) * FS, sdh + (min(g + 8, nt - 1) * N + i) * FS,
                   t);
      float ds[2][V];
#pragma unroll
      for (int v = 0; v < V; ++v) ds[0][v] = ds[1][v] = 0.f;
      mm<F, F>(ds, a, wtc + q.sd, lane);
      store_tile<F, F>(ds, 0, rows, F, 0, nt, lane);
    }
    for (int u = 0; u < nt; ++u) sdag[u * 32 + lane] = sdxs[u * 32 + lane] = 0.f;
    __syncwarp();

    float xi[3], x0i[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      xi[k] = sx[3 * i + k];
      x0i[k] = sx0[3 * i + k];
    }
    float agg = 0.f, sw = 0.f;  // the lane's column of agg_i; its rows' w_ij
    int vi = 0;                 // the column a reduce-scatter leaves the lane: col_of(vi, t)
    for (int j0 = 0; j0 < N; j0 += 16) {
      // the edges (i, j) of the lane's rows j = j0 + g + 8r; their x_i - x_j
      // and xs0_i - xs0_j wait in shared memory (registers are short)
      int jj[2];
      float rad[2], vm[2];
      __syncwarp();  // the previous tile's tangents have read gd, gd0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + g + 8 * r;
        vm[r] = j < N && j != i ? 1.f : 0.f;
        jj[r] = j < N ? j : i;
        float d[3], d0[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          d[k] = xi[k] - sx[3 * jj[r] + k];
          d0[k] = x0i[k] - sx0[3 * jj[r] + k];
        }
        rad[r] = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
        if (t == 0) {
          gd[g + 8 * r] = make_float4(d[0], d[1], d[2], 0.f);
          gd0[g + 8 * r] = make_float4(d0[0], d0[1], d0[2], 0.f);
        }
      }
      __syncwarp();
      // primal: sp1 = silu'(z1), mp = m_pre, sp2 = silu'(z2), kc = silu'(cz) w_c2
      float sp1[2][V], mp[2][V], sp2[2][V], kc[2][V];
      float atte[2], datf[2], tfac[2], wfac[2], wij[2];
      {
        uint32_t a[KS][4];
        {
          float z[2][V];
          const float e0 = sea[i * N + jj[0]], e1 = sea[i * N + jj[1]];
#pragma unroll
          for (int v = 0; v < V; v += 2) {
            const int col = col_of(v, t);
            const float2 si = *reinterpret_cast<const float2*>(src + i * F + col);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 dj = *reinterpret_cast<const float2*>(dst + jj[r] * FS + col);
              const float er = r ? e1 : e0;
              z[r][v] = (si.x + dj.x) + (rad[r] * wr_r[v] + er * we_r[v]);
              z[r][v + 1] = (si.y + dj.y) + (rad[r] * wr_r[v + 1] + er * we_r[v + 1]);
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float s = sigm_tanh(z[r][v]);
              sp1[r][v] = s * (1.f + z[r][v] * (1.f - s));
              z[r][v] *= s;
            }
          to_frag<F>(z, a);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) mp[0][v] = mp[1][v] = be2[col_of(v, t)];
        mm_b<F, F>(mp, a, b_e2);  // z2
        float lg[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float z2 = mp[r][v];
            const float s = sigm_tanh(z2);
            sp2[r][v] = s * (1.f + z2 * (1.f - s));
            mp[r][v] = z2 * s;
            lg[r] += mp[r][v] * wa_r[v];
          }
        float m[2][V];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float att = c.attention ? sigm_tanh(quad_sum(lg[r]) + batt) : 1.f;
          atte[r] = att * vm[r];
          datf[r] = c.attention ? att * (1.f - att) * vm[r] : 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) m[r][v] = mp[r][v] * atte[r];
        }
        {  // agg_i += sum over the tile's senders of m
          float p[V];
#pragma unroll
          for (int v = 0; v < V; ++v) p[v] = m[0][v] + m[1][v];
          agg += col_sum<V>(p, lane, vi);
        }
        to_frag<F>(m, a);
        float cz[2][V];
#pragma unroll
        for (int v = 0; v < V; ++v) cz[0][v] = cz[1][v] = bc1[col_of(v, t)];
        mm_b<F, F>(cz, a, b_c1);
        float cm[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float z = cz[r][v];
            const float s = sigm_tanh(z);
            const float w2 = wc2[col_of(v, t)];
            cm[r] += z * s * w2;
            kc[r][v] = s * (1.f + z * (1.f - s)) * w2;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // w_ij = a(cm) / (|x_i - x_j| + 1); its tangent (da - w_ij dnorm) / den
          // = tfac dcm - wfac c, dnorm = c / (2 norm)
          const float cmr = quad_sum(cm[r]);
          const float nrm = sqrtf(rad[r] + 1e-8f), den = nrm + 1.f;
          const float th = c.tanh ? tanhf(cmr) : 0.f;
          const float av = c.tanh ? th * c.coords_range : cmr;
          wij[r] = vm[r] * av / den;
          tfac[r] = vm[r] * (c.tanh ? c.coords_range * (1.f - th * th) : 1.f) / den;
          wfac[r] = wij[r] / (2.f * nrm * den);
          sw += wij[r];
        }
      }
      // lane t keeps part t of the dx sums: t = 0 sum_j dw_ij, t = 1 + k
      // sum_j (dw_ij x_jk + w_ij dx_jk)
      float xw[2], ww[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float xk = sx[3 * jj[r] + (t ? t - 1 : 0)];
        xw[r] = t ? xk : 1.f;
        ww[r] = t ? wij[r] : 0.f;
      }

      for (int u = 0; u < nt; ++u) {
        const float4 dxi = sdx[u * N + i], ei = se[u * N + i];
        float ct[2], et[2], dxk[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float4 dxj = sdx[u * N + jj[r]], ej = se[u * N + jj[r]];
          const float4 d = gd[g + 8 * r], d0 = gd0[g + 8 * r];
          ct[r] = 2.f * (d.x * (dxi.x - dxj.x) + d.y * (dxi.y - dxj.y) + d.z * (dxi.z - dxj.z));
          et[r] = 2.f * (d0.x * (ei.x - ej.x) + d0.y * (ei.y - ej.y) + d0.z * (ei.z - ej.z));
          dxk[r] = t == 1 ? dxj.x : t == 2 ? dxj.y : dxj.z;
        }
        // dz1 = dsrc_i + c w_r + e w_e + R(dh_j) W_dst
        float acc[2][V];
#pragma unroll
        for (int v = 0; v < V; v += 2) {
          const int col = col_of(v, t);
          const float2 ds = *reinterpret_cast<const float2*>(rows + u * F + col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            acc[r][v] = ds.x + (ct[r] * wr_r[v] + et[r] * we_r[v]);
            acc[r][v + 1] = ds.y + (ct[r] * wr_r[v + 1] + et[r] * we_r[v + 1]);
          }
        }
        uint32_t a[KS][4];
        frag_rows<F>(a, sdh + (u * N + jj[0]) * FS, sdh + (u * N + jj[1]) * FS, t);
        mm_b<F, F>(acc, a, b_dst);
        // dm_pre = sp2 (R(sp1 dz1) W_e2), dl = dm_pre . w_att
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] *= sp1[r][v];
        to_frag<F>(acc, a);
        float dm[2][V];
#pragma unroll
        for (int v = 0; v < V; ++v) dm[0][v] = dm[1][v] = 0.f;
        mm_b<F, F>(dm, a, b_e2);
        float dl[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            dm[r][v] *= sp2[r][v];
            dl[r] += dm[r][v] * wa_r[v];
          }
        // dm = dm_pre att + m_pre datt, masked
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float datt = c.attention ? datf[r] * quad_sum(dl[r]) : 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) dm[r][v] = dm[r][v] * atte[r] + mp[r][v] * datt;
        }
        {  // dagg_i += sum over the tile's senders of dm
          float p[V];
#pragma unroll
          for (int v = 0; v < V; ++v) p[v] = dm[0][v] + dm[1][v];
          int unused;
          sdag[u * 32 + lane] += col_sum<V>(p, lane, unused);
        }
        // dcm = sum_k silu'(cz_k) w_c2k (R(dm) W_c1)_k
        to_frag<F>(dm, a);
        float dz[2][V];
#pragma unroll
        for (int v = 0; v < V; ++v) dz[0][v] = dz[1][v] = 0.f;
        mm_b<F, F>(dz, a, b_c1);
        float part = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float dcm = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) dcm += dz[r][v] * kc[r][v];
          const float dw = tfac[r] * quad_sum(dcm) - wfac[r] * ct[r];
          part += dw * xw[r] + ww[r] * dxk[r];
        }
        sdxs[u * 32 + lane] += part;
      }
    }

    // receiver i's outputs. sum_j w_ij over all rows (every lane of a quad
    // holds its rows' sum)
    sw += __shfl_xor_sync(0xffffffffu, sw, 4);
    sw += __shfl_xor_sync(0xffffffffu, sw, 8);
    sw += __shfl_xor_sync(0xffffffffu, sw, 16);
    const bool owner = V == 8 || !(lane & 4);
    const int mycol = col_of(vi, t);
    if (owner) sagg[mycol] = agg;
    for (int u = 0; u < nt; ++u) {
      float s = sdxs[u * 32 + lane];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const float sdw = __shfl_sync(0xffffffffu, s, 0);  // sum_j dw_ij
      // dx_out_i = dx_i + dx_i sum_j w_ij + x_i sum_j dw_ij - sum_j (dw_ij x_j + w_ij dx_j)
      if (g == 0 && t > 0) {
        const float4 dxi = sdx[u * N + i];
        const float dk = t == 1 ? dxi.x : t == 2 ? dxi.y : dxi.z;
        const float xk = t == 1 ? xi[0] : t == 2 ? xi[1] : xi[2];
        dx_out[(((size_t)b * Tc + t0 + u) * N + i) * 3 + t - 1] = dk + dk * sw + xk * sdw - s;
      }
      if (owner) rows[u * F + mycol] = sdag[u * 32 + lane];  // dsrc_i is no longer read
    }
    __syncwarp();
    // silu'(nz_i), nz_i = R([h_i, agg_i]) W_n1 + b_n1 (lane k: feature k)
    if (lane < F) {
      float nz = wts[o.bn1 + lane];
      for (int k = 0; k < F; ++k) nz += rnd(hb[i * F + k], 1) * wts[o.n1 + k * F + lane];
      for (int k = 0; k < F; ++k) nz += rnd(sagg[k], 1) * wts[o.n1 + (F + k) * F + lane];
      sspn[lane] = dsilu(nz);
    }
    __syncwarp();
    // dh_out_i = dh_i + R(silu'(nz_i) R([dh_i, dagg_i]) W_n1) W_n2, a row per tangent
    {
      uint32_t a[2 * KS][4];
      frag_rows<F>(a, sdh + (min(g, nt - 1) * N + i) * FS, sdh + (min(g + 8, nt - 1) * N + i) * FS,
                   t);
      {
        float dg[2][V];
        clamped_tile<F>(dg, rows, F, nt, lane);
        to_frag<F>(dg, a + KS);
      }
      float dnz[2][V];
#pragma unroll
      for (int v = 0; v < V; ++v) dnz[0][v] = dnz[1][v] = 0.f;
      mm<2 * F, F>(dnz, a, wtc + q.n1f, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) dnz[r][v] *= sspn[col_of(v, t)];
      to_frag<F>(dnz, a);
      const size_t bt0 = (size_t)b * Tc + t0;
      float y[2][V];
      clamped_tile<F>(y, dh + (bt0 * N + i) * F, N * F, nt, lane);
      mm<F, F>(y, a, wtc + q.n2f, lane);
      store_tile<F, F>(y, 0, dh_out + (bt0 * N + i) * F, N * F, 0, nt, lane);
    }
    __syncwarp();  // the next receiver rewrites rows, sagg and the slots
  }
}

template <int F>
int launch_tan_tc(const float* h, const float* x, const float* ea, const float* xs0,
                  const float* basis, const float* dh, const float* dx, const float* wts,
                  const __nv_bfloat16* wtc, float* dh_out, float* dx_out, int B, int Tc, int tc,
                  const Cfg& c, cudaStream_t s) {
  const size_t bytes = tan_smem<F>(c.N, tc).total;
  const int err = prepare(egcl_tan_tc_kernel<F>, bytes);
  if (err) return err;
  const dim3 grid(B, (Tc + tc - 1) / tc);
  egcl_tan_tc_kernel<F><<<grid, kTanThreads, bytes, s>>>(h, x, ea, xs0, basis, dh, dx, wts, wtc,
                                                         dh_out, dx_out, c, Tc, tc);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest N and tangents a block the kernel takes (the largest block,
// N = 64, F = 32, tc = 16, needs 207,120 bytes of shared memory).
extern "C" int pita_egcl_tangent_tc_max_n() { return kTanMaxN; }
extern "C" int pita_egcl_tangent_tc_max_chunk() { return kTanMaxTc; }

// pita_egcl_tangent (csrc/egnn_tangent.cu) in bf16 compute, on tensor cores:
// the same arguments, all f32 and contiguous, plus wtc, the bf16 matrices of
// pack_weights_tc (16-byte aligned); wts is the f32 buffer of
// pack_weights(w, bf16), of which the vectors and W_n1 are read. A block
// takes `tc` tangents of a chain, 1 <= tc <= 16; N <= 64.
extern "C" int pita_egcl_tangent_tc(const float* h, const float* x, const float* ea,
                                    const float* xs0, const float* basis, const float* dh,
                                    const float* dx, const float* wts, const void* wtc,
                                    float* dh_out, float* dx_out, int B, int Tc, int tc, int N,
                                    int F, int attention, int tanh, float coords_range,
                                    void* stream) {
  if (B <= 0 || Tc <= 0) return 0;
  if (N < 1 || N > kTanMaxN || tc < 1 || tc > kTanMaxTc || (Tc + tc - 1) / tc > 65535)
    return (int)cudaErrorInvalidValue;
  const Cfg c{N, 1, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wtc);
  switch (F) {
    case 16:
      return launch_tan_tc<16>(h, x, ea, xs0, basis, dh, dx, wts, w, dh_out, dx_out, B, Tc, tc,
                               c, s);
    case 32:
      return launch_tan_tc<32>(h, x, ea, xs0, basis, dh, dx, wts, w, dh_out, dx_out, B, Tc, tc,
                               c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
