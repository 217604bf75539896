// K4 in f32 on tensor cores: one EGCL layer's tangent map for a chunk of
// coordinate-basis tangents in f32 compute, its products in 3xTF32, sm_90a.
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/egnn_fwd.py:
// _layer_tan_kernel (:195-239, called through _layer_tan_call :360,
// pallas_call at :365) for compute dtype f32, as egnn_tangent_tc.cu does for
// bf16. The function is the scalar egcl_tan_kernel's in f32: the layer of
// _layer_step (:85-136) linearized at (h, x, edge_attr), a chunk of tangents
// (dh, dx) pushed through, the edge-attribute tangent rebuilt on chip from
// xs0 and the basis. Nothing is rounded: every product is f32, taken as three
// TF32 products (mma_tf32.cuh, ~2^-21 relative), and every sigmoid keeps the
// overflow-safe form of egnn_fwd.py:67 in f32 (an exponential and a
// reciprocal, ~1e-6 relative; tanh.approx would err by 2^-11).
//
// What bounds it on the H100: per chain, tangent and edge one F x F product
// (R(sp1 dz1) W_e2; the tangent of the coordinate MLP is a dot product, see
// below) and 9F + 23 f32 operations around it: at 64 chains x 64 tangents,
// N = 55, F = 32, 2.8e10 product operations, 0.17 ms at a third of the TF32
// dense peak, and 3.8e9 f32 operations, 0.11 ms. The scalar K4 ran those
// products on the FP32 pipes and recomputed the primal edge chain (3F + 1
// sigmoids) for every tangent. The design, that of the bf16 K4
// (egnn_tangent_tc.cu):
//  - One block of 8 warps per chain and chunk of `tc` tangents (tc <= 8).
//    Warp w owns the receivers i = w, w + 8, ... and walks the sender tiles
//    of receiver i (16 senders, one m16 tile: rows are senders).
//  - For each (receiver, sender tile) the primal edge chain runs once and
//    leaves in registers what the tangent map needs: silu'(z1), silu'(z2),
//    m_pre, the gate and its derivative, the coordinate weight's two terms,
//    and kcu = W_c1 (silu'(cz) w_c2), one more product of the tile. The
//    tangent of cm is dcm = R(dm) W_c1 . (silu'(cz) w_c2) = dm . kcu (f32
//    reassociation; bf16 rounds dm first and cannot), so a tangent's chain
//    is one product, not two, and has no SFU operation.
//  - A tangent's edge chain: dz1 = dsrc_i + ddst_j + c w_r + e w_e, with
//    ddst_j = dh_j W_dst of the chunk computed once a block into shared
//    memory (not once an edge, as the bf16 K4 does from bf16 dh), then
//    (sp1 dz1) W_e2 on tensor cores, dl and dcm as quad sums.
//  - Sums over the senders of the fixed receiver (dagg_i, sum_j dw_ij and
//    sum_j (dw_ij x_j + w_ij dx_j)) are column sums of the tile into the
//    lane's own slot in the warp's shared memory, tile after tile. No
//    atomics, a fixed order, one warp writes each output: two launches are
//    bitwise equal.
//  - Receiver i's node part runs at the end of its walk with the chunk's
//    tangents as rows: dh_i W_src before the walk (dsrc_i), and after it
//    [dh_i, dagg_i] W_n1, times silu'(nz_i), then . W_n2.
//  - The weights in TF32 hi + lo are four times the bf16 ones, too many for
//    registers: W_e2, W_c1 and W_c1^T (24 KB at F = 32) wait in shared
//    memory, where a lane reads its B fragment as one float4 (consecutive
//    lanes, consecutive 16 bytes); W_src, W_dst, W_n1 and W_n2, read once a
//    receiver or a block, come from global memory (L2).
//  - Shared memory: those matrices, ddst of the chunk (f32, rows of F + 8),
//    its dx and basis, src, dst, x, xs0 and edge_attr of the chain, per warp
//    the tile's edge geometry, the dsrc rows and the sum slots: 169,856 bytes
//    at N = 55, F = 32, tc = 8, so the chunk is 8 tangents (16 would not fit)
//    and one block of 8 warps an SM.
//  - Padding: a sender row past N, or on the diagonal, runs the diagonal's
//    finite values and is masked out of every sum; tangent rows past the
//    chunk in the node products compute on the chunk's last row and are not
//    stored.

#include "egnn_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

#include <cstdint>

namespace {

constexpr int kT32Warps = 8;
constexpr int kT32Threads = 32 * kT32Warps;
constexpr int kT32MaxN = 64;  // four 16-sender tiles
constexpr int kT32MaxTc = 8;  // the chunk's ddst must fit in shared memory

__host__ __device__ inline int pad16(int bytes) { return (bytes + 15) & ~15; }

// Byte offsets of the pieces of a block's shared memory.
struct T32Smem {
  int mats, vec, src, dst, x, xs0, dd, dxs, es, ea, warp, warp_bytes, total;
};

template <int F>
__host__ __device__ inline T32Smem t32_smem(int N, int tc) {
  constexpr int FS = F + 8;
  T32Smem s;
  int p = 0;
  s.mats = p; p += 6 * F * F * 4;          // W_e2, W_c1, W_c1^T in fragment layout
  s.vec = p;  p += pad16((6 * F + 4) * 4); // w_r, w_e, b_e2, w_att, b_c1, w_c2, b_att
  s.src = p;  p += pad16(N * F * 4);       // src_i (with b_src), rows of F
  s.dst = p;  p += pad16(N * FS * 4);      // dst_j, rows of F + 8
  s.x = p;    p += pad16(3 * N * 4);
  s.xs0 = p;  p += pad16(3 * N * 4);
  s.dd = p;   p += pad16(tc * N * FS * 4); // ddst = dh W_dst of the chunk, [tangent][node]
  s.dxs = p;  p += pad16(tc * N * 16);     // dx of the chunk, (x, y, z, 0) per [tangent][node]
  s.es = p;   p += pad16(tc * N * 16);     // basis of the chunk, the same
  s.ea = p;   p += pad16(N * N * 4);       // edge_attr of the chain
  // per warp: the tile's edge geometry (x_i - x_j and xs0_i - xs0_j of its
  // 16 rows, float4 each), rows[tc][F] (dsrc_i, later dagg_i), two slots
  // [tc][32] a lane (dagg and the dx sums), agg_i and silu'(nz_i)
  s.warp_bytes = pad16(2 * 16 * 16 + (tc * F + 2 * tc * 32 + 2 * F) * 4);
  s.warp = p; p += kT32Warps * s.warp_bytes;
  s.total = p;
  return s;
}

// rows min(g + 8r, nrows - 1) of a row-major f32 array, C columns, in the
// accumulator layout
template <int C>
__device__ __forceinline__ void clamped_rows(float (&v)[2][C / 4], const float* base, int ld,
                                             int nrows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = base + (size_t)min(g + 8 * r, nrows - 1) * ld;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const float2 p = *reinterpret_cast<const float2*>(row + nt * 8 + 2 * t);
      v[r][2 * nt] = p.x;
      v[r][2 * nt + 1] = p.y;
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kT32Threads, 1)
egcl_tan_f32tc_kernel(const float* __restrict__ h, const float* __restrict__ x,
                      const float* __restrict__ ea, const float* __restrict__ xs0,
                      const float* __restrict__ basis, const float* __restrict__ dh,
                      const float* __restrict__ dx, const float* __restrict__ wts,
                      const float* __restrict__ wtf, float* __restrict__ dh_out,
                      float* __restrict__ dx_out, Cfg c, int Tc, int tc) {
  static_assert(F == 16 || F == 32, "F must be 16 or 32");
  constexpr int V = F / 4, FS = F + 8, K8 = F / 8;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const WOff o = woff(F);
  const TfOff q = tfoff(F);
  const int N = c.N, tid = threadIdx.x;
  const int b = blockIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.y * tc;
  const int nt = min(tc, Tc - t0);  // tangents of this block
  const T32Smem L = t32_smem<F>(N, tc);
  const float4* wg4 = reinterpret_cast<const float4*>(wtf);

  const float4* me2 = reinterpret_cast<const float4*>(smem + L.mats) + q.e2 / 4;
  const float4* mc1 = reinterpret_cast<const float4*>(smem + L.mats) + q.c1 / 4;
  const float4* mc1t = reinterpret_cast<const float4*>(smem + L.mats) + q.c1t / 4;
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  const float *wr = vec, *we = vec + F, *be2 = vec + 2 * F, *watt = vec + 3 * F,
              *bc1 = vec + 4 * F, *wc2 = vec + 5 * F;
  float* src = reinterpret_cast<float*>(smem + L.src);
  float* dst = reinterpret_cast<float*>(smem + L.dst);
  float* sx = reinterpret_cast<float*>(smem + L.x);
  float* sx0 = reinterpret_cast<float*>(smem + L.xs0);
  float* sdd = reinterpret_cast<float*>(smem + L.dd);
  float4* sdx = reinterpret_cast<float4*>(smem + L.dxs);
  float4* se = reinterpret_cast<float4*>(smem + L.es);
  float* sea = reinterpret_cast<float*>(smem + L.ea);

  // prologue: the edge matrices, the vectors, the chain's coordinates, the
  // chunk's tangents
  {
    float4* ms = reinterpret_cast<float4*>(smem + L.mats);
    for (int k = tid; k < 6 * F * F / 4; k += kT32Threads) ms[k] = wg4[k];
    for (int k = tid; k < F; k += kT32Threads) {
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
    for (int k = tid; k < N * N; k += kT32Threads) sea[k] = ea[(size_t)b * N * N + k];
    for (int k = tid; k < 3 * N; k += kT32Threads) {
      sx[k] = xb[k];
      sx0[k] = x0b[k];
    }
    const size_t bt0 = (size_t)b * Tc + t0;
    const float* dxg = dx + bt0 * N * 3;
    const float* eg = basis + (size_t)t0 * N * 3;
    for (int k = tid; k < nt * N; k += kT32Threads) {
      sdx[k] = make_float4(dxg[3 * k], dxg[3 * k + 1], dxg[3 * k + 2], 0.f);
      se[k] = make_float4(eg[3 * k], eg[3 * k + 1], eg[3 * k + 2], 0.f);
    }
  }
  const float* hb = h + (size_t)b * N * F;
  const float* dhb = dh + ((size_t)b * Tc + t0) * N * F;  // the chunk's dh, [tangent][node][F]
  const int NT16 = (N + 15) / 16;
  if (warp < NT16) {  // src | dst = h [W_src | W_dst] + [b_src | 0], a node tile a warp
    const int n0 = 16 * warp;
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
    store_tile<F, 2 * F>(sd, 0, src, F, n0, N, lane);
    store_tile<F, 2 * F>(sd, F, dst, FS, n0, N, lane);
  }
  // ddst = dh W_dst for every (tangent, node tile) of the chunk
  for (int it = warp; it < nt * NT16; it += kT32Warps) {
    const int u = it / NT16, n0 = 16 * (it % NT16);
    float v[2][V];
    load_tile<F>(v, dhb + (size_t)u * N * F, F, n0, N, lane);
    uint32_t ah[K8][4], al[K8][4];
    to_frag_tf32<F>(v, ah, al);
    float y[2][V];
#pragma unroll
    for (int k = 0; k < V; ++k) y[0][k] = y[1][k] = 0.f;
    mm3<F, F>(y, ah, al, wg4 + (q.sd + 2 * F * F) / 4, lane);
    store_tile<F, F>(y, 0, sdd + u * N * FS, FS, n0, N, lane);
  }
  __syncthreads();

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

  for (int i = warp; i < N; i += kT32Warps) {
    // dsrc_i = dh_i W_src, one row per tangent of the chunk
    {
      float v[2][V];
      clamped_rows<F>(v, dhb + (size_t)i * F, N * F, nt, lane);
      uint32_t ah[K8][4], al[K8][4];
      to_frag_tf32<F>(v, ah, al);
      float ds[2][V];
#pragma unroll
      for (int k = 0; k < V; ++k) ds[0][k] = ds[1][k] = 0.f;
      mm3<F, F>(ds, ah, al, wg4 + q.sd / 4, lane);
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
      // and xs0_i - xs0_j wait in shared memory
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
      // primal: sp1 = silu'(z1), mp = m_pre, sp2 = silu'(z2), kcu = W_c1 (silu'(cz) w_c2)
      float sp1[2][V], mp[2][V], sp2[2][V], kcu[2][V];
      float atte[2], datf[2], tfac[2], wfac[2], wij[2];
      {
        uint32_t ah[K8][4], al[K8][4];
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
              const float s = sigm_fast(z[r][v]);
              sp1[r][v] = s * (1.f + z[r][v] * (1.f - s));
              z[r][v] *= s;
            }
          to_frag_tf32<F>(z, ah, al);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) mp[0][v] = mp[1][v] = be2[col_of(v, t)];
        mm3<F, F>(mp, ah, al, me2, lane);  // z2
        float lg[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float z2 = mp[r][v];
            const float s = sigm_fast(z2);
            sp2[r][v] = s * (1.f + z2 * (1.f - s));
            mp[r][v] = z2 * s;
            lg[r] += mp[r][v] * wa_r[v];
          }
        float m[2][V];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float att = c.attention ? sigm_fast(quad_sum(lg[r]) + batt) : 1.f;
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
        to_frag_tf32<F>(m, ah, al);
        float cz[2][V];
#pragma unroll
        for (int v = 0; v < V; ++v) cz[0][v] = cz[1][v] = bc1[col_of(v, t)];
        mm3<F, F>(cz, ah, al, mc1, lane);
        float cm[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float z = cz[r][v];
            const float s = sigm_fast(z);
            const float w2 = wc2[col_of(v, t)];
            cm[r] += z * s * w2;
            cz[r][v] = s * (1.f + z * (1.f - s)) * w2;  // silu'(cz) w_c2
          }
        to_frag_tf32<F>(cz, ah, al);
#pragma unroll
        for (int v = 0; v < V; ++v) kcu[0][v] = kcu[1][v] = 0.f;
        mm3<F, F>(kcu, ah, al, mc1t, lane);
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
        // sp1 dz1, dz1 = dsrc_i + ddst_j + c w_r + e w_e
        float acc[2][V];
        const float* ddu = sdd + u * N * FS;
#pragma unroll
        for (int v = 0; v < V; v += 2) {
          const int col = col_of(v, t);
          const float2 ds = *reinterpret_cast<const float2*>(rows + u * F + col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 dd = *reinterpret_cast<const float2*>(ddu + jj[r] * FS + col);
            acc[r][v] = sp1[r][v] * ((ds.x + dd.x) + (ct[r] * wr_r[v] + et[r] * we_r[v]));
            acc[r][v + 1] =
                sp1[r][v + 1] * ((ds.y + dd.y) + (ct[r] * wr_r[v + 1] + et[r] * we_r[v + 1]));
          }
        }
        // dm_pre = sp2 ((sp1 dz1) W_e2), dl = dm_pre . w_att
        uint32_t ah[K8][4], al[K8][4];
        to_frag_tf32<F>(acc, ah, al);
        float dm[2][V];
#pragma unroll
        for (int v = 0; v < V; ++v) dm[0][v] = dm[1][v] = 0.f;
        mm3<F, F>(dm, ah, al, me2, lane);
        float dl[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            dm[r][v] *= sp2[r][v];
            dl[r] += dm[r][v] * wa_r[v];
          }
        // dm = dm_pre att + m_pre datt, masked; dcm = dm . kcu
        float dcm[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float datt = c.attention ? datf[r] * quad_sum(dl[r]) : 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            dm[r][v] = dm[r][v] * atte[r] + mp[r][v] * datt;
            dcm[r] += dm[r][v] * kcu[r][v];
          }
        }
        float part = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float dw = tfac[r] * quad_sum(dcm[r]) - wfac[r] * ct[r];
          part += dw * xw[r] + ww[r] * dxk[r];
        }
        sdxs[u * 32 + lane] += part;
        {  // dagg_i += sum over the tile's senders of dm
          float p[V];
#pragma unroll
          for (int v = 0; v < V; ++v) p[v] = dm[0][v] + dm[1][v];
          int unused;
          sdag[u * 32 + lane] += col_sum<V>(p, lane, unused);
        }
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
    // silu'(nz_i), nz_i = [h_i, agg_i] W_n1 + b_n1 (lane k: feature k)
    if (lane < F) {
      float nz = wts[o.bn1 + lane];
      for (int k = 0; k < F; ++k) nz += hb[i * F + k] * wts[o.n1 + k * F + lane];
      for (int k = 0; k < F; ++k) nz += sagg[k] * wts[o.n1 + (F + k) * F + lane];
      sspn[lane] = dsilu(nz);
    }
    __syncwarp();
    // dh_out_i = dh_i + (silu'(nz_i) [dh_i, dagg_i] W_n1) W_n2, a row per tangent
    {
      uint32_t ah[2 * K8][4], al[2 * K8][4];
      float dv[2][V];
      clamped_rows<F>(dv, dhb + (size_t)i * F, N * F, nt, lane);
      to_frag_tf32<F>(dv, ah, al);
      {
        float dg[2][V];
        clamped_rows<F>(dg, rows, F, nt, lane);
        to_frag_tf32<F>(dg, ah + K8, al + K8);
      }
      float dnz[2][V];
#pragma unroll
      for (int v = 0; v < V; ++v) dnz[0][v] = dnz[1][v] = 0.f;
      mm3<2 * F, F>(dnz, ah, al, wg4 + q.n1 / 4, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) dnz[r][v] *= sspn[col_of(v, t)];
      to_frag_tf32<F>(dnz, ah, al);
      mm3<F, F>(dv, ah, al, wg4 + q.n2 / 4, lane);  // dv = dh_i + ...
      const size_t bt0 = (size_t)b * Tc + t0;
      store_tile<F, F>(dv, 0, dh_out + (bt0 * N + i) * F, N * F, 0, nt, lane);
    }
    __syncwarp();  // the next receiver rewrites rows, sagg and the slots
  }
}

template <int F>
int launch_tan_f32tc(const float* h, const float* x, const float* ea, const float* xs0,
                     const float* basis, const float* dh, const float* dx, const float* wts,
                     const float* wtf, float* dh_out, float* dx_out, int B, int Tc, int tc,
                     const Cfg& c, cudaStream_t s) {
  const size_t bytes = t32_smem<F>(c.N, tc).total;
  const int err = prepare(egcl_tan_f32tc_kernel<F>, bytes);
  if (err) return err;
  const dim3 grid(B, (Tc + tc - 1) / tc);
  egcl_tan_f32tc_kernel<F><<<grid, kT32Threads, bytes, s>>>(h, x, ea, xs0, basis, dh, dx, wts,
                                                            wtf, dh_out, dx_out, c, Tc, tc);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest N and tangents a block the kernel takes (the largest block, N =
// 64, F = 32, tc = 8, needs 190,736 bytes of shared memory).
extern "C" int pita_egcl_tangent_tf32_max_n() { return kT32MaxN; }
extern "C" int pita_egcl_tangent_tf32_max_chunk() { return kT32MaxTc; }

// pita_egcl_tangent (csrc/egnn_tangent.cu) in f32, on tensor cores: the same
// arguments, all f32 and contiguous (h and dh 8-byte aligned), plus wtf, the
// matrices of pack_weights_tf32 (16-byte aligned); wts is the f32 buffer of
// pack_weights(w), of which the vectors and W_n1 are read. A block takes `tc`
// tangents of a chain, 1 <= tc <= 8; N <= 64.
extern "C" int pita_egcl_tangent_tf32(const float* h, const float* x, const float* ea,
                                      const float* xs0, const float* basis, const float* dh,
                                      const float* dx, const float* wts, const float* wtf,
                                      float* dh_out, float* dx_out, int B, int Tc, int tc, int N,
                                      int F, int attention, int tanh, float coords_range,
                                      void* stream) {
  if (B <= 0 || Tc <= 0) return 0;
  if (N < 1 || N > kT32MaxN || tc < 1 || tc > kT32MaxTc || (Tc + tc - 1) / tc > 65535)
    return (int)cudaErrorInvalidValue;
  const Cfg c{N, 0, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16:
      return launch_tan_f32tc<16>(h, x, ea, xs0, basis, dh, dx, wts, wtf, dh_out, dx_out, B, Tc,
                                  tc, c, s);
    case 32:
      return launch_tan_f32tc<32>(h, x, ea, xs0, basis, dh, dx, wts, wtf, dh_out, dx_out, B, Tc,
                                  tc, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
