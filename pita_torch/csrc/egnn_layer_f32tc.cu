// K2 in f32 on tensor cores: one EGCL layer forward in f32 compute, its
// products in 3xTF32, sm_90a.
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/egnn_fwd.py:153
// _layer_fwd_kernel (called through _layer_fwd_call, egnn_fwd.py:311,
// pallas_call at :318) for compute dtype f32, as egnn_layer_tc.cu's K2 does
// for bf16. The function is the scalar egcl_fwd_kernel's in f32 (_layer_step,
// egnn_fwd.py:85-136): nothing is rounded; every product is f32, taken as
// three TF32 products (mma_tf32.cuh, ~2^-21 relative), and every sigmoid
// keeps the overflow-safe form of egnn_fwd.py:67 in f32 (sigm_fast: an
// exponential and a reciprocal, ~1e-6 relative; the bf16 K2's tanh.approx
// would err by 2^-11).
//
// What bounds it on the H100: per edge the two F x F edge products, 2.5e10
// operations at 2,000 chains, N = 55, F = 32 with the node products, 0.15 ms
// at a third of the TF32 dense peak; and 3F + 2 sigmoids and tanhs per edge,
// 0.14 ms at one SFU operation each, 0.28 ms at the two an accurate sigmoid
// takes here. The scalar K2 ran the products on the FP32 pipes (2.42-2.45
// ms at 2,000 chains on an H100 80GB HBM3 at 700 W). The design is the bf16
// K2's:
//  - One block per chain, one warp per tile of 16 receivers i (one m16
//    tile; N <= 64, so at most 4 warps); the warp walks over all senders j.
//  - The edge chain z1 -> silu -> .W_e2 -> z2 -> silu -> gate -> .W_c1 -> cz
//    runs as m16n8k8 TF32 mmas, three a product (hi and lo of the operands),
//    with f32 accumulators, each accumulator tile feeding the next product
//    as its A fragments in registers (to_frag_tf32, mm3). A lane holds 2
//    receivers x F/4 features of each F-vector.
//  - Every sum of the forward runs over senders for a fixed receiver (agg_i,
//    sum_j w_ij, sum_j w_ij x_j), so each stays in the lane's registers for
//    the whole walk: no sum in shared memory and no atomic, a fixed order
//    (two launches are bitwise equal). The node MLP takes agg_i from those
//    registers as A fragments for the warp's own 16 nodes.
//  - The attention logit and cm are quad sums reduce-scattered by row: lane
//    t of a quad finishes row t & 1, so the gate is computed by two lanes a
//    quad (not four) and exchanged, and the coordinate weight (tanhf,
//    1 / (|x_i - x_j| + 1)) by the lanes that keep that row's sums.
//  - Shared memory holds what the warps read at every step: W_e2 and W_c1
//    in TF32 hi + lo fragment layout (a lane's B fragment is one float4), the
//    per-feature vectors, src (rows of F + 8: a warp reads 8 rows at once, on
//    distinct banks), dst and x; 33.7 KB at F = 32, N = 55. The src/dst
//    projection's and the node MLP's matrices are read from global memory
//    once per block. edge_attr is read from global memory.
//  - Padded rows (i >= N) run row N - 1's values and are not stored; the
//    diagonal runs finite values and is masked out of every sum.

#include "egnn_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

#include <cstdint>

namespace {

constexpr int kF32MaxN = 64;  // one 16-receiver tile per warp, at most 4 warps
constexpr int kF32Threads = 128;
constexpr int kF32MinBlocks = 4;

template <int F>
size_t fwd_f32tc_smem_bytes(int N) {
  const int FS = F + 8;
  return ((size_t)4 * F * F + 6 * F + 4 + (size_t)N * (FS + F) + pad4(3 * N)) * sizeof(float);
}

template <int F>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
egcl_fwd_f32tc_kernel(const float* __restrict__ h, const float* __restrict__ x,
                      const float* __restrict__ ea, const float* __restrict__ wts,
                      const float* __restrict__ wtf, float* __restrict__ h_out,
                      float* __restrict__ x_out, Cfg c) {
  static_assert(F == 16 || F == 32, "F must be 16 or 32");
  constexpr int V = F / 4, FS = F + 8, K8 = F / 8;
  extern __shared__ float4 smem4[];
  const WOff o = woff(F);
  const TfOff q = tfoff(F);
  const int N = c.N, tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const float4* wg4 = reinterpret_cast<const float4*>(wtf);

  const float4* me2 = smem4 + q.e2 / 4;
  const float4* mc1 = smem4 + q.c1 / 4;
  float* vec = reinterpret_cast<float*>(smem4 + F * F);
  const float *wr = vec, *we = vec + F, *be2 = vec + 2 * F, *watt = vec + 3 * F,
              *bc1 = vec + 4 * F, *wc2 = vec + 5 * F;
  float* src = vec + 6 * F + 4;  // rows of FS
  float* dst = src + N * FS;     // rows of F
  float* sx = dst + N * F;

  // prologue: the two edge matrices, the vectors, the coordinates
  {
    for (int k = tid; k < F * F; k += nthr) smem4[k] = wg4[k];  // W_e2, W_c1: 4 F^2 floats
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
  {  // src | dst = h [W_src | W_dst] + [b_src | 0]
    float hv[2][V];
    load_tile<F>(hv, hb, F, i0, N, lane);
    uint32_t ah[K8][4], al[K8][4];
    to_frag_tf32<F>(hv, ah, al);
    float sd[2][2 * V];
#pragma unroll
    for (int v = 0; v < 2 * V; ++v) {
      const int col = col_of(v, t);
      sd[0][v] = sd[1][v] = col < F ? wts[o.bsrc + col] : 0.f;
    }
    mm3<F, 2 * F>(sd, ah, al, wg4 + q.sd / 4, lane);
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
    uint32_t ah[K8][4], al[K8][4];
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
        for (int v = 0; v < V; ++v) z[r][v] *= sigm_fast(z[r][v]);
      to_frag_tf32<F>(z, ah, al);
    }
    // m_pre = silu(z2), z2 = silu(z1) W_e2 + b_e2; the attention logit
    float mp[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) mp[0][v] = mp[1][v] = be2[col_of(v, t)];
    mm3<F, F>(mp, ah, al, me2, lane);
    float lg[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        mp[r][v] *= sigm_fast(mp[r][v]);
        lg[r] += mp[r][v] * watt[col_of(v, t)];
      }
    float att[2] = {1.f, 1.f};
    if (c.attention) {  // lane t finishes row t & 1, then the pair swaps gates
      float l = (me ? lg[1] : lg[0]) + __shfl_xor_sync(0xffffffffu, me ? lg[0] : lg[1], 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float mine = sigm_fast(l + batt);
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      att[0] = me ? other : mine;
      att[1] = me ? mine : other;
    }
    // m = m_pre * att, off the diagonal; agg_i += m; cz = m W_c1 + b_c1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float gate = j != i0 + g + 8 * r ? att[r] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        mp[r][v] *= gate;
        agg[r][v] += mp[r][v];
      }
    }
    to_frag_tf32<F>(mp, ah, al);
    float cz[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) cz[0][v] = cz[1][v] = bc1[col_of(v, t)];
    mm3<F, F>(cz, ah, al, mc1, lane);
    float cm[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) cm[r] += cz[r][v] * sigm_fast(cz[r][v]) * wc2[col_of(v, t)];
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

  // x_out_i = x_i + x_i sum_j w_ij - sum_j w_ij x_j: lanes t = 0, 1 of a quad
  if (t < 2 && i_me < N) {
    float* xo = x_out + ((size_t)b * N + i_me) * 3;
    const float x0 = me ? xi[1][0] : xi[0][0], x1 = me ? xi[1][1] : xi[0][1],
                x2 = me ? xi[1][2] : xi[0][2];
    xo[0] = x0 + x0 * sw - swx0;
    xo[1] = x1 + x1 * sw - swx1;
    xo[2] = x2 + x2 * sw - swx2;
  }

  // node MLP of the warp's 16 nodes: h_out = h + silu([h, agg] W_n1 + b_n1) W_n2 + b_n2
  {
    uint32_t ah[2 * K8][4], al[2 * K8][4];
    float hv[2][V];
    load_tile<F>(hv, hb, F, i0, N, lane);
    to_frag_tf32<F>(hv, ah, al);
    to_frag_tf32<F>(agg, ah + K8, al + K8);
    float nz[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) nz[0][v] = nz[1][v] = wts[o.bn1 + col_of(v, t)];
    mm3<2 * F, F>(nz, ah, al, wg4 + q.n1 / 4, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) nz[r][v] = silu(nz[r][v]);
    to_frag_tf32<F>(nz, ah, al);
    float y[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) y[0][v] = y[1][v] = 0.f;
    mm3<F, F>(y, ah, al, wg4 + q.n2 / 4, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) y[r][v] = hv[r][v] + y[r][v] + wts[o.bn2 + col_of(v, t)];
    store_tile<F, F>(y, 0, h_out + (size_t)b * N * F, F, i0, N, lane);
  }
}

template <int F>
int launch_fwd_f32tc(const float* h, const float* x, const float* ea, const float* wts,
                     const float* wtf, float* h_out, float* x_out, int B, const Cfg& c,
                     cudaStream_t s) {
  if (c.N < 1 || c.N > kF32MaxN) return (int)cudaErrorInvalidValue;
  const size_t bytes = fwd_f32tc_smem_bytes<F>(c.N);
  const int err = prepare(egcl_fwd_f32tc_kernel<F>, bytes);
  if (err) return err;
  const int warps = (c.N + 15) / 16;  // one per 16-receiver tile
  egcl_fwd_f32tc_kernel<F><<<B, 32 * warps, bytes, s>>>(h, x, ea, wts, wtf, h_out, x_out, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Length in floats of the 3xTF32 kernels' weight buffer (pack_weights_tf32).
extern "C" int pita_egcl_tf32_weights_len(int F) { return tfoff(F).total; }

// Largest N the kernel takes (one 16-receiver tile per warp).
extern "C" int pita_egcl_tf32_max_n() { return kF32MaxN; }

// pita_egcl_forward (csrc/egnn_layer.cu) in f32, on tensor cores: h (B, N,
// F), x (B, N, 3), ea (B, N, N) -> h_out (B, N, F), x_out (B, N, 3), all f32
// and contiguous (h 8-byte aligned); wts is the f32 buffer of
// pack_weights(w), of which the vectors are read, wtf the matrices of
// pack_weights_tf32 (16-byte aligned). N <= pita_egcl_tf32_max_n().
extern "C" int pita_egcl_forward_tf32(const float* h, const float* x, const float* ea,
                                      const float* wts, const float* wtf, float* h_out,
                                      float* x_out, int B, int N, int F, int attention, int tanh,
                                      float coords_range, void* stream) {
  if (B <= 0) return 0;
  const Cfg c{N, 0, attention, tanh, coords_range};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16: return launch_fwd_f32tc<16>(h, x, ea, wts, wtf, h_out, x_out, B, c, s);
    case 32: return launch_fwd_f32tc<32>(h, x, ea, wts, wtf, h_out, x_out, B, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
