// bf16 tensor-core helpers shared by the kernels that multiply on mma.sync:
// egnn_layer_tc.cu (K2, K3), egnn_tangent_tc.cu (K4) and g_op.cu (K5); the
// tile helpers below mma16816 are those of the EGCL kernels (the 3xTF32
// ones of mma_tf32.cuh too, whose accumulator layout is the same).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace {

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col). Fragment
// layouts, lane = 4 * gid + tid: a[0] row gid, k 2tid..2tid+1; a[1] row
// gid + 8, same k; a[2], a[3] the same rows at k + 8. b0 k 2tid..2tid+1, b1 k
// 2tid+8..2tid+9, both at column gid. d[0..1] row gid, columns 2tid..2tid+1;
// d[2..3] row gid + 8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A tile of 16 rows x C columns in registers, in the mma accumulator layout:
// lane (g = lane/4, t = lane%4) holds rows g (r = 0) and g + 8 (r = 1) at
// columns col(v) = (v/2)*8 + 2t + v%2, v < C/4.
__device__ __forceinline__ int col_of(int v, int t) { return (v >> 1) * 8 + 2 * t + (v & 1); }

// A fragments of the K/16 k-steps of a 16 x K tile, rounded to bf16.
template <int K>
__device__ __forceinline__ void to_frag(const float (&v)[2][K / 4], uint32_t (*a)[4]) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    a[ks][0] = pack2(v[0][4 * ks], v[0][4 * ks + 1]);
    a[ks][1] = pack2(v[1][4 * ks], v[1][4 * ks + 1]);
    a[ks][2] = pack2(v[0][4 * ks + 2], v[0][4 * ks + 3]);
    a[ks][3] = pack2(v[1][4 * ks + 2], v[1][4 * ks + 3]);
  }
}

// The same for an f32 operand that must keep its f32 value: hi + lo.
template <int K>
__device__ __forceinline__ void to_frag_split(const float (&v)[2][K / 4], uint32_t (*hi)[4],
                                              uint32_t (*lo)[4]) {
  float r[2][K / 4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int k = 0; k < K / 4; ++k)
      r[q][k] = v[q][k] - __bfloat162float(__float2bfloat16(v[q][k]));
  to_frag<K>(v, hi);
  to_frag<K>(r, lo);
}

// acc (16 x NO) += A (16 x K, fragments a) . M, with M^T at mt (rows of K+8)
template <int K, int NO>
__device__ __forceinline__ void mm(float (&acc)[2][NO / 4], const uint32_t (*a)[4],
                                   const __nv_bfloat16* mt, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NO / 8; ++nt) {
    float d[4] = {acc[0][2 * nt], acc[0][2 * nt + 1], acc[1][2 * nt], acc[1][2 * nt + 1]};
    const __nv_bfloat16* row = mt + (nt * 8 + g) * (K + 8) + 2 * t;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + ks * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + ks * 16 + 8);
      mma16816(d, a[ks], b0, b1);
    }
    acc[0][2 * nt] = d[0];
    acc[0][2 * nt + 1] = d[1];
    acc[1][2 * nt] = d[2];
    acc[1][2 * nt + 1] = d[3];
  }
}

// rows row0 + g + 8r (< nrows, else 0) of a row-major f32 array, C columns
template <int C>
__device__ __forceinline__ void load_tile(float (&v)[2][C / 4], const float* base, int ld,
                                          int row0, int nrows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      float2 p = make_float2(0.f, 0.f);
      if (row < nrows) p = *reinterpret_cast<const float2*>(base + row * ld + nt * 8 + 2 * t);
      v[r][2 * nt] = p.x;
      v[r][2 * nt + 1] = p.y;
    }
  }
}

// columns [c0, c0 + C) of a 16 x * tile into rows row0 + g + 8r < nrows
template <int C, int CT>
__device__ __forceinline__ void store_tile(const float (&v)[2][CT / 4], int c0, float* base,
                                           int ld, int row0, int nrows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= nrows) continue;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
      *reinterpret_cast<float2*>(base + row * ld + nt * 8 + 2 * t) =
          make_float2(v[r][c0 / 4 + 2 * nt], v[r][c0 / 4 + 2 * nt + 1]);
  }
}

// sum over the quad (the 4 lanes that share a tile row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// one level of a reduce-scatter over lanes lane ^ m: keep half the values
template <int H>
__device__ __forceinline__ void halve(float* p, int lane, int m, int& base) {
  const bool up = lane & m;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? p[k] : p[k + H];
    const float keep = up ? p[k + H] : p[k];
    p[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
  if (up) base += H;
}

// Column sums of a tile row-pair p[v] (already summed over the lane's two
// rows) over the 8 row groups: returns one total, of column col_of(vi, t);
// for F = 16 lanes lane and lane ^ 4 hold the same one (owner: lane & 4 == 0).
template <int V>
__device__ __forceinline__ float col_sum(float (&p)[V], int lane, int& vi) {
  int base = 0;
  if constexpr (V == 8) {
    halve<4>(p, lane, 16, base);
    halve<2>(p, lane, 8, base);
    halve<1>(p, lane, 4, base);
  } else {
    static_assert(V == 4, "F must be 16 or 32");
    halve<2>(p, lane, 16, base);
    halve<1>(p, lane, 8, base);
    p[0] += __shfl_xor_sync(0xffffffffu, p[0], 4);
  }
  vi = base;
  return p[0];
}

// Per-edge geometry of a sender tile's rows for receiver i, as the VJP
// kernels (K3) walk it: the lane's two rows are senders j0 + g + 8r; a row
// without an edge (j >= N or j == i) runs the diagonal. sx: the chain's
// coordinates (3 a node), eab: its edge_attr (N x N).
struct Geo {
  float d[2][3], rad[2], eij[2], vm[2];
  int jj[2], j[2];
};

__device__ __forceinline__ void edge_geo(Geo& e, const float* sx, const float* eab, int i, int j0,
                                         int N, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + g + 8 * r;
    const bool valid = j < N && j != i;
    const int jj = j < N ? j : i;
    e.j[r] = j;
    e.jj[r] = jj;
    e.vm[r] = valid ? 1.f : 0.f;
    float rad = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e.d[r][k] = sx[3 * i + k] - sx[3 * jj + k];
      rad += e.d[r][k] * e.d[r][k];
    }
    e.rad[r] = rad;
    e.eij[r] = eab[i * N + jj];
  }
}

}  // namespace
