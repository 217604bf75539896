// f32 products on tensor cores in 3xTF32, shared by the f32 EGCL kernels that
// multiply on mma.sync: egnn_tangent_f32tc.cu (K4), egnn_layer_f32tc.cu (K2)
// and egnn_layer_bwd_f32tc.cu (K3). They take the accumulator-layout tile
// helpers of mma_bf16.cuh (col_of, load_tile, store_tile, quad_sum,
// col_sum), whose layout the m16n8k8 TF32 accumulator shares.
//
// An f32 value a is split into hi = tf32(a), a rounded to TF32's 10 mantissa
// bits, and lo = a - hi, exact in f32. A product a b is then taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, three m16n8k8 TF32 mma.sync products into
// one f32 accumulator. What is dropped, lo_a lo_b and the bits of lo below
// TF32's precision, is about 2^-21 of |a b|: the products keep about f32
// accuracy, which one TF32 pass (2^-11) would not.
//
// Fragment layouts of m16n8k8 (lane = 4 g + t): A a0 (row g, k t), a1 (row
// g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4); B b0 (k t,
// column g), b1 (k t + 4, column g); the accumulator as for m16n8k16 (d0, d1
// row g, columns 2t, 2t + 1; d2, d3 row g + 8). A lane's accumulator holds
// columns 2t and 2t + 1 of each 8-column block, not t and t + 4; since the
// order of the k terms of a product is free, the k-step ks takes column
// 8 ks + 2t as its k = t and 8 ks + 2t + 1 as its k = t + 4, for A and B
// alike. So an accumulator tile is the next product's A operand in
// registers (to_frag_tf32), and a lane's B fragment is two neighbouring rows
// of M, which the host packer stores beside each other.

#pragma once

#include <cstdint>

namespace {

// Offsets (in floats) of the matrices of the f32 tensor-core weight buffer,
// each the right operand M (K x NO) of a product Y = A M in fragment layout:
// for each (n-tile nt, k-step ks, lane) one float4 {hi M[k][n], hi M[k+1][n],
// lo M[k][n], lo M[k+1][n]}, k = 8 ks + 2 t, n = 8 nt + g, at float4 index
// (nt K/8 + ks) 32 + lane; 2 K NO floats a matrix. Mirrored by
// pita_torch/ops/egnn_layer.py:pack_weights_tf32. K2 and K4 read the first
// six; K3 also the transposes after them (appended, so that the offsets of
// the first six stay where they were).
struct TfOff {
  int e2, c1, c1t, sd, n1, n2, e2t, n2t, n1t, sdt, total;
};

__host__ __device__ inline TfOff tfoff(int F) {
  TfOff o;
  int p = 0;
  o.e2 = p;  p += 2 * F * F;  // M = W_e2 (e2, c1 and c1t adjoin: the edge matrices)
  o.c1 = p;  p += 2 * F * F;  // M = W_c1
  o.c1t = p; p += 2 * F * F;  // M = W_c1^T
  o.sd = p;  p += 4 * F * F;  // M = [W_src | W_dst]; W_dst's n-tiles start at sd + 2 F^2
  o.n1 = p;  p += 4 * F * F;  // M = W_n1 (2F x F)
  o.n2 = p;  p += 2 * F * F;  // M = W_n2
  o.e2t = p; p += 2 * F * F;  // M = W_e2^T (K3's edge pass)
  o.n2t = p; p += 2 * F * F;  // M = W_n2^T (K3's node MLP backward)
  o.n1t = p; p += 4 * F * F;  // M = W_n1^T (F x 2F)
  o.sdt = p; p += 4 * F * F;  // M = [W_src^T ; W_dst^T] (2F x F)
  o.total = p;
  return o;
}

// a = hi + lo: hi is a rounded to TF32 (to nearest, ties away from zero),
// lo = a - hi exactly, handed to the tensor core, which reads its TF32 bits
// (adding half a TF32 ulp first makes that a rounding, not a truncation)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(a - __uint_as_float(h)) + 0x1000u;
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi and lo A fragments of the K/8 k-steps of a 16 x K tile held in the
// accumulator layout (v[r][2 ks + e]: row g + 8r, column 8 ks + 2t + e)
template <int K>
__device__ __forceinline__ void to_frag_tf32(const float (&v)[2][K / 4], uint32_t (*hi)[4],
                                             uint32_t (*lo)[4]) {
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    split_tf32(v[0][2 * ks], hi[ks][0], lo[ks][0]);
    split_tf32(v[1][2 * ks], hi[ks][1], lo[ks][1]);
    split_tf32(v[0][2 * ks + 1], hi[ks][2], lo[ks][2]);
    split_tf32(v[1][2 * ks + 1], hi[ks][3], lo[ks][3]);
  }
}

// acc (16 x NO) += A (16 x K, fragments hi + lo) . M, M in fragment layout at
// mf (shared or global memory); the small terms first
template <int K, int NO>
__device__ __forceinline__ void mm3(float (&acc)[2][NO / 4], const uint32_t (*hi)[4],
                                    const uint32_t (*lo)[4], const float4* mf, int lane) {
#pragma unroll
  for (int nt = 0; nt < NO / 8; ++nt) {
    float d[4] = {acc[0][2 * nt], acc[0][2 * nt + 1], acc[1][2 * nt], acc[1][2 * nt + 1]};
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const float4 b = mf[(nt * (K / 8) + ks) * 32 + lane];
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      mma1688(d, lo[ks], bh0, bh1);
      mma1688(d, hi[ks], __float_as_uint(b.z), __float_as_uint(b.w));
      mma1688(d, hi[ks], bh0, bh1);
    }
    acc[0][2 * nt] = d[0];
    acc[0][2 * nt + 1] = d[1];
    acc[1][2 * nt] = d[2];
    acc[1][2 * nt + 1] = d[3];
  }
}

}  // namespace
