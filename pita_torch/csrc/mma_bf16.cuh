// bf16 tensor-core helpers shared by the kernels that multiply on mma.sync:
// egnn_layer_tc.cu (K2, K3) and g_op.cu (K5).

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

}  // namespace
