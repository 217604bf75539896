// G-operator tangent contraction for the exact score divergence (K5), sm_90a.
//
// Replaces the Pallas TPU kernel pita_tpu/ops/pallas/g_op.py: _kernel, called
// through g_operator_contract (g_op.py:91, pallas_call at :133):
//
//   t2[t,b,n,g] = sum_{m,f} G[b,n,m,f,g] * bv[t,b,m,f]
//   G[b,n,m,f,g] = att_mask[b,n,m] * sp1[b,n,m,f] * W2[f,g] * sp2[b,n,m,g]
//                  + satq[b,n,m,f] * m_pre[b,n,m,g]
//
// with G built on chip from the primal edge activations, so the
// (B, N, N, F, F) operator never exists in device memory. As in the TPU
// kernel, G and bv are rounded to bf16 for the product whatever the model's
// compute dtype, and the sum accumulates in f32. Each G element is formed in
// f32 as (att_mask*sp2[g]) * (sp1[f]*W2[f,g]) + satq[f]*m_pre[g] and then
// rounded, so near-integer inputs give the plain version's result exactly.
//
// Two kernels. pita_g_op_contract runs the tensor-core kernel below, the one
// every caller gets. pita_g_op_contract_scalar keeps the first version
// (scalar f32 FMAs, one block per chain and 16 tangents, G rebuilt for every
// tile of tangents, at the end of this file) as a yardstick only.
//
// What bounds it on the H100: per chain one product (T x N*F) . (N*F x N*F),
// 2*(N*F)^2*T operations, against (4*N*N*F + 2*T*N*F) floats moved: at N=55,
// F=32, T=165 and 256 chains 0.26 ms of bf16 tensor-core work and 0.30 ms of
// bytes, so a good kernel sits near the byte bound. The tensor-core design:
//  - wgmma.mma_async m64n168k16, bf16 operands from shared memory, f32
//    accumulators. The product's rows are (receiver n, column g): one
//    warpgroup's 64 rows are 64/F receivers. Its columns are 168 tangents, so
//    all T = 165 tangents of LJ55 fit one product and G is built once per
//    chain. The reduction index is k = (m, f), F/16 k steps per sender m.
//  - B (bv): a first small kernel rounds bv to bf16 once and writes it as a
//    panel in wgmma's K-major core-matrix layout (pack_panel_kernel).
//  - A (G): each warp builds its 16 rows of G for one sender in registers,
//    each element formed in f32 and rounded, and stores them to the
//    warpgroup's A tile in shared memory. A from registers makes ptxas
//    serialize the products (the next sender's operands are written while
//    the last products run); a tile in shared memory, double-buffered, does
//    not, so the products of sender m run while the G of m + 1 is built.
//  - A block is kWG warpgroups (3 x 64/F receivers) of one chain. The block's
//    threads copy each sender's B tiles (10.5 KB at F=32) and its receivers'
//    primal rows with cp.async into a ring of kStages slots, kStages -
//    kInFlight - 1 senders ahead; full/empty mbarriers hand the slots between
//    the copies and the warpgroups' products, with no block-wide barrier.
//    Each lane keeps its W2 entries (F/16 * 8) in registers.
//  - The blocks of a chain are adjacent in the grid, so its panel (590 KB)
//    and primal rows stay in L2 while they run.
//  - What holds it at ~3x its bound (measured): shared memory, not the
//    tensor cores. Per sender an SM reads 44 KB of operands for its three
//    warpgroups' products (504 clocks of tensor work) and moves ~14 KB of
//    copies and the G build's loads and stores beside them.
//  - Determinism: each output element is written by one thread, the sum over
//    m runs in a fixed order, no atomics: two launches are bitwise equal.
//  - Limits: N <= 64, F in {16, 32}.

#include "mma_bf16.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNT = 168;  // tangents a warpgroup carries: the N of its wgmma
constexpr int kWG = 3;    // warpgroups a block
constexpr int kTcThreads = 128 * kWG;
constexpr int kTcMaxN = 64;
constexpr int kInFlight = 1;  // groups of products a warpgroup leaves running
constexpr int kStages = 4;    // ring slots, one sender each

// bv (T, B, N, F) f32 -> panel (bf16) in the layout wgmma reads its B operand
// in (K-major, no swizzle): for chain b and k step kk (k = 16kk..16kk+15,
// k = m*F + f), Tp/8 groups of 8 tangents, each two 8 x 8 core matrices (k
// 0-7, then 8-15), each 8 tangent rows of 16 bytes. Tangents past T are 0.
// One thread writes one 16-byte row.
__global__ void pack_panel_kernel(const float* __restrict__ bv, uint4* __restrict__ panel,
                                  int T, int B, int N, int F, int Tp) {
  const int NK = N * F / 16, CT = Tp / 8;
  const size_t total = (size_t)B * NK * CT * 16;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int tr = (int)(i & 7), kh = (int)((i >> 3) & 1);
    size_t q = i >> 4;
    const int ct = (int)(q % CT);
    q /= CT;
    const int kk = (int)(q % NK), b = (int)(q / NK);
    const int t = ct * 8 + tr, k = kk * 16 + kh * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      const float4* src =
          reinterpret_cast<const float4*>(bv + (((size_t)t * B + b) * N + k / F) * F + k % F);
      const float4 lo = src[0], hi = src[1];
      v = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y), pack2(hi.z, hi.w));
    }
    panel[i] = v;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes16) {
  if (bytes16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// d (64 x 168 f32, the warpgroup's accumulators) += a (64 x 16) . b (16 x 168),
// bf16, both in shared memory as K-major core matrices (descriptors da, db)
__device__ __forceinline__ void wgmma_m64n168k16(float (&d)[84], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %86, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83"
      "}, %84, %85, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
// keeps the compiler from moving the accumulators across an asynchronous product
__device__ __forceinline__ void fence_acc(float (&d)[84]) {
#pragma unroll
  for (int i = 0; i < 84; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory matrix descriptor of a K-major, unswizzled 16-deep tile:
// core matrices (8 rows of 16 bytes) adjacent in k are 128 bytes apart
// (leading byte offset), groups of 8 rows 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t desc(const void* tile) {
  const uint64_t addr = (uint32_t)__cvta_generic_to_shared(tile);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// One slot of the ring: what the block needs for one sender m.
//   panel: (F/16) k steps x kNT/8 tangent groups x 256 bytes (the B tiles)
//   prim:  [r][4][F] floats, sp1, satq, sp2, m_pre of edge (n0 + r, m)
//   att:   [r] floats
template <int F>
struct Stage {
  static constexpr int kR = kWG * 64 / F;      // receivers a block
  static constexpr int kTile = kNT / 8 * 256;  // bytes of one k step's B tile
  static constexpr int kPanel = (F / 16) * kTile;
  static constexpr int kPrim = kR * 4 * F;
  static constexpr int kAtt = (kR + 3) / 4 * 4;
  static constexpr int kBytes = kPanel + 4 * (kPrim + kAtt);
  // the ring, each warpgroup's kInFlight + 1 A buffers of F/16 k steps x 2 KB,
  // then the full and empty barrier of each slot
  static constexpr int kA = kWG * (kInFlight + 1) * (F / 16) * 2048;
  static constexpr int kSmem = kStages * kBytes + kA + 2 * kStages * 8;
};

// A thread's share of filling one ring slot: fixed 16-byte pieces (4 bytes
// for the gate) whose sources advance by a constant from one sender to the
// next, so a slot costs a few instructions.
template <int F>
struct Copier {
  static constexpr int KS = F / 16, CH = kNT / 8 * 16, R = Stage<F>::kR;
  static constexpr int kPanelPer = (KS * CH + kTcThreads - 1) / kTcThreads;
  const uint4* panel_src[kPanelPer];
  int panel_dst[kPanelPer];  // uint4 index in the slot, -1 for none
  size_t panel_step;         // uint4s from one sender to the next
  const float* prim_src;     // nullptr for none
  int prim_dst;              // float index in the slot's primal rows
  const float* att_src;      // nullptr for none

  __device__ __forceinline__ Copier(const float* sp1, const float* sp2, const float* attm,
                                    const float* satq, const float* mpre, const uint4* pg,
                                    size_t kk_stride, int b, int n0, int N) {
    const int tid = threadIdx.x;
    panel_step = KS * kk_stride;
#pragma unroll
    for (int k = 0; k < kPanelPer; ++k) {
      const int c = tid + k * kTcThreads;
      panel_dst[k] = c < KS * CH ? c : -1;
      panel_src[k] = pg + (size_t)(c / CH) * kk_stride + c % CH;
    }
    // the primal rows; receivers past N copy row N - 1
    prim_src = nullptr;
    prim_dst = 0;
    if (tid < R * F) {
      const int r = tid / F, arr = (tid % F) / (F / 4), q = tid % (F / 4);
      const int n = min(n0 + r, N - 1);
      const float* src = arr == 0 ? sp1 : arr == 1 ? satq : arr == 2 ? sp2 : mpre;
      prim_src = src + ((size_t)b * N + n) * N * F + 4 * q;
      prim_dst = (r * 4 + arr) * F + 4 * q;
    }
    att_src = tid < R ? attm + ((size_t)b * N + min(n0 + tid, N - 1)) * N : nullptr;
  }

  __device__ __forceinline__ void issue(char* slot, int m) const {
    uint4* sb = reinterpret_cast<uint4*>(slot);
    float* sp = reinterpret_cast<float*>(slot + Stage<F>::kPanel);
#pragma unroll
    for (int k = 0; k < kPanelPer; ++k)
      if (panel_dst[k] >= 0) cp_async(sb + panel_dst[k], panel_src[k] + m * panel_step, 1);
    if (prim_src) cp_async(sp + prim_dst, prim_src + (size_t)m * F, 1);
    if (att_src) cp_async(sp + Stage<F>::kPrim + threadIdx.x, att_src + m, 0);
  }
};

// grid (receiver blocks x tangent groups, B). Warp q of warpgroup w takes
// receiver n0 + w*64/F + q/(F/16) and the 16 columns g0 = 16*(q % (F/16)).. of
// it: its 16 rows of the warpgroup's 64-row A operand. A receiver past N
// computes on row N - 1 and stores nothing: no branch may surround the
// products, or ptxas serializes them.
template <int F>
__global__ void __launch_bounds__(kTcThreads, 1)
g_op_tc_kernel(const float* __restrict__ sp1, const float* __restrict__ sp2,
               const float* __restrict__ attm, const float* __restrict__ satq,
               const float* __restrict__ mpre, const float* __restrict__ w2,
               const uint4* __restrict__ panel, float* __restrict__ out, int T, int B, int N,
               int Tp) {
  using S = Stage<F>;
  constexpr int KS = F / 16, R = S::kR;
  constexpr int kAhead = kStages - kInFlight - 1;  // senders loading ahead
  extern __shared__ uint4 smem[];
  char* ring = reinterpret_cast<char*>(smem);
  char* a_all = ring + kStages * S::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(a_all + S::kA);
  uint64_t* empty = full + kStages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;
  const int n_rb = (N + R - 1) / R;
  const int n0 = (blockIdx.x % n_rb) * R, tg = blockIdx.x / n_rb;
  const int rr = wg * (64 / F) + wq / (F / 16), n = n0 + rr, g0 = 16 * (wq % (F / 16));
  const int b = blockIdx.y;
  const int NK = N * KS, CT = Tp / 8;
  const size_t kk_stride = (size_t)CT * 16;  // uint4s a k step of the panel
  const uint4* pg = panel + (size_t)b * NK * kk_stride + (size_t)tg * (kNT / 8) * 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kTcThreads);  // every thread's copies landed
      mbar_init(empty + s, kWG);        // every warpgroup's products done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // lane's W2 entries: rows f = 16ks + 8(i/2) + 2tid + i%2, columns g0 + gid + 8h
  float w2r[KS][4][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w2r[ks][i][h] = __ldg(w2 + (16 * ks + 8 * (i >> 1) + 2 * tid + (i & 1)) * F + g0 + gid + 8 * h);

  float acc[84];
#pragma unroll
  for (int i = 0; i < 84; ++i) acc[i] = 0.f;
  fence_acc(acc);

  const Copier<F> copier(sp1, sp2, attm, satq, mpre, pg, kk_stride, b, n0, N);
  for (int s = 0; s < kAhead && s < N; ++s) {
    copier.issue(ring + s * S::kBytes, s);
    cp_async_arrive(full + s);
  }
  // the warpgroup's A tiles: kInFlight + 1 buffers x KS k steps x 2 KB (64
  // rows of G); this lane's four bf16 pairs of a step at a_lane + {0, 256,
  // 128, 384} bytes: rows g0 + gid (+ 8), k 2tid, 2tid + 1 (+ 8)
  char* a_tiles = a_all + wg * (kInFlight + 1) * KS * 2048;
  const int a_lane = (2 * wq * 2) * 128 + gid * 16 + tid * 4;
  // descriptors of A buffer 0 and of slot 0's B tiles; the others are offsets
  // of them (the start address field counts 16 bytes)
  const uint64_t da0 = desc(a_tiles), db0 = desc(ring);
  const float* prim0 = reinterpret_cast<const float*>(ring + S::kPanel);

  // Per sender m: refill the slot of sender m - kInFlight - 1 with sender
  // m + kAhead once every warpgroup has released it; wait for sender m's
  // slot; build G of edge (n, m) into A buffer m % (kInFlight + 1) (free: the
  // products of m - kInFlight - 1 are done); issue the products, which run
  // while the next sender's G is built; once the products of m - kInFlight
  // are done, release their slot.
  int cur = 0, phase = 0, abuf = 0;  // m % kStages, (m / kStages) % 2, A buffer
  int fill = kAhead % kStages;       // (m + kAhead) % kStages
  for (int m = 0; m < N; ++m) {
    const int f = m + kAhead;
    if (f < N) {
      if (f >= kStages) mbar_wait(empty + fill, (f / kStages - 1) & 1);
      copier.issue(ring + fill * S::kBytes, f);
      cp_async_arrive(full + fill);
    }
    mbar_wait(full + cur, phase);
    const float* pm = prim0 + cur * (S::kBytes / 4);  // the slot's primal rows
    const float att = pm[S::kPrim + rr];
    const float* ps = pm + rr * 4 * F;
    float a_g[2], mp_g[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a_g[h] = att * ps[2 * F + g0 + gid + 8 * h];
      mp_g[h] = ps[3 * F + g0 + gid + 8 * h];
    }
    char* al = a_tiles + abuf * KS * 2048 + a_lane;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 s0 = *reinterpret_cast<const float2*>(ps + 16 * ks + 2 * tid);
      const float2 s1 = *reinterpret_cast<const float2*>(ps + 16 * ks + 8 + 2 * tid);
      const float2 q0 = *reinterpret_cast<const float2*>(ps + F + 16 * ks + 2 * tid);
      const float2 q1 = *reinterpret_cast<const float2*>(ps + F + 16 * ks + 8 + 2 * tid);
      const float s[4] = {s0.x, s0.y, s1.x, s1.y}, q[4] = {q0.x, q0.y, q1.x, q1.y};
      // each element formed in f32 as in the scalar kernel, then rounded
      float gv[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) gv[i][h] = a_g[h] * (s[i] * w2r[ks][i][h]) + q[i] * mp_g[h];
      *reinterpret_cast<uint32_t*>(al + ks * 2048) = pack2(gv[0][0], gv[1][0]);
      *reinterpret_cast<uint32_t*>(al + ks * 2048 + 256) = pack2(gv[0][1], gv[1][1]);
      *reinterpret_cast<uint32_t*>(al + ks * 2048 + 128) = pack2(gv[2][0], gv[3][0]);
      *reinterpret_cast<uint32_t*>(al + ks * 2048 + 384) = pack2(gv[2][1], gv[3][1]);
    }
    // the copied B tiles and the A tile just written, for wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's tile
    wgmma_fence();
    const uint64_t da = da0 + (uint64_t)(abuf * KS * 2048 / 16);
    const uint64_t db = db0 + (uint64_t)(cur * S::kBytes / 16);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n168k16(acc, da + ks * (2048 / 16), db + ks * (S::kTile / 16));
    wgmma_commit();
    wgmma_wait<kInFlight>();
    if (m >= kInFlight && wq == 0 && lane == 0) mbar_arrive(empty + (m - kInFlight) % kStages);
    cur = cur + 1 == kStages ? 0 : cur + 1;
    phase ^= cur == 0;
    fill = fill + 1 == kStages ? 0 : fill + 1;
    abuf = abuf == kInFlight ? 0 : abuf + 1;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (n >= N) return;

  // accumulator i: row g0 + gid + 8*((i/2)%2), tangent t0 + 8*(i/4) + 2tid + i%2
  const int t0 = tg * kNT;
  float* o = out + ((size_t)b * N + n) * F + g0 + gid;
  const size_t t_stride = (size_t)B * N * F;
#pragma unroll
  for (int i = 0; i < 84; ++i) {
    const int t = t0 + 8 * (i >> 2) + 2 * tid + (i & 1);
    if (t < T) o[t * t_stride + 8 * ((i >> 1) & 1)] = acc[i];
  }
}

template <int F>
int launch_tc(const float* sp1, const float* sp2, const float* attm, const float* satq,
              const float* mpre, const float* w2, const float* bv, void* panel, float* out,
              int T, int B, int N, cudaStream_t s) {
  const int Tp = (T + kNT - 1) / kNT * kNT;
  const size_t total = (size_t)B * (N * F / 16) * (Tp / 8) * 16;
  const size_t want = (total + 255) / 256;
  const int pack_blocks = (int)(want < 132 * 32 ? want : 132 * 32);  // grid-stride beyond
  pack_panel_kernel<<<pack_blocks, 256, 0, s>>>(bv, static_cast<uint4*>(panel), T, B, N, F, Tp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int bytes = Stage<F>::kSmem;
  err = (int)cudaFuncSetAttribute(g_op_tc_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes);
  if (err) return err;
  const int n_rb = (N + Stage<F>::kR - 1) / Stage<F>::kR;
  const dim3 grid(n_rb * (Tp / kNT), B);
  g_op_tc_kernel<F><<<grid, kTcThreads, bytes, s>>>(
      sp1, sp2, attm, satq, mpre, w2, static_cast<const uint4*>(panel), out, T, B, N, Tp);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 elements of the panel scratch pita_g_op_contract needs.
extern "C" long long pita_g_op_panel_elems(int T, int B, int N, int F) {
  return (long long)B * N * F * ((T + kNT - 1) / kNT * kNT);
}

// sp1, sp2, satq, mpre: (B, N, N, F); attm: (B, N, N); w2: (F, F);
// bv: (T, B, N, F) -> out (T, B, N, F). All f32, contiguous, 16-byte aligned.
// panel: scratch of pita_g_op_panel_elems(T, B, N, F) bf16, 16-byte aligned.
// N <= 64 and F in {16, 32}, else cudaErrorInvalidValue.
extern "C" int pita_g_op_contract(const float* sp1, const float* sp2, const float* attm,
                                  const float* satq, const float* mpre, const float* w2,
                                  const float* bv, void* panel, float* out, int T, int B, int N,
                                  int F, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (B > 65535 || N < 1 || N > kTcMaxN) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16: return launch_tc<16>(sp1, sp2, attm, satq, mpre, w2, bv, panel, out, T, B, N, s);
    case 32: return launch_tc<32>(sp1, sp2, attm, satq, mpre, w2, bv, panel, out, T, B, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The scalar kernel (the first version, kept as a yardstick): one block per
// (chain, tile of 16 tangents); the tile of the tangent panel as f32 rounded
// to bf16 in shared memory (110 KB at N*F = 1760); a warp takes receiver n,
// lane g the output feature g, and builds G[m,f,g] in a register for 16 FMAs
// against broadcast loads of the panel. Bound by the f32 FMAs (3.9 ms at 67
// TFLOP/s at the main path's launch).

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;            // tangents per block
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

size_t smem_floats(int N, int F) {
  return (size_t)N * F * kTile + (size_t)kWarps * 2 * F;
}

template <int F>
__global__ void __launch_bounds__(kThreads, 2)
g_op_kernel(const float* __restrict__ sp1, const float* __restrict__ sp2,
            const float* __restrict__ attm, const float* __restrict__ satq,
            const float* __restrict__ mpre, const float* __restrict__ w2,
            const float* __restrict__ bv, float* __restrict__ out, int T, int B,
            int N) {
  static_assert(F % 4 == 0 && F <= 32, "F must be a multiple of 4, at most 32");
  extern __shared__ float4 smem4[];
  float* panel = reinterpret_cast<float*>(smem4);  // [(m*F + f) * kTile + tt]
  float* stage = panel + (size_t)N * F * kTile;    // per warp: sp1[F], satq[F]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int nt = min(kTile, T - t0);
  const int NF = N * F;

  // the tile of the tangent panel, rounded to bf16; a tangent past T is 0
  for (int tt = 0; tt < kTile; ++tt) {
    const float* src = bv + ((size_t)(t0 + tt) * B + b) * NF;
    for (int k = tid; k < NF; k += kThreads)
      panel[k * kTile + tt] = tt < nt ? rnd_bf16(src[k]) : 0.f;
  }

  // lane g keeps column g of W2 (lanes past F copy column 0 and never write)
  const int g = lane < F ? lane : 0;
  float w2c[F];
#pragma unroll
  for (int f = 0; f < F; ++f) w2c[f] = w2[f * F + g];
  __syncthreads();

  float* st = stage + warp * 2 * F;
  for (int n = warp; n < N; n += kWarps) {
    const size_t row = ((size_t)b * N + n) * N;  // edge (b, n, 0)
    float acc[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) acc[tt] = 0.f;
    for (int m = 0; m < N; ++m) {
      const size_t e = (row + m) * F;
      const float a_g = attm[row + m] * sp2[e + g];
      const float mp_g = mpre[e + g];
      __syncwarp();  // the previous sender's reads of the stage are done
      if (lane < F) {
        st[lane] = sp1[e + lane];
        st[F + lane] = satq[e + lane];
      }
      __syncwarp();
      const float4* pm = reinterpret_cast<const float4*>(panel + (size_t)m * F * kTile);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float gv = rnd_bf16(a_g * (st[f] * w2c[f]) + st[F + f] * mp_g);
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          const float4 v = pm[f * (kTile / 4) + q];
          acc[4 * q + 0] += gv * v.x;
          acc[4 * q + 1] += gv * v.y;
          acc[4 * q + 2] += gv * v.z;
          acc[4 * q + 3] += gv * v.w;
        }
      }
    }
    if (lane < F) {
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt)
        if (tt < nt) out[(((size_t)(t0 + tt) * B + b) * N + n) * F + lane] = acc[tt];
    }
  }
}

template <int F>
int launch(const float* sp1, const float* sp2, const float* attm, const float* satq,
           const float* mpre, const float* w2, const float* bv, float* out, int T,
           int B, int N, cudaStream_t s) {
  const size_t bytes = smem_floats(N, F) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(
      g_op_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  const dim3 grid((T + kTile - 1) / kTile, B);
  g_op_kernel<F><<<grid, kThreads, bytes, s>>>(sp1, sp2, attm, satq, mpre, w2, bv, out,
                                               T, B, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes one block needs (0 if F is not supported).
extern "C" long long pita_g_op_scalar_smem_bytes(int N, int F) {
  if (F != 16 && F != 32) return 0;
  return (long long)(smem_floats(N, F) * sizeof(float));
}

// sp1, sp2, satq, mpre: (B, N, N, F); attm: (B, N, N); w2: (F, F);
// bv: (T, B, N, F) -> out (T, B, N, F). All f32, contiguous.
extern "C" int pita_g_op_contract_scalar(const float* sp1, const float* sp2, const float* attm,
                                         const float* satq, const float* mpre,
                                         const float* w2, const float* bv, float* out, int T,
                                         int B, int N, int F, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 16: return launch<16>(sp1, sp2, attm, satq, mpre, w2, bv, out, T, B, N, s);
    case 32: return launch<32>(sp1, sp2, attm, satq, mpre, w2, bv, out, T, B, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
