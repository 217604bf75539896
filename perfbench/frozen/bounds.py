"""Peaks of one H100 SXM and the least times of the EGCL kernels.

Frozen copy of ``chip_smoke.py`` at commit dfb8e7f (lines 195-207, 247-275,
309-346, 595-604, 650-660, 878-904): ``bound_ms``, ``egcl_bound``,
``lj_bound``, ``tangent_fp32_ops`` and ``k4_f32_bound``, without their
printing. The benchmark's roofline and mfu readers take their yardstick from
here and from nothing in the program, so a later change cannot move it.
"""

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
# an f32 product in 3xTF32 is three TF32 products (hi hi, hi lo, lo hi)
PEAK_3XTF32 = PEAK_TF32 / 3
# special-function units: 16 results per clock per SM, 132 SMs, 1.98 GHz
PEAK_SFU = 132 * 16 * 1.98e9
# FP32 pipes: 128 lanes per SM, one operation (an FMA counts as one) a clock
PEAK_FP32_OPS = 132 * 128 * 1.98e9

# K1's f32 instructions (chip_smoke.py:309-312)
LJ_F32_PER_PAIR = 19
LJ_F32_SPLINE_SELECT = 3
LJ_F32_PER_CLOSE_PAIR = 8
LJ_F32_PER_PARTICLE = 15


def bound_ms(n_bytes, n_ops, peak_ops, sfu_ops=0, fp32_ops=0):
    """The least time (ms) and what sets it: bytes over the memory rate, or
    operations over their peak, the SFU operations and the elementwise f32
    operations over theirs."""
    t_b = n_bytes / PEAK_BYTES * 1e3
    t_o = max(n_ops / peak_ops, sfu_ops / PEAK_SFU, fp32_ops / PEAK_FP32_OPS) * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def egcl_bound(n_bytes, n_ops, peak_ops, n_edges, F):
    """bound_ms of an EGCL kernel: sigma(z1), sigma(z2), sigma(cz) (F each),
    the attention sigmoid and a tanh per edge, one SFU operation each."""
    return bound_ms(n_bytes, n_ops, peak_ops, (3 * F + 2) * n_edges)


def packed_numel(F):
    """Floats of the scalar kernels' packed weight buffer (15 arrays, each
    padded to a multiple of 4; csrc/egnn_common.cuh)."""
    sizes = (F * F, F, F * F, 2 * F, F * F, F, F, 1, F * F, F, F, 2 * F * F, F, F * F, F)
    return sum(s + (-s) % 4 for s in sizes)


def k2_bound(B, N, F, peak_ops):
    """K2 (the EGCL forward) at B chains: h, x and edge_attr read, h and x
    written, the weights read; edge and node products; the SFU terms
    (chip_smoke.py:526-538, 595-604)."""
    E = B * N * (N - 1)
    io = 4 * (2 * B * N * F + 2 * B * N * 3 + B * N * N) + 4 * packed_numel(F)
    return egcl_bound(io, E * 4 * F * F + B * N * 10 * F * F, peak_ops, E, F)


def k3_bound(B, N, F, peak_ops):
    """K3 (the EGCL VJP) at B chains: h, x, edge_attr, gh and gx read, dh,
    dx and dea written; the forward's two edge products and their
    transposes, the node products and theirs (chip_smoke.py:526-534, 650-660)."""
    E = B * N * (N - 1)
    io = 4 * (3 * B * N * F + 3 * B * N * 3 + 2 * B * N * N) + 4 * packed_numel(F)
    return egcl_bound(io, E * 8 * F * F + 2 * B * N * 10 * F * F, peak_ops, E, F)


def tangent_fp32_ops(n_edge_tangents, F):
    """The f32 operations of the tangent map around its products
    (chip_smoke.py:878-887)."""
    return n_edge_tangents * (9 * F + 23)


def k4_f32_bound(B, Tc, N, F, n_weights=None):
    """The f32 K4's bound for B chains x Tc tangents (chip_smoke.py:890-904)."""
    n_weights = packed_numel(F) if n_weights is None else n_weights
    E = B * N * (N - 1)
    ops = Tc * E * 2 * F * F + E * 6 * F * F + (Tc + 1) * B * N * 10 * F * F
    ew, sfu = tangent_fp32_ops(Tc * E, F), (3 * F + 2) * E
    n_bytes = 4 * (2 * B * Tc * N * (F + 3) + B * N * (F + 6) + B * N * N + Tc * N * 3
                   + n_weights)
    return bound_ms(n_bytes, ops, PEAK_3XTF32, sfu_ops=sfu, fp32_ops=ew)


def k4_f32_ops(B, Tc, N, F):
    """The products of ``k4_f32_bound`` (operations, two a multiply-add)."""
    E = B * N * (N - 1)
    return Tc * E * 2 * F * F + E * 6 * F * F + (Tc + 1) * B * N * 10 * F * F


def lj_bound(B, N, pairs_below_rmin=0, spline=True):
    """K1's bound at B configurations of N particles: bytes, f32
    instructions and SFU operations (chip_smoke.py:321-346)."""
    pairs = B * N * (N - 1) // 2
    f32 = LJ_F32_PER_PAIR * pairs + LJ_F32_PER_PARTICLE * B * N
    sfu = pairs
    if spline:
        f32 += LJ_F32_SPLINE_SELECT * pairs + LJ_F32_PER_CLOSE_PAIR * pairs_below_rmin
        sfu += pairs_below_rmin
    n_bytes = 4 * (2 * B * N * 3 + B)
    return bound_ms(n_bytes, 0, PEAK_F32, sfu, f32)


def egcl_forward_macs(N, F):
    """Multiply-adds of one EGCL layer's forward for one chain: the source
    and destination node products, the node MLP (2F x F and F x F), and per
    edge the edge MLP's F x F product, the attention dot, the coordinate
    MLP's F x F product and its output dot, and the two scalar features."""
    E = N * (N - 1)
    return E * (2 * F * F + 4 * F) + 5 * N * F * F
