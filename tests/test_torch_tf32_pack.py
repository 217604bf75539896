"""The host side of the f32 tensor-core kernels (3xTF32): the weight packer's
split and fragment layout, and the rule that routes f32 launches to them.

The layout is read back here by the formula of ``csrc/mma_tf32.cuh``, written
out independently of the packer: for matrix M (K x NO) at float offset
``off``, n-tile nt, k-step ks and lane = 4 g + t, the float4 at
``off + 4 * ((nt * K/8 + ks) * 32 + lane)`` holds hi M[k][n], hi M[k+1][n],
lo M[k][n], lo M[k+1][n] with k = 8 ks + 2 t and n = 8 nt + g.
"""

import numpy as np
import pytest
import torch

from pita_torch.ops import egnn_layer as el
from torch_threads import one_intra_op_thread  # noqa: F401

def _weights(F, seed):
    rng = np.random.default_rng(seed)
    shapes = dict(w_src=(F, F), b_src=(F,), w_dst=(F, F), w_scal=(2, F), w_e2=(F, F),
                  b_e2=(F,), w_att=(F, 1), b_att=(1,), w_c1=(F, F), b_c1=(F,), w_c2=(F, 1),
                  w_n1=(2 * F, F), b_n1=(F,), w_n2=(F, F), b_n2=(F,))
    # entries over several binades, as trained weights have
    return {k: torch.as_tensor((rng.normal(size=s) * np.exp(rng.normal(size=s))
                                / np.sqrt(s[0])).astype(np.float32))
            for k, s in shapes.items()}


def _expected(w):
    """The ten right operands M of csrc/mma_tf32.cuh:tfoff, in its order: the
    six of the forward and the tangent, then the VJP's transposes."""
    return dict(e2=w["w_e2"], c1=w["w_c1"], c1t=w["w_c1"].T,
                sd=torch.cat([w["w_src"], w["w_dst"]], 1), n1=w["w_n1"], n2=w["w_n2"],
                e2t=w["w_e2"].T, n2t=w["w_n2"].T, n1t=w["w_n1"].T,
                sdt=torch.cat([w["w_src"].T, w["w_dst"].T], 0))


def _unpack(buf, F):
    """(hi, lo) of each matrix, read by the layout formula."""
    buf = buf.numpy()
    out, off = {}, 0
    for name, (K, NO) in (("e2", (F, F)), ("c1", (F, F)), ("c1t", (F, F)), ("sd", (F, 2 * F)),
                          ("n1", (2 * F, F)), ("n2", (F, F)), ("e2t", (F, F)), ("n2t", (F, F)),
                          ("n1t", (F, 2 * F)), ("sdt", (2 * F, F))):
        hi, lo = np.zeros((K, NO), np.float32), np.zeros((K, NO), np.float32)
        for nt in range(NO // 8):
            for ks in range(K // 8):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    k, n = 8 * ks + 2 * t, 8 * nt + g
                    q = off + 4 * ((nt * (K // 8) + ks) * 32 + lane)
                    hi[k, n], hi[k + 1, n], lo[k, n], lo[k + 1, n] = buf[q:q + 4]
        out[name] = (hi, lo)
        off += 2 * K * NO
    # tfoff(F).total: the six matrices of K2 and K4 (16 F^2), K3's four (12 F^2)
    assert off == buf.size == 28 * F * F
    return out


@pytest.mark.parametrize("F,seed", [(16, 1), (32, 2), (32, 3)])
def test_pack_weights_tf32_layout_and_split(F, seed):
    """hi and lo are exact TF32 values; hi + lo gives back each matrix to
    within 2^-21 of its largest entry; the fragment layout unpacks to W."""
    w = _weights(F, seed)
    got = _unpack(el.pack_weights_tf32(w), F)
    for name, m in _expected(w).items():
        m = m.numpy()
        hi, lo = got[name]
        for part in (hi, lo):
            assert not (part.view(np.uint32) & 0x1FFF).any(), name
        # hi is m rounded to 10 mantissa bits: within half a TF32 ulp
        assert np.all(np.abs(hi - m) <= np.abs(m) * 2.0 ** -11), name
        err = np.abs(hi.astype(np.float64) + lo - m).max()
        assert err <= 2.0 ** -21 * np.abs(m).max(), (name, err)


def test_tf32_split_of_special_values():
    a = torch.tensor([0.0, -0.0, 1.0, -1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12, -3.0e-30,
                      6.5e4, 2 ** -126])
    hi, lo = el.tf32_split(a)
    assert torch.equal(hi[:4], a[:4]) and not lo[:4].any()
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - a.double()).abs()
            <= a.double().abs() * 2.0 ** -21).all()
    # a tie rounds away from zero
    assert hi[4] == 1 + 2 ** -10 and hi[5] == 1 + 2 ** -10


@pytest.mark.parametrize("N,F,takes", [
    (13, 32, True), (55, 32, True), (64, 16, True), (1, 16, True),  # the lj13 and lj55 presets
    (65, 32, False), (100, 16, False),  # more than four 16-node tiles: the scalar kernels
    (13, 24, False), (55, 64, False),  # widths the kernels have no instance for
])
def test_tf32_routing_rule(N, F, takes):
    assert el.tf32_takes(N, F) is takes


def test_egcl_packed_tc_follows_the_compute_dtype():
    """The layer's tensor-core buffer: bf16 matrices for a bf16 layer, TF32
    hi + lo fragments for an f32 one."""
    from pita_torch.nets.egnn import EGCL

    for cd, want in ((torch.float32, el.pack_weights_tf32),
                     (torch.bfloat16, el.pack_weights_tc)):
        layer = EGCL(16, compute_dtype=cd)
        for name, v in _weights(16, 4).items():
            getattr(layer, name).data.copy_(v)
        got = layer.packed("cpu", tc=True)
        assert got.dtype == want(layer.weights()).dtype
        assert torch.equal(got, want(layer.weights()))
