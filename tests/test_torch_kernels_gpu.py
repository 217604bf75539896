"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card and nvcc; every test skips without a card. This file
imports neither JAX nor pita_tpu, so on a machine without them it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from pita_torch.io.bench_asset import BENCH_ASSET
from pita_torch.io.flax_params import load_egnn_params
from pita_torch.nets import EGNNBackbone
from pita_torch.ops import egnn_layer as el
from pita_torch.ops import egnn_tangent as et
from pita_torch.ops import g_op
from pita_torch.ops import lj as ljop
from pita_torch.targets import LennardJones

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lattice(n, B, scale, seed):
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = grid[:n][None] * 1.1 + scale * rng.normal(size=(B, n, 3))
    return x.reshape(B, n * 3).astype(np.float32)


@pytest.mark.parametrize("n,smooth", [(13, False), (55, True)])
def test_lj_kernel_matches_plain(cuda, n, smooth):
    x = torch.as_tensor(_lattice(n, 300, 0.3, seed=3), device=cuda)
    t = LennardJones(n, smooth=smooth, temperature=1.7)
    kw = dict(eps=t.eps, rm=t.rm, oscillator_scale=t._osc, energy_factor=t.energy_factor,
              temperature=t.temperature, spline=t.spline)
    before = ljop.lj_log_prob_and_force.launches
    lp_k, f_k = ljop.lj_log_prob_and_force(x, n, **kw)
    assert ljop.lj_log_prob_and_force.launches == before + 1
    lp_p, f_p = ljop.lj_log_prob_and_force_plain(x, n, **kw)
    torch.cuda.synchronize()
    # f32 sums in another order; closed-form vs autograd force
    assert (lp_k - lp_p).abs().max() <= 1e-5 * lp_p.abs().max()
    assert (f_k - f_p).abs().max() <= 1e-5 * f_p.abs().max()


def _bench_layer(device):
    bb = EGNNBackbone(55, hidden_nf=32, n_layers=3)
    bb.load_state_dict(load_egnn_params(np.load(BENCH_ASSET)["energy_params"], 3))
    return {f: v.to(device) for f, v in bb.layers[0].weights().items()}


def _random_layer(F, device, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = dict(w_src=(F, F), b_src=(F,), w_dst=(F, F), w_scal=(2, F), w_e2=(F, F),
                  b_e2=(F,), w_att=(F, 1), b_att=(1,), w_c1=(F, F), b_c1=(F,), w_c2=(F, 1),
                  w_n1=(2 * F, F), b_n1=(F,), w_n2=(F, F), b_n2=(F,))
    return {k: (torch.randn(s, generator=g) / s[0] ** 0.5).to(device) for k, s in shapes.items()}


@pytest.mark.parametrize("F,N,cd,tol", [
    (32, 55, torch.float32, 1e-4),
    (32, 55, torch.bfloat16, 3e-2),
    (16, 13, torch.float32, 1e-4),
    (16, 40, torch.bfloat16, 3e-2),
])
def test_egcl_kernels_match_plain(cuda, F, N, cd, tol):
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(64, N, 3, generator=g, device=cuda) * 0.5
    h = torch.randn(64, N, F, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    gh, gx = torch.randn_like(h), torch.randn_like(x)
    for attention, tanh in ((True, True), (False, False)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=cd)
        before = (el.egnn_layer_forward.launches, el.egnn_layer_backward.launches)
        got = (*el.egnn_layer_forward(h, x, ea, w, **cfg),
               *el.egnn_layer_backward(h, x, ea, gh, gx, w, **cfg))
        assert (el.egnn_layer_forward.launches, el.egnn_layer_backward.launches) == (
            before[0] + 1, before[1] + 1)
        with torch.no_grad():
            ref = (*el.layer_step(h, x, ea, w, **cfg),
                   *el.layer_vjp(h, x, ea, gh, gx, w, **cfg))
        torch.cuda.synchronize()
        # f32: sums reassociated; bf16: now and then a neighbouring bf16 rounding
        for a, b in zip(got, ref):
            assert (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.parametrize("N,F,T,B,integer", [
    (55, 32, 165, 8, False),  # LJ55: 11 tiles of 16 tangents, the last one of 5
    (13, 16, 39, 5, False),
    (7, 32, 21, 3, True),  # near-integer inputs are exact in bf16: indexing only
])
def test_g_op_kernel_matches_plain(cuda, N, F, T, B, integer):
    g = torch.Generator(device=cuda).manual_seed(N)
    rand = lambda *s: torch.rand(s, generator=g, device=cuda)
    randn = lambda *s: torch.randn(s, generator=g, device=cuda)
    if integer:
        draw = lambda *s: torch.round(randn(*s) * 2)
        sp1, sp2, att = draw(B, N, N, F), draw(B, N, N, F), draw(B, N, N)
        satq, m_pre, w2, bv = draw(B, N, N, F), draw(B, N, N, F), draw(F, F), draw(T, B, N, F)
    else:
        sp1, sp2, att = rand(B, N, N, F), rand(B, N, N, F), rand(B, N, N)
        satq, m_pre = randn(B, N, N, F) * 0.1, randn(B, N, N, F)
        w2, bv = randn(F, F) / F ** 0.5, randn(T, B, N, F) * 0.5
    mask = 1.0 - torch.eye(N, device=cuda)
    args = (sp1, sp2, att * mask, satq * mask[:, :, None], m_pre, w2, bv)
    before = g_op.g_operator_contract.launches
    got = g_op.g_operator_contract(*args)
    assert g_op.g_operator_contract.launches == before + 1
    ref = g_op.g_operator_contract_plain(*args)
    torch.cuda.synchronize()
    if integer:
        assert torch.equal(got, ref)
    else:
        # the same bf16 roundings of G and bv up to an f32 ulp before rounding; f32 sums
        # over N*F terms in another order
        assert (got - ref).abs().max() <= 2e-3 * ref.abs().max()


@pytest.mark.parametrize("F,N,Tc,tc,cd,tol", [
    (32, 55, 20, 8, torch.float32, 2e-4),  # ragged: blocks of 8, 8 and 4 tangents
    (32, 55, 20, 8, torch.bfloat16, 3e-2),
    (16, 13, 39, 16, torch.float32, 2e-4),
    (16, 40, 7, 1, torch.bfloat16, 3e-2),
])
def test_egcl_tangent_kernel_matches_plain(cuda, F, N, Tc, tc, cd, tol):
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    g = torch.Generator(device=cuda).manual_seed(N + 1)
    B = 6
    randn = lambda *s: torch.randn(s, generator=g, device=cuda)
    xs0 = randn(B, N, 3) * 0.5
    x = xs0 + 0.1 * randn(B, N, 3)
    h = randn(B, N, F)
    ea = ((xs0[:, :, None] - xs0[:, None]) ** 2).sum(-1)
    basis = torch.eye(3 * N, device=cuda)[torch.randperm(3 * N, generator=g, device=cuda)[:Tc]]
    basis = basis.reshape(Tc, N, 3)
    dh, dx = randn(B, Tc, N, F), randn(B, Tc, N, 3)
    for attention, tanh in ((True, True), (False, False)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=cd)
        before = et.egnn_layer_tangent.launches
        got = et.egnn_layer_tangent(h, x, ea, xs0, basis, dh, dx, w, tangent_chunk=tc, **cfg)
        assert et.egnn_layer_tangent.launches == before + 1
        with torch.no_grad():
            ref = et.layer_tangent(h, x, ea, xs0, basis, dh, dx, w, **cfg)
        torch.cuda.synchronize()
        # f32: sums reassociated; bf16: now and then a neighbouring bf16 rounding
        for a, b in zip(got, ref):
            assert (a - b).abs().max() <= tol * b.abs().max()


def test_trace_routes_agree_on_the_card(cuda, monkeypatch):
    """The three routes of the exact trace on a small f32 model: materialized
    G, kernel K5 (bf16 G) and kernel K4 (forward mode). The G-operator term
    is a small part of the trace, so its size is measured (the trace with the
    term dropped) and K5's route held to a twentieth of it."""
    from pita_torch.nets.egnn_fast import egnn_jacobian_trace

    bb = EGNNBackbone(13, hidden_nf=16, n_layers=3)
    g = torch.Generator().manual_seed(7)
    for name, p in bb.named_parameters():
        scale = 0.1 if p.dim() == 1 else 0.01 if name.endswith("w_c2") else p.shape[0] ** -0.5
        p.data = torch.randn(p.shape, generator=g) * scale
    bb = bb.to(cuda)
    t = torch.rand(5, generator=g).to(cuda)
    x = (torch.randn(5, 39, generator=g) * 0.5).to(cuda)
    _, tr_m = egnn_jacobian_trace(bb, t, x, 1.0)
    _, tr_g = egnn_jacobian_trace(bb, t, x, 1.0, g_kernel=True, tangent_chunk=20)
    tr_f = et.egnn_jacobian_trace_fused(bb, t, x, 1.0, tangent_chunk=4, super_chunk=16)
    monkeypatch.setattr(g_op, "g_operator_contract", lambda *a: torch.zeros_like(a[-1]))
    _, tr_0 = egnn_jacobian_trace(bb, t, x, 1.0, g_kernel=True)
    torch.cuda.synchronize()
    top = tr_m.abs().max()
    share = (tr_0 - tr_m).abs().max() / top
    assert share >= 1e-4  # else the comparison below could not see a wrong K5
    assert (tr_g - tr_m).abs().max() <= share / 20 * top  # bf16 G and Bv: ~1e-3 of the term
    assert (tr_f - tr_m).abs().max() <= 1e-4 * top  # f32 both


def test_exact_generic_divergence_on_the_card(cuda):
    """The generic exact divergence (D reverse-mode rows, each through the
    EGCL VJP kernel K3) against the edge-operator trace, f32."""
    from pita_torch.nets.egnn_fast import egnn_jacobian_trace
    from pita_torch.ops.divergence import exact_divergence

    bb = EGNNBackbone(13, hidden_nf=16, n_layers=2)
    g = torch.Generator().manual_seed(8)
    for p in bb.parameters():
        p.data = torch.randn(p.shape, generator=g) * (0.1 if p.dim() == 1 else p.shape[0] ** -0.5)
    bb = bb.to(cuda)
    t = torch.rand(4, generator=g).to(cuda)
    x = (torch.randn(4, 39, generator=g) * 0.5).to(cuda)
    before = el.egnn_layer_backward.launches
    tr_rev = exact_divergence(lambda tq, xq: bb(tq, xq, 1.0), t, x, row_chunk=16)
    assert el.egnn_layer_backward.launches == before + 2 * 3  # 2 layers x 3 chunks of rows
    _, tr_op = egnn_jacobian_trace(bb, t, x, 1.0)
    torch.cuda.synchronize()
    assert (tr_rev - tr_op).abs().max() <= 1e-4 * tr_op.abs().max()
