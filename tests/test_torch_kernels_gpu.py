"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card and nvcc; every test skips without a card. This file
imports neither JAX nor pita_tpu, so on a machine without them it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import ctypes

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
from torch_threads import one_intra_op_thread  # noqa: F401

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


def _lj_inputs(n, B, seed, device, close=True):
    """Jittered lattices; with ``close`` every other configuration has
    particle 1 at r = 0.5 from particle 0, below the spline's r_min."""
    x = _lattice(n, B, 0.15, seed).reshape(B, n, 3)
    if close:
        x[::2, 1] = x[::2, 0] + np.array([0.5, 0.0, 0.0], dtype=np.float32)
    return torch.as_tensor(x.reshape(B, n * 3), device=device)


def _lj_kw(t):
    return dict(eps=t.eps, rm=t.rm, oscillator_scale=t._osc, energy_factor=t.energy_factor,
                temperature=t.temperature, spline=t.spline)


def _lj_close(k, p, tol=1e-5):
    # f32 sums in another order, an approximate reciprocal (~7e-7 in r^-12);
    # closed-form vs autograd force
    return all((a - b).abs().max() <= tol * b.abs().max() for a, b in zip(k, p))


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("n", [13, 55])
@pytest.mark.parametrize("B", [1, 7, 300, 2048])
def test_lj_pairs_kernel_matches_plain(cuda, B, n, smooth):
    """The new K1 at every geometry the wrapper picks for these (N, B), the
    spline's branch taken in every other configuration."""
    x = _lj_inputs(n, B, seed=B + n, device=cuda)
    kw = _lj_kw(LennardJones(n, smooth=smooth, temperature=1.3))
    before = (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches)
    got = ljop.lj_log_prob_and_force(x, n, **kw)
    assert (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches) == (
        before[0] + 1, before[1])
    ref = ljop.lj_log_prob_and_force_plain(x, n, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (B,) and got[1].shape == (B, 3 * n)
    assert _lj_close(got, ref)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [2, 13, 55])
def test_lj_pairs_kernel_every_lane_count(cuda, monkeypatch, n, lanes):
    """Each lane count the kernel takes, whatever the wrapper would pick, on
    target constants that are not 1 (the folded rm, eps and factors)."""
    monkeypatch.setattr(ljop, "lanes_per_particle", lambda n_, b_, sms: lanes)
    x = _lj_inputs(n, 9, seed=lanes, device=cuda)
    t = LennardJones(n, smooth=True, rm=1.2, eps=0.7, energy_factor=0.5,
                     oscillator_scale=2.0, temperature=1.3)
    got = ljop.lj_log_prob_and_force(x, n, **_lj_kw(t))
    ref = ljop.lj_log_prob_and_force_plain(x, n, **_lj_kw(t))
    torch.cuda.synchronize()
    assert _lj_close(got, ref)


def test_lj_pairs_kernel_is_deterministic(cuda):
    """Every sum runs in a fixed order, no atomics: two launches on the same
    input are bitwise equal."""
    x = _lj_inputs(55, 300, seed=4, device=cuda)
    kw = _lj_kw(LennardJones(55, smooth=True))
    got, again = ljop.lj_log_prob_and_force(x, 55, **kw), ljop.lj_log_prob_and_force(x, 55, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n,smooth,B", [(55, True, 300), (13, False, 7)])
def test_lj_scalar_kernel_matches_plain(cuda, n, smooth, B):
    """The first K1, kept as the yardstick, still computes the function."""
    x = _lj_inputs(n, B, seed=5, device=cuda)
    kw = _lj_kw(LennardJones(n, smooth=smooth, temperature=1.7))
    before = (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches)
    got = ljop._lj_scalar(x, n, **kw)
    assert (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches) == (
        before[0], before[1] + 1)
    ref = ljop.lj_log_prob_and_force_plain(x, n, **kw)
    torch.cuda.synchronize()
    assert _lj_close(got, ref)


def test_lj_pairs_kernel_refuses_what_it_cannot_take(cuda):
    n = ljop.MAX_N + 1
    x = torch.randn(2, 3 * n, device=cuda)
    before = ljop.lj_log_prob_and_force.launches
    with pytest.raises(ValueError, match=f"N <= {ljop.MAX_N}"):
        ljop.lj_log_prob_and_force(x, n)
    with pytest.raises(ValueError, match="rm > 0"):
        ljop.lj_log_prob_and_force(x[:, :39], 13, rm=0.0)
    assert ljop.lj_log_prob_and_force.launches == before


def test_lj_limits_match_the_kernel(cuda):
    """The limits and the packed layout the wrapper uses are the kernel's."""
    lib = ljop._lib()
    assert lib.pita_lj_max_n() == ljop.MAX_N
    assert lib.pita_lj_max_group() == ljop.MAX_GROUP
    assert lib.pita_lj_params_bytes() == ctypes.sizeof(ljop._LJParams)


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


@pytest.mark.parametrize("F,N,cd,tol,B", [
    (32, 55, torch.float32, 1e-4, 64),
    (32, 55, torch.bfloat16, 3e-2, 64),
    (16, 13, torch.float32, 1e-4, 64),
    (16, 40, torch.bfloat16, 3e-2, 64),
    # bf16 only (the tensor-core K2 and K3): their largest N (4 full tiles),
    # one ragged tile at F=32, and the Hutchinson launch's 4096 chains
    (32, 64, torch.bfloat16, 3e-2, 64),
    (32, 13, torch.bfloat16, 3e-2, 64),
    (32, 55, torch.bfloat16, 3e-2, 4096),
])
def test_egcl_kernels_match_plain(cuda, F, N, cd, tol, B):
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(B, N, 3, generator=g, device=cuda) * 0.5
    h = torch.randn(B, N, F, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    gh, gx = torch.randn_like(h), torch.randn_like(x)
    # bf16 runs the tensor-core K2 and K3, f32 the 3xTF32 K2 and K3; the
    # scalar ones never at these shapes
    tc = cd == torch.bfloat16
    for attention, tanh in ((True, True), (False, False)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=cd)
        counts = lambda: (el.egnn_layer_forward.launches, el.egnn_layer_forward_tc.launches,
                          el.egnn_layer_forward_tf32.launches, el.egnn_layer_backward.launches,
                          el.egnn_layer_backward_tc.launches, el.egnn_layer_backward_tf32.launches)
        before = counts()
        # the bf16 K2 hands its aggregate to the bf16 K3
        h_out, x_out, *agg = el.egnn_layer_forward(h, x, ea, w, with_agg=tc, **cfg)
        got = (h_out, x_out, *el.egnn_layer_backward(h, x, ea, gh, gx, w,
                                                     agg=agg[0] if tc else None, **cfg))
        assert counts() == (before[0], before[1] + tc, before[2] + (not tc),
                            before[3], before[4] + tc, before[5] + (not tc))
        with torch.no_grad():
            ref = (*el.layer_step(h, x, ea, w, **cfg),
                   *el.layer_vjp(h, x, ea, gh, gx, w, **cfg))
        torch.cuda.synchronize()
        # f32: sums reassociated; bf16: now and then a neighbouring bf16 rounding
        for a, b in zip(got, ref):
            assert (a - b).abs().max() <= tol * b.abs().max()
        # dea is written for every edge, 0 on the diagonal
        assert not got[4].diagonal(dim1=1, dim2=2).any()


@pytest.mark.parametrize("F,N,B", [
    (32, 55, 64), (32, 64, 64), (32, 13, 64), (16, 55, 64), (16, 64, 64), (16, 13, 64),
    (32, 55, 4096),  # the Hutchinson launch
])
def test_egcl_tc_forward_matches_plain(cuda, F, N, B):
    """The tensor-core K2 against layer_step in bf16, on random weights at
    F = 16 and the bench's layer at F = 32; two launches on the same inputs
    are bitwise equal (the sums over senders run in a fixed order)."""
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    g = torch.Generator(device=cuda).manual_seed(N + 2)
    x = torch.randn(B, N, 3, generator=g, device=cuda) * 0.5
    h = torch.randn(B, N, F, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    for attention, tanh in ((True, True), (False, False)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=torch.bfloat16)
        before = el.egnn_layer_forward_tc.launches
        got = el.egnn_layer_forward_tc(h, x, ea, w, **cfg)
        again = el.egnn_layer_forward_tc(h, x, ea, w, **cfg)
        assert el.egnn_layer_forward_tc.launches == before + 2
        with torch.no_grad():
            ref = el.layer_step(h, x, ea, w, **cfg)
        torch.cuda.synchronize()
        for a, a2, b in zip(got, again, ref):
            assert torch.equal(a, a2)
            # now and then a neighbouring bf16 rounding (TOL_BF16 of chip_smoke.py)
            assert (a - b).abs().max() <= 3e-2 * b.abs().max()


@pytest.mark.parametrize("F,N,B", [
    (32, 55, 64), (32, 13, 64), (16, 55, 64), (16, 13, 64),  # the presets' N at both widths
    (32, 64, 64), (16, 40, 7),  # four full receiver tiles; a ragged one
    (32, 55, 2000),  # the DEM refill's launch
])
def test_egcl_tf32_forward_matches_plain(cuda, F, N, B):
    """The 3xTF32 K2 against layer_step in f32 at chip_smoke.py's TOL_F32, on
    random weights at F = 16 and the bench's layer at F = 32, attention and
    tanh on and off; two launches on the same inputs are bitwise equal."""
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    g = torch.Generator(device=cuda).manual_seed(N + 3)
    x = torch.randn(B, N, 3, generator=g, device=cuda) * 0.5
    h = torch.randn(B, N, F, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    for attention, tanh in ((True, True), (False, False), (True, False)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=torch.float32)
        before = (el.egnn_layer_forward.launches, el.egnn_layer_forward_tf32.launches)
        got = el.egnn_layer_forward(h, x, ea, w, **cfg)
        again = el.egnn_layer_forward_tf32(h, x, ea, w, **cfg)
        assert (el.egnn_layer_forward.launches, el.egnn_layer_forward_tf32.launches) == (
            before[0], before[1] + 2)
        with torch.no_grad():
            ref = [torch.cat(p) for p in zip(*(
                el.layer_step(h[s:s + 500], x[s:s + 500], ea[s:s + 500], w, **cfg)
                for s in range(0, B, 500)))]
        torch.cuda.synchronize()
        for a, a2, b in zip(got, again, ref):
            assert torch.equal(a, a2)
            assert (a - b).abs().max() <= 2e-4 * b.abs().max()


def _plain_vjp(h, x, ea, gh, gx, w, cfg, chunk=512):
    """layer_vjp in chunks of chains: its edge tensors are 0.4 GB a tensor
    at 1,024 chains."""
    return [torch.cat(p) for p in zip(*(
        el.layer_vjp(h[s:s + chunk], x[s:s + chunk], ea[s:s + chunk], gh[s:s + chunk],
                     gx[s:s + chunk], w, **cfg) for s in range(0, h.shape[0], chunk)))]


@pytest.mark.parametrize("F,N,B", [
    *((F, N, 64) for F in (32, 16) for N in (55, 64, 13)),  # the presets' N, four full tiles
    (32, 55, 256), (32, 55, 2048),  # the fill's launch, phase 3's
])
def test_egcl_tf32_backward_matches_plain(cuda, F, N, B):
    """The 3xTF32 K3 against layer_vjp in f32 at chip_smoke.py's TOL_F32, on
    random weights at F = 16 and the bench's layer at F = 32, attention and
    tanh on and off; egnn_layer_backward sends f32 there and nowhere else;
    two launches on the same inputs are bitwise equal."""
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    g = torch.Generator(device=cuda).manual_seed(N + 4)
    x = torch.randn(B, N, 3, generator=g, device=cuda) * 0.5
    h = torch.randn(B, N, F, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    gh, gx = torch.randn_like(h), torch.randn_like(x)
    for attention, tanh in ((True, True), (False, False), (True, False)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=torch.float32)
        counts = lambda: (el.egnn_layer_backward.launches, el.egnn_layer_backward_tc.launches,
                          el.egnn_layer_backward_tf32.launches)
        before = counts()
        got = el.egnn_layer_backward(h, x, ea, gh, gx, w, **cfg)
        again = el.egnn_layer_backward_tf32(h, x, ea, gh, gx, w, **cfg)
        assert counts() == (before[0], before[1], before[2] + 2)
        ref = _plain_vjp(h, x, ea, gh, gx, w, cfg)
        torch.cuda.synchronize()
        for a, a2, b in zip(got, again, ref):
            assert torch.equal(a, a2)
            assert (a - b).abs().max() <= 2e-4 * b.abs().max()
        assert not got[2].diagonal(dim1=1, dim2=2).any()


def test_egcl_tf32_backward_is_deterministic(cuda):
    """The sums over receivers and senders run in a fixed order with no
    atomics: three launches at the fill's 256 chains, on inputs far from 0
    (t = 1's spread), are bitwise equal, and equal to the scalar K3 within
    TOL_F32."""
    w = _bench_layer(cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(256, 55, 3, generator=g, device=cuda) * 1.5
    h = torch.randn(256, 55, 32, generator=g, device=cuda) * 3.0
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    gh, gx = torch.randn_like(h), torch.randn_like(x)
    cfg = dict(attention=True, tanh=True, coords_range=5.0, cd=torch.float32)
    runs = [el.egnn_layer_backward_tf32(h, x, ea, gh, gx, w, **cfg) for _ in range(3)]
    before = el.egnn_layer_backward.launches
    scalar = el._backward_scalar(h, x, ea, gh, gx, w, **cfg)
    assert el.egnn_layer_backward.launches == before + 1
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    for a, b in zip(runs[0], scalar):
        assert (a - b).abs().max() <= 2e-4 * b.abs().max()


def test_egcl_tf32_backward_refuses_and_routes_by_shape(cuda):
    """The rule of egnn_layer.tf32_takes for K3: f32 at N > 64 runs the
    scalar K3; the 3xTF32 wrapper itself refuses bf16, N > 64 and F outside
    (16, 32), and launches nothing then."""
    w = _random_layer(16, cuda, seed=2)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(3, 65, 3, generator=g, device=cuda)
    h = torch.randn(3, 65, 16, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    gh, gx = torch.randn_like(h), torch.randn_like(x)
    before = (el.egnn_layer_backward.launches, el.egnn_layer_backward_tf32.launches)
    got = el.egnn_layer_backward(h, x, ea, gh, gx, w)
    assert (el.egnn_layer_backward.launches, el.egnn_layer_backward_tf32.launches) == (
        before[0] + 1, before[1])
    ref = el.layer_vjp(h, x, ea, gh, gx, w)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max() <= 2e-4 * b.abs().max()
    with pytest.raises(ValueError, match="N <= 64"):
        el.egnn_layer_backward_tf32(h, x, ea, gh, gx, w)
    s13 = tuple(t[:, :13].contiguous() for t in (h, x))
    args13 = (*s13, ea[:, :13, :13].contiguous(), gh[:, :13].contiguous(),
              gx[:, :13].contiguous())
    with pytest.raises(ValueError, match="f32 only"):
        el.egnn_layer_backward_tf32(*args13, w, cd=torch.bfloat16)
    w24 = _random_layer(24, cuda, seed=2)
    z = lambda *s: torch.zeros(*s, device=cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        el.egnn_layer_backward_tf32(z(2, 13, 24), z(2, 13, 3), z(2, 13, 13), z(2, 13, 24),
                                    z(2, 13, 3), w24)
    assert el.egnn_layer_backward_tf32.launches == before[1]
    assert el._lib_bwd_tf32().pita_egcl_bwd_tf32_max_n() == el.TF32_MAX_N


def test_egcl_f32_forward_routes_by_shape(cuda):
    """The rule of egnn_layer.tf32_takes: f32 at N > 64 runs the scalar K2;
    the 3xTF32 wrapper itself refuses N > 64, F outside (16, 32) and bf16."""
    w = _random_layer(16, cuda, seed=1)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, 70, 3, generator=g, device=cuda)
    h = torch.randn(3, 70, 16, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    before = (el.egnn_layer_forward.launches, el.egnn_layer_forward_tf32.launches)
    got = el.egnn_layer_forward(h, x, ea, w)
    assert (el.egnn_layer_forward.launches, el.egnn_layer_forward_tf32.launches) == (
        before[0] + 1, before[1])
    with torch.no_grad():
        ref = el.layer_step(h, x, ea, w)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    with pytest.raises(ValueError, match="N <= 64"):
        el.egnn_layer_forward_tf32(h, x, ea, w)
    w24 = _random_layer(24, cuda, seed=1)
    with pytest.raises(ValueError, match="N <= 64"):
        el.egnn_layer_forward_tf32(torch.zeros(2, 13, 24, device=cuda),
                                   torch.zeros(2, 13, 3, device=cuda),
                                   torch.zeros(2, 13, 13, device=cuda), w24)
    with pytest.raises(ValueError, match="f32 only"):
        el.egnn_layer_forward_tf32(h[:, :13].contiguous(), x[:, :13].contiguous(),
                                   ea[:, :13, :13].contiguous(), w, cd=torch.bfloat16)
    assert el.egnn_layer_forward_tf32.launches == before[1]
    assert el._lib_tf32().pita_egcl_tf32_max_n() == el.TF32_MAX_N


def test_egcl_tc_forward_refuses_large_n(cuda):
    w = _random_layer(16, cuda, seed=1)
    h, x = torch.zeros(2, 65, 16, device=cuda), torch.zeros(2, 65, 3, device=cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        el.egnn_layer_forward_tc(h, x, torch.zeros(2, 65, 65, device=cuda), w,
                                 cd=torch.bfloat16)


def test_egcl_tc_backward_refuses_large_n(cuda):
    w = _random_layer(16, cuda, seed=1)
    h, x = torch.zeros(2, 65, 16, device=cuda), torch.zeros(2, 65, 3, device=cuda)
    before = el.egnn_layer_backward_tc.launches
    with pytest.raises(ValueError, match="N <= 64"):
        el.egnn_layer_backward_tc(h, x, torch.zeros(2, 65, 65, device=cuda), h, x, w,
                                  agg=torch.zeros_like(h), cd=torch.bfloat16)
    assert el.egnn_layer_backward_tc.launches == before


@pytest.mark.parametrize("bad", ["missing", "shape", "dtype", "device"])
def test_egcl_tc_backward_refuses_a_bad_aggregate(cuda, bad):
    """The tensor-core K3 reads K2's aggregate and never rebuilds it: a
    missing one, or one of another shape, dtype or device, raises before
    any launch."""
    w = _random_layer(32, cuda, seed=3)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 55, 3, generator=g, device=cuda)
    h = torch.randn(4, 55, 32, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    agg = dict(missing=None, shape=torch.zeros(4, 54, 32, device=cuda),
               dtype=torch.zeros(4, 55, 32, device=cuda, dtype=torch.bfloat16),
               device=torch.zeros(4, 55, 32))[bad]
    before = el.egnn_layer_backward_tc.launches
    for f in (el.egnn_layer_backward, el.egnn_layer_backward_tc):
        with pytest.raises(ValueError, match="agg"):
            f(h, x, ea, h, x, w, agg=agg, cd=torch.bfloat16)
    assert el.egnn_layer_backward_tc.launches == before


@pytest.mark.parametrize("F,N,B", [
    (32, 55, 64), (32, 13, 64), (32, 64, 64), (16, 55, 64),
    (32, 55, 4096),  # the Hutchinson launch
])
def test_egcl_tc_forward_aggregate(cuda, F, N, B):
    """The tensor-core K2 asked for its aggregate: h_out and x_out bitwise
    those of K2 without it, and the aggregate (f32, as the kernel summed it)
    within bf16's tolerance of layer_step's sum of the masked messages."""
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    g = torch.Generator(device=cuda).manual_seed(N + 5)
    x = torch.randn(B, N, 3, generator=g, device=cuda) * 0.5
    h = torch.randn(B, N, F, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    for attention, tanh in ((True, True), (False, False)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=torch.bfloat16)
        before = el.egnn_layer_forward_tc.launches
        plain = el.egnn_layer_forward_tc(h, x, ea, w, **cfg)
        h_out, x_out, agg = el.egnn_layer_forward_tc(h, x, ea, w, with_agg=True, **cfg)
        assert el.egnn_layer_forward_tc.launches == before + 2
        ref = torch.cat([el._aggregate(el.layer_step(h[s:s + 512], x[s:s + 512],
                                                     ea[s:s + 512], w, with_acts=True,
                                                     **cfg)[2])
                         for s in range(0, B, 512)])
        torch.cuda.synchronize()
        assert torch.equal(h_out, plain[0]) and torch.equal(x_out, plain[1])
        assert agg.dtype == torch.float32 and agg.shape == h.shape
        assert (agg - ref).abs().max() <= 3e-2 * ref.abs().max()


def _g_op_inputs(device, N, F, T, B, integer=False):
    g = torch.Generator(device=device).manual_seed(N)
    rand = lambda *s: torch.rand(s, generator=g, device=device)
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    if integer:
        draw = lambda *s: torch.round(randn(*s) * 2)
        sp1, sp2, att = draw(B, N, N, F), draw(B, N, N, F), draw(B, N, N)
        satq, m_pre, w2, bv = draw(B, N, N, F), draw(B, N, N, F), draw(F, F), draw(T, B, N, F)
    else:
        sp1, sp2, att = rand(B, N, N, F), rand(B, N, N, F), rand(B, N, N)
        satq, m_pre = randn(B, N, N, F) * 0.1, randn(B, N, N, F)
        w2, bv = randn(F, F) / F ** 0.5, randn(T, B, N, F) * 0.5
    mask = 1.0 - torch.eye(N, device=device)
    return sp1, sp2, att * mask, satq * mask[:, :, None], m_pre, w2, bv


@pytest.mark.parametrize("N,F,T,B,integer", [
    (55, 32, 165, 8, False),  # LJ55's shape: 165 of the 168 tangents a product takes
    (13, 16, 39, 5, False),
    (7, 32, 21, 3, True),  # near-integer inputs are exact in bf16: indexing only
    # the tensor-core kernel's edges: N = 64, a block of receivers only
    # partly inside N (13, 55: its other rows compute and store nothing), one
    # tangent, a ragged tangent count (37), one chain
    (64, 32, 37, 1, False),
    (64, 16, 165, 1, False),
    (13, 32, 1, 8, False),
    (55, 16, 37, 8, False),
    (55, 32, 1, 1, False),
    (13, 16, 165, 8, False),
    (55, 32, 165, 4, True),
    (64, 16, 37, 2, True),
])
def test_g_op_kernel_matches_plain(cuda, N, F, T, B, integer):
    args = _g_op_inputs(cuda, N, F, T, B, integer)
    before = (g_op.g_operator_contract.launches, g_op._contract_scalar.launches)
    got = g_op.g_operator_contract(*args)
    assert (g_op.g_operator_contract.launches, g_op._contract_scalar.launches) == (
        before[0] + 1, before[1])
    ref = g_op.g_operator_contract_plain(*args)
    torch.cuda.synchronize()
    if integer:
        assert torch.equal(got, ref)
    else:
        # the same bf16 roundings of G and bv up to an f32 ulp before rounding; f32 sums
        # over N*F terms in another order
        assert (got - ref).abs().max() <= 2e-3 * ref.abs().max()


def test_g_op_kernel_is_deterministic(cuda):
    """One lane writes each output, the sum over senders runs in a fixed
    order: two launches on the same inputs are bitwise equal."""
    args = _g_op_inputs(cuda, 55, 32, 165, 8)
    got, again = g_op.g_operator_contract(*args), g_op.g_operator_contract(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("N,F", [(65, 32), (13, 24)])
def test_g_op_kernel_refuses_unsupported_shapes(cuda, N, F):
    args = _g_op_inputs(cuda, N, F, 3, 2)
    before = g_op.g_operator_contract.launches
    with pytest.raises(ValueError, match="N <= 64"):
        g_op.g_operator_contract(*args)
    assert g_op.g_operator_contract.launches == before


def test_g_op_scalar_kernel_matches_plain(cuda):
    """The scalar K5, kept as the yardstick, counts on its own counter."""
    args = _g_op_inputs(cuda, 55, 32, 37, 4)
    before = (g_op.g_operator_contract.launches, g_op._contract_scalar.launches)
    got = g_op._contract_scalar(*args)
    assert (g_op.g_operator_contract.launches, g_op._contract_scalar.launches) == (
        before[0], before[1] + 1)
    ref = g_op.g_operator_contract_plain(*args)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 2e-3 * ref.abs().max()


@pytest.mark.parametrize("F,N,Tc,tc,cd,tol", [
    (32, 55, 20, 8, torch.float32, 2e-4),  # ragged: blocks of 8, 8 and 4 tangents
    (32, 55, 20, 8, torch.bfloat16, 3e-2),
    (16, 13, 39, 16, torch.float32, 2e-4),
    (16, 40, 7, 1, torch.bfloat16, 3e-2),
])
def test_egcl_tangent_kernel_matches_plain(cuda, F, N, Tc, tc, cd, tol):
    """The dispatch: bf16 runs the tensor-core K4, f32 the 3xTF32 K4, each
    counted on its own counter, the scalar K4 never at these shapes."""
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    args = _tangent_inputs(cuda, 6, N, F, Tc, seed=N + 1)
    tc_kernel = cd == torch.bfloat16
    counts = lambda: (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tc.launches,
                      et.egnn_layer_tangent_tf32.launches)
    for attention, tanh in ((True, True), (False, False)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=cd)
        before = counts()
        got = et.egnn_layer_tangent(*args, w, tangent_chunk=tc, **cfg)
        assert counts() == (before[0], before[1] + tc_kernel, before[2] + (not tc_kernel))
        with torch.no_grad():
            ref = et.layer_tangent(*args, w, **cfg)
        torch.cuda.synchronize()
        # f32: sums reassociated; bf16: now and then a neighbouring bf16 rounding
        for a, b in zip(got, ref):
            assert (a - b).abs().max() <= tol * b.abs().max()


def _tangent_inputs(device, B, N, F, Tc, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    xs0 = randn(B, N, 3) * 0.5
    x = xs0 + 0.1 * randn(B, N, 3)
    h = randn(B, N, F)
    ea = ((xs0[:, :, None] - xs0[:, None]) ** 2).sum(-1)
    basis = torch.eye(3 * N, device=device)[torch.randperm(3 * N, generator=g, device=device)[:Tc]]
    return h, x, ea, xs0, basis.reshape(Tc, N, 3), randn(B, Tc, N, F), randn(B, Tc, N, 3)


@pytest.mark.parametrize("F,N,Tc,B,tc", [
    (32, 55, 64, 8, 8),  # the main path's launch, at 8 chains
    (32, 55, 37, 8, 8),  # the ragged last super-chunk: blocks of 8 and one of 5
    (32, 64, 64, 1, 16),  # four full sender tiles; the largest chunk
    (32, 13, 1, 8, 8),  # one tangent; one partly filled sender tile
    (16, 55, 37, 1, 5),
    (16, 64, 1, 8, 1),
    (16, 13, 39, 1, 16),  # all 39 tangents of N = 13
    (32, 55, 1, 1, 3),
])
def test_egcl_tangent_tc_kernel_matches_plain(cuda, F, N, Tc, B, tc):
    """The tensor-core K4 at the edges of its tiles: sender tiles partly
    inside N, chunks of tangents that do not divide Tc, the largest N and
    chunk; attention and tanh on and off."""
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    args = _tangent_inputs(cuda, B, N, F, Tc, seed=3 * N + Tc)
    for attention, tanh in ((True, True), (False, False), (True, False), (False, True)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=torch.bfloat16)
        before = (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tc.launches)
        got = et.egnn_layer_tangent_tc(*args, w, tangent_chunk=tc, **cfg)
        assert (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tc.launches) == (
            before[0], before[1] + 1)
        with torch.no_grad():
            ref = et.layer_tangent(*args, w, **cfg)
        torch.cuda.synchronize()
        # the same bf16 roundings up to a neighbouring bf16 now and then
        for a, b in zip(got, ref):
            assert torch.isfinite(a).all()
            assert (a - b).abs().max() <= 3e-2 * b.abs().max()


def test_egcl_tangent_tc_kernel_is_deterministic(cuda):
    """One warp writes each output and sums over senders in a fixed order:
    two launches on the same inputs are bitwise equal."""
    w = _bench_layer(cuda)
    args = _tangent_inputs(cuda, 8, 55, 32, 64, seed=5)
    run = lambda: et.egnn_layer_tangent_tc(*args, w, cd=torch.bfloat16)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("N,F,tc,match", [
    (65, 32, 8, "N <= 64"), (13, 24, 8, "N <= 64"), (13, 32, 17, "tangent_chunk"),
    (13, 32, 0, "tangent_chunk"),
])
def test_egcl_tangent_tc_kernel_refuses_unsupported_shapes(cuda, N, F, tc, match):
    w = _random_layer(F, cuda, seed=1)
    args = _tangent_inputs(cuda, 2, N, F, 3, seed=2)
    before = et.egnn_layer_tangent_tc.launches
    with pytest.raises(ValueError, match=match):
        et.egnn_layer_tangent(*args, w, tangent_chunk=tc, cd=torch.bfloat16)
    assert et.egnn_layer_tangent_tc.launches == before


@pytest.mark.parametrize("F,N,Tc,B,tc", [
    (32, 55, 64, 8, 16),  # the fill's launch at 8 chains: the route's chunk of 16 runs as 8
    (32, 55, 37, 8, 8),  # the ragged last super-chunk: blocks of 8 and one of 5
    (32, 13, 39, 8, 8),  # all 39 tangents of lj13
    (32, 64, 9, 1, 8),  # four full sender tiles
    (16, 55, 20, 3, 3),
    (16, 13, 1, 8, 1),  # one tangent; one partly filled sender tile
])
def test_egcl_tangent_tf32_kernel_matches_plain(cuda, F, N, Tc, B, tc):
    """The 3xTF32 K4 at chip_smoke.py's TOL_F32, at the edges of its tiles:
    sender tiles partly inside N, chunks that do not divide Tc, the largest
    N, a chunk above its 8; attention and tanh on and off."""
    w = _bench_layer(cuda) if F == 32 else _random_layer(F, cuda, seed=N)
    args = _tangent_inputs(cuda, B, N, F, Tc, seed=5 * N + Tc)
    for attention, tanh in ((True, True), (False, False), (True, False), (False, True)):
        cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=torch.float32)
        before = (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tf32.launches)
        got = et.egnn_layer_tangent_tf32(*args, w, tangent_chunk=tc, **cfg)
        assert (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tf32.launches) == (
            before[0], before[1] + 1)
        with torch.no_grad():
            ref = et.layer_tangent(*args, w, **cfg)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.isfinite(a).all()
            assert (a - b).abs().max() <= 2e-4 * b.abs().max()


def test_egcl_tangent_tf32_kernel_is_deterministic(cuda):
    """One warp writes each output and sums over senders in a fixed order:
    two launches on the same inputs are bitwise equal."""
    w = _bench_layer(cuda)
    args = _tangent_inputs(cuda, 8, 55, 32, 64, seed=6)
    run = lambda: et.egnn_layer_tangent_tf32(*args, w)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_egcl_f32_tangent_routes_by_shape(cuda):
    """The rule of egnn_layer.tf32_takes for K4: f32 at N > 64 runs the scalar
    K4; the 3xTF32 wrapper itself refuses N > 64, F outside (16, 32), a
    chunk below 1 and bf16; its limits are the kernel's."""
    w = _random_layer(16, cuda, seed=2)
    args = _tangent_inputs(cuda, 2, 70, 16, 5, seed=3)
    before = (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tf32.launches)
    got = et.egnn_layer_tangent(*args, w, tangent_chunk=4)
    assert (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tf32.launches) == (
        before[0] + 1, before[1])
    with torch.no_grad():
        ref = et.layer_tangent(*args, w)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max() <= 2e-4 * b.abs().max()
    with pytest.raises(ValueError, match="N <= 64"):
        et.egnn_layer_tangent_tf32(*args, w)
    small = _tangent_inputs(cuda, 2, 13, 16, 5, seed=4)
    with pytest.raises(ValueError, match="tangent_chunk"):
        et.egnn_layer_tangent_tf32(*small, w, tangent_chunk=0)
    with pytest.raises(ValueError, match="f32 only"):
        et.egnn_layer_tangent_tf32(*small, w, cd=torch.bfloat16)
    with pytest.raises(ValueError, match="N <= 64"):
        et.egnn_layer_tangent_tf32(*_tangent_inputs(cuda, 2, 13, 24, 5, seed=4),
                                   _random_layer(24, cuda, seed=2))
    assert et.egnn_layer_tangent_tf32.launches == before[1]
    lib = et._lib_tf32()
    assert lib.pita_egcl_tangent_tf32_max_n() == el.TF32_MAX_N
    assert lib.pita_egcl_tangent_tf32_max_chunk() == et.TF32_MAX_CHUNK


def test_egcl_tangent_tc_limits_match_the_kernel(cuda):
    """The limits the wrapper checks on CUDA tensors are the kernel's."""
    lib = et._lib_tc()
    assert lib.pita_egcl_tangent_tc_max_n() == et.TC_MAX_N
    assert lib.pita_egcl_tangent_tc_max_chunk() == et.TC_MAX_CHUNK


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


def test_trace_bf16_routes_agree_on_the_card(cuda):
    """The forward-mode trace of a bf16 backbone runs the tensor-core K4
    (nine launches: 3 layers x 3 super-chunks of 16, 16 and 7 tangents) and
    never the scalar one, and agrees with the same trace by the plain
    version on the CPU within chip_smoke.py's TOL_TRACE_BF16: both round the
    same tangents to bf16, up to a neighbouring bf16 where an f32 value an
    ulp apart rounds the other way. (The edge-operator trace rounds no
    tangent; on this small model the two routes differ by ~2.6e-3 of the
    trace whichever K4 runs, so it is no yardstick of the kernel.)"""
    bb = EGNNBackbone(13, hidden_nf=16, n_layers=3, compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(7)
    for name, p in bb.named_parameters():
        scale = 0.1 if p.dim() == 1 else 0.01 if name.endswith("w_c2") else p.shape[0] ** -0.5
        p.data = torch.randn(p.shape, generator=g) * scale
    t = torch.rand(5, generator=g)
    x = torch.randn(5, 39, generator=g) * 0.5
    tr_p = et.egnn_jacobian_trace_fused(bb, t, x, 1.0, tangent_chunk=4, super_chunk=16)
    bb = bb.to(cuda)
    before = (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tc.launches)
    tr_f = et.egnn_jacobian_trace_fused(bb, t.to(cuda), x.to(cuda), 1.0, tangent_chunk=4,
                                        super_chunk=16)
    assert (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tc.launches) == (
        before[0], before[1] + 9)
    torch.cuda.synchronize()
    assert (tr_f.cpu() - tr_p).abs().max() <= 1e-3 * tr_p.abs().max()


def test_exact_generic_divergence_on_the_card(cuda):
    """The generic exact divergence on the kernel route (D reverse-mode rows,
    a forward and a backward per block of rows, each backward through the
    EGCL VJP kernel K3, which has no batching rule: the replicated form the
    sampler takes there) against the edge-operator trace, f32."""
    from pita_torch.nets.egnn_fast import egnn_jacobian_trace
    from pita_torch.ops.divergence import exact_divergence_replicated

    bb = EGNNBackbone(13, hidden_nf=16, n_layers=2)
    g = torch.Generator().manual_seed(8)
    for p in bb.parameters():
        p.data = torch.randn(p.shape, generator=g) * (0.1 if p.dim() == 1 else p.shape[0] ** -0.5)
    bb = bb.to(cuda)
    t = torch.rand(4, generator=g).to(cuda)
    x = (torch.randn(4, 39, generator=g) * 0.5).to(cuda)
    before = el.egnn_layer_backward_tf32.launches
    tr_rev = exact_divergence_replicated(lambda tq, xq: bb(tq, xq, 1.0), t, x, row_chunk=16)
    # the f32 K3 in 3xTF32 (N = 13): 2 layers x 3 chunks of rows
    assert el.egnn_layer_backward_tf32.launches == before + 2 * 3
    _, tr_op = egnn_jacobian_trace(bb, t, x, 1.0)
    torch.cuda.synchronize()
    assert (tr_rev - tr_op).abs().max() <= 1e-4 * tr_op.abs().max()


def test_training_step_repacks_the_sampler_kernels(cuda, tmp_path):
    """After an optimizer step on the card, the EMA shadow's layers (the
    sampler's weights, updated in place) repack their kernel buffers, the
    3xTF32 K2's too: K2 and K3 on them match their plain versions on the
    updated weights, f32."""
    from pita_torch.configs import build_trainer, compose

    cfg = compose("lj13", debug="short", overrides={
        "trainer.temperatures": (4.0, 3.0), "trainer.num_epochs_per_temp": (2,),
        "trainer.buffer_capacity": 512, "trainer.init_from_prior": True,
        "trainer.num_init_samples": 64, "trainer.ema_decay": 0.5, "net.hidden_nf": 16,
        "net.n_layers": 2, "out_dir": str(tmp_path)})
    tr = build_trainer(cfg, device=cuda)
    tr.populate_initial_buffer()
    layer = tr.ema_score.module.layers[1]
    before = layer.packed(cuda).clone()
    before_tc = layer.packed(cuda, tc=True).clone()
    tr.train_step(0)
    assert not torch.equal(before, layer.packed(cuda))
    assert not torch.equal(before_tc, layer.packed(cuda, tc=True))
    w = layer.weights()
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(64, 13, 3, generator=g, device=cuda) * 0.5
    h = torch.randn(64, 13, 16, generator=g, device=cuda)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    gh, gx = torch.randn_like(h), torch.randn_like(x)
    n_fwd, n_bwd = el.egnn_layer_forward_tf32.launches, el.egnn_layer_backward_tf32.launches
    with torch.no_grad():
        ho, xo = layer(h, x, ea)
        ref = el.layer_step(h, x, ea, w, **layer.cfg)
    dh, dx, dea = el.egnn_layer_backward(h, x, ea, gh, gx, w, packed=layer.packed(cuda),
                                         packed_tc=layer.packed(cuda, tc=True), **layer.cfg)
    ref_b = el.layer_vjp(h, x, ea, gh, gx, w, **layer.cfg)
    assert (el.egnn_layer_forward_tf32.launches, el.egnn_layer_backward_tf32.launches) == (
        n_fwd + 1, n_bwd + 1)
    assert torch.equal(layer.packed(cuda, tc=True), el.pack_weights_tf32(w).to(cuda))
    torch.cuda.synchronize()
    for a, b in zip((ho, xo, dh, dx, dea), (*ref, *ref_b)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("n", [13, 55])
def test_idem_target_through_the_lj_kernel_matches_plain(cuda, n):
    """∇ₓR_t of 4 configurations over 1,000 probes each: the 4,000 probes in
    one K1 launch against the plain log_prob_and_force on the same probes.
    Softmax weights magnify K1's log p error (<= 1e-5 of the largest), so
    the target holds within 1e-3 of its largest entry."""
    from pita_torch.train.dem_estimator import estimate_grad_Rt

    B, K = 4, 1000
    x = _lj_inputs(n, B, seed=n, device=cuda, close=False)
    t = LennardJones(n, smooth=n == 55, temperature=1.0)
    ht = torch.tensor([1e-3, 5e-3, 1e-2, 2e-2], device=cuda)
    eps = torch.randn(B, K, 3 * n, generator=torch.Generator(cuda).manual_seed(n), device=cuda)
    before = ljop.lj_log_prob_and_force.launches
    got = estimate_grad_Rt(ht, x, t.log_prob_and_force, eps)
    assert ljop.lj_log_prob_and_force.launches == before + 1
    ref = estimate_grad_Rt(ht, x, lambda y: ljop.lj_log_prob_and_force_plain(y, n, **_lj_kw(t)),
                           eps)
    torch.cuda.synchronize()
    assert got.shape == (B, 3 * n) and torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()


def test_hmc_steps_through_the_lj_kernel_match_plain(cuda):
    """Three HMC steps of 10 leapfrogs on LJ55 with the same momenta and
    uniforms: by K1 (1 + 3·12 launches) and by the plain version; the same
    acceptance rate each step and step size, the positions within 1e-4 of
    the largest."""
    from pita_torch.baselines.mcmc import hmc_chain

    B, L = 64, 10
    t = LennardJones(55, smooth=True, temperature=1.0)
    x0 = _lj_inputs(55, B, seed=7, device=cuda, close=False)
    g = torch.Generator(cuda).manual_seed(3)
    draws = [(torch.randn(x0.shape, generator=g, device=cuda),
              torch.rand(B, generator=g, device=cuda)) for _ in range(3)]
    before = (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches)
    got = hmc_chain(t.log_prob_and_force, x0, 3, step_size=5e-3, n_leapfrog=L, draws=draws)
    assert (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches) == (
        before[0] + 1 + 3 * (L + 2), before[1])
    ref = hmc_chain(lambda y: ljop.lj_log_prob_and_force_plain(y, 55, **_lj_kw(t)), x0, 3,
                    step_size=5e-3, n_leapfrog=L, draws=draws)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and float(got[2]) == float(ref[2])
    assert 0.0 < float(got[1].mean()) < 1.0
    assert (got[0] - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()
