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
