"""The f32 EGCL VJP wrapper of the 3xTF32 kernel (K3) on the CPU, where it runs
its plain version, against pita_tpu's Pallas VJP kernel in interpret mode;
the dispatch of egnn_layer_backward by compute dtype, and EGCLFunction's f32
backward. The kernel itself is held against layer_vjp on the card in
test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.ops.pallas.egnn_fwd import _W_FIELDS, _layer_bwd_call
from pita_torch.nets.egnn import EGCL
from pita_torch.ops import egnn_layer as el
from torch_threads import one_intra_op_thread  # noqa: F401

N, B = 13, 2
NP = 16  # pita_tpu pads N to the sublane tile


def _weights(F, seed):
    """Both frameworks' copies of one layer's weights, from a numpy seed: the
    kernels at fan-in scale, biases and the coordinate head large enough
    that every branch of the VJP carries weight."""
    rng = np.random.default_rng(seed)
    shapes = dict(w_src=(F, F), b_src=(F,), w_dst=(F, F), w_scal=(2, F), w_e2=(F, F),
                  b_e2=(F,), w_att=(F, 1), b_att=(1,), w_c1=(F, F), b_c1=(F,), w_c2=(F, 1),
                  w_n1=(2 * F, F), b_n1=(F,), w_n2=(F, F), b_n2=(F,))
    np_w = {k: (rng.normal(size=s) * (0.1 if len(s) == 1 else s[0] ** -0.5)).astype(np.float32)
            for k, s in shapes.items()}
    return {k: jnp.asarray(v) for k, v in np_w.items()}, {k: torch.as_tensor(v)
                                                            for k, v in np_w.items()}


def _inputs(F, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, F)).astype(np.float32)
    x = (0.7 * rng.normal(size=(B, N, 3))).astype(np.float32)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1).astype(np.float32)
    gh = rng.normal(size=(B, N, F)).astype(np.float32)
    gx = rng.normal(size=(B, N, 3)).astype(np.float32)
    return h, x, ea, gh, gx


def _pallas_vjp(h, x, ea, gh, gx, jw, cfg):
    """pita_tpu's _layer_bwd_call in interpret mode, its padding and (B, 3,
    N) coordinate planes undone."""
    pad = ((0, 0), (0, NP - N))
    hp = jnp.pad(h, pad + ((0, 0),))
    ghp = jnp.pad(gh, pad + ((0, 0),))
    xp = jnp.pad(jnp.swapaxes(x, 1, 2), ((0, 0), (0, 0), (0, NP - N)))
    gxp = jnp.pad(jnp.swapaxes(gx, 1, 2), ((0, 0), (0, 0), (0, NP - N)))
    eap = jnp.pad(ea, pad + ((0, NP - N),))
    static = dict(n_particles=N, cd=jnp.float32, **cfg)
    dh, dx, dea = _layer_bwd_call(hp, xp, eap, ghp, gxp, [jw[f] for f in _W_FIELDS], static,
                                  B, True)
    return (np.asarray(dh)[:, :N], np.asarray(jnp.swapaxes(dx, 1, 2))[:, :N],
            np.asarray(dea)[:, :N, :N])


@pytest.mark.parametrize("attention,tanh", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("F", [16, 32])
def test_backward_tf32_matches_pita_tpu_kernel(F, attention, tanh):
    jw, tw = _weights(F, seed=F + 2 * attention + tanh)
    args = _inputs(F, seed=F)
    cfg = dict(attention=attention, tanh=tanh, coords_range=5.0)
    ref = _pallas_vjp(*(jnp.asarray(a) for a in args), jw, cfg)
    before = el.egnn_layer_backward_tf32.launches
    got = el.egnn_layer_backward_tf32(*(torch.as_tensor(a) for a in args), tw,
                                      cd=torch.float32, **cfg)
    assert el.egnn_layer_backward_tf32.launches == before  # the plain version ran
    for g, r in zip(got, ref):
        # f32 reverse mode in two frameworks: reassociated sums
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5 * np.abs(r).max())
    assert not got[2].diagonal(dim1=1, dim2=2).any()


def test_backward_on_the_cpu_counts_no_launch():
    """On CPU tensors egnn_layer_backward runs layer_vjp for f32 (the 3xTF32
    route's shape and the scalar route's) and bf16, and no wrapper counts a
    launch."""
    counters = (el.egnn_layer_backward, el.egnn_layer_backward_tc, el.egnn_layer_backward_tf32)
    _, tw = _weights(16, seed=5)
    before = [f.launches for f in counters]
    for n in (N, 70):  # tf32_takes(13, 16) and not tf32_takes(70, 16)
        rng = np.random.default_rng(n)
        x = torch.as_tensor(rng.normal(size=(2, n, 3)).astype(np.float32))
        h, gh = (torch.as_tensor(rng.normal(size=(2, n, 16)).astype(np.float32))
                 for _ in range(2))
        gx = torch.as_tensor(rng.normal(size=(2, n, 3)).astype(np.float32))
        ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
        for cd in (torch.float32, torch.bfloat16):
            cfg = dict(attention=True, tanh=True, coords_range=5.0, cd=cd)
            # the bf16 VJP takes the forward's aggregate
            agg = (el.egnn_layer_forward(h, x, ea, tw, with_agg=True, **cfg)[2]
                   if cd == torch.bfloat16 else None)
            got = el.egnn_layer_backward(h, x, ea, gh, gx, tw, agg=agg, **cfg)
            for a, b in zip(got, el.layer_vjp(h, x, ea, gh, gx, tw, **cfg)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="f32 only"):
        h = torch.zeros(1, N, 16)
        el._tf32_launch_args(h, tw, None, None, dict(cd=torch.bfloat16), "VJP")


def test_egcl_function_f32_backward_is_layer_vjp():
    """EGCLFunction's backward for an f32 layer, which hands the layer's
    TF32 buffer to egnn_layer_backward, equals layer_vjp on the CPU."""
    _, tw = _weights(32, seed=9)
    layer = EGCL(32, compute_dtype=torch.float32)
    for name, v in tw.items():
        getattr(layer, name).data.copy_(v)
    h, x, ea, gh, gx = (torch.as_tensor(a) for a in _inputs(32, seed=10))
    hr, xr, ear = (a.clone().requires_grad_(True) for a in (h, x, ea))
    ho, xo = layer(hr, xr, ear)
    got = torch.autograd.grad((ho, xo), (hr, xr, ear), (gh, gx))
    ref = el.layer_vjp(h, x, ea, gh, gx, layer.weights(), **layer.cfg)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)  # the same plain computation
    assert torch.equal(layer.packed("cpu", tc=True), el.pack_weights_tf32(layer.weights()))
