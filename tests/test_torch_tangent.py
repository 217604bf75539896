"""The plain version of the EGCL layer tangent map (kernel K4's reference)
against jax.jvp through pita_tpu's _layer_step, and the forward-mode Jacobian
trace against pita_tpu's Pallas trace in interpret mode and against the
edge-operator trace (CPU). The CUDA kernel is held against the plain version
in test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets.egnn_fast import extract_params
from pita_tpu.ops.pallas.egnn_fwd import _W_FIELDS, _layer_step, egnn_jacobian_trace_pallas
from pita_torch.io.flax_params import load_egnn_params
from pita_torch.nets import EGNNBackbone
from pita_torch.nets.egnn_fast import egnn_jacobian_trace
from pita_torch.ops.divergence import exact_divergence_replicated
from pita_torch.ops.egnn_layer import layer_step
from pita_torch.ops.egnn_tangent import (egnn_jacobian_trace_fused, egnn_layer_tangent,
                                         egnn_layer_tangent_tc, layer_tangent)
from torch_threads import one_intra_op_thread  # noqa: F401


def _layer(seed, hidden, n=6):
    mod = JaxEGNN(n_particles=n, hidden_nf=hidden, n_layers=1)
    params = mod.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, 3 * n)), 1.0)
    lp = extract_params(params, 1, True)[2][0]
    jw = {f: getattr(lp, f) for f in _W_FIELDS}
    return jw, {f: torch.as_tensor(np.array(v)) for f, v in jw.items()}


def _inputs(B, Tc, N, F, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    h, x, xs0 = f32(B, N, F), f32(B, N, 3), f32(B, N, 3)
    ea = ((xs0[:, :, None] - xs0[:, None]) ** 2).sum(-1)
    basis = np.eye(3 * N, dtype=np.float32)[rng.permutation(3 * N)[:Tc]].reshape(Tc, N, 3)
    return h, x, ea, xs0, basis, f32(B, Tc, N, F), f32(B, Tc, N, 3)


def _jax_tangent(h, x, ea, xs0, basis, dh, dx, jw, cd, attention, tanh):
    """jax.jvp through pita_tpu's _layer_step, a tangent at a time, with the
    edge-attribute tangent of _layer_tan_kernel (egnn_fwd.py:228-231)."""
    N = x.shape[1]
    mask = 1.0 - jnp.eye(N, dtype=jnp.float32)
    f = lambda hh, xx, ee: _layer_step(hh, xx, ee, mask, jw, attention=attention, tanh=tanh,
                                       coords_range=5.0, cd=cd)
    xt = jnp.swapaxes(jnp.asarray(x), 1, 2)  # (B, 3, N), pita_tpu's layout
    diff0 = jnp.asarray(xs0)[:, :, None, :] - jnp.asarray(xs0)[:, None, :, :]  # (B,N,N,3)

    def one(e, dh_t, dx_t):
        de = e[:, None, :] - e[None, :, :]  # (N, N, 3)
        dea = 2.0 * jnp.sum(diff0 * de[None], axis=-1)
        _, (dho, dxo) = jax.jvp(f, (jnp.asarray(h), xt, jnp.asarray(ea)),
                                (dh_t, jnp.swapaxes(dx_t, 1, 2), dea))
        return dho, jnp.swapaxes(dxo, 1, 2)

    outs = [one(jnp.asarray(basis[t]), jnp.asarray(dh[:, t]), jnp.asarray(dx[:, t]))
            for t in range(basis.shape[0])]
    return (np.stack([np.asarray(o[0]) for o in outs], 1),
            np.stack([np.asarray(o[1]) for o in outs], 1))


@pytest.mark.parametrize("attention,tanh", [(True, True), (False, False)])
def test_layer_tangent_matches_jax_jvp_f32(attention, tanh):
    jw, tw = _layer(seed=1, hidden=16)
    args = _inputs(3, 5, 6, 16, seed=2)
    ref = _jax_tangent(*args, jw, jnp.float32, attention, tanh)
    got = egnn_layer_tangent(*(torch.as_tensor(a) for a in args), tw, attention=attention,
                             tanh=tanh, coords_range=5.0)  # CPU: the plain version
    for g, r in zip(got, ref):
        # f32, the same linear map; sums over 6 edges / 16 features reassociated
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


def test_layer_tangent_matches_jax_jvp_bf16():
    """bf16 matmul inputs: the tangent of a rounded input is itself rounded,
    as under jax.jvp."""
    jw, tw = _layer(seed=3, hidden=16)
    args = _inputs(3, 4, 6, 16, seed=4)
    ref = _jax_tangent(*args, jw, jnp.bfloat16, True, True)
    got = layer_tangent(*(torch.as_tensor(a) for a in args), tw, attention=True, tanh=True,
                        coords_range=5.0, cd=torch.bfloat16)
    for g, r in zip(got, ref):
        # an f32 value one ulp apart can round to a neighbouring bf16 (2^-8)
        assert np.abs(g.numpy() - r).max() <= 2e-2 * np.abs(r).max()
    # and the rounding is really there: the f32 tangent differs by more than f32 noise
    f32 = layer_tangent(*(torch.as_tensor(a) for a in args), tw, attention=True, tanh=True,
                        coords_range=5.0)
    assert (f32[0] - got[0]).abs().max() > 1e-4 * got[0].abs().max()


def test_layer_tangent_is_the_jvp_of_layer_step():
    """Independent of JAX: torch.func.jvp through the port's own layer_step
    (f32, where its rounding is the identity)."""
    _, tw = _layer(seed=5, hidden=8, n=5)
    h, x, ea, xs0, basis, dh, dx = (torch.as_tensor(a) for a in _inputs(2, 3, 5, 8, seed=6))
    got = layer_tangent(h, x, ea, xs0, basis, dh, dx, tw)
    diff0 = xs0[:, :, None, :] - xs0[:, None, :, :]
    for t in range(3):
        de = basis[t][:, None, :] - basis[t][None, :, :]
        dea = 2 * (diff0 * de[None]).sum(-1)
        _, (dho, dxo) = torch.func.jvp(lambda a, b, c: layer_step(a, b, c, tw), (h, x, ea),
                                       (dh[:, t], dx[:, t], dea))
        torch.testing.assert_close(got[0][:, t], dho, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[1][:, t], dxo, rtol=1e-5, atol=1e-5)


def _model(n, hidden, layers, seed, attention=True, tanh=True, B=4):
    mod = JaxEGNN(n_particles=n, hidden_nf=hidden, n_layers=layers, attention=attention,
                  tanh=tanh)
    rng = np.random.default_rng(seed)
    t = (rng.uniform(size=B) + 0.1).astype(np.float32)
    x = rng.normal(size=(B, 3 * n)).astype(np.float32)
    params = mod.init(jax.random.PRNGKey(seed), jnp.asarray(t), jnp.asarray(x), 1.1)
    bb = EGNNBackbone(n, hidden_nf=hidden, n_layers=layers, attention=attention, tanh=tanh)
    bb.load_state_dict(load_egnn_params(serialization.to_bytes(params), layers, attention))
    return mod, params, bb, t, x


@pytest.mark.parametrize("attention,tanh", [(True, True), (False, False)])
def test_trace_fused_matches_pallas_interpret_and_edge_operator(attention, tanh):
    mod, params, bb, t, x = _model(7, 16, 2, seed=7, attention=attention, tanh=tanh)
    ref = np.asarray(egnn_jacobian_trace_pallas(params, mod, jnp.asarray(t), jnp.asarray(x),
                                                jnp.asarray(1.1), tangent_chunk=8,
                                                interpret=True))
    tt, xt = torch.as_tensor(t), torch.as_tensor(x)
    # 21 tangents in super-chunks of 8: a ragged last one of 5
    got = egnn_jacobian_trace_fused(bb, tt, xt, 1.1, tangent_chunk=4, super_chunk=8)
    # the tolerance of pita_tpu's own test of its Pallas trace
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=1e-3)
    # f32, the same trace by forward mode and by edge operators
    _, tr_op = egnn_jacobian_trace(bb, tt, xt, 1.1)
    np.testing.assert_allclose(got.numpy(), tr_op.numpy(), rtol=1e-4, atol=1e-4)
    full = egnn_jacobian_trace_fused(bb, tt, xt, 1.1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_three_trace_routes_agree_on_large_weights():
    """Weights far from their initial scale make every term of the trace
    count: the edge-operator trace, the forward-mode trace and the
    reverse-mode oracle must agree to f32 reassociation. (pita_tpu's
    edge-operator trace is 0.2 % off here: it gathers the y-operators with
    their (d, q) axes transposed.)"""
    bb = EGNNBackbone(5, hidden_nf=16, n_layers=3)
    gen = torch.Generator().manual_seed(0)
    for p in bb.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.5
    t = torch.rand(3, generator=gen)
    x = torch.randn(3, 15, generator=gen)
    _, tr_op = egnn_jacobian_trace(bb, t, x, 1.0)
    tr_fwd = egnn_jacobian_trace_fused(bb, t, x, 1.0)
    tr_rev = exact_divergence_replicated(lambda tq, xq: bb(tq, xq, 1.0), t, x)
    np.testing.assert_allclose(tr_op.numpy(), tr_rev.numpy(), rtol=2e-5)
    np.testing.assert_allclose(tr_fwd.numpy(), tr_rev.numpy(), rtol=2e-5)


@pytest.mark.parametrize("attention,tanh", [(True, True), (False, False)])
def test_bf16_dispatch_on_cpu_runs_the_plain_version(attention, tanh):
    """On CPU tensors both K4 entry points run the plain version in bf16 and
    launch no kernel: the tensor-core K4 is chosen by dtype only on CUDA."""
    _, tw = _layer(seed=9, hidden=16)
    args = [torch.as_tensor(a) for a in _inputs(2, 5, 6, 16, seed=10)]
    cfg = dict(attention=attention, tanh=tanh, coords_range=5.0, cd=torch.bfloat16)
    before = (egnn_layer_tangent.launches, egnn_layer_tangent_tc.launches)
    ref = layer_tangent(*args, tw, **cfg)
    for fn in (egnn_layer_tangent, egnn_layer_tangent_tc):
        got = fn(*args, tw, tangent_chunk=3, **cfg)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert (egnn_layer_tangent.launches, egnn_layer_tangent_tc.launches) == before


def _random_weights(hidden, seed):
    rng = np.random.default_rng(seed)
    return {f: torch.as_tensor(rng.normal(size=s).astype(np.float32)) for f, s in dict(
        w_src=(hidden, hidden), b_src=(hidden,), w_dst=(hidden, hidden), w_scal=(2, hidden),
        w_e2=(hidden, hidden), b_e2=(hidden,), w_att=(hidden, 1), b_att=(1,),
        w_c1=(hidden, hidden), b_c1=(hidden,), w_c2=(hidden, 1), w_n1=(2 * hidden, hidden),
        b_n1=(hidden,), w_n2=(hidden, hidden), b_n2=(hidden,)).items()}


@pytest.mark.parametrize("n,hidden,chunk", [
    (65, 16, 8),  # more senders than the kernel's four 16-row tiles
    (6, 24, 8),  # a width its products do not tile
    (6, 16, 0),
    (6, 16, 17),  # more tangents than its one 16-row tile
])
def test_tc_wrapper_on_cpu_runs_the_plain_version_past_the_kernel_limits(n, hidden, chunk):
    """The tensor-core K4's limits are the kernel's: on CPU tensors the
    wrapper runs the plain version at any shape, as K2's and K3's do (the
    limits on CUDA tensors are tests/test_torch_kernels_gpu.py's)."""
    w = _random_weights(hidden, seed=11)
    args = [torch.as_tensor(a) for a in _inputs(1, 2, n, hidden, seed=12)]
    cfg = dict(attention=True, tanh=True, coords_range=5.0, cd=torch.bfloat16)
    ref = layer_tangent(*args, w, **cfg)
    got = egnn_layer_tangent_tc(*args, w, tangent_chunk=chunk, **cfg)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_tc_wrapper_refuses_f32():
    """f32 stays on the scalar K4, on every device."""
    w = _random_weights(16, seed=11)
    args = [torch.as_tensor(a) for a in _inputs(1, 2, 6, 16, seed=12)]
    with pytest.raises(ValueError, match="bf16 only"):
        egnn_layer_tangent_tc(*args, w, tangent_chunk=8, cd=torch.float32)
