"""pita_torch.nets.egnn_fast against pita_tpu.nets.egnn_fast (CPU, f32):
the forward with its activations, every tangent operator, the Jacobian trace
by each route and the score divergence. The port's generic exact trace
(D VJPs; on the kernel route, whose EGCL backward has no batching rule, its
replicated form ``exact_divergence_replicated``) is the independent oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.nets import egnn_fast as jf
from pita_tpu.schedules import ElucidatingNoiseSchedule as JaxSched
from pita_torch.io.flax_params import load_egnn_params
from pita_torch.nets import EGNNBackbone, ScoreWrapper
from pita_torch.nets import egnn_fast as tf
from pita_torch.ops.divergence import exact_divergence_replicated
from pita_torch.schedules import ElucidatingNoiseSchedule
from torch_threads import one_intra_op_thread  # noqa: F401

ASSET = "pita_tpu/assets/bench_lj55.npz"


def _setup(n=5, hidden=16, layers=2, attention=True, tanh=True, seed=0, B=4):
    mod = JaxEGNN(n_particles=n, hidden_nf=hidden, n_layers=layers, attention=attention,
                  tanh=tanh)
    rng = np.random.default_rng(seed)
    t = rng.uniform(size=B).astype(np.float32)
    x = rng.normal(size=(B, 3 * n)).astype(np.float32)
    params = mod.init(jax.random.PRNGKey(seed), jnp.asarray(t), jnp.asarray(x), 1.3)
    bb = EGNNBackbone(n, hidden_nf=hidden, n_layers=layers, attention=attention, tanh=tanh)
    bb.load_state_dict(load_egnn_params(serialization.to_bytes(params), layers, attention))
    return mod, params, bb, t, x, 1.3


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("attention,tanh", [(True, True), (False, True), (True, False)])
def test_egnn_apply_and_activations_match_jax(attention, tanh):
    mod, params, bb, t, x, beta = _setup(attention=attention, tanh=tanh)
    out_j, (ea_j, d0_j, _, cr_j, _, acts_j, xs_j) = jf.egnn_apply(
        params, mod, jnp.asarray(t), jnp.asarray(x), jnp.asarray(beta), with_acts=True)
    out_t, (ea_t, d0_t, _, cr_t, _, acts_t, xs_t) = tf.egnn_apply(
        bb, torch.as_tensor(t), torch.as_tensor(x), beta, with_acts=True)
    # f32, the same operations; sums over 5 edges / 16 features reassociated
    _close(out_t, out_j)
    _close(ea_t, ea_j)
    _close(d0_t, d0_j)
    assert cr_t == pytest.approx(cr_j)
    for a_t, a_j in zip(acts_t, acts_j):
        for name in a_j._fields:
            _close(getattr(a_t, name), getattr(a_j, name))
    # and the same function as the backbone module
    _close(bb(torch.as_tensor(t), torch.as_tensor(x), beta), out_j)


@pytest.mark.parametrize("materialize_g", [True, False])
@pytest.mark.parametrize("attention,tanh", [(True, True), (False, False)])
def test_layer_tangent_ops_match_jax(materialize_g, attention, tanh):
    """Every operator of every layer; G itself when materialized, the
    arguments of the G-operator kernel when not."""
    mod, params, bb, t, x, beta = _setup(n=4, hidden=8, attention=attention, tanh=tanh, seed=1)
    _, (_, d0_j, mask_j, cr, layers_j, acts_j, _) = jf.egnn_apply(
        params, mod, jnp.asarray(t), jnp.asarray(x), jnp.asarray(beta), with_acts=True)
    _, (_, d0_t, mask_t, _, w_t, acts_t, _) = tf.egnn_apply(
        bb, torch.as_tensor(t), torch.as_tensor(x), beta, with_acts=True)
    for lp, aj, w, at in zip(layers_j, acts_j, w_t, acts_t):
        ops_j = jf._layer_tangent_ops(lp, aj, d0_j, mask_j, cr, attention, tanh, jnp.float32,
                                      materialize_g=materialize_g)
        ops_t = tf._layer_tangent_ops(w, at, d0_t, mask_t, cr, attention, tanh,
                                      materialize_g=materialize_g)
        assert set(ops_t) == set(ops_j)
        for k, ref in ops_j.items():
            if isinstance(ref, dict):
                assert set(ops_t[k]) == set(ref)
                for kk in ref:
                    _close(ops_t[k][kk], ref[kk])
            else:
                _close(ops_t[k], ref)  # f32, reassociated sums over 4 edges / 8 features


@pytest.mark.parametrize("attention,tanh", [(True, True), (False, True), (True, False),
                                            (False, False)])
def test_jacobian_trace_matches_jax_and_oracle(attention, tanh):
    mod, params, bb, t, x, beta = _setup(layers=3, attention=attention, tanh=tanh, seed=2)
    out_j, tr_j = jf.egnn_jacobian_trace(params, mod, jnp.asarray(t), jnp.asarray(x),
                                         jnp.asarray(beta))
    tt, xt = torch.as_tensor(t), torch.as_tensor(x)
    out_t, tr_t = tf.egnn_jacobian_trace(bb, tt, xt, beta)
    _close(out_t, out_j)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-4, atol=1e-4)
    # independent oracle: D reverse-mode rows through the backbone module
    tr_o = exact_divergence_replicated(lambda tq, xq: bb(tq, xq, beta), tt, xt, row_chunk=4)
    np.testing.assert_allclose(tr_t.numpy(), tr_o.numpy(), rtol=1e-4, atol=1e-4)


def test_jacobian_trace_chunked_equals_unchunked():
    mod, params, bb, t, x, beta = _setup()
    tt, xt = torch.as_tensor(t), torch.as_tensor(x)
    _, full = tf.egnn_jacobian_trace(bb, tt, xt, beta)
    for chunk in (4, 7):  # 15 tangents: ragged last chunks of 3 and 1
        _, part = tf.egnn_jacobian_trace(bb, tt, xt, beta, tangent_chunk=chunk)
        np.testing.assert_allclose(part.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attention", [True, False])
def test_jacobian_trace_g_kernel_route_matches_jax_interpret(attention):
    """g_kernel=True: the plain version of K5 on the CPU against the Pallas
    G-operator kernel in interpret mode; both round G and Bv to bf16."""
    mod, params, bb, t, x, beta = _setup(layers=3, attention=attention, seed=3)
    out_j, tr_j = jf.egnn_jacobian_trace(params, mod, jnp.asarray(t), jnp.asarray(x),
                                         jnp.asarray(beta), g_kernel=True,
                                         g_kernel_interpret=True, g_rows_per_block=2)
    tt, xt = torch.as_tensor(t), torch.as_tensor(x)
    out_t, tr_t = tf.egnn_jacobian_trace(bb, tt, xt, beta, g_kernel=True)
    _close(out_t, out_j)
    # the tolerance of pita_tpu's own test of this route (bf16 G)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=2e-2, atol=5e-3)
    _, tr_m = tf.egnn_jacobian_trace(bb, tt, xt, beta)
    np.testing.assert_allclose(tr_t.numpy(), tr_m.numpy(), rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("precondition_beta", [False, True])
def test_score_divergence_fast_matches_jax(precondition_beta):
    mod, params, bb, t, x, beta = _setup(seed=4, B=5)
    js = JaxSched(sigma_min=0.05, sigma_max=10.0, rho=7.0)
    ts = ElucidatingNoiseSchedule(sigma_min=0.05, sigma_max=10.0, rho=7.0)
    ref = np.asarray(jf.score_divergence_fast(
        JaxScore(mod, precondition_beta=precondition_beta), params, js.h(jnp.asarray(t)),
        jnp.asarray(x), jnp.asarray(beta)))
    sw = ScoreWrapper(bb, precondition_beta=precondition_beta)
    tt, xt = torch.as_tensor(t), torch.as_tensor(x)
    got = tf.score_divergence_fast(sw, ts.h(tt), xt, beta)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    # chain chunks with a ragged last one (5 = 2 + 2 + 1), and tangent chunks
    part = tf.score_divergence_fast(sw, ts.h(tt), xt, beta, chain_chunk=2, tangent_chunk=4)
    np.testing.assert_allclose(part.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # the generic exact divergence of the score function
    gen = exact_divergence_replicated(lambda tq, xq: sw.score(ts.h(tq), xq, beta), tt, xt,
                                      chunk_size=3)
    np.testing.assert_allclose(gen.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_score_divergence_fast_bench_weights_lj55():
    """The bench's LJ55 score network (55 particles, 32 wide, 3 layers), f32,
    2 chains, tangents in chunks of 33."""
    a = np.load(ASSET)
    mod = JaxEGNN(n_particles=55, hidden_nf=32, n_layers=3)
    params = serialization.msgpack_restore(a["score_params"].tobytes())
    bb = EGNNBackbone(55, hidden_nf=32, n_layers=3)
    bb.load_state_dict(load_egnn_params(a["score_params"], 3))
    x = (a["data_T_low"][:2] + 0.05 * np.random.default_rng(5).normal(size=(2, 165))).astype(
        np.float32)
    ht = np.array([0.3, 1.1], np.float32)
    ref = np.asarray(jf.score_divergence_fast(JaxScore(mod), params, jnp.asarray(ht),
                                              jnp.asarray(x), jnp.asarray(1.0),
                                              tangent_chunk=33))
    got = tf.score_divergence_fast(ScoreWrapper(bb), torch.as_tensor(ht), torch.as_tensor(x),
                                   1.0, tangent_chunk=33)
    # f32 reassociation is ~1e-5 here; the rest is pita_tpu's own: it gathers
    # the y-operators (QCX1, QCXD, QEX1, QEXD) with their (d, q) axes
    # transposed, which moves its trace by 2.2e-4 of the largest value on these
    # weights. The port's trace is held to 1e-4 by the reverse-mode oracle
    # above and by the forward-mode trace in test_torch_tangent.py.
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-4 * np.abs(ref).max())


def test_supports_fast_divergence_and_atom_types():
    _, _, bb, t, x, beta = _setup()
    assert tf.supports_fast_divergence(bb)
    assert not tf.supports_fast_divergence(torch.nn.Linear(3, 3))
    # atom types: their one-hot joins the node features before the embedding
    typed = EGNNBackbone(5, hidden_nf=16, n_layers=2, atom_types=(0, 1, 1, 2, 0))
    typed.reset_parameters(torch.Generator().manual_seed(0))
    assert typed.w_emb.shape[0] == 2 + 3
    got = tf.egnn_apply(typed, torch.as_tensor(t), torch.as_tensor(x), beta)
    np.testing.assert_array_equal(got.numpy(),
                                  typed(torch.as_tensor(t), torch.as_tensor(x), beta).numpy())
