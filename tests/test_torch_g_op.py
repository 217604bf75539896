"""The plain version of the G-operator contraction (kernel K5's reference)
against pita_tpu's Pallas kernel in interpret mode (CPU). The CUDA kernel
is held against the plain version in test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.ops.pallas.g_op import g_operator_contract as jax_g_op
from pita_torch.ops.g_op import _contract_scalar, g_operator_contract, g_operator_contract_plain
from torch_threads import one_intra_op_thread  # noqa: F401


def _inputs(N, F, T, B, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        draw = lambda *s: np.round(rng.normal(size=s) * 2).astype(np.float32)
        sp1, sp2, att = draw(B, N, N, F), draw(B, N, N, F), draw(B, N, N)
        satq, m_pre, w2, bv = draw(B, N, N, F), draw(B, N, N, F), draw(F, F), draw(T, B, N, F)
    else:
        f32 = lambda a: a.astype(np.float32)
        sp1, sp2 = f32(rng.uniform(size=(B, N, N, F))), f32(rng.uniform(size=(B, N, N, F)))
        att = f32(rng.uniform(size=(B, N, N)))
        satq = f32(rng.normal(size=(B, N, N, F)) * 0.1)
        m_pre = f32(rng.normal(size=(B, N, N, F)))
        w2 = f32(rng.normal(size=(F, F)) / np.sqrt(F))
        bv = f32(rng.normal(size=(T, B, N, F)) * 0.5)
    mask = (1.0 - np.eye(N)).astype(np.float32)
    return sp1, sp2, att * mask, satq * mask[:, :, None], m_pre, w2, bv


@pytest.mark.parametrize("N,F,T,B", [(13, 16, 39, 3), (7, 32, 21, 2)])
def test_plain_matches_pallas_interpret(N, F, T, B):
    args = _inputs(N, F, T, B, seed=N)
    ref = np.asarray(jax_g_op(*(jnp.asarray(a) for a in args), rows_per_block=4,
                              interpret=True))
    got = g_operator_contract(*(torch.as_tensor(a) for a in args))  # CPU: the plain version
    assert got.shape == (T, B, N, F)
    # both round G and bv to bf16; an f32 G one ulp apart can round to a
    # neighbouring bf16 (the tolerance of pita_tpu's own test)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=2e-2)
    # far inside that tolerance in fact: the roundings coincide almost everywhere
    assert np.abs(got.numpy() - ref).max() <= 2e-3 * np.abs(ref).max()


def test_plain_matches_pallas_interpret_near_integer():
    """Near-integer inputs are exact in bf16: only the indexing is tested."""
    args = _inputs(5, 8, 15, 2, seed=1, integer=True)
    ref = np.asarray(jax_g_op(*(jnp.asarray(a) for a in args), rows_per_block=2,
                              interpret=True))
    got = g_operator_contract_plain(*(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_plain_is_the_materialized_einsum_up_to_bf16():
    sp1, sp2, att_mask, satq, m_pre, w2, bv = (torch.as_tensor(a)
                                               for a in _inputs(6, 16, 18, 2, seed=2))
    K = sp1[..., :, None] * w2 * sp2[..., None, :]
    G = att_mask[..., None, None] * K + satq[..., :, None] * m_pre[..., None, :]
    ref = torch.einsum("bnmfg,tbmf->tbng", G, bv)
    got = g_operator_contract_plain(sp1, sp2, att_mask, satq, m_pre, w2, bv)
    # two bf16 roundings (2^-9 each) on sums of 96 terms
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.parametrize("bad", ["shape", "dtype", "rank"])
def test_wrapper_refuses_bad_inputs(bad):
    args = [torch.as_tensor(a) for a in _inputs(4, 8, 6, 2, seed=3)]
    if bad == "shape":
        args[2] = args[2][:, :3]
        err = ValueError
    elif bad == "dtype":
        args[6] = args[6].double()
        err = TypeError
    else:
        args[0] = args[0][0]
        err = ValueError
    with pytest.raises(err):
        g_operator_contract(*args)


def test_cpu_tensors_take_the_plain_version_at_any_width():
    """The tensor-core kernel's limits (N <= 64, F in {16, 32}) hold on CUDA
    only: on the CPU the wrapper is the plain version for any shape."""
    args = [torch.as_tensor(a) for a in _inputs(3, 24, 5, 2, seed=4)]
    torch.testing.assert_close(g_operator_contract(*args), g_operator_contract_plain(*args),
                               rtol=0, atol=0)


def test_scalar_kernel_runs_on_cuda_tensors_only():
    """The scalar K5 is a timing yardstick: it has no CPU path and counts
    nothing when it refuses."""
    args = [torch.as_tensor(a) for a in _inputs(4, 8, 6, 2, seed=5)]
    before = _contract_scalar.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _contract_scalar(*args)
    assert _contract_scalar.launches == before
