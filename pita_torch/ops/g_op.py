"""G-operator tangent contraction (kernel K5) with its plain version.

Counterpart of ``pita_tpu/ops/pallas/g_op.py:91 g_operator_contract``:

    t2[t,b,n,g] = Σ_{m,f} G[b,n,m,f,g] · bv[t,b,m,f]
    G[b,n,m,f,g] = att_mask[b,n,m]·sp1[b,n,m,f]·W2[f,g]·sp2[b,n,m,g]
                   + satq[b,n,m,f]·m_pre[b,n,m,g]

the dominant product of the edge-operator exact divergence
(``pita_torch/nets/egnn_fast.py``). The kernel of ``pita_torch/csrc/g_op.cu``
builds G on chip, so the (B, N, N, F, F) operator never reaches device
memory. Like the TPU kernel it rounds G and bv to bf16 for the product,
whatever the model's compute dtype, and accumulates in f32; the plain
version rounds the same way. ``att_mask`` and ``satq`` arrive pre-masked
(0 on the diagonal). The TPU kernel's ``rows_per_block``, its padding of N
and of the receiver rows, and its ``interpret`` flag are not carried over.

For a CUDA tensor the wrapper launches the kernel; for a CPU tensor it runs
the plain version.
"""

import ctypes
import functools

import torch

from pita_torch.ops import _build


def g_operator_contract_plain(sp1, sp2, att_mask, satq, m_pre, w2, bv):
    """Plain version: G materialized, rounded to bf16 like bv, then the
    einsum ``"bnmfg,tbmf->tbng"`` in f32."""
    K = sp1[..., :, None] * w2 * sp2[..., None, :]
    G = att_mask[..., None, None] * K + satq[..., :, None] * m_pre[..., None, :]
    G = G.to(torch.bfloat16).float()
    return torch.einsum("bnmfg,tbmf->tbng", G, bv.to(torch.bfloat16).float())


@functools.cache
def _lib():
    lib = _build.load("g_op")
    lib.pita_g_op_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.pita_g_op_smem_bytes.restype = ctypes.c_longlong
    lib.pita_g_op_contract.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.pita_g_op_contract.restype = ctypes.c_int
    return lib


def _check_inputs(sp1, sp2, att_mask, satq, m_pre, w2, bv):
    if sp1.dim() != 4 or sp1.shape[1] != sp1.shape[2]:
        raise ValueError(f"sp1 must be (B, N, N, F); got {tuple(sp1.shape)}")
    if bv.dim() != 4:
        raise ValueError(f"bv must be (T, B, N, F); got {tuple(bv.shape)}")
    B, N, _, F = sp1.shape
    T = bv.shape[0]
    shapes = [(sp2, (B, N, N, F)), (satq, (B, N, N, F)), (m_pre, (B, N, N, F)),
              (att_mask, (B, N, N)), (w2, (F, F)), (bv, (T, B, N, F))]
    for a, s in shapes:
        if tuple(a.shape) != s:
            raise ValueError(f"expected shape {s}, got {tuple(a.shape)}")
    for a in (sp1, sp2, att_mask, satq, m_pre, w2, bv):
        if a.dtype != torch.float32:
            raise TypeError(f"expected float32, got {a.dtype}")
        if a.device != sp1.device:
            raise ValueError("all inputs must be on one device")
    if sp1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sp1.device}")


def g_operator_contract(sp1, sp2, att_mask, satq, m_pre, w2, bv):
    """t2[t,b,n,g] = Σ_{m,f} G[b,n,m,f,g]·bv[t,b,m,f] without materializing G (K5).

    sp1, sp2, satq, m_pre: (B, N, N, F) f32 primal edge activations;
    att_mask: (B, N, N), the attention gate with the edge mask folded in
    (``satq`` pre-masked too); w2: (F, F); bv: (T, B, N, F) tangent node
    features. Returns (T, B, N, F) f32.
    """
    _check_inputs(sp1, sp2, att_mask, satq, m_pre, w2, bv)
    if sp1.device.type == "cpu":
        return g_operator_contract_plain(sp1, sp2, att_mask, satq, m_pre, w2, bv)
    B, N, _, F = sp1.shape
    T = bv.shape[0]
    lib = _lib()
    smem = lib.pita_g_op_smem_bytes(N, F)
    if smem == 0 or smem > 232448:
        raise ValueError(f"G-operator kernel does not support F={F}, N={N} "
                         f"(needs F in (16, 32) and {smem} <= 232448 bytes of shared memory)")
    args = [a.contiguous() for a in (sp1, sp2, att_mask, satq, m_pre, w2, bv)]
    out = torch.empty_like(args[-1])
    with torch.cuda.device(sp1.device):
        stream = torch.cuda.current_stream(sp1.device).cuda_stream
        err = lib.pita_g_op_contract(*(a.data_ptr() for a in args), out.data_ptr(),
                                     T, B, N, F, stream)
    _build.check(err, "g_operator_contract")
    g_operator_contract.launches += 1
    return out


g_operator_contract.launches = 0
