"""G-operator tangent contraction (kernel K5) with its plain version.

Counterpart of ``pita_tpu/ops/pallas/g_op.py:91 g_operator_contract``:

    t2[t,b,n,g] = Σ_{m,f} G[b,n,m,f,g] · bv[t,b,m,f]
    G[b,n,m,f,g] = att_mask[b,n,m]·sp1[b,n,m,f]·W2[f,g]·sp2[b,n,m,g]
                   + satq[b,n,m,f]·m_pre[b,n,m,g]

the dominant product of the edge-operator exact divergence
(``pita_torch/nets/egnn_fast.py``). The tensor-core kernel of
``pita_torch/csrc/g_op.cu`` builds G on chip, one sender at a time, into the
shared-memory operand tiles of its bf16 products, so the (B, N, N, F, F)
operator never reaches device memory. Like the TPU kernel it rounds G and bv to bf16 for the
product, whatever the model's compute dtype, and accumulates in f32; the
plain version rounds the same way. ``att_mask`` and ``satq`` arrive
pre-masked (0 on the diagonal). The TPU kernel's ``rows_per_block``, its
padding of N and of the receiver rows, and its ``interpret`` flag are not
carried over.

For a CUDA tensor ``g_operator_contract`` launches the tensor-core kernel
(N <= 64, F in {16, 32}; counter ``g_operator_contract.launches``); for a
CPU tensor it runs the plain version. ``_contract_scalar`` launches the
first, scalar kernel of the same file (counter ``_contract_scalar.launches``):
a yardstick for timing, reached by no caller of the sampler.
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


_MAX_N = 64  # the tensor-core kernel's limit (pita_g_op_contract)


@functools.cache
def _lib():
    lib = _build.load("g_op")
    lib.pita_g_op_contract.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.pita_g_op_contract.restype = ctypes.c_int
    lib.pita_g_op_panel_elems.argtypes = [ctypes.c_int] * 4
    lib.pita_g_op_panel_elems.restype = ctypes.c_longlong
    lib.pita_g_op_scalar_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.pita_g_op_scalar_smem_bytes.restype = ctypes.c_longlong
    lib.pita_g_op_contract_scalar.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.pita_g_op_contract_scalar.restype = ctypes.c_int
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


def _device_args(args):
    """Contiguous, and 16-byte aligned for the kernels' vector loads."""
    args = [a.contiguous() for a in args]
    return [a if a.data_ptr() % 16 == 0 else a.clone() for a in args]


def g_operator_contract(sp1, sp2, att_mask, satq, m_pre, w2, bv):
    """t2[t,b,n,g] = Σ_{m,f} G[b,n,m,f,g]·bv[t,b,m,f] without materializing G (K5).

    sp1, sp2, satq, m_pre: (B, N, N, F) f32 primal edge activations;
    att_mask: (B, N, N), the attention gate with the edge mask folded in
    (``satq`` pre-masked too); w2: (F, F); bv: (T, B, N, F) tangent node
    features. Returns (T, B, N, F) f32. On CUDA N <= 64 and F in (16, 32).
    """
    _check_inputs(sp1, sp2, att_mask, satq, m_pre, w2, bv)
    if sp1.device.type == "cpu":
        return g_operator_contract_plain(sp1, sp2, att_mask, satq, m_pre, w2, bv)
    B, N, _, F = sp1.shape
    T = bv.shape[0]
    if F not in (16, 32) or N > _MAX_N:
        raise ValueError(f"the tensor-core G-operator kernel takes F in (16, 32) and "
                         f"N <= {_MAX_N}; got F={F}, N={N}")
    lib = _lib()
    args = _device_args((sp1, sp2, att_mask, satq, m_pre, w2, bv))
    out = torch.empty_like(args[-1])
    # scratch for bv rounded to bf16 in the layout the products read it in
    panel = torch.empty(lib.pita_g_op_panel_elems(T, B, N, F), dtype=torch.bfloat16,
                        device=sp1.device)
    with torch.cuda.device(sp1.device):
        stream = torch.cuda.current_stream(sp1.device).cuda_stream
        err = lib.pita_g_op_contract(*(a.data_ptr() for a in args), panel.data_ptr(),
                                     out.data_ptr(), T, B, N, F, stream)
    _build.check(err, "g_operator_contract")
    g_operator_contract.launches += 1
    return out


def _contract_scalar(sp1, sp2, att_mask, satq, m_pre, w2, bv):
    """The same function by the first, scalar K5 kernel (f32 FMAs): the
    yardstick the tensor-core kernel is timed against. CUDA tensors only."""
    _check_inputs(sp1, sp2, att_mask, satq, m_pre, w2, bv)
    if sp1.device.type != "cuda":
        raise ValueError("_contract_scalar runs on CUDA tensors only")
    B, N, _, F = sp1.shape
    T = bv.shape[0]
    lib = _lib()
    smem = lib.pita_g_op_scalar_smem_bytes(N, F)
    if smem == 0 or smem > 232448:
        raise ValueError(f"the scalar G-operator kernel does not support F={F}, N={N} "
                         f"(needs F in (16, 32) and {smem} <= 232448 bytes of shared memory)")
    args = _device_args((sp1, sp2, att_mask, satq, m_pre, w2, bv))
    out = torch.empty_like(args[-1])
    with torch.cuda.device(sp1.device):
        stream = torch.cuda.current_stream(sp1.device).cuda_stream
        err = lib.pita_g_op_contract_scalar(*(a.data_ptr() for a in args), out.data_ptr(),
                                            T, B, N, F, stream)
    _build.check(err, "_contract_scalar")
    _contract_scalar.launches += 1
    return out


g_operator_contract.launches = 0
_contract_scalar.launches = 0
