"""One EGCL layer's tangent map (kernel K4) and the forward-mode Jacobian trace.

Counterpart of ``pita_tpu/ops/pallas/egnn_fwd.py``: ``_layer_tan_kernel``
(:195-239, called through ``_layer_tan_call`` :360) is the kernel of
``pita_torch/csrc/egnn_tangent.cu`` (its header says what bounds it on the
H100 and what its design does about that), ``egnn_jacobian_trace_pallas``
(:501-559) is ``egnn_jacobian_trace_fused`` here.

The layer of ``pita_torch.ops.egnn_layer.layer_step`` is linearized at its
primal inputs (h, x, edge_attr) and a chunk of tangents (dh, dx, dea) pushed
through; the edge-attribute tangent is rebuilt from the original coordinates
``xs0`` and the one-hot basis ``e``: ``dea[i,j] = 2·Σ_d diff0[i,j,d]·(e[i,d] −
e[j,d])``. As under ``jax.linearize``, the tangent of a matmul input is itself
rounded to the compute dtype (the layer VJP, K3, treats that rounding as the
identity; in forward mode the port follows JAX). Layout: primal h (B, N, F),
x and xs0 (B, N, 3), edge_attr (B, N, N); basis (Tc, N, 3); tangents dh
(B, Tc, N, F), dx (B, Tc, N, 3); all float32. The TPU kernel's (3, Np)
coordinate planes, its padding of N to 16 and of the tangent chunk, and its
``interpret`` flag are not carried over.

For a CUDA tensor the wrapper launches the kernel; for a CPU tensor it runs
the plain version.
"""

import ctypes
import functools

import torch

from pita_torch.ops import _build
from pita_torch.ops.egnn_layer import (_kernel_args, egnn_layer_forward, layer_step, pack_weights,
                                       rounded_weights)


def _rt(a, cd):
    """Round to the compute dtype (value and tangent alike)."""
    return a if cd == torch.float32 else a.to(cd).float()


def layer_tangent(h, x, edge_attr, xs0, basis, dh, dx, w, *, attention=True, tanh=True,
                  coords_range=5.0, cd=torch.float32):
    """Plain version of the layer's tangent map: the linearization of
    ``layer_step`` written out; returns (dh_out, dx_out).

    All (B, Tc, N, N, F) tangent edge tensors are materialized: chunk the
    tangents (or the chains) where memory is short.
    """
    N = x.shape[-2]
    w = rounded_weights(w, cd)
    w_r, w_e = w["w_scal"][0], w["w_scal"][1]
    mask = 1.0 - torch.eye(N, dtype=torch.float32, device=x.device)

    # primal pass, keeping what the tangents need
    _, _, acts = layer_step(h, x, edge_attr, w, attention=attention, tanh=tanh,
                            coords_range=coords_range, cd=cd, with_acts=True)
    diff, norm, sp1, sp2, m_pre, att, sp_cz, wgt, sp_n = (
        acts.diff, acts.norm, acts.sp1, acts.sp2, acts.m_pre, acts.att, acts.sp_cz, acts.w,
        acts.sp_n)
    denom = norm + 1.0
    th = torch.tanh(acts.cm)

    # tangents; the tangent axis sits at dim 1
    ddiff = dx[:, :, :, None, :] - dx[:, :, None, :, :]  # (B, Tc, N, N, 3)
    c = 2 * (diff[:, None] * ddiff).sum(-1)  # d radial, (B, Tc, N, N)
    diff0 = xs0[:, :, None, :] - xs0[:, None, :, :]
    de = basis[:, :, None, :] - basis[:, None, :, :]  # (Tc, N, N, 3)
    e = 2 * (diff0[:, None] * de[None]).sum(-1)  # d edge_attr
    dhr = _rt(dh, cd)
    dsrc, ddst = dhr @ w["w_src"], dhr @ w["w_dst"]
    dz1 = (dsrc[:, :, :, None, :] + ddst[:, :, None, :, :]
           + c[..., None] * w_r + e[..., None] * w_e)  # (B, Tc, N, N, F)
    dm_pre = sp2[:, None] * (_rt(sp1[:, None] * dz1, cd) @ w["w_e2"])
    dm = dm_pre * att[:, None, :, :, None]
    if attention:
        datt = (att * (1 - att))[:, None] * (dm_pre * w["w_att"][:, 0]).sum(-1)
        dm = dm + m_pre[:, None] * datt[..., None]
    dm = dm * mask[..., None]
    dcm = (sp_cz[:, None] * (_rt(dm, cd) @ w["w_c1"]) * w["w_c2"][:, 0]).sum(-1)
    da = (coords_range * (1 - th * th))[:, None] * dcm if tanh else dcm
    # w = a·mask/(norm+1): d_w = (d_a·mask − w·d_norm)/(norm+1), d_norm = c/(2·norm)
    dw = (da * mask - wgt[:, None] * (c / (2 * norm[:, None]))) / denom[:, None]
    dx_out = (dx + dx * wgt.sum(-1)[:, None, :, None] + x[:, None] * dw.sum(-1)[..., None]
              - dw @ x[:, None] - wgt[:, None] @ dx)
    dagg = dm.sum(-2)
    dnz = _rt(torch.cat([dh, dagg], dim=-1), cd) @ w["w_n1"]
    dh_out = dh + _rt(sp_n[:, None] * dnz, cd) @ w["w_n2"]
    return dh_out, dx_out


@functools.cache
def _lib():
    lib = _build.load("egnn_tangent")
    lib.pita_egcl_tangent_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.pita_egcl_tangent_smem_bytes.restype = ctypes.c_longlong
    lib.pita_egcl_tangent.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.pita_egcl_tangent.restype = ctypes.c_int
    return lib


def _check_inputs(h, x, edge_attr, xs0, basis, dh, dx):
    if h.dim() != 3 or dh.dim() != 4:
        raise ValueError(f"h must be (B, N, F) and dh (B, Tc, N, F); got {tuple(h.shape)}, "
                         f"{tuple(dh.shape)}")
    B, N, F = h.shape
    Tc = dh.shape[1]
    shapes = [(x, (B, N, 3)), (edge_attr, (B, N, N)), (xs0, (B, N, 3)), (basis, (Tc, N, 3)),
              (dh, (B, Tc, N, F)), (dx, (B, Tc, N, 3))]
    for a, s in shapes:
        if tuple(a.shape) != s:
            raise ValueError(f"expected shape {s}, got {tuple(a.shape)}")
    for a in (h, x, edge_attr, xs0, basis, dh, dx):
        if a.dtype != torch.float32:
            raise TypeError(f"expected float32, got {a.dtype}")
        if a.device != h.device:
            raise ValueError("all inputs must be on one device")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")


def egnn_layer_tangent(h, x, edge_attr, xs0, basis, dh, dx, w, packed=None,
                       tangent_chunk: int = 8, **cfg):
    """One EGCL layer's tangent map for a chunk of tangents (K4); returns
    (dh_out, dx_out).

    ``cfg``: attention, tanh, coords_range, cd. ``packed``: the output of
    ``pack_weights(w, cd)`` on the inputs' device, built here if not given.
    ``tangent_chunk``: tangents one block of the kernel takes in turn.
    """
    _check_inputs(h, x, edge_attr, xs0, basis, dh, dx)
    if h.device.type == "cpu":
        with torch.no_grad():
            return layer_tangent(h, x, edge_attr, xs0, basis, dh, dx, w, **cfg)
    if tangent_chunk < 1:
        raise ValueError(f"tangent_chunk must be positive, got {tangent_chunk}")
    if packed is None:
        packed = pack_weights(w, cfg.get("cd", torch.float32)).to(h.device)
    B, N, F, *flags = _kernel_args(h, packed, cfg, backward=False)
    Tc = dh.shape[1]
    lib = _lib()
    smem = lib.pita_egcl_tangent_smem_bytes(N, F)
    if smem == 0 or smem > 232448:
        raise ValueError(f"EGCL tangent kernel does not support F={F}, N={N} "
                         f"({smem} > 232448 bytes of shared memory)")
    args = [a.contiguous() for a in (h, x, edge_attr, xs0, basis, dh, dx)]
    dh_out, dx_out = torch.empty_like(args[5]), torch.empty_like(args[6])
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.pita_egcl_tangent(
            *(a.data_ptr() for a in args), packed.data_ptr(), dh_out.data_ptr(),
            dx_out.data_ptr(), B, Tc, int(tangent_chunk), N, F, *flags, stream,
        )
    _build.check(err, "egnn_layer_tangent")
    egnn_layer_tangent.launches += 1
    return dh_out, dx_out


egnn_layer_tangent.launches = 0


@torch.no_grad()
def egnn_jacobian_trace_fused(backbone, t, x_flat, beta, tangent_chunk: int = 8,
                              super_chunk: int = 64):
    """tr dF/dx of the EGNN backbone in forward mode, (B,).

    The primal runs through the layer forward (K2 on CUDA) keeping each
    layer's input state; the D = N·3 one-hot coordinate tangents then run
    through each layer's tangent map (K4 on CUDA) in super-chunks of
    ``super_chunk`` tangents resident in device memory at a time, a block of
    the kernel taking ``tangent_chunk`` of them. The mean-free projection and
    the pick of the diagonal are plain torch.
    """
    B = x_flat.shape[0]
    N, F = backbone.n_particles, backbone.hidden_nf
    D = N * 3
    dev = x_flat.device
    xs = x_flat.reshape(B, N, 3).contiguous()
    h = backbone.embed(t, x_flat, beta).contiguous()
    diff0 = xs[:, :, None, :] - xs[:, None, :, :]
    ea = (diff0 * diff0).sum(-1).contiguous()

    packs = [layer.packed(dev) if dev.type == "cuda" else None for layer in backbone.layers]
    states, xc = [], xs
    for layer, packed in zip(backbone.layers, packs):
        states.append((h, xc))
        h, xc = egnn_layer_forward(h, xc, ea, layer.weights(), packed=packed, **layer.cfg)

    eye = torch.eye(D, dtype=torch.float32, device=dev)
    trace = torch.zeros(B, device=dev)
    for start in range(0, D, super_chunk):
        basis = eye[start:start + super_chunk].reshape(-1, N, 3)  # (Tc, N, 3)
        dh = torch.zeros(B, basis.shape[0], N, F, device=dev)
        dx = basis[None].expand(B, -1, -1, -1).contiguous()
        for layer, packed, (h_l, x_l) in zip(backbone.layers, packs, states):
            dh, dx = egnn_layer_tangent(h_l, x_l, ea, xs, basis, dh, dx, layer.weights(),
                                        packed=packed, tangent_chunk=tangent_chunk,
                                        **layer.cfg)
        dvel = dx - basis[None]
        dvel = dvel - dvel.mean(dim=2, keepdim=True)
        trace = trace + (dvel * basis[None]).sum(dim=(1, 2, 3))
    return trace
