"""One EGCL layer: CUDA kernels K2 (forward) and K3 (VJP) with plain versions.

Counterpart of ``pita_tpu/ops/pallas/egnn_fwd.py``: ``_layer_step``
(:85-136) is ``layer_step`` here; ``_layer_fwd_kernel`` (:153, called at
:318) and ``_layer_bwd_kernel`` (:169, called at :342) are the kernels of
``pita_torch/csrc/egnn_layer.cu`` (its header says what bounds them on the
H100 and how their design answers that). ``EGCLFunction`` takes the place of
the custom VJP of ``_get_layer_core`` (:425-452).

Layout: h (B, N, F), x (B, N, 3), edge_attr (B, N, N), all float32. The TPU
kernels' padding of N to 16 and their (B, 3, N) coordinate planes are not
carried over. Numerics follow ``_layer_step``: matmul inputs rounded to the
compute dtype, f32 accumulation, elementwise math in f32. In the VJP the
rounding counts as the identity (straight-through), so cotangents stay f32.

For a CUDA tensor each wrapper launches its kernel; for a CPU tensor it runs
the plain version.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from pita_torch.io.flax_params import W_FIELDS
from pita_torch.ops import _build

# weights that enter a matmul (_mm) and are rounded to the compute dtype
_MM_FIELDS = ("w_src", "w_dst", "w_e2", "w_c1", "w_n1", "w_n2")


def _round(a, cd):
    """Round to the compute dtype in value; the gradient passes straight through."""
    if cd == torch.float32:
        return a
    return a + (a.to(cd).float() - a).detach()


def _mm(a, b, cd):
    """a @ b with both inputs rounded to ``cd`` and an f32 result
    (egnn_fwd.py:57-64)."""
    return _round(a, cd) @ _round(b, cd)


def _sigmoid(z):
    """Overflow-safe logistic (egnn_fwd.py:67-72)."""
    return torch.exp(torch.clamp(z, max=0.0)) / (1.0 + torch.exp(-z.abs()))


def _silu(z):
    return z * _sigmoid(z)


def _silu_prime(z):
    s = _sigmoid(z)
    return s * (1 + z * (1 - s))


class LayerActs(NamedTuple):
    """Primal activations of one EGCL layer that its tangent map needs."""

    x_in: torch.Tensor  # (B, N, 3) layer input coordinates
    diff: torch.Tensor  # (B, N, N, 3) pairwise differences of x_in
    h_in: torch.Tensor  # (B, N, F) layer input node features
    norm: torch.Tensor  # (B, N, N)
    sp1: torch.Tensor  # silu'(z1)
    sp2: torch.Tensor  # silu'(z2)
    m_pre: torch.Tensor  # silu(z2) before attention
    att: torch.Tensor  # (B, N, N)
    sp_cz: torch.Tensor  # silu'(cz)
    cm: torch.Tensor  # (B, N, N) coordinate-MLP scalar
    w: torch.Tensor  # (B, N, N) masked a/(norm+1) coordinate weights
    sp_n: torch.Tensor  # (B, N, F) silu'(node hidden)


def layer_step(h, x, edge_attr, w, *, attention=True, tanh=True, coords_range=5.0,
               cd=torch.float32, with_acts=False):
    """Plain version of one EGCL layer; returns (h_out, x_out), and with
    ``with_acts`` also the ``LayerActs`` of this primal pass.

    h: (B, N, F); x: (B, N, 3); edge_attr: (B, N, N); w: dict of the 15
    weights in the JAX (in, out) layout.
    """
    N = x.shape[-2]
    mask = 1.0 - torch.eye(N, dtype=torch.float32, device=x.device)
    # direct differences: the identity |xi|^2 + |xj|^2 - 2 x.xT cancels for
    # close pairs, and the tangents amplify the error by 1/norm
    diff = x[..., :, None, :] - x[..., None, :, :]  # (B, N, N, 3)
    radial = (diff * diff).sum(-1)
    norm = torch.sqrt(radial + 1e-8)
    denom = norm + 1.0

    src = _mm(h, w["w_src"], cd) + w["b_src"]
    dst = _mm(h, w["w_dst"], cd)
    scal = radial[..., None] * w["w_scal"][0] + edge_attr[..., None] * w["w_scal"][1]
    z1 = src[..., :, None, :] + dst[..., None, :, :] + scal  # (B, N, N, F)
    z2 = _mm(_silu(z1), w["w_e2"], cd) + w["b_e2"]
    m_pre = _silu(z2)
    if attention:
        att = _sigmoid((m_pre * w["w_att"][:, 0]).sum(-1) + w["b_att"][0])
    else:
        att = torch.ones_like(m_pre[..., 0])
    m = m_pre * (att * mask)[..., None]

    cz = _mm(m, w["w_c1"], cd) + w["b_c1"]
    cm = (_silu(cz) * w["w_c2"][:, 0]).sum(-1)
    a = torch.tanh(cm) * coords_range if tanh else cm
    wgt = (a * mask) / denom  # (B, N, N)
    x_out = x + x * wgt.sum(-1)[..., None] - wgt @ x

    agg = m.sum(-2)  # (B, N, F)
    nz = _mm(torch.cat([h, agg], dim=-1), w["w_n1"], cd) + w["b_n1"]
    h_out = h + _mm(_silu(nz), w["w_n2"], cd) + w["b_n2"]
    if not with_acts:
        return h_out, x_out
    acts = LayerActs(
        x_in=x, diff=diff, h_in=h, norm=norm,
        sp1=_silu_prime(z1), sp2=_silu_prime(z2), m_pre=m_pre, att=att,
        sp_cz=_silu_prime(cz), cm=cm, w=wgt, sp_n=_silu_prime(nz),
    )
    return h_out, x_out, acts


def layer_vjp(h, x, edge_attr, gh, gx, w, **cfg):
    """Plain version of the VJP: autograd through ``layer_step``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (h, x, edge_attr)]
        h_out, x_out = layer_step(*ins, w, **cfg)
        return torch.autograd.grad((h_out, x_out), ins, (gh, gx))


def rounded_weights(w, cd) -> dict:
    """The weights as the matmuls see them: those that enter one rounded to
    ``cd``, all as f32."""
    if cd == torch.float32:
        return w
    return {f: (v.to(cd).float() if f in _MM_FIELDS else v) for f, v in w.items()}


def pack_weights(w, cd=torch.float32) -> torch.Tensor:
    """The 15 weights as one f32 buffer in the layout of csrc/egnn_common.cuh:
    each array flattened, padded to a multiple of 4 floats, matmul weights
    rounded to ``cd``."""
    w = rounded_weights(w, cd)
    parts = []
    for f in W_FIELDS:
        v = w[f].detach().float().reshape(-1)
        parts.append(torch.nn.functional.pad(v, (0, (-v.numel()) % 4)))
    return torch.cat(parts).contiguous()


@functools.cache
def _lib():
    lib = _build.load("egnn_layer")
    lib.pita_egcl_weights_len.argtypes = [ctypes.c_int]
    lib.pita_egcl_weights_len.restype = ctypes.c_int
    lib.pita_egcl_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.pita_egcl_smem_bytes.restype = ctypes.c_longlong
    lib.pita_egcl_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.pita_egcl_forward.restype = ctypes.c_int
    lib.pita_egcl_backward.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.pita_egcl_backward.restype = ctypes.c_int
    return lib


def _check_inputs(h, x, edge_attr, *cots):
    if h.dim() != 3 or x.dim() != 3 or x.shape[-1] != 3:
        raise ValueError(f"h must be (B, N, F) and x (B, N, 3); got {tuple(h.shape)}, "
                         f"{tuple(x.shape)}")
    B, N, F = h.shape
    shapes = [(x, (B, N, 3)), (edge_attr, (B, N, N))]
    if cots:
        shapes += [(cots[0], (B, N, F)), (cots[1], (B, N, 3))]
    for t, s in shapes:
        if tuple(t.shape) != s:
            raise ValueError(f"expected shape {s}, got {tuple(t.shape)}")
    for t in (h, x, edge_attr, *cots):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if t.device != h.device:
            raise ValueError("all inputs must be on one device")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")


def _kernel_args(h, packed, cfg, backward):
    B, N, F = h.shape
    lib = _lib()
    if packed.device != h.device or packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError("packed weights must be a contiguous f32 tensor on the inputs' device")
    if packed.numel() != lib.pita_egcl_weights_len(F) or packed.data_ptr() % 16:
        raise ValueError(f"packed weights do not match hidden width {F} (or are misaligned)")
    smem = lib.pita_egcl_smem_bytes(N, F, int(backward))
    if smem == 0 or smem > 232448:
        raise ValueError(f"EGCL kernel does not support F={F}, N={N} "
                         f"(needs F in (16, 32) and {smem} <= 232448 bytes of shared memory)")
    cd = cfg.get("cd", torch.float32)
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {cd}")
    return (B, N, F, int(cd == torch.bfloat16), int(cfg.get("attention", True)),
            int(cfg.get("tanh", True)), float(cfg.get("coords_range", 5.0)))


def egnn_layer_forward(h, x, edge_attr, w, packed=None, **cfg):
    """One EGCL layer forward (K2); returns (h_out, x_out).

    ``cfg``: attention, tanh, coords_range, cd. ``packed``: the output of
    ``pack_weights(w, cd)`` on the inputs' device, built here if not given.
    """
    _check_inputs(h, x, edge_attr)
    if h.device.type == "cpu":
        with torch.no_grad():
            return layer_step(h, x, edge_attr, w, **cfg)
    if packed is None:
        packed = pack_weights(w, cfg.get("cd", torch.float32)).to(h.device)
    args = _kernel_args(h, packed, cfg, backward=False)
    h, x, edge_attr = (t.contiguous() for t in (h, x, edge_attr))
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib().pita_egcl_forward(
            h.data_ptr(), x.data_ptr(), edge_attr.data_ptr(), packed.data_ptr(),
            h_out.data_ptr(), x_out.data_ptr(), *args, stream,
        )
    _build.check(err, "egnn_layer_forward")
    egnn_layer_forward.launches += 1
    return h_out, x_out


def egnn_layer_backward(h, x, edge_attr, gh, gx, w, packed=None, **cfg):
    """VJP of one EGCL layer with respect to (h, x, edge_attr) (K3);
    returns (dh, dx, dea)."""
    _check_inputs(h, x, edge_attr, gh, gx)
    if h.device.type == "cpu":
        return layer_vjp(h, x, edge_attr, gh, gx, w, **cfg)
    if packed is None:
        packed = pack_weights(w, cfg.get("cd", torch.float32)).to(h.device)
    args = _kernel_args(h, packed, cfg, backward=True)
    h, x, edge_attr, gh, gx = (t.contiguous() for t in (h, x, edge_attr, gh, gx))
    dh, dx, dea = torch.empty_like(h), torch.empty_like(x), torch.empty_like(edge_attr)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib().pita_egcl_backward(
            h.data_ptr(), x.data_ptr(), edge_attr.data_ptr(), gh.data_ptr(),
            gx.data_ptr(), packed.data_ptr(), dh.data_ptr(), dx.data_ptr(),
            dea.data_ptr(), *args, stream,
        )
    _build.check(err, "egnn_layer_backward")
    egnn_layer_backward.launches += 1
    return dh, dx, dea


egnn_layer_forward.launches = 0
egnn_layer_backward.launches = 0


class EGCLFunction(torch.autograd.Function):
    """One EGCL layer, differentiable in (h, x, edge_attr) only.

    The forward runs K2 and saves only its inputs; the backward runs K3,
    which rebuilds the edge tensors on chip. Weights get no gradient
    (inference only): a weight that requires grad raises.
    """

    @staticmethod
    def forward(ctx, h, x, edge_attr, layer):
        if any(p.requires_grad for p in layer.parameters()):
            raise RuntimeError("EGCLFunction is inference-only: weights must not require grad")
        ctx.layer = layer
        ctx.save_for_backward(h, x, edge_attr)
        return egnn_layer_forward(h, x, edge_attr, layer.weights(),
                                  packed=layer.packed(h.device), **layer.cfg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gh, gx):
        h, x, edge_attr = ctx.saved_tensors
        layer = ctx.layer
        dh, dx, dea = egnn_layer_backward(
            h, x, edge_attr, gh.contiguous(), gx.contiguous(), layer.weights(),
            packed=layer.packed(h.device), **layer.cfg,
        )
        return dh, dx, dea, None
