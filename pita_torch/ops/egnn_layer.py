"""One EGCL layer: CUDA kernels K2 (forward) and K3 (VJP) with plain versions.

Counterpart of ``pita_tpu/ops/pallas/egnn_fwd.py``: ``_layer_step``
(:85-136) is ``layer_step`` here; ``_layer_fwd_kernel`` (:153, called at
:318) and ``_layer_bwd_kernel`` (:169, called at :342) are the kernels of
``pita_torch/csrc/egnn_layer.cu`` and of the tensor-core sources named below
(each header says what bounds its kernel on the H100 and how its design
answers that). ``EGCLFunction`` takes the place of
the custom VJP of ``_get_layer_core`` (:425-452).

Layout: h (B, N, F), x (B, N, 3), edge_attr (B, N, N), all float32. The TPU
kernels' padding of N to 16 and their (B, 3, N) coordinate planes are not
carried over. Numerics follow ``_layer_step``: matmul inputs rounded to the
compute dtype, f32 accumulation, elementwise math in f32. In the VJP the
rounding counts as the identity (straight-through), so cotangents stay f32.

For a CUDA tensor each wrapper launches its kernel; for a CPU tensor it runs
the plain version. The compute dtype and the shape choose the kernel:

- bf16: the tensor-core kernels of ``csrc/egnn_layer_tc.cu``
  (``egnn_layer_forward_tc``, ``egnn_layer_backward_tc``; N <= 64, else
  ``ValueError``). The VJP reads the aggregate agg_i = sum_j m_ij that the
  forward summed (``with_agg``, ``agg``) instead of rebuilding it;
- f32 K2: the 3xTF32 tensor-core kernel of ``csrc/egnn_layer_f32tc.cu``
  (``egnn_layer_forward_tf32``) where ``tf32_takes(N, F)``, F in (16, 32) and
  N <= 64 (the lj13 and lj55 presets), else the scalar ``egcl_fwd_kernel`` of
  ``csrc/egnn_layer.cu`` (``_forward_scalar``);
- f32 K3: the 3xTF32 tensor-core kernel of ``csrc/egnn_layer_bwd_f32tc.cu``
  (``egnn_layer_backward_tf32``) where ``tf32_takes(N, F)``, else the scalar
  ``egcl_bwd_kernel`` of ``csrc/egnn_layer.cu`` (``_backward_scalar``).
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


def pack_weights_tc(w) -> torch.Tensor:
    """The bf16 matrices of the tensor-core forward and VJP in the layout of
    ``csrc/egnn_layer_tc.cu:tcoff``: for each product Y = A M, the transpose
    of M row by row, each row padded by 8 elements, all rounded to bf16."""
    e2, c1, ws, wd, n1, n2 = (w[f].detach().float().to(torch.bfloat16)
                              for f in ("w_e2", "w_c1", "w_src", "w_dst", "w_n1", "w_n2"))
    mats = (e2.T, c1.T, e2, c1, torch.cat([ws.T, wd.T]), n1.T, n2, n1, torch.cat([ws, wd], 1),
            n2.T)
    return torch.cat([torch.nn.functional.pad(m, (0, 8)).reshape(-1) for m in mats]).contiguous()


def tf32_split(a):
    """``a`` (f32) as ``hi + lo``: hi rounded to TF32 (10 mantissa bits, to
    nearest, ties away from zero), lo = a - hi rounded the same way. Both are
    exact TF32 values (their low 13 bits are 0); hi + lo is a to ~2^-21."""
    def rnd(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    a = a.detach().float()
    hi = rnd(a)
    return hi, rnd(a - hi)


def _frag_tf32(m):
    """M (K, NO) in the fragment layout of ``csrc/mma_tf32.cuh``, flattened:
    for each (n-tile, k-step, lane = 4 g + t) the four floats hi M[k][n],
    hi M[k + 1][n], lo M[k][n], lo M[k + 1][n], k = 8 ks + 2 t, n = 8 nt + g."""
    K, NO = m.shape
    hi, lo = tf32_split(m)
    # k = 8 ks + 2 t + e and n = 8 nt + g, to the order (nt, ks, g, t, e)
    frag = lambda v: v.reshape(K // 8, 4, 2, NO // 8, 8).permute(3, 0, 4, 1, 2)
    return torch.cat([frag(hi), frag(lo)], -1).reshape(-1)


def pack_weights_tf32(w) -> torch.Tensor:
    """The f32 matrices of the 3xTF32 kernels (``egnn_layer_forward_tf32``,
    ``egnn_layer_backward_tf32``, ``egnn_tangent.egnn_layer_tangent_tf32``) in
    the layout of ``csrc/mma_tf32.cuh:tfoff``: W_e2, W_c1, W_c1^T, [W_src |
    W_dst], W_n1, W_n2, then the VJP's W_e2^T, W_n2^T, W_n1^T and [W_src^T ;
    W_dst^T], each split into TF32 hi + lo and laid out by ``_frag_tf32``."""
    e2, c1, ws, wd, n1, n2 = (w[f].detach().float()
                              for f in ("w_e2", "w_c1", "w_src", "w_dst", "w_n1", "w_n2"))
    mats = (e2, c1, c1.T, torch.cat([ws, wd], 1), n1, n2,
            e2.T, n2.T, n1.T, torch.cat([ws.T, wd.T], 0))
    return torch.cat([_frag_tf32(m) for m in mats]).contiguous()


# the largest N of the 3xTF32 kernels, mirrored from csrc/egnn_layer_f32tc.cu,
# csrc/egnn_layer_bwd_f32tc.cu and csrc/egnn_tangent_f32tc.cu: four 16-node
# tiles
TF32_MAX_N = 64


def tf32_takes(N: int, F: int) -> bool:
    """The rule that sends an f32 K2, K3 or K4 launch to its 3xTF32
    tensor-core kernel: F in (16, 32) and N <= 64; a larger N goes to the
    scalar kernel."""
    return F in (16, 32) and N <= TF32_MAX_N


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


@functools.cache
def _lib_tc():
    lib = _build.load("egnn_layer_tc")
    lib.pita_egcl_tc_weights_len.argtypes = [ctypes.c_int]
    lib.pita_egcl_tc_weights_len.restype = ctypes.c_int
    lib.pita_egcl_tc_max_n.argtypes = []
    lib.pita_egcl_tc_max_n.restype = ctypes.c_int
    lib.pita_egcl_backward_tc.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.pita_egcl_backward_tc.restype = ctypes.c_int
    lib.pita_egcl_forward_tc.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.pita_egcl_forward_tc.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_tf32():
    lib = _build.load("egnn_layer_f32tc")
    lib.pita_egcl_tf32_weights_len.argtypes = [ctypes.c_int]
    lib.pita_egcl_tf32_weights_len.restype = ctypes.c_int
    lib.pita_egcl_tf32_max_n.argtypes = []
    lib.pita_egcl_tf32_max_n.restype = ctypes.c_int
    lib.pita_egcl_forward_tf32.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.pita_egcl_forward_tf32.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd_tf32():
    lib = _build.load("egnn_layer_bwd_f32tc")
    lib.pita_egcl_bwd_tf32_max_n.argtypes = []
    lib.pita_egcl_bwd_tf32_max_n.restype = ctypes.c_int
    lib.pita_egcl_backward_tf32.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.pita_egcl_backward_tf32.restype = ctypes.c_int
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
    """The scalar arguments of a launch; ``backward`` None skips the scalar
    kernels' shared-memory check."""
    B, N, F = h.shape
    lib = _lib()
    if packed.device != h.device or packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError("packed weights must be a contiguous f32 tensor on the inputs' device")
    if packed.numel() != lib.pita_egcl_weights_len(F) or packed.data_ptr() % 16:
        raise ValueError(f"packed weights do not match hidden width {F} (or are misaligned)")
    smem = 1 if backward is None else lib.pita_egcl_smem_bytes(N, F, int(backward))
    if smem == 0 or smem > 232448:
        raise ValueError(f"EGCL kernel does not support F={F}, N={N} "
                         f"(needs F in (16, 32) and {smem} <= 232448 bytes of shared memory)")
    cd = cfg.get("cd", torch.float32)
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {cd}")
    return (B, N, F, int(cd == torch.bfloat16), int(cfg.get("attention", True)),
            int(cfg.get("tanh", True)), float(cfg.get("coords_range", 5.0)))


def egnn_layer_forward(h, x, edge_attr, w, packed=None, packed_tc=None, with_agg=False, **cfg):
    """One EGCL layer forward (K2); returns (h_out, x_out), and with
    ``with_agg`` (bf16 only) also the aggregate that
    ``egnn_layer_backward`` reads.

    ``cfg``: attention, tanh, coords_range, cd. ``packed``: the output of
    ``pack_weights(w, cd)`` on the inputs' device, built here if not given.
    On CUDA the compute dtype and the shape pick the kernel: bf16 runs the
    tensor-core kernel (``egnn_layer_forward_tc``, ``packed_tc`` from
    ``pack_weights_tc``); f32 the 3xTF32 tensor-core kernel
    (``egnn_layer_forward_tf32``, ``packed_tc`` from ``pack_weights_tf32``)
    where ``tf32_takes(N, F)`` (F in (16, 32), N <= 64), else the scalar
    kernel, whose launches this function counts.
    """
    cd = cfg.get("cd", torch.float32)
    if cd == torch.bfloat16:
        return egnn_layer_forward_tc(h, x, edge_attr, w, packed=packed, packed_tc=packed_tc,
                                     with_agg=with_agg, **cfg)
    if with_agg:
        raise ValueError("only the bf16 EGCL forward hands its aggregate to the VJP")
    if cd == torch.float32 and tf32_takes(h.shape[-2], h.shape[-1]):
        return egnn_layer_forward_tf32(h, x, edge_attr, w, packed=packed, packed_tc=packed_tc,
                                       **cfg)
    return _forward_scalar(h, x, edge_attr, w, packed, **cfg)


def _forward_scalar(h, x, edge_attr, w, packed=None, **cfg):
    """The scalar K2 (``egcl_fwd_kernel``) in either compute dtype, counted
    on ``egnn_layer_forward.launches``: ``egnn_layer_forward``'s f32 route
    for shapes ``tf32_takes`` refuses. The f32 shapes it takes and bf16 reach
    it only when called directly, to time it against the tensor-core
    kernels."""
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


def egnn_layer_backward(h, x, edge_attr, gh, gx, w, packed=None, packed_tc=None, agg=None,
                        **cfg):
    """VJP of one EGCL layer with respect to (h, x, edge_attr) (K3);
    returns (dh, dx, dea).

    On CUDA the compute dtype and the shape pick the kernel: bf16 runs the
    tensor-core kernel (``egnn_layer_backward_tc``, ``packed_tc`` from
    ``pack_weights_tc``), which needs ``agg``, the aggregate of
    ``egnn_layer_forward(..., with_agg=True)`` on the same inputs; f32 the
    3xTF32 tensor-core kernel (``egnn_layer_backward_tf32``, ``packed_tc``
    from ``pack_weights_tf32``) where ``tf32_takes(N, F)`` (F in (16, 32),
    N <= 64), else the scalar kernel, whose launches this function counts.
    """
    cd = cfg.get("cd", torch.float32)
    if cd == torch.bfloat16:
        return egnn_layer_backward_tc(h, x, edge_attr, gh, gx, w, packed=packed,
                                      packed_tc=packed_tc, agg=agg, **cfg)
    if agg is not None:
        raise ValueError("only the bf16 EGCL VJP reads the forward's aggregate")
    if cd == torch.float32 and tf32_takes(h.shape[-2], h.shape[-1]):
        return egnn_layer_backward_tf32(h, x, edge_attr, gh, gx, w, packed=packed,
                                        packed_tc=packed_tc, **cfg)
    return _backward_scalar(h, x, edge_attr, gh, gx, w, packed, **cfg)


def _backward_scalar(h, x, edge_attr, gh, gx, w, packed=None, **cfg):
    """The scalar K3 (``egcl_bwd_kernel``) in either compute dtype, counted
    on ``egnn_layer_backward.launches``: ``egnn_layer_backward``'s f32 route
    for shapes ``tf32_takes`` refuses. The f32 shapes it takes and bf16 reach
    it only when called directly, to time it against the tensor-core
    kernels."""
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


def _tc_launch_args(h, w, packed, packed_tc, cfg, what):
    """The library and the leading arguments of a tensor-core launch:
    (lib, packed, packed_tc, (B, N, F, attention, tanh, coords_range)).
    Raises on F outside (16, 32), N above the kernels' limit, or a
    ``packed_tc`` that is not ``pack_weights_tc(w)`` on the inputs' device."""
    B, N, F = h.shape
    lib = _lib_tc()
    if F not in (16, 32) or N > lib.pita_egcl_tc_max_n():
        raise ValueError(f"the tensor-core EGCL {what} takes F in (16, 32) and N <= "
                         f"{lib.pita_egcl_tc_max_n()}; got F={F}, N={N}")
    if packed is None:
        packed = pack_weights(w, torch.bfloat16).to(h.device)
    if packed_tc is None:
        packed_tc = pack_weights_tc(w).to(h.device)
    args = _kernel_args(h, packed, cfg, backward=None)
    if (packed_tc.device != h.device or packed_tc.dtype != torch.bfloat16
            or not packed_tc.is_contiguous() or packed_tc.data_ptr() % 16
            or packed_tc.numel() != lib.pita_egcl_tc_weights_len(F)):
        raise ValueError(f"packed_tc must be pack_weights_tc(w) for hidden width {F}, "
                         "contiguous and 16-byte aligned on the inputs' device")
    return lib, packed, packed_tc, (B, N, F, *args[4:])


def _tf32_launch_args(h, w, packed, packed_tc, cfg, what):
    """The leading arguments of a 3xTF32 launch: (packed, packed_tc, (B, N,
    F, attention, tanh, coords_range)). Raises on a compute dtype other than
    f32, on a shape ``tf32_takes`` refuses, or on a ``packed_tc`` that is not
    ``pack_weights_tf32(w)`` on the inputs' device."""
    B, N, F = h.shape
    if cfg.get("cd", torch.float32) != torch.float32:
        raise ValueError(f"the 3xTF32 EGCL {what} computes in f32 only")
    if not tf32_takes(N, F):
        raise ValueError(f"the 3xTF32 EGCL {what} takes F in (16, 32) and N <= {TF32_MAX_N}; "
                         f"got F={F}, N={N}")
    if packed is None:
        packed = pack_weights(w).to(h.device)
    if packed_tc is None:
        packed_tc = pack_weights_tf32(w).to(h.device)
    args = _kernel_args(h, packed, cfg, backward=None)
    if (packed_tc.device != h.device or packed_tc.dtype != torch.float32
            or not packed_tc.is_contiguous() or packed_tc.data_ptr() % 16
            or packed_tc.numel() != _lib_tf32().pita_egcl_tf32_weights_len(F)):
        raise ValueError(f"packed_tc must be pack_weights_tf32(w) for hidden width {F}, "
                         "contiguous and 16-byte aligned on the inputs' device")
    return packed, packed_tc, (B, N, F, *args[4:])


def egnn_layer_forward_tf32(h, x, edge_attr, w, packed=None, packed_tc=None, **cfg):
    """K2 in f32 on tensor cores, its products in 3xTF32
    (``csrc/egnn_layer_f32tc.cu``); returns (h_out, x_out). Takes F in (16,
    32) and N up to 64; raises on anything else, and on a compute dtype other
    than f32. On CPU tensors it runs the plain version, at any shape."""
    _check_inputs(h, x, edge_attr)
    if h.device.type == "cpu":
        with torch.no_grad():
            return layer_step(h, x, edge_attr, w, **cfg)
    packed, packed_tc, args = _tf32_launch_args(h, w, packed, packed_tc, cfg, "forward")
    h, x, edge_attr = (t.contiguous() for t in (h, x, edge_attr))
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib_tf32().pita_egcl_forward_tf32(
            h.data_ptr(), x.data_ptr(), edge_attr.data_ptr(), packed.data_ptr(),
            packed_tc.data_ptr(), h_out.data_ptr(), x_out.data_ptr(), *args, stream,
        )
    _build.check(err, "egnn_layer_forward_tf32")
    egnn_layer_forward_tf32.launches += 1
    return h_out, x_out


def egnn_layer_backward_tf32(h, x, edge_attr, gh, gx, w, packed=None, packed_tc=None, **cfg):
    """K3 in f32 on tensor cores, its products in 3xTF32
    (``csrc/egnn_layer_bwd_f32tc.cu``); returns (dh, dx, dea). Takes F in
    (16, 32) and N up to 64; raises on anything else, and on a compute dtype
    other than f32. On CPU tensors it runs the plain version, at any shape."""
    _check_inputs(h, x, edge_attr, gh, gx)
    if h.device.type == "cpu":
        return layer_vjp(h, x, edge_attr, gh, gx, w, **cfg)
    packed, packed_tc, args = _tf32_launch_args(h, w, packed, packed_tc, cfg, "VJP")
    h, x, edge_attr, gh, gx = (t.contiguous() for t in (h, x, edge_attr, gh, gx))
    dh, dx, dea = torch.empty_like(h), torch.empty_like(x), torch.empty_like(edge_attr)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib_bwd_tf32().pita_egcl_backward_tf32(
            h.data_ptr(), x.data_ptr(), edge_attr.data_ptr(), gh.data_ptr(),
            gx.data_ptr(), packed.data_ptr(), packed_tc.data_ptr(), dh.data_ptr(),
            dx.data_ptr(), dea.data_ptr(), *args, stream,
        )
    _build.check(err, "egnn_layer_backward_tf32")
    egnn_layer_backward_tf32.launches += 1
    return dh, dx, dea


def _check_bf16(cfg, what):
    if cfg.get("cd", torch.float32) != torch.bfloat16:
        raise ValueError(f"the tensor-core EGCL {what} computes in bf16 only")


def _aggregate(acts):
    """agg_i = sum_j m_ij of a ``layer_step`` pass, from its ``LayerActs``:
    the same operations as ``layer_step``'s own sum."""
    N = acts.att.shape[-1]
    mask = 1.0 - torch.eye(N, dtype=torch.float32, device=acts.att.device)
    return (acts.m_pre * (acts.att * mask)[..., None]).sum(-2)


def egnn_layer_forward_tc(h, x, edge_attr, w, packed=None, packed_tc=None, with_agg=False,
                          **cfg):
    """K2 in bf16 compute on tensor cores (``csrc/egnn_layer_tc.cu``); returns
    (h_out, x_out), and with ``with_agg`` also the aggregate agg_i = sum_j
    m_ij (B, N, F), f32 as the kernel summed it, which
    ``egnn_layer_backward_tc`` reads. Takes F in (16, 32) and N up to 64;
    raises on anything else, and on a compute dtype other than bf16."""
    _check_inputs(h, x, edge_attr)
    _check_bf16(cfg, "forward")
    if h.device.type == "cpu":
        with torch.no_grad():
            if not with_agg:
                return layer_step(h, x, edge_attr, w, **cfg)
            h_out, x_out, acts = layer_step(h, x, edge_attr, w, with_acts=True, **cfg)
            return h_out, x_out, _aggregate(acts)
    lib, packed, packed_tc, args = _tc_launch_args(h, w, packed, packed_tc, cfg, "forward")
    h, x, edge_attr = (t.contiguous() for t in (h, x, edge_attr))
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    agg = torch.empty_like(h) if with_agg else None
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.pita_egcl_forward_tc(
            h.data_ptr(), x.data_ptr(), edge_attr.data_ptr(), packed.data_ptr(),
            packed_tc.data_ptr(), h_out.data_ptr(), x_out.data_ptr(),
            None if agg is None else agg.data_ptr(), *args, stream,
        )
    _build.check(err, "egnn_layer_forward_tc")
    egnn_layer_forward_tc.launches += 1
    return (h_out, x_out) if agg is None else (h_out, x_out, agg)


def _check_agg(h, agg):
    """Raises unless ``agg`` is an f32 (B, N, F) tensor on h's device."""
    if agg is None:
        raise ValueError("the tensor-core EGCL VJP needs agg, the aggregate of "
                         "egnn_layer_forward_tc(..., with_agg=True) on the same inputs")
    if tuple(agg.shape) != tuple(h.shape) or agg.dtype != torch.float32 or agg.device != h.device:
        raise ValueError(f"agg must be f32 {tuple(h.shape)} on {h.device}; got {agg.dtype} "
                         f"{tuple(agg.shape)} on {agg.device}")


def egnn_layer_backward_tc(h, x, edge_attr, gh, gx, w, packed=None, packed_tc=None, agg=None,
                           **cfg):
    """K3 in bf16 compute on tensor cores (``csrc/egnn_layer_tc.cu``); returns
    (dh, dx, dea). ``agg`` is the aggregate that ``egnn_layer_forward_tc(...,
    with_agg=True)`` returned for the same inputs; the kernel reads it and
    does not rebuild it. Takes F in (16, 32) and N up to 64; raises on
    anything else, on a compute dtype other than bf16, and on a missing or
    ill-shaped ``agg``."""
    _check_inputs(h, x, edge_attr, gh, gx)
    _check_bf16(cfg, "VJP")
    _check_agg(h, agg)
    if h.device.type == "cpu":
        return layer_vjp(h, x, edge_attr, gh, gx, w, **cfg)
    lib, packed, packed_tc, args = _tc_launch_args(h, w, packed, packed_tc, cfg, "VJP")
    h, x, edge_attr, agg, gh, gx = (t.contiguous() for t in (h, x, edge_attr, agg, gh, gx))
    dh, dx, dea = torch.empty_like(h), torch.empty_like(x), torch.empty_like(edge_attr)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.pita_egcl_backward_tc(
            h.data_ptr(), x.data_ptr(), edge_attr.data_ptr(), agg.data_ptr(), gh.data_ptr(),
            gx.data_ptr(), packed.data_ptr(), packed_tc.data_ptr(), dh.data_ptr(),
            dx.data_ptr(), dea.data_ptr(), *args, stream,
        )
    _build.check(err, "egnn_layer_backward_tc")
    egnn_layer_backward_tc.launches += 1
    return dh, dx, dea


egnn_layer_forward.launches = 0
egnn_layer_forward_tc.launches = 0
egnn_layer_forward_tf32.launches = 0
egnn_layer_backward.launches = 0
egnn_layer_backward_tc.launches = 0
egnn_layer_backward_tf32.launches = 0


class EGCLFunction(torch.autograd.Function):
    """One EGCL layer, differentiable in (h, x, edge_attr) only.

    The forward runs K2 and saves its inputs; the backward runs K3, which
    rebuilds the edge tensors on chip; in bf16 both run their tensor-core
    kernels, in f32 their 3xTF32 ones where ``tf32_takes``. A bf16 forward
    that records a graph (grad mode on and an input that requires grad)
    also saves K2's aggregate, which the bf16 K3 reads; one that records
    none stores nothing more. Weights get no gradient (inference only): a
    weight that requires grad raises.
    """

    @classmethod
    def apply(cls, h, x, edge_attr, layer):
        # forward runs with grad mode off, so whether this call records a
        # graph for a backward is decided here, as autograd decides it
        records = torch.is_grad_enabled() and any(t.requires_grad for t in (h, x, edge_attr))
        return super().apply(h, x, edge_attr, layer, records)

    @staticmethod
    def forward(ctx, h, x, edge_attr, layer, records):
        if any(p.requires_grad for p in layer.parameters()):
            raise RuntimeError("EGCLFunction is inference-only: weights must not require grad")
        ctx.layer = layer
        with_agg = records and layer.cfg["cd"] == torch.bfloat16
        h_out, x_out, *agg = egnn_layer_forward(
            h, x, edge_attr, layer.weights(), packed=layer.packed(h.device),
            packed_tc=layer.packed(h.device, tc=True), with_agg=with_agg, **layer.cfg,
        )
        ctx.save_for_backward(h, x, edge_attr, *agg)
        return h_out, x_out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gh, gx):
        h, x, edge_attr, *agg = ctx.saved_tensors
        layer = ctx.layer
        dh, dx, dea = egnn_layer_backward(
            h, x, edge_attr, gh.contiguous(), gx.contiguous(), layer.weights(),
            packed=layer.packed(h.device), packed_tc=layer.packed(h.device, tc=True),
            agg=agg[0] if agg else None, **layer.cfg,
        )
        return dh, dx, dea, None, None
