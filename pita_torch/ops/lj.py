"""Lennard-Jones log-probability and force: CUDA kernel and plain version.

Counterpart of ``pita_tpu/ops/pallas/lj.py:79 lj_log_prob_and_force``; the
kernel is ``pita_torch/csrc/lj.cu`` (see its header for what bounds it on the
H100 and how its design answers that). For a CUDA tensor the wrapper
launches the kernel; for a CPU tensor it runs the plain version, which is
the dense energy of ``pita_tpu/targets/lj.py:101-117`` with the force taken
by autograd.

The kernel takes its scalars as one packed structure (``pack_params``,
cached per parameter tuple) and its launch geometry from
``lanes_per_particle``. On CUDA it refuses N > ``MAX_N`` (``ValueError``),
rm <= 0 and eps == 0. ``_lj_scalar`` launches the first kernel of the same
file through the first wrapper's host path (counter ``_lj_scalar.launches``):
a yardstick for timing, reached by no caller.
"""

import contextlib
import ctypes
import functools

import torch

from pita_torch.ops import _build

# limits of csrc/lj.cu (pita_lj_max_n, pita_lj_max_group)
MAX_N = 256
MAX_GROUP = 512
# the geometry aims at this many warps in the grid per SM: one per scheduler
WARPS_PER_SM = 4
_SAME_DEVICE = contextlib.nullcontext()


def lj_energy(x: torch.Tensor, n_particles: int, eps: float = 1.0, rm: float = 1.0,
              oscillator_scale: float = 1.0, energy_factor: float = 1.0,
              spline=None) -> torch.Tensor:
    """Untempered LJ energy over ordered pairs plus the CoM oscillator; x: (..., N*3).

    ``spline``: optional (c0, c1, c2, c3, r_min), the first cubic segment of
    the smoothing spline that replaces the pair energy where r < r_min.
    """
    shape = x.shape[:-1]
    xr = x.reshape(*shape, n_particles, 3)
    diff = xr[..., :, None, :] - xr[..., None, :, :]
    d2 = (diff ** 2).sum(-1)
    eye = torch.eye(n_particles, dtype=torch.bool, device=x.device)
    # keep the diagonal finite so autograd stays NaN-free; masked out below
    r = torch.sqrt(torch.where(eye, torch.ones_like(d2), d2))
    x6 = (rm / r) ** 6
    e_pair = eps * (x6 * x6 - 2 * x6)
    if spline is not None:
        c0, c1, c2, c3, r_min = spline
        dx = r - r_min
        e_sm = c0 * dx ** 3 + c1 * dx ** 2 + c2 * dx + c3
        e_pair = torch.where(r < r_min, e_sm, e_pair)
    e = torch.where(eye, torch.zeros_like(e_pair), e_pair).sum((-2, -1)) * energy_factor
    if oscillator_scale:
        centered = xr - xr.mean(-2, keepdim=True)
        e = e + 0.5 * oscillator_scale * (centered ** 2).sum((-2, -1))
    return e


def lj_log_prob_and_force_plain(x, n_particles, eps=1.0, rm=1.0, oscillator_scale=1.0,
                                energy_factor=1.0, temperature=1.0, spline=None):
    """Plain version: log_prob = -E/T and its autograd gradient."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        lp = -lj_energy(xx, n_particles, eps, rm, oscillator_scale, energy_factor,
                        spline) / temperature
        (force,) = torch.autograd.grad(lp.sum(), xx)
    return lp.detach(), force


class _LJParams(ctypes.Structure):
    """The kernel's constants (``LJParams`` in csrc/lj.cu). The kernel uses
    x' = x / rm, s = 1/r'^2 = (rm/r)^2 and accumulates per particle
    e = sum_j (s^6 - 2 s^3) and g = sum_j s (s^3 - s^6) (x'_i - x'_j), with
    the spline's terms in the same units where r < r_min; then
    log_prob = ke * sum_i e_i + ko * sum_i |x'_i - xbar'|^2 and
    force_i = kg * g_i + kc * (x'_i - xbar')."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "inv_rm", "rmin2", "ke", "ko", "kg", "kc", "rm", "r_min",
        "c0", "c1", "c2", "c3", "q0", "q1", "q2")] + [("spline", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def pack_params(eps=1.0, rm=1.0, oscillator_scale=1.0, energy_factor=1.0, temperature=1.0,
                spline=None) -> _LJParams:
    """The kernel's packed constants for one parameter tuple (``spline`` a
    tuple or None), folded in float64 and rounded once to float32."""
    if not rm > 0 or eps == 0:
        raise ValueError(f"the LJ kernel takes rm > 0 and eps != 0; got rm={rm}, eps={eps}")
    t, ef, osc = temperature, energy_factor, oscillator_scale
    c0, c1, c2, c3, r_min = (0.0,) * 5 if spline is None else spline
    return _LJParams(
        inv_rm=1.0 / rm, rmin2=(r_min / rm) ** 2,
        ke=-ef * eps / t, ko=-0.5 * osc * rm * rm / t,
        # dE/dx_i = 4 ef sum_j e'(r^2) (x_i - x_j) with e'(r^2) = 6 eps s (s^3 - s^6) / rm^2
        kg=-24.0 * ef * eps / (rm * t), kc=-osc * rm / t,
        rm=rm, r_min=r_min,
        c0=c0 / eps, c1=c1 / eps, c2=c2 / eps, c3=c3 / eps,
        # the spline's e'(r^2) (x_i - x_j) = p'(dx) (x'_i - x'_j) / (2 r'), in units of 6 eps / rm
        q0=3.0 * c0 * rm / (12.0 * eps), q1=2.0 * c1 * rm / (12.0 * eps),
        q2=c2 * rm / (12.0 * eps),
        spline=int(spline is not None))


def group_threads(n_particles: int, lanes: int) -> int:
    """Threads of one configuration's group: N*lanes rounded up to a power
    of two up to a warp, else to whole warps (csrc/lj.cu:group_threads)."""
    nl = n_particles * lanes
    return 1 << (nl - 1).bit_length() if nl <= 32 else -(-nl // 32) * 32


@functools.lru_cache(maxsize=256)
def lanes_per_particle(n_particles: int, batch: int, sms: int) -> int:
    """Lanes L that split each particle's partners: the fewest (the least
    reduction work) that put ``WARPS_PER_SM`` warps per SM in the grid, or
    the most the kernel takes (8, N*L <= MAX_GROUP) when none does."""
    best = 1
    for lanes in (1, 2, 4, 8):
        if n_particles * lanes > MAX_GROUP:
            break
        best = lanes
        if batch * group_threads(n_particles, lanes) >= 32 * WARPS_PER_SM * sms:
            break
    return best


@functools.cache
def _lib():
    lib = _build.load("lj")
    lib.pita_lj_log_prob_and_force.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.POINTER(_LJParams), ctypes.c_void_p]
    )
    lib.pita_lj_log_prob_and_force.restype = ctypes.c_int
    lib.pita_lj_log_prob_and_force_scalar.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 5
        + [ctypes.c_int] + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    )
    lib.pita_lj_log_prob_and_force_scalar.restype = ctypes.c_int
    for name in ("pita_lj_max_n", "pita_lj_max_group", "pita_lj_params_bytes"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, n_particles):
    if x.dim() != 2 or x.shape[1] != n_particles * 3:
        raise ValueError(f"x must be (B, {n_particles * 3}), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def lj_log_prob_and_force(x: torch.Tensor, n_particles: int, eps: float = 1.0,
                          rm: float = 1.0, oscillator_scale: float = 1.0,
                          energy_factor: float = 1.0, temperature: float = 1.0,
                          spline=None):
    """x: (B, n_particles*3) f32 → (log_prob (B,), force (B, n_particles*3)).

    A CUDA tensor launches the kernel (n_particles <= ``MAX_N``); a CPU
    tensor runs the plain version.
    """
    dev = _check(x, n_particles)
    if dev.type == "cpu":
        return lj_log_prob_and_force_plain(x, n_particles, eps, rm, oscillator_scale,
                                           energy_factor, temperature, spline)
    if n_particles > MAX_N:
        raise ValueError(f"the LJ kernel takes N <= {MAX_N}; got {n_particles}")
    if spline is not None and type(spline) is not tuple:
        spline = tuple(spline)
    p = pack_params(eps, rm, oscillator_scale, energy_factor, temperature, spline)
    if not x.is_contiguous():
        x = x.contiguous()
    B, D = x.shape
    index = dev.index
    # the force then log_prob, in one allocation
    out = torch.empty(B * (D + 1), dtype=torch.float32, device=dev)
    lanes = lanes_per_particle(n_particles, B, _sm_count(index))
    # a device context costs host time: enter one only when x is elsewhere
    with _SAME_DEVICE if index == torch.cuda.current_device() else torch.cuda.device(index):
        err = _lib().pita_lj_log_prob_and_force(
            x.data_ptr(), out.data_ptr(), B, n_particles, lanes, p,
            torch._C._cuda_getCurrentRawStream(index))
    _build.check(err, "lj_log_prob_and_force")
    lj_log_prob_and_force.launches += 1
    return out.as_strided((B,), (1,), B * D), out.as_strided((B, D), (D, 1))


lj_log_prob_and_force.launches = 0


def _lj_scalar(x: torch.Tensor, n_particles: int, eps: float = 1.0, rm: float = 1.0,
               oscillator_scale: float = 1.0, energy_factor: float = 1.0,
               temperature: float = 1.0, spline=None):
    """The first K1 (``lj_scalar_kernel``) through the first wrapper's host
    path, for CUDA tensors only: the yardstick the kernel and the wrapper are
    timed against. No caller reaches it."""
    _check(x, n_particles)
    if x.device.type != "cuda":
        raise ValueError("the scalar LJ kernel is a CUDA yardstick")
    x = x.contiguous()
    B = x.shape[0]
    logp = torch.empty(B, dtype=torch.float32, device=x.device)
    force = torch.empty_like(x)
    sp = (0.0,) * 5 if spline is None else tuple(float(v) for v in spline)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().pita_lj_log_prob_and_force_scalar(
            x.data_ptr(), logp.data_ptr(), force.data_ptr(), B, n_particles,
            eps, rm, oscillator_scale, energy_factor, temperature,
            int(spline is not None), *sp, stream,
        )
    _build.check(err, "_lj_scalar")
    _lj_scalar.launches += 1
    return logp, force


_lj_scalar.launches = 0
