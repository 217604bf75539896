"""Lennard-Jones log-probability and force: CUDA kernel and plain version.

Counterpart of ``pita_tpu/ops/pallas/lj.py:79 lj_log_prob_and_force``; the
kernel is ``pita_torch/csrc/lj.cu`` (see its header for what bounds it on the
H100 and how its design answers that). For a CUDA tensor the wrapper
launches the kernel; for a CPU tensor it runs the plain version, which is
the dense energy of ``pita_tpu/targets/lj.py:101-117`` with the force taken
by autograd.
"""

import ctypes
import functools

import torch

from pita_torch.ops import _build


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


@functools.cache
def _fn():
    f = _build.load("lj").pita_lj_log_prob_and_force
    f.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 5
        + [ctypes.c_int] + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    return f


def lj_log_prob_and_force(x: torch.Tensor, n_particles: int, eps: float = 1.0,
                          rm: float = 1.0, oscillator_scale: float = 1.0,
                          energy_factor: float = 1.0, temperature: float = 1.0,
                          spline=None):
    """x: (B, n_particles*3) f32 → (log_prob (B,), force (B, n_particles*3)).

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    """
    if x.dim() != 2 or x.shape[1] != n_particles * 3:
        raise ValueError(f"x must be (B, {n_particles * 3}), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.device.type == "cpu":
        return lj_log_prob_and_force_plain(x, n_particles, eps, rm, oscillator_scale,
                                           energy_factor, temperature, spline)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    B = x.shape[0]
    logp = torch.empty(B, dtype=torch.float32, device=x.device)
    force = torch.empty_like(x)
    sp = (0.0,) * 5 if spline is None else tuple(float(v) for v in spline)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn()(
            x.data_ptr(), logp.data_ptr(), force.data_ptr(), B, n_particles,
            eps, rm, oscillator_scale, energy_factor, temperature,
            int(spline is not None), *sp, stream,
        )
    _build.check(err, "lj_log_prob_and_force")
    lj_log_prob_and_force.launches += 1
    return logp, force


lj_log_prob_and_force.launches = 0
