"""The LJ55 sampling workload of ``bench.py`` (lines 194-252), built for the port.

Reads the trained EGNN score/energy pair from ``pita_tpu/assets/bench_lj55.npz``
(flax msgpack bytes, decoded by ``pita_torch.io.flax_params``) and builds
the target and schedules the way ``bench.py`` does: LJ55 with the smoothing
spline at T = t_high / γ, the Elucidating schedule (σ 0.05–80, ρ 7) and a
constant annealing factor γ. Only the file is read; nothing of ``pita_tpu``
is imported.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from pita_torch.io.flax_params import load_egnn_params
from pita_torch.nets import EGNNBackbone, EnergyWrapper, ScoreWrapper
from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
from pita_torch.targets import LJ55
from pita_torch.utils.device import resolve_device

ASSETS = Path(__file__).resolve().parents[2] / "pita_tpu" / "assets"
BENCH_ASSET = ASSETS / "bench_lj55.npz"
EXACT_ENERGIES_ASSET = ASSETS / "bench_lj55_exact_energies.npy"


@dataclasses.dataclass
class LJ55Bench:
    target: object
    score: ScoreWrapper
    energy: EnergyWrapper
    noise: ElucidatingNoiseSchedule
    anneal: ConstantAnnealingSchedule
    data_T_low: np.ndarray  # (1024, 165) ground-truth samples at the low temperature
    prior_scale: float  # std of the prior samples x1 (bench.py:252)


def lj55_backbone(compute_dtype=torch.bfloat16) -> EGNNBackbone:
    """EGNN(32 wide, 3 layers, attention, tanh, temperature-conditioned)."""
    return EGNNBackbone(n_particles=55, n_spatial_dim=3, hidden_nf=32, n_layers=3,
                        compute_dtype=compute_dtype)


def load_lj55_bench(path=BENCH_ASSET, device=None,
                    compute_dtype=torch.bfloat16) -> LJ55Bench:
    """The bench workload on ``device`` (CUDA by default; raises without a GPU)."""
    dev = resolve_device(device)
    asset = np.load(path)
    t_high = float(asset["t_high"])
    gamma = float(asset["gamma"])
    nets = []
    for key in ("score_params", "energy_params"):
        bb = lj55_backbone(compute_dtype)
        bb.load_state_dict(load_egnn_params(asset[key], n_layers=3))
        nets.append(bb.to(dev))
    noise = ElucidatingNoiseSchedule(sigma_min=0.05, sigma_max=80.0, rho=7.0)
    return LJ55Bench(
        target=LJ55(smooth=True, temperature=t_high / gamma),
        score=ScoreWrapper(nets[0]),
        energy=EnergyWrapper(nets[1]),
        noise=noise,
        anneal=ConstantAnnealingSchedule(annealing_factor=gamma),
        data_T_low=np.asarray(asset["data_T_low"], np.float32),
        prior_scale=math.sqrt(noise.h(1.0) / gamma),
    )
