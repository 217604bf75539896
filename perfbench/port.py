"""What the benchmark takes from the program: its objects, built from the
configuration file, and the observers that record a checked job.

Everything the program is handed here (weights, inputs) the benchmark made
or loaded itself, and the same tensors go to the reference.
"""

from pathlib import Path

import numpy as np
import torch

from perfbench.frozen.msgpack import egnn_params_from_tree, msgpack_restore
from perfbench.reference import egnn as R

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def asset(cfg):
    return np.load(ROOT / cfg["asset"])


def asset_weights(cfg, device):
    """The trained score and energy weights of the configuration's asset, as
    {name: float32 tensor} on ``device``."""
    a = asset(cfg)
    return [{k: v.to(device) for k, v in
             egnn_params_from_tree(msgpack_restore(a[key].tobytes()), cfg["n_layers"]).items()}
            for key in ("score_params", "energy_params")]


def backbone(cfg, route, device, weights=None):
    """The program's EGNN backbone on ``route``, holding ``weights``."""
    from pita_torch.nets import EGNNBackbone

    bb = EGNNBackbone(n_particles=cfg["n_particles"], n_spatial_dim=3,
                      hidden_nf=cfg["hidden_nf"], n_layers=cfg["n_layers"],
                      coords_range=cfg["coords_range"], compute_dtype=DTYPES[cfg["precision"]],
                      route=route).to(device)
    if weights is not None:
        load(bb, weights)
    return bb


def load(bb, weights):
    with torch.no_grad():
        for name, p in bb.named_parameters():
            p.copy_(weights[name])


def ref_nets(cfg, weights, precision=None):
    return [R.EGNN(w, cfg["n_particles"], cfg["hidden_nf"], cfg["n_layers"],
                   cfg["coords_range"], precision or cfg["precision"]) for w in weights]


def ref_schedule(cfg):
    s = cfg["noise_schedule"]
    return R.Elucidating(s["sigma_min"], s["sigma_max"], s["rho"])


def lj_target(cfg, temperature):
    from pita_torch.targets import LJ55

    return LJ55(smooth=cfg["target"]["smooth"], temperature=temperature)


def noise_schedule(cfg):
    from pita_torch.schedules import ElucidatingNoiseSchedule

    s = cfg["noise_schedule"]
    return ElucidatingNoiseSchedule(sigma_min=s["sigma_min"], sigma_max=s["sigma_max"],
                                    rho=s["rho"])


class Recorder:
    """The states a checked integration entered, in call order: the program
    calls its energy net once per Euler–Maruyama step on the chains' state,
    and once more, under no_grad, on the state the final resample reads."""

    def __init__(self):
        self.on = False
        self.states = []

    def take(self):
        out, self.states = self.states, []
        return out


def observed_energy(bb, rec, precondition_beta=False):
    """The program's EnergyWrapper over ``bb``, recording into ``rec``."""
    from pita_torch.nets import EnergyWrapper

    class Observed(EnergyWrapper):
        def energy(self, ht, xt, *args, **kw):
            if rec.on:
                rec.states.append(xt.detach().clone())
            return super().energy(ht, xt, *args, **kw)

    return Observed(bb, precondition_beta=precondition_beta)


def recording_draws(generator, log):
    """The program's GeneratorDraws over ``generator``, keeping every draw
    in ``log`` (a dict of lists) so that the reference replays them."""
    from pita_torch.sampler.integrator import GeneratorDraws

    class Recording(GeneratorDraws):
        def noise(self, step, shape):
            v = super().noise(step, shape)
            log["noise"].append(v)
            return v

        def probes(self, step, num_probes, shape):
            v = super().probes(step, num_probes, shape)
            log["probes"][step] = v
            return v

        def resample_u0(self, step):
            v = super().resample_u0(step)
            log["u0"].append(v)
            return v

    return Recording(generator)


def new_log():
    return {"noise": [], "probes": {}, "u0": []}
