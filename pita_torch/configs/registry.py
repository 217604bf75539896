"""Experiment presets and dotted-override composition.

Counterpart of ``pita_tpu/configs/registry.py``: ``ExperimentConfig``, the
``gmm`` (the default, as in pita_tpu), ``dw4``, ``lj13``, ``lj55``,
``aldp``, ``al3``, ``al4`` and ``alp_diffusion_baseline`` presets, the
``short`` and ``score_only`` debug overlays, ``compose`` (preset, debug
overlay, YAML overlay, overrides), ``parse_overrides`` and
``build_trainer`` with the energy kinds ``gmm``, ``dw4``, ``lj`` and
``alp`` and the net kinds ``mlp``, ``egnn``, ``dit3d`` and ``torchmd_et``.
The presets are copies of ``pita_tpu``'s (this package imports nothing of
it), without the TPU-only integrator key ``segment_size``. ``pita_tpu``'s
``integrator.pallas_divergence`` is accepted as the port's
``integrator.divergence_tangent_kernel`` (the K4 route).
"""

import ast
import copy
import dataclasses
import os
from typing import Any, Dict, List, Optional

from pita_torch.sampler.integrator import IntegratorConfig
from pita_torch.train.losses import LossConfig
from pita_torch.train.trainer import TrainerConfig

# pita_tpu's integrator keys -> the port's
KEY_ALIASES = {"integrator.pallas_divergence": "integrator.divergence_tangent_kernel"}


@dataclasses.dataclass
class ExperimentConfig:
    name: str
    energy: Dict[str, Any]
    net: Dict[str, Any]
    noise_schedule: Dict[str, Any]
    annealing_schedule: Dict[str, Any]
    trainer: TrainerConfig
    loss: LossConfig
    integrator: IntegratorConfig
    logger: tuple = ("csv", "console")
    out_dir: str = "outputs"
    tags: tuple = ()


def _gmm() -> dict:
    """GMM-40 (registry.py:113-140)."""
    return dict(
        name="gmm",
        tags=("GMM",),
        energy=dict(kind="gmm", normalized=True),
        net=dict(kind="mlp", hidden_size=128, hidden_layers=3, emb_size=128),
        noise_schedule=dict(kind="elucidating", sigma_min=0.01, sigma_max=80.0, rho=7.0),
        annealing_schedule=dict(kind="constant"),
        trainer=dict(
            temperatures=(3.0, 2.0, 1.0),
            num_epochs_per_temp=(100, 100),
            training_batch_size=512,
            should_mean_free=False,
            train_on_all_temps=True,
            num_init_samples=10000,
            seed=12345,
        ),
        loss=dict(w_target_score=0.01),
        integrator=dict(
            num_integration_steps=1000,
            end_resampling_step=900,
            resampling_interval=1,
            resample_at_end=True,
            should_mean_free=False,
        ),
    )


def _dw4() -> dict:
    """DW4, four particles in 2D (registry.py:143-165)."""
    return dict(
        name="dw4",
        tags=("DW4",),
        energy=dict(kind="dw4"),
        net=dict(kind="egnn", hidden_nf=32, n_layers=3, n_spatial_dim=2),
        noise_schedule=dict(kind="elucidating", sigma_min=0.05, sigma_max=80.0, rho=7.0),
        annealing_schedule=dict(kind="constant"),
        trainer=dict(
            temperatures=(3.0, 2.0, 1.5, 1.0),
            num_epochs_per_temp=(150, 150, 200),
            training_batch_size=512,
            train_on_all_temps=True,
            seed=12345,
        ),
        loss=dict(w_target_score=0.01),
        integrator=dict(
            num_integration_steps=1000,
            end_resampling_step=900,
            resampling_interval=1,
            resample_at_end=True,
        ),
    )


def _lj13() -> dict:
    """configs/experiment/lj13.yaml (registry.py:42-83)."""
    return dict(
        name="lj13",
        tags=("LJ13",),
        energy=dict(kind="lj", n_particles=13, smooth=False),
        net=dict(kind="egnn", hidden_nf=32, n_layers=3),
        noise_schedule=dict(kind="elucidating", sigma_min=0.05, sigma_max=80.0, rho=7.0),
        annealing_schedule=dict(kind="constant"),
        trainer=dict(
            temperatures=(4.0, 3.0, 2.0, 1.5, 1.2, 1.0),
            num_epochs_per_temp=(150, 200, 150, 200, 300),
            training_batch_size=512,
            num_temp_annealed_samples=5000,
            num_samples_to_save=10000,
            num_init_samples=10000,
            num_eval_samples=2048,
            train_on_all_temps=True,
            seed=12345,
        ),
        loss=dict(w_energy_score=1.0, w_score=1.0, w_energy_matching=1.0,
                  w_target_score=0.0, w_dem_energy=0.0),
        integrator=dict(
            num_integration_steps=1000,
            end_resampling_step=900,
            resampling_interval=1,
            resample_at_end=True,
            post_mcmc_steps=0,
            num_negative_time_steps=0,
            divergence_chunk_size=1024,
        ),
    )


def _lj55() -> dict:
    """LJ13 scaled to the 55-particle cluster (registry.py:86-111)."""
    cfg = _lj13()
    cfg.update(name="lj55", tags=("LJ55",))
    cfg["energy"] = dict(kind="lj", n_particles=55, smooth=True)
    cfg["trainer"] = dict(
        cfg["trainer"],
        training_batch_size=256,
        num_eval_samples=1024,
        temperatures=(2.0, 1.5, 1.2, 1.0),
        num_epochs_per_temp=(200, 200, 300),
        transition_min_fill_ess=0.02,
        transition_fill_max_retries=2,
        transition_fill_extra_mcmc=30,
    )
    cfg["integrator"] = dict(cfg["integrator"], divergence_chunk_size=64)
    return cfg


def _aldp() -> dict:
    """configs/experiment/aldp.yaml, alanine dipeptide (registry.py:168-203)."""
    return dict(
        name="aldp",
        tags=("ALDP",),
        energy=dict(kind="alp", peptide="aldp"),
        net=dict(kind="dit3d", hidden_size=128, cond_dim=128, n_heads=8, n_blocks=6),
        noise_schedule=dict(kind="elucidating", sigma_min=0.01, sigma_max=80.0, rho=7.0),
        annealing_schedule=dict(kind="constant"),
        trainer=dict(
            temperatures=(1200.0, 755.95, 555.52, 300.0),
            num_epochs_per_temp=(200, 200, 200),
            training_batch_size=2048,
            num_temp_annealed_samples=50000,
            train_on_all_temps=True,
            seed=12345,
            transition_min_fill_ess=0.02,
            transition_fill_max_retries=2,
            transition_fill_extra_mcmc=30,
        ),
        loss=dict(w_target_score=0.01),
        integrator=dict(
            num_integration_steps=1000,
            end_resampling_step=800,
            resampling_interval=1,
            resample_at_end=False,
            post_mcmc_steps=5,
            adaptive_mcmc=True,
            dt_negative_time=1e-13,
        ),
    )


def _al3() -> dict:
    """configs/experiment/al3.yaml, alanine tripeptide, 32 atoms (registry.py:206-225)."""
    cfg = _aldp()
    cfg.update(name="al3", tags=("AL3",))
    cfg["energy"] = dict(kind="alp", peptide="al3")
    cfg["noise_schedule"] = dict(kind="elucidating", sigma_min=0.01, sigma_max=80.0, rho=7.0)
    cfg["trainer"] = dict(
        cfg["trainer"],
        temperatures=(1200.0, 755.95, 555.52, 408.24, 300.0),
        num_epochs_per_temp=(200, 200, 200, 200),
        training_batch_size=2048,
        num_temp_annealed_samples=30000,
        temps_to_anneal_test=((600.0, 600.0),),
    )
    cfg["integrator"] = dict(cfg["integrator"], end_resampling_step=800)
    return cfg


def _al4() -> dict:
    """AL4 tetrapeptide, 42 atoms: the al3 ladder, one size up (registry.py:228-233)."""
    cfg = _al3()
    cfg.update(name="al4", tags=("AL4",))
    cfg["energy"] = dict(kind="alp", peptide="al4")
    return cfg


def _alp_diffusion_baseline() -> dict:
    """configs/experiment/alp_diffusion_baseline.yaml: plain score-only
    diffusion at 300 K, no weights, no debiasing, no annealing
    (registry.py:236-262)."""
    cfg = _aldp()
    cfg.update(name="alp_diffusion_baseline", tags=("ALDP", "diffusion_baseline"))
    cfg["noise_schedule"] = dict(kind="elucidating", sigma_min=0.005, sigma_max=80.0, rho=7.0)
    cfg["trainer"] = dict(
        cfg["trainer"],
        temperatures=(300.0, 300.0),
        num_epochs_per_temp=(400,),
        should_mean_free=False,
        temps_to_anneal_test=((300.0, 300.0),),
    )
    cfg["loss"] = dict(w_score=1.0, w_energy_score=0.0, w_energy_matching=0.0,
                       w_target_score=0.0, w_dem_energy=0.0, w_dU_dt_regularization=0.0)
    cfg["integrator"] = dict(
        cfg["integrator"],
        end_resampling_step=1000,
        resampling_interval=-1,
        should_mean_free=False,
        debias_inference=False,
        post_mcmc_steps=0,
    )
    return cfg


EXPERIMENTS = {
    "gmm": _gmm,
    "dw4": _dw4,
    "lj13": _lj13,
    "lj55": _lj55,
    "aldp": _aldp,
    "al3": _al3,
    "al4": _al4,
    "alp_diffusion_baseline": _alp_diffusion_baseline,
}

# configs/debug/*.yaml (registry.py:276-295)
DEBUG_OVERLAYS = {
    "short": {
        "trainer.n_train_batches_per_epoch": 4,
        "trainer.training_batch_size": 32,
        "trainer.num_init_samples": 256,
        "trainer.num_eval_samples": 64,
        "trainer.num_temp_annealed_samples": 128,
        "trainer.num_samples_to_save": 128,
        "trainer.test_batch_size": 64,
        "trainer.check_val_every_n_epoch": 1,
        "integrator.num_integration_steps": 2,
        "integrator.end_resampling_step": 2,
        "logger": ("csv",),
    },
    "score_only": {
        "loss.only_train_score": True,
        "integrator.debias_inference": False,
        "integrator.resampling_interval": -1,
        "integrator.resample_at_end": False,
    },
}


def _set_dotted(cfg: dict, dotted: str, value):
    parts = KEY_ALIASES.get(dotted, dotted).split(".")
    node = cfg
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def _coerce(s):
    if isinstance(s, (int, float, bool, tuple, list)) or s is None:
        return s
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s and s[0] in "([":
        def tup(v):
            return tuple(tup(p) for p in v) if isinstance(v, (tuple, list)) else v

        try:
            return tup(ast.literal_eval(s))
        except (ValueError, SyntaxError):
            pass
    if "," in s:
        return tuple(_coerce(p) for p in s.strip("[]()").split(",") if p != "")
    return s


def parse_overrides(args: List[str]) -> dict:
    """Parse ``key=value`` CLI tokens (hydra style)."""
    out = {}
    for a in args:
        if "=" not in a:
            raise ValueError(f"override '{a}' is not key=value")
        k, v = a.split("=", 1)
        out[k] = _coerce(v)
    return out


def compose(experiment: str = "gmm", overrides: Optional[Dict[str, Any]] = None,
            debug: Optional[str] = None, yaml_path: Optional[str] = None) -> ExperimentConfig:
    """Preset, then the debug overlay, then the YAML file's keys (dotted or
    top-level, as on the command line), then the overrides. A ``net.kind``
    other than the preset's starts the net group afresh from that backbone's
    defaults, as Hydra's ``net=<group>`` does (pita_tpu keeps the preset's
    other net keys, which the new backbone does not take)."""
    if experiment not in EXPERIMENTS:
        raise ValueError(f"experiment {experiment!r} is not ported (have {sorted(EXPERIMENTS)})")
    cfg = copy.deepcopy(EXPERIMENTS[experiment]())
    merged = dict(DEBUG_OVERLAYS[debug]) if debug is not None else {}
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            merged.update(yaml.safe_load(f) or {})
    merged.update(overrides or {})
    if merged.get("net.kind", cfg["net"]["kind"]) != cfg["net"]["kind"]:
        # another backbone: its own defaults, as Hydra's net=<group> selects
        cfg["net"] = {"kind": merged["net.kind"]}
    for k, v in merged.items():
        if "." in k:
            _set_dotted(cfg, k, v)
        else:
            cfg[k] = v
    return ExperimentConfig(
        name=cfg["name"], energy=cfg["energy"], net=cfg["net"],
        noise_schedule=cfg["noise_schedule"], annealing_schedule=cfg["annealing_schedule"],
        trainer=TrainerConfig(**cfg["trainer"]), loss=LossConfig(**cfg["loss"]),
        integrator=IntegratorConfig(**cfg["integrator"]),
        logger=tuple(cfg.get("logger", ("csv", "console"))),
        out_dir=cfg.get("out_dir", "outputs"), tags=tuple(cfg.get("tags", ())),
    )


def _build_target(spec: dict, temperature: float):
    spec = dict(spec)
    kind = spec.pop("kind")
    if kind == "gmm":
        from pita_torch.targets import GMM40

        return GMM40(temperature=temperature, **spec)
    if kind == "dw4":
        from pita_torch.targets import DoubleWell4

        return DoubleWell4(temperature=temperature, **spec)
    if kind == "lj":
        from pita_torch.targets import LennardJones

        return LennardJones(temperature=temperature, **spec)
    if kind == "alp":
        from pita_torch.targets import ALPEnergy

        return ALPEnergy(temperature=temperature, **spec)
    raise ValueError(f"unknown energy kind {kind!r}")


def _build_backbone_factory(spec: dict, target):
    spec = dict(spec)
    kind = spec.pop("kind")
    if kind == "mlp":
        from pita_torch.nets import MLPBackbone

        return lambda: MLPBackbone(in_dim=target.dim, out_dim=target.dim, **spec)
    if kind == "egnn":
        from pita_torch.nets import EGNNBackbone

        n_sd = spec.pop("n_spatial_dim", target.n_spatial_dim)
        return lambda: EGNNBackbone(n_particles=target.n_particles, n_spatial_dim=n_sd,
                                    route="autograd", **spec)
    if kind == "dit3d":
        from pita_torch.nets import DiT3DBackbone

        return lambda: DiT3DBackbone(n_particles=target.n_particles,
                                     n_spatial_dim=target.n_spatial_dim, **spec)
    if kind == "torchmd_et":
        from pita_torch.nets import TorchMDETBackbone

        return lambda: TorchMDETBackbone(n_particles=target.n_particles, **spec)
    raise ValueError(f"unknown net kind {kind!r}")


def _build_noise_schedule(spec: dict):
    spec = dict(spec)
    kind = spec.pop("kind")
    from pita_torch import schedules as S

    return {
        "elucidating": S.ElucidatingNoiseSchedule,
        "geometric": S.GeometricNoiseSchedule,
        "linear": S.LinearNoiseSchedule,
        "quadratic": S.QuadraticNoiseSchedule,
        "power": S.PowerNoiseSchedule,
        "sub_linear": S.SubLinearNoiseSchedule,
    }[kind](**spec)


def _build_annealing_factory(spec: dict):
    spec = dict(spec)
    kind = spec.pop("kind")
    from pita_torch import schedules as S

    cls = {"constant": S.ConstantAnnealingSchedule, "linear": S.LinearAnnealingSchedule,
           "sigmoid": S.SigmoidAnnealingSchedule}[kind]
    return lambda af: cls(annealing_factor=af, **spec)


def build_trainer(cfg: ExperimentConfig, resume: bool = False, dem_cfg=None, device=None):
    """The object graph (train.py:58-79) on ``device`` (CUDA by default,
    raising without a GPU). ``resume`` keeps an existing metrics.csv; a
    ``DEMConfig`` (``pita_torch.train.dem``) adds its pretraining phase,
    which no preset or override builds."""
    from pita_torch.io.logging import make_logger
    from pita_torch.train.trainer import EnergyTempTrainer

    target = _build_target(cfg.energy, temperature=cfg.trainer.temperatures[0])
    out_dir = os.path.join(cfg.out_dir, cfg.name)
    return EnergyTempTrainer(
        target=target,
        backbone_factory=_build_backbone_factory(cfg.net, target),
        noise_schedule=_build_noise_schedule(cfg.noise_schedule),
        annealing_schedule_factory=_build_annealing_factory(cfg.annealing_schedule),
        loss_cfg=cfg.loss, integrator_cfg=cfg.integrator, cfg=cfg.trainer,
        out_dir=out_dir, logger=make_logger(out_dir, cfg.logger, resume=resume),
        dem_cfg=dem_cfg, device=device,
    )
