"""Job driver of a rung fill with the exact trace: one ``integrate_sde``
call a job on the configuration's DiT3D score/energy pair.

The nets are the program's ``DiT3DBackbone`` in the configuration's widths
and precision, wrapped as the trainer wraps its sampling nets
(``ScoreWrapper``, ``EnergyWrapper``), with weights drawn from the run's
seed (``perfbench/reference/dit.py:draw_weights``; the configuration says
why). Each job draws its prior samples (mean-free, at the trainer's prior
scale) and its generator from the run's seed and the job's index, and runs
the sampler over ``chains`` × ``steps`` from t = 1 with the exact trace of
the score's Jacobian (``divergence_mode="exact"``, which a DiT takes by D
VJPs), systematic resampling at every step before ``end_resampling_step``,
no ESS trigger and no MCMC after. The work of a job is chains × steps
chain·steps.

The check (``perfbench/checks_exact.py``) reads the states the energy net
was called on and the log-weights the program resampled on: while a job
runs, ``pita_torch.sampler.integrator.systematic_resample`` is wrapped to
keep a copy of its input.
"""

import contextlib
import math
import time

import torch

from perfbench import checks as C
from perfbench import port
from perfbench.checks_exact import check_exact_integration
from perfbench.drivers.sample import job_seed, readings
from perfbench.reference import dit as RD
from perfbench.reference import egnn as R
from perfbench.trace import phase


def weight_seeds(seed):
    """The score's and the energy's weight seeds from the run's seed."""
    return [(seed * 7_919 + k) % (2 ** 63) for k in (1, 2)]


def net_kw(cfg):
    return dict(hidden=cfg["hidden_size"], cond=cfg["cond_dim"], n_blocks=cfg["n_blocks"],
                mlp_ratio=cfg["mlp_ratio"], freq_dim=cfg["freq_dim"],
                temperature=cfg["condition_on_temperature"])


def draw_weights(cfg, seed, device):
    return [{k: v.to(device) for k, v in
             RD.draw_weights(s, cfg["weights"]["scale"], **net_kw(cfg)).items()}
            for s in weight_seeds(seed)]


def backbone(cfg, device, weights):
    """The program's DiT3D holding ``weights``; every weight is set."""
    from pita_torch.nets import DiT3DBackbone

    bb = DiT3DBackbone(n_particles=cfg["n_particles"], n_spatial_dim=3,
                       hidden_size=cfg["hidden_size"], cond_dim=cfg["cond_dim"],
                       n_heads=cfg["n_heads"], n_blocks=cfg["n_blocks"],
                       condition_on_temperature=cfg["condition_on_temperature"],
                       compute_dtype=port.DTYPES[cfg["precision"]]).to(device)
    names = {n for n, _ in bb.named_parameters()}
    if names != set(weights):
        raise ValueError(f"weights do not match the net: {sorted(names ^ set(weights))}")
    port.load(bb, weights)
    return bb


def ref_nets(cfg, weights, precision=None):
    return [RD.DiT3D(w, cfg["n_particles"], cfg["n_heads"], cfg["n_blocks"],
                     precision or cfg["precision"], cfg["condition_on_temperature"])
            for w in weights]


@contextlib.contextmanager
def recording_resamples(log):
    """Keep in ``log["resampled_on"]`` the log-weights the integrator hands
    to ``systematic_resample`` while the block runs."""
    from pita_torch.sampler import integrator

    real = integrator.systematic_resample

    def observed(a, u0):
        log["resampled_on"].append(a.detach().clone())
        return real(a, u0)

    integrator.systematic_resample = observed
    try:
        yield
    finally:
        integrator.systematic_resample = real


class Driver:
    rate_name = "sample_rate"

    def __init__(self, cell, seed, device, sizes=None):
        self.cfg = cell["config_file"]
        self.tr = dict(cell["traffic_file"], **(sizes or {}))
        self.seed, self.dev = seed, device
        self.trace_jobs = self.tr["trace_jobs"]
        self.chains, self.steps = self.tr["chains"], self.tr["steps"]
        self.end_resampling = min(self.tr["end_resampling_step"], self.steps)
        self.work_per_job = self.chains * self.steps

    def setup(self):
        t0 = time.perf_counter()
        from pita_torch.nets import ScoreWrapper
        from pita_torch.sampler.integrator import IntegratorConfig
        from pita_torch.schedules import ConstantAnnealingSchedule
        from pita_torch.targets import ALPEnergy

        cfg, tr = self.cfg, self.tr
        self.gamma = cfg["temperatures"][0] / cfg["temperatures"][1]
        self.beta = cfg["beta"]
        self.weights = draw_weights(cfg, self.seed, self.dev)
        self.rec = port.Recorder()
        self.score = ScoreWrapper(backbone(cfg, self.dev, self.weights[0]))
        self.energy = port.observed_energy(backbone(cfg, self.dev, self.weights[1]), self.rec)
        self.sched = port.noise_schedule(cfg)
        self.anneal = ConstantAnnealingSchedule(annealing_factor=self.gamma)
        self.target = ALPEnergy(cfg["target"]["peptide"], temperature=cfg["temperatures"][1],
                                implicit_solvent=cfg["target"]["implicit_solvent"])
        if self.target.n_particles != cfg["n_particles"]:
            raise ValueError(f"{cfg['target']['peptide']} has {self.target.n_particles} atoms")
        self.icfg = IntegratorConfig(
            num_integration_steps=self.steps, end_resampling_step=self.end_resampling,
            resampling_interval=1, resample_at_end=False, should_mean_free=True,
            divergence_mode=tr["divergence_mode"],
            divergence_chunk_size=tr["divergence_chunk_size"],
            ess_resampling_threshold=tr["ess_resampling_threshold"],
            post_mcmc_steps=tr["post_mcmc_steps"])
        self.prior_scale = math.sqrt(float(self.sched.h(torch.tensor(1.0))) / self.gamma)
        t1 = time.perf_counter()
        self.job(-1)  # the warm-up: one job at the cell's shapes
        if self.dev == "cuda":
            torch.cuda.synchronize()
        self.setup_times = {"program objects": t1 - t0, "warm-up job": time.perf_counter() - t1}

    def job(self, k):
        from pita_torch.sampler.integrator import integrate_sde

        N = self.cfg["n_particles"]
        with phase("draw inputs"):
            gen = torch.Generator(self.dev).manual_seed(job_seed(self.seed, k))
            x1 = R.remove_mean(torch.randn((self.chains, N * 3), generator=gen, device=self.dev)
                               * self.prior_scale, N)
            log = dict(port.new_log(), resampled_on=[])
            draws = port.recording_draws(gen, log)
        with phase("integrate_sde"), recording_resamples(log):
            self.rec.on = True
            res = integrate_sde(x1, self.score, self.energy, self.sched, self.anneal,
                                self.target, self.beta, self.icfg, draws=draws, device=self.dev)
            self.rec.on = False
        return dict(states=self.rec.take(), x1=x1, samples=res.samples,
                    logweights=res.logweights, log=log, n_steps=self.steps,
                    end_resampling=self.end_resampling)

    def free_program(self):
        del self.score, self.energy
        if self.dev == "cuda":
            torch.cuda.empty_cache()

    def check(self, it):
        """The numbers compared, each with its limit."""
        lim = self.tr["limits"]
        out = C.Readings()
        nets = ref_nets(self.cfg, self.weights)
        beta = torch.tensor(self.beta, device=self.dev)
        with R.strict_f32():
            check_exact_integration(it, nets, port.ref_schedule(self.cfg), self.gamma, beta,
                                    lim, out, self.cfg["n_particles"], self.tr["ref_block"])
        return readings(out, lim)


def reference_job(drv, rec, precision):
    """The reference sampler in ``precision``, put in the program's place
    over a job's inputs and draws: what ``check`` reads, as the program's
    observed job gives it (the controls)."""
    from perfbench.reference import sampler as S

    nets = ref_nets(drv.cfg, drv.weights, precision)
    score_net, energy_net = nets
    sched = port.ref_schedule(drv.cfg)
    beta = torch.tensor(drv.beta, device=drv.dev)
    N, n, end = drv.cfg["n_particles"], rec["n_steps"], rec["end_resampling"]
    log = rec["log"]
    x = rec["x1"].clone()
    B = x.shape[0]
    a = torch.zeros(B, device=x.device)
    ts = S.times(n, x.device)
    states, rows, resampled_on = [], [], []
    with R.strict_f32():
        for i in range(n):
            states.append(x)
            t = ts[i].expand(B)
            div_s = RD.exact_div(score_net, sched, x, t, beta, drv.tr["ref_block"]) \
                if i < end else None
            d = S.drift(score_net, energy_net, sched, drv.gamma, x, t, beta, div_s)
            x_next = S.em_update(x, d["drift_X"], ts[i], log["noise"][i], sched, 1.0 / n, N)
            if i < end:
                a_next = a + S.clamp_quantile(d["drift_A"]) / n
                resampled_on.append(a_next)
                idx = S.systematic(a_next, log["u0"][i])[0]
                x_next, a_next = x_next[idx], torch.zeros_like(a_next)
            else:
                a_next = torch.zeros_like(a)
            x, a = x_next.detach(), a_next.detach()
            rows.append(a)
    return dict(rec, states=states, samples=x, logweights=torch.stack(rows),
                log=dict(log, resampled_on=resampled_on))
