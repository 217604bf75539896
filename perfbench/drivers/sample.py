"""Job driver of the sampling traffic: one ``integrate_sde`` call a job.

Each job draws its prior samples and its generator from the run's seed and
the job's index, runs the annealed sampler over ``chains`` × ``steps`` on
the configuration's trained score/energy pair, and ends when the device
has finished. The traffic file sets the integrator (divergence mode,
probes, recomputation interval, ESS trigger). The work of a job is
chains × steps chain·steps.
"""

import math
import random
import time

import torch

from perfbench import checks as C
from perfbench import port
from perfbench.reference import egnn as R
from perfbench.trace import phase


def job_seed(seed, k):
    return (seed * 1_000_003 + k + 1) % (2 ** 63)


class Driver:
    rate_name = "sample_rate"

    def __init__(self, cell, seed, device, sizes=None):
        self.cfg = cell["config_file"]
        self.tr = dict(cell["traffic_file"], **(sizes or {}))
        self.seed, self.dev = seed, device
        self.trace_jobs = self.tr["trace_jobs"]
        self.chains, self.steps = self.tr["chains"], self.tr["steps"]
        self.work_per_job = self.chains * self.steps

    def setup(self):
        t0 = time.perf_counter()
        from pita_torch.nets import ScoreWrapper
        from pita_torch.sampler.integrator import IntegratorConfig
        from pita_torch.schedules import ConstantAnnealingSchedule

        cfg, tr = self.cfg, self.tr
        a = port.asset(cfg)
        self.t_high, self.gamma = float(a["t_high"]), float(a["gamma"])
        self.weights = port.asset_weights(cfg, self.dev)
        self.rec = port.Recorder()
        self.score = ScoreWrapper(port.backbone(cfg, "kernels", self.dev, self.weights[0]))
        self.energy = port.observed_energy(port.backbone(cfg, "kernels", self.dev,
                                                         self.weights[1]), self.rec)
        self.sched = port.noise_schedule(cfg)
        self.anneal = ConstantAnnealingSchedule(annealing_factor=self.gamma)
        self.target = port.lj_target(cfg, self.t_high / self.gamma)
        self.icfg = IntegratorConfig(
            num_integration_steps=self.steps, end_resampling_step=self.steps,
            resampling_interval=1, resample_at_end=False, should_mean_free=True,
            divergence_chunk_size=min(tr["divergence_chunk_size"], self.chains),
            divergence_mode=tr["divergence_mode"], hutchinson_probes=tr["hutchinson_probes"],
            ess_resampling_threshold=tr["ess_resampling_threshold"],
            divergence_update_interval=tr["divergence_update_interval"])
        self.prior_scale = math.sqrt(float(self.sched.h(torch.tensor(1.0))) / self.gamma)
        t1 = time.perf_counter()
        self.job(-1)  # the warm-up: one job at the cell's shapes
        if self.dev == "cuda":
            torch.cuda.synchronize()
        self.setup_times = {"program objects": t1 - t0, "warm-up job": time.perf_counter() - t1}

    def job(self, k):
        from pita_torch.sampler.integrator import integrate_sde

        with phase("draw inputs"):
            gen = torch.Generator(self.dev).manual_seed(job_seed(self.seed, k))
            x1 = torch.randn((self.chains, self.cfg["n_particles"] * 3), generator=gen,
                             device=self.dev) * self.prior_scale
            log = port.new_log()
            draws = port.recording_draws(gen, log)
        with phase("integrate_sde"):
            self.rec.on = True
            res = integrate_sde(x1, self.score, self.energy, self.sched, self.anneal,
                                self.target, 1.0, self.icfg, draws=draws, device=self.dev)
            self.rec.on = False
        return dict(states=self.rec.take(), x1=x1, samples=res.samples,
                    logweights=res.logweights, log=log,
                    n_steps=self.steps, end_resampling=self.steps, resample=True,
                    ess_threshold=self.icfg.ess_resampling_threshold,
                    div=self.icfg.divergence_mode,
                    div_interval=self.icfg.divergence_update_interval)

    def free_program(self):
        del self.score, self.energy
        if self.dev == "cuda":
            torch.cuda.empty_cache()

    def check(self, it):
        """The numbers compared, each with its limit."""
        lim = self.tr["limits"]
        out = C.Readings()
        rng = random.Random(self.seed)
        nets = port.ref_nets(self.cfg, self.weights)
        sched = port.ref_schedule(self.cfg)
        beta = torch.tensor(1.0, device=self.dev)
        n = it["n_steps"]
        extra = rng.sample(range(n), min(self.tr["extra_full_steps"], n))
        with R.strict_f32():
            C.check_integration(it, nets, sched, self.gamma, beta, lim, rng, out,
                                full_steps=set(extra), rows_per_step=self.tr["rows_per_step"])
        return readings(out, lim)


def readings(out, lim):
    return [dict(name=n, value=getattr(out, n), limit=lim[n], ok=getattr(out, n) <= lim[n])
            for n in ("x_gap", "a_gap")] + [
            dict(name="misses", value=out.misses, limit=0, ok=out.misses == 0,
                 notes=out.notes + ["checked: " + ", ".join(f"{k} {v}" for k, v in
                                                            out.counts.items())])]
