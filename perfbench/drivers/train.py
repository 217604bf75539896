"""Job driver of the training traffic: ``train_step`` back to back.

Set-up builds the configuration's preset trainer once, gives both nets (and
their EMA shadows) the asset's trained pair, a rung in the middle of a
ladder (at the EGNN's initial weights the energy-matching loss reads ~1e9
and the first Adam steps amplify round-off ten-thousandfold, so no
reference could follow them), fills the first rung's buffer with the asset's
configurations and the target's log-probabilities and forces, and drives
the trainer through its first ``first_steps`` steps on draws the benchmark
made: distinct buffer rows, rotations' Gaussians, noise levels and noise.
Those steps are the warm-up, and the check follows them from the asset's
weights: the start. The window then runs jobs of ``steps_per_job`` steps of
the same trainer, each drawing its own batch as training does. In every job
one step, drawn from the seed, is recorded: the trainer's own draws for it
and, before and after it, the parameters, Adam's moments and count and the
EMA shadows. The check follows the recorded step of the job that the
harness keeps from that state: the reference's loss and gradient on the
step's draws against the program's, and Adam's update and the EMA, given
the gradient and first moment that Adam got and the parameters it left,
against the program's. The work of a job is
batch × steps samples.
"""

import random
import tempfile
import time

import torch

from perfbench import port
from perfbench.reference import egnn as R
from perfbench.reference import train as RT
from perfbench.trace import phase

B1 = RT.B1
ROUND_OFF = 1e-6  # a leaf's gradient under this share of the median leaf's is round-off


def leaf_gaps(prog, ref, keep=None):
    """Each leaf's gap between the program's and the reference's norms, over
    the larger of the reference leaf's norm and the median leaf's."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(ref[n].norm()) for n in names}
    med = float(torch.tensor(list(rn.values())).median())
    return {n: abs(float(prog[n].norm()) - rn[n]) / max(rn[n], med, 1e-30) for n in names}


def moving_leaves(grads):
    """The leaves whose reference gradient is at least ``ROUND_OFF`` of the
    median leaf's, and each leaf's ratio to the median: the others (no path
    from the loss, or one that f32 rounds away) move under Adam by round-off
    alone."""
    norms = {n: float(g.norm()) for n, g in grads.items()}
    med = float(torch.tensor(list(norms.values())).median())
    ratio = {n: v / max(med, 1e-30) for n, v in norms.items()}
    return {n for n, r in ratio.items() if r >= ROUND_OFF}, ratio


def leaf_label(n):
    return f"{'score' if n[0] == 0 else 'energy'} {n[1]}"


class Driver:
    rate_name = "train_rate"

    def __init__(self, cell, seed, device, sizes=None):
        self.cfg = cell["config_file"]
        self.tr = dict(cell["traffic_file"], **(sizes or {}))
        self.seed, self.dev = seed, device
        self.trace_jobs = self.tr["trace_jobs"]
        self.batch = self.tr.get("batch", self.cfg["training_batch_size"])
        self.work_per_job = self.batch * self.tr["steps_per_job"]
        self.pick = random.Random(seed)  # the recorded step of each job

    def setup(self):
        t0 = time.perf_counter()
        from pita_torch.configs.registry import build_trainer, compose
        from pita_torch.train.buffer import buffer_add, buffer_set, buffer_view

        cfg, tr, dev = self.cfg, self.tr, self.dev
        gen = torch.Generator(dev).manual_seed(self.seed % (2 ** 63))
        self.tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
        overrides = {"out_dir": self.tmp.name, "logger": (),
                     "trainer.seed": self.seed % (2 ** 63),
                     "trainer.training_batch_size": self.batch}
        tr_ = self.trainer = build_trainer(compose(cfg["preset"], overrides), device=dev)
        t1 = time.perf_counter()
        self.weights = port.asset_weights(cfg, dev)
        for net, w in zip((tr_.score_net, tr_.energy_net, tr_.ema_score.module,
                           tr_.ema_energy.module), self.weights * 2):
            port.load(net, w)
        a = port.asset(cfg)
        self.x0 = torch.as_tensor(a[cfg["buffer_asset"]], device=dev)[:tr["buffer_rows"]]
        self.T0 = float(tr_.targets[0].temperature)
        lp, force = tr_.targets[0].log_prob_and_force(self.x0)
        tr_.buffers = buffer_set(tr_.buffers, 0, buffer_add(buffer_view(tr_.buffers, 0),
                                                            self.x0, lp, force))
        self.names = self.leaf_names()
        self.shapes = [p.shape for p in tr_.params]
        draw_step = tr_.draw_step

        def recording_draw_step(temp_idx):  # the window's own draws, kept for the check
            self.last_draws = draw_step(temp_idx)
            return self.last_draws

        tr_.draw_step = recording_draw_step
        t2 = time.perf_counter()
        self.first = self.first_steps(gen)
        self.snapshot()  # its kernels warmed up too
        if dev == "cuda":
            torch.cuda.synchronize()
        self.setup_times = {"trainer": t1 - t0, "weights and buffer": t2 - t1,
                            "first steps": time.perf_counter() - t2}

    def draws(self, gen, k):
        """The benchmark's draws of the first ``k`` steps: distinct rows."""
        B, D = self.batch, self.x0.shape[1]
        rows = torch.randperm(self.x0.shape[0], generator=gen, device=self.dev)[:k * B]
        return [(rows[s * B:(s + 1) * B],
                 torch.randn((B, 3, 3), generator=gen, device=self.dev),
                 torch.randn((B,), generator=gen, device=self.dev),
                 torch.randn((B, D), generator=gen, device=self.dev)) for s in range(k)]

    def first_steps(self, gen):
        from pita_torch.train.losses import LossDraws
        from pita_torch.train.trainer import StepDraws

        tr_ = self.trainer
        draws = self.draws(gen, self.tr["first_steps"])
        losses, g1 = [], None
        for s, (idx, rot, ln, z) in enumerate(draws):
            scal, _ = tr_.train_step(0, StepDraws(idx, rot, None, LossDraws(ln, z, None)))
            losses.append(float(scal["loss"]))
            if s == 0:  # the first gradient as Adam got it: mu = (1 − b1)·g
                g1 = {n: m.detach() / (1 - B1) for n, m in zip(self.names, tr_.opt_state.mu)}
        after = {n: p.detach().clone() for n, p in zip(self.names, tr_.params)}
        ema = {n: p.detach().clone() for n, p in zip(self.names, self.ema_params())}
        return dict(draws=draws, losses=losses, g1=g1, after=after, ema=ema)

    def leaf_names(self):
        return [(i, k) for i, net in enumerate((self.trainer.score_net, self.trainer.energy_net))
                for k, _ in net.named_parameters()]

    def ema_params(self):
        tr_ = self.trainer
        return list(tr_.ema_score.module.parameters()) + list(tr_.ema_energy.module.parameters())

    @torch.no_grad()
    def snapshot(self):
        """The training state, each part flattened into one tensor (a few
        concatenations, not a copy a leaf)."""
        tr_ = self.trainer
        flat = lambda ts: torch.cat([t.detach().reshape(-1) for t in ts])
        return dict(w=flat(tr_.params), mu=flat(tr_.opt_state.mu), nu=flat(tr_.opt_state.nu),
                    ema=flat(self.ema_params()), count=tr_.opt_state.count,
                    ema_count=tr_.ema_score.num_updates)

    def by_leaf(self, flat):
        out, o = {}, 0
        for n, s in zip(self.names, self.shapes):
            k = s.numel()
            out[n] = flat[o:o + k].reshape(s)
            o += k
        return out

    def job(self, k):
        pick = self.pick.randrange(self.tr["steps_per_job"])
        rec = None
        with phase("train_step"):
            for j in range(self.tr["steps_per_job"]):
                if j != pick:
                    self.trainer.train_step(0)
                    continue
                before = self.snapshot()
                scal, _ = self.trainer.train_step(0)
                rec = dict(before=before, after=self.snapshot(), draws=self.last_draws,
                           loss=scal["loss"], job=k, step=j)
        return rec

    def free_program(self):
        del self.trainer
        self.tmp.cleanup()
        if self.dev == "cuda":
            torch.cuda.empty_cache()

    def ref_inputs(self):
        cfg = self.cfg
        log_p0 = R.lj_log_prob(self.x0, self.T0, cfg["n_particles"], R.lj_spline()).float()
        return port.ref_schedule(cfg), log_p0, torch.tensor(1.0, device=self.dev)

    def ref_step(self, st, d, sched, log_p0, beta, half):
        if half:  # a fault's reading: each batch's second half left out
            d = tuple(v[:v.shape[0] // 2] for v in d)
        return st(sched, self.x0, log_p0, beta, d, self.tr["lr"], self.tr["grad_clip"],
                  self.tr["ema_decay"])

    def reference(self, precision=None, half=False):
        """The reference's first steps from the asset's weights and the
        benchmark's draws."""
        st = RT.Step(self.weights, self.cfg, precision or self.cfg["precision"])
        sched, log_p0, beta = self.ref_inputs()
        losses, g1 = [], None
        w0 = {n: st.w[n[0]][n[1]].clone() for n in st.names}
        for s, d in enumerate(self.first["draws"]):
            L, g = self.ref_step(st, d, sched, log_p0, beta, half)
            losses.append(L)
            if s == 0:
                g1 = g
        delta = {n: st.w[n[0]][n[1]] - w0[n] for n in st.names}
        ema = {n: st.ema[n[0]][n[1]] - w0[n] for n in st.names}
        return dict(losses=losses, g1=g1, delta=delta, ema=ema)

    def window_reference(self, rec, precision=None, half=False):
        """The reference's step from the state the program entered the
        recorded window step with, on that step's draws."""
        b = rec["before"]
        w, mu, nu, ema = (self.by_leaf(b[k]) for k in ("w", "mu", "nu", "ema"))
        split = lambda t: [{k: v for (i, k), v in t.items() if i == net} for net in (0, 1)]
        st = RT.Step(split(w), self.cfg, precision or self.cfg["precision"],
                     state=dict(mu=mu, nu=nu, count=b["count"], ema=split(ema),
                                ema_count=b["ema_count"]))
        sched, log_p0, beta = self.ref_inputs()
        d = rec["draws"]
        L, g = self.ref_step(st, (d.idx, d.rot_normal, d.loss.ln_sigma_draw, d.loss.noise),
                             sched, log_p0, beta, half)
        return dict(loss=L, g=g, delta={n: st.w[n[0]][n[1]] - w[n] for n in st.names},
                    ema={n: st.ema[n[0]][n[1]] - ema[n] for n in st.names})

    def as_first(self, ref):
        """A reference's first steps in the form of the program's: a
        control's or a fault's reading."""
        w0 = {n: self.weights[n[0]][n[1]] for n in ref["delta"]}
        return dict(losses=ref["losses"], g1=ref["g1"],
                    after={n: w0[n] + ref["delta"][n] for n in w0},
                    ema={n: w0[n] + ref["ema"][n] for n in w0})

    def as_window(self, rec, ref):
        """A reference's window step in the form of the program's record."""
        b = rec["before"]
        cat = lambda t: torch.cat([t[n].reshape(-1) for n in self.names])
        mu = (B1 * b["mu"] + (1 - B1) * cat(ref["g"]))
        after = dict(b, w=b["w"] + cat(ref["delta"]), mu=mu, ema=b["ema"] + cat(ref["ema"]),
                     count=b["count"] + 1, ema_count=b["ema_count"] + 1)
        return dict(rec, after=after, loss=torch.tensor(ref["loss"]))

    def draw_misses(self, d):
        """Rows missing from the step's draws, or buffer rows outside the
        filled part."""
        B, n = self.batch, self.x0.shape[0]
        rows = [d.idx.shape[0], d.rot_normal.shape[0], d.loss.ln_sigma_draw.shape[0],
                d.loss.noise.shape[0]]
        return sum(abs(r - B) for r in rows) + int(((d.idx < 0) | (d.idx >= n)).sum())

    def check(self, rec, first=None):
        """The numbers compared, each with its limit: the first steps from
        the asset's weights (``first`` in place of the program's reads a
        control's or a fault's), and the recorded window step ``rec``."""
        lim = self.tr["limits"]
        p = first or self.first
        with R.strict_f32():
            ref = self.reference()
        w0 = {n: self.weights[n[0]][n[1]] for n in ref["delta"]}
        moving, ratio = moving_leaves(ref["g1"])
        gaps = {
            "grad_gap": leaf_gaps(p["g1"], ref["g1"]),
            "step_gap": leaf_gaps({n: p["after"][n] - w0[n] for n in w0}, ref["delta"], moving),
            "ema_gap": leaf_gaps({n: p["ema"][n] - w0[n] for n in w0}, ref["ema"], moving),
        }
        # the first step's loss: the later ones carry the parameters that Adam's
        # first steps move by round-off alone (``step_gap``'s excluded leaves)
        rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p["losses"], ref["losses"])]
        vals = {"loss_gap": rel[0]}
        notes = {"loss_gap": [f"later steps' losses within {max(rel[1:]):.3g}"] if rel[1:] else []}
        notes["step_gap"] = [excluded(ratio, moving, "first steps")]
        self.note_worst(gaps, ratio, vals, notes)
        if rec is None:
            vals["window_misses"] = 1
            notes["window_misses"] = ["no window step was recorded"]
        else:
            self.check_window(rec, vals, notes)
        return [dict(name=k, value=v, limit=lim[k], ok=v <= lim[k], notes=notes.get(k, []))
                for k, v in vals.items()]

    def check_window(self, rec, vals, notes):
        b, a = rec["before"], rec["after"]
        miss = self.draw_misses(rec["draws"])
        why = [f"{miss} rows of the draws missing or outside the buffer"] if miss else []
        if a["count"] != b["count"] + 1 or a["ema_count"] != b["ema_count"] + 1:
            miss += 1
            why.append(f"counts {b['count']}, {b['ema_count']} -> {a['count']}, {a['ema_count']}")
        vals["window_misses"] = miss
        notes["window_misses"] = why + [f"job {rec['job']}, step {rec['step']} of the job, "
                                        f"Adam's count {b['count']} before it"]
        with R.strict_f32():
            ref = self.window_reference(rec)
        mu_b, mu_a = self.by_leaf(b["mu"]), self.by_leaf(a["mu"])
        # the step's gradient as Adam got it: mu' = b1·mu + (1 − b1)·g
        g = {n: (mu_a[n] - B1 * mu_b[n]) / (1 - B1) for n in self.names}
        # Adam and the EMA given what the program holds: the gradient and first
        # moment that Adam got, and the parameters after it. Each stage's error
        # shows once: recomputed from the gradient, mu would carry the
        # gradient's round-off into 1e-4 of a leaf's change where it cancels
        wb, wa = self.by_leaf(b["w"]), self.by_leaf(a["w"])
        eb, ea = self.by_leaf(b["ema"]), self.by_leaf(a["ema"])
        nu_b = self.by_leaf(b["nu"])
        d, keep = RT.ema_weights(b["ema_count"] + 1, self.tr["ema_decay"])
        with R.strict_f32():
            upd = {n: RT.update(mu_a[n], RT.B2 * nu_b[n] + (1 - RT.B2) * g[n] * g[n],
                                b["count"] + 1, self.tr["lr"]) for n in self.names}
            ema = {n: eb[n] * d + wa[n] * keep - eb[n] for n in self.names}
        gaps = {
            "window_grad_gap": leaf_gaps(g, ref["g"]),
            # the change as the program's f32 add leaves it: fl(w + u) − w carries
            # the rounding of w, some 6e-8·|w|, that is up to 1e-4 of u = 1e-3
            "window_step_gap": leaf_gaps({n: wa[n] - wb[n] for n in self.names},
                                         {n: (wb[n] + upd[n]) - wb[n] for n in self.names}),
            "window_ema_gap": leaf_gaps({n: ea[n] - eb[n] for n in self.names}, ema),
        }
        vals["window_loss_gap"] = abs(float(rec["loss"]) - ref["loss"]) / max(abs(ref["loss"]),
                                                                             1e-30)
        _, ratio = moving_leaves(ref["g"])
        self.note_worst(gaps, ratio, vals, notes)

    def note_worst(self, gaps, ratio, vals, notes):
        for k, g in gaps.items():
            worst = max(g, key=g.get)
            vals[k] = g[worst]
            notes.setdefault(k, []).insert(0, f"worst leaf {leaf_label(worst)}: its reference "
                                              f"gradient {ratio[worst]:.3g} of the median "
                                              f"leaf's; {len(g)} leaves compared")


def excluded(ratio, moving, what):
    """The leaves left out of the change, with their reference gradients
    over the median leaf's."""
    out = sorted((r, n) for n, r in ratio.items() if n not in moving)
    zero = sum(1 for r, _ in out if r == 0.0)
    rest = ", ".join(f"{leaf_label(n)} {r:.2g}" for r, n in out if r > 0.0)
    return (f"{what}: {len(out)} of {len(ratio)} leaves left out, {zero} with a gradient of "
            f"exactly 0" + (f"; the others: {rest}" if rest else ""))
