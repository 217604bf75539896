"""The comparison that decides ``correct`` for the sampling cells.

The program's run cannot be followed from its start alone: resampling picks
ancestors from a CDF, and the smallest difference in a log-weight moves a
point across a boundary, after which the two runs hold different chains. So
the reference follows the program step by step from the program's own
state, which the energy observer records (``perfbench/port.py``):

- the start: the first state is the prior draw the benchmark handed over;
- each step's Euler–Maruyama update: the reference's update of the state
  the program entered the step with, compared row by row with the state it
  left it with (``x_gap``: the largest ‖Δx‖ over the median size of the
  step's drift·dt, or of its learned part: what drift_X has beyond the
  closed form of the preconditioning, see ``check_integration``);
- the log-weights: the program's row a_i against a_{i−1} + min(drift_A,
  q₀.₉)·dt of the reference (``a_gap``: the largest gap over the rms of the
  step's increments, or of their learned part); where the reference computes the divergence for a
  sample of chains only, the clamp value q is the program's own (the
  largest increment), and the stage that this skips, the quantile itself,
  is checked by itself: as many chains sit at q as the 0.9 quantile puts
  there;
- resampling, the stage that following the program's own state skips:
  the ancestor of each row is found by the row it equals (the update
  without drift is the closest candidate), and each must lie in its point's
  slot of the reference's CDF, within the slack that the a-gap limit
  allows; the ESS trigger must fire where the reference's ESS is below the
  threshold (``misses``: count of rows or steps that break this, limit 0).
"""

import math

import torch

from perfbench.reference import egnn as R
from perfbench.reference import sampler as S


def _nearest(rows, cand, block=1024):
    """For each row, the index of the closest candidate and the ratio of the
    closest distance to the second closest."""
    idx, ratio = [], []
    for s in range(0, rows.shape[0], block):
        d = torch.cdist(rows[s:s + block].double(), cand.double())
        two = d.topk(min(2, d.shape[1]), largest=False)
        idx.append(two.indices[:, 0])
        r = two.values[:, 0] / two.values[:, -1].clamp_min(1e-300)
        ratio.append(r)
    return torch.cat(idx), torch.cat(ratio)


def slot_misses(anc, a, u0, slack):
    """Rows whose ancestor is not admissible: systematic resampling puts the
    point u_k = (u0 + k/B) mod 1 of row k in the CDF slot of its ancestor
    ``anc[k]`` (the first len(anc) rows are judged); ``slack`` is how far a
    CDF value may move (absolute, and relative to the CDF value) under the
    allowed log-weight error."""
    B = a.shape[0]
    cdf = S.clipped_cdf(a)
    lo = torch.cat([torch.zeros(1, dtype=cdf.dtype, device=cdf.device), cdf[:-1]])
    k = torch.arange(anc.shape[0], dtype=torch.float64, device=a.device)
    u = (u0.double() + k / B) % 1.0
    c_lo, c_hi = lo[anc], cdf[anc]
    tol_lo = slack[0] + slack[1] * c_lo
    tol_hi = slack[0] + slack[1] * c_hi
    bad = (u < c_lo - tol_lo) | (u > c_hi + tol_hi)
    return int(bad.sum())


class Readings:
    """The largest reading of each compared number over a run's checks."""

    def __init__(self):
        self.x_gap = 0.0
        self.a_gap = 0.0
        self.misses = 0
        self.notes = []
        self.counts = {"rows": 0, "a_rows": 0, "resampled_rows": 0, "steps": 0}

    def count(self, name, n):
        self.counts[name] += int(n)

    def gap(self, name, v):
        v = float(v)
        if not math.isfinite(v):
            v = float("inf")
        setattr(self, name, max(getattr(self, name), v))

    def miss(self, n, why):
        if n:
            self.misses += n
            self.notes.append(f"{n} {why}")


def check_integration(it, nets, sched, gamma, beta, lim, rng, out, full_steps=(),
                      rows_per_step=32):
    """Check one integration the program ran (``it``: its observed states,
    its result, the draws it used and its settings) against the reference
    nets; readings go into ``out`` (a ``Readings``).

    The reference computes the drift of every chain at ``full_steps`` and at
    every step that recomputes the Hutchinson divergence or resamples; there
    it checks every row's update, and where it knows the divergence also
    the log-weights and the resampling. At the other steps it checks
    ``rows_per_step`` rows drawn from ``rng``. The run carries the
    divergence of its last recomputation, which the reference follows
    through the ancestors.

    A gap is measured against the learned part of the drift (what it has
    beyond the closed form of the preconditioning): in bf16 the program's
    own rounding sits there, and the whole drift would hide it."""
    score_net, energy_net = nets
    states, lw, log = it["states"], it["logweights"], it["log"]
    n, B = it["n_steps"], states[0].shape[0]
    dev = states[0].device
    ts = S.times(n, dev)
    dt = 1.0 / n
    if len(states) != n:
        out.miss(1, f"states observed: {len(states)}, expected {n}")
        return
    if not torch.equal(states[0], it["x1"]):
        out.miss(1, "first state is not the prior draw handed over")
    after = lambda i: states[i + 1] if i + 1 < len(states) else it["samples"]
    if it["div"] != "hutchinson":
        raise ValueError(f"no check for the divergence {it['div']!r}")
    div_c = torch.zeros(B, device=dev)
    a_prev = torch.zeros(B, device=dev)
    for i in range(n):
        x_i, x_o = states[i], after(i)
        t = ts[i].expand(B)
        g = sched.g(ts[i])
        noise = log["noise"][i]
        in_window = i < it["end_resampling"]
        fired = it["resample"] and in_window and (
            it["ess_threshold"] is None or bool((lw[i] == 0).all()))
        rediv = i % it["div_interval"] == 0
        d = None
        if rediv:
            div_s = S.hutchinson_div(score_net, sched, x_i, t, beta, log["probes"][i])
            d = S.drift(score_net, energy_net, sched, gamma, x_i, t, beta, div_s)
            div_new = d["div_bt"]
        elif i in full_steps or fired:
            d = S.drift(score_net, energy_net, sched, gamma, x_i, t, beta, None)
            d["drift_A"] = gamma * gamma * d["inner"] + gamma * div_c + gamma * d["dUdt"]
        if not rediv:
            div_new = div_c
        # ancestors: each row is the update of the candidate it is closest to
        if fired:
            base = x_i + (d["drift_X"] * dt if d is not None else 0.0)
            anc, ratio = _nearest(x_o, R.remove_mean(base + g * noise * math.sqrt(dt)))
            descents = int((anc[1:] < anc[:-1]).sum())
            if descents > 1:  # u_k = (u0 + k/B) mod 1 wraps once
                out.miss(descents - 1, f"descents of the ancestors past the wrap at step {i}")
        else:
            anc = torch.arange(B, device=dev)
        # the Euler-Maruyama update, row by row
        if d is not None:
            rows = torch.arange(B, device=dev)
            dX = d["drift_X"][anc]
        else:
            rows = torch.tensor(sorted(rng.sample(range(B), min(rows_per_step, B))), device=dev)
            dX = S.drift(score_net, energy_net, sched, gamma, x_i[anc[rows]], t[rows],
                         beta)["drift_X"]
        src = anc[rows]
        x_ref = S.em_update(x_i[src], dX, ts[i], noise[src], sched, dt)
        part = dX - S.analytic(sched, gamma, x_i[src], t[rows])[0]
        x_scale = R.remove_mean(part * dt).norm(dim=-1).median().clamp_min(1e-30)
        out.gap("x_gap", ((x_o[rows] - x_ref).norm(dim=-1) / x_scale).max())
        out.count("rows", rows.numel())
        out.count("steps", 1)
        # log-weights and resampling
        if d is not None and in_window:
            inc = S.clamp_quantile(d["drift_A"]) * dt
            a_ref = a_prev + inc
            part = d["drift_A"] - S.analytic(sched, gamma, x_i, t)[1]
            scale_a = (part * dt).pow(2).mean().sqrt().clamp_min(1e-30)
            if fired:
                allowed = lim["a_gap"] * float(scale_a)
                out.miss(slot_misses(anc, a_ref, log["u0"][i], (1e-5, 2 * allowed)),
                         f"rows with an ancestor outside its CDF slot at step {i}")
                out.count("resampled_rows", B)
            else:
                out.gap("a_gap", ((lw[i] - a_ref).abs() / scale_a).max())
                out.count("a_rows", B)
            if it["ess_threshold"] is not None:
                e = S.ess(a_ref)
                if abs(e - it["ess_threshold"]) > 0.01 and (e < it["ess_threshold"]) != fired:
                    out.miss(1, f"ESS trigger at step {i} (reference ESS {e:.4f})")
        div_c = div_new[anc]
        a_prev = lw[i] if in_window else torch.zeros_like(a_prev)
