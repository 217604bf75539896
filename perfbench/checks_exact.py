"""The comparison that decides ``correct`` for a sampling cell whose
divergence is the exact trace (``perfbench/drivers/sample_exact.py``).

As in ``perfbench/checks.py``, the reference follows the program step by
step from the program's own state (resampling picks ancestors from a CDF,
so a run cannot be followed from its start alone). At every step the
reference computes the drift of every chain; inside the resampling window
it also takes the exact trace of the score's Jacobian by its own D one-hot
VJPs (``perfbench/reference/dit.py:exact_div``):

- ``x_gap``: every row of every step, the program's state after the step
  against the reference's Euler–Maruyama update of the state the program
  entered it with, from the row's ancestor, ‖Δx‖ over the median ‖learned
  drift·dt‖ of the step (drift_X less its closed form, where bf16's
  rounding sits);
- ``a_gap``: the log-weights the program resampled on (recorded as it
  handed them to ``systematic_resample``) against a_{i−1} + min(drift_A,
  q₀.₉)·dt of the reference, over the rms of the learned part of the
  increments; every chain of every step in the window;
- ``misses`` (limit 0): ancestors outside their slot of the reference's
  CDF (within the slack the a-gap limit allows), more than one wrap of the
  ancestors, log-weights not reset by a resample, missing or foreign
  states or log-weight records.
"""

import math

import torch

from perfbench.checks import _nearest, slot_misses
from perfbench.reference import dit as RD
from perfbench.reference import egnn as R
from perfbench.reference import sampler as S


def check_exact_integration(it, nets, sched, gamma, beta, lim, out, n_particles, block=128):
    """Check one integration the program ran (``it``: its observed states,
    the log-weights it resampled on, its result, its draws and settings)
    against the reference nets; readings go into ``out``
    (``perfbench.checks.Readings``). Every step in the window resamples."""
    score_net, energy_net = nets
    states, lw, log = it["states"], it["logweights"], it["log"]
    n, end, B = it["n_steps"], it["end_resampling"], states[0].shape[0]
    dev = states[0].device
    ts = S.times(n, dev)
    dt = 1.0 / n
    if len(states) != n:
        out.miss(1, f"states observed: {len(states)}, expected {n}")
        return
    if len(log["resampled_on"]) != end:
        out.miss(1, f"log-weight records: {len(log['resampled_on'])}, expected {end}")
        return
    if not torch.equal(states[0], it["x1"]):
        out.miss(1, "first state is not the prior draw handed over")
    after = lambda i: states[i + 1] if i + 1 < len(states) else it["samples"]
    a_prev = torch.zeros(B, device=dev)
    for i in range(n):
        x_i, x_o = states[i], after(i)
        t = ts[i].expand(B)
        in_window = i < end
        div_s = RD.exact_div(score_net, sched, x_i, t, beta, block) if in_window else None
        d = S.drift(score_net, energy_net, sched, gamma, x_i, t, beta, div_s)
        noise = log["noise"][i]
        if in_window:
            cand = R.remove_mean(x_i + d["drift_X"] * dt + sched.g(ts[i]) * noise * math.sqrt(dt),
                                 n_particles)
            anc, _ = _nearest(x_o, cand)
            descents = int((anc[1:] < anc[:-1]).sum())
            if descents > 1:  # u_k = (u0 + k/B) mod 1 wraps once
                out.miss(descents - 1, f"descents of the ancestors past the wrap at step {i}")
        else:
            anc = torch.arange(B, device=dev)
        # the Euler-Maruyama update, every row
        dX = d["drift_X"][anc]
        x_ref = S.em_update(x_i[anc], dX, ts[i], noise[anc], sched, dt, n_particles)
        part = dX - S.analytic(sched, gamma, x_i[anc], t)[0]
        x_scale = R.remove_mean(part * dt, n_particles).norm(dim=-1).median().clamp_min(1e-30)
        out.gap("x_gap", ((x_o - x_ref).norm(dim=-1) / x_scale).max())
        out.count("rows", B)
        out.count("steps", 1)
        if not in_window:
            continue
        # the log-weights the program resampled on, and its ancestors
        a_ref = a_prev + S.clamp_quantile(d["drift_A"]) * dt
        learned = d["drift_A"] - S.analytic(sched, gamma, x_i, t)[1]
        scale_a = (learned * dt).pow(2).mean().sqrt().clamp_min(1e-30)
        out.gap("a_gap", ((log["resampled_on"][i] - a_ref).abs() / scale_a).max())
        out.count("a_rows", B)
        allowed = lim["a_gap"] * float(scale_a)
        out.miss(slot_misses(anc, a_ref, log["u0"][i], (1e-5, 2 * allowed)),
                 f"rows with an ancestor outside its CDF slot at step {i}")
        out.count("resampled_rows", B)
        if bool((lw[i] != 0).any()):
            out.miss(1, f"log-weights not reset by the resample at step {i}")
        a_prev = lw[i]
