"""Plain PyTorch reference of PITA's weighted reverse-SDE step.

One Euler–Maruyama step of the annealed reverse SDE with Feynman–Kac
log-weights (PITA, arXiv 2506.16471, eqs. for the debiased drift), on the
reference nets of ``perfbench/reference/egnn.py``:

    drift_X = γ·(−∇ₓU)·g²/2 + γ·b,          b = s_θ·g²/2,
    drift_A = γ²·⟨−∇ₓU, b⟩ + γ·div b + γ·∂U/∂t (+ dγ/dt·U, 0 here),

drift_A clamped at its batch 0.9 quantile; x ← x + drift_X·dt + g·ε·√dt,
projected to zero centre of mass; a ← a + drift_A·dt inside the resampling
window; systematic resampling on softmax(a) with each weight clipped to
[1e-6, 1]; ESS = 1/Σw̄². div b by Hutchinson (Rademacher probes, εᵀJε).

The terms are computed in blocks of chains so that the (B, N, N, F) edge
tensors fit; everything under ``strict_f32``.
"""

import math

import torch

from perfbench.reference import egnn as R


def times(n_steps, device):
    """The step times 1 → 0 (float32, as ``torch.linspace`` gives them)."""
    return torch.linspace(1.0, 0.0, n_steps + 1, device=device)[:-1]


def _blocks(B, block):
    return [slice(s, min(s + block, B)) for s in range(0, B, block)]


def energy_terms(energy_net, sched, x, t, beta, block=256):
    """U, ∇ₓU and ∂U/∂t per chain at times t (B,)."""
    Us, gs, dts = [], [], []
    for sl in _blocks(x.shape[0], block):
        with torch.enable_grad():
            xx = x[sl].detach().requires_grad_(True)
            tt = t[sl].detach().requires_grad_(True)
            U = R.energy(energy_net, sched.h(tt), xx, beta)
            g, dt = torch.autograd.grad(U.sum(), (xx, tt))
        Us.append(U.detach())
        gs.append(g)
        dts.append(dt)
    return torch.cat(Us), torch.cat(gs), torch.cat(dts)


@torch.no_grad()
def scores(score_net, sched, x, t, beta, block=256):
    return torch.cat([R.score(score_net, sched.h(t[sl]), x[sl], beta)
                      for sl in _blocks(x.shape[0], block)])


def hutchinson_div(score_net, sched, x, t, beta, probes, block=256):
    """Mean over the P probes of εᵀ(∂s/∂x)ε, (B,); probes (P, B, D)."""
    P = probes.shape[0]
    out = []
    for sl in _blocks(x.shape[0], max(block // P, 1)):
        b = x[sl].shape[0]
        with torch.enable_grad():
            xr = x[sl].detach().repeat(P, 1).requires_grad_(True)
            y = R.score(score_net, sched.h(t[sl].repeat(P)), xr, beta)
            eps = probes[:, sl].reshape(P * b, -1)
            (jt,) = torch.autograd.grad(y, xr, eps)
        out.append((jt * eps).sum(-1).reshape(P, b).mean(0))
    return torch.cat(out)


def drift(score_net, energy_net, sched, gamma, x, t, beta, div_s=None):
    """drift_X (B, D) and, with ``div_s`` (the score's divergence, (B,)),
    drift_A (B,) before the quantile clamp, and its parts."""
    g2 = sched.g(t) ** 2
    U, gU, dUdt = energy_terms(energy_net, sched, x, t, beta)
    b = scores(score_net, sched, x, t, beta) * g2[:, None] / 2
    drift_X = gamma * (-gU) * g2[:, None] / 2 + gamma * b
    out = dict(drift_X=drift_X, U=U, dUdt=dUdt, inner=(-gU * b).sum(-1))
    if div_s is not None:
        out["div_bt"] = div_s * g2 / 2
        out["drift_A"] = gamma * gamma * out["inner"] + gamma * out["div_bt"] + gamma * dUdt
    return out


def analytic(sched, gamma, x, t):
    """The part of drift_X and drift_A that the preconditioning gives with
    the network's output F at zero, in closed form: s = −x/(1 + h),
    E = ‖x‖²/(2(1 + h)), div s = −D/(1 + h). What the checks compare is
    measured against the rest, the part the network contributes."""
    h, g2 = sched.h(t), sched.g(t) ** 2
    D = x.shape[-1]
    r2 = (x * x).sum(-1)
    b = -x * (g2 / (2 * (1 + h)))[:, None]
    drift_X = gamma * (-x / (1 + h)[:, None]) * (g2 / 2)[:, None] + gamma * b
    inner = r2 * g2 / (2 * (1 + h) ** 2)
    div_bt = -D * g2 / (2 * (1 + h))
    dUdt = -r2 / (2 * (1 + h) ** 2) * sched.dh_dt(t)
    return drift_X, gamma * gamma * inner + gamma * div_bt + gamma * dUdt


def clamp_quantile(v, q=0.9):
    return torch.minimum(v, torch.quantile(v, q))


def em_update(x, drift_X, t_i, noise, sched, dt, n_particles=55):
    x_next = x + drift_X * dt + sched.g(t_i) * noise * math.sqrt(dt)
    return R.remove_mean(x_next, n_particles)


def clipped_cdf(a):
    return torch.cumsum(torch.clamp(torch.softmax(a.double(), 0), 1e-6, 1.0), 0)


def systematic(a, u0):
    """Ancestors of systematic resampling on softmax(a) (weights clipped to
    [1e-6, 1], the CDF inverted at u0 + k/B); also the CDF and the points."""
    B = a.shape[0]
    u = (u0.double() + torch.arange(B, dtype=torch.float64, device=a.device) / B) % 1.0
    cdf = clipped_cdf(a)
    idx = torch.clamp(torch.searchsorted(cdf, u, right=False), 0, B - 1)
    return idx, cdf, u


def ess(a):
    la = a.double() - torch.logsumexp(a.double(), 0)
    return float(torch.exp(-torch.logsumexp(2 * la, 0)) / a.shape[0])


@torch.no_grad()
def integrate(nets, sched, gamma, x1, beta, draws, *, n_steps, end_resampling,
              ess_threshold=None, div_interval=1, resample=True):
    """The reference sampler run end to end (the controls put it in the
    program's place): returns the states entering each step, the log-weight
    rows and the samples, as the program's observed run gives them; the
    divergence by Hutchinson on draws.probes every ``div_interval``-th
    step."""
    score_net, energy_net = nets
    dev = x1.device
    B, D = x1.shape
    ts = times(n_steps, dev)
    dt = 1.0 / n_steps
    x, a = x1.clone(), torch.zeros(B, device=dev)
    div_c = torch.zeros(B, device=dev)
    states, rows = [], []
    for i in range(n_steps):
        states.append(x)
        t = ts[i].expand(B)
        rediv = i % div_interval == 0
        if rediv:
            div_s = hutchinson_div(score_net, sched, x, t, beta, draws.probes(i))
        d = drift(score_net, energy_net, sched, gamma, x, t, beta, div_s)
        if not rediv:
            d["drift_A"] = gamma * gamma * d["inner"] + gamma * div_c + gamma * d["dUdt"]
            div_new = div_c
        else:
            div_new = d["div_bt"]
        drift_A = clamp_quantile(d["drift_A"])
        x_next = em_update(x, d["drift_X"], ts[i], draws.noise(i), sched, dt)
        in_window = i < end_resampling
        a_next = a + drift_A * dt if in_window else torch.zeros_like(a)
        u0 = draws.u0(i)
        if resample and in_window:
            fire = ess_threshold is None or ess(a_next) < ess_threshold
            if fire:
                idx = systematic(a_next, u0)[0]
                x_next, div_new = x_next[idx], div_new[idx]
                a_next = torch.zeros_like(a_next)
        x, a, div_c = x_next, a_next, div_new
        rows.append(a)
    return dict(states=states, logweights=torch.stack(rows), samples=x)
