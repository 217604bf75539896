"""The port's Hutch++ trace, exact Laplacian, pinned energy and the drift
terms of the score-free and the pinned sampler against pita_tpu (CPU), on
the same inputs made with numpy; the generic exact trace's one-forward form
against its replicated form and pita_tpu on every autograd-route backbone,
and which of the two forms the sampler and the CNF take by route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets import TorchMDETBackbone as JaxET
from pita_tpu.nets.dit import DiT3DBackbone as JaxDiT
from pita_tpu.nets import EnergyWrapper as JaxEnergy
from pita_tpu.nets import MLPBackbone as JaxMLP
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.ops.divergence import exact_divergence as jax_exact_div
from pita_tpu.ops.divergence import exact_laplacian as jax_laplacian
from pita_tpu.ops.divergence import hutchpp_divergence as jax_hutchpp
from pita_tpu.sampler.terms import compute_sde_terms as jax_terms
from pita_tpu.schedules import ConstantAnnealingSchedule as JaxConst
from pita_tpu.schedules import ElucidatingNoiseSchedule as JaxSched
from pita_tpu.targets import LJ13 as JaxLJ13
from pita_torch.io.flax_params import (dit_params_from_tree, load_egnn_params,
                                       mlp_params_from_tree, torchmd_et_params_from_tree)
from pita_torch.nets import (DiT3DBackbone, EGNNBackbone, EnergyWrapper, MLPBackbone,
                             ScoreWrapper, TorchMDETBackbone)
from pita_torch.ops.divergence import (exact_divergence, exact_divergence_replicated,
                                       exact_laplacian, hutchpp_divergence)
from pita_torch.sampler import cnf, cnf_nll, terms
from pita_torch.sampler.terms import compute_sde_terms
from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
from pita_torch.targets import LJ13
from tests.test_torch_dit_reference import no_batching_fallback
from torch_threads import one_intra_op_thread  # noqa: F401


SCHED = dict(sigma_min=0.05, sigma_max=10.0, rho=7.0)
D_MLP = 6


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _mlp_pair(seed=0):
    """pita_tpu's MLP with random (nonzero) weights, and the port's with the
    same ones through mlp_params_from_tree."""
    mod = JaxMLP(out_dim=D_MLP, hidden_size=16, hidden_layers=1, emb_size=8, input_scale=2.0)
    p = jax.jit(mod.init)(jax.random.PRNGKey(seed), jnp.zeros(2), jnp.zeros((2, D_MLP)),
                          jnp.ones(2))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.3 * rng.normal(size=a.shape),
                                           jnp.float32), p)
    net = MLPBackbone(D_MLP, D_MLP, hidden_size=16, hidden_layers=1, emb_size=8,
                      input_scale=2.0)
    net.load_state_dict(mlp_params_from_tree(jax.tree.map(np.asarray, p)))
    return mod, p, net


def _mlp_inputs(B=5):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, D_MLP)).astype(np.float32)
    t = rng.uniform(0.1, 0.9, size=B).astype(np.float32)
    return x, t


@pytest.mark.parametrize("rank", [3, D_MLP])
def test_hutchpp_divergence_matches_jax_and_the_exact_trace_at_full_rank(rank):
    mod, p, net = _mlp_pair()
    x, t = _mlp_inputs()
    js, ts = JaxScore(mod), ScoreWrapper(net)
    jsched, tsched = JaxSched(**SCHED), ElucidatingNoiseSchedule(**SCHED)
    jf = lambda tt, xx: js.score(p, jsched.h(tt), xx, 1.0)
    tf = lambda tt, xx: ts.score(tsched.h(tt), xx, 1.0)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    S = jax.random.rademacher(k1, (rank, 5, D_MLP), dtype=jnp.float32)
    G = jax.random.rademacher(k2, (2, 5, D_MLP), dtype=jnp.float32)
    ref = jax.jit(lambda tt, xx: jax_hutchpp(jf, tt, xx, key, rank=rank, num_probes=2))(
        jnp.asarray(t), jnp.asarray(x))
    got = hutchpp_divergence(tf, torch.as_tensor(t), torch.as_tensor(x),
                             torch.as_tensor(np.array(S)), torch.as_tensor(np.array(G)),
                             tangent_chunk=4)
    _close(got, ref, 1e-4)
    if rank >= D_MLP:  # the sketch spans the space: the exact trace
        exact = exact_divergence(tf, torch.as_tensor(t), torch.as_tensor(x))
        _close(got, exact.numpy(), 1e-4)
        _close(exact, jax.jit(lambda tt, xx: jax_exact_div(jf, tt, xx))(jnp.asarray(t),
                                                                         jnp.asarray(x)), 1e-4)


def test_exact_laplacian_matches_jax():
    mod, p, net = _mlp_pair(1)
    x, t = _mlp_inputs()
    je, te = JaxEnergy(mod), EnergyWrapper(net)
    jsched, tsched = JaxSched(**SCHED), ElucidatingNoiseSchedule(**SCHED)
    ref = jax.jit(lambda t0, x0: jax_laplacian(lambda tt, xx: je.energy(p, jsched.h(tt), xx, 1.0),
                                               t0, x0))(jnp.asarray(t), jnp.asarray(x))
    got = exact_laplacian(lambda tt, xx: te.energy(tsched.h(tt), xx, 1.0),
                          torch.as_tensor(t), torch.as_tensor(x), row_chunk=4)
    _close(got, ref, 1e-4)


def _egnn_pair(seed=0):
    """pita_tpu's LJ13 EGNN (hidden 8, 1 layer) and the port's on the
    kernel route (the plain layers on the CPU) with the same weights."""
    mod = JaxEGNN(n_particles=13, hidden_nf=8, n_layers=1)
    init = jax.jit(mod.init)
    params = [init(jax.random.PRNGKey(seed + i), jnp.zeros((2,)), jnp.zeros((2, 39)), 1.0)
              for i in range(2)]
    nets = []
    for q in params:
        bb = EGNNBackbone(13, hidden_nf=8, n_layers=1)
        bb.load_state_dict(load_egnn_params(serialization.to_bytes(q), 1))
        nets.append(bb)
    return mod, params, nets


def _lj_inputs(B=6):
    rng = np.random.default_rng(4)
    side = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(2)])[:13]
    x = (side * 1.1 + 0.08 * rng.normal(size=(B, 13, 3))).reshape(B, 39).astype(np.float32)
    x -= x.reshape(B, 13, 3).mean(1).repeat(13, 0).reshape(B, 39)
    t = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
    return x, t


def test_pinned_energy_and_its_gradient_match_jax():
    mod, (p, _), (net, _) = _egnn_pair()
    x, t = _lj_inputs()
    jt, tt = JaxLJ13(temperature=2.0), LJ13(temperature=2.0)
    ht = (t * 3.0).astype(np.float32)
    je, te = JaxEnergy(mod), EnergyWrapper(net.with_route("autograd"))
    pinned = jax.jit(lambda xx: je.energy(p, jnp.asarray(ht), xx, 1.0, pin=True,
                                          t=jnp.asarray(t), energy_function=jt))
    ref, ref_g = jax.value_and_grad(lambda xx: jnp.sum(pinned(xx)))(jnp.asarray(x))
    xx = torch.as_tensor(x).requires_grad_(True)
    E = te.energy(torch.as_tensor(ht), xx, 1.0, pin=True, t=torch.as_tensor(t),
                  energy_function=tt.log_prob)
    (g,) = torch.autograd.grad(E.sum(), xx)
    _close(E.sum(), ref, 1e-5)
    _close(g, ref_g, 1e-5)
    _close(E, pinned(jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("case", ["score_free", "pinned_exact"])
def test_drift_terms_match_jax(case):
    """compute_sde_terms of the score-free path (exact Laplacian of the
    energy net, on its autograd copy here) and of the pinned energy with the
    exact trace, against pita_tpu's within 1e-4. (pita_tpu's score-free path
    with pinning raises: its per-sample Laplacian gets the batch's times.)"""
    mod, (ps, pe), (bs, be) = _egnn_pair(1)
    x, _ = _lj_inputs()
    t = np.full(6, 0.4, np.float32)
    pin = case == "pinned_exact"
    jtarget, ttarget = JaxLJ13(temperature=2.0), LJ13(temperature=2.0)
    with_score = case == "pinned_exact"
    ref = jax.jit(lambda tt, xx: jax_terms(
        JaxScore(mod) if with_score else None, JaxEnergy(mod), ps if with_score else None, pe,
        JaxSched(**SCHED), JaxConst(annealing_factor=1.5), tt, xx, 1.0, pin_energy=pin,
        energy_function=jtarget if pin else None))(jnp.asarray(t), jnp.asarray(x))
    got = compute_sde_terms(ScoreWrapper(bs) if with_score else None, EnergyWrapper(be),
                            ElucidatingNoiseSchedule(**SCHED),
                            ConstantAnnealingSchedule(annealing_factor=1.5),
                            torch.as_tensor(t), torch.as_tensor(x), 1.0, pin_energy=pin,
                            energy_function=ttarget.log_prob if pin else None)
    _close(got.drift_X, ref.drift_X, 1e-4)
    _close(got.drift_A, ref.drift_A, 1e-4)
    _close(got.divergence, ref.divergence, 1e-4)


def _perturbed(params, seed, scale):
    """Every leaf of a flax tree with N(0, scale²) noise added, in float32:
    flax zeroes some layers, and a zero layer leaves a trace nothing to
    judge."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)
                                              + scale * rng.normal(size=a.shape),
                                              jnp.float32), params)


def _dit_case(dtype):
    """A narrow DiT3D over 6 particles (D = 18: one block of 16 rows and one
    of 2) in ``dtype``, flax's and the port's with the same weights."""
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(hidden_size=32, cond_dim=32, n_heads=4, n_blocks=2)
    mod = JaxDiT(n_particles=6, compute_dtype=jd, **kw)
    p = _perturbed(jax.jit(mod.init)(jax.random.PRNGKey(2), jnp.zeros(2), jnp.zeros((2, 18)),
                                     jnp.ones(2)), 2, 0.05)
    net = DiT3DBackbone(n_particles=6, compute_dtype=td, **kw)
    net.load_state_dict(dit_params_from_tree(jax.tree.map(np.asarray, p), 2), strict=True)
    return mod, p, net, 18


def _mlp_case():
    mod, p, net = _mlp_pair(2)
    return mod, p, net, D_MLP


def _egnn2d_case():
    """DW4's 2-D EGNN (4 particles, D = 8) on the autograd route."""
    mod = JaxEGNN(n_particles=4, n_spatial_dim=2, hidden_nf=8, n_layers=2)
    p = jax.jit(mod.init)(jax.random.PRNGKey(3), jnp.zeros((2,)), jnp.zeros((2, 8)), 1.0)
    net = EGNNBackbone(4, n_spatial_dim=2, hidden_nf=8, n_layers=2, route="autograd")
    net.load_state_dict(load_egnn_params(serialization.to_bytes(p), 2))
    return mod, p, net, 8


def _torchmd_et_case():
    """TorchMD-ET over 5 particles (D = 15), its weights perturbed."""
    kw = dict(hidden=16, n_layers=2, num_heads=2, num_rbf=8)
    mod = JaxET(n_particles=5, **kw)
    p = _perturbed(jax.jit(mod.init)(jax.random.PRNGKey(4), jnp.zeros(2), jnp.zeros((2, 15)),
                                     jnp.ones(2)), 4, 0.1)
    net = TorchMDETBackbone(5, **kw)
    net.load_state_dict(torchmd_et_params_from_tree(jax.tree.map(np.asarray, p)))
    return mod, p, net, 15


# case: (backbone, chains, chunk_size, tolerance against the replicated form, against pita_tpu)
TRACE_CASES = {
    "dit_f32": (lambda: _dit_case("f32"), 5, None, 1e-5, 1e-4),
    "dit_bf16": (lambda: _dit_case("bf16"), 5, None, 1e-3, 5e-3),
    "mlp": (_mlp_case, 5, None, 1e-5, 1e-4),
    "egnn2d_autograd": (_egnn2d_case, 5, None, 1e-5, 1e-4),
    "torchmd_et": (_torchmd_et_case, 5, None, 1e-5, 1e-4),
    "dit_f32_chain_chunks": (lambda: _dit_case("f32"), 7, 3, 1e-5, 1e-4),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_exact_divergence_one_forward_matches_the_replicated_form_and_jax(case):
    """The trace by one forward and the one-hot rows as batched cotangents
    against the forward and backward per block of rows (4 rows a block,
    so D = 6, 8, 15 and 18 end on a part block) and pita_tpu's
    linearize/jvp trace; no op's backward falls back to vmap's loop over
    the rows for want of a batching rule."""
    build, B, chunk, tol_rep, tol_jax = TRACE_CASES[case]
    mod, p, net, D = build()
    rng = np.random.default_rng(8)
    x = (0.5 * rng.normal(size=(B, D))).astype(np.float32)
    ht = rng.uniform(0.2, 3.0, size=B).astype(np.float32)
    js, ts = JaxScore(mod), ScoreWrapper(net)
    tf = lambda hq, xq: ts.score(hq, xq, 0.7)
    with no_batching_fallback():
        got = exact_divergence(tf, torch.as_tensor(ht), torch.as_tensor(x), chunk_size=chunk,
                               row_chunk=4)
    rep = exact_divergence_replicated(tf, torch.as_tensor(ht), torch.as_tensor(x),
                                      chunk_size=chunk, row_chunk=4)
    ref = jax.jit(lambda hh, xx: jax_exact_div(lambda h, y: js.score(p, h, y, 0.7), hh, xx))(
        jnp.asarray(ht), jnp.asarray(x))
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, rep.numpy(), tol_rep)
    _close(got, ref, tol_jax)


class _Recorder:
    """Wraps both forms of the exact trace in a module and records which ran."""

    def __init__(self, monkeypatch, module):
        self.ran = []
        for name in ("exact_divergence", "exact_divergence_replicated"):
            real = getattr(module, name)
            monkeypatch.setattr(module, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def run(*args, **kw):
            self.ran.append(name)
            return real(*args, **kw)
        return run


def _small_dit():
    net = DiT3DBackbone(n_particles=5, hidden_size=16, cond_dim=16, n_heads=2, n_blocks=1,
                        compute_dtype=torch.float32)
    with torch.no_grad():
        for w in net.parameters():
            w.add_(0.05 * torch.randn(w.shape, generator=torch.Generator().manual_seed(6)))
    return net


@pytest.mark.parametrize("backbone,want", [("egnn_kernels", "exact_divergence_replicated"),
                                           ("dit", "exact_divergence")])
def test_the_sampler_and_the_cnf_take_the_trace_form_by_route(monkeypatch, backbone, want):
    """``compute_sde_terms`` in ``exact_generic`` mode and ``cnf_nll`` take
    the replicated trace for a score on the EGNN's kernel route (whose
    backward K3 has no batching rule) and the one-forward trace for any
    other backbone, here the DiT3D."""
    if backbone == "dit":
        bs, be = _small_dit(), _small_dit()
        B = 4
        x = 0.5 * torch.randn(B, 15, generator=torch.Generator().manual_seed(7))
    else:
        _, _, (bs, be) = _egnn_pair(2)
        assert bs.route == "kernels"
        B = 3
        x = torch.as_tensor(_lj_inputs(B)[0])
    sched = ElucidatingNoiseSchedule(**SCHED)
    rec = _Recorder(monkeypatch, terms)
    compute_sde_terms(ScoreWrapper(bs), EnergyWrapper(be), sched,
                      ConstantAnnealingSchedule(annealing_factor=1.5), torch.full((B,), 0.4), x,
                      1.0, divergence_mode="exact_generic")
    assert rec.ran == [want]
    rec = _Recorder(monkeypatch, cnf)
    cnf_nll(x, ScoreWrapper(bs), sched, num_steps=1)
    assert rec.ran == [want]
