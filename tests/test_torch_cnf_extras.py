"""The port's CNF likelihood and the extras components against pita_tpu
(CPU), on the same numpy inputs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.nets import MLPBackbone as JaxMLP
from pita_tpu.nets import extras as jx
from pita_tpu.sampler.cnf import cnf_nll as jax_cnf_nll
from pita_tpu.schedules import ElucidatingNoiseSchedule as JaxSched
from pita_torch.io.flax_params import _dense, mlp_params_from_tree
from pita_torch.nets import MLPBackbone
from pita_torch.nets import extras as tx
from pita_torch.sampler import cnf_nll
from pita_torch.schedules import ElucidatingNoiseSchedule
from tests.test_sampler import AnalyticScore
from torch_threads import one_intra_op_thread  # noqa: F401


SCHED = dict(sigma_min=0.01, sigma_max=10.0, rho=7.0)
SIGMA0_SQ = 1.0


class GaussianScore:
    """The exact score of N(0, σ0² I) noised by h: −x/(σ0² + h)."""

    def score(self, ht, xt, beta):
        ht = torch.as_tensor(ht, dtype=xt.dtype).reshape(-1).expand(xt.shape[0])
        return -xt / (SIGMA0_SQ + ht[:, None])


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(1.0, np.abs(ref).max()))


def test_cnf_nll_on_a_gaussian_matches_jax_and_the_closed_form():
    x0 = (np.random.default_rng(0).normal(size=(32, 2)) * math.sqrt(SIGMA0_SQ)).astype(
        np.float32)
    ref = jax.jit(lambda x: jax_cnf_nll(jax.random.PRNGKey(1), x, AnalyticScore(), {},
                                        JaxSched(**SCHED), num_steps=60, exact=True))(
        jnp.asarray(x0))
    got = cnf_nll(torch.as_tensor(x0), GaussianScore(), ElucidatingNoiseSchedule(**SCHED),
                  num_steps=60, exact=True)
    for a in ("x1", "delta_logp", "nll"):
        _close(getattr(got, a), getattr(ref, a), 1e-4)
    true_nll = 0.5 * (x0 ** 2).sum(-1) / SIGMA0_SQ + math.log(2 * math.pi * SIGMA0_SQ)
    np.testing.assert_allclose(got.nll.numpy(), true_nll, rtol=0.05, atol=0.05)
    # the Hutchinson estimate with many probes stays near the exact one
    hutch = cnf_nll(torch.as_tensor(x0), GaussianScore(), ElucidatingNoiseSchedule(**SCHED),
                    num_steps=60, exact=False, hutchinson_probes=64,
                    generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(hutch.nll.numpy(), got.nll.numpy(), rtol=0.1, atol=0.2)


def _mlp(seed=0):
    mod = JaxMLP(out_dim=2, hidden_size=16, hidden_layers=1, emb_size=8)
    p = mod.init(jax.random.PRNGKey(seed), jnp.zeros(3), jnp.zeros((3, 2)), jnp.ones(3))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.2 * rng.normal(size=a.shape),
                                           jnp.float32), p)
    net = MLPBackbone(2, 2, hidden_size=16, hidden_layers=1, emb_size=8)
    net.load_state_dict(mlp_params_from_tree(jax.tree.map(np.asarray, p)))
    return mod, p, net


def _xt(B=6):
    rng = np.random.default_rng(5)
    return (rng.normal(size=(B, 2)).astype(np.float32),
            rng.uniform(0.2, 2.0, size=B).astype(np.float32))


def test_simple_debug_score_and_flow_wrapper():
    x, ht = _xt()
    mean = np.array([1.0, -1.0], np.float32)
    js, ts = jx.SimpleDebugScore(jnp.asarray(mean)), tx.SimpleDebugScore(torch.as_tensor(mean))
    D, s = ts.denoiser(torch.as_tensor(ht), torch.as_tensor(x), 1.0, return_score=True)
    jD, js_ = js.denoiser({}, jnp.asarray(ht), jnp.asarray(x), 1.0, return_score=True)
    _close(D, jD, 1e-6)
    _close(s, js_, 1e-6)
    _close(ts.score(torch.as_tensor(ht), torch.as_tensor(x), 1.0),
           js.score({}, jnp.asarray(ht), jnp.asarray(x), 1.0), 1e-6)

    mod, p, net = _mlp()
    jf, tf = jx.FlowWrapper(mod), tx.FlowWrapper(net)
    _close(tf.denoiser(torch.as_tensor(ht), torch.as_tensor(x), 1.0),
           jf.denoiser(p, jnp.asarray(ht), jnp.asarray(x), 1.0), 1e-5)
    _close(tf.score(torch.as_tensor(ht), torch.as_tensor(x), 1.0),
           jf.score(p, jnp.asarray(ht), jnp.asarray(x), 1.0), 1e-5)


def test_scaling_wrapper_weighter_and_scaler():
    mod, p, net = _mlp(1)
    x, ht = _xt()
    jnet = jx.ScalingWrapper(backbone=mod, input_scale=2.0, output_scale=3.0)
    ref = jnet.apply({"params": {"backbone": p["params"]}}, jnp.asarray(ht), jnp.asarray(x), 1.0)
    got = tx.ScalingWrapper(net, input_scale=2.0, output_scale=3.0)(
        torch.as_tensor(ht), torch.as_tensor(x), 1.0)
    _close(got, ref, 1e-5)
    for kind in ("edm", "ones", "basic"):
        _close(tx.LambdaWeighter(kind)(torch.as_tensor(ht)),
               jx.LambdaWeighter(kind)(jnp.asarray(ht)), 1e-6)
    with pytest.raises(ValueError):
        tx.LambdaWeighter("nope")
    js, ts = jx.ScoreScaler(None), tx.ScoreScaler(None)
    scaled = ts.scale_target_score(torch.as_tensor(x), torch.as_tensor(ht))
    _close(scaled, js.scale_target_score(jnp.asarray(x), jnp.asarray(ht)), 1e-6)
    _close(ts.unscale_score(scaled, torch.as_tensor(ht)), x, 1e-6)


def test_pis_net_matches_jax():
    mod = jx.PISNet(out_dim=2, hidden_size=16, emb_size=8)
    x, ht = _xt()
    score = -x
    p = mod.init(jax.random.PRNGKey(0), jnp.zeros(6), jnp.asarray(x), jnp.asarray(score))
    rng = np.random.default_rng(2)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.2 * rng.normal(size=a.shape), p)
    sd = {}
    for j, name in enumerate(("drift0", "drift1", "drift_out", "coeff_out", "coeff0")):
        _dense(sd, name, p["params"][f"Dense_{j}"])
    net = tx.PISNet(2, 2, hidden_size=16, emb_size=8)
    net.load_state_dict(sd)
    ref = mod.apply(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p), jnp.asarray(ht),
                    jnp.asarray(x), jnp.asarray(score))
    _close(net(torch.as_tensor(ht), torch.as_tensor(x), torch.as_tensor(score)), ref, 1e-5)
    fresh = tx.PISNet(2, 2).reset_parameters(torch.Generator().manual_seed(0))
    assert float(fresh.drift_out.weight.detach().abs().max()) == 0.0
