"""The port's DiT3D against pita_tpu's flax DiT3D on the CPU: the forward in
float32 and bfloat16 with the same weights carried across by
dit_params_from_tree, the score and energy wrappers, flax's initial
distributions, and the exact and Hutchinson traces the sampler takes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.nets.dit import DiT3DBackbone as JaxDiT
from pita_tpu.nets.precondition import EnergyWrapper as JaxEnergy
from pita_tpu.nets.precondition import ScoreWrapper as JaxScore
from pita_tpu.ops.divergence import exact_divergence as jax_exact_divergence
from pita_torch.io.flax_params import dit_params_from_tree
from pita_torch.nets import DiT3DBackbone, EnergyWrapper, ScoreWrapper
from pita_torch.ops.divergence import exact_divergence, hutchinson_divergence
from pita_torch.sampler.terms import compute_sde_terms
from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
from torch_threads import one_intra_op_thread  # noqa: F401

N = 22  # aldp
NARROW = dict(hidden_size=32, cond_dim=32, n_heads=4, n_blocks=2)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(B=8, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, N * 3))).astype(np.float32)
    t = rng.uniform(-2.0, 1.0, B).astype(np.float32)
    beta = rng.uniform(0.25, 1.0, B).astype(np.float32)
    return x, t, beta


def _pair(dtype="float32", perturb=True, seed=0):
    """A flax DiT3D with its init weights and the port's with the same ones.
    With ``perturb`` every weight gets N(0, 0.05²) noise: flax zeroes the
    modulation and the final layer, so its initial output is exactly 0."""
    jd, td, _ = DTYPES[dtype]
    jnet = JaxDiT(n_particles=N, compute_dtype=jd, **NARROW)
    x, t, b = _inputs()
    params = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(t), jnp.asarray(x), jnp.asarray(b))
    if perturb:
        leaves, tree = jax.tree.flatten(params)
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
        params = jax.tree.unflatten(
            tree, [a + 0.05 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
    tnet = DiT3DBackbone(n_particles=N, compute_dtype=td, **NARROW)
    tnet.load_state_dict(dit_params_from_tree(jax.tree.map(np.asarray, params), 2), strict=True)
    return jnet, params, tnet


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_flax(dtype):
    jnet, params, tnet = _pair(dtype)
    x, t, b = _inputs(16, seed=1)
    ref = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(t), jnp.asarray(x), jnp.asarray(b)))
    got = tnet(torch.as_tensor(t), torch.as_tensor(x), torch.as_tensor(b)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (16, N * 3)
    tol = DTYPES[dtype][2]
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    # flax's own initial weights carry across too: its output is zero
    jnet, params, tnet = _pair(dtype, perturb=False)
    got = tnet(torch.as_tensor(t), torch.as_tensor(x), torch.as_tensor(b))
    assert float(got.detach().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrappers_match_flax(dtype):
    """ScoreWrapper's score and EnergyWrapper's energy and x-gradient."""
    jnet, params, tnet = _pair(dtype)
    x, _, beta = _inputs(8, seed=2)
    ht = np.random.default_rng(3).uniform(0.05, 4.0, 8).astype(np.float32)
    J = dict(ht=jnp.asarray(ht), xt=jnp.asarray(x), beta=jnp.asarray(beta))
    T = dict(ht=torch.as_tensor(ht), xt=torch.as_tensor(x), beta=torch.as_tensor(beta))
    tol = DTYPES[dtype][2]
    jit = lambda f: jax.jit(lambda p, kw: f(p, **kw))
    pairs = [
        (jit(JaxScore(jnet).score)(params, J), ScoreWrapper(tnet).score(**T)),
        (jit(JaxEnergy(jnet).energy)(params, J), EnergyWrapper(tnet).energy(**T)),
        (jit(JaxEnergy(jnet).grad_x)(params, J), EnergyWrapper(tnet).grad_x(**T)),
    ]
    for name, (ref, got) in zip(("score", "energy", "grad_x"), pairs):
        ref, got = np.asarray(ref), got.detach().numpy()
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), name


def test_reset_parameters_draws_flax_distributions():
    """Zero modulations and final layer, unit LayerNorm scales, zero biases,
    and lecun-normal kernels (truncated at 2σ, variance 1/fan_in) whose
    sample std is within 4 standard errors of flax's."""
    net = DiT3DBackbone(n_particles=N).reset_parameters(torch.Generator().manual_seed(0))
    x, t, b = _inputs()
    jparams = JaxDiT(n_particles=N).init(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(x),
                                         jnp.asarray(b))
    zeroed = {"final_ada", "final_out"} | {f"blocks.{i}.ada" for i in range(6)}
    ref = dit_params_from_tree(jax.tree.map(np.asarray, jparams), 6)
    assert ref.keys() == net.state_dict().keys()
    for name, p in net.state_dict().items():
        mod, kind = name.rsplit(".", 1)
        if "norm" in mod:
            assert torch.equal(p, torch.ones_like(p)), name
        elif kind == "bias" or mod in zeroed:
            assert float(p.abs().max()) == 0.0 and float(ref[name].abs().max()) == 0.0, name
        else:
            fan_in = p.shape[1]
            std = float(p.std())
            flax_std = float(ref[name].std())
            want = np.sqrt(1.0 / fan_in)  # the truncated normal's std
            se = want / np.sqrt(2 * p.numel())
            assert abs(std - want) <= 4 * se + 1e-3 * want, (name, std, want)
            assert abs(flax_std - want) <= 4 * se + 1e-3 * want, (name, flax_std, want)
            assert float(p.abs().max()) <= 2 * want / 0.87962566103423978 + 1e-6, name


def test_route_protocol():
    net = DiT3DBackbone(n_particles=N, **NARROW)
    assert net.route == "autograd"
    for route in ("kernels", "autograd"):
        copy = net.with_route(route)
        assert copy is not net and copy.route == "autograd"
        for a, b in zip(copy.parameters(), net.parameters()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_exact_trace_matches_jax_forward_mode():
    """div_x of the DiT score by the port's D VJPs (exact_divergence, and
    through compute_sde_terms in the preset's "exact" mode, which a non-EGNN
    score takes there) against pita_tpu's linearize/jvp trace, within 1e-4
    of the largest; the Hutchinson estimate against εᵀJε by jax.jvp."""
    jnet, params, tnet = _pair("float32")
    x, _, _ = _inputs(6, seed=4)
    beta = 0.63  # one inverse temperature for all chains, as the sampler has it
    ht = np.random.default_rng(5).uniform(0.1, 3.0, 6).astype(np.float32)
    jscore = lambda h, xx: JaxScore(jnet).score(params, h, xx, beta)
    ref = np.asarray(jax.jit(lambda h, xx: jax_exact_divergence(jscore, h, xx))(
        jnp.asarray(ht), jnp.asarray(x)))
    tscore = lambda h, xx: ScoreWrapper(tnet).score(h, xx, beta)
    got = exact_divergence(tscore, torch.as_tensor(ht), torch.as_tensor(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()

    noise = ElucidatingNoiseSchedule(sigma_min=0.01, sigma_max=80.0, rho=7.0)
    t = torch.as_tensor(np.random.default_rng(6).uniform(0.2, 0.9, 6).astype(np.float32))
    xt = torch.as_tensor(x)
    terms = compute_sde_terms(ScoreWrapper(tnet), EnergyWrapper(tnet), noise,
                              ConstantAnnealingSchedule(annealing_factor=1.0), t, xt,
                              beta, divergence_mode="exact")
    g2 = noise.g(t) ** 2
    direct = exact_divergence(
        lambda tq, xq: ScoreWrapper(tnet).score(noise.h(tq), xq, beta), t, xt)
    torch.testing.assert_close(terms.divergence, direct * g2 / 2, rtol=1e-5, atol=1e-6)

    probes = np.random.default_rng(7).choice([-1.0, 1.0], (3, 6, N * 3)).astype(np.float32)
    est = hutchinson_divergence(tscore, torch.as_tensor(ht), torch.as_tensor(x),
                                torch.as_tensor(probes)).numpy()
    jvp = jax.jit(lambda e: jax.jvp(lambda xx: jscore(jnp.asarray(ht), xx), (jnp.asarray(x),),
                                    (e,))[1])
    want = np.mean([np.sum(np.asarray(jvp(jnp.asarray(e))) * e, -1) for e in probes], 0)
    assert np.abs(est - want).max() <= 1e-4 * np.abs(want).max()
