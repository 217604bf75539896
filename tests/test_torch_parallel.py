"""The port's sharded sampling, data-parallel step and sharded buffer
(pita_torch.parallel) under gloo in 2 and 4 CPU processes, against the
one-process port and against pita_tpu.parallel on its 8-device CPU mesh
(tests/test_parallel.py).

The ranks are spawned processes that run tests/torch_parallel_workers.py
(torch and pita_torch only) through a file store in tmp_path: no port is
opened, so the suite's parallel workers do not collide. One spawn starts the
ranks of both world sizes while the JAX inputs and references are made; each
rank runs every case, and each test reads its case's results.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from pita_torch.io.flax_params import mlp_params_from_tree
from pita_torch.nets import MLPBackbone
from pita_torch.schedules import ElucidatingNoiseSchedule
from pita_tpu.nets import EnergyWrapper as JaxEnergy
from pita_tpu.nets import MLPBackbone as JaxMLP
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.parallel import make_dp_train_step as jax_dp_step
from pita_tpu.parallel import make_mesh
from pita_tpu.parallel import sharded_integrate as jax_sharded_integrate
from pita_tpu.sampler import IntegratorConfig as JaxConfig
from pita_tpu.sampler import integrate_sde as jax_integrate
from pita_tpu.schedules import ConstantAnnealingSchedule as JaxConst
from pita_tpu.schedules import ElucidatingNoiseSchedule as JaxSched
from pita_tpu.targets import GMM40 as JaxGMM
from pita_tpu.train.losses import LossConfig as JaxLossConfig
from tests import torch_parallel_workers as W
from tests.test_sampler import AnalyticEnergy as JaxAnalyticEnergy
from tests.test_sampler import AnalyticScore as JaxAnalyticScore
from tests.test_sampler import GaussianTarget as JaxGaussian
from tests.test_torch_sampler import JaxDraws
from torch_threads import one_intra_op_thread  # noqa: F401

SPAWN_TIMEOUT_S = 150
B_GAUSS, B_DP, DIM_BUF = 256, 64, 6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree_s, tree_e):
    """JAX score and energy MLP trees as the port's flattened parameters."""
    out = []
    for tree in (tree_s, tree_e):
        net = MLPBackbone(2, 2, **W.MLP)
        net.load_state_dict(mlp_params_from_tree(_np_tree(tree)))
        out += [p.detach().reshape(-1) for p in net.parameters()]
    return torch.cat(out).numpy()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The ranks of both world sizes, started before their inputs exist so
    that their start-up overlaps the JAX side; (directory, process context)."""
    out = tmp_path_factory.mktemp("ranks")
    for ws in W.WORLD_SIZES:
        (out / f"ranks{ws}").mkdir()
    ctx = mp.start_processes(W.run_process, args=(str(out), SPAWN_TIMEOUT_S),
                             nprocs=sum(W.WORLD_SIZES), join=False, start_method="spawn")
    yield out, ctx
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def inputs(spawned):
    """Every case's inputs from JAX (prior samples, draws, weights, data),
    written for the ranks, then its JAX references."""
    rng = jax.random.PRNGKey(0)
    k_prior, k_int = jax.random.split(rng)
    anneal = JaxConst(annealing_factor=W.ANNEAL)
    sched = JaxSched(**W.SCHED)
    scale = float(np.sqrt(sched.h(jnp.asarray(1.0)) / W.ANNEAL))
    x1 = jax.random.normal(k_prior, (B_GAUSS, 2)) * scale
    steps = W.GAUSS_CFG["num_integration_steps"]
    jd = JaxDraws(k_int, steps, True, 0)
    k_diff, k_res = (jnp.stack([k[j] for k in jd.steps]) for j in (0, 1))
    z = {"x1": np.asarray(x1),
         # JaxDraws.noise and .resample_u0 for every step in one call each
         "noise": np.asarray(jax.vmap(lambda k: jax.random.normal(k, (B_GAUSS, 2),
                                                                  jnp.float32))(k_diff)),
         "u0": np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(k_res)),
         "end_u0": jd.end_u0().numpy()}
    np.testing.assert_array_equal(z["noise"][7], jd.noise(7, (B_GAUSS, 2)).numpy())

    # the data-parallel step of tests/test_parallel.py:65-101
    gmm = JaxGMM()
    sw = JaxScore(JaxMLP(out_dim=2, **W.MLP))
    ew = JaxEnergy(JaxMLP(out_dim=2, **W.MLP))
    ps, pe = jax.jit(lambda k: (sw.init(k, 2), ew.init(jax.random.fold_in(k, 1), 2)))(rng)
    for which, tree in (("score", ps), ("energy", pe)):
        for k, v in mlp_params_from_tree(_np_tree(tree)).items():
            z[f"{which}.{k}"] = v.numpy()
    k_loss = jax.random.fold_in(rng, 3)

    @jax.jit
    def data_and_draws(k):
        x = gmm.sample(jax.random.fold_in(k, 2), B_DP)
        k_sigma, k_noise, _ = jax.random.split(k_loss, 3)
        return (x, *gmm.log_prob_and_force(x), jax.random.normal(k_noise, (B_DP, 2)),
                jax.random.normal(k_sigma, (B_DP,)))

    x0, e0, f0, noise, ln_sigma = data_and_draws(rng)
    for case in W.DP_LOSS:
        z[f"{case}.x0"], z[f"{case}.e0"], z[f"{case}.f0"] = map(np.asarray, (x0, e0, f0))
        z[f"{case}.noise"], z[f"{case}.ln_sigma_draw"] = np.asarray(noise), np.asarray(ln_sigma)
    # the mask case: the first 3/8 of the batch at small noise, inside the
    # target-score subset, the rest far outside it; the ranks' subsets differ
    ln = np.where(np.arange(B_DP) < 3 * B_DP // 8, -2.5, 1.5)
    z["mask.ln_sigma_draw"] = (ln + 0.1 * z["mask.ln_sigma_draw"]).astype(np.float32)

    rb = np.random.default_rng(7)
    z["buf_capacity"] = np.array(512)
    for r in range(3):
        z[f"buf{r}.x"] = rb.normal(size=(100, DIM_BUF)).astype(np.float32)
        z[f"buf{r}.e"] = rb.normal(size=100).astype(np.float32)
        z[f"buf{r}.f"] = rb.normal(size=(100, DIM_BUF)).astype(np.float32)
    out, _ = spawned
    np.savez(out / "inputs_partial.npz", **z)
    os.replace(out / "inputs_partial.npz", out / "inputs.npz")  # the ranks start on it

    # the JAX references, made while the ranks run; jitted whole: op by op,
    # each primitive compiles alone
    args = (JaxAnalyticScore(), JaxAnalyticEnergy(), {}, {}, sched, anneal, JaxGaussian(), 1.0,
            JaxConfig(**W.GAUSS_CFG))
    refs = {"jax_single": jax.jit(lambda k, x: jax_integrate(k, x, *args))(k_int, x1),
            "jax_sharded": jax_sharded_integrate(make_mesh(8), k_int, x1, *args)}
    opt = optax.adam(1e-3)
    step = jax_dp_step(make_mesh(8, axis_name="dp"), sw, ew, sched, JaxLossConfig(), opt)
    ps_dp, pe_dp, _, aux_dp = step(ps, pe, opt.init((ps, pe)), k_loss, x0, e0, f0,
                                   jnp.asarray(1.0))
    refs["jax_dp"] = (_flat(ps_dp, pe_dp), float(aux_dp["loss"]))
    return z, refs


@pytest.fixture(scope="module", params=W.WORLD_SIZES)
def ranks(request, inputs, spawned):
    """The ranks' results of one world size, once every rank has finished:
    (world size, a reader of ``<case>_<rank>.npz``)."""
    out, ctx = spawned
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            pytest.fail(f"the ranks did not finish in {SPAWN_TIMEOUT_S} s")
    ws = request.param
    return ws, lambda case, r: np.load(out / f"ranks{ws}" / f"{case}_{r}.npz")


def _gauss_port(z):
    return W.gaussian_run(None, torch.as_tensor(z["x1"]), W.GAUSS_CFG,
                          draws=W.ArrayDraws(z["noise"], z["u0"], z["end_u0"]))


def test_sharded_integrate_matches_one_process_and_jax(inputs, ranks):
    """The analytic Gaussian of tests/test_parallel.py:25-52 (256 chains x 40
    steps, resampling every 4th, final resample) with JAX's draws: every
    rank returns the one-process port's result (samples and log-weights
    within 1e-6, ancestor counts identical), which matches pita_tpu's
    integrate_sde, and the port's sharded run matches pita_tpu's sharded
    run at its test's rtol=1e-4, atol=1e-5."""
    z, refs = inputs
    ws, read = ranks
    one = _gauss_port(z)
    for r in range(ws):
        got = read("gauss", r)
        np.testing.assert_allclose(got["samples"], one.samples.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["logweights"], one.logweights.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["num_unique"], one.num_unique.numpy())
        for k, v in one.term_stats.items():
            np.testing.assert_allclose(got[f"stat.{k}"], v.numpy(), rtol=1e-5, atol=1e-7)
    assert int(one.num_unique.min()) < B_GAUSS  # resampling fired
    for name in ("jax_single", "jax_sharded"):
        ref = refs[name]
        np.testing.assert_allclose(one.samples.numpy(), np.asarray(ref.samples), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(one.num_unique.numpy(), np.asarray(ref.num_unique))
    np.testing.assert_allclose(read("gauss", 0)["samples"], np.asarray(refs["jax_sharded"].samples),
                               rtol=1e-4, atol=1e-5)


def test_sharded_integrate_every_reduction_matches_one_process(inputs, ranks):
    """Hutchinson probes with a carried divergence, the ESS trigger at every
    step, the final resample and 4 adaptive MALA steps, the draws from the
    generator (seeded alike on every rank): each rank equals the one-process
    run with the same seed (within 1e-6; acceptance rates, which set MALA's
    step, and ancestor counts identical)."""
    z, _ = inputs
    ws, read = ranks
    one = W.gaussian_run(None, torch.as_tensor(z["x1"]), W.FULL_CFG)
    for r in range(ws):
        got = read("full", r)
        np.testing.assert_allclose(got["samples"], one.samples.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["logweights"], one.logweights.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["num_unique"], one.num_unique.numpy())
        np.testing.assert_array_equal(got["acceptance"], one.acceptance_rates.numpy())
        for k, v in one.term_stats.items():
            np.testing.assert_allclose(got[f"stat.{k}"], v.numpy(), rtol=1e-5, atol=1e-7)
    n = one.num_unique.numpy()
    assert (n[:-1] < B_GAUSS).any() and (n[:-1] == B_GAUSS).any()  # ESS fired, and not always
    assert 0 < one.acceptance_rates.numpy().mean() < 1


def test_sharded_integrate_refuses_an_indivisible_batch(ranks):
    ws, read = ranks
    for r in range(ws):
        assert "does not divide" in str(read("indivisible", r)["refused"])


def test_dp_step_matches_jax_and_one_process(inputs, ranks):
    """GMM-40, MLPs 32 x 2, batch 64, Adam at 1e-3 (tests/test_parallel.py:65-101):
    the weights after the step within that test's rtol=2e-3, atol=2e-6 of
    pita_tpu's data-parallel step and the loss within 1e-3; against the
    one-process port step within 1e-6 of the largest weight change."""
    z, refs = inputs
    ws, read = ranks
    jax_params, jax_loss = refs["jax_dp"]
    one, one_loss = W.dp_step(None, _Npz(z), "gmm")
    before = np.concatenate([v.ravel() for v in _before(z)])
    change = np.abs(one - before).max()
    for r in range(ws):
        got = read("dp_gmm", r)
        np.testing.assert_allclose(got["params"], jax_params, rtol=2e-3, atol=2e-6)
        np.testing.assert_allclose(float(got["loss.loss"]), jax_loss, rtol=1e-3)
        assert np.abs(got["params"] - one).max() <= 1e-6 * change
        np.testing.assert_allclose(float(got["loss.loss"]), one_loss["loss"], rtol=1e-5)


class _Npz:
    """A dict of arrays seen as an np.load result (``.files`` and items)."""

    def __init__(self, d):
        self.d = d
        self.files = list(d)

    def __getitem__(self, k):
        return self.d[k]


def _before(z):
    out = []
    for which in ("score", "energy"):
        net = MLPBackbone(2, 2, **W.MLP)
        out += [z[f"{which}.{k}"] for k, _ in net.named_parameters()]
    return out


def test_dp_step_with_rank_dependent_subset_masks(inputs, ranks):
    """The target-score loss's subset mean (ln σ small) covers 3/8 of the
    batch, all on the first ranks: the mean of per-rank subset means would
    be off by about half. The data-parallel step equals the one-process
    step: weights within 1e-6 of the largest change, each loss within 1e-5."""
    z, _ = inputs
    ws, read = ranks
    sched = ElucidatingNoiseSchedule(**W.SCHED)
    ht = torch.exp(2 * sched.sample_ln_sigma(B_DP, torch.as_tensor(z["mask.ln_sigma_draw"])))
    thresh = sched.h(torch.tensor(W.DP_LOSS["mask"].time_threshold_target_score))
    in_subset = (ht < thresh).numpy().reshape(ws, -1).sum(1)
    assert in_subset.sum() == 3 * B_DP // 8 and in_subset.min() == 0
    one, one_loss = W.dp_step(None, _Npz(z), "mask")
    before = np.concatenate([v.ravel() for v in _before(z)])
    change = np.abs(one - before).max()
    assert one_loss["target_score_loss"] > 0
    for r in range(ws):
        got = read("dp_mask", r)
        assert np.abs(got["params"] - one).max() <= 1e-6 * change
        for k, v in one_loss.items():
            np.testing.assert_allclose(float(got[f"loss.{k}"]), v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_sharded_buffer_matches_one_process(inputs, ranks):
    """Capacity 512 split over the ranks (512/W rows each), three masked
    adds of 100 rows, then 64 rows sampled in each of the three modes from
    the same seed: the rows in rank order are the one-process buffer's, the
    cursor and fill count equal, the samples identical on every rank. A
    capacity of 513 is refused."""
    z, _ = inputs
    ws, read = ranks
    ref, samples = W.one_process_buffer(_Npz(z))
    parts = [read("buffer", r) for r in range(ws)]
    for p in parts:
        assert int(p["rows"]) == p["x"].shape[0] == 512 // ws
        assert int(p["pos"]) == ref.pos and int(p["size"]) == ref.size
        assert "does not divide" in str(p["refused"])
    for k, v in (("x", ref.x), ("energy", ref.energy), ("force", ref.force)):
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), v.numpy())
    for key, (xs, es, fs, idx) in samples.items():
        for p in parts:
            np.testing.assert_array_equal(p[f"{key}.idx"], idx.numpy())
            np.testing.assert_array_equal(p[f"{key}.x"], xs.numpy())
            np.testing.assert_array_equal(p[f"{key}.e"], es.numpy())
            np.testing.assert_array_equal(p[f"{key}.f"], fs.numpy())
