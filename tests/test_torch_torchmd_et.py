"""The port's TorchMD-ET backbone, the peptide atom types and the EGNN with
atom types against pita_tpu (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.nets import TorchMDETBackbone as JaxET
from pita_tpu.nets.atom_features import peptide_atom_types as jax_atom_types
from pita_tpu.nets.egnn_fast import score_divergence_fast as jax_div_fast
from pita_tpu.targets.alp import build_peptide_topology as jax_topology
from pita_torch.configs import build_trainer, compose
from pita_torch.io.flax_params import load_egnn_params, torchmd_et_params_from_tree
from pita_torch.nets import EGNNBackbone, ScoreWrapper, TorchMDETBackbone
from pita_torch.nets.atom_features import peptide_atom_types
from pita_torch.nets.egnn_fast import score_divergence_fast
from pita_torch.targets.alp import build_peptide_topology
from torch_threads import one_intra_op_thread  # noqa: F401


N = 8
KW = dict(hidden=16, n_layers=2, num_heads=2, num_rbf=8)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _pair(atom_types=None, seed=0):
    """pita_tpu's TorchMD-ET with its init weights perturbed (LayerNorms
    too), and the port's with the same weights."""
    mod = JaxET(n_particles=N, atom_types=atom_types, **KW)
    p = jax.jit(mod.init)(jax.random.PRNGKey(seed), jnp.zeros(2), jnp.zeros((2, 3 * N)),
                          jnp.ones(2))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.normal(size=a.shape),
                                           jnp.float32), p)
    net = TorchMDETBackbone(N, atom_types=atom_types, **KW)
    net.load_state_dict(torchmd_et_params_from_tree(jax.tree.map(np.asarray, p)))
    return mod, p, net


def _inputs(B=12, seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, 3 * N)) * 1.2).astype(np.float32)
    t = rng.uniform(-2, 1, size=B).astype(np.float32)
    beta = rng.uniform(0.3, 1.0, size=B).astype(np.float32)
    return x, t, beta


@pytest.mark.parametrize("atom_types", [None, (0, 1, 1, 2, 3, 3, 3, 4)])
def test_forward_matches_jax_from_carried_weights(atom_types):
    mod, p, net = _pair(atom_types)
    x, t, beta = _inputs()
    ref = jax.jit(mod.apply)(p, jnp.asarray(t), jnp.asarray(x), jnp.asarray(beta))
    got = net(torch.as_tensor(t), torch.as_tensor(x), torch.as_tensor(beta))
    _close(got, ref, 1e-5)
    assert np.abs(np.asarray(ref)).max() > 1e-3


def test_equivariance_under_a_rotation_and_the_backbone_protocol(tmp_path):
    _, _, net = _pair(seed=2)
    x, t, _ = _inputs(4, 3)
    q, _ = np.linalg.qr(np.random.default_rng(4).normal(size=(3, 3)))
    R = torch.as_tensor(q * np.sign(np.linalg.det(q)), dtype=torch.float32)
    xt = torch.as_tensor(x)
    out = net(torch.as_tensor(t), xt, 1.0).reshape(4, N, 3)
    out_rot = net(torch.as_tensor(t), (xt.reshape(4, N, 3) @ R.T).reshape(4, -1), 1.0)
    _close(out_rot.reshape(4, N, 3), (out @ R.T).detach().numpy(), 1e-4)
    assert net.route == net.sampler_route == "autograd"
    fresh = TorchMDETBackbone(N, **KW).reset_parameters(torch.Generator().manual_seed(0))
    assert float(fresh.layers[0].norm_h.weight.detach().min()) == 1.0
    copy = fresh.with_route("autograd")
    assert copy is not fresh and torch.equal(copy.embed.weight, fresh.embed.weight)
    # the registry builds it behind a preset, on the trainer's route
    tr = build_trainer(compose("lj13", debug="short", overrides={
        "net.kind": "torchmd_et", "net.hidden": 8, "net.n_layers": 1,
        "trainer.buffer_capacity": 64, "out_dir": str(tmp_path)}), device="cpu")
    assert isinstance(tr.score_net, TorchMDETBackbone) and tr.score_net.n_particles == 13
    assert isinstance(tr.ema_score.module, TorchMDETBackbone)


@pytest.mark.parametrize("n_ala", [1, 2, 3])
def test_peptide_atom_types_match_jax(n_ala):
    got = peptide_atom_types(build_peptide_topology(n_ala))
    assert got == jax_atom_types(jax_topology(n_ala))
    assert len(got) == (22, 32, 42)[n_ala - 1]


def test_egnn_with_atom_types_forward_and_fast_trace_match_jax():
    types = peptide_atom_types(build_peptide_topology(1))
    mod = JaxEGNN(n_particles=22, hidden_nf=8, n_layers=2, atom_types=types)
    p = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.zeros(2), jnp.zeros((2, 66)), jnp.ones(2))
    net = EGNNBackbone(22, hidden_nf=8, n_layers=2, atom_types=types)
    net.load_state_dict(load_egnn_params(serialization.to_bytes(p), 2))
    assert net.w_emb.shape[0] == 2 + max(types) + 1
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 66)) * 0.3).astype(np.float32)
    t = rng.uniform(-1, 1, size=4).astype(np.float32)
    _close(net(torch.as_tensor(t), torch.as_tensor(x), 1.0),
           jax.jit(mod.apply)(p, jnp.asarray(t), jnp.asarray(x), 1.0), 1e-5)
    ht = np.exp(rng.uniform(-2, 1, size=4)).astype(np.float32)
    got = score_divergence_fast(ScoreWrapper(net), torch.as_tensor(ht), torch.as_tensor(x), 1.0)
    ref = jax.jit(lambda h, xx: jax_div_fast(JaxScore(mod), p, h, xx, 1.0))(jnp.asarray(ht),
                                                                            jnp.asarray(x))
    _close(got, ref, 1e-4)
