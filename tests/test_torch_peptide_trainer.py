"""The peptide presets and the aldp trainer of the port against pita_tpu's on
the CPU: the four presets key for key, three training steps of a narrow
aldp from one bridged state with JAX's draws, the train CLI end to end on
tiny cached data sets, and every preset built on the CPU when asked (and
refused without a GPU otherwise)."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.configs import EXPERIMENTS as JAX_EXPERIMENTS
from pita_tpu.configs import build_trainer as jax_build_trainer
from pita_tpu.configs import compose as jax_compose
from pita_tpu.io.checkpoint import _state_pytree
from pita_tpu.train import buffer as jbuf
from pita_torch import train_cli
from pita_torch.configs import EXPERIMENTS, build_trainer, compose
from pita_torch.io import checkpoint
from pita_torch.io.flax_params import trainer_state_from_tree
from pita_torch.nets import DiT3DBackbone
from pita_torch.targets import ALPEnergy
from pita_torch.train.losses import LossDraws
from pita_torch.train.trainer import StepDraws
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PRESETS = ("aldp", "al3", "al4", "alp_diffusion_baseline")
LR = 1e-3
NARROW = {"trainer.temperatures": (1200.0, 755.95), "trainer.num_epochs_per_temp": (2,),
          "trainer.buffer_capacity": 512, "net.hidden_size": 32, "net.cond_dim": 32,
          "net.n_heads": 4, "net.n_blocks": 2}


def t(a):
    return torch.as_tensor(np.array(a))


def _data_dir(path, temps=(1200.0, 755.95), peptide="aldp", n=200):
    """Cached sets: MD frames of aldp at 300 K (their temperature does not
    matter here, only that nothing is generated)."""
    path.mkdir(parents=True, exist_ok=True)
    x = np.load(REPO / "aldp_md_T300.npz")["positions"].reshape(-1, 66)[:n].astype(np.float32)
    for T in temps:
        for which in ("train", "val", "test"):
            np.save(path / f"{peptide}_temp_{T:.2f}_{which}.npy", x)
    return path


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_pita_tpu_minus_segment_size(name):
    want = JAX_EXPERIMENTS[name]()
    want["integrator"].pop("segment_size")
    assert EXPERIMENTS[name]() == want
    # and they compose: every field the port's configs share with pita_tpu's
    got, ref = compose(name, debug="short"), jax_compose(name, debug="short")
    assert (got.energy, got.net, got.name, got.tags) == (ref.energy, ref.net, ref.name, ref.tags)
    for part in ("trainer", "loss", "integrator"):
        g, r = dataclasses.asdict(getattr(got, part)), dataclasses.asdict(getattr(ref, part))
        shared = g.keys() & r.keys()
        assert {k: g[k] for k in shared} == {k: r[k] for k in shared}, part


@pytest.mark.parametrize("name", PRESETS)
def test_presets_build_on_the_cpu_and_need_a_gpu_otherwise(name, tmp_path, monkeypatch):
    cfg = compose(name, overrides={"out_dir": str(tmp_path)})
    tr = build_trainer(cfg, device="cpu")
    assert isinstance(tr.score_net, DiT3DBackbone) and isinstance(tr.targets[0], ALPEnergy)
    assert tr.score_net.compute_dtype == torch.bfloat16
    assert len(tr.score_net.blocks) == 6 and tr.score_net.final_norm.weight.shape == (128,)
    assert tr.targets[0].temperature == cfg.trainer.temperatures[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        build_trainer(cfg)


def test_torchmd_et_is_not_ported():
    """TorchMD-ET is ported: net kind torchmd_et builds behind the aldp
    preset (22 atoms); an unknown net kind is refused."""
    from pita_torch.nets import TorchMDETBackbone

    tr = build_trainer(compose("aldp", overrides={"net": {"kind": "torchmd_et"}}),
                       device="cpu")
    assert isinstance(tr.score_net, TorchMDETBackbone) and tr.score_net.n_particles == 22
    with pytest.raises(ValueError, match="unknown net kind"):
        build_trainer(compose("aldp", overrides={"net": {"kind": "nope"}}), device="cpu")


def _jax_epoch_draws(jtr):
    """The draws of pita_tpu's train_one_epoch, in its key schedule
    (trainer.py:414-432, 489-497; losses.py:79-86; buffer.py:116)."""
    cfg = jtr.cfg
    _, k_epoch, k_temps = jax.random.split(jtr.key, 3)
    temp_idxs = jax.random.randint(k_temps, (cfg.n_train_batches_per_epoch,), 0,
                                   jtr.active_temp_index() + 1)
    B, D = cfg.training_batch_size, jtr.dim
    out = []
    for key_t, ti in zip(jax.random.split(k_epoch, cfg.n_train_batches_per_epoch), temp_idxs):
        k_sample, k_aug, _, k_loss = jax.random.split(key_t, 4)
        idx = jbuf.buffer_sample(jbuf.buffer_view(jtr.buffers, int(ti)), k_sample, B,
                                 replacement=True)[3]
        k_sigma, k_noise, _ = jax.random.split(k_loss, 3)
        loss = LossDraws(t(jax.random.normal(k_sigma, (B,))),
                         t(jax.random.normal(k_noise, (B, D))))
        out.append((int(ti), StepDraws(t(idx), t(jax.random.normal(k_aug, (B, 3, 3))), None,
                                       loss)))
    return out


# Weights whose gradient is zero in exact arithmetic, so that what the two
# frameworks compute for it is rounding noise, which Adam normalizes to about
# ±lr a step: the final Dense's bias of either net shifts every particle's
# output alike, which the mean-free coordinates and losses cancel; the energy
# net's final modulation sees the zero-initialised final Dense at step 1.
ROUNDING_ONLY = ("score.final_out.bias", "energy.final_out.bias", "energy.final_ada.weight",
                 "energy.final_ada.bias")


def test_three_aldp_train_steps_match_jax_trainer(tmp_path):
    """A 2-block, 32-wide float32 DiT pair and the aldp losses: params, EMA
    and Adam state after three steps from one state with the same draws.
    Weights compare in units of lr (Adam's first steps move each by about
    lr·sign(g)), within 5e-3 lr (the float32 gradients of the two
    frameworks differ by rounding, which Adam's normalization amplifies where
    a weight's gradients nearly cancel from step to step: 2.7e-3 lr at
    worst here); the moments within 1e-3 of each tensor's largest entry; the
    epoch's mean losses within 1e-3 (the energy-score loss is a second
    derivative of a small energy: 1.1e-4 here). The
    ROUNDING_ONLY weights are held to Adam's bound of lr a step, and the
    final biases' gradients to rounding size."""
    data = _data_dir(tmp_path / "data", temps=(1200.0,))
    ov = dict(NARROW, **{"trainer.n_train_batches_per_epoch": 3, "energy.data_dir": str(data)})
    jtr = jax_build_trainer(jax_compose("aldp", debug="short", overrides=dict(
        ov, **{"net.compute_dtype": jnp.float32, "out_dir": str(tmp_path / "j")})))
    # the same function, compiled once instead of dispatched op by op
    jtr.targets[0].log_prob_and_force = jax.jit(jtr.targets[0].log_prob_and_force)
    jtr.populate_initial_buffer()
    ttr = build_trainer(compose("aldp", debug="short", overrides=dict(
        ov, **{"net.compute_dtype": "float32", "out_dir": str(tmp_path / "t")})), device="cpu")
    state = jax.tree.map(np.asarray, _state_pytree(jtr))
    ttr.load_state_dict(trainer_state_from_tree(state, n_layers=2))
    draws = _jax_epoch_draws(jtr)
    j_losses = jtr.train_one_epoch()
    t_losses = [ttr.train_step(ti, draws=d)[0] for ti, d in draws]
    for k, v in j_losses.items():
        np.testing.assert_allclose(np.mean([float(s[k]) for s in t_losses]), v, rtol=1e-3,
                                   atol=1e-9, err_msg=k)
    want = trainer_state_from_tree(jax.tree.map(np.asarray, _state_pytree(jtr)), n_layers=2)
    got = ttr.state_dict()
    tol = lambda name: 3 * 2 * LR if name in ROUNDING_ONLY else 5e-3 * LR
    for net in ("score", "energy"):
        for k, v in got[f"params_{net}"].items():
            np.testing.assert_allclose(v.numpy(), want[f"params_{net}"][k].numpy(), rtol=0,
                                       atol=tol(f"{net}.{k}"), err_msg=f"params_{net}.{k}")
        for k, v in got[f"ema_{net}"]["params"].items():
            np.testing.assert_allclose(v.numpy(), want[f"ema_{net}"]["params"][k].numpy(),
                                       rtol=0, atol=tol(f"{net}.{k}"), err_msg=f"ema_{net}.{k}")
        assert got[f"ema_{net}"]["num_updates"] == want[f"ema_{net}"]["num_updates"] == 3
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 3
    nu_max = max(float(v.max()) for v in got["opt_state"]["nu"].values())
    for m in ("mu", "nu"):
        for k, v in got["opt_state"][m].items():
            r = want["opt_state"][m][k].numpy()
            if k.endswith("final_out.bias"):  # zero gradient at every step
                assert float(got["opt_state"]["nu"][k].max()) <= 1e-8 * nu_max, k
            elif k not in ROUNDING_ONLY:
                assert np.abs(v.numpy() - r).max() <= 1e-3 * max(np.abs(r).max(), 1e-30), (m, k)


def test_train_cli_aldp_short_runs_to_its_end(tmp_path, capsys):
    """python -m pita_torch.train_cli experiment=aldp debug=short device=cpu,
    cut to two rungs of one epoch and a narrow DiT, on cached sets; the
    checkpoint restores into a fresh trainer tensor for tensor."""
    data = _data_dir(tmp_path / "data")
    ckpt = tmp_path / "ckpt.pt"
    over = ["trainer.temperatures=1200.0,755.95", "trainer.num_epochs_per_temp=1,",
            "trainer.max_epochs=1", "trainer.buffer_capacity=512", "net.hidden_size=32",
            "net.cond_dim=32", "net.n_heads=4", "net.n_blocks=2", f"energy.data_dir={data}"]
    train_cli.main(["experiment=aldp", "debug=short", "device=cpu", f"out_dir={tmp_path}",
                    f"ckpt_path={ckpt}"] + over)
    out = capsys.readouterr().out
    assert "final metrics" in out
    run = tmp_path / "aldp"
    assert (run / "buffer_samples_temperature_755.950.npz").exists()
    assert (run / "samples_temperature_1200.000_annealed_to_755.950.npz").exists()
    header = (run / "metrics.csv").read_text().splitlines()[0].split(",")
    for col in ("val/rama/resampled/torus_wasserstein", "val/correct_symmetry_rate",
                "val/uncorrectable_symmetry_rate", "val/ic/kld_mean", "val/tica/w2",
                "test/T=1200.00->755.95/rama/resampled/w2"):
        assert col in header, col
    from pita_torch.configs import parse_overrides

    fresh = build_trainer(compose("aldp", debug="short", overrides=dict(
        parse_overrides(over), out_dir=str(tmp_path / "r"))), device="cpu")
    checkpoint.restore_checkpoint(fresh, str(ckpt))
    saved = torch.load(ckpt, weights_only=True)
    assert fresh.epoch == saved["epoch"] == 1 and int(fresh.buffers.size[1]) > 0
    for k, v in saved["params_score"].items():
        assert torch.equal(fresh.score_net.state_dict()[k], v), k
