"""The port's trainer against pita_tpu's on the CPU: three training steps
from one bridged state with JAX's draws, the initial buffer, the fill-quality
floor's escalation, the train CLI end to end at LJ13, atomic checkpoints,
the kernel buffers repacked after a step, and the CUDA default."""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from pita_tpu.configs import build_trainer as jax_build_trainer
from pita_tpu.configs import compose as jax_compose
from pita_tpu.io.checkpoint import _state_pytree
from pita_tpu.sampler import IntegratorConfig as JaxIntegratorConfig
from pita_tpu.train import buffer as jbuf
from pita_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from pita_tpu.train.trainer import fill_with_quality_floor as jax_fill
from pita_torch import train_cli
from pita_torch.baselines.mcmc import jittered_lattice
from pita_torch.configs import build_trainer, compose
from pita_torch.io import checkpoint
from pita_torch.io.flax_params import trainer_state_from_tree
from pita_torch.ops.egnn_layer import pack_weights
from pita_torch.sampler import IntegratorConfig
from pita_torch.train.losses import LossDraws
from pita_torch.train.trainer import StepDraws, TrainerConfig, fill_with_quality_floor
from torch_threads import one_intra_op_thread  # noqa: F401

LR = 1e-3
NARROW = {"trainer.temperatures": (4.0, 3.0), "trainer.num_epochs_per_temp": (2,),
          "trainer.buffer_capacity": 512, "net.hidden_nf": 8, "net.n_layers": 1}


def t(a):
    return torch.as_tensor(np.array(a))


def _trainers(tmp_path, n_steps=3):
    """A pita_tpu trainer with its rung-0 buffer from a train set of jittered
    lattices, and the port's trainer loaded with the same state through the
    bridge."""
    _lj13_data_dir(tmp_path / "data", temps=(4.0,))
    ov = dict(NARROW, **{"trainer.n_train_batches_per_epoch": n_steps,
                         "energy.data_dir": str(tmp_path / "data")})
    jcfg = jax_compose("lj13", debug="short", overrides=dict(ov, out_dir=str(tmp_path / "j")))
    jtr = jax_build_trainer(jcfg)
    jtr.populate_initial_buffer()
    tcfg = compose("lj13", debug="short", overrides=dict(ov, out_dir=str(tmp_path / "t")))
    ttr = build_trainer(tcfg, device="cpu")
    state = jax.tree.map(np.asarray, _state_pytree(jtr))
    ttr.load_state_dict(trainer_state_from_tree(state, n_layers=1))
    return jtr, ttr


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


def test_three_train_steps_match_jax_trainer(tmp_path):
    """Params, EMA and Adam state after three steps from one state with the
    same draws. Adam's first steps move each weight by about lr·sign(g), so
    weights compare in units of lr, within 1e-3 lr (a weight whose gradient
    is within rounding of zero could differ by up to 2 lr a step; none does
    here), the moments within 1e-3 of each tensor's largest entry."""
    jtr, ttr = _trainers(tmp_path)
    draws = _jax_epoch_draws(jtr)
    jtr.train_one_epoch()
    for ti, d in draws:
        ttr.train_step(ti, draws=d)
    ref = jax.tree.map(np.asarray, _state_pytree(jtr))
    got = ttr.state_dict()
    want = trainer_state_from_tree(ref, n_layers=1)
    for which in ("params_score", "params_energy"):
        for k, v in got[which].items():
            np.testing.assert_allclose(v.numpy(), want[which][k].numpy(), rtol=0,
                                       atol=1e-3 * LR, err_msg=f"{which}.{k}")
    for which in ("ema_score", "ema_energy"):
        assert got[which]["num_updates"] == want[which]["num_updates"] == 3
        for k, v in got[which]["params"].items():
            np.testing.assert_allclose(v.numpy(), want[which]["params"][k].numpy(), rtol=0,
                                       atol=1e-3 * LR, err_msg=f"{which}.{k}")
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 3
    for m in ("mu", "nu"):
        for k, v in got["opt_state"][m].items():
            r = want["opt_state"][m][k].numpy()
            assert np.abs(v.numpy() - r).max() <= 1e-3 * max(np.abs(r).max(), 1e-30), (m, k)


def test_populate_initial_buffer_from_prior_and_from_data_dir(tmp_path):
    ov = dict(NARROW, out_dir=str(tmp_path), **{"trainer.num_init_samples": 40})
    tr = build_trainer(compose("lj13", debug="short",
                               overrides=dict(ov, **{"trainer.init_from_prior": True})),
                       device="cpu")
    tr.populate_initial_buffer()
    assert tr.buffers.size.tolist() == [40, 0]
    x = tr.buffers.x[0, :40]
    # mean-free prior at sqrt(h(t_start))
    assert float(x.reshape(40, 13, 3).mean(1).abs().max()) < 1e-5
    data = jittered_lattice(13, 25, torch.Generator().manual_seed(1)).numpy()
    np.save(tmp_path / "LJ13_temp_4.0_train.npy", data)
    tr = build_trainer(compose("lj13", debug="short",
                               overrides=dict(ov, **{"energy.data_dir": str(tmp_path)})),
                       device="cpu")
    tr.populate_initial_buffer()
    rows = tr.buffers.x[0, :40].numpy()
    assert all(any(np.array_equal(r, d) for d in data) for r in rows)
    lp, _ = tr.targets[0].log_prob_and_force(tr.buffers.x[0, :40])
    np.testing.assert_allclose(tr.buffers.energy[0, :40].numpy(), lp.numpy(), rtol=1e-6)


class _Res:
    def __init__(self, lw, n):
        self.logweights = lw
        self.samples = np.zeros((n, 3), np.float32)


def _stub(ess_by_attempt, to):
    """sample_fn whose no-resampling pass has a given normalized ESS: one
    chain of weight w, the rest of weight 1 (ESS = (w+n-1)^2/(n (w^2+n-1)))."""
    calls = []

    def fn(n, f_cfg):
        n_diag = min(n, 64)
        target = ess_by_attempt[len(calls)]
        w = 1.0
        while ((w + n_diag - 1) ** 2 / (n_diag * (w * w + n_diag - 1))) > target:
            w *= 1.05
        lw = np.zeros((3, n_diag), np.float32)
        lw[:, 0] = np.log(w)
        calls.append((n, None if f_cfg is None else (f_cfg.post_mcmc_steps,
                                                     f_cfg.ess_resampling_threshold)))
        return _Res(to(lw), n), _Res(to(lw), n_diag), None, None

    return fn, calls


@pytest.mark.parametrize("ess", [(0.001, 0.002, 0.5), (0.001, 0.5, 0.5), (0.5, 0.5, 0.5)])
def test_fill_with_quality_floor_escalates_like_jax(ess):
    kw = dict(transition_min_fill_ess=0.02, transition_fill_max_retries=2,
              transition_fill_extra_mcmc=30, transition_fill_effective_floor=100.0)
    icfg = dict(num_integration_steps=3, end_resampling_step=3)
    jfn, jcalls = _stub(ess, lambda a: a)
    tfn, tcalls = _stub(ess, t)
    _, jinfo, jfill = jax_fill(jfn, JaxIntegratorConfig(**icfg), JaxTrainerConfig(**kw), 40,
                               fill_floor=0.02, retry=lambda f: f())
    _, tinfo, tfill = fill_with_quality_floor(tfn, IntegratorConfig(**icfg), TrainerConfig(**kw),
                                              40, fill_floor=0.02)
    assert tcalls == jcalls
    assert tinfo.keys() == jinfo.keys()
    for k in jinfo:
        np.testing.assert_allclose(tinfo[k], jinfo[k], rtol=1e-5, err_msg=k)
    assert (tfill is None) == (jfill is None)
    _, none_info, _ = fill_with_quality_floor(tfn, IntegratorConfig(**icfg), TrainerConfig(**kw),
                                              40)
    assert none_info == {}


def _lj13_data_dir(path, temps=(4.0, 3.0), n=300):
    os.makedirs(path, exist_ok=True)
    g = torch.Generator().manual_seed(0)
    for T in temps:
        for which in ("train", "val", "test"):
            np.save(os.path.join(path, f"LJ13_temp_{T:.1f}_{which}.npy"),
                    jittered_lattice(13, n, g).numpy())


# the columns pita_tpu's trainer logs on this run (trainer.py:1147-1151 train,
# :864-880 eval_step_losses, :965-1062 evaluate, :1252-1272 test)
JAX_COLUMNS = (
    ["step", "launch", "train/epoch_s"]
    + [f"train/{k}" for k in ("loss", "score_loss", "energy_score_loss", "target_score_loss",
                              "dem_energy_loss", "energy_matching_loss",
                              "dU_dt_regularization_loss")]
    + ["val/loss", "val/temp=4.000/score_loss", "val/temp=3.000/energy_matching_loss"]
    + [f"val/{k}" for k in ("buffer_filled_temp", "energy_w2", "energy_w1", "energy_mean_gap",
                            "data_energy_std", "dist_w2", "energy_mean",
                            "energy_mean_no_resampling", "lower_temp", "ess", "logweight_std",
                            "n_resampling_islands")]
    + [f"test/T=4.00->3.00/{k}" for k in ("energy_w2", "energy_w1", "energy_mean_gap",
                                          "data_energy_std", "dist_w2", "energy_mean")]
)


def test_train_cli_lj13_short_runs_to_its_end(tmp_path, capsys):
    """python -m pita_torch.train_cli experiment=lj13 debug=short device=cpu,
    cut to two rungs of one epoch each and a 16-wide, 2-layer net."""
    data = tmp_path / "data"
    _lj13_data_dir(data)
    ckpt = tmp_path / "ckpt.pt"
    args = ["experiment=lj13", "debug=short", "device=cpu", f"out_dir={tmp_path}",
            f"energy.data_dir={data}", "trainer.temperatures=4.0,3.0",
            "trainer.num_epochs_per_temp=1,", "trainer.max_epochs=2",
            "trainer.buffer_capacity=1024", "net.hidden_nf=16", "net.n_layers=2",
            f"ckpt_path={ckpt}"]
    train_cli.main(args)
    assert "final metrics" in capsys.readouterr().out
    with open(tmp_path / "lj13" / "metrics.csv", newline="") as f:
        header = next(csv.reader(f))
    missing = [c for c in JAX_COLUMNS if c not in header]
    assert not missing, missing
    assert any("ln_sigma=[" in c for c in header)
    assert (tmp_path / "lj13" / "buffer_samples_temperature_3.000.npz").exists()
    assert (tmp_path / "lj13" / "samples_temperature_4.000_annealed_to_3.000.npz").exists()
    # the checkpoint restores into a fresh trainer, tensor for tensor
    ov = {a.split("=", 1)[0]: a.split("=", 1)[1] for a in args[4:-1]}
    from pita_torch.configs import parse_overrides

    fresh = build_trainer(compose("lj13", debug="short", overrides=dict(
        parse_overrides([f"{k}={v}" for k, v in ov.items()]), out_dir=str(tmp_path / "r"))),
        device="cpu")
    checkpoint.restore_checkpoint(fresh, str(ckpt))
    saved = torch.load(ckpt, weights_only=True)
    assert fresh.epoch == saved["epoch"] == 2
    assert int(fresh.buffers.size[1]) > 0
    _assert_same_state(fresh.state_dict(), saved)


def _assert_same_state(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_state(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_interrupted_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    ov = dict(NARROW, out_dir=str(tmp_path), **{"trainer.init_from_prior": True,
                                                "trainer.num_init_samples": 64})
    tr = build_trainer(compose("lj13", debug="short", overrides=ov), device="cpu")
    tr.populate_initial_buffer()
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save_checkpoint(tr, path)
    first = torch.load(path, weights_only=True)
    tr.train_one_epoch()

    def torn(state, p):
        with open(p, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_write", torn)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(tr, path)
    assert os.listdir(tmp_path).count("ckpt.pt") == 1
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    fresh = build_trainer(compose("lj13", debug="short", overrides=ov), device="cpu")
    checkpoint.restore_checkpoint(fresh, path)
    _assert_same_state(fresh.state_dict(), first)
    assert fresh.ema_score.num_updates == 0 and tr.ema_score.num_updates == 4


def test_kernel_buffers_repack_after_a_step_and_an_ema_update(tmp_path):
    """The sampler's layers cache their packed kernel weights; an in-place
    optimizer step or EMA update must make them repack (EGCL.packed's stamp)."""
    ov = dict(NARROW, out_dir=str(tmp_path), **{"trainer.init_from_prior": True,
                                                "trainer.num_init_samples": 64,
                                                "trainer.ema_decay": 0.5})
    tr = build_trainer(compose("lj13", debug="short", overrides=ov), device="cpu")
    tr.populate_initial_buffer()
    ema_layer = tr.ema_score.module.layers[0]
    frozen = tr.score_net.with_route("kernels")
    before = ema_layer.packed(torch.device("cpu")).clone()
    frozen_before = frozen.layers[0].packed(torch.device("cpu")).clone()
    tr.train_step(0)
    after = ema_layer.packed(torch.device("cpu"))
    assert not torch.equal(before, after)
    assert torch.equal(after, pack_weights(ema_layer.weights()))
    # an in-place optimizer-style update of a kernel-route net
    with torch.no_grad():
        for p, q in zip(frozen.parameters(), tr.score_net.parameters()):
            p.copy_(q)
    repacked = frozen.layers[0].packed(torch.device("cpu"))
    assert not torch.equal(frozen_before, repacked)
    assert torch.equal(repacked, pack_weights(frozen.layers[0].weights()))
    # the sampler refuses trainable weights; the trainer samples through the EMA
    with pytest.raises(RuntimeError, match="inference-only"):
        tr.score_net.with_route("kernels").requires_grad_(True)(
            torch.zeros(2), torch.zeros(2, 39), 1.0)


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = compose("lj13", debug="short", overrides=dict(NARROW, out_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no GPU"):
        build_trainer(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        train_cli.main(["experiment=lj13", "debug=short", f"out_dir={tmp_path}"])
    # the evaluation figures are ported: make_plots builds on the CPU when asked
    tr = build_trainer(compose("lj13", overrides={"trainer.make_plots": True,
                                                  "out_dir": str(tmp_path)}), device="cpu")
    assert tr.cfg.make_plots and tr.device.type == "cpu"
