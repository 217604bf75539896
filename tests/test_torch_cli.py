"""The port's entry points and host-side tools against pita_tpu on the CPU:
``compose`` with the score_only overlay and a YAML overlay, ``-m`` and
``--sweep`` of the train CLI, a YAML-configured training run with the
geometric schedule, ``eval_cli`` on a checkpoint, the evaluation figures
and the logger backends."""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from pita_tpu import train_cli as jax_train_cli
from pita_tpu.configs import compose as jax_compose
from pita_tpu.io import logging as jax_logging
from pita_torch import eval_cli, train_cli
from pita_torch.configs import build_trainer, compose
from pita_torch.configs.registry import DEBUG_OVERLAYS
from pita_torch.io import checkpoint, plotting
from pita_torch.io import logging as tlogging
from pita_torch.schedules import SigmoidAnnealingSchedule
from pita_torch.targets import LJ13
from tests.test_torch_trainer import NARROW, _lj13_data_dir
from torch_threads import one_intra_op_thread  # noqa: F401

YAML_OVERLAY = {
    "noise_schedule": {"kind": "geometric", "sigma_min": 0.01, "sigma_max": 10.0},
    "trainer.lr": 3e-4,
    "trainer.num_epochs_per_temp": [2],
    "trainer.temperatures": [4.0, 3.0],
    **DEBUG_OVERLAYS["score_only"],
}


def _fields(cfg):
    """An ExperimentConfig as plain values; the integrator's keys that both
    packages have."""
    out = {k: getattr(cfg, k) for k in ("name", "energy", "net", "noise_schedule",
                                         "annealing_schedule", "logger", "out_dir", "tags")}
    out["trainer"] = dataclasses.asdict(cfg.trainer)
    out["loss"] = dataclasses.asdict(cfg.loss)
    out["integrator"] = dataclasses.asdict(cfg.integrator)
    return out


@pytest.mark.parametrize("case", ["score_only", "yaml", "yaml_and_overrides"])
def test_compose_matches_jax(case, tmp_path):
    """The same ExperimentConfig fields as pita_tpu.configs.compose (the
    integrator's keys both packages have)."""
    path = tmp_path / "overlay.yaml"
    path.write_text(yaml.safe_dump(YAML_OVERLAY))
    kw = {"score_only": dict(debug="score_only"),
          "yaml": dict(yaml_path=str(path)),
          "yaml_and_overrides": dict(debug="short", yaml_path=str(path),
                                     overrides={"trainer.lr": 1e-3, "seed": 5})}[case]
    got, want = _fields(compose("lj55", **kw)), _fields(jax_compose("lj55", **kw))
    common = got["integrator"].keys() & want["integrator"].keys()
    assert len(common) > 20
    got["integrator"] = {k: got["integrator"][k] for k in common}
    want["integrator"] = {k: want["integrator"][k] for k in common}
    assert got == want
    if case != "score_only":
        assert got["noise_schedule"]["kind"] == "geometric" and got["loss"]["only_train_score"]


def _cli_args(tmp_path, data):
    return ["experiment=lj13", "debug=short", "device=cpu", f"out_dir={tmp_path}",
            f"energy.data_dir={data}", "trainer.max_epochs=1", "net.hidden_nf=8",
            "net.n_layers=1", "trainer.buffer_capacity=512", "test=false"]


def test_multirun_cartesian(tmp_path):
    """-m with seed=1,2 runs both trainings, each in its suffixed run
    directory (tests/test_sweeps.py:47-60)."""
    data = tmp_path / "data"
    _lj13_data_dir(data, temps=(4.0,))
    results = train_cli.main(["-m", "seed=1,2"] + _cli_args(tmp_path, data))
    assert list(results) == ["seed-1", "seed-2"]
    runs = sorted(d for d in os.listdir(tmp_path) if d.startswith("lj13"))
    assert runs == ["lj13_seed-1", "lj13_seed-2"]
    for r in runs:
        with open(tmp_path / r / "metrics.csv") as f:
            assert "val/energy_w2" in f.readline()


def test_sweep_draws_match_jax(monkeypatch):
    """The same trials for a fixed sweep_seed: both main functions patched,
    so no run trains."""
    argv = ["experiment=lj13", "trainer.lr=1e-4:1e-2", "loss.w_score=0.5:2.0",
            "net.hidden_nf=16,32,64", "sweep_trials=6", "sweep_seed=3", "debug=short"]
    calls = {"jax": [], "torch": []}
    metric = iter([3.0, 1.0, 2.0, 5.0, 0.5, 4.0] * 2)
    monkeypatch.setattr(jax_train_cli, "main",
                        lambda a: calls["jax"].append(a) or next(metric))
    monkeypatch.setattr(train_cli, "main", lambda a: calls["torch"].append(a) or next(metric))
    jbest = jax_train_cli.sweep(list(argv))
    best = train_cli.sweep(list(argv))
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) == 6
    assert best == jbest and best[0] == 4


def test_train_cli_yaml_geometric_score_only(tmp_path):
    """config=<yaml>: the geometric schedule trains (its uniform ln σ draws)
    with the score_only overlay's keys, one rung transition at LJ13."""
    data = tmp_path / "data"
    _lj13_data_dir(data)
    path = tmp_path / "overlay.yaml"
    path.write_text(yaml.safe_dump(dict(YAML_OVERLAY, **{"trainer.num_epochs_per_temp": [1],
                                                         "trainer.max_epochs": 2})))
    args = [a for a in _cli_args(tmp_path, data) if not a.startswith("trainer.max_epochs")]
    train_cli.main(args + [f"config={path}"])
    with open(tmp_path / "lj13" / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert float(rows[0]["train/energy_score_loss"]) == 0.0  # score only
    assert np.isfinite(float(rows[0]["train/score_loss"]))
    assert any(r.get("val/buffer_filled_temp") == "3.0" for r in rows)


def _small_trainer(tmp_path, data, **ov):
    cfg = compose("lj13", debug="short", overrides=dict(
        NARROW, out_dir=str(tmp_path), **{"energy.data_dir": str(data),
                                          "trainer.num_init_samples": 64}, **ov))
    return cfg, build_trainer(cfg, device="cpu")


def test_eval_cli_matches_trainer_test(tmp_path, capsys):
    """eval_cli on a CPU checkpoint gives the metrics of trainer.test(ckpt_path=),
    bitwise: both restore the same weights and generator state."""
    data = tmp_path / "data"
    _lj13_data_dir(data)
    _, tr = _small_trainer(tmp_path / "train", data)
    tr.populate_initial_buffer()
    tr.train_step(0)
    ckpt = str(tmp_path / "ckpt.pt")
    checkpoint.save_checkpoint(tr, ckpt)
    overrides = [f"{k}={v}" for k, v in NARROW.items() if k != "trainer.temperatures"
                 and k != "trainer.num_epochs_per_temp"]
    got = eval_cli.main(["experiment=lj13", "debug=short", "device=cpu", f"ckpt_path={ckpt}",
                         f"out_dir={tmp_path / 'eval'}", f"energy.data_dir={data}",
                         "trainer.temperatures=4.0,3.0", "trainer.num_epochs_per_temp=2,",
                         *overrides])
    _, fresh = _small_trainer(tmp_path / "ref", data)
    want = fresh.test(ckpt_path=ckpt)
    assert got == want and "test/T=4.00->3.00/energy_w2" in got
    assert "test/T=4.00->3.00/energy_w2:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="ckpt_path"):
        eval_cli.main(["experiment=lj13", "device=cpu"])


def test_every_plotting_function_writes_its_png(tmp_path):
    rng = np.random.default_rng(0)
    lj = LJ13()
    x = torch.as_tensor(rng.normal(size=(20, 39)).astype(np.float32))

    class Gauss2D:
        def log_prob(self, z):
            return -0.5 * (z**2).sum(-1) / 100.0

    d = str(tmp_path)
    paths = [
        plotting.plot_energy_histograms(torch.randn(50), rng.normal(size=50), d,
                                        not_resampled_energies=torch.randn(30)),
        plotting.plot_interatomic_distances(lj, x, x.numpy() * 1.1, d),
        plotting.plot_gmm_contours(Gauss2D(), torch.randn(40, 2) * 10, d, grid_n=20),
        plotting.plot_ramachandran(rng.uniform(-3, 3, 200), rng.uniform(-3, 3, 200), d,
                                   temperature=300.0),
        plotting.plot_tica_density(rng.normal(size=(100, 2)), d,
                                   proj_generated=rng.normal(size=(100, 2))),
        plotting.plot_logweights(torch.randn(5, 30), d),
        plotting.plot_num_unique(torch.arange(5), d),
        plotting.plot_acceptance(torch.rand(4), d),
        plotting.plot_sde_term_stats({"divergence": torch.rand(5), "scalar": torch.tensor(1.0)},
                                     d),
        plotting.plot_annealing_schedule(SigmoidAnnealingSchedule(annealing_factor=2.0), 20, d),
    ]
    names = ["energy_hist", "dist_hist", "gmm_samples", "ramachandran", "tica", "logweights",
             "num_unique_idxs", "acceptance_rate", "sde_terms", "annealing_factor"]
    assert paths == [os.path.join(d, f"{n}.png") for n in names]
    assert all(os.path.getsize(p) > 1000 for p in paths)
    assert plotting.plot_acceptance(torch.zeros(0), d) is None
    assert plotting.plot_sde_term_stats({"s": torch.tensor(1.0)}, d) is None


def test_make_plots_writes_the_epoch_figures(tmp_path):
    data = tmp_path / "data"
    _lj13_data_dir(data)
    _, tr = _small_trainer(tmp_path, data, **{"trainer.make_plots": True,
                                              "trainer.max_epochs": 1})
    tr.fit()
    pdir = tmp_path / "lj13" / "plots" / "epoch_0"
    assert sorted(os.listdir(pdir)) == ["dist_hist.png", "energy_hist.png", "logweights.png",
                                        "num_unique_idxs.png", "sde_terms.png"]


def test_logger_backends(tmp_path, capsys, monkeypatch):
    """TensorBoard writes event files; a backend whose package is missing
    is skipped with pita_tpu's line."""
    lg = tlogging.make_logger(str(tmp_path), ("csv", "tensorboard"))
    lg.log_metrics({"val/a": 1.5, "val/b": 2.0}, step=3)
    lg.log_image("img", [np.zeros((4, 4, 3), np.uint8)], step=3)
    lg.loggers[1].writer.close()
    events = os.listdir(tmp_path / "tb")
    assert events and all(e.startswith("events.out.tfevents") for e in events)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert [e.value for e in acc.Scalars("val/a")] == [1.5]

    import builtins

    real_import = builtins.__import__
    missing = {"wandb", "mlflow", "neptune", "comet_ml", "aim"}

    def no_pkgs(name, *a, **k):
        if name.split(".")[0] in missing:
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pkgs)
    kinds = ("wandb", "mlflow", "neptune", "comet", "aim")
    for mod in (tlogging, jax_logging):
        for kind in kinds:  # each with the arguments its constructor takes
            kw = {} if kind in ("mlflow", "aim") else {"project": "p"}
            assert mod.make_logger(str(tmp_path / "x"), (kind,), **kw).loggers == []
    out = capsys.readouterr().out.splitlines()
    want = [f"{k} not available; skipping" for k in kinds]
    assert out == want + want  # the port's lines, then pita_tpu's
    with pytest.raises(ValueError, match="unknown logger kind"):
        tlogging.make_logger(str(tmp_path), ("nope",))


def test_eval_and_train_cli_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        eval_cli.main(["experiment=lj13", "debug=short", f"out_dir={tmp_path}",
                       f"ckpt_path={tmp_path / 'none.pt'}"])
    with pytest.raises(RuntimeError, match="no GPU"):
        train_cli.main(["-m", "experiment=lj13", "debug=short", "seed=1,2",
                        f"out_dir={tmp_path}"])
