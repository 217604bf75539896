"""Each job driver driven through a whole run at a small size on the CPU,
past the harness's look for a card (the port's plain versions stand in for
its kernels): a sound run is correct; each planted fault and each cell's
control makes ``correct`` false under the committed limits.

    python -m pytest perfbench/tests/test_perfbench_runs.py

Minutes on a CPU: the exact trace's plain versions are slow there.
"""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import controls, harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 3_000_000_000_017  # above 2**31, as the driver's are
SIZES = {
    "lj55-bf16.hutch-2048": {"chains": 8, "steps": 12, "extra_full_steps": 2,
                             "rows_per_step": 4},
    "lj55-f32.train-256": {"batch": 8, "buffer_rows": 64, "steps_per_job": 2},
}


def run(workload, seed=SEED):
    cell = harness.load_cell(workload)
    t0 = time.time()
    return harness.run(cell, seed, 0.01, False, "cpu", lambda: time.time() - t0,
                       sizes=SIZES[workload])


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["metrics"]["setup_s"]["value"] > 0


def _freeze_state(monkeypatch):
    """The sampler's step returns the state it was given: every projection
    after the first hands back the first step's result."""
    from pita_torch.sampler import integrator

    real, held = integrator.remove_mean, {}

    def frozen(x, *a):
        key = x.shape[0]
        if key not in held:
            held[key] = real(x, *a)
        return held[key]

    monkeypatch.setattr(integrator, "remove_mean", frozen)


def _half_batch(monkeypatch):
    """Resampling's softmax and CDF over half of the chains, the choice
    repeated over the rest."""
    from pita_torch.sampler import integrator

    real = integrator.systematic_resample

    def half(a, u0):
        idx = real(a[:a.shape[0] // 2], u0)
        return torch.cat([idx, idx, idx[:a.shape[0] % 2]])

    monkeypatch.setattr(integrator, "systematic_resample", half)


def _altered(monkeypatch):
    """One chain's drift altered where each step computes it."""
    from pita_torch.sampler import integrator

    real = integrator.compute_sde_terms

    def altered(*a, **k):
        t = real(*a, **k)
        dx = t.drift_X.clone()
        dx[0, 0] += 1.0  # one coordinate: a shift of the whole chain is projected out
        return t._replace(drift_X=dx)

    monkeypatch.setattr(integrator, "compute_sde_terms", altered)


def _train_unchanged(monkeypatch):
    """Every step after the set-up's first ones returns its state unchanged."""
    from pita_torch.train.trainer import EnergyTempTrainer

    real = EnergyTempTrainer._apply_gradients

    def no_update(self, grads):
        if self.opt_state.count < 3:  # the traffic's first_steps
            return real(self, grads)
        return torch.zeros(())

    monkeypatch.setattr(EnergyTempTrainer, "_apply_gradients", no_update)


def _train_unchanged_from_start(monkeypatch):
    from pita_torch.train.trainer import EnergyTempTrainer

    monkeypatch.setattr(EnergyTempTrainer, "_apply_gradients", lambda self, grads: torch.zeros(()))


def _train_half_batch(monkeypatch, from_step=0):
    """The loss over half of each batch; with ``from_step`` only from that
    optimizer step on."""
    from pita_torch.train import trainer

    real = trainer.compute_losses
    tr = {}
    orig_init = trainer.EnergyTempTrainer.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        tr["t"] = self

    monkeypatch.setattr(trainer.EnergyTempTrainer, "__init__", init)

    def half(score, energy, sched, cfg, x0, e0, f0, beta, draws=None, **k):
        if tr["t"].opt_state.count < from_step:
            return real(score, energy, sched, cfg, x0, e0, f0, beta, draws=draws, **k)
        h = x0.shape[0] // 2
        d = draws._replace(ln_sigma_draw=draws.ln_sigma_draw[:h], noise=draws.noise[:h])
        return real(score, energy, sched, cfg, x0[:h], e0[:h], f0[:h], beta, draws=d, **k)

    monkeypatch.setattr(trainer, "compute_losses", half)


def _train_half_batch_in_window(monkeypatch):
    _train_half_batch(monkeypatch, from_step=3)


def _train_window_rows(monkeypatch):
    """The window's draws hold half of the batch, the loss the mean over
    it."""
    from pita_torch.train.trainer import EnergyTempTrainer

    real = EnergyTempTrainer.draw_step

    def half(self, temp_idx):
        d = real(self, temp_idx)
        h = d.idx.shape[0] // 2
        return d._replace(idx=d.idx[:h], rot_normal=d.rot_normal[:h],
                          loss=d.loss._replace(ln_sigma_draw=d.loss.ln_sigma_draw[:h],
                                               noise=d.loss.noise[:h]))

    monkeypatch.setattr(EnergyTempTrainer, "draw_step", half)


def _train_altered_in_window(monkeypatch):
    """One element of the window's updates altered where Adam makes it."""
    from pita_torch.train import trainer

    real = trainer.adam_update

    def altered(grads, state, lr, *a, **k):
        updates, st = real(grads, state, lr, *a, **k)
        if st.count > 3:
            updates[0] = updates[0].clone()
            updates[0].view(-1)[0] += 10 * lr
        return updates, st

    monkeypatch.setattr(trainer, "adam_update", altered)


SAMPLING_FAULTS = {"state unchanged": _freeze_state, "half the batch": _half_batch,
                   "answer altered": _altered}
TRAINING_FAULTS = {"state unchanged": _train_unchanged_from_start,
                   "state unchanged in the window": _train_unchanged,
                   "half the batch": _train_half_batch,
                   "half the batch in the window": _train_half_batch_in_window,
                   "half the rows drawn in the window": _train_window_rows,
                   "answer altered in the window": _train_altered_in_window}
CASES = ([("lj55-bf16.hutch-2048", f) for f in SAMPLING_FAULTS]
         + [("lj55-f32.train-256", f) for f in TRAINING_FAULTS])


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, workload, fault):
    plant = (SAMPLING_FAULTS if "train" not in workload else TRAINING_FAULTS)[fault]
    plant(monkeypatch)
    res = run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["lj55-bf16.hutch-2048", "lj55-f32.train-256"])
def test_the_control_fails_the_committed_limits(workload):
    """The reference in the precision below the configuration's, in the
    program's place, reads over at least one limit."""
    cell = harness.load_cell(workload)
    mod = harness.driver_for(cell)
    drv = mod.Driver(cell, SEED, "cpu", sizes=SIZES[workload])
    drv.setup()
    lower = controls.LOWER[cell["config_file"]["precision"]]
    kind = cell["traffic_file"]["driver"]
    rec = drv.job(0)
    if kind == "sample":
        checks = drv.check(controls.control_sample(drv, rec, lower))
    else:
        from perfbench.reference import egnn as R

        with R.strict_f32():
            win = drv.as_window(rec, drv.window_reference(rec, lower))
        checks = drv.check(win)  # the window step alone: the first steps are the program's
        assert not all(c["ok"] for c in checks if c["name"].startswith("window")), checks
        with R.strict_f32():
            first = drv.as_first(drv.reference(lower))
        checks = drv.check(rec, first=first)
    assert not all(c["ok"] for c in checks), checks


def test_run_py_refuses_without_a_card():
    """On a machine without CUDA the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "lj55-bf16.hutch-2048", "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
def test_run_py_on_the_card_prints_one_correct_result(cuda):
    import json

    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "lj55-bf16.hutch-2048", "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["sample_rate"]["value"] > 0
    assert list(res)[-1] == "check"
