"""The aldp cell (``aldp-dit3d.exact-1024``) driven through a whole run at a
small size on the CPU, past the harness's look for a card: a sound run is
correct; each planted fault (``perfbench/controls_exact.py:FAULTS``) and
the fp8 control make ``correct`` false under the committed limits.

    python -m pytest -p no:cacheprovider perfbench/tests/test_perfbench_aldp.py

About two minutes on a CPU: the published widths at 32 chains x 3 steps.
"""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import controls, controls_exact, harness, trace
from pita_torch.utils import tracing

WORKLOAD = "aldp-dit3d.exact-1024"
SEED = 3_000_000_000_017  # above 2**31, as the driver's are
SIZES = {"chains": 32, "steps": 3, "end_resampling_step": 2, "ref_block": 16}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run(seed=SEED):
    cell = harness.load_cell(WORKLOAD)
    t0 = time.time()
    return harness.run(cell, seed, 0.01, False, "cpu", lambda: time.time() - t0, sizes=SIZES)


def test_a_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["metrics"]["setup_s"]["value"] > 0
    assert res["metrics"]["sample_rate"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(controls_exact.FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(fault):
    with controls_exact.FAULTS[fault]():
        res = run()
    assert not res["correct"], res["checks"]


def test_the_fp8_control_fails_the_committed_limits():
    """The reference with its products' inputs in fp8 e4m3, in the
    program's place, reads over at least one limit."""
    cell = harness.load_cell(WORKLOAD)
    mod = harness.driver_for(cell)
    drv = mod.Driver(cell, SEED, "cpu", sizes=SIZES)
    drv.setup()
    rec = drv.job(0)
    checks = drv.check(mod.reference_job(drv, rec, controls.LOWER["bf16"]))
    assert not all(c["ok"] for c in checks), checks


def test_the_traced_run_reports_the_counters(monkeypatch):
    """A traced run on the CPU, under a CPU profiler: the span counters read
    the trace's passes and the DiT's rows a step."""
    def start():
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.__enter__()
        return prof

    def stop(prof):
        prof.__exit__(None, None, None)
        return dict(kernels=[], busy_s=0.0, window_s=1.0, device_ops=[], idle_gaps=[])

    monkeypatch.setattr(trace, "start", start)
    monkeypatch.setattr(trace, "stop", stop)
    cell = harness.load_cell(WORKLOAD)
    t0 = time.time()
    tracing.clear()
    try:
        res = harness.run(cell, SEED, 0.01, True, "cpu", lambda: time.time() - t0, sizes=SIZES)
    finally:
        tracing.clear()
    m = {k: v["value"] for k, v in res["metrics"].items()}
    D = 3 * cell["config_file"]["n_particles"]
    assert m["trace_passes_per_step.aldp"] == pytest.approx(-(-D // 16))
    assert m["dit_rows_per_step.aldp"] == pytest.approx(SIZES["chains"] * (2 + D))
    assert m["mfu_pct.aldp"] > 0


def test_the_cell_s_modules_load_no_jax():
    root = Path(__file__).resolve().parents[2]
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness, checks_exact, controls_exact\n"
            "from perfbench.reference import dit\n"
            "from perfbench.frozen import dit_counts\n"
            "harness.load_module(harness.HERE / 'drivers' / 'sample_exact.py', 'd')\n"
            "import pita_torch.nets.dit, pita_torch.ops.divergence, pita_torch.targets\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'jax', 'jaxlib', 'flax', 'optax', 'pita_tpu'}))\n" % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
