"""One run of one cell: set-up, a closed-loop window, the check, one result.

Driven by data: the cell's entry in ``BENCHMARK.json`` names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); the traffic file names its job
driver (``perfbench/drivers/<driver>.py``); each per-layer metric of the
cell is read by ``perfbench/metrics/<name>.py``. A new cell, configuration,
traffic mix or metric is new files and entries; this file stays as it is.

The window is a closed loop with one client: the next job starts when the
last one has synchronised, and it runs until ``seconds`` have passed. The
end-to-end rate is all the work of all jobs over the window's whole time.
With ``trace`` the run times the traffic's ``trace_jobs`` jobs untraced,
then profiles the same jobs, and reports the per-layer metrics read from
them; a rate among them (``ctx["rate"]``) is the untraced one.
"""

import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from perfbench import trace as T

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload, bench_path=None):
    """The cell's entry of BENCHMARK.json with its configuration, traffic
    and metric entries resolved."""
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = dict(cells[workload])
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cell["config_file"] = load_json(ROOT / config["file"])
    cell["traffic_file"] = load_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def reports(m):
        return workload in m.get("workloads", [workload]) and e2e_of(m["moves"])

    def e2e_of(name):
        m = next(e for e in bench["end_to_end"] if e["name"] == name)
        return workload in m.get("workloads", [workload])

    cell["end_to_end"] = [m for m in bench["end_to_end"] if e2e_of(m["name"])]
    cell["per_layer"] = [m for m in bench["per_layer"] if reports(m)]
    return cell


def driver_for(cell):
    name = cell["traffic_file"]["driver"]
    return load_module(HERE / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def run(cell, seed, seconds, trace, device, setup_clock, sizes=None):
    """Set-up, window, check; returns the result dict (without ``device``'s
    card fields, which the caller adds). ``sizes`` overrides the traffic's
    parameters (the tests' small sizes on the CPU)."""
    mod = driver_for(cell)
    drv = mod.Driver(cell, seed, device, sizes=sizes)
    t_entry = setup_clock()
    if device == "cuda":
        from pita_torch.ops import _build

        _build.build_all()  # nvcc, once per checkout: pita_torch/_build/ keeps the libraries
    t_built = setup_clock()
    drv.setup()
    sync = (lambda: torch.cuda.synchronize()) if device == "cuda" else (lambda: None)
    sync()
    setup_s = setup_clock()
    print(f"perfbench: set-up {setup_s:.2f} s: to the harness {t_entry:.2f} s, kernel "
          f"libraries {t_built - t_entry:.2f} s, the driver's set-up {setup_s - t_built:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in getattr(drv, 'setup_times', {}).items())})",
          file=sys.stderr)

    keep = random.Random(seed)  # reservoir of one: the job the check reads
    kept, jobs, work = None, 0, 0.0
    prof = None
    if trace:
        # the same jobs untimed by the profiler first: the profiler's own cost
        # on the host would otherwise read as the card's idle time
        u0 = time.perf_counter()
        for k in range(drv.trace_jobs):
            drv.job(k)
            sync()
        untraced_s = time.perf_counter() - u0
        prof = T.start()
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        rec = drv.job(jobs)
        sync()
        ends.append(time.perf_counter())
        work += drv.work_per_job
        jobs += 1
        if rec is not None and keep.random() * jobs < 1.0:
            kept = rec
        if trace and jobs >= drv.trace_jobs:
            break
        if not trace and time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    reading = None
    if trace:
        reading = T.stop(prof)
        reading["untraced_s"] = untraced_s
        print(f"perfbench: the traced jobs took {window_s / untraced_s:.4f} times as long as "
              f"untraced ({untraced_s:.3f} s)", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    took = sorted(b - a for a, b in zip(ends, ends[1:]))
    print(f"perfbench: window {window_s:.3f} s, {jobs} jobs; a job took {took[0]:.4f} s at "
          f"least, {took[len(took) // 2]:.4f} s median, {took[-1]:.4f} s at most",
          file=sys.stderr)
    drv.free_program()
    t_check = time.perf_counter()
    checks = drv.check(kept)
    print(f"perfbench: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = all(c["ok"] for c in checks)
    rate_name = drv.rate_name
    rate = work / window_s
    out = {"correct": correct, "attempted": jobs, "failed": 0 if correct else 1}
    if trace:
        ctx = dict(cell=cell, driver=drv, jobs=jobs, work=work, window_s=window_s,
                   rate=work / untraced_s, reading=reading)
        metrics = {}
        for m in cell["per_layer"]:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "perfbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        out["busy_s"], out["window_s"] = reading["busy_s"], reading["window_s"]
        out["breakdown"] = {"device_ops": reading["device_ops"],
                            "idle_gaps": reading["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        out["metrics"] = {rate_name: {"value": rate, "unit": units[rate_name]},
                          "setup_s": {"value": setup_s, "unit": units["setup_s"]}}
    out["peak"] = peak
    out["checks"] = checks
    return out
