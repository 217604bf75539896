"""The readings that the exact-trace cell's limits are set from: the
program's over many seeds, the control's, and the planted faults'.

    python3 perfbench/controls_exact.py --workload aldp-dit3d.exact-1024 \
        --seeds <a,b,...> --control-seeds <c,...> --fault-seeds <d,...> [--out <file.json>]

On the card, at the cell's own size (``--device cpu --sizes '{...}'`` for a
rehearsal). For each seed the program runs one job after its set-up and
the check reads it. For each control seed the reference, computed in the
precision below the configuration's (bf16 -> fp8 e4m3), runs the same job
from the same inputs and draws in the program's place, and the same check
reads it. For each fault seed the program runs one job with each planted
fault (``FAULTS``) and the check reads it. The benchmark's own runs do not
run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def state_unchanged():
    """The sampler's step returns the state it was given: every projection
    after the first hands back the first step's result."""
    from pita_torch.sampler import integrator

    real, held = integrator.remove_mean, {}

    def frozen(x, *a):
        if x.shape[0] not in held:
            held[x.shape[0]] = real(x, *a)
        return held[x.shape[0]]

    return _patched(integrator, "remove_mean", frozen)


def half_the_batch():
    """Resampling's softmax and CDF over half of the chains, the choice
    repeated over the rest."""
    from pita_torch.sampler import integrator

    real = integrator.systematic_resample

    def half(a, u0):
        idx = real(a[:a.shape[0] // 2], u0)
        return torch.cat([idx, idx, idx[:a.shape[0] % 2]])

    return _patched(integrator, "systematic_resample", half)


def missing_trace_row(row=-1):
    """The program's exact trace less one of its D one-hot rows' diagonal
    element (the last row's by default): a trace that leaves the row out."""
    from pita_torch.sampler import terms

    real = terms.exact_divergence

    def trace(f, t, x, chunk_size=None, row_chunk=16):
        e = torch.zeros_like(x)
        e[:, row] = 1.0
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            (jt,) = torch.autograd.grad(f(t, xr), xr, e)
        return real(f, t, x, chunk_size, row_chunk) - jt[:, row]

    return _patched(terms, "exact_divergence", trace)


FAULTS = {"state unchanged": state_unchanged, "half the batch": half_the_batch,
          "missing trace row": missing_trace_row}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="aldp-dit3d.exact-1024")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at --sizes")
    ap.add_argument("--sizes", default="{}", help="JSON: the traffic's sizes overridden")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from perfbench import harness
    from perfbench.controls import LOWER

    cell = harness.load_cell(args.workload)
    mod = harness.driver_for(cell)
    split = lambda s: [int(v) for v in s.split(",") if v]
    seeds, cseeds, fseeds = split(args.seeds), split(args.control_seeds), split(args.fault_seeds)
    lower = LOWER[cell["config_file"]["precision"]]
    dev, sizes = args.device, json.loads(args.sizes)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    table = {"workload": args.workload,
             "device": torch.cuda.get_device_name(0) if dev == "cuda" else "cpu",
             "program": {}, "control": {}, **{f: {} for f in FAULTS}}
    read = lambda checks: {c["name"]: c["value"] for c in checks}
    for s in sorted(set(seeds) | set(cseeds) | set(fseeds)):
        t0 = time.perf_counter()
        drv = mod.Driver(cell, s, dev, sizes=sizes)
        drv.setup()
        rec = drv.job(0)
        sync()
        t1 = time.perf_counter()
        if s in seeds:
            table["program"][s] = read(drv.check(rec))
        t2 = time.perf_counter()
        if s in cseeds:
            table["control"][s] = read(drv.check(mod.reference_job(drv, rec, lower)))
        if s in fseeds:
            for name, plant in FAULTS.items():
                with plant():
                    bad = drv.job(0)
                table[name][s] = read(drv.check(bad))
        print(f"seed {s}: set-up and job {t1 - t0:.1f} s, check {t2 - t1:.1f} s, all "
              f"{time.perf_counter() - t0:.1f} s "
              + json.dumps({k: table[k].get(s) for k in table if isinstance(table[k], dict)
                            and s in table[k]}), flush=True)
        del drv, rec
        if dev == "cuda":
            torch.cuda.empty_cache()
    for key, vals in table.items():
        if isinstance(vals, dict) and vals:
            names = next(iter(vals.values())).keys()
            agg = {n: (max if key == "program" else min)(v[n] for v in vals.values())
                   for n in names}
            print(f"{key} ({'largest' if key == 'program' else 'smallest'} over "
                  f"{len(vals)} seeds): {json.dumps(agg)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)


if __name__ == "__main__":
    main()
