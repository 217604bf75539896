"""The readings that a cell's limits are set from: the program's over many
seeds, and the control's.

    python3 perfbench/controls.py --workload <name> --seeds <a,b,...> \
        --control-seeds <c,d,...> [--out <file.json>]

On the card, at the cell's own size. For each seed the program runs one job
(for the training cell: after its set-up's first steps) and the check reads
it. For each control seed the reference, put in the program's place and
computed in the precision below the configuration's (bf16 -> fp8, f32 ->
TF32), runs the same job from the same inputs and draws (for the training
cell: the first steps, and the recorded window step from the program's
state), and the same check reads it; for the training cell also the
reference with half of each batch left out (the mean over the rest). The
benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOWER = {"bf16": "fp8", "f32": "tf32"}


class Replay:
    """The draws one program job took, handed to the reference sampler."""

    def __init__(self, log):
        self.log = log

    def probes(self, i):
        return self.log["probes"][i]

    def noise(self, i):
        return self.log["noise"][i]

    def u0(self, i):
        return self.log["u0"][i]


def control_sample(drv, rec, precision):
    """The reference sampler in ``precision`` over a hutch job's inputs."""
    import torch

    from perfbench import port
    from perfbench.reference import egnn as R
    from perfbench.reference import sampler as S

    nets = port.ref_nets(drv.cfg, drv.weights, precision)
    beta = torch.tensor(1.0, device=drv.dev)
    with R.strict_f32():
        r = S.integrate(nets, port.ref_schedule(drv.cfg), drv.gamma, rec["x1"], beta,
                        Replay(rec["log"]), n_steps=rec["n_steps"],
                        end_resampling=rec["end_resampling"], ess_threshold=rec["ess_threshold"],
                        div_interval=rec["div_interval"])
    return dict(rec, states=r["states"], samples=r["samples"],
                logweights=r["logweights"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at --sizes")
    ap.add_argument("--sizes", default="{}", help="JSON: the traffic's sizes overridden")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    mod = harness.driver_for(cell)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    lower = LOWER[cell["config_file"]["precision"]]
    dev, sizes = args.device, json.loads(args.sizes)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    table = {"workload": args.workload,
             "device": torch.cuda.get_device_name(0) if dev == "cuda" else "cpu",
             "program": {}, "control": {}, "half_batch": {}}
    kind = cell["traffic_file"]["driver"]
    drv = None
    for s in sorted(set(seeds) | set(cseeds)):
        t0 = time.perf_counter()
        if drv is None or kind == "train":
            drv = mod.Driver(cell, s, dev, sizes=sizes)
            drv.setup()
        drv.seed = s
        rec = drv.job(0)
        sync()
        if s in seeds:
            table["program"][s] = {c["name"]: c["value"] for c in drv.check(rec)}
        if s in cseeds:
            if kind == "train":
                from perfbench.reference import egnn as R

                for key, prec, half in (("control", lower, False), ("half_batch", None, True)):
                    with R.strict_f32():
                        first = drv.as_first(drv.reference(prec, half=half))
                        win = drv.as_window(rec, drv.window_reference(rec, prec, half=half))
                    table[key][s] = {c["name"]: c["value"] for c in drv.check(win, first=first)}
            else:
                ctrl = control_sample(drv, rec, lower)
                table["control"][s] = {c["name"]: c["value"] for c in drv.check(ctrl)}
        print(f"seed {s}: {time.perf_counter() - t0:.1f} s "
              + json.dumps({k: table[k].get(s) for k in ("program", "control", "half_batch")}),
              flush=True)
        if kind == "train":
            drv.free_program()
    for key in ("program", "control", "half_batch"):
        vals = table[key]
        if vals:
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
