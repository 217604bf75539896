"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
It exits with a code other than 0, and prints no result, without CUDA or
with too few cards, and if the JAX package or JAX itself was loaded. The
kernels' build directory is the checkout's ``pita_torch/_build/``; Triton
and PyTorch extension caches go to ``.perfbench_cache/`` in the checkout.
"""

import time

_T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pita_tpu")


def process_start():
    """The process's start on the wall clock (from /proc), else the time
    this module began."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T0


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    start = process_start()
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['chips']} cards needed, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      lambda: time.time() - start)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = res.pop("checks")
    peak = res.pop("peak")
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"],
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": cell["chips"], "memory_peak_bytes": peak}}
    if args.trace:
        out["device"].update(busy_s=res["busy_s"], window_s=res["window_s"])
        out["breakdown"] = res["breakdown"]
    out["check"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        for note in c.get("notes", []):
            print(f"perfbench: {c['name']}: {note}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
