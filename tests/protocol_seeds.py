"""The LJ ground-truth protocol at shifted seeds, held to a committed asset.

For one committed ``data/<asset>.rhat.json`` (``LJ<N>_temp_<T>_<which>``) this
runs the ten-run protocol (``generate_lj_dataset_reference_protocol``) at the
settings ``scripts/make_ground_truth.py`` uses for that asset, at the asset's
seed plus 100·j for each shift j, and prints one JSON line a shift: R-hat, the
run energy means, and the largest gap to the committed run means with run r
paired to committed run r (the script's cross-backend rule,
make_ground_truth.py:114-141) and with the runs paired by rank, beside that
rule's tolerance. A last line sums the shifts up. Either implementation can be
run, so both are held to the same committed asset by the same rule:

    python tests/protocol_seeds.py torch LJ55_temp_1.0_val 1 8        # pita_torch, CUDA
    python tests/protocol_seeds.py torch LJ13_temp_1.0_val 1 2 --device cpu
    JAX_PLATFORMS=cpu python tests/protocol_seeds.py jax LJ55_temp_1.0_val 1 4  # pita_tpu

Shifts of 100 keep every seed (and its runs' seed + 1000·r) apart from the
committed assets' seeds, which lie in 0..111.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gaps(committed: dict, diag: dict) -> dict:
    """The cross-backend rule's arms for one protocol run."""
    old = np.asarray(committed["per_run_energy_mean"])
    new = np.asarray(diag["per_run_energy_mean"])
    tol = max(0.05 * float(np.mean(committed["per_run_energy_std"])), 3.5 * float(np.std(old)))
    index_gap = float(np.max(np.abs(old - new)))
    rank_gap = float(np.max(np.abs(np.sort(old) - np.sort(new))))
    rhat_gap = abs(diag["rhat_energy"] - committed["rhat_energy"])
    return dict(tol=tol, index_gap=index_gap, rank_gap=rank_gap, rhat_gap=rhat_gap,
                index_ok=index_gap <= tol and rhat_gap <= 0.02,
                rank_ok=rank_gap <= tol and rhat_gap <= 0.02)


def protocol(backend: str, n_part: int, T: float, seed: int, committed: dict, device: str):
    kw = dict(num_samples=committed["num_samples"], n_runs=committed["n_runs"], seed=seed,
              warmup=committed["warmup"])
    if backend == "jax":
        from pita_tpu.baselines.mcmc import generate_lj_dataset_reference_protocol
        from pita_tpu.targets.lj import LennardJones

        target = LennardJones(n_particles=n_part, smooth=True, temperature=T)
        return generate_lj_dataset_reference_protocol(target, **kw)[1]
    from pita_torch.baselines.mcmc import generate_lj_dataset_reference_protocol
    from pita_torch.targets import LennardJones

    target = LennardJones(n_part, smooth=True, temperature=T)
    return generate_lj_dataset_reference_protocol(target, device=device, **kw)[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("backend", choices=("torch", "jax"))
    p.add_argument("asset", help="a committed data/<asset>.rhat.json, e.g. LJ55_temp_1.0_val")
    p.add_argument("first", type=int, help="first shift j (seed + 100 j)")
    p.add_argument("last", type=int, help="last shift j")
    p.add_argument("--device", default="cuda", help="pita_torch's device (default cuda)")
    a = p.parse_args(argv)
    sys.path.insert(0, REPO)
    with open(os.path.join(REPO, "data", f"{a.asset}.rhat.json")) as f:
        committed = json.load(f)
    n_part, _, T, which = a.asset.split("_")
    n_part, T = int(n_part[2:]), float(T)
    base = {"train": 0, "val": 50, "test": 90}[which] + int(T * 7)
    means, rows = [], []
    for j in range(a.first, a.last + 1):
        t0 = time.perf_counter()
        diag = protocol(a.backend, n_part, T, base + 100 * j, committed, a.device)
        row = dict(backend=a.backend, asset=a.asset, seed=base + 100 * j,
                   seconds=time.perf_counter() - t0, rhat=diag["rhat_energy"],
                   converged=diag["converged"], per_run_energy_mean=diag["per_run_energy_mean"],
                   std_of_means=float(np.std(diag["per_run_energy_mean"])),
                   **gaps(committed, diag))
        print(json.dumps(row), flush=True)
        means += diag["per_run_energy_mean"]
        rows.append(row)
    old = committed["per_run_energy_mean"]
    print(json.dumps(dict(
        backend=a.backend, asset=a.asset, shifts=[a.first, a.last], n=len(rows),
        index_misses=sum(not r["index_ok"] for r in rows),
        rank_misses=sum(not r["rank_ok"] for r in rows),
        not_converged=sum(not r["converged"] for r in rows),
        pooled_mean=float(np.mean(means)), pooled_std_of_means=float(np.std(means, ddof=1)),
        committed_mean=float(np.mean(old)), committed_std_of_means=float(np.std(old, ddof=1)),
        mean_run_spread=float(np.mean(committed["per_run_energy_std"])),
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
