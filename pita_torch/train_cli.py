"""Training entry point.

Counterpart of ``pita_tpu/train_cli.py``: compose the preset with the debug
overlay, a YAML overlay and the overrides, build the trainer, ``fit``, then
``test`` from the saved checkpoint; or run several such trainings. Hydra-style
arguments:

    python -m pita_torch.train_cli                  # experiment=gmm, as in pita_tpu
    python -m pita_torch.train_cli experiment=lj55
    python -m pita_torch.train_cli experiment=lj13 debug=short device=cpu out_dir=/tmp/run
    python -m pita_torch.train_cli experiment=lj13 config=overlay.yaml
    python -m pita_torch.train_cli -m experiment=lj13 debug=short seed=1,2
    python -m pita_torch.train_cli --sweep experiment=lj13 trainer.lr=1e-4:1e-2 sweep_trials=4

Besides ``pita_tpu``'s ``experiment=``, ``debug=``, ``config=``,
``ckpt_path=``, ``test=``, ``time_checkpoint_seconds=`` and
``name_suffix=``, it takes ``device=`` (CUDA by default; without a GPU that
raises unless ``device=cpu``), which reaches every run of ``-m`` and
``--sweep``.
"""

import itertools
import math
import random
import re
import sys
import traceback

_FLAGS = ("name_suffix", "experiment", "debug", "config", "ckpt_path", "test",
          "time_checkpoint_seconds", "device")


def multirun(argv):
    """Hydra's ``-m``: every ``key=a,b`` argument is swept and the cartesian
    product runs in turn, each run's name suffixed with its values
    (train_cli.py:17-39). Returns {suffix: the run's metric}."""
    sweep_keys, sweep_vals, fixed = [], [], []
    for a in argv:
        if "=" in a and "," in a.split("=", 1)[1]:
            k, v = a.split("=", 1)
            sweep_keys.append(k)
            sweep_vals.append(v.split(","))
        else:
            fixed.append(a)
    results = {}
    for combo in itertools.product(*sweep_vals):
        run_args = fixed + [f"{k}={v}" for k, v in zip(sweep_keys, combo)]
        tag = "_".join(f"{k.split('.')[-1]}-{v}" for k, v in zip(sweep_keys, combo))
        if not any(a.startswith("name=") for a in run_args):
            run_args.append(f"name_suffix={tag}")
        print(f"=== multirun: {tag or 'single'} ===")
        results[tag] = main(run_args)
    print(f"multirun done: {results}")
    return results


def sweep(argv):
    """Seeded random search (train_cli.py:42-101; the reference's
    hydra-optuna sweeper with random search for optuna's TPE): ``key=lo:hi``
    is a float range, log-uniform when 0 < lo and hi/lo >= 10; ``key=a,b,c``
    a uniform choice; ``sweep_trials=N`` (default 8) and ``sweep_seed=S``
    set the search. One training a trial, minimizing the metric ``main``
    returns; a trial that raises counts as no metric. Returns the best
    (trial, draw, metric)."""
    trials, seed, ranges, fixed = 8, 0, [], []
    for a in argv:
        if a.startswith("sweep_trials="):
            trials = int(a.split("=", 1)[1])
        elif a.startswith("sweep_seed="):
            seed = int(a.split("=", 1)[1])
        elif "=" in a and re.fullmatch(r"[-+0-9.eE]+:[-+0-9.eE]+", a.split("=", 1)[1]):
            k, v = a.split("=", 1)
            lo, hi = (float(x) for x in v.split(":"))
            ranges.append((k, ("range", lo, hi)))
        elif "=" in a and "," in a.split("=", 1)[1]:
            k, v = a.split("=", 1)
            ranges.append((k, ("choice", v.split(","))))
        else:
            fixed.append(a)
    rng = random.Random(seed)
    best = None
    for t in range(trials):
        draw = {}
        for k, spec in ranges:
            if spec[0] == "range":
                _, lo, hi = spec
                if lo > 0 and hi / lo >= 10:
                    draw[k] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
                else:
                    draw[k] = rng.uniform(lo, hi)
            else:
                draw[k] = rng.choice(spec[1])
        run_args = fixed + [f"{k}={v}" for k, v in draw.items()] + [f"name_suffix=trial{t}"]
        print(f"=== sweep trial {t}/{trials}: {draw} ===")
        try:
            metric = main(run_args)
        except Exception:
            traceback.print_exc()
            metric = None
        if metric is not None and (best is None or metric < best[2]):
            best = (t, draw, metric)
    print(f"sweep done; best trial: {best}")
    return best


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--sweep" in argv:
        return sweep([a for a in argv if a != "--sweep"])
    if "-m" in argv or "--multirun" in argv:
        return multirun([a for a in argv if a not in ("-m", "--multirun")])
    from pita_torch.configs import build_trainer, compose, parse_overrides

    flags = dict(experiment="gmm", debug=None, config=None, ckpt_path=None, test="true",
                 time_checkpoint_seconds=None, name_suffix=None, device=None)
    overrides = {}
    for a in argv:
        key = a.split("=", 1)[0]
        if key in _FLAGS and "=" in a:
            flags[key] = a.split("=", 1)[1]
        else:
            overrides.update(parse_overrides([a]))

    cfg = compose(flags["experiment"], overrides=overrides, debug=flags["debug"],
                  yaml_path=flags["config"])
    if flags["name_suffix"]:
        cfg.name = f"{cfg.name}_{flags['name_suffix']}"
    print(f"experiment={cfg.name} tags={cfg.tags} out_dir={cfg.out_dir}")
    ckpt_path = flags["ckpt_path"]
    trainer = build_trainer(cfg, resume=ckpt_path is not None, device=flags["device"])
    time_ckpt = flags["time_checkpoint_seconds"]
    metric = None
    try:
        trainer.fit(ckpt_path=ckpt_path, resume=ckpt_path is not None,
                    time_checkpoint_seconds=float(time_ckpt) if time_ckpt else None)
        if flags["test"].lower() == "true":
            metrics = trainer.test(ckpt_path=ckpt_path)
            vals = [v for k, v in metrics.items() if "energy_w2" in k]
            metric = vals[0] if vals else None
    finally:
        if trainer.metrics_history:
            print(f"final metrics: {trainer.metrics_history[-1]}")
    return metric


if __name__ == "__main__":
    main()
