"""Training entry point.

Counterpart of ``main`` in ``pita_tpu/train_cli.py:104-171``: compose the
preset with the debug overlay and the overrides, build the trainer, ``fit``,
then ``test`` from the saved checkpoint. Hydra-style arguments:

    python -m pita_torch.train_cli experiment=lj55
    python -m pita_torch.train_cli experiment=lj13 debug=short device=cpu out_dir=/tmp/run

Besides ``pita_tpu``'s ``experiment=``, ``debug=``, ``ckpt_path=``,
``test=``, ``time_checkpoint_seconds=`` and ``name_suffix=``, it takes
``device=`` (CUDA by default; without a GPU that raises unless
``device=cpu``). ``multirun`` and ``sweep`` are not ported.
"""

import sys

_FLAGS = ("name_suffix", "experiment", "debug", "ckpt_path", "test",
          "time_checkpoint_seconds", "device")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from pita_torch.configs import build_trainer, compose, parse_overrides

    flags = dict(experiment="lj13", debug=None, ckpt_path=None, test="true",
                 time_checkpoint_seconds=None, name_suffix=None, device=None)
    overrides = {}
    for a in argv:
        key = a.split("=", 1)[0]
        if key in _FLAGS and "=" in a:
            flags[key] = a.split("=", 1)[1]
        else:
            overrides.update(parse_overrides([a]))

    cfg = compose(flags["experiment"], overrides=overrides, debug=flags["debug"])
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
