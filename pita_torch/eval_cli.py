"""Evaluation entry point.

Counterpart of ``pita_tpu/eval_cli.py`` (the reference's ``eval.py``):
compose the preset with the overrides, build the trainer, restore a
checkpoint, run the test phase (the final annealed sampling and its
metrics) and print the metrics.

    python -m pita_torch.eval_cli experiment=lj55 ckpt_path=runs/lj55/ckpt.pt
    python -m pita_torch.eval_cli experiment=lj13 ckpt_path=/tmp/ckpt.pt device=cpu

``device=`` as in ``train_cli``: CUDA by default, raising without a GPU.
"""

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from pita_torch.configs import build_trainer, compose, parse_overrides
    from pita_torch.io.checkpoint import restore_checkpoint

    flags = dict(experiment="gmm", debug=None, ckpt_path=None, device=None)
    overrides = {}
    for a in argv:
        key = a.split("=", 1)[0]
        if key in flags and "=" in a:
            flags[key] = a.split("=", 1)[1]
        else:
            overrides.update(parse_overrides([a]))
    if flags["ckpt_path"] is None:
        raise ValueError("eval requires ckpt_path=...")
    cfg = compose(flags["experiment"], overrides=overrides, debug=flags["debug"])
    trainer = build_trainer(cfg, device=flags["device"])
    restore_checkpoint(trainer, flags["ckpt_path"])
    metrics = trainer.test()
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics


if __name__ == "__main__":
    main()
