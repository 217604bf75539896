"""MD data-generation entry point.

Counterpart of ``pita_tpu/generate_md_cli.py``: Langevin MD on a chosen
peptide at a chosen temperature, with checkpointed ``.npz`` trajectory
dumps. The same ``key=value`` options, and ``device=`` (CUDA by default;
without a GPU that raises unless ``device=cpu``):

    python -m pita_torch.generate_md_cli peptide=aldp temperature=300 \
        n_steps=100000 out=data/aldp_md.npz
"""

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(a.split("=", 1) for a in argv)
    peptide = opts.get("peptide", "aldp")
    temperature = float(opts.get("temperature", 300.0))
    n_steps = int(opts.get("n_steps", 100000))
    n_replicas = int(opts.get("n_replicas", 8))
    seed = int(opts.get("seed", 0))
    out = opts.get("out", f"{peptide}_md_T{temperature:.0f}.npz")

    from pita_torch.baselines.md import generate_md_dataset
    from pita_torch.targets.alp import ALPEnergy

    target = ALPEnergy(peptide, temperature=temperature)
    path = generate_md_dataset(target, out, n_steps=n_steps, n_replicas=n_replicas, seed=seed,
                               device=opts.get("device"))
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
