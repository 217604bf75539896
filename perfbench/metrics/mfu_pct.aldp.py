"""mfu_pct.aldp (%): the whole step's products over the card's bf16 peak
(989 TFLOP/s). The products per chain-step are fixed by the algorithm and
the configuration's widths (perfbench/frozen/dit_counts.py): 135 DiT3D
forward-equivalents (the score's forward, the energy's forward and input
gradient, and 66 VJPs of the exact trace), 2 x 27,433,472 operations each at
aldp's widths; times the chain-steps a second of the traced jobs, run
untraced. Layer: whole step (pita_torch/sampler/terms.py,
pita_torch/nets/dit.py, pita_torch/ops/divergence.py)."""

from perfbench.frozen.dit_counts import PEAK_BF16, flops_per_chain_step


def read(ctx):
    return 100.0 * flops_per_chain_step(ctx["driver"].cfg) * ctx["rate"] / PEAK_BF16
