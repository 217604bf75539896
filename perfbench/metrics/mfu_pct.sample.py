"""mfu_pct.sample (%): the whole step's products over the card's bf16 peak
(989 TFLOP/s). The products per chain-step are fixed by the algorithm and
the configuration's shapes: in each EGCL layer the edge MLP, attention,
coordinate MLP and node MLP (perfbench/frozen/bounds.py:egcl_forward_macs)
for the score forward, the energy's value and its gradient, and on every
step that recomputes the Hutchinson divergence one VJP a probe; two
operations a multiply-add; times the chain-steps a second of the traced
jobs, run untraced.
Layer: whole step (pita_torch/sampler/terms.py, pita_torch/nets/egnn.py)."""

from perfbench.frozen.bounds import PEAK_BF16, egcl_forward_macs


def read(ctx):
    drv = ctx["driver"]
    cfg, tr = drv.cfg, drv.tr
    per_layer = egcl_forward_macs(cfg["n_particles"], cfg["hidden_nf"])
    passes = 3 + tr["hutchinson_probes"] / tr["divergence_update_interval"]
    flops = 2 * cfg["n_layers"] * per_layer * passes
    return 100.0 * flops * ctx["rate"] / PEAK_BF16
