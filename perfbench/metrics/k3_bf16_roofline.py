"""k3_bf16_roofline (%): the bf16 K3 (EGCL VJP) kernels' least time over
their device time in the traced window. The least time is the frozen
egcl bound (perfbench/frozen/bounds.py) of the VJPs the sampler needs: per
step one through each layer of the energy net at the chains' batch, and on
every step that recomputes the Hutchinson divergence one through each layer
of the score net at probes x chains. Layer: EGCL layer kernels
(pita_torch/ops/egnn_layer.py -> csrc/egnn_layer_tc.cu)."""

from perfbench.frozen.bounds import PEAK_BF16, k3_bound

KERNELS = ("egcl_bwd_tc_kernel",)


def read(ctx):
    drv = ctx["driver"]
    ms = sum(e - s for name, s, e in ctx["reading"]["kernels"]
             if any(k in name for k in KERNELS)) / 1e3
    if ms <= 0:
        return None
    cfg, tr = drv.cfg, drv.tr
    N, F, L, B = cfg["n_particles"], cfg["hidden_nf"], cfg["n_layers"], drv.chains
    rediv = -(-drv.steps // tr["divergence_update_interval"])
    P = tr["hutchinson_probes"]
    bound = ctx["jobs"] * L * (drv.steps * k3_bound(B, N, F, PEAK_BF16)[0]
                               + rediv * k3_bound(P * B, N, F, PEAK_BF16)[0])
    return 100.0 * bound / ms
