"""idle_ms.sample.weights (ms): the card's idle time inside the program's
`sampler.weights` spans (drift_X, drift_A and its quantile clamp), per EM step:
each gap between device operations in the traced window, split by its overlap
with those spans, summed, over the number of `sampler.step` spans. Layer: whole
step (pita_torch/sampler/terms.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "sampler.weights", "sampler.step")
