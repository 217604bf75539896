"""idle_ms.sample.update (ms): the card's idle time inside the program's
`sampler.update` spans (the probe, noise and u0 draws, the EM update, the
mean-free projection, the log-weights and the term stds), per EM step: each gap
between device operations in the traced window, split by its overlap with those
spans, summed, over the number of `sampler.step` spans. Layer: the sampler loop
(pita_torch/sampler/integrator.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "sampler.update", "sampler.step")
