"""idle_ms.sample.resample (ms): the card's idle time inside the program's
`sampler.resample` spans (the ESS-triggered systematic resampling), per EM
step: each gap between device operations in the traced window, split by its
overlap with those spans, summed, over the number of `sampler.step` spans.
Layer: the sampler loop (pita_torch/sampler/integrator.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "sampler.resample", "sampler.step")
