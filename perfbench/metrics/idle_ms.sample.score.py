"""idle_ms.sample.score (ms): the card's idle time inside the program's
`sampler.score` spans (the score net's forward), per EM step: each gap between
device operations in the traced window, split by its overlap with those spans,
summed, over the number of `sampler.step` spans. Layer: whole step
(pita_torch/sampler/terms.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "sampler.score", "sampler.step")
