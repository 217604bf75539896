"""idle_ms.aldp.divergence (ms): the card's idle time inside the program's
`sampler.divergence` spans (the exact trace: 5 passes of one-hot VJPs through
the DiT3D score), per EM step: each gap between device operations in the
traced window, split by its overlap with those spans, summed, over the number
of `sampler.step` spans. Layer: whole step (pita_torch/sampler/terms.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "sampler.divergence", "sampler.step")
