"""idle_ms.sample.energy_grad (ms): the card's idle time inside the program's
`sampler.energy_grad` spans (the energy net's forward and its autograd.grad:
the K2 and K3 launches and their glue), per EM step: each gap between device
operations in the traced window, split by its overlap with those spans, summed,
over the number of `sampler.step` spans. Layer: whole step
(pita_torch/sampler/terms.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "sampler.energy_grad", "sampler.step")
