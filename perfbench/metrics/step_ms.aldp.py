"""step_ms.aldp (ms): the median duration of the program's `sampler.step`
spans in the traced window, one an Euler-Maruyama step of `integrate_sde` (2
jobs x 10 steps of 1,024 chains, each with the exact trace by 66 VJPs).
Layer: the sampler loop (pita_torch/sampler/integrator.py)."""

from perfbench import spans


def read(ctx):
    return spans.step_ms(ctx, "sampler.step")
