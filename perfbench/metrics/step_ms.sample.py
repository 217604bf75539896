"""step_ms.sample (ms): the median duration of the program's `sampler.step`
spans in the traced window, one an Euler-Maruyama step of `integrate_sde` (3
jobs x 100 steps): the host's issue of a step, or the card's work where the
host waits for it. Layer: the sampler loop
(pita_torch/sampler/integrator.py)."""

from perfbench import spans


def read(ctx):
    return spans.step_ms(ctx, "sampler.step")
