"""step_p95_ms.sample (ms): the 95th percentile of the durations of the
program's `sampler.step` spans in the traced window (300 steps, 15 beyond it):
the host's stalls inside a job. Layer: the sampler loop
(pita_torch/sampler/integrator.py)."""

from perfbench import spans


def read(ctx):
    return spans.step_ms(ctx, "sampler.step", q=95)
