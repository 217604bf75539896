"""trace_passes_per_step.aldp (passes): the program's
`divergence.exact_pass` spans in the traced window over its `sampler.step`
spans: the forward and VJP passes of the exact trace a step (66 rows in
passes of 16: 5). None where the program records no such span. Layer: the
generic exact trace (pita_torch/ops/divergence.py:exact_divergence)."""

from perfbench import spans


def read(ctx):
    records = spans.program_spans() or []
    steps = sum(1 for r in records if r.name == "sampler.step" and r.end_ns is not None)
    n = sum(1 for r in records if r.name == "divergence.exact_pass" and r.end_ns is not None)
    return n / steps if steps and n else None
