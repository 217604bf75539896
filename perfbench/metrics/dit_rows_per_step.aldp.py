"""dit_rows_per_step.aldp (rows): the rows of the program's `dit.forward`
spans in the traced window, summed, over its `sampler.step` spans: the
DiT3D's batch rows a step (the score's 1,024, the energy's 1,024 and the
exact trace's 66 x 1,024: 69,632). None where the program records no such
span. Layer: the DiT3D backbone (pita_torch/nets/dit.py)."""

from perfbench import spans


def read(ctx):
    records = spans.program_spans() or []
    steps = sum(1 for r in records if r.name == "sampler.step" and r.end_ns is not None)
    rows = sum(r.attrs.get("rows", 0) for r in records
               if r.name == "dit.forward" and r.end_ns is not None)
    return rows / steps if steps and rows else None
