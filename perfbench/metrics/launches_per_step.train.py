"""launches_per_step.train (launches): device kernels in the traced window
over the optimizer steps there; copies and sets are not kernels. Layer: the
training step (pita_torch/train/trainer.py:train_step and what it calls)."""


def read(ctx):
    steps = ctx["jobs"] * ctx["driver"].tr["steps_per_job"]
    n = sum(1 for name, _, _ in ctx["reading"]["kernels"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / steps if steps else None
