"""launches_per_step.sample (launches): device kernels in the traced window
over the Euler-Maruyama steps the sampler ran there; copies and sets are not
kernels. Layer: the sampler loop (pita_torch/sampler/integrator.py)."""


def read(ctx):
    drv = ctx["driver"]
    steps = ctx["jobs"] * drv.steps
    n = sum(1 for name, _, _ in ctx["reading"]["kernels"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / steps if steps else None
