"""idle_pct (%): the share of the jobs' time in which no operation ran on the
card: 1 - busy / time, busy the union of the device operations' intervals
in the torch.profiler trace, time what the same jobs took untraced (the
profiler's cost on the host stretches the traced window). Layer: device."""


def read(ctx):
    r = ctx["reading"]
    if r["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["untraced_s"])
