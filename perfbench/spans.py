"""The program's spans against the device trace: how long its steps took,
and which part of a step the card sat idle in.

The spans are ``pita_torch.utils.tracing``'s records, which the program
makes while a profiler session is active, so in the traced window alone;
their ``time.time_ns()`` stamps are divided by 1e3 to lie on the trace's
clock (µs). The card's idle intervals are the gaps in the union of the
device operations' intervals (``ctx["reading"]["kernels"]``, the markers
left out), the union ``perfbench/trace.py`` takes. Each idle interval is
split by its overlap with the spans of each name: while the card waits,
the host may pass through several parts of a step, and each holds the card
up for the time it is open.

A program without spans (one before ``pita_torch/utils/tracing.py``) gives
``None`` to every reader, and the run leaves the metric out.
"""

import statistics
import sys


def program_spans():
    """The program's span records, or None where it recorded none."""
    try:
        from pita_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans() or None


def merged(intervals):
    """The union of (start, end) intervals as a sorted list of disjoint ones;
    touching intervals join."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(kernels):
    """The gaps between the device operations' merged intervals."""
    busy = merged((s, e) for _, s, e in kernels)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def overlap(a, b):
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarise(records, kernels):
    """Per span name: its count, its durations (ms) and the idle µs inside
    it; per name whose spans have children, the children's names and the
    idle µs inside them. Spans still open are left out."""
    gaps = idle_gaps(kernels)
    by_name, children, kids = {}, {}, {}
    for r in records:
        if r.end_ns is None:
            continue
        iv = (r.start_ns / 1e3, r.end_ns / 1e3)
        by_name.setdefault(r.name, []).append(iv)
        if r.parent is not None:
            parent = records[r.parent].name
            children.setdefault(parent, []).append(iv)
            kids.setdefault(parent, {})[r.name] = None
    return dict(
        gaps=gaps,
        count={n: len(iv) for n, iv in by_name.items()},
        ms={n: [(e - s) / 1e3 for s, e in iv] for n, iv in by_name.items()},
        idle={n: overlap(gaps, merged(iv)) for n, iv in by_name.items()},
        kids={n: list(k) for n, k in kids.items()},
        idle_children={n: overlap(gaps, merged(iv)) for n, iv in children.items()},
        idle_any=overlap(gaps, merged(iv for ivs in by_name.values() for iv in ivs)),
    )


def reading(ctx):
    """The run's summary of its spans (computed once, kept in ``ctx``), or
    None without spans. The first call reports on stderr how the window's
    idle time falls: inside no span, and inside each name that has children,
    in them and in none of them (its own)."""
    if "program_spans" not in ctx:
        records = program_spans()
        ctx["program_spans"] = out = (None if records is None
                                      else summarise(records, ctx["reading"]["kernels"]))
        if out is None:
            print("perfbench: the program recorded no spans", file=sys.stderr)
        else:
            report(out)
    return ctx["program_spans"]


def report(out):
    total = sum(b - a for a, b in out["gaps"]) / 1e3
    print(f"perfbench: spans: {total:.3f} ms idle between device operations, "
          f"{out['idle_any'] / 1e3:.3f} ms of it inside some program span", file=sys.stderr)
    for name, kids in out["kids"].items():
        n, idle = out["count"][name], out["idle"][name] / 1e3
        inside = out["idle_children"][name] / 1e3
        parts = ", ".join(f"{k} {out['idle'][k] / 1e3 / n:.4f}" for k in kids)
        print(f"perfbench: spans: {n} {name} spans: {idle:.3f} ms idle inside them "
              f"({100 * idle / total if total else 0.0:.2f} % of the window's), "
              f"{inside:.3f} ms in their children, {idle - inside:.3f} ms their own; "
              f"per {name}, ms: {parts}", file=sys.stderr)


def idle_ms(ctx, name, step):
    """Idle ms inside the spans ``name`` over the number of ``step`` spans;
    None where no span ``name`` was recorded."""
    out = reading(ctx)
    if out is None or name not in out["count"] or not out["count"].get(step):
        return None
    return out["idle"][name] / 1e3 / out["count"][step]


def step_ms(ctx, step, q=None):
    """The median duration (ms) of the spans ``step``, or with ``q`` its
    ``q``-th percentile; None without such spans."""
    out = reading(ctx)
    if out is None or step not in out["ms"]:
        return None
    ms = out["ms"][step]
    if q is None:
        return statistics.median(ms)
    return statistics.quantiles(ms, n=100)[q - 1] if len(ms) > 1 else ms[0]
