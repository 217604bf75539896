"""The traced window: device operations from torch.profiler, host phases from
the host's clock.

The profiler records the card's activity only (``ProfilerActivity.CUDA``):
recording every host operation as well would stretch a host-paced window by
its own cost and count that as idle. The job drivers mark their host phases
with ``phase(name)``, which stamps the host's clock only while a trace is
open. Two marker kernels, one before the window and one after it, each
between synchronisations, tie the trace's clock to the host's.

``stop`` reduces the trace to what the readers and the result's
``breakdown`` need:

- ``kernels``: every device operation (kernels, copies, sets) as (name,
  start µs, end µs), the markers left out;
- ``busy_s``: the time in which some device operation ran (the union of
  their intervals), ``window_s`` the traced window's wall time;
- ``device_ops``: the 10 names with the most device time, in seconds;
- ``idle_gaps``: the device's idle time summed by the host phase that was
  open when each gap began, the 10 largest, in seconds.
"""

import contextlib
import sys
import time

import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
_phases = None  # (name, start ns, end ns) on the host's clock while a trace is open


@contextlib.contextmanager
def phase(name):
    """A host phase of a job driver, stamped while a trace is open."""
    if _phases is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        _phases.append((name, t0, time.time_ns()))


def _mark():
    """Host time (ns) around one marker kernel, between synchronisations."""
    torch.cuda.synchronize()
    h0 = time.time_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return (h0 + time.time_ns()) / 2


def start():
    global _phases
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    prof._perfbench_marks = [_mark()]
    _phases = []
    prof._perfbench_t0 = time.perf_counter()
    return prof


def _events(prof):
    """Device operations: (name, start µs, end µs) on the trace's clock."""
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        s = e.start_ns() / 1e3
        dev.append((e.name(), s, s + e.duration_ns() / 1e3))
    return dev


def _host_to_trace(dev, marks):
    """The markers' device starts against their host times: a map from the
    host's clock (ns) to the trace's (µs), and the device operations
    without the markers."""
    found = [r for r in dev if MARKER in r[0]]
    rest = [r for r in dev if MARKER not in r[0]]
    if len(found) != 2:
        print(f"perfbench: {len(found)} marker kernels in the trace, 2 expected: host phases "
              "are placed by the host's clock alone", file=sys.stderr)
        return (lambda ns: ns / 1e3), rest
    (_, d0, _), (_, d1, _) = sorted(found, key=lambda r: r[1])
    h0, h1 = marks
    slope = (d1 - d0) / ((h1 - h0) / 1e3) if h1 > h0 else 1.0
    print(f"perfbench: trace clock: offset {d0 - h0 / 1e3:.1f} µs, drift {slope - 1:.3g} over "
          f"the window", file=sys.stderr)
    return (lambda ns: d0 + (ns - h0) / 1e3 * slope), rest


def stop(prof):
    global _phases
    torch.cuda.synchronize()
    window_s = time.perf_counter() - prof._perfbench_t0
    host, _phases = _phases, None
    prof._perfbench_marks.append(_mark())
    prof.__exit__(None, None, None)
    to_trace, dev = _host_to_trace(_events(prof), prof._perfbench_marks)
    dev.sort(key=lambda r: r[1])
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted(((name, to_trace(a), to_trace(b)) for name, a, b in host),
                   key=lambda r: r[1])
    idle = {}
    for g0, g1 in gaps:
        # the innermost phase open at the gap's start: the latest-starting one
        open_ = [h for h in spans if h[1] <= g0 < h[2]]
        name = open_[-1][0] if open_ else "outside any phase"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    idle_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(kernels=dev, busy_s=busy / 1e6, window_s=window_s,
                device_ops=[[n, v] for n, v in ops], idle_gaps=[[n, v] for n, v in idle_top])
