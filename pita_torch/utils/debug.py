"""Profiling and numerics-debugging hooks.

Counterpart of ``pita_tpu/utils/debug.py`` (the reference's Lightning
profiler configs and ``detect_anomaly``, configs/debug/default.yaml:30):

- ``profile_trace``: a ``torch.profiler`` trace of the block, written to a
  directory as a Chrome trace (open it in Perfetto or chrome://tracing),
  with the program's spans (``pita_torch/utils/tracing.py``: the sampler's
  EM steps, the trainer's optimizer steps and their parts) on a track of
  their own on the trace's clock;
- ``detect_anomaly``: autograd's anomaly mode, which raises when a backward
  pass makes a NaN, and a check of every torch function's result in the
  block, which raises ``FloatingPointError`` on a NaN (and with ``infs`` an
  Inf), as ``jax_debug_nans`` and ``jax_debug_infs`` do.
"""

import contextlib
import json
import os
import time

import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

from pita_torch.utils import tracing


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block (CPU, and CUDA when there is a GPU); on exit write
    ``<log_dir>/trace_<pid>_<ns>.json`` with the spans the block recorded,
    then clear the span records. Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(tracing.spans())
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, tracing.spans()[first:])
    tracing.clear()


def _add_spans(path, records):
    """Write ``records`` into the Chrome trace at ``path`` as complete events
    on a track of their own. Its timestamps are µs after the trace's
    ``baseTimeNanoseconds`` on the unix clock, the spans' clock."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    trace["traceEvents"] += [
        {"ph": "X", "cat": "program_span", "name": r.name, "pid": os.getpid(),
         "tid": "program spans", "ts": (r.start_ns - base) / 1e3,
         "dur": (r.end_ns - r.start_ns) / 1e3, "args": dict(r.attrs, request=r.request)}
        for r in records if r.end_ns is not None]
    with open(path, "w") as f:
        json.dump(trace, f, default=repr)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class _NonFiniteCheck(TorchFunctionMode):
    """Raises when a torch function returns a floating tensor with a NaN
    (or, with ``infs``, an Inf)."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if not t.is_floating_point():
                continue
            name = getattr(func, "__name__", str(func))
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {name}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf produced by {name}")
        return out


@contextlib.contextmanager
def detect_anomaly(nans: bool = True, infs: bool = False):
    """Raise on a NaN (and with ``infs`` an Inf) made in the block, in a
    forward result or in a backward pass. Every result is checked, so each
    op waits for the device: for debugging only."""
    with torch.autograd.set_detect_anomaly(True), _NonFiniteCheck(nans, infs):
        yield
