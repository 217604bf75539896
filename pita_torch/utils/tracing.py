"""Spans of the program: named host intervals inside the sampler's EM step
and the trainer's optimizer step, so that a profile of the card can say
which part of a step left it waiting.

``span(name, **attrs)`` marks a block (``with span("sampler.step", step=i):``);
``spans()`` returns the records, ``clear()`` drops them. The names and where
they sit: ``sampler.integrate`` (``integrate_sde``) over ``sampler.step``
(one EM step) over ``sampler.energy_grad``, ``sampler.score``,
``sampler.divergence``, ``sampler.weights``, ``sampler.update`` and
``sampler.resample``; ``train.step`` (``EnergyTempTrainer.train_step``) over
``train.batch``, ``train.losses``, ``train.backward``, ``train.optimizer``
and ``train.ema``. Below them, wherever they are called:
``divergence.exact_pass`` (one batched backward of
``ops/divergence.py:exact_divergence``, whose one forward a chain chunk lies
outside the passes, or one forward and VJP pass of
``exact_divergence_replicated``; attributes ``rows``, the R one-hot rows
times the B chains of the pass, and ``chains``, B) and ``dit.forward``
(``nets/dit.py:DiT3DBackbone.forward``; attribute ``rows``, its batch).

- **The gate.** A span records only while a ``torch.profiler`` session is
  active on this thread (``torch.autograd._profiler_enabled()``, the gate of
  torch's own data pipes and RPC). Otherwise ``span`` makes that one check
  and returns a shared no-op object: it allocates nothing and reads no clock.
  There is no other switch.
- **The clock.** A record's start and end are ``time.time_ns()`` (unix ns),
  the clock kineto stamps its events with, so the spans lie on the
  profiler's timeline as they are.
- **No device work.** A span launches nothing, records no CUDA event and
  never synchronises: a step's kernels are the same with spans on or off.

Records stay in memory until ``clear()``. Their readers: the benchmark's
per-layer metrics (``perfbench/spans.py`` and the ``step_ms.*``,
``step_p95_ms.*`` and ``idle_ms.*`` readers), which split the card's idle
time by the spans open across it, and ``trace_passes_per_step.aldp`` and
``dit_rows_per_step.aldp``, which count the last two names a step; and
``pita_torch/utils/debug.py:profile_trace``, which writes them into its
Chrome trace.
"""

import time
from typing import NamedTuple, Optional

from torch.autograd import _profiler_enabled


class Span(NamedTuple):
    name: str
    parent: Optional[int]  # index in spans() of the enclosing span; None for a root
    request: int  # shared by every span under one root
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    attrs: dict


_records = []  # [name, parent, request, start_ns, end_ns, attrs] lists, made Spans by spans()
_open = []  # indices into _records of the open spans, innermost last
_roots = 0  # roots recorded, the next root's request id


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "index")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _roots
        parent = _open[-1] if _open else None
        if parent is None:
            request, _roots = _roots, _roots + 1
        else:
            request = _records[parent][2]
        self.index = len(_records)
        _records.append([self.name, parent, request, time.time_ns(), None, self.attrs])
        _open.append(self.index)
        return None

    def __exit__(self, *exc):
        _records[self.index][4] = time.time_ns()
        _open.pop()
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` over its block while a
    profiler session is active, and does nothing otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _On(name, attrs)


def spans() -> list:
    """The records (``Span``), in order of start; a parent's index points
    into this list."""
    return [Span(*r) for r in _records]


def clear():
    """Drop every record. Call it with no span open."""
    global _roots
    _records.clear()
    _roots = 0
