"""The port's spans and counters.

``span(name)`` marks a stretch of host time in the program's own files: the
train steps' phases, the optimizer's updates, the trunk kernels' wrappers
(``trunk.fwd``, ``trunk.dx``, ``trunk.dw``), the attention kernels' wrappers
(``attn.fwd``, ``attn.dkv``, ``attn.dq``, around the plain versions too on
the CPU) and the variant generator's blocks (``variant.attn``,
``variant.channel``, ``variant.style``).
Spans are off by default, and then ``span`` returns one shared no-op
context: a flag read, no allocation, no clock read, nothing on the device.
``enable()`` turns them on: each span closed appends a ``Span`` to an
in-memory list that ``take()`` returns and clears. Times are
``time.time_ns()``, the epoch clock that ``torch.profiler``'s kineto events
are stamped in; ``enable(profiler=True)`` also opens
``torch.profiler.record_function(name)`` for each span, so that a span is
an event in the device trace's own timeline.

A span's parent is the innermost span open on the same thread. The autograd
engine runs CUDA backward nodes on a thread of its own, so a span opened
there (a trunk ``dx``) has no parent: readers place it by time. A span
opened with ``step=`` (a train step's root) sets the step id that every
span closed until it ends carries, on any thread.

``count(name, n)`` adds to ``COUNTS``; counters are always on: the kernels'
launches by route, counted on the host as each wrapper launches
(``trunk.fwd.<route>``, ``trunk.dx.<route>``, ``trunk.dw.<route>``,
``trunk.dw.db`` (a ``dw`` launch that also sums the bias gradient),
``attn.fwd.<route>``, ``attn.dkv``, ``attn.dq``; a CUDA-graph replay
counts none), and how each CUT step ran (``cut.graph.eager``,
``cut.graph.capture``, ``cut.graph.replay``: ``train/cut_trainer.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None
    thread: int
    step: int | None
    start_ns: int
    end_ns: int


COUNTS: dict[str, int] = {}
_COUNT_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()
_ON = False
_PROFILER = False
_SPANS: list[Span] = []
_IDS = itertools.count(1)
_STACKS = threading.local()
_STEP: int | None = None


class _Open:
    __slots__ = ("name", "step", "id", "parent", "start", "annotation")

    def __init__(self, name: str, step: int | None):
        self.name, self.step = name, step

    def __enter__(self):
        global _STEP
        stack = _STACKS.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        if self.step is not None:
            _STEP = self.step
        self.annotation = None
        if _PROFILER:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _STEP
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _STACKS.stack.pop()
        _SPANS.append(Span(self.name, self.id, self.parent, threading.get_ident(), _STEP,
                           self.start, end))
        if self.step is not None:
            _STEP = None
        return False


def span(name: str, step: int | None = None):
    """A context that records ``name``'s stretch when spans are on; ``step``
    (a train step's index) is given by the step's root span."""
    if not _ON:
        return _OFF
    return _Open(name, step)


def count(name: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        COUNTS[name] = COUNTS.get(name, 0) + n


def enable(profiler: bool = False) -> None:
    """Record spans from now on; with ``profiler``, each also as a
    ``torch.profiler.record_function`` range."""
    global _ON, _PROFILER
    _ON, _PROFILER = True, profiler


def disable() -> None:
    global _ON, _PROFILER
    _ON = _PROFILER = False


def take() -> list[Span]:
    """The spans closed since the last ``take``, in the order they closed;
    clears them."""
    out = _SPANS[:]
    del _SPANS[:len(out)]
    return out
