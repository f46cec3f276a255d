"""The program's own spans in a traced run: two stretches of whole calls
after the harness's, and the pure functions that read them.

- The span stretch: ``trace_calls`` calls with the program's spans on
  (``gan_variant_research_tpu_torch/core/trace.py``) and no profiler. It
  gives ``spans`` (each (name, id, parent, thread, step, start ns, end ns))
  and ``counts`` (the change of the program's launch counters).
- The phase stretch: ``trace_gap_calls`` calls with each span also a
  ``record_function`` range, under CPU + CUDA profiling. It gives
  ``phases``: for each span name, the device's idle seconds whose gap's
  midpoint falls in that span (innermost: of the spans open there, on any
  thread, the one that started last), and the device seconds and count of
  the kernels, copies and sets whose launching call falls in it; what lies
  in no span goes under ``OUTSIDE``. Also the root spans (``ROOTS``) and
  the operations launched inside one.

A program without ``core/trace.py`` gives neither: the stretches return
nothing, and the readers of their keys return ``None``.
"""

from __future__ import annotations

import bisect
import importlib
import statistics
import time

import torch

from portbench.harness import _union, sync

TRACE_MODULE = "gan_variant_research_tpu_torch.core.trace"
ROOTS = ("cut.step", "cyclegan.step")
UPDATES = ("optim.clip", "optim.adam", "ema.update")
OUTSIDE = "(outside the step)"


def program_trace():
    """The program's span module, or ``None`` for a program without one."""
    try:
        return importlib.import_module(TRACE_MODULE)
    except ModuleNotFoundError as e:
        if e.name != TRACE_MODULE:
            raise
        return None


# --------------------------------------------------------------------------- #
# the stretches

def span_stretch(call, first: int, n: int) -> dict:
    """``call(first)`` .. ``call(first + n - 1)`` with the program's spans
    on: {"spans", "counts"}, or {} without spans in the program."""
    trace = program_trace()
    if trace is None:
        return {}
    before = dict(trace.COUNTS)
    trace.take()
    trace.enable()
    try:
        for i in range(n):
            call(first + i)
    finally:
        trace.disable()
    spans = [tuple(s) for s in trace.take()]
    counts = {k: v - before.get(k, 0) for k, v in trace.COUNTS.items() if v != before.get(k, 0)}
    return {"spans": spans, "counts": counts}


def phase_stretch(call, first: int, n: int, device) -> dict:
    """``call(first)`` .. ``call(first + n - 1)`` with the spans as
    ``record_function`` ranges under the profiler (CPU and CUDA):
    {"phases"}, or {} without spans in the program."""
    from torch.profiler import ProfilerActivity, profile

    trace = program_trace()
    if trace is None:
        return {}
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    sync(device)
    trace.take()
    trace.enable(profiler=True)
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                call(first + i)
            sync(device)
            window = time.perf_counter() - t0
    finally:
        trace.disable()
    names = {s.name for s in trace.take()}
    spans, ops = kineto_spans_and_ops(prof.profiler.kineto_results.events(), names)
    out = split(spans, ops)
    out["window_s"] = window
    return {"phases": out}


def stretches(call, first: int, wl: dict, device) -> dict:
    """The span stretch, then the phase stretch, from call ``first`` on:
    the ctx keys they give."""
    ctx = span_stretch(call, first, wl["trace_calls"])
    ctx.update(phase_stretch(call, first + wl["trace_calls"], wl["trace_gap_calls"], device))
    return ctx


# --------------------------------------------------------------------------- #
# pure functions of the events

def kineto_spans_and_ops(events, names) -> tuple[list, list]:
    """From torch.profiler's kineto events: the program's spans, the host
    events named in ``names`` (its ``record_function`` ranges), as (name,
    start ns, end ns); and the device's kernels, copies and sets as (start
    ns, end ns, launch ns), where launch is the start of the CUDA API call
    (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...) with the op's
    correlation id, else of the PyTorch op its linked correlation id names
    (``None`` where neither is found). As torch.profiler reads them, a host
    event with a linked correlation id is a CUDA API call, and one without
    is a PyTorch op or range; a device event named as a span is the range's
    shadow on the device's timeline, not an op."""
    from torch.autograd import DeviceType

    spans, device, launchers, frontend = [], [], {}, {}
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() > 0:
                launchers[e.correlation_id()] = e.start_ns()
            else:
                frontend[e.correlation_id()] = e.start_ns()
                if e.name() in names:
                    spans.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() not in names:
            device.append(e)
    ops = []
    for e in device:
        launch = launchers.get(e.correlation_id(), frontend.get(e.linked_correlation_id()))
        ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), launch))
    return spans, ops


def timeline(spans) -> tuple[list, list]:
    """(points, owners) for spans given as (name, start, end): over
    [points[i], points[i + 1]) the innermost span open is ``owners[i]``,
    the one that started last (of two that started together, the one that
    ends first), on whatever thread; ``None`` where no span is open."""
    spans = [s for s in spans if s[1] < s[2]]
    points = sorted({t for _, a, b in spans for t in (a, b)})
    at = {t: i for i, t in enumerate(points)}
    opening, closing = [[] for _ in points], [[] for _ in points]
    for k, (_, a, b) in enumerate(spans):
        opening[at[a]].append(k)
        closing[at[b]].append(k)
    active, owners = set(), []
    for i in range(len(points)):
        active.difference_update(closing[i])
        active.update(opening[i])
        inner = max(active, key=lambda k: (spans[k][1], -spans[k][2]), default=None)
        owners.append(None if inner is None else spans[inner][0])
    return points, owners


def owner(points: list, owners: list, t) -> str:
    """The innermost span open at ``t``, else ``OUTSIDE``."""
    if t is None:
        return OUTSIDE
    i = bisect.bisect_right(points, t) - 1
    name = owners[i] if i >= 0 else None
    return OUTSIDE if name is None else name


def split(spans, ops) -> dict:
    """Each device gap's seconds under the span holding its midpoint
    (``idle``), each op's seconds and count under the span holding its
    launch (``device``, ``ops``); spans as (name, start ns, end ns), ops as
    (start ns, end ns, launch ns). Also the root spans' count (``roots``)
    and the ops launched inside one (``root_ops``)."""
    points, owners = timeline(spans)
    idle, device, count = {}, {}, {}
    merged = _union((a, b) for a, b, _ in ops)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        name = owner(points, owners, (end + start) / 2)
        idle[name] = idle.get(name, 0.0) + (start - end) / 1e9
    roots = sorted((a, b) for name, a, b in spans if name in ROOTS)
    root_ops = 0
    for a, b, launch in ops:
        name = owner(points, owners, launch)
        device[name] = device.get(name, 0.0) + (b - a) / 1e9
        count[name] = count.get(name, 0) + 1
        if launch is not None:
            i = bisect.bisect_right(roots, (launch, float("inf"))) - 1
            root_ops += i >= 0 and launch <= roots[i][1]
    return {"idle": idle, "device": device, "ops": count, "roots": len(roots),
            "root_ops": root_ops}


def durations_ms(spans) -> dict:
    """{name: (total ms, self ms)} summed over the span stretch's spans,
    given as (name, id, parent, thread, step, start ns, end ns); self leaves
    out the children (same thread) that the span holds."""
    total, inner = {}, {}
    by_id = {s[1]: s for s in spans}
    for name, _, parent, _, _, a, b in spans:
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
        if parent in by_id:
            p = by_id[parent][0]
            inner[p] = inner.get(p, 0.0) + (b - a) / 1e6
    return {k: (v, v - inner.get(k, 0.0)) for k, v in total.items()}


# --------------------------------------------------------------------------- #
# what the readers share

def root_spans_ms(ctx: dict) -> list[float]:
    return [(s[6] - s[5]) / 1e6 for s in ctx.get("spans", ()) if s[0] in ROOTS]


def step_span_ms(ctx: dict) -> float | None:
    """The median host time of one step, from the program's root span."""
    roots = root_spans_ms(ctx)
    return statistics.median(roots) if roots else None


def host_ms_per_step(ctx: dict, match) -> float | None:
    """The summed host ms of the spans whose name ``match`` accepts, over the
    root spans of the span stretch."""
    roots = root_spans_ms(ctx)
    if not roots:
        return None
    return sum((s[6] - s[5]) / 1e6 for s in ctx["spans"] if match(s[0])) / len(roots)


def launches_per_step(ctx: dict) -> float | None:
    """Device ops launched inside a root span of the phase stretch, per
    root span."""
    p = ctx.get("phases")
    if not p or not p["roots"]:
        return None
    return p["root_ops"] / p["roots"]
