"""Run one cell as ``portbench/run.py --trace 1`` does, then the program's
span and phase stretches (``portbench/phases.py``); print the result line
with the metrics they feed and ``breakdown.idle_phases``, and on standard
error a table of the step's phases.

    python3 portbench/run_phases.py --workload <name> --seed <n> --seconds <s>

From the root of a checkout, on the card; the run is always traced
(``--trace`` is taken and ignored). Until ``portbench/measure.py`` runs
the two stretches itself, this wraps its ``measure`` for the run: the
window and the traced stretches as ``run.py`` makes them, then the two
more on the same ``call``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parents[1]
# the metrics the two stretches feed, with their units
METRICS = {"step_span_ms.train": "ms", "update_host_ms.train": "ms",
           "trunk_host_ms.train": "ms", "launches.train": "ops"}


def timed(call, host_ms: list):
    """``call`` that appends each call's host ms to ``host_ms``."""
    def run(i):
        t = time.perf_counter()
        call(i)
        host_ms.append((time.perf_counter() - t) * 1e3)
    return run


@contextlib.contextmanager
def stretches_after_measure(stash: dict):
    """While open, ``measure.measure`` runs, after its own stretches (with
    ``trace``), ``trace_calls`` calls with the spans off and then the span
    and phase stretches, and leaves its ctx in ``stash``, with each call's
    host ms in the spans-off and span stretches (``host_ms_off``,
    ``host_ms_on``: the spans' on-cost, both after the profiled stretches)
    and the span stretch's trunk conv calls by kind (``trunk_kinds``)."""
    from portbench import measure, phases

    inner = measure.measure

    def measure_and_stretches(wl, seconds, trace, device, t_start, call, **kw):
        out = inner(wl, seconds, trace, device, t_start, call, **kw)
        if trace:
            n = wl["trace_calls"]
            first = out["calls"] + n + wl["trace_gap_calls"]
            off, on = [], []
            for i in range(n):
                timed(call, off)(first + i)
            first += n
            ctx = out["ctx"]
            ctx.update(phases.stretches(timed(call, on), first, wl, device))
            ctx["host_ms_off"], ctx["host_ms_on"] = off, on[:n]
            ctx["trunk_kinds"] = dict(collections.Counter(
                kind for i in range(n) for _, kind in kw["trunk_of"](first + i)))
            stash["ctx"] = ctx
        return out

    measure.measure = measure_and_stretches
    try:
        yield
    finally:
        measure.measure = inner


def run_cell(cell: dict, seed: int, seconds: float, device="cuda",
             t_start: float | None = None) -> tuple[dict, dict]:
    """A ``--trace 1`` run of ``cell`` with the two stretches: (the result
    line's object with the new metrics and ``breakdown.idle_phases``, the
    readers' ctx)."""
    from portbench import harness

    stash = {}
    with stretches_after_measure(stash):
        result = harness.run_cell(cell, seed, seconds, True, device, t_start)
    ctx = stash.get("ctx", {})
    for name, unit in METRICS.items():
        value = harness.metric_reader(cell, name).read(ctx)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": unit}
    if "phases" in ctx:
        result["breakdown"]["idle_phases"] = harness.top(ctx["phases"]["idle"])
    return result, ctx


def phase_table(ctx: dict) -> list[str]:
    """Per root span: each span name's host ms (total, self; the span
    stretch) and device ms, idle ms and launches (the phase stretch)."""
    from portbench import phases

    host = phases.durations_ms(ctx.get("spans", []))
    steps = len(phases.root_spans_ms(ctx)) or 1
    p = ctx.get("phases") or {"idle": {}, "device": {}, "ops": {}, "roots": 0}
    per = p["roots"] or 1
    names = sorted(set(host) | set(p["idle"]) | set(p["ops"]),
                   key=lambda k: -host.get(k, (0.0, 0.0))[0])
    rows = ["phase | host ms | self ms | device ms | idle ms | launches"]
    for k in names:
        total, own = host.get(k, (0.0, 0.0))
        rows.append(f"{k} | {total / steps:.3f} | {own / steps:.3f} | "
                    f"{p['device'].get(k, 0.0) * 1e3 / per:.3f} | "
                    f"{p['idle'].get(k, 0.0) * 1e3 / per:.3f} | {p['ops'].get(k, 0) / per:.1f}")
    return rows


def notes(ctx: dict) -> list[str]:
    """What the stretches say beside the metrics: the idle share inside the
    program's spans, the trunk counters against the shapes' call count, and
    the spans' on-cost (root span against the window's host time a call,
    and a call's host time with spans on against spans off)."""
    from portbench import phases, readers

    out = []
    p = ctx.get("phases")
    if p:
        idle = sum(p["idle"].values())
        inside = 1.0 - p["idle"].get(phases.OUTSIDE, 0.0) / idle if idle else 1.0
        out.append(f"idle_in_spans {inside:.4f} of {idle:.6f} s over {p['roots']} steps "
                   f"(stretch {p['window_s']:.3f} s)")
    counts = ctx.get("counts")
    if counts is not None:
        got = {kind: counts.get(f"trunk.{kind}.bf16_wgmma", 0) for kind in ctx["trunk_kinds"]}
        out.append(f"trunk_counts {json.dumps(got, sort_keys=True)} shapes "
                   f"{json.dumps(ctx['trunk_kinds'], sort_keys=True)} "
                   f"equal {got == ctx['trunk_kinds']}; all {json.dumps(counts, sort_keys=True)}")
    span_ms, host = phases.step_span_ms(ctx), readers.host_call_ms(ctx)
    if span_ms is not None and host:
        out.append(f"on_cost root span median {span_ms:.3f} ms, window host call median "
                   f"{host:.3f} ms, ratio {span_ms / host:.4f}")
    if ctx.get("host_ms_on") and ctx.get("host_ms_off"):
        on, off = (statistics.median(ctx[k]) for k in ("host_ms_on", "host_ms_off"))
        out.append(f"on_cost host call median, spans on {on:.3f} ms, off {off:.3f} ms "
                   f"(both after the profiled stretches), ratio {on / off:.4f}")
    return out


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from portbench import harness, run

    args = run.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    t_start = min(harness.process_start(), T_IMPORT)
    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("run_phases: the cell needs a CUDA device", file=sys.stderr)
        return 2
    result, ctx = run_cell(cell, args.seed, args.seconds, "cuda", t_start)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"run_phases: modules that must not load were loaded: {loaded}", file=sys.stderr)
        return 3
    result.pop("setup_split")
    for line in phase_table(ctx) + notes(ctx):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
