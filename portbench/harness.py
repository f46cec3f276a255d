"""The benchmark's machinery: finding a cell's files by name, the closed
loop and its clocks, the profiled stretch, and the result line.

A cell is ``workloads/<name>.json``: its ``config`` (``configs/<config>.json``),
its ``driver`` (``drivers/<driver>.py``, which drives one entry point of the
program) and that driver's traffic parameters. A per-layer metric is
``metrics/<name>.py`` with ``read(ctx)``. ``BENCHMARK.json`` says which
metrics each cell reports; nothing here names a cell or a metric.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GIB = 2 ** 30
# modules that may not be loaded by the time a run prints its result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gan_variant_research_tpu")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux's
    /proc/self/stat, to the kernel's clock tick), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules(modules) -> list[str]:
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


# --------------------------------------------------------------------------- #
# the cell's files

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its workload, configuration, BENCHMARK.json
    entries and metrics: {"name", "workload", "config", "entry",
    "end_to_end", "per_layer"}. Raises when any piece is missing."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    workload = load_json(root / "portbench" / "workloads" / f"{name}.json")
    config = load_json(root / "portbench" / "configs" / f"{entry['config']}.json")
    applies = lambda m: name in m.get("workloads", [name])  # noqa: E731
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"name": name, "workload": workload, "config": config, "entry": entry,
            "end_to_end": e2e, "per_layer": per_layer, "root": root}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(cell: dict):
    name = cell["workload"]["driver"]
    return load_module(cell["root"] / "portbench" / "drivers" / f"{name}.py",
                       f"portbench_driver_{name}")


def metric_reader(cell: dict, metric: str):
    return load_module(cell["root"] / "portbench" / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_"))


# --------------------------------------------------------------------------- #
# clocks

def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StepClock:
    """A mark after each step: a CUDA event on the card (no synchronise),
    the host clock after a synchronise elsewhere. ``intervals_ms`` gives the
    times between consecutive marks, the first from ``start``."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self):
        self.marks = [self._mark()]

    def mark(self):
        self.marks.append(self._mark())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def closed_loop(call, seconds: float, period: int, device) -> dict:
    """Run ``call(i)`` (i counting from 0) in whole periods of ``period``
    calls until ``seconds`` have passed, then synchronise. Returns the
    calls made, the window's host seconds (from a synchronise before the
    first call to the one after the last), each call's host time (its
    return) and the intervals between the calls' completion on the device."""
    clock = StepClock(device)
    host = []
    sync(device)
    t0 = time.perf_counter()
    clock.start()
    n = 0
    while True:
        for _ in range(period):
            h = time.perf_counter()
            call(n)
            host.append(time.perf_counter() - h)
            clock.mark()
            n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    return {"calls": n, "seconds": elapsed, "host_s": host, "intervals_ms": clock.intervals_ms()}


# --------------------------------------------------------------------------- #
# the profiled stretch

def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _span_us(e) -> tuple[float, float]:
    """A kineto event's (start, end) in us."""
    start = e.start_ns() / 1e3
    return start, start + e.duration_ns() / 1e3


def profile_stretch(run, device, host_ops: bool = False) -> dict:
    """Run ``run()`` under ``torch.profiler`` (the device's activity, and the
    host's ops with ``host_ops``). Returns the device operations as (name,
    start us, end us), the union of their intervals in seconds (``busy_s``),
    the stretch's host seconds (``window_s``), and with ``host_ops`` the
    idle gaps' seconds by the innermost host op running in each gap's
    middle. Events are read from the profiler's kineto results, without
    building its event tree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    acts = ([ProfilerActivity.CUDA] if on_card else []) + (
        [ProfilerActivity.CPU] if host_ops or not on_card else [])
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync(device)
        window = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    ops = [(e.name(), *_span_us(e)) for e in events if e.device_type() == DeviceType.CUDA]
    merged = _union((a, b) for _, a, b in ops)
    out = {"ops": ops, "busy_s": sum(b - a for a, b in merged) / 1e6, "window_s": window}
    if host_ops:
        cpu = sorted((*_span_us(e), e.name()) for e in events
                     if e.device_type() == DeviceType.CPU)
        starts = [c[0] for c in cpu]
        gaps = {}
        for (_, end), (start, _) in zip(merged, merged[1:]):
            mid = (end + start) / 2
            # the covering event that started last is the innermost
            i = bisect.bisect_right(starts, mid) - 1
            low = max(i - 2000, -1)
            while i > low and cpu[i][1] < mid:
                i -= 1
            name = cpu[i][2] if i > low else "(host python)"
            gaps[name] = gaps.get(name, 0.0) + (start - end) / 1e6
        out["idle_gaps"] = gaps
    return out


def top(sums: dict, n: int = 10) -> list:
    return [[k[:120], v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def op_seconds(ops) -> dict:
    sums = {}
    for name, a, b in ops:
        sums[name] = sums.get(name, 0.0) + (b - a) / 1e6
    return sums


# --------------------------------------------------------------------------- #
# the result

def device_info(device, count: int, memory_peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(memory_peak)}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run of ``cell``: the driver's set-up, window, traced stretch (with
    ``trace``) and check. Returns the result line's object."""
    out = driver(cell).run(cell, seed, seconds, trace, device,
                           t_start if t_start is not None else process_start())
    if trace:
        ctx = out["ctx"]
        metrics = {}
        for m in cell["per_layer"]:
            value = metric_reader(cell, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = device_info(device, cell["entry"]["chips"], out["memory_peak_bytes"])
    result = {"correct": bool(out["checks"]) and all(v <= lim for _, v, lim, _ in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        t = out["ctx"]["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {"device_ops": top(op_seconds(t["ops"])),
                               "idle_gaps": top(t.get("idle_gaps", {}))}
    result["setup_split"] = out["setup_split"]
    result["checks"] = {name: {"value": v, "limit": lim, "at": where}
                        for name, v, lim, where in out["checks"]}
    return result
