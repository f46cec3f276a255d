"""``portbench/phases.py`` on synthetic events (each gap and device op put
down to the program span that caused it), its readers without their keys,
and ``run_phases.py``'s stretches in a CPU run of the CUT cell, with and
without the program's spans."""

from __future__ import annotations

import sys

import pytest
from torch.autograd import DeviceType

from portbench import harness, phases, run_phases

NEW = ("step_span_ms.train", "update_host_ms.train", "trunk_host_ms.train", "launches.train")


class Event:
    """The parts of a kineto event that ``kineto_spans_and_ops`` reads; a
    CUDA API call has a linked correlation id, the PyTorch op it
    runs in."""

    def __init__(self, name, start, end, kind, corr=0, linked=0):
        self._name, self._start, self._dur, self._kind = name, start, end - start, kind
        self._corr, self._linked = corr, linked

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return DeviceType.CUDA if self._kind == "device" else DeviceType.CPU

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


# a step [0, 1000) whose D step [100, 500) holds a trunk dx [200, 300)
# opened on the autograd engine's thread (no parent; placed by time)
SPANS = [("cut.step", 0, 1000), ("cut.d_step", 100, 500), ("trunk.dx", 200, 300)]


def test_a_gaps_midpoint_goes_to_the_innermost_span_on_any_thread():
    ops = [(0, 50, 10), (70, 210, 10), (290, 450, 10), (470, 480, 10), (700, 900, 10)]
    out = phases.split(SPANS, ops)
    # gaps: 50-70 (mid 60, the step), 210-290 (mid 250, the dx),
    # 450-470 (mid 460, the D step), 480-700 (mid 590, the step)
    assert out["idle"] == pytest.approx({"cut.step": 240e-9, "trunk.dx": 80e-9,
                                         "cut.d_step": 20e-9})


def test_nested_spans_starting_together_the_shorter_is_inner():
    points, owners = phases.timeline([("a", 0, 100), ("b", 0, 40), ("empty", 50, 50)])
    assert [phases.owner(points, owners, t) for t in (10, 45, 50, 99, 100, -1)] == [
        "b", "a", "a", "a", phases.OUTSIDE, phases.OUTSIDE]


def test_a_device_op_goes_to_the_span_holding_its_launch_by_correlation_id():
    events = [Event(n, a, b, "host", corr=50 + i) for i, (n, a, b) in enumerate(SPANS)]
    events += [
        Event("aten::mul", 110, 130, "host", corr=7),
        # a PyTorch op whose correlation id equals the launch's CUPTI id:
        # the runtime call must win
        Event("aten::add", 900, 950, "host", corr=1),
        Event("cudaLaunchKernel", 120, 125, "host", corr=1, linked=7),
        Event("cuLaunchKernelEx", 250, 255, "host", corr=2, linked=52),
        Event("mul_kernel", 600, 640, "device", corr=1, linked=7),       # launched at 120
        Event("dx_main_wgmma", 640, 700, "device", corr=2, linked=52),   # launched at 250
        # no runtime call recorded: the linked PyTorch op's start (110)
        Event("Memcpy DtoD", 700, 710, "device", corr=3, linked=7),
        # launched by nothing in the trace
        Event("Memset", 710, 711, "device", corr=4),
        # a span's shadow on the device's timeline: not an op
        Event("cut.d_step", 600, 700, "device", corr=5, linked=51),
    ]
    spans, ops = phases.kineto_spans_and_ops(events, {"cut.step", "cut.d_step", "trunk.dx"})
    assert sorted(spans) == sorted(SPANS)
    assert sorted(ops) == [(600, 640, 120), (640, 700, 250), (700, 710, 110), (710, 711, None)]
    out = phases.split(spans, ops)
    assert out["ops"] == {"cut.d_step": 2, "trunk.dx": 1, phases.OUTSIDE: 1}
    assert out["device"] == pytest.approx({"cut.d_step": 50e-9, "trunk.dx": 60e-9,
                                           phases.OUTSIDE: 1e-9})
    assert (out["roots"], out["root_ops"]) == (1, 3)


def test_what_lies_in_no_span_goes_outside_the_step():
    ops = [(1000, 1100, 1050), (1300, 1400, 1200), (1500, 1600, -5)]
    out = phases.split(SPANS, ops)
    assert out["idle"] == pytest.approx({phases.OUTSIDE: 300e-9})
    assert out["ops"] == {phases.OUTSIDE: 3} and out["root_ops"] == 0


def test_host_ms_total_and_self_and_the_span_readers():
    ms = 1_000_000
    spans = [("cut.step", 1, None, 9, 0, 0, 10 * ms), ("cut.d_step", 2, 1, 9, 0, ms, 5 * ms),
             ("optim.adam", 3, 2, 9, 0, 2 * ms, 3 * ms), ("trunk.dx", 4, None, 8, 0, ms, 2 * ms),
             ("cut.step", 5, None, 9, 1, 20 * ms, 24 * ms), ("ema.update", 6, 5, 9, 1, 21 * ms,
                                                              22 * ms)]
    assert phases.durations_ms(spans) == {"cut.step": (14.0, 9.0), "cut.d_step": (4.0, 3.0),
                                          "optim.adam": (1.0, 1.0), "trunk.dx": (1.0, 1.0),
                                          "ema.update": (1.0, 1.0)}
    ctx = {"spans": spans, "phases": {"roots": 2, "root_ops": 7000}}
    cell = harness.load_cell("cut_flagship.train_warmup_b12")
    read = {m: harness.metric_reader(cell, m).read(ctx) for m in NEW}
    assert read == {"step_span_ms.train": 7.0, "update_host_ms.train": 1.0,
                    "trunk_host_ms.train": 0.5, "launches.train": 3500.0}


@pytest.mark.parametrize("ctx", [{}, {"window": {"calls": 3, "seconds": 1.0},
                                      "trace": {"calls": 2, "ops": []}},
                                 {"spans": [], "phases": {"roots": 0, "root_ops": 0}}])
def test_the_readers_return_none_without_their_keys(ctx):
    cell = harness.load_cell("cut_flagship.train_warmup_b12")
    assert all(harness.metric_reader(cell, m).read(ctx) is None for m in NEW)


def _tiny_cut():
    cell = harness.load_cell("cut_flagship.train_warmup_b12")
    cfg = cell["config"]["train"]
    cfg["image_size"] = 32
    cfg["model"]["generator"]["ngf"] = 8
    cfg["model"]["discriminator"]["ndf"] = 8
    cfg["patchnce"]["num_patches"] = 16
    cfg["runtime"]["precision"] = "fp32"
    cell["workload"].update(batch=2, ring=3, trace_calls=3, trace_gap_calls=2)
    return cell


@pytest.mark.parametrize("program_spans", [True, False])
def test_a_cpu_run_with_the_stretches(monkeypatch, program_spans):
    """The stretches follow the harness's on the same calls; without the
    program's spans (a program that predates them) they give nothing and
    the run's line lacks their metrics."""
    if not program_spans:
        # as in a checkout whose program has no span module
        monkeypatch.setitem(sys.modules, phases.TRACE_MODULE, None)
        assert phases.program_trace() is None
    cell = _tiny_cut()
    result, ctx = run_phases.run_cell(cell, 2 ** 31 + 3, 0.2, "cpu", 0.0)
    assert result["correct"] and result["breakdown"]["idle_gaps"] == []
    added = set(result["metrics"]) - {m["name"] for m in cell["per_layer"]}
    if not program_spans:
        assert not added and "idle_phases" not in result["breakdown"]
        assert "spans" not in ctx and "phases" not in ctx
        return
    assert added == set(NEW)
    roots = [s for s in ctx["spans"] if s[0] == "cut.step"]
    assert len(roots) == 3 and ctx["phases"]["roots"] == 2
    # the window's calls, the harness's stretches (3 + 2), 3 with the spans
    # off, then these
    first = ctx["window"]["calls"] + 8
    assert len(ctx["host_ms_off"]) == len(ctx["host_ms_on"]) == 3
    steps = [s[4] for s in roots]
    assert steps == list(range(steps[0], steps[0] + 3)) and steps[0] > first
    assert ctx["counts"] == {}          # no kernel runs on the CPU
    assert ctx["trunk_kinds"] == {"fwd": 3 * 54, "dx": 3 * 54, "dw": 3 * 54}
    assert result["metrics"]["launches.train"]["value"] == 0.0
    assert result["metrics"]["step_span_ms.train"]["value"] > 0
    assert any(row.startswith("cut.g_head | ") for row in run_phases.phase_table(ctx))
    assert [n.split()[0] for n in run_phases.notes(ctx)] == [
        "idle_in_spans", "trunk_counts", "on_cost", "on_cost"]
