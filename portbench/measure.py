"""What every driver shares: the window after set-up, the traced stretches,
the reference's numbers and the checks.

A driver builds the program's object on the seed's inputs, runs its
checked steps, and hands ``measure`` a ``call(i)`` that does one step or
one served batch of the window (continuing where set-up stopped), with the
model FLOPs and trunk conv calls of the step a call index makes.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import compare
from portbench.harness import GIB, closed_loop, percentile, profile_stretch, sync


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def measure(wl: dict, seconds: float, trace: bool, device, t_start: float, call, *,
            flops_of, trunk_of, marks: list) -> dict:
    """Set-up ends here (``setup_s``: process start to now, after a
    synchronise). Then the window: ``call`` in whole periods of
    ``wl["period"]`` until ``seconds`` pass; then, with ``trace``, the
    profiled stretches of ``wl["trace_calls"]`` calls (the device alone)
    and ``wl["trace_gap_calls"]`` calls (with the host's ops, for the idle
    gaps). ``flops_of(i)`` and ``trunk_of(i)`` give call i's model FLOPs
    and its trunk conv calls ((batch, kind) pairs). ``marks`` holds (what,
    time.time()) at the ends of set-up's parts; the rest up to here is
    the warm-up, and ``setup_split`` gives the seconds of each part."""
    sync(device)
    marks = marks + [("warm-up", time.time())]
    setup_s = marks[-1][1] - t_start
    split = [(name, t - prev) for (name, t), prev in zip(marks, [t_start] + [t for _, t in marks])]
    peak = memory_peak(device)
    reset_peak(device)
    loop = closed_loop(call, seconds, wl["period"], device)
    window_peak = memory_peak(device)
    n = loop["calls"]
    out = {
        "setup_s": setup_s,
        "setup_split": split,
        "calls": n,
        "window": {
            "calls": n, "seconds": loop["seconds"],
            "images": n * wl["batch"],
            "flops": sum(flops_of(i) for i in range(n)),
            "host_call_ms": [t * 1e3 for t in loop["host_s"]],
            "p95_ms": percentile(loop["intervals_ms"], 95),
        },
        "peak_mem_gib": window_peak / GIB,
    }
    ctx = {"window": out["window"], "batch": wl["batch"]}
    if trace:
        first = n
        n_t = wl["trace_calls"]
        t = profile_stretch(lambda: [call(first + i) for i in range(n_t)], device)
        t["calls"] = n_t
        t["flops"] = sum(flops_of(first + i) for i in range(n_t))
        t["trunk_calls"] = [c for i in range(n_t) for c in trunk_of(first + i)]
        first += n_t
        n_g = wl["trace_gap_calls"]
        gaps = profile_stretch(lambda: [call(first + i) for i in range(n_g)], device,
                               host_ops=True)
        t["idle_gaps"] = gaps["idle_gaps"]
        ctx["trace"] = t
    out["ctx"] = ctx
    out["memory_peak_bytes"] = max(peak, window_peak, memory_peak(device))
    return out


def free_memory(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


# the program runs under PyTorch's settings as a process starts with them
PROGRAM_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def full_precision() -> None:
    """float32 as stated, for the reference: no TF32 in matmuls or cuDNN
    convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def program_precision() -> None:
    """Back to the settings the program runs under."""
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = PROGRAM_TF32


# --------------------------------------------------------------------------- #
# the numbers a training step leaves

def first_grads(mus: dict, b1: float) -> dict:
    """{net: {leaf: norm of the first gradient}} from Adam's first moments
    after one step (mu = (1 - b1) g)."""
    return {net: {k: v / (1.0 - b1) for k, v in compare.norms(mu).items()}
            for net, mu in mus.items()}


def first_grad_tensors(mus: dict, b1: float) -> dict:
    """{net: {leaf: the first gradient}} from Adam's first moments after one
    step, copied."""
    return {net: {k: v / (1.0 - b1) for k, v in mu.items()} for net, mu in mus.items()}


def changes(params: dict, init: dict) -> dict:
    """{net: {leaf: norm of its change from ``init``}}."""
    return {net: compare.norms({k: v.detach() - init[net][k] for k, v in p.items()})
            for net, p in params.items()}


def checks(numbers: dict, limits: dict) -> list:
    """(name, value, limit, where) for each number the cell compares: those
    its workload gives a limit."""
    return [(name, v, limits[name], where) for name, (v, where) in numbers.items()
            if name in limits]
