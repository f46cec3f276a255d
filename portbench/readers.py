"""What the per-layer metrics' readers share: shares of the traced
stretch and of the window, and device time by kernel name.

A reader's ``ctx`` holds ``window`` (calls, seconds, images, model FLOPs,
each call's host ms), ``trace`` (the profiled stretch's device operations
as (name, start us, end us), ``busy_s``, ``window_s``, its calls and their
trunk conv calls) and ``trunk_geom`` (image size, ngf, downsamplings).
"""

from __future__ import annotations

import re
import statistics

from portbench.work import flops


def idle_share(ctx: dict) -> float | None:
    """% of the untraced window in which no operation ran on the device:
    1 - (the device's busy seconds a call in the traced stretch, the union
    of its operations' intervals) x (the window's calls) / (the window's
    seconds). The stretch itself runs slower on a host-bound cell (the
    tracer's cost on each launch), so its own idle share reads high; the
    device's busy time a call does not move with it."""
    t, w = ctx.get("trace"), ctx["window"]
    if not t or not t["calls"] or not w["calls"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["calls"] * w["calls"] / w["seconds"])


def mfu(ctx: dict) -> float | None:
    """% of the card's bf16 peak that the window's model FLOPs make."""
    w = ctx["window"]
    return 100.0 * w["flops"] / w["seconds"] / flops.PEAK_BF16_FLOPS if w["calls"] else None


def host_call_ms(ctx: dict) -> float | None:
    """The median host time of one call into the program (its return)."""
    calls = ctx["window"]["host_call_ms"]
    return statistics.median(calls) if calls else None


def device_s(ctx: dict, pattern: str) -> float:
    """Device seconds of the traced operations whose name ``pattern``
    matches (``re.search``)."""
    rx = re.compile(pattern)
    return sum(b - a for name, a, b in ctx["trace"]["ops"] if rx.search(name)) / 1e6


def ms_per_call(ctx: dict, pattern: str) -> float | None:
    t = ctx.get("trace")
    if not t or not t["calls"]:
        return None
    return device_s(ctx, pattern) / t["calls"] * 1e3


def trunk_roofline(ctx: dict, pattern: str) -> float | None:
    """% of the trunk convs' bound (from the traced calls' shapes) in the
    device time of the kernels ``pattern`` names; nothing without them."""
    t = ctx.get("trace")
    if not t or not t["trunk_calls"]:
        return None
    spent = device_s(ctx, pattern)
    if spent <= 0:
        return None
    return 100.0 * flops.trunk_bound_s(t["trunk_calls"], *ctx["trunk_geom"]) / spent
