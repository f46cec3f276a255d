"""What the attention metrics' readers and the variant driver share: the
attention kernels by name in the device trace, kernels' launches a step,
and the attention kernels' share of their bound.

``ctx["attn_calls"]`` holds the traced steps' attention kernel calls from
the configuration's shapes (``work/attention.py``: (kind, B, n, d_qk,
d_v)); ``ctx["trace"]["ops"]`` the traced device operations as (name,
start us, end us).
"""

from __future__ import annotations

import re

from portbench.readers import device_s
from portbench.work.attention import KINDS, attention_bound_s

# the kernels of ``csrc/spatial_attention{,_dkv,_dq}.cu``, bf16 and float32,
# one device kernel a wrapper's launch
ATTENTION = {"fwd": r"\b(attn_fwd_bf16|attn_fwd_f32)\b",
             "dkv": r"\b(attn_dkv_bf16|attn_dkv_f32)\b",
             "dq": r"\b(attn_dq_wgmma|attn_dq_f32)\b"}
KERNELS = "|".join(ATTENTION.values())


def launches(ctx: dict, patterns: dict) -> dict[str, float]:
    """Traced launches a step of each kernel in ``patterns``."""
    t = ctx["trace"]
    return {kind: sum(1 for name, _, _ in t["ops"] if re.search(rx, name)) / t["calls"]
            for kind, rx in patterns.items()}


def launches_by_name(ctx: dict, pattern: str) -> dict[str, float]:
    """Traced launches a step of each kernel name that ``pattern`` matches."""
    t, counts = ctx["trace"], {}
    for name, _, _ in t["ops"]:
        m = re.search(pattern, name)
        if m:
            counts[m.group(0)] = counts.get(m.group(0), 0) + 1
    return {k: v / t["calls"] for k, v in sorted(counts.items())}


def _launches_match(ctx: dict) -> bool:
    """The traced launches of each attention kernel are the calls
    ``attn_calls`` gives (a route that splits a call would make more)."""
    t = ctx["trace"]
    counts = {k: v * t["calls"] for k, v in launches(ctx, ATTENTION).items()}
    return all(counts[kind] == sum(1 for c in ctx["attn_calls"] if c[0] == kind)
               for kind in KINDS)


def attention_roofline(ctx: dict) -> float | None:
    """% of the attention kernels' bound (``attn_calls``) in the device time
    of the kernels ``KERNELS`` names; nothing without attention calls, or
    when the traced launches differ from them."""
    t = ctx.get("trace")
    if not t or not t["calls"] or not ctx.get("attn_calls") or not _launches_match(ctx):
        return None
    spent = device_s(ctx, KERNELS)
    if spent <= 0:
        return None
    return 100.0 * attention_bound_s(ctx["attn_calls"]) / spent


def attention_ms(ctx: dict) -> float | None:
    """Device ms a traced step in the attention kernels; nothing without
    them."""
    t = ctx.get("trace")
    if not t or not t["calls"]:
        return None
    spent = device_s(ctx, KERNELS)
    return spent / t["calls"] * 1e3 if spent > 0 else None
