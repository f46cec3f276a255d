"""The attention kernels' work and bounds, and the variant blocks' model FLOPs.

The benchmark's own arithmetic from shapes; nothing here reads the
program. One call of the core at (B, n, d_qk, d_v) in bf16, each byte
read or written once (q, k of d_qk columns; v, o, do of d_v; dq, dk of
d_qk; dv of d_v; the float32 row statistics ``lse`` and ``di``):

- forward ``softmax(q k^T) v``: 2 B n^2 (d_qk + d_v) FLOPs; reads q, k, v,
  writes o and ``lse``;
- dK/dV: 2 B n^2 (2 d_qk + 2 d_v) (s = q k^T and dp = do v^T again, dV =
  p^T do, dK = ds^T q); reads q, k, v, do, ``lse``, ``di``, writes dk, dv;
- dQ: 2 B n^2 (2 d_qk + d_v) (s again, dp, dQ = ds k); reads the same,
  writes dq.

A bound is the larger of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s
(``flops.bound_s``). ``variant_step_flops`` adds the variant's model FLOPs
to ``flops.cut_step_flops``' convention: per attention block and image
the core's forward and its four 1 x 1 convs, 3 x forward a training pass;
the SE gate's dense layers (< 0.01% of a block) and the elementwise gates
are left out.
"""

from __future__ import annotations

from portbench.reference.variant import ATTN_REDUCTION
from portbench.work import flops

KINDS = ("fwd", "dkv", "dq")


def attention_work(b: int, n: int, d_qk: int, d_v: int, kind: str,
                   itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one attention kernel call."""
    pair = 2.0 * b * n * n
    qk, v, stats = b * n * d_qk * itemsize, b * n * d_v * itemsize, b * n * 4
    if kind == "fwd":
        return pair * (d_qk + d_v), 2 * qk + 2 * v + stats
    if kind == "dkv":
        return pair * (2 * d_qk + 2 * d_v), 2 * qk + 2 * v + 2 * stats + qk + v
    if kind == "dq":
        return pair * (2 * d_qk + d_v), 2 * qk + 2 * v + 2 * stats + qk
    raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def attention_bound_s(calls) -> float:
    """The summed bound of ``calls``: (kind, B, n, d_qk, d_v) tuples."""
    return sum(flops.bound_s(*attention_work(b, n, dqk, dv, kind))
               for kind, b, n, dqk, dv in calls)


def _blocks(g_cfg: dict) -> tuple[list[int], int, int]:
    """(attention block ids, trunk channels C, d_qk = C / 8)."""
    c = g_cfg.get("ngf", 64) * 2 ** g_cfg.get("n_downsampling", 2)
    ids = sorted(g_cfg.get("attn_layers", ())) if g_cfg.get("use_attention") else []
    return ids, c, max(c // ATTN_REDUCTION, 1)


def attention_calls(cfg: dict, batch: int, step: int) -> list[tuple]:
    """(kind, B, n, d_qk, d_v) of every attention kernel call of CUT step
    ``step``: each G pass (``flops.cut_trunk_passes``) that reaches an
    attention block runs its forward, dK/dV and dQ once (every pass has a
    backward)."""
    g_cfg = cfg["model"]["generator"]
    ids, c, d_qk = _blocks(g_cfg)
    hw = int(cfg["image_size"]) >> g_cfg.get("n_downsampling", 2)
    calls = []
    for b, blocks in flops.cut_trunk_passes(cfg, batch, step):
        for i in ids:
            if i < blocks:
                calls += [(kind, b, hw * hw, d_qk, c) for kind in KINDS]
    return calls


def block_fwd_flops(n: int, c: int, d_qk: int) -> float:
    """One attention block's forward per image: the core and the q, k, v and
    output 1 x 1 convs."""
    return 2.0 * n * n * (d_qk + c) + 2.0 * n * c * (2 * d_qk + 2 * c)


def variant_step_flops(cfg: dict, batch: int, step: int) -> float:
    """The variant blocks' model FLOPs of CUT step ``step``: 3 x forward for
    every attention forward the step runs."""
    g_cfg = cfg["model"]["generator"]
    _, c, d_qk = _blocks(g_cfg)
    fwd = [call for call in attention_calls(cfg, batch, step) if call[0] == "fwd"]
    return sum(3.0 * b * block_fwd_flops(n, c, d_qk) for _, b, n, _, _ in fwd)
