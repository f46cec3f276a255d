"""The comparisons that decide ``correct``: the program's numbers against the
plain reference's.

- ``loss_gap``: the largest relative gap of the first step's losses (the
  later steps' losses follow Adam's first updates, which turn rounding in
  near-zero gradient elements into whole +-lr moves: the float32 reference
  run twice already reads 2.6e-4 on the third step's and 1e-5 on the
  first's);
- ``leaf_gap``: per parameter leaf, the gap between the program's norm of a
  quantity (a gradient, a change) and the reference's, over the larger of
  the reference's norm of that leaf and of the net's median leaf (some
  gradients are all but zero); the worst leaf;
- ``diff_gap``: per leaf, the norm of the difference between the program's
  gradient and the reference's, over the larger of the reference's norm
  of that leaf and of the net's median leaf; the worst leaf;
- ``image_gap``: the worst image's mean absolute difference in uint8
  levels.
"""

from __future__ import annotations

import statistics

import torch

# A leaf whose first gradient in the reference is under this share of the
# net's median leaf is nought to rounding (a bias before an instance norm):
# its gradient is round-off and Adam moves it by round-off alone, so
# neither is compared.
ZERO_GRADIENT_SHARE = 1e-3


def loss_gap(prog: list[dict], ref: list[dict]) -> tuple[float, str]:
    """Worst |p - r| / |r| over the steps and the reference's loss keys
    (a key the reference reads as 0 on a step, R1 off it, is skipped)."""
    worst, where = 0.0, ""
    for i, (p, r) in enumerate(zip(prog, ref)):
        for k, rv in r.items():
            if rv == 0.0:
                continue
            gap = abs(float(p[k]) - rv) / abs(rv)
            if gap >= worst:
                worst, where = gap, f"step{i}.{k}"
    return worst, where


def norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gap(prog: dict[str, float], ref: dict[str, float],
             keep=None) -> tuple[float, str]:
    """Worst leaf of |n_p - n_r| / max(n_r, median n_r) over one net's leaves
    (``keep`` a set of the leaves compared, all by default)."""
    median = statistics.median(ref.values())
    worst, where = 0.0, ""
    for k, r in ref.items():
        if keep is not None and k not in keep:
            continue
        gap = abs(prog[k] - r) / max(r, median, 1e-30)
        if gap >= worst:
            worst, where = gap, k
    return worst, where


def diff_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """Worst leaf of ||p - r|| / max(||r||, median ||r||) over one net's
    leaves (``keep`` as in ``leaf_gap``)."""
    ref_norms = norms(ref)
    median = statistics.median(ref_norms.values())
    worst, where = 0.0, ""
    for k, r in ref.items():
        if keep is not None and k not in keep:
            continue
        gap = float(torch.linalg.vector_norm((prog[k] - r).double())) / max(ref_norms[k], median,
                                                                            1e-30)
        if gap >= worst:
            worst, where = gap, k
    return worst, where


def moved_leaves(first_grad_norms: dict[str, float]) -> set[str]:
    """The leaves whose first gradient in the reference is not nought to
    rounding (``ZERO_GRADIENT_SHARE`` of the median leaf or more)."""
    median = statistics.median(first_grad_norms.values())
    return {k for k, v in first_grad_norms.items() if v >= ZERO_GRADIENT_SHARE * median}


def worst(gaps: dict[str, tuple[float, str]]) -> tuple[float, str]:
    """The worst of several nets' (gap, leaf), named ``net.leaf``."""
    net, (gap, leaf) = max(gaps.items(), key=lambda kv: kv[1][0])
    return gap, f"{net}.{leaf}"


def image_gap(prog_u8: torch.Tensor, ref_u8: torch.Tensor) -> tuple[float, int]:
    """(worst image's mean |p - r| in levels, its index) over NHWC uint8."""
    diff = (prog_u8.int() - ref_u8.int()).abs().float().mean(dim=(1, 2, 3))
    i = int(diff.argmax())
    return float(diff[i]), i


def train_numbers(prog: dict, ref: dict) -> dict[str, tuple[float, str]]:
    """The numbers of a training cell. ``prog`` and ``ref`` hold ``losses``
    (a dict a step), ``grad`` and ``change`` ({net: {leaf: norm}}) and
    ``d_grad``, the discriminators' first gradients ({net: {leaf:
    tensor}}); the leaves whose first reference gradient is nought to
    rounding are left out (an ``ema`` net follows ``g``'s rule).
    ``d_grad_diff`` is taken on the discriminators alone: their gradient
    comes through D alone (its inputs detached), while G's first gradient
    passes 18 and more instance norms whose projections cancel most of it,
    where bf16 already moves its direction by 35-51% at random init."""
    keep = {net: moved_leaves(g) for net, g in ref["grad"].items()}
    keep.setdefault("ema", keep.get("g"))
    return {
        "loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad_gap": worst({net: leaf_gap(prog["grad"][net], r, keep[net])
                           for net, r in ref["grad"].items()}),
        "change_gap": worst({net: leaf_gap(prog["change"][net], r, keep[net])
                             for net, r in ref["change"].items()}),
        "d_grad_diff": worst({net: diff_gap(prog["d_grad"][net], r, keep[net])
                              for net, r in ref["d_grad"].items()}),
    }
