"""DiffAugment on injected random draws (NHWC).

Counterpart of ``gan_variant_research_tpu/ops/diffaugment.py``:

- brightness: x + (u - 0.5) per sample;
- saturation: (x - mean_c) * 2u + mean_c;
- contrast: (x - mean_chw) * (u + 0.5) + mean_chw;
- translation (ratio 0.125): an integer shift per sample and axis, zero fill;
- cutout (ratio 0.5) / cutout_light (0.2): one zeroed square per sample,
  its centre anywhere in the image, clamped to the bounds.

The uniform draws ``u`` are in x's dtype, as the JAX draws are (bf16 for a
bf16 fake), and the arithmetic runs in x's dtype.
"""

from __future__ import annotations

import dataclasses

import torch

TRANSLATION_RATIO = 0.125
CUTOUT_RATIOS = {"cutout": 0.5, "cutout_light": 0.2}
_OPS = {"color": ("brightness", "saturation", "contrast"),
        "translation": ("translation",),
        "cutout": ("cutout",),
        "cutout_light": ("cutout_light",)}


def policy_ops(policy) -> tuple[str, ...]:
    """The flat op list of a policy; unknown names are skipped, as in the
    JAX package."""
    return tuple(op for p in policy for op in _OPS.get(p, ()))


@dataclasses.dataclass
class DiffAugmentDraws:
    """The draws of one ``diff_augment`` call: one entry per op of the
    policy's flat op list (``policy_ops``), in order, as the JAX chain gives
    every op its own key, so an op that repeats draws anew. ``ops`` names
    the ops; ``values[k]`` holds op k's per-sample tensors, each (B,): the
    uniform in [0, 1) in x's dtype for brightness, saturation and contrast;
    integer ``(shift_h, shift_w)`` in [-s, s] for translation; integer
    ``(cut_h, cut_w)`` centres for cutout and cutout_light."""

    ops: tuple[str, ...] = ()
    values: tuple[tuple[torch.Tensor, ...], ...] = ()


def translation_max_shift(size: int, ratio: float = TRANSLATION_RATIO) -> int:
    return int(size * ratio + 0.5)


def cutout_size(size: int, ratio: float) -> int:
    return int(size * ratio + 0.5)


def rand_brightness(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return x + (u.to(x.dtype) - 0.5).view(-1, 1, 1, 1)


def rand_saturation(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    factor = (u.to(x.dtype) * 2.0).view(-1, 1, 1, 1)
    mean = x.mean(dim=3, keepdim=True)
    return (x - mean) * factor + mean


def rand_contrast(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    factor = (u.to(x.dtype) + 0.5).view(-1, 1, 1, 1)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * factor + mean


def rand_translation(x: torch.Tensor, shift_h: torch.Tensor,
                     shift_w: torch.Tensor) -> torch.Tensor:
    """out[b, i, j] = x[b, i + shift_h[b], j + shift_w[b]], zero outside."""
    b, h, w, _ = x.shape
    rows = torch.arange(h, device=x.device)[None, :] + shift_h.view(-1, 1).long()
    cols = torch.arange(w, device=x.device)[None, :] + shift_w.view(-1, 1).long()
    valid = (((rows >= 0) & (rows < h))[:, :, None]
             & ((cols >= 0) & (cols < w))[:, None, :])
    bi = torch.arange(b, device=x.device)[:, None, None]
    out = x[bi, rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    return out * valid[..., None].to(x.dtype)


def rand_cutout(x: torch.Tensor, cut_h: torch.Tensor, cut_w: torch.Tensor,
                ratio: float = 0.5) -> torch.Tensor:
    """Zero the square of side ``int(size * ratio + 0.5)`` centred (lower
    middle for even sides) at (cut_h, cut_w), clamped to the image."""
    _, h, w, _ = x.shape
    ch, cw = cutout_size(h, ratio), cutout_size(w, ratio)
    lo_h = cut_h.view(-1, 1).long() - ch // 2
    lo_w = cut_w.view(-1, 1).long() - cw // 2
    rows = torch.arange(h, device=x.device)[None, :]
    cols = torch.arange(w, device=x.device)[None, :]
    in_h = (rows >= lo_h.clamp_min(0)) & (rows <= (lo_h + ch - 1).clamp_max(h - 1))
    in_w = (cols >= lo_w.clamp_min(0)) & (cols <= (lo_w + cw - 1).clamp_max(w - 1))
    keep = ~(in_h[:, :, None] & in_w[:, None, :])
    return x * keep[..., None].to(x.dtype)


def diff_augment(x: torch.Tensor, policy, draws: DiffAugmentDraws) -> torch.Tensor:
    """Apply the policy's ops in order, each with its own draws."""
    ops = policy_ops(policy)
    if tuple(draws.ops) != ops:
        raise ValueError(f"draws are for ops {draws.ops}, the policy has {ops}")
    for op, v in zip(ops, draws.values):
        if op == "brightness":
            x = rand_brightness(x, *v)
        elif op == "saturation":
            x = rand_saturation(x, *v)
        elif op == "contrast":
            x = rand_contrast(x, *v)
        elif op == "translation":
            x = rand_translation(x, *v)
        else:
            x = rand_cutout(x, *v, CUTOUT_RATIOS[op])
    return x
