"""The port's sampler of one train step's random draws.

Counterpart of ``gan_variant_research_tpu/core/prng.py::step_keys`` and of
the ``jax.random`` calls inside the JAX step: one ``torch.Generator`` (the
train state's, on the state's device) draws every random input of a step,
with the same shapes, ranges and dtypes as the JAX draws. The JAX bits
cannot be reproduced; the parity tests fill a ``StepDraws`` from
``jax.random`` under the JAX key splits instead.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from gan_variant_research_tpu_torch.data.augment import AugmentDraws
from gan_variant_research_tpu_torch.ops.diffaugment import (
    CUTOUT_RATIOS,
    DiffAugmentDraws,
    cutout_size,
    policy_ops,
    translation_max_shift,
)

SCALE_RANGE = (0.85, 1.0)
JITTER = (0.05, 0.05, 0.05, 0.02)   # brightness, contrast, saturation, hue


@dataclasses.dataclass
class StepDraws:
    """Every random input of one CUT step, named as the JAX step's keys:
    the two ``train_augment`` calls, the three ``diff_augment`` calls
    (``None`` without DiffAugment), the per-layer PatchNCE ids, and the style
    gates' alphas of the three generator passes (the photo forward, the
    taps-only forward on the fake, the identity pass), each (n_blocks, B)
    float32 in [alpha_min, alpha_max] (``None`` without style dropout)."""

    photo_aug: AugmentDraws
    monet_aug: AugmentDraws
    da_real: DiffAugmentDraws | None
    da_fake: DiffAugmentDraws | None
    da_g: DiffAugmentDraws | None
    nce: list[torch.Tensor]
    style_fwd: torch.Tensor | None = None
    style_nce: torch.Tensor | None = None
    style_idt: torch.Tensor | None = None


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    u = torch.rand((n,), generator=gen, device=gen.device, dtype=dtype)
    return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u


def _randint(gen: torch.Generator, n: int, lo: int, hi: int) -> torch.Tensor:
    return torch.randint(lo, hi, (n,), generator=gen, device=gen.device)


def sample_augment(gen: torch.Generator, batch: int) -> AugmentDraws:
    b, c, s, h = JITTER
    return AugmentDraws(
        scales=_uniform(gen, batch, *SCALE_RANGE),
        off_i=_uniform(gen, batch, 0.0, 1.0),
        off_j=_uniform(gen, batch, 0.0, 1.0),
        flip=_uniform(gen, batch, 0.0, 1.0) < 0.5,
        brightness=_uniform(gen, batch, 1.0 - b, 1.0 + b),
        contrast=_uniform(gen, batch, 1.0 - c, 1.0 + c),
        saturation=_uniform(gen, batch, 1.0 - s, 1.0 + s),
        hue=_uniform(gen, batch, -h, h),
    )


def sample_diff_augment(gen: torch.Generator, batch: int, size: int, policy,
                        dtype: torch.dtype) -> DiffAugmentDraws:
    """Draws for ``diff_augment`` of a (batch, size, size, C) tensor of
    ``dtype``, one per op in policy order; the colour uniforms are drawn in
    ``dtype``."""
    ops = policy_ops(policy)
    values = []
    for op in ops:
        if op in ("brightness", "saturation", "contrast"):
            values.append((_uniform(gen, batch, 0.0, 1.0, dtype),))
        elif op == "translation":
            s = translation_max_shift(size)
            values.append((_randint(gen, batch, -s, s + 1), _randint(gen, batch, -s, s + 1)))
        else:
            c = cutout_size(size, CUTOUT_RATIOS[op])
            values.append((_randint(gen, batch, 0, size + (1 - c % 2)),
                           _randint(gen, batch, 0, size + (1 - c % 2))))
    return DiffAugmentDraws(ops, tuple(values))


def sample_step(gen: torch.Generator, batch: int, image_size: int, policy,
                real_dtype: torch.dtype, fake_dtype: torch.dtype,
                tap_hw: Sequence[int], num_patches: int,
                style: tuple[int, float, float] | None = None) -> StepDraws:
    """One step's draws. ``policy`` is the DiffAugment op list (``None``
    when it is off); ``tap_hw`` the H*W of each tapped NCE layer; ``style``
    (n_blocks, alpha_min, alpha_max) with style dropout, else ``None``."""
    da = (lambda dtype: sample_diff_augment(gen, batch, image_size, policy, dtype)
          if policy is not None else None)

    def alphas():
        if style is None:
            return None
        n_blocks, lo, hi = style
        return _uniform(gen, n_blocks * batch, lo, hi).view(n_blocks, batch)

    return StepDraws(
        photo_aug=sample_augment(gen, batch),
        monet_aug=sample_augment(gen, batch),
        da_real=da(real_dtype),
        da_fake=da(fake_dtype),
        da_g=da(fake_dtype),
        nce=[_randint(gen, min(num_patches, hw), 0, hw) for hw in tap_hw],
        style_fwd=alphas(),
        style_nce=alphas(),
        style_idt=alphas(),
    )
