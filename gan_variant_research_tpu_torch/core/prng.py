"""The port's sampler of one train step's random draws.

Counterpart of ``gan_variant_research_tpu/core/prng.py::step_keys`` and of
the ``jax.random`` calls inside the JAX steps (CUT's and CycleGAN's): one
``torch.Generator`` (the train state's, on the state's device) draws every
random input of a step, with the same shapes, ranges and dtypes as the JAX
draws. The JAX bits cannot be reproduced; the parity tests fill a
``StepDraws`` or ``CycleGANDraws`` from ``jax.random`` under the JAX key
splits instead.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from gan_variant_research_tpu_torch.data.augment import AugmentDraws, CropFlipDraws
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


@dataclasses.dataclass
class CycleGANDraws:
    """Every random input of one CycleGAN step, named as the JAX step's keys
    (``step_keys(base_key, step, ("aug_a", "aug_b"))``): the two
    ``cyclegan_augment`` calls' crop offsets and flips."""

    aug_a: CropFlipDraws
    aug_b: CropFlipDraws


def sample_crop_flip(gen: torch.Generator, batch: int, height: int, width: int,
                     crop: int) -> CropFlipDraws:
    return CropFlipDraws(off_i=_randint(gen, batch, 0, height - crop + 1),
                         off_j=_randint(gen, batch, 0, width - crop + 1),
                         flip=_uniform(gen, batch, 0.0, 1.0) < 0.5)


def sample_cyclegan(gen: torch.Generator, batch: int, height: int, width: int,
                    crop: int) -> CycleGANDraws:
    """One CycleGAN step's draws for uint8 batches of (batch, height, width)
    cropped to ``crop``^2."""
    return CycleGANDraws(aug_a=sample_crop_flip(gen, batch, height, width, crop),
                         aug_b=sample_crop_flip(gen, batch, height, width, crop))


# --------------------------------------------------------------------------- #
# the JAX run key a checkpoint carries (``base_key``)

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """Threefry-2x32 with 20 rounds (Random123; ``jax._src.prng``), on
    uint32 arrays."""
    u32 = np.uint32
    ks = (u32(k0), u32(k1), u32(k0) ^ u32(k1) ^ u32(0x1BD11BDA))
    x0, x1 = x0.astype(u32) + ks[0], x1.astype(u32) + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << u32(r)) | (x1 >> u32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def jax_base_key(seed: int, splits: int = 3) -> np.ndarray:
    """The key data (uint32 (2,)) of the run key that the JAX trainers'
    ``init_state`` draws for ``seed``: ``jax.random.key(seed)`` is (0,
    seed) for a uint32 seed, split ``splits`` ways (the partitionable
    threefry split: counters (0, i)), and the run key is the last: the
    third of three for ``CUTTrainer``, the fifth of five for
    ``CycleGANTrainer``."""
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(0, int(seed) & 0xFFFFFFFF, np.zeros(splits, np.uint32),
                               np.arange(splits, dtype=np.uint32))
    return np.array([b0[-1], b1[-1]], dtype=np.uint32)
