"""[-1, 1] normalisation helpers (NHWC).

Counterpart of the normalisation half of
``gan_variant_research_tpu/ops/color.py``. Arithmetic stays in the input's
dtype, as ``jnp`` does with Python scalars, so bf16 rounds where JAX rounds.
"""

from __future__ import annotations

import torch


def normalize_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> float in [-1, 1]."""
    if not x.is_floating_point():
        x = x.float() / 255.0
    return x * 2.0 - 1.0


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return x * 0.5 + 0.5


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 [0, 255]: clamp, *0.5+0.5, *255, round half to even."""
    x = torch.clamp(x, -1.0, 1.0)
    x = (x * 0.5 + 0.5) * 255.0
    return torch.round(x).to(torch.uint8)
