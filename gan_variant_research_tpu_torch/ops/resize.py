"""Device-side bilinear resize of NHWC images.

Counterpart of ``gan_variant_research_tpu/ops/resize.py::resize_bilinear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    antialias: bool = True) -> torch.Tensor:
    """Resize an NHWC float tensor to (H, W) = ``size``: half-pixel centres,
    antialiased when shrinking. A tensor already at ``size`` comes back
    unchanged, as ``jax.image.resize`` returns it."""
    if x.dim() != 4:
        raise ValueError(f"Expected NHWC, got shape {tuple(x.shape)}")
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[1:3]) == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      antialias=antialias, align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()
