"""Exponential moving average of the generator's parameters.

Counterpart of ``gan_variant_research_tpu/train/ema.py``: the shadow starts
as a copy of the parameters; each step, shadow <- (1 - decay) * param +
decay * shadow, in place.
"""

from __future__ import annotations

import torch


def ema_init(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(shadow: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
               decay: float) -> None:
    for k, s in shadow.items():
        s.mul_(decay).add_(params[k] * (1.0 - decay))
