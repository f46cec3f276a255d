"""Adversarial losses on raw logit maps, reduced in float32.

Counterpart of ``gan_variant_research_tpu/losses/adversarial.py``: hinge
(D: 0.5 (mean relu(1 - D(real)) + mean relu(1 + D(fake))); G: -mean
D(fake)), and LSGAN / BCE against constant targets; each averaged over the
scales of a multiscale D (a single map or a list).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _as_list(preds):
    return preds if isinstance(preds, (list, tuple)) else [preds]


def discriminator_hinge_loss(real_preds, fake_preds) -> torch.Tensor:
    real_preds, fake_preds = _as_list(real_preds), _as_list(fake_preds)
    loss = 0.0
    for real, fake in zip(real_preds, fake_preds):
        loss_real = torch.relu(1.0 - real.float()).mean()
        loss_fake = torch.relu(1.0 + fake.float()).mean()
        loss = loss + (loss_real + loss_fake) * 0.5
    return loss / len(real_preds)


def generator_hinge_loss(fake_preds) -> torch.Tensor:
    fake_preds = _as_list(fake_preds)
    loss = 0.0
    for fake in fake_preds:
        loss = loss - fake.float().mean()
    return loss / len(fake_preds)


def gan_loss(pred, is_real: bool, mode: str = "lsgan") -> torch.Tensor:
    """LSGAN (MSE) or BCE-with-logits against all-ones / all-zeros targets,
    averaged over scales."""
    preds = _as_list(pred)
    total = 0.0
    for p in preds:
        p = p.float()
        target = torch.ones_like(p) if is_real else torch.zeros_like(p)
        if mode == "lsgan":
            total = total + (p - target).square().mean()
        elif mode == "bce":
            total = total + F.binary_cross_entropy_with_logits(p, target)
        else:
            raise ValueError(f"Unknown gan mode: {mode!r}")
    return total / len(preds)
