"""L1 reconstruction losses, reduced in float32. Counterpart of
``gan_variant_research_tpu/losses/reconstruction.py``."""

from __future__ import annotations

import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def identity_loss(reconstructed: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """float32 L1 of G(monet) against the monet (CUT's identity term)."""
    return l1_loss(reconstructed, target)


def cycle_loss(reconstructed: torch.Tensor, source: torch.Tensor, lam: float) -> torch.Tensor:
    return lam * l1_loss(reconstructed, source)
