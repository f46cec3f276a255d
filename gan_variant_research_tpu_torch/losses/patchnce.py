"""PatchNCE contrastive loss (CUT), batched.

Counterpart of ``gan_variant_research_tpu/losses/patchnce.py``. The patch
ids are drawn by the caller (``core/prng.py``), one shared set per layer for
the whole batch and for both src and tgt. Per layer: gather the patches in
the features' dtype, then cast to float32; L2-normalise with eps 1e-6;
logits = tgt @ src^T / temperature, clamped to +-50; cross-entropy against
the diagonal (negatives never cross batch items); a non-finite layer loss
becomes 0. The mean is over the batch, then over the layers. Source
features are detached here.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def layer_nce(src: torch.Tensor, tgt: torch.Tensor, patch_ids: torch.Tensor,
              temperature: float) -> torch.Tensor:
    """One layer on NHWC features and (n,) flat spatial ids; float32 scalar."""
    b, h, w, c = src.shape
    patch_ids = patch_ids.long()
    src_p = _normalize(src.reshape(b, h * w, c)[:, patch_ids].float())
    tgt_p = _normalize(tgt.reshape(b, h * w, c)[:, patch_ids].float())
    logits = torch.einsum("bnc,bmc->bnm", tgt_p, src_p) / temperature
    logits = logits.clamp(-50.0, 50.0)
    loss = (torch.logsumexp(logits, dim=-1) - logits.diagonal(dim1=1, dim2=2)).mean()
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))


def patch_nce_loss(src_feats: Sequence[torch.Tensor], tgt_feats: Sequence[torch.Tensor],
                   patch_ids: Sequence[torch.Tensor],
                   temperature: float = 0.07) -> torch.Tensor:
    """Mean NCE loss over the tapped layers; ``patch_ids[i]`` holds layer
    i's ``min(num_patches, H*W)`` ids."""
    if not (len(src_feats) == len(tgt_feats) == len(patch_ids)):
        raise ValueError(f"{len(src_feats)} src, {len(tgt_feats)} tgt and "
                         f"{len(patch_ids)} patch-id sets do not match")
    total = 0.0
    for src, tgt, ids in zip(src_feats, tgt_feats, patch_ids):
        total = total + layer_nce(src.detach(), tgt, ids, temperature)
    return total / len(src_feats)
