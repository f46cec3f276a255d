"""Adam behind a global-norm clip, with optax's arithmetic.

Counterpart of ``gan_variant_research_tpu/train/optim.py``:
``chain(clip_by_global_norm(max_norm), adam(lr, b1, b2, eps=1e-8))``, and
the cosine schedule when ``scheduler.enabled``. The state keeps ``count``,
``mu`` and ``nu`` per parameter, as optax's ``ScaleByAdamState`` does.

The clip is optax's rule: the gradients are scaled by ``max_norm / norm``
only when ``norm >= max_norm``, with no epsilon (``torch.nn.utils.
clip_grad_norm_`` divides by ``norm + 1e-6``). It is decided on the device,
without a host sync.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gan_variant_research_tpu_torch.core import config as cfg_mod


@dataclasses.dataclass
class AdamState:
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8
    max_norm: float | None = 10.0
    cosine: tuple[float, int] | None = None   # (lr_min, total_steps)

    def learning_rate(self, count: int) -> float:
        """The rate of the update that follows ``count`` earlier ones
        (optax's ``cosine_decay_schedule`` with ``alpha = lr_min / lr``)."""
        if self.cosine is None:
            return self.lr
        lr_min, total = self.cosine
        frac = min(count, total) / total
        alpha = lr_min / self.lr
        return self.lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             state: AdamState) -> AdamState:
        """Clip ``grads``, update the moments, and add the Adam update to
        ``params`` in place. Returns the new state (the moments are updated
        in place)."""
        if self.max_norm is not None:
            grads = clip_by_global_norm(grads, self.max_norm)
        count = state.count + 1
        lr = self.learning_rate(state.count)
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        for k, p in params.items():
            g = grads[k].float()
            mu, nu = state.mu[k], state.nu[k]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g.square())
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_((-lr * update).to(p.dtype))
        return AdamState(count, state.mu, state.nu)


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float) -> dict[str, torch.Tensor]:
    """optax.clip_by_global_norm: g / norm * max_norm where norm >= max_norm."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, g / norm * max_norm) for k, g in grads.items()}


def optimizer_from_config(opt_cfg: dict, grad_clip: float | None,
                          max_steps: int | None) -> Optimizer:
    """An ``optim.G`` / ``optim.D`` block -> ``Optimizer``. Weight decay
    (optax's adamw) is not ported."""
    get = lambda path, default: cfg_mod.get(opt_cfg, path, default)
    if float(get("weight_decay", 0.0)) > 0:
        raise NotImplementedError("weight_decay > 0 (adamw) is not ported")
    lr = float(get("lr", 2e-4))
    b1, b2 = (float(b) for b in get("betas", [0.5, 0.999]))
    cosine = None
    if get("scheduler.enabled", False):
        kind = get("scheduler.type", "cosine")
        if kind != "cosine":
            raise ValueError(f"Unknown scheduler type: {kind!r}")
        if not max_steps:
            raise ValueError("cosine scheduler requires max_steps")
        cosine = (float(get("scheduler.lr_min", 0.0)), max(1, int(max_steps)))
    max_norm = float(grad_clip) if grad_clip is not None and grad_clip > 0 else None
    return Optimizer(lr=lr, b1=b1, b2=b2, max_norm=max_norm, cosine=cosine)
