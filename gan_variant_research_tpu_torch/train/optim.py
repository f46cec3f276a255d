"""Adam behind a global-norm clip, with optax's arithmetic.

Counterpart of ``gan_variant_research_tpu/train/optim.py``:
``chain(clip_by_global_norm(max_norm), adam(lr, b1, b2, eps=1e-8))``, or
``adam`` alone without a clip, and two learning-rate rules: the cosine
schedule when ``scheduler.enabled`` (CUT), and CycleGAN's epoch decay
(``epoch_decay`` in ``train/cyclegan_trainer.py:111-121`` of the JAX
package: the LambdaLR rule, constant, then linear to 0 between two epochs,
the epoch read from the update count). The state keeps ``count``, ``mu``
and ``nu`` per parameter, as optax's ``ScaleByAdamState`` does.

The clip is optax's rule: the gradients are scaled by ``max_norm / norm``
only when ``norm >= max_norm``, with no epsilon (``torch.nn.utils.
clip_grad_norm_`` divides by ``norm + 1e-6``). It is decided on the device,
without a host sync. ``Optimizer.step`` runs the spans ``optim.clip`` and
``optim.adam`` (``core/trace.py``).

An update's rate and Adam's bias corrections are decided on the host in
doubles (``Optimizer.scalars``) and reach the arithmetic as float32 0-d
tensors on the parameters' device, rounded once, so that a CUDA graph of a
train step reads each step's values from its buffers
(``train/cut_trainer.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from gan_variant_research_tpu_torch.core import config as cfg_mod
from gan_variant_research_tpu_torch.core import trace


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
    # (steps_per_epoch, decay_start_epoch, epochs)
    epoch_decay: tuple[int, int, int] | None = None

    @property
    def scheduled(self) -> bool:
        """Whether the rate follows a schedule (optax then keeps a count of
        its own beside Adam's)."""
        return self.cosine is not None or self.epoch_decay is not None

    def learning_rate(self, count: int) -> float:
        """The rate of the update that follows ``count`` earlier ones
        (optax's ``cosine_decay_schedule`` with ``alpha = lr_min / lr``, or
        the epoch decay: ``lr`` before ``decay_start_epoch``, then ``lr``
        times ``1 - (epoch - start) / max(1, epochs - start)`` clipped to
        [0, 1])."""
        if self.epoch_decay is not None:
            steps_per_epoch, start, epochs = self.epoch_decay
            epoch = count // steps_per_epoch
            if epoch < start:
                return self.lr
            return self.lr * min(max(1.0 - (epoch - start) / max(1, epochs - start), 0.0), 1.0)
        if self.cosine is None:
            return self.lr
        lr_min, total = self.cosine
        frac = min(count, total) / total
        alpha = lr_min / self.lr
        return self.lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamState(0, zeros(), zeros())

    def scalars(self, count: int) -> tuple[float, float, float]:
        """The update that follows ``count`` earlier ones: its rate and
        Adam's bias corrections ``1 - b1 ** (count + 1)`` and ``1 - b2 **
        (count + 1)``, in doubles."""
        n = count + 1
        return self.learning_rate(count), 1.0 - self.b1 ** n, 1.0 - self.b2 ** n

    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             state: AdamState) -> AdamState:
        """Clip ``grads``, update the moments, and add the Adam update to
        ``params`` in place (``update`` on ``scalars(state.count)``).
        Returns the new state (the moments are updated in place)."""
        device = next(iter(params.values())).device
        self.update(params, grads, state, *(torch.full((), v, dtype=torch.float32, device=device)
                                            for v in self.scalars(state.count)))
        return AdamState(state.count + 1, state.mu, state.nu)

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
               state: AdamState, lr: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> None:
        """``step``'s arithmetic on tensors alone: the rate ``lr`` and the
        bias corrections ``c1``, ``c2`` are 0-d tensors; ``state.count`` is
        neither read nor moved."""
        if self.max_norm is not None:
            with trace.span("optim.clip"):
                grads = clip_by_global_norm(grads, self.max_norm)
        with trace.span("optim.adam"):
            for k, p in params.items():
                g = grads[k].float()
                mu, nu = state.mu[k], state.nu[k]
                mu.mul_(self.b1).add_((1.0 - self.b1) * g)
                nu.mul_(self.b2).add_((1.0 - self.b2) * g.square())
                update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
                p.sub_((lr * update).to(p.dtype))

    def state_dict(self, state: AdamState, tree: Callable[[dict], dict]) -> dict:
        """``state`` in the layout ``flax.serialization.to_state_dict`` gives
        optax's state of the same chain: ``{"0": {} (the clip), "1": {"0":
        {count, mu, nu} (scale_by_adam), "1": {} or, with a schedule,
        {count}}}``, without the clip's level when there is no clip. ``tree`` maps the moments' dicts to the JAX param tree."""
        count = np.asarray(state.count, dtype=np.int32)
        adam = {"0": {"count": count, "mu": tree(state.mu), "nu": tree(state.nu)},
                "1": {"count": count} if self.scheduled else {}}
        return {"0": {}, "1": adam} if self.max_norm is not None else adam

    def load_state_dict(self, data: dict, leaves: Callable[[dict], dict]) -> AdamState:
        """The inverse of ``state_dict``; ``leaves`` maps a JAX tree of
        moments back to the port's dict of tensors."""
        adam = (data["1"] if self.max_norm is not None else data)["0"]
        return AdamState(int(adam["count"]), leaves(adam["mu"]), leaves(adam["nu"]))


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
