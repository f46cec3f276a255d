"""The variant generator's blocks: SAGAN self-attention, channel attention
and the style-dropout gate, NHWC.

Counterpart of ``gan_variant_research_tpu/models/attention.py``. Submodules
and parameters carry the JAX names (``query``, ``key``, ``value``, ``out``
and ``gamma``; ``fc1`` and ``fc2``; ``gamma`` and ``beta``), so
``convert.py`` maps one to one. All three are identities at init.

- ``SelfAttention2d``: ``x + gamma * out(softmax(q k^T) v)`` with 1x1 convs.
  Its core is picked by d_qk = C / reduction alone, on both devices: up to
  128, where the JAX package can run its flash kernel, it is
  ``ops/kernels/spatial_attention.py::spatial_attention`` (the hand-written
  kernels on a CUDA tensor, the plain version on the CPU; looked up on its
  module at each call, so a comparison can route it); past 128, where the
  JAX package runs its einsum core, it is ``einsum_attention``, that core's
  counterpart in stock PyTorch ops. The JAX ``flash`` routing (a TPU rule
  on n and C) does not carry over: the kernels take any n, and
  ``attn_flash`` is only validated.
- ``ChannelAttention``: ``x * 2 sigmoid(fc2(relu(fc1(mean(x)))))``.
- ``StyleGate``: ``alpha x + (1 - alpha)(gamma IN(x) + beta)`` for a
  pre-drawn per-sample ``alpha`` (B,); without one it returns ``x``, as the
  JAX gate does without a key.

The last two are stock PyTorch ops, as XLA runs them in JAX, with the JAX
modules' float32 casts.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.models.layers import Conv2d
from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as attention_core
from gan_variant_research_tpu_torch.ops.kernels.instance_norm import instance_norm
from gan_variant_research_tpu_torch.ops.nn_ops import uniform_fan_in_


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX ``SelfAttention2d``'s einsum core (models/attention.py's
    non-flash branch), at its rounding points: q k^T of the inputs' values
    summed in float32, the softmax in float32, the weights cast to v's
    dtype, then the weighted sum in that dtype. The (B, n, n) map is
    materialised, as XLA does there; on the card its call is counted under
    ``attn.fwd.einsum`` (no hand-written kernel runs)."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    if v.device.type == "cuda":
        trace.count("attn.fwd.einsum")
    return torch.matmul(attn, v)


class SelfAttention2d(nn.Module):
    """SAGAN self-attention over the spatial grid; ``gamma`` starts at 0."""

    def __init__(self, channels: int, reduction: int = 8, flash="auto",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        # as the JAX package validates it (attention.py:71-75): a quoted
        # YAML "false" must not pass; the value selects nothing here
        if flash not in (True, False, "auto"):
            raise ValueError(f"attn_flash must be true, false or 'auto', got {flash!r}")
        inner = max(channels // reduction, 1)
        kw = dict(dtype=dtype, generator=generator)
        self.query = Conv2d(channels, inner, 1, **kw)
        self.key = Conv2d(channels, inner, 1, **kw)
        self.value = Conv2d(channels, channels, 1, **kw)
        self.out = Conv2d(channels, channels, 1, **kw)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        q = self.query(x).reshape(b, h * w, -1)
        k = self.key(x).reshape(b, h * w, -1)
        v = self.value(x).reshape(b, h * w, c)
        if attention_core.attention_route(q.shape[2], c)[0] == "einsum":
            core = einsum_attention
        else:
            core = attention_core.spatial_attention
        out = self.out(core(q, k, v).reshape(b, h, w, c))
        return x + self.gamma.to(x.dtype) * out


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in the compute dtype, the bias
    added after the product. ``weight`` is (out, in), the JAX kernel
    transposed."""

    def __init__(self, in_features: int, features: int, zero_init: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        weight = torch.zeros(features, in_features)
        if not zero_init:
            uniform_fan_in_(weight, in_features, generator)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(self.dtype).T + self.bias.to(self.dtype)


class ChannelAttention(nn.Module):
    """Squeeze-and-excitation gate; ``fc2`` starts at 0, so the scale at
    init is 2 sigmoid(0) = 1."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        inner = max(channels // reduction, 1)
        self.fc1 = Dense(channels, inner, dtype=dtype, generator=generator)
        self.fc2 = Dense(inner, channels, zero_init=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.float().mean(dim=(1, 2)).to(x.dtype)
        z = self.fc2(torch.relu(self.fc1(pooled)))
        scale = 2.0 * torch.sigmoid(z.float())
        return x * scale[:, None, None, :].to(x.dtype)


class StyleGate(nn.Module):
    """The train-only style-dropout gate; ``gamma`` starts at 1, ``beta``
    at 0."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, alpha: torch.Tensor | None = None) -> torch.Tensor:
        """``alpha``: (B,) draws in [alpha_min, alpha_max], drawn in float32
        and cast here to x's dtype; ``None`` returns ``x``."""
        if alpha is None:
            return x
        if alpha.shape != (x.shape[0],):
            raise ValueError(f"alpha must be ({x.shape[0]},), got {tuple(alpha.shape)}")
        styled = self.gamma.to(x.dtype) * instance_norm(x) + self.beta.to(x.dtype)
        a = alpha.to(x.dtype).view(-1, 1, 1, 1)
        return a * x + (1.0 - a) * styled
