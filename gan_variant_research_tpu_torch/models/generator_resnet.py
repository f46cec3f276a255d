"""ResNet-9 generator with PatchNCE feature taps (NHWC).

Counterpart of ``gan_variant_research_tpu/models/generator_resnet.py``:
reflect-pad 7x7 stem -> stride-2 downsamplings -> residual blocks ->
ConvTranspose upsamplings -> reflect-pad 7x7 + tanh. Submodules carry the
JAX param tree's names (``initial_conv``, ``down_i``, ``res_i``, ``up_i``,
``output_conv``), so ``convert.py`` maps one to one.

Every reflect-padded trunk conv runs through ``reflect_conv3x3``: on a CUDA
tensor that is the hand-written kernel, whatever the config's ``use_pallas``
says (``train/cut_trainer.py::build_generator`` reads and ignores the
TPU-only fields).

The variant blocks (``models/attention.py``) follow their host residual
block, as in the JAX generator (:274-294): ``attn_i`` for i in
``attn_layers``, ``channel_attn_i`` for i in ``channel_attn_layers``, and
``style_gate_i`` after every block with style dropout. The tap of a block
sees the block's output after them; tap ids do not change.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.models.attention import (
    ChannelAttention,
    SelfAttention2d,
    StyleGate,
)
from gan_variant_research_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    activation_fn,
    pad_2d,
)
from gan_variant_research_tpu_torch.ops.kernels.resblock import (
    fused_resblock,
    reflect_conv3x3,
)
from gan_variant_research_tpu_torch.ops.nn_ops import instance_norm, uniform_fan_in_


def _norm(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "instance":
        return instance_norm(x)
    if kind in ("none", "identity"):
        return x
    if kind == "batch":
        raise NotImplementedError("batch norm is not supported")
    raise ValueError(f"Unknown norm: {kind!r}")


class ResidualBlock(nn.Module):
    """pad -> conv3x3 -> norm -> act -> pad -> conv3x3 -> norm, residual add.

    Parameters ``conv{1,2}_weight`` are OIHW, ``conv{1,2}_bias`` float32
    (absent with ``use_bias=False``, where the kernel gets a zero bias)."""

    def __init__(self, channels: int, padding_type: str = "reflect",
                 norm: str = "instance", activation: str = "relu",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if padding_type not in ("reflect", "replicate", "zero"):
            raise ValueError(f"Unknown padding_type: {padding_type!r}")
        self.padding_type = padding_type
        self.norm = norm
        self.act = activation_fn(activation)
        self.baseline = (padding_type, norm, activation) == ("reflect", "instance", "relu")
        self.dtype = dtype
        fan_in = 9 * channels
        for i in (1, 2):
            self.register_parameter(f"conv{i}_weight", nn.Parameter(uniform_fan_in_(
                torch.empty(channels, channels, 3, 3), fan_in, generator)))
            self.register_parameter(f"conv{i}_bias", nn.Parameter(uniform_fan_in_(
                torch.empty(channels), fan_in, generator)) if use_bias else None)

    def _bias(self, i: int, x: torch.Tensor) -> torch.Tensor:
        b = getattr(self, f"conv{i}_bias")
        return b if b is not None else torch.zeros(x.shape[-1], device=x.device)

    def _conv(self, h: torch.Tensor, i: int) -> torch.Tensor:
        w = getattr(self, f"conv{i}_weight")
        if self.padding_type == "reflect":
            return reflect_conv3x3(h, w.permute(2, 3, 1, 0), self._bias(i, h))
        if self.padding_type == "replicate":
            h = pad_2d(h, 1, "replicate")
        y = F.conv2d(h.permute(0, 3, 1, 2), w.to(self.dtype), None, 1,
                     1 if self.padding_type == "zero" else 0)
        y = y.permute(0, 2, 3, 1).contiguous()
        b = getattr(self, f"conv{i}_bias")
        return y if b is None else y + b.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.baseline:
            return fused_resblock(x, self.conv1_weight.permute(2, 3, 1, 0),
                                  self._bias(1, x),
                                  self.conv2_weight.permute(2, 3, 1, 0),
                                  self._bias(2, x))
        h = self.act(_norm(self._conv(x, 1), self.norm))
        h = _norm(self._conv(h, 2), self.norm)
        return x + h


class ResNetGenerator(nn.Module):
    """``forward(x)`` -> image in [-1, 1]; ``forward(x, extract=ids)`` ->
    (image, [tapped features]). ``x`` and every output are NHWC.

    Tap ids: 0 = stem, 1..n_down = downsamplings, then one per residual
    block, then one per upsampling. Ids out of range are skipped silently,
    as in the JAX package (the config's ``nce_layers [0, 4, 8, 12, 16]``
    taps 0, 4, 8 and 12)."""

    def __init__(self, output_nc: int = 3, ngf: int = 64, n_blocks: int = 9,
                 n_downsampling: int = 2, padding_type: str = "reflect",
                 norm: str = "instance", activation: str = "relu",
                 use_bias: bool = True, use_attention: bool = False,
                 attn_layers: Sequence[int] = (3, 7), attn_flash="auto",
                 use_channel_attn: bool = False,
                 channel_attn_layers: Sequence[int] = (5,),
                 use_style_dropout: bool = False, alpha_min: float = 0.4,
                 alpha_max: float = 0.9, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        """``alpha_min``, ``alpha_max``: the range of the style-dropout draws,
        which the train step samples (``style_alpha`` of ``forward``)."""
        super().__init__()
        self.padding_type = padding_type
        self.norm = norm
        self.act = activation_fn(activation)
        self.dtype = dtype
        stem_pad = 3 if padding_type != "reflect" else 0
        kw = dict(dtype=dtype, generator=generator)

        self.initial_conv = Conv2d(3, ngf, 7, padding=stem_pad, use_bias=use_bias, **kw)
        self.n_down = n_downsampling
        self.n_blocks = n_blocks
        self.use_style_dropout = use_style_dropout
        self.alpha_range = (float(alpha_min), float(alpha_max))
        for i in range(n_downsampling):
            mult = 2 ** i
            self.add_module(f"down_{i}", Conv2d(
                ngf * mult, ngf * mult * 2, 3, strides=2, padding=1,
                use_bias=use_bias, **kw))
        res_channels = ngf * 2 ** n_downsampling
        for i in range(n_blocks):
            self.add_module(f"res_{i}", ResidualBlock(
                res_channels, padding_type=padding_type, norm=norm,
                activation=activation, use_bias=use_bias, **kw))
            if use_attention and i in tuple(attn_layers):
                self.add_module(f"attn_{i}", SelfAttention2d(res_channels, flash=attn_flash,
                                                             **kw))
            if use_channel_attn and i in tuple(channel_attn_layers):
                self.add_module(f"channel_attn_{i}", ChannelAttention(res_channels, **kw))
            if use_style_dropout:
                self.add_module(f"style_gate_{i}", StyleGate(res_channels))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"up_{i}", ConvTranspose2d(
                ngf * mult, ngf * mult // 2, 3, strides=2, padding=1,
                output_padding=1, use_bias=use_bias, **kw))
        # both reference lineages keep the bias on the output conv
        self.output_conv = Conv2d(ngf, output_nc, 7, padding=stem_pad,
                                  use_bias=True, **kw)

    def _trunk_block(self, h: torch.Tensor, i: int,
                     style_alpha: torch.Tensor | None) -> torch.Tensor:
        """Residual block i, then its variant blocks, each in its span
        (``variant.attn``, ``variant.channel``, ``variant.style``)."""
        h = getattr(self, f"res_{i}")(h)
        for name, span in ((f"attn_{i}", "variant.attn"), (f"channel_attn_{i}", "variant.channel")):
            if hasattr(self, name):
                with trace.span(span):
                    h = getattr(self, name)(h)
        if self.use_style_dropout:
            with trace.span("variant.style"):
                h = getattr(self, f"style_gate_{i}")(
                    h, None if style_alpha is None else style_alpha[i])
        return h

    def forward(self, x: torch.Tensor, extract: Sequence[int] | None = None,
                taps_only: bool = False, style_alpha: torch.Tensor | None = None):
        """``taps_only=True`` (with ``extract``) stops after the last
        existing tap and returns (None, feats): the train step's forward on
        the fake needs only the PatchNCE features. ``style_alpha``
        (n_blocks, B) holds the style gates' draws; without it, or without
        style dropout, the gates pass their input through."""
        if not self.use_style_dropout:
            style_alpha = None
        elif style_alpha is not None and style_alpha.shape != (self.n_blocks, x.shape[0]):
            raise ValueError(f"style_alpha must be ({self.n_blocks}, {x.shape[0]}), "
                             f"got {tuple(style_alpha.shape)}")
        tap_set = set(extract) if extract is not None else set()
        n_layers = 1 + 2 * self.n_down + self.n_blocks
        last = max((i for i in tap_set if i < n_layers), default=-1)
        feats: list[torch.Tensor] = []
        reflect = self.padding_type == "reflect"
        stages = [lambda h: self.act(_norm(self.initial_conv(
            pad_2d(h, 3, "reflect") if reflect else h), self.norm))]
        stages += [lambda h, i=i: self.act(_norm(getattr(self, f"down_{i}")(h), self.norm))
                   for i in range(self.n_down)]
        stages += [lambda h, i=i: self._trunk_block(h, i, style_alpha)
                   for i in range(self.n_blocks)]
        stages += [lambda h, i=i: self.act(_norm(getattr(self, f"up_{i}")(h), self.norm))
                   for i in range(self.n_down)]
        h = x.to(self.dtype)
        for layer_idx, stage in enumerate(stages):
            h = stage(h)
            if layer_idx in tap_set:
                feats.append(h)
            if taps_only and layer_idx == last:
                return None, feats
        out = pad_2d(h, 3, "reflect") if reflect else h
        out = torch.tanh(self.output_conv(out))
        if extract is not None:
            return out, feats
        return out
