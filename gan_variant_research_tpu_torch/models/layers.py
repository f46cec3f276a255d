"""Conv layers and padding/activation helpers with the JAX package's
semantics. Counterpart of ``gan_variant_research_tpu/models/layers.py``.

Activations are NHWC at every function here, as in the JAX package. A conv
views its input as an NCHW tensor in ``torch.channels_last`` (a permute, no
copy), and its output back as NHWC. Parameters are float32 in PyTorch's own
layouts and are cast to the compute dtype at use:

- ``Conv2d.weight`` is OIHW (the JAX kernel is HWIO);
- ``ConvTranspose2d.weight`` is (in, out, kh, kw), the JAX correlation
  kernel unflipped and transposed (``convert.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan_variant_research_tpu_torch.ops.nn_ops import uniform_fan_in_


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Module):
    """torch.nn.Conv2d semantics on NHWC tensors: symmetric zero
    ``padding``, PyTorch's default init, the bias added after the conv in the
    compute dtype. The space-to-depth schedule of the JAX package is a TPU
    reparametrisation with the same parameters, so it has no counterpart."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, padding: int = 0, use_bias: bool = True,
                 use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if use_spectral_norm:
            raise NotImplementedError(
                "spectral norm is not ported yet (ROADMAP.md Queue 1, "
                "'Variant losses and D options')")
        self.strides = strides
        self.padding = padding
        self.dtype = dtype
        fan_in = kernel_size * kernel_size * in_channels
        self.weight = nn.Parameter(uniform_fan_in_(
            torch.empty(features, in_channels, kernel_size, kernel_size),
            fan_in, generator))
        self.bias = (nn.Parameter(uniform_fan_in_(torch.empty(features), fan_in,
                                                  generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(_to_nchw(x), self.weight.to(self.dtype), None,
                     self.strides, self.padding)
        y = _to_nhwc(y)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class ConvTranspose2d(nn.Module):
    """torch.nn.ConvTranspose2d(k, stride, padding, output_padding) on NHWC
    tensors. The JAX layer correlates the stride-dilated input, padded by
    (k-1-p, k-1-p+output_padding), with a flipped HWIO kernel; with the
    weight in PyTorch's (in, out, kh, kw) layout that is exactly
    ``F.conv_transpose2d``. Init: U(+-1/sqrt(kh*kw*out)), PyTorch's rule."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 2, padding: int = 1, output_padding: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.strides = strides
        self.padding = padding
        self.output_padding = output_padding
        self.dtype = dtype
        fan_in = kernel_size * kernel_size * features
        self.weight = nn.Parameter(uniform_fan_in_(
            torch.empty(in_channels, features, kernel_size, kernel_size),
            fan_in, generator))
        self.bias = (nn.Parameter(uniform_fan_in_(torch.empty(features), fan_in,
                                                  generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(_to_nchw(x), self.weight.to(self.dtype), None,
                               self.strides, self.padding, self.output_padding)
        y = _to_nhwc(y)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


_PAD_MODES = {"reflect": "reflect", "replicate": "replicate", "zero": "constant"}


def pad_2d(x: torch.Tensor, pad: int, padding_type: str) -> torch.Tensor:
    """reflect / replicate / zero spatial padding of an NHWC tensor."""
    if padding_type not in _PAD_MODES:
        raise ValueError(f"Unknown padding_type: {padding_type!r}")
    if pad == 0:
        return x
    y = F.pad(_to_nchw(x), (pad, pad, pad, pad), mode=_PAD_MODES[padding_type])
    return _to_nhwc(y)


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return torch.relu
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.2)
    if name in ("none", "identity"):
        return lambda x: x
    raise ValueError(f"Unknown activation: {name!r}")
