"""Core NN primitives with the JAX package's semantics, NHWC layout.

Counterpart of ``gan_variant_research_tpu/ops/nn_ops.py``: instance norm
(no affine, biased variance, eps 1e-5), the U-Net's affine instance norm
(its chain from ``models/generator_unet.py``), reflection padding, and the
PyTorch-default conv initialisers, U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over the spatial dims of an NHWC tensor, no affine.

    The JAX formula, so bf16 rounds at the same places: float32 mean and
    E[x^2], ``var = max(E[x^2] - mean^2, 0)``, and the normalisation applied
    in the input dtype as ``x * scale - offset``. (``F.instance_norm``
    normalises in float32 and rounds once, which differs in bf16.)"""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    mean_sq = xf.square().mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = inv.to(x.dtype)
    offset = (mean * inv).to(x.dtype)
    return x * scale - offset


def affine_instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """The U-Net's affine instance norm of an NHWC tensor over H and W, as
    the JAX package's ``models/generator_unet.py::AffineInstanceNorm``:
    float32 mean and centred biased variance, ``gamma * (x - mean) *
    rsqrt(var + eps) + beta`` in float32, cast back to x's dtype once."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (gamma.float() * out + beta.float()).to(x.dtype)


def reflect_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d for an NHWC tensor; the result is NHWC contiguous."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1).contiguous()


def uniform_fan_in_(t: torch.Tensor, fan_in: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """PyTorch's default conv weight and bias init, in place:
    kaiming_uniform(a=sqrt(5)) on the weight and the bias rule both come to
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride 2, padding 1, count_include_pad=False) on NHWC,
    the multiscale discriminator's downsampler."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1, count_include_pad=False)
    return y.permute(0, 2, 3, 1).contiguous()
