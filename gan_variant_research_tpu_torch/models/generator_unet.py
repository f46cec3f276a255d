"""U-Net generator, the CycleGAN option ``model.generator: unet`` (NHWC).

Counterpart of ``gan_variant_research_tpu/models/generator_unet.py``: 7x7
stem (ngf) -> four stride-2 downsamplings (2, 4, 8, 8 ngf) -> two 3x3
bottleneck convs (8 ngf) -> four stride-2 transposed convs, each followed
by a skip concatenation and a 3x3 reduce conv (8, 4, 2, 1 ngf) -> 7x7 conv
to 3 channels + tanh. Every conv is followed by the notebook's *affine*
instance norm and a ReLU, the last one excepted.

Submodules carry the flax auto-names (``_SameConv_i`` holding ``Conv_0``,
``ConvTranspose_i``, ``AffineInstanceNorm_i``, numbered in the order the
JAX module creates them), so ``convert.py`` maps one to one. Padding follows
flax's ``'SAME'``:

- a conv pads ``k - 1`` in all at stride 1 and ``(ceil(n / s) - 1) * s + k
  - n`` at stride s, the lower side taking the floor of half: at k 3,
  stride 2 and an even size that is (0, 1), which ``F.pad`` gives before a
  conv with ``padding=0``;
- the transposed conv (``transpose_kernel=False``) correlates the
  stride-dilated input, padded (2, 1), with the kernel as it is: torch's
  ``conv_transpose2d`` with ``padding=0`` on the spatially flipped kernel in
  (in, out, kh, kw) order (``convert._hwio_to_convtranspose``) gives the
  same values on its first 2H rows and columns (it pads (2, 2)).

Every conv is cuDNN on the card. Each norm and the ReLU after it is
``ops/kernels/instance_norm.py::affine_instance_norm``: the hand-written
affine kernels for a bf16 CUDA tensor, the stock float32 chain otherwise
(counters ``unet.norm.{fwd,bwd}.{kernel,plain}``). Its spans
(``core/trace.py``): one apply is ``unet.encoder`` (stem and four downs),
``unet.bottleneck`` and ``unet.decoder`` (the ups, skip concatenations,
reduces and output conv); each ``AffineInstanceNorm`` forward is a
``unet.norm`` span inside them and adds 1 to the counter ``unet.norm`` (15
an apply). The norms' backward runs on autograd's thread, outside any span.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.models.layers import Conv2d
from gan_variant_research_tpu_torch.ops.kernels import instance_norm

# the JAX module's count of each submodule
N_CONVS, N_UPS, N_NORMS = 12, 4, 15


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``glorot_uniform``, in place: U(+-sqrt(6 / (fan_in + fan_out)))."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax / XLA ``'SAME'`` padding of one spatial dim: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class AffineInstanceNorm(nn.Module):
    """Instance norm over H, W with learnable ``gamma`` / ``beta``, in float32
    (biased variance, eps 1e-5), cast back to the input dtype, then the ReLU
    if ``relu``. The forward is a ``unet.norm`` span and counts
    ``unet.norm``; the backward, on autograd's thread, is in no span."""

    def __init__(self, channels: int, eps: float = 1e-5, relu: bool = False):
        super().__init__()
        self.eps, self.relu = eps, relu
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trace.count("unet.norm")
        with trace.span("unet.norm"):
            return instance_norm.affine_instance_norm(x, self.gamma, self.beta, self.eps,
                                                      self.relu)


class _SameConv(nn.Module):
    """Keras ``Conv2D(padding='same')``: flax's ``'SAME'`` pads, then
    ``Conv_0`` (OIHW ``weight``, ``bias``; glorot-uniform init, zero bias)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_size, self.strides = kernel_size, strides
        self.Conv_0 = Conv2d(in_channels, features, kernel_size, strides=strides, padding=0,
                             dtype=dtype, generator=generator)
        area = kernel_size * kernel_size
        glorot_uniform_(self.Conv_0.weight, area * in_channels, area * features, generator)
        with torch.no_grad():
            self.Conv_0.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.strides
        (top, bottom), (left, right) = (same_padding(n, k, s) for n in x.shape[1:3])
        return self.Conv_0(F.pad(x, (0, 0, left, right, top, bottom)))


class _SameConvTranspose(nn.Module):
    """flax ``ConvTranspose(features, (3, 3), strides=(2, 2), 'SAME')``:
    ``weight`` (in, out, kh, kw) is the flax kernel flipped in space,
    ``bias`` float32; the output is 2H x 2W."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 2, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_channels, features, kernel_size, kernel_size))
        area = kernel_size * kernel_size
        glorot_uniform_(self.weight, area * in_channels, area * features, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        s = self.strides
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(self.dtype), None, s)
        y = y[:, :, :h * s, :w * s].permute(0, 2, 3, 1).contiguous()
        return y + self.bias.to(self.dtype)


class UNetGenerator(nn.Module):
    """``forward(x)`` -> image in [-1, 1], both NHWC, in the compute dtype."""

    def __init__(self, ngf: int = 64, output_nc: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        convs = [(3, ngf, 7, 1), (ngf, 2 * ngf, 3, 2), (2 * ngf, 4 * ngf, 3, 2),
                 (4 * ngf, 8 * ngf, 3, 2), (8 * ngf, 8 * ngf, 3, 2),
                 (8 * ngf, 8 * ngf, 3, 1), (8 * ngf, 8 * ngf, 3, 1),
                 (16 * ngf, 8 * ngf, 3, 1), (8 * ngf, 4 * ngf, 3, 1),
                 (4 * ngf, 2 * ngf, 3, 1), (2 * ngf, ngf, 3, 1), (ngf, output_nc, 7, 1)]
        for i, (c_in, c_out, k, s) in enumerate(convs):
            self.add_module(f"_SameConv_{i}", _SameConv(c_in, c_out, k, s, **kw))
        ups = [(8 * ngf, 8 * ngf), (8 * ngf, 4 * ngf), (4 * ngf, 2 * ngf), (2 * ngf, ngf)]
        for i, (c_in, c_out) in enumerate(ups):
            self.add_module(f"ConvTranspose_{i}", _SameConvTranspose(c_in, c_out, **kw))
        # the norms in creation order: stem, 4 downs, 2 bottleneck convs, then
        # each up and its reduce conv; each with the ReLU that follows it
        norms = [ngf, 2 * ngf, 4 * ngf, 8 * ngf, 8 * ngf, 8 * ngf, 8 * ngf]
        norms += [c for _, c_out in ups for c in (c_out, c_out)]
        for i, c in enumerate(norms):
            self.add_module(f"AffineInstanceNorm_{i}", AffineInstanceNorm(c, relu=True))

    def _conv_block(self, h: torch.Tensor, conv: nn.Module, norm: int) -> torch.Tensor:
        return getattr(self, f"AffineInstanceNorm_{norm}")(conv(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = lambda i: getattr(self, f"_SameConv_{i}")  # noqa: E731
        h = x.to(self.dtype)
        skips = []
        with trace.span("unet.encoder"):                     # stem, 4 downs
            for i in range(5):
                h = self._conv_block(h, conv(i), i)
                skips.append(h)
        with trace.span("unet.bottleneck"):
            for i in (5, 6):
                h = self._conv_block(h, conv(i), i)
        with trace.span("unet.decoder"):                     # up, concat, reduce
            for i in range(N_UPS):
                h = self._conv_block(h, getattr(self, f"ConvTranspose_{i}"), 7 + 2 * i)
                h = torch.cat([h, skips[3 - i]], dim=-1)
                h = self._conv_block(h, conv(7 + i), 8 + 2 * i)
            return torch.tanh(conv(11)(h))
