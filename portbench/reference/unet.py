"""The plain reference U-Net generator and its CycleGAN step, float32.

Written from the U-Net generator of the TF/Keras notebook
``GAN_baseline_Sujit.ipynb`` (cell 4; U-Net, Ronneberger et al. 2015,
arXiv 1505.04597, trained as CycleGAN, Zhu et al. 2017, arXiv
1703.10593) on NCHW tensors with ``torch.nn.functional`` alone:

- a 7 x 7 stem at ngf, four stride-2 3 x 3 downs (2, 4, 8, 8 ngf), two
  3 x 3 bottleneck convs (8 ngf);
- four stride-2 3 x 3 transposed convs (8, 4, 2, 1 ngf), each followed by
  the concatenation of the encoder's output at that size and a 3 x 3
  reduce conv to the transposed conv's width;
- a 7 x 7 conv to 3 channels and tanh;
- after every conv but the last, the notebook's affine instance norm (the
  mean and biased variance over H, W in float32, eps 1e-5, then gamma x
  + beta per channel) and a ReLU.

Parameters come as a dict under the program's state-dict names
(``_SameConv_i.Conv_0.{weight,bias}`` OIHW, ``ConvTranspose_i.{weight,
bias}`` in torch's (in, out, kh, kw) order, ``AffineInstanceNorm_i.{gamma,
beta}``), numbered as the program numbers them. ``cast`` is the convs'
precision, as ``nets.conv`` takes it. The drivers run it under
``measure.full_precision`` (TF32 off), as the other references.

Departures from the notebook, each the program's too:

- Keras ``padding='same'`` is written as flax's ``'SAME'``: at stride 2
  and an even size the lower side takes the floor of half the padding,
  which is (0, 1) at k 3 (Keras agrees on the split);
- the transposed conv is flax's ``ConvTranspose(strides 2, 'SAME')``
  without ``transpose_kernel``: the input dilated with zeros, padded (2, 1)
  and correlated with the kernel in its flax form. That form is the
  program's weight un-flipped in space (the program flips it once at
  conversion, for ``conv_transpose2d``), so the reference checks the flip;
- the CycleGAN step keeps the configuration's loss (``baseline_tpu.yaml``:
  LSGAN; the notebook trains with BCE) and its one Adam over both
  generators with the epoch decay (``steps.CycleGAN``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import nets
from portbench.reference.steps import CycleGAN

EPS = 1e-5
# (conv index, kernel, stride) of the encoder and the bottleneck, in order
ENCODER = ((0, 7, 1), (1, 3, 2), (2, 3, 2), (3, 3, 2), (4, 3, 2))
BOTTLENECK = ((5, 3, 1), (6, 3, 1))
N_UPS = 4


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax ``'SAME'`` padding of one dim: (low, high), low the floor of
    half."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def affine_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    x = x.float()
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    xhat = (x - mean) / torch.sqrt(var + EPS)
    return gamma.view(1, -1, 1, 1) * xhat + beta.view(1, -1, 1, 1)


def same_conv(p: dict, i: int, x: torch.Tensor, k: int, stride: int = 1,
              cast=nets.FP32) -> torch.Tensor:
    """``_SameConv_i``: zero pads as ``same_pad``, then the conv and its
    bias."""
    top, bottom = same_pad(x.shape[2], k, stride)
    left, right = same_pad(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    name = f"_SameConv_{i}.Conv_0."
    return nets.conv(x, p[name + "weight"], p[name + "bias"], stride, 0, cast)


def conv_transpose(p: dict, i: int, x: torch.Tensor, cast=nets.FP32) -> torch.Tensor:
    """``ConvTranspose_i``, stride 2, 3 x 3, 'SAME': x dilated with zeros
    (a zero between neighbours), padded (2, 1) on each spatial dim, and
    correlated with the flax kernel (the program's weight flipped back in
    space, as OIHW): 2H x 2W out."""
    n, c, h, w = x.shape
    dilated = x.new_zeros((n, c, 2 * h - 1, 2 * w - 1))
    dilated[:, :, ::2, ::2] = x
    dilated = F.pad(dilated, (2, 1, 2, 1))
    weight = p[f"ConvTranspose_{i}.weight"].flip(2, 3).transpose(0, 1)
    return nets.conv(dilated, weight, p[f"ConvTranspose_{i}.bias"], 1, 0, cast)


def generator(p: dict, x: torch.Tensor, cast=nets.FP32) -> torch.Tensor:
    """The U-Net on NCHW ``x`` in [-1, 1]: the image in [-1, 1]."""
    def block(h, norm):
        return torch.relu(affine_norm(h, p[f"AffineInstanceNorm_{norm}.gamma"],
                                      p[f"AffineInstanceNorm_{norm}.beta"]))

    h, skips = x, []
    for i, k, s in ENCODER:
        h = block(same_conv(p, i, h, k, s, cast), i)
        skips.append(h)
    for i, k, s in BOTTLENECK:
        h = block(same_conv(p, i, h, k, s, cast), i)
    for i in range(N_UPS):
        h = block(conv_transpose(p, i, h, cast), 7 + 2 * i)
        h = torch.cat([h, skips[3 - i]], dim=1)
        h = block(same_conv(p, 7 + i, h, 3, 1, cast), 8 + 2 * i)
    return torch.tanh(same_conv(p, 11, h, 7, 1, cast))


class CycleGANUNet(CycleGAN):
    """``steps.CycleGAN`` (its six unbatched generator applies, losses,
    Adams and decay) on the U-Net generator."""

    def G(self, p, x):
        return generator(p, x, self.cast)
