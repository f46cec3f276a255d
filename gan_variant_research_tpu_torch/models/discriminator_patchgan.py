"""70x70 PatchGAN discriminator and its multiscale wrapper (NHWC).

Counterpart of ``gan_variant_research_tpu/models/discriminator_patchgan.py``:
4x4 convs with zero padding 1 and LeakyReLU 0.2, stride 2 for ``conv_0`` ..
``conv_{n_layers-1}``, stride 1 for ``conv_{n_layers}`` and the 1-channel
``conv_out``; ``norm='instance'`` puts an instance norm after the middle
convs, which then have no bias. Submodules carry the JAX names
(``scale_i.conv_n``), so ``convert.py`` maps one to one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan_variant_research_tpu_torch.models.layers import Conv2d
from gan_variant_research_tpu_torch.ops.kernels.instance_norm import instance_norm
from gan_variant_research_tpu_torch.ops.nn_ops import avg_pool_3x3_s2


def _lrelu(h: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(h, 0.2)


class PatchGANDiscriminator(nn.Module):
    """``forward(x)`` -> the (B, H', W', 1) logit map; with
    ``extract_features=True`` -> (logits, [post-LeakyReLU features])."""

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm: str = "none", use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if use_spectral_norm:
            raise NotImplementedError(
                "spectral norm is not ported yet (ROADMAP.md Queue 1, "
                "'Variant losses and D options')")
        if norm not in ("none", "instance"):
            raise ValueError(f"Unknown discriminator norm: {norm!r}")
        self.use_in = norm == "instance"
        self.n_layers = n_layers
        self.dtype = dtype
        kw = dict(kernel_size=4, padding=1, dtype=dtype, generator=generator)
        self.conv_0 = Conv2d(in_channels, ndf, strides=2, use_bias=True, **kw)
        c = ndf
        for n in range(1, n_layers):
            nf = ndf * min(2 ** n, 8)
            self.add_module(f"conv_{n}", Conv2d(c, nf, strides=2,
                                                use_bias=not self.use_in, **kw))
            c = nf
        nf = ndf * min(2 ** n_layers, 8)
        self.add_module(f"conv_{n_layers}", Conv2d(c, nf, strides=1,
                                                   use_bias=not self.use_in, **kw))
        self.conv_out = Conv2d(nf, 1, strides=1, use_bias=True, **kw)

    def forward(self, x: torch.Tensor, extract_features: bool = False):
        h = _lrelu(self.conv_0(x.to(self.dtype)))
        feats = [h]
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{n}")(h)
            if self.use_in:
                h = instance_norm(h)
            h = _lrelu(h)
            feats.append(h)
        logits = self.conv_out(h)
        if logits.shape[1] == 0 or logits.shape[2] == 0:
            raise ValueError(
                f"PatchGAN logit map is empty ({tuple(logits.shape)}): input "
                f"{x.shape[1]}x{x.shape[2]} is too small for n_layers={self.n_layers}")
        if extract_features:
            return logits, feats
        return logits


class MultiscaleDiscriminator(nn.Module):
    """``num_scales`` PatchGANs (``scale_i``) on an AvgPool(3, 2, 1) pyramid;
    returns the list of logit maps (and, with ``extract_features=True``, the
    per-scale feature lists)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, num_scales: int = 1,
                 norm: str = "none", use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_scales = num_scales
        for i in range(num_scales):
            self.add_module(f"scale_{i}", PatchGANDiscriminator(
                ndf=ndf, n_layers=n_layers, norm=norm,
                use_spectral_norm=use_spectral_norm, dtype=dtype,
                generator=generator))

    def forward(self, x: torch.Tensor, extract_features: bool = False):
        outputs, feats = [], []
        h = x
        for i in range(self.num_scales):
            if i > 0:
                h = avg_pool_3x3_s2(h)
            out = getattr(self, f"scale_{i}")(h, extract_features=extract_features)
            if extract_features:
                outputs.append(out[0])
                feats.append(out[1])
            else:
                outputs.append(out)
        if extract_features:
            return outputs, feats
        return outputs
