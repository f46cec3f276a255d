"""The U-Net CycleGAN's model FLOPs from shapes, as ``flops.py`` counts them.

A conv's FLOPs are 2 x MACs; a stride-2 transposed conv takes every input
pixel through its k^2 kernel; a training pass counts 3 x its forward. The
step's passes are ``flops.cyclegan_step_flops``': three G applies of 2b,
3b and b images with their backward, D_A and D_B on the fakes with their
input gradients and the two D steps on 2b images each. Norms, pads,
concatenations and elementwise work are left out.
"""

from __future__ import annotations

from portbench.work.flops import conv_flops, discriminator_fwd_flops


def unet_layer_flops(image_size: int, ngf: int = 64, output_nc: int = 3) -> list[float]:
    """Forward FLOPs per image of each U-Net conv in the order it runs: the
    stem, 4 downs, 2 bottleneck convs, then each transposed conv and its
    reduce, then the output conv."""
    s = image_size
    widths = [ngf, 2 * ngf, 4 * ngf, 8 * ngf, 8 * ngf]
    layers = [conv_flops(s, s, 3, ngf, 7)]
    for c_in, c_out in zip(widths, widths[1:]):
        s //= 2
        layers.append(conv_flops(s, s, c_in, c_out, 3))
    layers += [conv_flops(s, s, 8 * ngf, 8 * ngf, 3)] * 2
    c = 8 * ngf
    for out in reversed(widths[:4]):           # 8, 4, 2, 1 ngf: the skip's width
        layers.append(2.0 * s * s * c * out * 9)
        s *= 2
        layers.append(conv_flops(s, s, 2 * out, out, 3))
        c = out
    layers.append(conv_flops(s, s, c, output_nc, 7))
    return layers


def unet_fwd_flops(image_size: int, ngf: int = 64) -> float:
    return sum(unet_layer_flops(image_size, ngf))


def cyclegan_unet_step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one CycleGAN step on the U-Net at ``batch``."""
    size, m = int(cfg["data"]["img_size"]), cfg["model"]
    g = unet_fwd_flops(size, m["ngf"])
    d = discriminator_fwd_flops(size, m["ndf"], m.get("n_layers", 3))
    return batch * (3 * 6 * g + (2 * 2 + 2 * 2 * 3) * d)
