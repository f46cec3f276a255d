"""The U-Net CycleGAN's weights from ``--seed``, beside ``draws.py``.

``unet_spec`` names the U-Net's parameters in the program's state-dict
names (``models/generator_unet.py``), each with the range it is drawn
from:

- every conv and transposed-conv weight glorot-uniform, U(+-sqrt(6 /
  (fan_in + fan_out))) with k^2 in and k^2 out channels, as the program
  initialises them;
- every conv bias from U(-0.2, 0.2), each norm's ``gamma`` from U(0.5, 1.5)
  and ``beta`` from U(-0.5, 0.5): away from the program's init (0, 1, 0),
  so that the affine and the output conv's bias are on the path. The
  biases ahead of a norm cancel in it: their gradient is nought.

``cyclegan_unet_weights`` draws each generator in one draw from a stream of
its own and the discriminators as ``draws.cyclegan_weights`` does.
"""

from __future__ import annotations

import math

import torch

from portbench import draws as D
from portbench.reference.nets import make_params, patchgan_spec

BIAS = (-0.2, 0.2)
GAMMA = (0.5, 1.5)
BETA = (-0.5, 0.5)


def unet_spec(ngf: int = 64, output_nc: int = 3) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, (lo, hi)) of every U-Net parameter, in the program's
    order: the 12 convs (OIHW), the 4 transposed convs ((in, out, kh, kw)),
    the 15 norms."""
    convs = [(3, ngf, 7), (ngf, 2 * ngf, 3), (2 * ngf, 4 * ngf, 3), (4 * ngf, 8 * ngf, 3),
             (8 * ngf, 8 * ngf, 3), (8 * ngf, 8 * ngf, 3), (8 * ngf, 8 * ngf, 3),
             (16 * ngf, 8 * ngf, 3), (8 * ngf, 4 * ngf, 3), (4 * ngf, 2 * ngf, 3),
             (2 * ngf, ngf, 3), (ngf, output_nc, 7)]
    ups = [(8 * ngf, 8 * ngf), (8 * ngf, 4 * ngf), (4 * ngf, 2 * ngf), (2 * ngf, ngf)]
    norms = [ngf, 2 * ngf, 4 * ngf, 8 * ngf, 8 * ngf, 8 * ngf, 8 * ngf]
    norms += [c for _, c_out in ups for c in (c_out, c_out)]

    def glorot(c_in, c_out, k):
        b = math.sqrt(6.0 / (k * k * (c_in + c_out)))
        return -b, b

    spec = []
    for i, (c_in, c_out, k) in enumerate(convs):
        spec += [(f"_SameConv_{i}.Conv_0.weight", (c_out, c_in, k, k), glorot(c_in, c_out, k)),
                 (f"_SameConv_{i}.Conv_0.bias", (c_out,), BIAS)]
    for i, (c_in, c_out) in enumerate(ups):
        spec += [(f"ConvTranspose_{i}.weight", (c_in, c_out, 3, 3), glorot(c_in, c_out, 3)),
                 (f"ConvTranspose_{i}.bias", (c_out,), BIAS)]
    for i, c in enumerate(norms):
        spec += [(f"AffineInstanceNorm_{i}.gamma", (c,), GAMMA),
                 (f"AffineInstanceNorm_{i}.beta", (c,), BETA)]
    return spec


def unet_params(spec, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Every parameter of ``spec`` from its range, in one draw on ``device``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    per = lambda i: torch.repeat_interleave(  # noqa: E731
        torch.tensor([r[i] for _, _, r in spec], device=device), torch.tensor(sizes, device=device))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    flat = per(0) + u * (per(1) - per(0))
    return {name: t.view(shape) for (name, shape, _), t in zip(spec, flat.split(sizes))}


def cyclegan_unet_weights(seed: int, cfg: dict, device) -> dict:
    """The two U-Nets and the two instance-norm PatchGANs."""
    m = cfg["model"]
    g_spec = unet_spec(m["ngf"])
    d_spec = patchgan_spec(m["ndf"], 3, "instance")
    out = {}
    for name in ("G_A2B", "G_B2A", "D_A", "D_B"):
        gen = D.generator(seed, f"weights.{name}", device)
        out[name] = (unet_params(g_spec, gen, device) if name.startswith("G")
                     else make_params(d_spec, gen, device))
    return out
