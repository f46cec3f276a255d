"""The benchmark's inputs from ``--seed``: weights, image rings, step draws.

Everything is drawn on the run's device by ``torch.Generator``s seeded
from the run's seed and a name, so a seed always gives the same inputs and
the reference can draw them again. Draws are plain dicts of tensors; the
drivers hand the program the same values in its own types.

Distributions (the ranges of the configurations' augmentations):

- CUT's ``train_augment``: crop scale U(0.85, 1), crop offsets U(0, 1) of
  the free room, flip with p 0.5, brightness, contrast and saturation
  factors U(0.95, 1.05), hue shift U(-0.02, 0.02);
- DiffAugment: the colour uniforms U(0, 1) (rounded to bf16 where the
  program draws them in bf16: D's fake and the G head), translation shifts
  of up to int(size / 8 + 0.5) pixels, cutout centres anywhere;
- PatchNCE: min(num_patches, H W) positions per tapped layer, with
  replacement;
- CycleGAN's crop: integer offsets in [0, load - crop], flip with p 0.5.
"""

from __future__ import annotations

import hashlib

import torch

from portbench.reference.nets import generator_spec, make_params, patchgan_spec

_OPS = {"color": ("brightness", "saturation", "contrast"), "translation": ("translation",),
        "cutout": ("cutout",), "cutout_light": ("cutout_light",)}
CUTOUT_RATIOS = {"cutout": 0.5, "cutout_light": 0.2}


def subseed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, name))


def image_ring(seed: int, name: str, ring: int, batch: int, size: int, device,
               smooth: int = 0) -> torch.Tensor:
    """(ring, batch, size, size, 3) uint8 images: uniform levels, or with
    ``smooth`` a uniform ``smooth`` x ``smooth`` field per channel resized
    bilinearly to ``size`` (no pixel noise)."""
    gen = generator(seed, name, device)
    if not smooth:
        return torch.randint(0, 256, (ring, batch, size, size, 3), dtype=torch.uint8,
                             generator=gen, device=device)
    field = torch.rand((ring * batch, 3, smooth, smooth), generator=gen, device=device)
    img = torch.nn.functional.interpolate(field, size=(size, size), mode="bilinear",
                                          align_corners=True)
    img = torch.round(img * 255.0).to(torch.uint8)
    return img.permute(0, 2, 3, 1).reshape(ring, batch, size, size, 3).contiguous()


def policy_ops(policy) -> list[str]:
    return [op for p in policy for op in _OPS.get(p, ())]


def _u(gen, n, lo=0.0, hi=1.0):
    return torch.rand((n,), generator=gen, device=gen.device) * (hi - lo) + lo


def _i(gen, n, lo, hi):
    return torch.randint(lo, hi, (n,), generator=gen, device=gen.device)


def cut_augment(gen, b: int) -> dict:
    return {"scales": _u(gen, b, 0.85, 1.0), "off_i": _u(gen, b), "off_j": _u(gen, b),
            "flip": _u(gen, b) < 0.5, "brightness": _u(gen, b, 0.95, 1.05),
            "contrast": _u(gen, b, 0.95, 1.05), "saturation": _u(gen, b, 0.95, 1.05),
            "hue": _u(gen, b, -0.02, 0.02)}


def diff_augment(gen, b: int, size: int, policy, bf16: bool) -> list:
    out = []
    for op in policy_ops(policy):
        if op in ("brightness", "saturation", "contrast"):
            u = _u(gen, b)
            out.append((op, (u.to(torch.bfloat16).float() if bf16 else u,)))
        elif op == "translation":
            s = int(size * 0.125 + 0.5)
            out.append((op, (_i(gen, b, -s, s + 1), _i(gen, b, -s, s + 1))))
        else:
            c = int(size * CUTOUT_RATIOS[op] + 0.5)
            out.append((op, (_i(gen, b, 0, size + (1 - c % 2)), _i(gen, b, 0, size + (1 - c % 2)))))
    return out


def cut_tap_hw(cfg: dict) -> list[int]:
    """H W of each tapped generator stage that exists, in stage order."""
    g = cfg["model"]["generator"]
    size, n_down, n_blocks = cfg["image_size"], g["n_downsampling"], g["n_blocks"]
    sizes = ([size] + [size >> i for i in range(1, n_down + 1)] + [size >> n_down] * n_blocks
             + [size >> (n_down - 1 - i) for i in range(n_down)])
    return [sizes[i] ** 2 for i in sorted(set(cfg["patchnce"]["nce_layers"])) if 0 <= i < len(sizes)]


def cut_step(gen, cfg: dict, b: int) -> dict:
    """One CUT step's draws (``compute bf16``: the fake's DiffAugment
    colours rounded to bf16)."""
    size = cfg["image_size"]
    policy = cfg["diffaugment"]["policy"] if cfg["diffaugment"]["enable"] else []
    bf16 = cfg["runtime"]["precision"] == "bf16"
    n = cfg["patchnce"]["num_patches"]
    return {"photo_aug": cut_augment(gen, b), "monet_aug": cut_augment(gen, b),
            "da_real": diff_augment(gen, b, size, policy, False),
            "da_fake": diff_augment(gen, b, size, policy, bf16),
            "da_g": diff_augment(gen, b, size, policy, bf16),
            "nce": [_i(gen, min(n, hw), 0, hw) for hw in cut_tap_hw(cfg)]}


def cyclegan_step(gen, cfg: dict, b: int) -> dict:
    load, crop = cfg["data"]["load_size"], cfg["data"]["img_size"]
    aug = lambda: {"off_i": _i(gen, b, 0, load - crop + 1),  # noqa: E731
                   "off_j": _i(gen, b, 0, load - crop + 1), "flip": _u(gen, b) < 0.5}
    return {"aug_a": aug(), "aug_b": aug()}


def half(d, b: int):
    """The draws of the first half of a batch of ``b`` (every per-sample
    tensor cut to b // 2; PatchNCE's positions are the batch's)."""
    if isinstance(d, dict):
        return {k: v if k == "nce" else half(v, b) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(half(v, b) for v in d)
    if isinstance(d, torch.Tensor) and d.dim() == 1 and d.shape[0] == b:
        return d[: b // 2]
    return d


# --------------------------------------------------------------------------- #
# weights

def cut_weights(seed: int, cfg: dict, device) -> dict:
    """CUT's G and D (one discriminator scale, ``scale_0.``), each in one
    draw."""
    g, d = cfg["model"]["generator"], cfg["model"]["discriminator"]
    g_spec = generator_spec(g["ngf"], g["n_blocks"], g["n_downsampling"], True)
    d_spec = patchgan_spec(d["ndf"], d["n_layers"], d["norm"], "scale_0.")
    return {"g": make_params(g_spec, generator(seed, "weights.g", device), device),
            "d": make_params(d_spec, generator(seed, "weights.d", device), device)}


def cyclegan_weights(seed: int, cfg: dict, device) -> dict:
    """CycleGAN's bias-free generators and instance-norm discriminators."""
    m = cfg["model"]
    g_spec = generator_spec(m["ngf"], m["n_blocks"], 2, False)
    d_spec = patchgan_spec(m["ndf"], 3, "instance")
    return {name: make_params(g_spec if name.startswith("G") else d_spec,
                              generator(seed, f"weights.{name}", device), device)
            for name in ("G_A2B", "G_B2A", "D_A", "D_B")}
