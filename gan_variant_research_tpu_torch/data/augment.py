"""Training augmentation on the device, on injected random draws.

Counterpart of ``gan_variant_research_tpu/data/augment.py``:

- ``train_augment`` (CUT): uint8 NHWC -> [0, 1] -> per-sample crop (side
  s * min(H, W), continuous offset) + antialiased cubic resize as two dense
  resampling products -> clip -> horizontal flip -> colour jitter
  (brightness, contrast, saturation, hue, in that order) -> [-1, 1];
- ``cyclegan_augment`` (CycleGAN, Basic_GAN's train transform after the
  host's resize to ``load_size``): an integer-offset crop of ``crop``^2 ->
  horizontal flip -> [-1, 1].

All float32.

The JAX functions draw from their key; here every random number comes in an
``AugmentDraws`` or a ``CropFlipDraws`` (``core/prng.py`` samples them, the
tests fill them from ``jax.random`` under the JAX key splits).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AugmentDraws:
    """Per-sample draws, each of shape (B,): crop ``scales`` in the scale
    range; ``off_i``, ``off_j`` uniform in [0, 1), the crop offset as a
    fraction of the free room; ``flip`` bool; jitter factors ``brightness``,
    ``contrast``, ``saturation`` (around 1) and the ``hue`` shift."""

    scales: torch.Tensor
    off_i: torch.Tensor
    off_j: torch.Tensor
    flip: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor


@dataclasses.dataclass
class CropFlipDraws:
    """CycleGAN's per-sample draws, each of shape (B,): the crop's integer
    offsets ``off_i``, ``off_j`` in [0, H - crop] and [0, W - crop], and
    ``flip`` bool."""

    off_i: torch.Tensor
    off_j: torch.Tensor
    flip: torch.Tensor


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), torch.zeros_like(maxc))
    safe = delta.clamp_min(1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]

    def channel(n: float) -> torch.Tensor:
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


def _luma(x01: torch.Tensor) -> torch.Tensor:
    return 0.299 * x01[..., 0:1] + 0.587 * x01[..., 1:2] + 0.114 * x01[..., 2:3]


def color_jitter(x01: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor,
                 saturation: torch.Tensor, hue: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter on [0, 1] floats with per-sample factors
    (B,) and hue shifts (B,); a factor of ``None`` skips that op."""
    col = lambda f: f.view(-1, 1, 1, 1)
    if brightness is not None:
        x01 = torch.clamp(x01 * col(brightness), 0.0, 1.0)
    if contrast is not None:
        f = col(contrast)
        mean = _luma(x01).mean(dim=(1, 2, 3), keepdim=True)
        x01 = torch.clamp(f * x01 + (1.0 - f) * mean, 0.0, 1.0)
    if saturation is not None:
        f = col(saturation)
        x01 = torch.clamp(f * x01 + (1.0 - f) * _luma(x01), 0.0, 1.0)
    if hue is not None:
        hsv = _rgb_to_hsv(x01)
        h = torch.remainder(hsv[..., 0] + hue.view(-1, 1, 1), 1.0)
        x01 = _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))
    return x01


def _cubic_kernel(t: torch.Tensor) -> torch.Tensor:
    """Keys cubic, a = -0.5."""
    a = -0.5
    at = t.abs()
    at2 = at * at
    at3 = at2 * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
    return torch.where(at <= 1.0, w1, torch.where(at < 2.0, w2, torch.zeros_like(t)))


def _resample_weights(src: torch.Tensor, n_in: int, aa: torch.Tensor) -> torch.Tensor:
    """Row-normalised antialiased cubic weights, dense (B, S_out, n_in)."""
    i = torch.arange(n_in, dtype=torch.float32, device=src.device)[None, None, :]
    aa = aa[:, None, None]
    w = _cubic_kernel((src[:, :, None] - i) / aa) / aa
    return w / w.sum(dim=-1, keepdim=True)


def random_crop_resize(x01: torch.Tensor, out_size: int, scales: torch.Tensor,
                       off_i: torch.Tensor, off_j: torch.Tensor) -> torch.Tensor:
    """Per-sample crop of side ``scales * min(H, W)`` at offsets
    ``off * (size - crop)``, resized to ``out_size``^2 with antialiased cubic
    weights (antialiasing on downscale only)."""
    _, h, w, _ = x01.shape
    crop = scales * float(min(h, w))
    oi = off_i * (h - crop)
    oj = off_j * (w - crop)
    o = (torch.arange(out_size, dtype=torch.float32, device=x01.device) + 0.5)[None, :]
    ratio = (crop / out_size)[:, None]
    src_i = oi[:, None] + o * ratio - 0.5
    src_j = oj[:, None] + o * ratio - 0.5
    aa = torch.clamp(crop / out_size, min=1.0)
    w_rows = _resample_weights(src_i, h, aa)
    w_cols = _resample_weights(src_j, w, aa)
    y = torch.einsum("boh,bhwc->bowc", w_rows, x01)
    return torch.einsum("bow,bswc->bsoc", w_cols, y)


def random_hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the samples where ``flip`` (B,) is true."""
    return torch.where(flip.view(-1, 1, 1, 1), x.flip(2), x)


def train_augment(images_u8: torch.Tensor, image_size: int,
                  draws: AugmentDraws) -> torch.Tensor:
    """uint8 NHWC batch -> augmented float32 batch in [-1, 1]."""
    x01 = images_u8.float() / 255.0
    x01 = random_crop_resize(x01, image_size, draws.scales, draws.off_i, draws.off_j)
    x01 = torch.clamp(x01, 0.0, 1.0)
    x01 = random_hflip(x01, draws.flip)
    x01 = color_jitter(x01, draws.brightness, draws.contrast, draws.saturation, draws.hue)
    return x01 * 2.0 - 1.0


def cyclegan_augment(images_u8: torch.Tensor, crop_size: int,
                     draws: CropFlipDraws) -> torch.Tensor:
    """uint8 NHWC batch at the load size -> float32 batch of ``crop_size``^2
    in [-1, 1]: each sample's crop at its offsets, then its flip."""
    b = images_u8.shape[0]
    span = torch.arange(crop_size, device=images_u8.device)
    rows = draws.off_i.to(images_u8.device).view(b, 1) + span
    cols = draws.off_j.to(images_u8.device).view(b, 1) + span
    batch = torch.arange(b, device=images_u8.device).view(b, 1, 1)
    x01 = images_u8[batch, rows[:, :, None], cols[:, None, :]].float() / 255.0
    x01 = random_hflip(x01, draws.flip.to(images_u8.device))
    return x01 * 2.0 - 1.0
