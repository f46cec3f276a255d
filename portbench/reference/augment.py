"""The plain reference's augmentations on given draws, float32, NCHW out.

- ``train_augment`` (CUT): uint8 NHWC -> [0, 1] -> a crop of side
  s * min(H, W) at a continuous offset, resized with antialiased Keys cubic
  weights (a = -0.5) -> clip -> horizontal flip -> colour jitter
  (brightness, contrast, saturation, hue, in torchvision's order) ->
  [-1, 1];
- ``cyclegan_augment``: an integer-offset crop -> flip -> [-1, 1];
- ``diff_augment`` (Zhao et al. 2020, DiffAugment): brightness,
  saturation, contrast, translation (zero fill) and cutout, one op after
  the other, each on its own draws.

Draws are dicts of per-sample tensors (``portbench/draws.py`` makes
them); DiffAugment's are a list of (op, values) in policy order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CUTOUT_RATIOS = {"cutout": 0.5, "cutout_light": 0.2}


def _keys_cubic(t: torch.Tensor) -> torch.Tensor:
    a = -0.5
    at = t.abs()
    near = (a + 2.0) * at ** 3 - (a + 3.0) * at ** 2 + 1.0
    far = a * at ** 3 - 5.0 * a * at ** 2 + 8.0 * a * at - 4.0 * a
    return torch.where(at <= 1.0, near, torch.where(at < 2.0, far, torch.zeros_like(t)))


def _resize_matrix(offset: float, crop: float, n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights sampling [offset, offset + crop) at n_out
    half-pixel centres, antialiased (the kernel widened) when shrinking,
    each row summing to 1."""
    scale = crop / n_out
    centres = offset + (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * scale - 0.5
    aa = max(scale, 1.0)
    src = torch.arange(n_in, dtype=torch.float64, device=device)
    w = _keys_cubic((centres[:, None] - src[None, :]) / aa) / aa
    return (w / w.sum(dim=1, keepdim=True)).float()


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    v = x.amax(dim=1)
    delta = v - x.amin(dim=1)
    s = torch.where(v > 0, delta / v.clamp_min(1e-12), torch.zeros_like(v))
    d = delta.clamp_min(1e-12)
    h = torch.where(v == r, (v - b) / d - (v - g) / d,
                    torch.where(v == g, 2.0 + (v - r) / d - (v - b) / d,
                                4.0 + (v - g) / d - (v - r) / d))
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    return torch.stack([torch.remainder(h / 6.0, 1.0), s, v], dim=1)


def _hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x[:, 0], x[:, 1], x[:, 2]
    out = []
    for n in (5.0, 3.0, 1.0):
        k = torch.remainder(n + h * 6.0, 6.0)
        out.append(v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0))
    return torch.stack(out, dim=1)


def _luma(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


def train_augment(u8: torch.Tensor, size: int, d: dict) -> torch.Tensor:
    """uint8 NHWC -> the augmented float32 NCHW batch in [-1, 1]."""
    x = u8.permute(0, 3, 1, 2).float() / 255.0
    _, _, h, w = x.shape
    rows = []
    for i in range(x.shape[0]):
        crop = float(d["scales"][i]) * min(h, w)
        wr = _resize_matrix(float(d["off_i"][i]) * (h - crop), crop, h, size, x.device)
        wc = _resize_matrix(float(d["off_j"][i]) * (w - crop), crop, w, size, x.device)
        rows.append(wr @ x[i] @ wc.T)
    x = torch.clamp(torch.stack(rows), 0.0, 1.0)
    x = torch.where(d["flip"].view(-1, 1, 1, 1), x.flip(3), x)
    f = lambda k: d[k].view(-1, 1, 1, 1)  # noqa: E731
    x = torch.clamp(x * f("brightness"), 0.0, 1.0)
    mean = _luma(x).mean(dim=(1, 2, 3), keepdim=True)
    x = torch.clamp(f("contrast") * x + (1.0 - f("contrast")) * mean, 0.0, 1.0)
    x = torch.clamp(f("saturation") * x + (1.0 - f("saturation")) * _luma(x), 0.0, 1.0)
    hsv = _rgb_to_hsv(x)
    hue = torch.remainder(hsv[:, 0] + d["hue"].view(-1, 1, 1), 1.0)
    x = _hsv_to_rgb(torch.stack([hue, hsv[:, 1], hsv[:, 2]], dim=1))
    return x * 2.0 - 1.0


def cyclegan_augment(u8: torch.Tensor, crop: int, d: dict) -> torch.Tensor:
    """uint8 NHWC at the load size -> float32 NCHW crops in [-1, 1]."""
    out = []
    for i in range(u8.shape[0]):
        oi, oj = int(d["off_i"][i]), int(d["off_j"][i])
        x = u8[i, oi:oi + crop, oj:oj + crop].permute(2, 0, 1).float() / 255.0
        out.append(x.flip(2) if bool(d["flip"][i]) else x)
    return torch.stack(out) * 2.0 - 1.0


def _shift(x: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """out[:, i, j] = x[:, i + dh, j + dw], zero outside."""
    _, h, w = x.shape
    p = max(abs(dh), abs(dw))
    xp = F.pad(x, (p, p, p, p))
    return xp[:, p + dh:p + dh + h, p + dw:p + dw + w]


def diff_augment(x: torch.Tensor, ops: list) -> torch.Tensor:
    """DiffAugment on NCHW ``x``; ``ops`` is [(op, values)] in policy order."""
    for op, v in ops:
        if op == "brightness":
            x = x + (v[0].view(-1, 1, 1, 1) - 0.5)
        elif op == "saturation":
            mean = x.mean(dim=1, keepdim=True)
            x = (x - mean) * (v[0].view(-1, 1, 1, 1) * 2.0) + mean
        elif op == "contrast":
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) * (v[0].view(-1, 1, 1, 1) + 0.5) + mean
        elif op == "translation":
            x = torch.stack([_shift(x[i], int(v[0][i]), int(v[1][i])) for i in range(len(x))])
        else:
            _, _, h, w = x.shape
            ch = int(h * CUTOUT_RATIOS[op] + 0.5)
            cw = int(w * CUTOUT_RATIOS[op] + 0.5)
            keep = torch.ones_like(x)
            for i in range(len(x)):
                top, left = int(v[0][i]) - ch // 2, int(v[1][i]) - cw // 2
                keep[i, :, max(top, 0):max(top + ch, 0), max(left, 0):max(left + cw, 0)] = 0.0
            x = x * keep
    return x
