"""InceptionV3 (FID variant) in PyTorch: the feature network of MiFID/FID.

Counterpart of ``gan_variant_research_tpu/evalsuite/inception.py`` (the flax
``InceptionV3FID``). Modules and state-dict names are torch-fidelity's
(``Mixed_5b.branch1x1.conv.weight``, ``....bn.{weight,bias,running_mean,
running_var}``), so the canonical ``pt_inception-2015-12-05`` state dict
loads as it is (its ``fc`` and ``AuxLogits`` skipped). The FID variant's
details, as the JAX module documents them:

- BasicConv2d is a conv without bias, BatchNorm (eps 1e-3, inference
  statistics), then ReLU;
- the pool branches of InceptionA, C and the first E average over 3x3,
  stride 1, pad 1 with ``count_include_pad=False``; ``Mixed_7c`` (the last
  E) takes a max pool there;
- the input is uint8 [0, 255] -> (x - 128) / 128, at least 75 x 75 (299^2
  in use), and the output the 2048-d global mean of the last block.

``InceptionFID`` holds the net on a device: float32, channels_last, under
``torch.inference_mode``, with TF32 off for its convolutions during the
call (cuDNN's default would run them in TF32, which moves the features and
FID amplifies that). Its weights come from a torch ``.pth`` or from the JAX
package's converted ``.npz`` (flat ``a/b/c`` flax keys); without weights it
raises unless ``allow_random`` (pipeline tests only: scores against random
features mean nothing).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, inference statistics) + ReLU."""

    def __init__(self, in_c: int, out_c: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, bias=False, **kw)
        self.bn = nn.BatchNorm2d(out_c, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_c: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_c, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_c, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_c, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_c, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_c, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_c, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_c: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_c, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_c, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_c, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_c, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_c, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_c, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
            self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_c: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode   # "avg" (Mixed_7b) or "max" (Mixed_7c)
        self.branch1x1 = BasicConv2d(in_c, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_c, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_c, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_c, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """The FID feature net: float NCHW in [-1, 1], at least 75 x 75 ->
    (N, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        if x.shape[2] < 75 or x.shape[3] < 75:
            raise ValueError(f"InceptionV3 needs inputs >= 75x75 (got {x.shape[2]}x"
                             f"{x.shape[3]}); smaller images collapse to empty feature "
                             "maps in Mixed_7a.")
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def preprocess_uint8(u8_nhwc: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW (channels_last in memory), (x - 128) / 128,
    torch-fidelity's normalisation."""
    x = (u8_nhwc.float() - 128.0) / 128.0
    return x.permute(0, 3, 1, 2)


# --------------------------------------------------------------------------- #
# weights

_SKIPPED = ("fc.", "AuxLogits.")


def _is_buffer_count(name: str) -> bool:
    return name.endswith("num_batches_tracked")


def load_inception_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """torch-fidelity names -> float32 tensors, from a torch ``.pth`` (a
    state dict, or a dict with one under ``state_dict``) or the JAX
    package's converted ``.npz`` (flat ``a/b/c`` flax keys, converted by
    ``convert.inception_state_dict_from_jax``). The classifier head
    (``fc``, ``AuxLogits``) and BatchNorm's ``num_batches_tracked`` are
    dropped: the pool3 features use neither."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(
            f"Inception weights not found: {path}. Provide the torch-fidelity "
            "pt_inception-2015-12-05 state dict (.pth) or a converted .npz.")
    if path.suffix == ".npz":
        from gan_variant_research_tpu_torch.convert import inception_state_dict_from_jax

        params: dict = {}
        with np.load(path) as flat:
            for key in flat.files:
                node = params
                parts = key.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = flat[key]
        return inception_state_dict_from_jax(params)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float() for k, v in sd.items()
            if not k.startswith(_SKIPPED) and not _is_buffer_count(k)}


def validate_state_dict(module: nn.Module, sd: dict[str, torch.Tensor]) -> None:
    """Raise unless ``sd`` has exactly the net's leaves (BatchNorm's
    counters aside) at their shapes: a truncated or foreign checkpoint
    must not score."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()
            if not _is_buffer_count(k)}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    missing, extra = want.keys() - got.keys(), got.keys() - want.keys()
    if missing or extra:
        raise ValueError(f"Inception weights do not match the architecture; "
                         f"missing={sorted(missing)[:5]}... extra={sorted(extra)[:5]}...")
    bad = [f"{k}: {got[k]} != {want[k]}" for k in want if got[k] != want[k]]
    if bad:
        raise ValueError("Inception weights have wrong leaf shapes (truncated or foreign "
                         f"checkpoint?): {bad[:5]}...")


def _he_init_(module: nn.Module, seed: int = 0) -> None:
    """He-normal conv kernels from a seeded generator (the JAX module's
    init), BatchNorm at its defaults: random features that stay O(1)
    through the ~90 convs. Pipeline tests only."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN convolutions and CUDA matmuls for the duration,
    the settings restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def eval_device(name: str | torch.device) -> torch.device:
    """``name`` as a torch device; a CUDA device that is not there raises
    (there is no silent CPU run)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name}: no CUDA device is available; pass --device cpu "
                           "(device='cpu') to evaluate on the CPU")
    return device


class InceptionFID:
    """The 2048-d pool3 feature extractor on ``device`` (the card by
    default). ``weights_path=None`` needs ``allow_random=True`` and gives
    random features: pipeline tests only, never reportable scores."""

    def __init__(self, weights_path: str | Path | None = None, allow_random: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = eval_device(device)
        self.module = InceptionV3FID()
        self.randomly_initialized = weights_path is None
        if weights_path is not None:
            sd = load_inception_state_dict(weights_path)
            validate_state_dict(self.module, sd)
            self.module.load_state_dict(sd, strict=False)
        elif not allow_random:
            raise ValueError("InceptionFID needs the canonical FID weights for meaningful "
                             "scores. Pass weights_path (pt_inception .pth or converted "
                             ".npz), or allow_random=True for pipeline tests only.")
        else:
            _he_init_(self.module)
        self.module = self.module.eval().to(self.device, memory_format=torch.channels_last)

    def features(self, u8_nhwc: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC batch on the extractor's device -> (N, 2048) float32
        features there."""
        with torch.inference_mode(), full_float32():
            x = preprocess_uint8(u8_nhwc).contiguous(memory_format=torch.channels_last)
            return self.module(x)

    def features_u8(self, u8_nhwc: np.ndarray) -> np.ndarray:
        """uint8 NHWC host batch -> (N, 2048) float32 host features."""
        return self.features(torch.from_numpy(np.ascontiguousarray(u8_nhwc)).to(
            self.device)).cpu().numpy()
