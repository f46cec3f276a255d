"""Reflect-pad + 3x3 conv for the residual trunk, and the block built on it.

Counterpart of ``gan_variant_research_tpu/ops/pallas/resblock.py`` (forward
only: serving needs no gradient).

- ``reflect_conv3x3(x, w, b)``: reflect-pad(1) + 3x3 valid conv + bias on
  NHWC tensors. On a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/reflect_conv3x3.cu`` (built at first use) or raises; on a CPU
  tensor it runs ``reflect_conv3x3_reference``. ``LAUNCHES`` counts the
  kernel launches.
- ``reflect_conv3x3_reference``: the plain PyTorch version with the same
  dtype contract (float32 products and sums, float32 bias, one cast).
- ``fused_resblock``: conv -> instance norm -> ReLU -> conv -> instance norm
  -> residual add, NHWC.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gan_variant_research_tpu_torch.ops.nn_ops import instance_norm

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _forward_fn():
    from gan_variant_research_tpu_torch.ops.kernels._build import load_library

    fn = load_library("reflect_conv3x3").reflect_conv3x3_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (4-D), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _, h, width, c_in = x.shape
    if h < 2 or width < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{width}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c_in):
        raise ValueError(f"w must be HWIO (3, 3, {c_in}, Cout), got {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"b must be ({w.shape[3]},), got {tuple(b.shape)}")
    if not (w.is_floating_point() and b.is_floating_point()):
        raise TypeError("w and b must be floating point")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"x, w, b must share a device, got {x.device}, "
                         f"{w.device}, {b.device}")


def reflect_conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch reflect-pad(1) + 3x3 conv + bias, the kernel's contract:
    ``w`` is cast to x's dtype, products and sums are float32, the float32
    bias is added before the one cast to x's dtype. NHWC in and out."""
    _check(x, w, b)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(xp, wf) + b.float().view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def reflect_conv3x3(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """reflect-pad(1) + 3x3 valid conv + bias. ``x`` is NHWC (contiguous on
    CUDA), ``w`` HWIO (cast to x's dtype), ``b`` (Cout,) in float32.

    On CUDA this launches the Hopper kernel on the current stream without
    synchronising; on the CPU it is ``reflect_conv3x3_reference``."""
    global LAUNCHES
    _check(x, w, b)
    if x.device.type == "cpu":
        return reflect_conv3x3_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    n, h, width, c_in = x.shape
    c_out = w.shape[3]
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid limit of 65535")
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    y = torch.empty((n, h, width, c_out), dtype=x.dtype, device=x.device)
    fn = _forward_fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 n, h, width, c_in, c_out, _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"reflect_conv3x3 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def fused_resblock(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Residual block on the trunk conv: conv -> IN -> ReLU -> conv -> IN,
    plus the input. NHWC; weights HWIO, biases float32."""
    h1 = reflect_conv3x3(x, w1, b1)
    a1 = torch.relu(instance_norm(h1, eps))
    h2 = reflect_conv3x3(a1, w2, b2)
    return x + instance_norm(h2, eps)
