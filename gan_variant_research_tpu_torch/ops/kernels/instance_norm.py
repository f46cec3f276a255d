"""Instance norm over the spatial dims of an NHWC tensor (no affine, biased
variance), with the ReLU that may follow it, and its backward.

``instance_norm(x, eps, relu)`` routes by what the input is
(``norm_route``): a bf16 CUDA tensor goes through ``_InstanceNorm``, a
``torch.autograd.Function`` whose forward and backward each launch
``csrc/instance_norm.cu`` (statistics, finalize and apply passes);
anything else (float32, the CPU) takes the plain chain,
``ops/nn_ops.py::instance_norm`` then ``torch.relu``, with its ordinary
autograd, so double backward keeps working wherever a float32 graph needs
it. The bf16 Function is once differentiable.

The kernels' contract is the plain chain's arithmetic, written out here as
``instance_norm_stats_reference``, ``instance_norm_apply_reference`` and
``instance_norm_backward_reference`` (the chain's autograd graph taken by
hand; ``csrc/instance_norm.cu``'s header derives it). Saved for the
backward: x and the (N, 2, C) float32 statistics (mean and the unclamped
variance, whose sign says whether the clamp bit); no float32 copy of x.

Spans ``norm.fwd`` and ``norm.bwd`` cover the kernel wrappers' host side
and launch (the backward's on autograd's device thread). Counters
``norm.fwd.<route>`` and ``norm.bwd.<route>`` (``kernel`` or ``plain``,
``ROUTES``) count each call where it runs on the host, the plain route's
on the CPU too (its backward by a hook on the output), so a CUDA-graph
replay counts none.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch
from torch.autograd.function import once_differentiable

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.ops import nn_ops

ROUTES = ("kernel", "plain")
# csrc/instance_norm.cu's block layout: threads, channel vectors and rows in
# flight a thread, and the streaming kernels' blocks an SM (64 registers)
_THREADS, _TX_MAX, _UNROLL, _BLOCKS_PER_SM = 256, 32, 4, 4
_GRID_Z_MAX = 65535


@functools.cache
def _norm_fn():
    from gan_variant_research_tpu_torch.ops.kernels._build import load_library

    fn = load_library("instance_norm").instance_norm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def norm_route(x: torch.Tensor) -> str:
    """``kernel`` for a bf16 CUDA tensor, ``plain`` for any other."""
    return "kernel" if x.device.type == "cuda" and x.dtype == torch.bfloat16 else "plain"


def norm_splits(shape, sm_count: int) -> int:
    """How many pixel shares S the kernels split each (n, channel block)
    into: as many as keep the grid (S, channel blocks, N) within one wave of
    ``_BLOCKS_PER_SM`` blocks on each of ``sm_count`` SMs, so that a small
    N * C still fills the card and no partial second wave runs at low
    occupancy; at least ``_UNROLL`` rows of pixels for each thread."""
    n, h, w, c = shape
    vectors = c // 8 if c % 8 == 0 else c
    txn = min(vectors, _TX_MAX)
    blocks = n * -(-vectors // txn)
    most = max(1, h * w // (_THREADS // txn * _UNROLL))
    return max(1, min(_BLOCKS_PER_SM * sm_count // blocks, most))


# --------------------------------------------------------------------------- #
# plain versions (the kernels' contract)

def instance_norm_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """(N, 2, C) float32: the mean over H, W and the unclamped variance
    E[x^2] - mean^2, as ``nn_ops.instance_norm`` computes them."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2))
    mean_sq = xf.square().mean(dim=(1, 2))
    return torch.stack([mean, mean_sq - mean.square()], dim=1)


def _scale_offset(x: torch.Tensor, stats: torch.Tensor, eps: float):
    mean = stats[:, 0, None, None, :]
    inv = torch.rsqrt(torch.clamp(stats[:, 1, None, None, :], min=0.0) + eps)
    return inv.to(x.dtype), (mean * inv).to(x.dtype), mean, inv


def instance_norm_apply_reference(x: torch.Tensor, stats: torch.Tensor, relu: bool,
                                  eps: float = 1e-5) -> torch.Tensor:
    """``x * scale - offset`` in x's dtype, ``scale`` and ``offset`` rounded
    to it from the float32 statistics, then the ReLU if ``relu``."""
    scale, offset, _, _ = _scale_offset(x, stats, eps)
    y = x * scale - offset
    return torch.relu(y) if relu else y


def instance_norm_backward_reference(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                                     relu: bool, eps: float = 1e-5) -> torch.Tensor:
    """The input gradient of ``instance_norm_apply_reference`` (with the
    statistics' own dependence on x) for the cotangent ``g`` in x's dtype:
    autograd's graph of the plain chain, taken by hand.

    g' is g where the output is positive (with the ReLU). The two broadcasts
    reduce to G1 = sum g' and G2 = sum (g' * x), both products and sums
    rounded to x's dtype as ``sum_to_size`` leaves them; through ``offset``,
    ``scale``, the rsqrt, the clamp (no gradient where the variance was
    negative) and both means, dx = g' * scale + a + b * x per (n, c), with
    one rounding to x's dtype."""
    g, scale, a, b = backward_terms(g, x, stats, relu, eps)
    return (g.float() * scale.float() + (a + b * x.float())).to(x.dtype)


def backward_terms(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, relu: bool,
                   eps: float = 1e-5):
    """(g', scale, a, b) of ``instance_norm_backward_reference``: g' in x's
    dtype, scale (N, 1, 1, C) in x's dtype, a and b (N, 1, 1, C) float32."""
    scale, offset, mean, inv = _scale_offset(x, stats, eps)
    var = stats[:, 1, None, None, :]
    if relu:
        g = torch.where(x * scale - offset > 0, g, torch.zeros_like(g))
    d_offset = -g.sum(dim=(1, 2), keepdim=True).float()
    d_scale = (g * x).sum(dim=(1, 2), keepdim=True).float()
    d_inv = d_scale + d_offset * mean
    d_var = torch.where(var < 0, torch.zeros_like(var), -0.5 * d_inv * inv ** 3)
    d_mean = d_offset * inv - 2.0 * mean * d_var
    hw = x.shape[1] * x.shape[2]
    return g, scale, d_mean / hw, 2.0 * (d_var / hw)


# --------------------------------------------------------------------------- #
# the kernel's launches

def _launch(x, g, stats, out, eps: float, relu: bool, backward: bool) -> None:
    n, h, w, c = x.shape
    splits = norm_splits(x.shape, _sm_count(x.device.index or 0))
    # float32 scratch: the partial sums (N, S, 2, C), then the coefficients
    # (N, 4, C); torch.empty, so no fill lands on the card
    work = torch.empty(n * c * (2 * splits + 4), dtype=torch.float32, device=x.device)
    eps_bits = struct.unpack("<i", struct.pack("<f", eps))[0]
    with torch.cuda.device(x.device):
        err = _norm_fn()(x.data_ptr(), 0 if g is None else g.data_ptr(), work.data_ptr(),
                         stats.data_ptr(), out.data_ptr(), n, h * w, c, splits, int(relu),
                         int(backward), eps_bits, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_norm ({'backward' if backward else 'forward'}) launch "
                           f"failed: CUDA error {err}")


def _launch_forward(x: torch.Tensor, eps: float, relu: bool):
    with trace.span("norm.fwd"):
        if x.shape[0] > _GRID_Z_MAX:
            raise ValueError(f"batch {x.shape[0]} exceeds the kernel's grid limit of {_GRID_Z_MAX}")
        x = x.contiguous()
        y = torch.empty_like(x)
        stats = torch.empty((x.shape[0], 2, x.shape[3]), dtype=torch.float32, device=x.device)
        _launch(x, None, stats, y, eps, relu, backward=False)
        trace.count("norm.fwd.kernel")
        return x, y, stats


def _launch_backward(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, eps: float,
                     relu: bool) -> torch.Tensor:
    with trace.span("norm.bwd"):
        g = g.to(x.dtype).contiguous()
        dx = torch.empty_like(x)
        _launch(x, g, stats, dx, eps, relu, backward=True)
        trace.count("norm.bwd.kernel")
        return dx


class _InstanceNorm(torch.autograd.Function):
    """The bf16 norm (and ReLU) on a CUDA tensor, forward and backward on the
    kernels."""

    @staticmethod
    def forward(ctx, x, eps, relu):
        x, y, stats = _launch_forward(x, eps, relu)
        ctx.save_for_backward(x, stats)
        ctx.eps, ctx.relu = eps, relu
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        return _launch_backward(g, x, stats, ctx.eps, ctx.relu), None, None


def _count_plain_backward(grad: torch.Tensor) -> None:
    trace.count("norm.bwd.plain")


def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """Instance norm of the NHWC tensor ``x`` over H and W, no affine, then
    ``torch.relu`` if ``relu``: the kernels for a bf16 CUDA tensor, the plain
    chain for any other (``norm_route``)."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (4-D), got shape {tuple(x.shape)}")
    if norm_route(x) == "kernel":
        return _InstanceNorm.apply(x, eps, relu)
    y = nn_ops.instance_norm(x, eps)
    y = torch.relu(y) if relu else y
    trace.count("norm.fwd.plain")
    if y.requires_grad:
        y.register_hook(_count_plain_backward)
    return y
