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

The U-Net's affine norm, ``affine_instance_norm(x, gamma, beta, eps,
relu)``, routes the same way (``norm_route``): a bf16 CUDA tensor goes
through ``_AffineInstanceNorm`` and ``csrc/instance_norm.cu``'s affine
instance (entry ``affine_instance_norm``), anything else through the plain
chain ``ops/nn_ops.py::affine_instance_norm`` then ``torch.relu`` (the
U-Net's float32 arithmetic and autograd graph). The kernels' contract is
written out as
``affine_norm_stats_reference``, ``affine_norm_apply_reference`` and
``affine_norm_backward_reference`` (the chain's statistics and apply, and
its gradient taken by hand: dx, dgamma and dbeta). It saves x and the
(N, 2, C) float32 mean and centred variance; the backward returns dx,
dgamma and dbeta. Counters ``unet.norm.fwd.<route>`` and
``unet.norm.bwd.<route>``, counted as the non-affine ones are; no span of
its own (the U-Net's ``unet.norm`` span holds the forward).
"""

from __future__ import annotations

import struct

import torch
from torch.autograd.function import once_differentiable

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.ops import nn_ops
from gan_variant_research_tpu_torch.ops.kernels import _build

ROUTES = ("kernel", "plain")
# csrc/instance_norm.cu's block layout: threads, channel vectors and rows in
# flight a thread, and the streaming kernels' blocks an SM (64 registers)
_THREADS, _TX_MAX, _UNROLL, _BLOCKS_PER_SM = 256, 32, 4, 4


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

def _scratch(x: torch.Tensor, eps: float):
    """(S, the float32 scratch, eps's bits) of a launch on ``x``: the
    partial sums (N, S, 2, C), then the coefficients (N, 4, C); torch.empty,
    so no fill lands on the card."""
    n, _, _, c = x.shape
    splits = norm_splits(x.shape, _build.sm_count(x.device.index))
    work = torch.empty(n * c * (2 * splits + 4), dtype=torch.float32, device=x.device)
    return splits, work, struct.unpack("<i", struct.pack("<f", eps))[0]


def _launch(x, g, stats, out, eps: float, relu: bool, backward: bool) -> None:
    n, h, w, c = x.shape
    splits, work, eps_bits = _scratch(x, eps)
    _build.launch("instance_norm", x.device, x.data_ptr(), 0 if g is None else g.data_ptr(),
                  work.data_ptr(), stats.data_ptr(), out.data_ptr(), n, h * w, c, splits,
                  int(relu), int(backward), eps_bits)


def _launch_forward(x: torch.Tensor, eps: float, relu: bool):
    with trace.span("norm.fwd"):
        if x.shape[0] > _build.GRID_Z_MAX:
            raise ValueError(f"batch {x.shape[0]} exceeds the kernel's grid limit of "
                             f"{_build.GRID_Z_MAX}")
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


# --------------------------------------------------------------------------- #
# the U-Net's affine norm: plain versions (the kernels' contract)

def affine_norm_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """(N, 2, C) float32: the mean over H, W and the centred biased variance
    mean((x - mean)^2), as ``nn_ops.affine_instance_norm`` computes them."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    return torch.stack([mean[:, 0, 0], var[:, 0, 0]], dim=1)


def _affine_terms(x, stats, eps):
    """x - mean and r = rsqrt(var + eps), float32, (N, 1, 1, C) for r."""
    mean = stats[:, 0, None, None, :]
    return x.float() - mean, torch.rsqrt(stats[:, 1, None, None, :] + eps)


def affine_norm_apply_reference(x: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, relu: bool,
                                eps: float = 1e-5) -> torch.Tensor:
    """``gamma * (x - mean) * r + beta`` in float32, rounded to x's dtype
    once, then the ReLU if ``relu``: the chain's apply on ``stats``."""
    centred, r = _affine_terms(x, stats, eps)
    y = (gamma.float() * (centred * r) + beta.float()).to(x.dtype)
    return torch.relu(y) if relu else y


def affine_norm_backward_reference(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                                   gamma: torch.Tensor, beta: torch.Tensor, relu: bool,
                                   eps: float = 1e-5):
    """(dx, dgamma, dbeta) of ``affine_norm_apply_reference`` (with the
    statistics' own dependence on x) for the cotangent ``g``: autograd's
    graph of the plain chain, taken by hand.

    g' is g where the forward's output is positive (with the ReLU). Per
    (n, c), float32: S1 = sum g', S2 = sum g' * xhat (xhat = (x - mean) * r);
    dx = gamma * r * (g' - S1 / HW - xhat * S2 / HW), rounded to x's dtype
    once; dbeta = sum over n of S1, dgamma of S2, float32."""
    if relu:
        y = affine_norm_apply_reference(x, stats, gamma, beta, False, eps)
        g = torch.where(y > 0, g, torch.zeros_like(g))
    gf = g.float()
    centred, r = _affine_terms(x, stats, eps)
    xhat = centred * r
    s1 = gf.sum(dim=(1, 2), keepdim=True)
    s2 = (gf * xhat).sum(dim=(1, 2), keepdim=True)
    hw = x.shape[1] * x.shape[2]
    dx = gamma.float() * r * (gf - s1 / hw - xhat * (s2 / hw))
    return dx.to(x.dtype), s2.sum(dim=(0, 1, 2)), s1.sum(dim=(0, 1, 2))


# --------------------------------------------------------------------------- #
# the affine kernels' launches

def _launch_affine(x, g, gamma, beta, stats, out, dparams, eps: float, relu: bool,
                   backward: bool) -> None:
    n, h, w, c = x.shape
    splits, work, eps_bits = _scratch(x, eps)
    _build.launch("affine_instance_norm", x.device, x.data_ptr(),
                  0 if g is None else g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  work.data_ptr(), stats.data_ptr(), out.data_ptr(),
                  0 if dparams is None else dparams.data_ptr(), n, h * w, c, splits, int(relu),
                  int(backward), eps_bits)


def _params(gamma: torch.Tensor, beta: torch.Tensor):
    return gamma.detach().float().contiguous(), beta.detach().float().contiguous()


def _launch_affine_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                           relu: bool):
    if x.shape[0] > _build.GRID_Z_MAX:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel's grid limit of "
                         f"{_build.GRID_Z_MAX}")
    x = x.contiguous()
    y = torch.empty_like(x)
    stats = torch.empty((x.shape[0], 2, x.shape[3]), dtype=torch.float32, device=x.device)
    _launch_affine(x, None, *_params(gamma, beta), stats, y, None, eps, relu, backward=False)
    trace.count("unet.norm.fwd.kernel")
    return x, y, stats


def _launch_affine_backward(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor, eps: float, relu: bool):
    """(dx in x's dtype, dgamma, dbeta float32)."""
    g = g.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    dparams = torch.empty((2, x.shape[3]), dtype=torch.float32, device=x.device)
    _launch_affine(x, g, *_params(gamma, beta), stats, dx, dparams, eps, relu, backward=True)
    trace.count("unet.norm.bwd.kernel")
    return dx, dparams[0], dparams[1]


class _AffineInstanceNorm(torch.autograd.Function):
    """The bf16 affine norm (and ReLU) on a CUDA tensor, forward and backward
    on the kernels; gamma and beta get their gradients in their own dtype."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu):
        x, y, stats = _launch_affine_forward(x, gamma, beta, eps, relu)
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.eps, ctx.relu = eps, relu
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, beta, stats = ctx.saved_tensors
        dx, dgamma, dbeta = _launch_affine_backward(g, x, stats, gamma, beta, ctx.eps, ctx.relu)
        return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None


def _count_affine_plain_backward(grad: torch.Tensor) -> None:
    trace.count("unet.norm.bwd.plain")


def affine_instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """The U-Net's affine instance norm of the NHWC tensor ``x`` over H and W
    (per-channel ``gamma``, ``beta``), then ``torch.relu`` if ``relu``: the
    kernels for a bf16 CUDA tensor, the plain chain for any other
    (``norm_route``)."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (4-D), got shape {tuple(x.shape)}")
    if gamma.shape != (x.shape[3],) or beta.shape != (x.shape[3],):
        raise ValueError(f"gamma and beta must be ({x.shape[3]},), got {tuple(gamma.shape)} "
                         f"and {tuple(beta.shape)}")
    if norm_route(x) == "kernel":
        return _AffineInstanceNorm.apply(x, gamma, beta, eps, relu)
    y = nn_ops.affine_instance_norm(x, gamma, beta, eps)
    y = torch.relu(y) if relu else y
    trace.count("unet.norm.fwd.plain")
    if y.requires_grad:
        y.register_hook(_count_affine_plain_backward)
    return y
