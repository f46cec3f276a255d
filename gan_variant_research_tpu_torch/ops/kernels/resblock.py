"""Reflect-pad + 3x3 conv for the residual trunk, its gradients, and the
block built on it.

Counterpart of ``gan_variant_research_tpu/ops/pallas/resblock.py``.

- ``reflect_conv3x3(x, w, b)``: reflect-pad(1) + 3x3 valid conv + bias on
  NHWC tensors, differentiable through ``_ReflectConv3x3`` (a
  ``torch.autograd.Function``, the counterpart of the JAX ``custom_vjp``).
  Its forward is ``csrc/reflect_conv3x3.cu`` on a CUDA tensor (one of the
  routes ``FWD_ROUTES``, picked by ``fwd_route``) and
  ``reflect_conv3x3_reference`` on a CPU tensor; its backward is
  ``reflect_conv3x3_dx`` and ``reflect_conv3x3_dw``.
- ``reflect_conv3x3_dx(dy, w)``: the input gradient, ``csrc/
  reflect_conv3x3_dx.cu`` on CUDA (one of the routes ``DX_ROUTES``, picked
  by ``dx_route``), ``reflect_conv3x3_dx_reference`` on CPU.
- ``reflect_conv3x3_dw(x, dy)``: the weight gradient, ``csrc/
  reflect_conv3x3_dw.cu`` on CUDA (one of the routes ``DW_ROUTES``, picked
  by ``dw_route``), ``reflect_conv3x3_dw_reference`` on CPU.
- ``fused_resblock``: conv -> instance norm + ReLU -> conv -> instance norm
  -> residual add, NHWC.

A CUDA tensor launches the kernel (built at first use) or raises; the plain
versions serve CPU tensors. Each launch is counted in ``core/trace.py``'s
``COUNTS`` under ``trunk.fwd.<route>``, ``trunk.dx.<route>`` or
``trunk.dw.<route>``, and its wrapper's host side is the span
``trunk.fwd``, ``trunk.dx`` or ``trunk.dw``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.ops.kernels.instance_norm import instance_norm

# The forward kernel's routes, in the order of its ``route`` argument:
# float32 on FMA, bf16 on wgmma + TMA.
FWD_ROUTES = ("f32_fma", "bf16_wgmma")
# The dx kernel's routes, likewise.
DX_ROUTES = ("f32_fma", "bf16_wgmma")
# The dw kernel's routes, likewise.
DW_ROUTES = ("f32_fma", "bf16_wgmma")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_Z_MAX = 65535


def _load(name: str, symbol: str, n_ptr: int, n_int: int):
    from gan_variant_research_tpu_torch.ops.kernels._build import load_library

    fn = getattr(load_library(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _forward_fn():
    return _load("reflect_conv3x3", "reflect_conv3x3_forward", 4, 6)


@functools.cache
def _dx_fn():
    return _load("reflect_conv3x3_dx", "reflect_conv3x3_dx", 4, 6)


@functools.cache
def _dw_fn():
    return _load("reflect_conv3x3_dw", "reflect_conv3x3_dw", 4, 7)


def _check_act(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be NHWC (4-D), got shape {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.shape[1] < 2 or t.shape[2] < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got "
                         f"{t.shape[1]}x{t.shape[2]}")


def _check_device(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors must share a device, got {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    _check_act("x", x)
    c_in = x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c_in):
        raise ValueError(f"w must be HWIO (3, 3, {c_in}, Cout), got {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"b must be ({w.shape[3]},), got {tuple(b.shape)}")
    if not (w.is_floating_point() and b.is_floating_point()):
        raise TypeError("w and b must be floating point")
    _check_device(x, w, b)


def _check_cuda(t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError("activations must be contiguous NHWC tensors")
    if t.shape[0] > _GRID_Z_MAX:
        raise ValueError(f"batch {t.shape[0]} exceeds the kernel's grid limit of {_GRID_Z_MAX}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# --------------------------------------------------------------------------- #
# plain versions (the kernels' contracts; CPU path and the card's comparisons)

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


def _check_dx(dy: torch.Tensor, w: torch.Tensor) -> None:
    _check_act("dy", dy)
    if w.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[3] != dy.shape[3]:
        raise ValueError(f"w must be HWIO (3, 3, Cin, {dy.shape[3]}), got {tuple(w.shape)}")
    if not w.is_floating_point():
        raise TypeError("w must be floating point")
    _check_device(dy, w)


def reflect_conv3x3_dx_reference(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain input gradient, as ``_xla_data_grad``: the full correlation of
    dy with the kernel (``conv_transpose2d``) gives the gradient of the
    reflect-padded input, (N, H+2, W+2, Cin); its border columns, then rows,
    fold onto their reflection sources. ``w`` is cast to dy's dtype;
    products, sums and the fold are float32, then one cast to dy's dtype."""
    _check_dx(dy, w)
    wf = w.to(dy.dtype).float().permute(3, 2, 0, 1)           # (Cout, Cin, 3, 3)
    dxp = F.conv_transpose2d(dy.float().permute(0, 3, 1, 2), wf)
    g = dxp[..., 1:-1].clone()
    g[..., 1] += dxp[..., 0]
    g[..., -2] += dxp[..., -1]
    mid = g[:, :, 1:-1].clone()
    mid[:, :, 1] += g[:, :, 0]
    mid[:, :, -2] += g[:, :, -1]
    return mid.permute(0, 2, 3, 1).to(dy.dtype).contiguous()


def _check_dw(x: torch.Tensor, dy: torch.Tensor) -> None:
    _check_act("x", x)
    _check_act("dy", dy)
    if x.shape[:3] != dy.shape[:3] or x.dtype != dy.dtype:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} and dy {tuple(dy.shape)} "
                         f"{dy.dtype} must share N, H, W and dtype")
    _check_device(x, dy)


def reflect_conv3x3_dw_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient, as ``_xla_weight_grad``: nine float32
    (N*H*W, Cin)^T (N*H*W, Cout) products of the reflect-padded, shifted x
    with dy. Returns (3, 3, Cin, Cout) float32."""
    _check_dw(x, dy)
    n, h, width, c_in = x.shape
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    xp = xp.permute(0, 2, 3, 1)
    dyf = dy.float().reshape(-1, dy.shape[3])
    return torch.stack([
        torch.stack([xp[:, ky:ky + h, kx:kx + width].reshape(-1, c_in).T @ dyf
                     for kx in range(3)])
        for ky in range(3)])


# --------------------------------------------------------------------------- #
# kernel wrappers: plain version on a CPU tensor, the kernel on a CUDA tensor

def _launch_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with trace.span("trunk.fwd"):
        _check_cuda(x)
        c_out = w.shape[3]
        route = fwd_route(x.shape, c_out, x.dtype)
        w = w.to(x.dtype).contiguous()
        b = b.float().contiguous()
        if route == "bf16_wgmma":
            # channels of 8; the tensor maps need 16-byte aligned bases
            x, w, b = pad_fwd_channels(x, w, b)
            x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))
        n, h, width, c_in_k = x.shape
        c_out_k = w.shape[3]
        y = torch.empty((n, h, width, c_out_k), dtype=x.dtype, device=x.device)
        fn = _forward_fn()
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     n, h, width, c_in_k, c_out_k, FWD_ROUTES.index(route),
                     torch.cuda.current_stream().cuda_stream)
        _raise_on(err, f"reflect_conv3x3 ({route})")
        trace.count(f"trunk.fwd.{route}")
        return y if c_out_k == c_out else y[..., :c_out].contiguous()


def _route(dtype: torch.dtype, what: str) -> str:
    if dtype == torch.float32:
        return "f32_fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"{what} must be float32 or bfloat16, got {dtype}")
    return "bf16_wgmma"


def fwd_route(x_shape, c_out: int, dtype: torch.dtype) -> str:
    """The route of ``csrc/reflect_conv3x3.cu`` for an input of ``x_shape``
    (N, H, W, Cin) and ``dtype`` with ``c_out`` output channels: float32 on
    FMA, bf16 on wgmma + TMA (channel counts that are not multiples of 8 are
    zero-padded to them, ``pad_fwd_channels``)."""
    return _route(dtype, "x")


def pad_fwd_channels(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x (N, H, W, Cin), w (3, 3, Cin, Cout) and b (Cout,) zero-padded so that
    Cin and Cout are multiples of 8, as the wgmma route's tensor maps need
    (16-byte rows); unpadded tensors come back as they are. The zeros add
    nothing to the float32 sums, so the first Cout channels of the padded
    conv are the conv."""
    p_in, p_out = -w.shape[2] % 8, -w.shape[3] % 8
    if p_in:
        x = F.pad(x, (0, p_in))
    if p_in or p_out:
        w = F.pad(w, (0, p_out, 0, p_in))
    if p_out:
        b = F.pad(b, (0, p_out))
    return x, w, b


def dx_route(dy_shape, c_in: int, dtype: torch.dtype) -> str:
    """The route of ``csrc/reflect_conv3x3_dx.cu`` for a cotangent of
    ``dy_shape`` (N, H, W, Cout) and ``dtype`` with ``c_in`` input channels:
    float32 on FMA, bf16 on wgmma + TMA (channel counts that are not
    multiples of 8 are zero-padded to them, ``pad_dx_channels``)."""
    return _route(dtype, "dy")


def pad_dx_channels(dy: torch.Tensor, w: torch.Tensor):
    """dy (N, H, W, Cout) and w (3, 3, Cin, Cout) zero-padded so that Cin and
    Cout are multiples of 8, as the wgmma route's tensor maps need (16-byte
    rows); unpadded tensors come back as they are. The zeros add nothing to
    the float32 sums, so the first Cin channels of the padded input gradient
    are the input gradient."""
    c_in, c_out = w.shape[2], w.shape[3]
    p_in, p_out = -c_in % 8, -c_out % 8
    if p_out:
        dy = F.pad(dy, (0, p_out))
    if p_in or p_out:
        w = F.pad(w, (0, p_out, 0, p_in))
    return dy, w


def reflect_conv3x3_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of ``reflect_conv3x3`` for the cotangent ``dy``
    (N, H, W, Cout) and the HWIO kernel ``w``; returns (N, H, W, Cin) in
    dy's dtype. On CUDA it launches ``csrc/reflect_conv3x3_dx.cu`` on the
    current stream, on the route ``dx_route`` picks; on the CPU it is
    ``reflect_conv3x3_dx_reference``."""
    _check_dx(dy, w)
    if dy.device.type == "cpu":
        return reflect_conv3x3_dx_reference(dy, w)
    return _launch_dx(dy, w)


def _launch_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    with trace.span("trunk.dx"):
        _check_cuda(dy)
        n, h, width, c_out = dy.shape
        c_in = w.shape[2]
        route = dx_route(dy.shape, c_in, dy.dtype)
        if route == "bf16_wgmma":
            # (3, 3, Cin, Cout), channels of 8; the tensor maps need 16-byte
            # aligned bases
            dy, wk = pad_dx_channels(dy, w.to(dy.dtype))
            dy, wk = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (dy, wk.contiguous()))
            c_in_k, c_out = wk.shape[2], wk.shape[3]
        else:
            wk = w.to(dy.dtype).flip(0, 1).transpose(2, 3).contiguous()      # (3, 3, Cout, Cin)
            c_in_k = c_in
        # float32 scratch: the padded frame of the input gradient, then (wgmma
        # route) the interior sums of the pixels the fold reaches
        rows = 2 * (width + 2) + 2 * h + (2 * width + 2 * h if route == "bf16_wgmma" else 0)
        frame = torch.empty((n, rows, c_in_k), dtype=torch.float32, device=dy.device)
        dx = torch.empty((n, h, width, c_in_k), dtype=dy.dtype, device=dy.device)
        fn = _dx_fn()
        with torch.cuda.device(dy.device):
            err = fn(dy.data_ptr(), wk.data_ptr(), frame.data_ptr(), dx.data_ptr(),
                     n, h, width, c_in_k, c_out, DX_ROUTES.index(route),
                     torch.cuda.current_stream().cuda_stream)
        _raise_on(err, f"reflect_conv3x3_dx ({route})")
        trace.count(f"trunk.dx.{route}")
        return dx if c_in_k == c_in else dx[..., :c_in].contiguous()


def dw_route(x_shape, c_out: int, dtype: torch.dtype) -> str:
    """The route of ``csrc/reflect_conv3x3_dw.cu`` for an input of
    ``x_shape`` (N, H, W, Cin) and ``dtype`` with ``c_out`` output channels:
    float32 on FMA, bf16 on wgmma + TMA (channel counts that are not
    multiples of 8 are zero-padded to them, ``pad_dw_channels``)."""
    return _route(dtype, "x")


def pad_dw_channels(x: torch.Tensor, dy: torch.Tensor):
    """x (N, H, W, Cin) and dy (N, H, W, Cout) zero-padded so that Cin and
    Cout are multiples of 8, as the wgmma route's tensor maps need (16-byte
    rows); unpadded tensors come back as they are. The zeros add nothing to
    the float32 sums, so dw[:, :, :Cin, :Cout] of the padded pair is dw."""
    p_in, p_out = -x.shape[3] % 8, -dy.shape[3] % 8
    return (F.pad(x, (0, p_in)) if p_in else x), (F.pad(dy, (0, p_out)) if p_out else dy)


def dw_splits(x_shape, c_out: int, sm_count: int, route: str) -> int:
    """How many parts the dw kernel splits the N*H*W reduction into, at most
    one image-row segment (64 pixels) per part. bf16 (blocks of 128 x 128
    channels x 3 taps, one an SM): as many as fit in one wave over
    ``sm_count`` SMs; float32 (blocks of 64 x 64 channels): about four
    waves."""
    n, h, width, c_in = x_shape
    segments = n * h * -(-width // 64)
    if route == "bf16_wgmma":
        want = sm_count // (3 * -(-c_in // 128) * -(-c_out // 128))
    else:
        want = -(-4 * sm_count // (3 * -(-c_in // 64) * -(-c_out // 64)))
    return max(1, min(segments, want, _GRID_Z_MAX // 3))


def reflect_conv3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``reflect_conv3x3`` for the input ``x`` and the
    cotangent ``dy`` (same dtype); returns (3, 3, Cin, Cout) float32, the
    same bits from run to run. On CUDA it launches
    ``csrc/reflect_conv3x3_dw.cu`` on the current stream, on the route
    ``dw_route`` picks; on the CPU it is ``reflect_conv3x3_dw_reference``."""
    _check_dw(x, dy)
    if x.device.type == "cpu":
        return reflect_conv3x3_dw_reference(x, dy)
    return _launch_dw(x, dy)


def _launch_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    with trace.span("trunk.dw"):
        _check_cuda(x)
        _check_cuda(dy)
        c_in, c_out = x.shape[3], dy.shape[3]
        route = dw_route(x.shape, c_out, x.dtype)
        if route == "bf16_wgmma":
            # channels of 8; the tensor maps need 16-byte aligned bases
            x, dy = pad_dw_channels(x, dy)
            x, dy = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dy))
        n, h, width, c_in_k = x.shape
        c_out_k = dy.shape[3]
        splits = dw_splits(x.shape, c_out_k,
                           torch.cuda.get_device_properties(x.device).multi_processor_count, route)
        part = torch.empty((splits, 3, 3, c_in_k, c_out_k), dtype=torch.float32, device=x.device)
        dw = torch.empty((3, 3, c_in_k, c_out_k), dtype=torch.float32, device=x.device)
        fn = _dw_fn()
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                     n, h, width, c_in_k, c_out_k, splits, DW_ROUTES.index(route),
                     torch.cuda.current_stream().cuda_stream)
        _raise_on(err, f"reflect_conv3x3_dw ({route})")
        trace.count(f"trunk.dw.{route}")
        if (c_in_k, c_out_k) == (c_in, c_out):
            return dw
        return dw[:, :, :c_in, :c_out].contiguous()


class _ReflectConv3x3(torch.autograd.Function):
    """The trunk conv with its hand-written backward (JAX ``_rc_fwd`` /
    ``_rc_bwd``): the cotangent is cast to x's dtype for ``dx`` and ``dw``,
    ``db`` is its float32 sum taken before that cast, ``dw`` comes back in
    the weight's dtype. Double backward is refused."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        if x.device.type == "cpu":
            return reflect_conv3x3_reference(x, w, b)
        return _launch_forward(x, w, b)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g_cast = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = reflect_conv3x3_dx(g_cast, w)
        if ctx.needs_input_grad[1]:
            dw = reflect_conv3x3_dw(x, g_cast).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2)).to(ctx.b_dtype)
        return dx, dw, db


def reflect_conv3x3(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """reflect-pad(1) + 3x3 valid conv + bias, differentiable in x, w and b.
    ``x`` is NHWC (contiguous on CUDA), ``w`` HWIO (cast to x's dtype), ``b``
    (Cout,) in float32.

    On CUDA the forward and backward launch the Hopper kernels on the current
    stream without synchronising; on the CPU they are the plain versions."""
    _check(x, w, b)
    return _ReflectConv3x3.apply(x, w, b)


def fused_resblock(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Residual block on the trunk conv: conv -> IN -> ReLU -> conv -> IN,
    plus the input. NHWC; weights HWIO, biases float32. Each IN is
    ``ops/kernels/instance_norm.py``'s, the first with its ReLU fused."""
    h1 = reflect_conv3x3(x, w1, b1)
    a1 = instance_norm(h1, eps, relu=True)
    h2 = reflect_conv3x3(a1, w2, b2)
    return x + instance_norm(h2, eps)
