"""Reflect-pad + 3x3 conv for the residual trunk, its gradients, and the
block built on it.

Counterpart of ``gan_variant_research_tpu/ops/pallas/resblock.py``.

- ``reflect_conv3x3(x, w, b)``: reflect-pad(1) + 3x3 valid conv + bias on
  NHWC tensors, differentiable through ``_ReflectConv3x3`` (a
  ``torch.autograd.Function``, the counterpart of the JAX ``custom_vjp``).
  Its forward is ``csrc/reflect_conv3x3.cu`` on a CUDA tensor and
  ``reflect_conv3x3_reference`` on a CPU tensor; its backward is
  ``reflect_conv3x3_dx`` and ``reflect_conv3x3_dw``.
- ``reflect_conv3x3_dx(dy, w)``: the input gradient, ``csrc/
  reflect_conv3x3_dx.cu`` on CUDA, ``reflect_conv3x3_dx_reference`` on CPU.
- ``reflect_conv3x3_dw(x, dy)``: the weight gradient, ``csrc/
  reflect_conv3x3_dw.cu`` on CUDA, ``reflect_conv3x3_dw_reference`` on CPU.
  The same kernel also sums the bias gradient for ``_ReflectConv3x3``'s
  backward on the card (``_launch_dw(..., with_db=True)``).
- ``fused_resblock``: conv -> instance norm + ReLU -> conv -> instance norm
  -> residual add, NHWC.

A CUDA tensor launches the kernel (built at first use) or raises; the plain
versions serve CPU tensors. Each kernel takes one of the routes
``TRUNK_ROUTES``, which ``trunk_route`` picks by dtype alone. Each launch
is counted in ``core/trace.py``'s ``COUNTS`` under ``trunk.fwd.<route>``,
``trunk.dx.<route>`` or ``trunk.dw.<route>`` (and a ``dw`` launch that also
sums the bias gradient under ``trunk.dw.db``), and its wrapper's host side
is the span ``trunk.fwd``, ``trunk.dx`` or ``trunk.dw``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.ops.kernels import _build
from gan_variant_research_tpu_torch.ops.kernels.instance_norm import instance_norm

# The trunk kernels' routes, in the order of their ``route`` argument:
# float32 on FMA, bf16 on wgmma + TMA.
TRUNK_ROUTES = ("f32_fma", "bf16_wgmma")
_KERNELS = {"fwd": "reflect_conv3x3", "dx": "reflect_conv3x3_dx", "dw": "reflect_conv3x3_dw"}


def _check_act(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be NHWC (4-D), got shape {tuple(t.shape)}")
    if t.dtype not in _build.DTYPE_CODES:
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


def _on_cpu(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the plain versions (a CPU tensor) rather than
    the kernels."""
    return t.device.type == "cpu"


def _check_cuda(t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError("activations must be contiguous NHWC tensors")
    if t.shape[0] > _build.GRID_Z_MAX:
        raise ValueError(f"batch {t.shape[0]} exceeds the kernel's grid limit of "
                         f"{_build.GRID_Z_MAX}")


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

def trunk_route(dtype: torch.dtype) -> str:
    """The trunk kernels' route for ``dtype``: float32 on FMA, bf16 on wgmma
    + TMA (channel counts that are not multiples of 8 are zero-padded to
    them, ``pad_channels``)."""
    if dtype == torch.float32:
        return "f32_fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"the trunk kernels take float32 or bfloat16, got {dtype}")
    return "bf16_wgmma"


def pad_channels(t: torch.Tensor, *dims: int) -> torch.Tensor:
    """``t`` with each axis in ``dims`` zero-padded at its end to a multiple
    of 8, as the wgmma route's tensor maps need (16-byte rows); ``t`` itself
    where no axis needs it. The zeros add nothing to the float32 sums, so a
    kernel's output on padded operands, sliced back to the real channel
    counts, is its output on the operands."""
    pad = [0] * (2 * t.dim())
    for d in dims:
        pad[2 * (t.dim() - 1 - d) + 1] = -t.shape[d] % 8
    return F.pad(t, pad) if any(pad) else t


def _launch(kind: str, acts, operands, want, setup) -> torch.Tensor:
    """What the three trunk kernels' wrappers share, inside their span: the
    activations ``acts`` checked, the route, on the wgmma route each
    operand's channel axes (``operands`` holds (tensor, axes) pairs)
    zero-padded to 8 and its 4-D tensors given the 16-byte aligned bases the
    tensor maps need, then ``setup(route, *operands) -> (out, tensors,
    ints)`` for what is the kernel's own, the launch on ``tensors``' pointers
    (None a null pointer) and ``ints``, its count, and ``out`` with the
    padding sliced off to the shape ``want``."""
    for t in acts:
        _check_cuda(t)
    route = trunk_route(acts[0].dtype)
    if route == "bf16_wgmma":
        ts = [pad_channels(t, *dims) for t, dims in operands]
        ts = [t if t.dim() != 4 or t.data_ptr() % 16 == 0 else t.clone() for t in ts]
    else:
        ts = [t for t, _ in operands]
    out, tensors, ints = setup(route, *ts)
    _build.launch(_KERNELS[kind], out.device,
                  *(None if t is None else t.data_ptr() for t in tensors), *ints,
                  TRUNK_ROUTES.index(route))
    trace.count(f"trunk.{kind}.{route}")
    return out if out.shape == want else out[tuple(map(slice, want))].contiguous()


def _launch_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    def setup(route, x, w, b):
        y = torch.empty(x.shape[:3] + (w.shape[3],), dtype=x.dtype, device=x.device)
        return y, (x, w, b, y), (*x.shape, w.shape[3])

    with trace.span("trunk.fwd"):
        return _launch("fwd", (x,), ((x, (3,)), (w.to(x.dtype).contiguous(), (2, 3)),
                                     (b.float().contiguous(), (0,))),
                       x.shape[:3] + (w.shape[3],), setup)


def reflect_conv3x3_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of ``reflect_conv3x3`` for the cotangent ``dy``
    (N, H, W, Cout) and the HWIO kernel ``w``; returns (N, H, W, Cin) in
    dy's dtype. On CUDA it launches ``csrc/reflect_conv3x3_dx.cu`` on the
    current stream, on the route ``trunk_route`` picks; on the CPU it is
    ``reflect_conv3x3_dx_reference``."""
    _check_dx(dy, w)
    if _on_cpu(dy):
        return reflect_conv3x3_dx_reference(dy, w)
    return _launch_dx(dy, w)


def _launch_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    def setup(route, dy, wk):
        n, h, width, c_out = dy.shape
        if route == "f32_fma":
            wk = wk.flip(0, 1).transpose(2, 3).contiguous()      # (3, 3, Cout, Cin)
        c_in_k = wk.shape[2] if route == "bf16_wgmma" else wk.shape[3]
        # float32 scratch: the padded frame of the input gradient, then (wgmma
        # route) the interior sums of the pixels the fold reaches
        rows = 2 * (width + 2) + 2 * h + (2 * width + 2 * h if route == "bf16_wgmma" else 0)
        frame = torch.empty((n, rows, c_in_k), dtype=torch.float32, device=dy.device)
        dx = torch.empty((n, h, width, c_in_k), dtype=dy.dtype, device=dy.device)
        return dx, (dy, wk, frame, dx), (n, h, width, c_in_k, c_out)

    with trace.span("trunk.dx"):
        # w as (3, 3, Cin, Cout) in dy's dtype
        return _launch("dx", (dy,), ((dy, (3,)), (w.to(dy.dtype).contiguous(), (2, 3))),
                       dy.shape[:3] + (w.shape[2],), setup)


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
    return max(1, min(segments, want, _build.GRID_Z_MAX // 3))


def reflect_conv3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``reflect_conv3x3`` for the input ``x`` and the
    cotangent ``dy`` (same dtype); returns (3, 3, Cin, Cout) float32, the
    same bits from run to run. On CUDA it launches
    ``csrc/reflect_conv3x3_dw.cu`` on the current stream, on the route
    ``trunk_route`` picks; on the CPU it is ``reflect_conv3x3_dw_reference``."""
    _check_dw(x, dy)
    if _on_cpu(x):
        return reflect_conv3x3_dw_reference(x, dy)
    return _launch_dw(x, dy)[0]


def _launch_dw(x: torch.Tensor, dy: torch.Tensor, with_db: bool = False):
    """The dw kernel on ``x`` and ``dy``: (dw, db), db (Cout,) float32 the
    sum of dy over N, H and W where ``with_db`` (counted ``trunk.dw.db``),
    else None."""
    c_out = dy.shape[3]
    # room for the wgmma route's channels padded to 8
    db = torch.empty(-(-c_out // 8) * 8, dtype=torch.float32, device=x.device) if with_db else None

    def setup(route, x, dy):
        c_in, c_out = x.shape[3], dy.shape[3]
        splits = dw_splits(x.shape, c_out, _build.sm_count(x.device.index), route)
        # float32 scratch: the splits' partials of dw, (splits, 3, 3, Cin,
        # Cout), then of db, (splits, groups, Cout): on the wgmma route the
        # blocks of a share's 3 kernel rows and input-channel tiles of 128
        # split its segments between them
        groups = 3 * -(-c_in // 128) if route == "bf16_wgmma" else 1
        part = torch.empty(splits * (9 * c_in + groups) * c_out, dtype=torch.float32,
                           device=x.device)
        dw = torch.empty((3, 3, c_in, c_out), dtype=torch.float32, device=x.device)
        return dw, (x, dy, part, dw, db), (*x.shape, c_out, splits)

    with trace.span("trunk.dw"):
        dw = _launch("dw", (x, dy), ((x, (3,)), (dy, (3,))), (3, 3, x.shape[3], c_out), setup)
        if not with_db:
            return dw, None
        trace.count("trunk.dw.db")
        return dw, db[:c_out]


class _ReflectConv3x3(torch.autograd.Function):
    """The trunk conv with its hand-written backward (JAX ``_rc_fwd`` /
    ``_rc_bwd``): the cotangent is cast to x's dtype for ``dx`` and ``dw``,
    ``db`` is its float32 sum taken before that cast, ``dw`` comes back in
    the weight's dtype. On the card, where w and b both need gradients and
    the cotangent is already in x's dtype (the cast changes nothing), the
    ``dw`` kernel sums ``db`` too; elsewhere it is a stock sum. Double
    backward is refused."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        if _on_cpu(x):
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
            if ctx.needs_input_grad[2] and g.dtype == x.dtype and not _on_cpu(x):
                dw, db = _launch_dw(x, g_cast, with_db=True)
            else:
                dw = reflect_conv3x3_dw(x, g_cast)
            dw = dw.to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = (g.float().sum(dim=(0, 1, 2)) if db is None else db).to(ctx.b_dtype)
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
