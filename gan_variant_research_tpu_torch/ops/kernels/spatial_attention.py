"""The spatial self-attention core of the SAGAN block, and its gradients.

Counterpart of the Pallas TPU flash attention behind
``gan_variant_research_tpu/models/attention.py::flash_spatial_attention``
(the library kernel ``jax.experimental.pallas.ops.tpu.flash_attention``
with ``sm_scale=1``, non-causal), and of the einsum core it replaces
(attention.py:188-191).

- ``spatial_attention(q, k, v)``: ``softmax(q k^T) v`` for q, k (B, n, d_qk)
  and v (B, n, d_v), differentiable through ``_SpatialAttention`` (a
  ``torch.autograd.Function``). On a CUDA tensor its forward is
  ``csrc/spatial_attention.cu`` and its backward ``csrc/
  spatial_attention_dkv.cu`` and ``csrc/spatial_attention_dq.cu``; on a CPU
  tensor they are the plain versions.
- ``spatial_attention_forward(q, k, v) -> (o, lse)``, ``spatial_attention_dkv
  (q, k, v, do, lse, di) -> (dk, dv)``, ``spatial_attention_dq(q, k, v, do,
  lse, di) -> dq``: the three kernels' wrappers. ``lse`` (B, n) float32 is
  the row log-sum-exp of the logits, ``di`` (B, n) float32 is ``sum(o * do)``
  over d_v, taken outside the kernels as the library takes it.

The kernels take one head. Their limits: 8 <= d_qk <= 128 and 8 <= d_v <=
256, both multiples of 8, any n >= 1, B <= 65535; the backward kernels take
d_v <= 128 where d_qk > 64 (``backward_width``: their dK or dQ accumulator
takes the registers that a wider d_v would need). A CUDA tensor outside
them raises in the wrappers. ``spatial_attention`` brings every width the
JAX package runs through its flash kernel (d_qk <= 128) to them, by shape
only (``attention_route``), with the adaptations the JAX
``flash_spatial_attention`` makes for its 128-wide heads, all exact:

- ``padded``: d_qk zero-padded to the next multiple of 8 (at least 8) up
  to 64, and to 128 past 64 (the JAX flash path pads to its 128-wide head),
  d_v to the next multiple of 8, o sliced (zero columns add nothing to
  q k^T, do v^T or ``di``);
- ``split``: d_v > 256 cut into ceil(d_v / 256) equal column chunks, each
  a multiple of 8 (384 -> 2 x 192), run with the same q and k; o is their
  concatenation; in the backward each chunk takes its own ``di_c = sum
  over the chunk of o do``, dV is taken per chunk, dK and dQ are summed
  over the chunks in float32 and cast once;
- ``direct``: the kernels' own widths.

On every route the backward cuts each forward chunk again into column
chunks of at most ``backward_width(d_qk)`` (256 -> 2 x 128 on the d_qk-128
instance), each with its own ``di``; the forward's ``lse`` serves them all,
since it depends on q and k alone.

Past d_qk 128 the JAX package runs its einsum core, not the flash kernel;
``attention_route`` names that ``einsum``, and the port runs it in
``models/attention.py::einsum_attention``: ``spatial_attention`` refuses
it. Nothing the JAX package runs is refused. A CUDA tensor launches the
kernel (built at first use) or raises; the plain versions serve CPU
tensors, through the same routes. ``core/trace.py``'s ``COUNTS`` counts
the launches where they happen: the forward's under ``attn.fwd.<route>``,
by the route the caller names (a raw call is ``direct``; the einsum core's
calls on the card are ``attn.fwd.einsum``), the backward's under
``attn.dkv`` and ``attn.dq``. Each wrapper's host side, its checks, its
allocations and the launch (on the CPU, the plain version), is the span
``attn.fwd``, ``attn.dkv`` or ``attn.dq``.

``spatial_attention_dkv_contract`` and ``spatial_attention_dq_contract`` are
the backward as the library kernel rounds it (p and ds in the inputs' dtype,
sums in float64): the yardstick of the bf16 backward kernels in the tests
and on the card, never called on the main path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.ops.kernels import _build

ATTN_ROUTES = ("direct", "padded", "split", "einsum")
KERNEL_ROUTES = ATTN_ROUTES[:3]

_MAX_DQK, _MAX_DV = 128, 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"q, k must be (B, n, d_qk) and v (B, n, d_v), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    devs = {str(t.device) for t in (q, k, v)}
    if len(devs) != 1 or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q, k, v must share a CPU or CUDA device, got {sorted(devs)}")


def backward_width(d_qk: int) -> int:
    """The widest d_v the backward kernels take at this d_qk: 256 up to
    d_qk 64, 128 on the d_qk-128 instance."""
    return _MAX_DV if d_qk <= 64 else 128


def _check_cuda(*ts: torch.Tensor, max_dv: int = _MAX_DV) -> None:
    """What the kernels take: the limits above (d_v up to ``max_dv``),
    contiguous 16-byte aligned tensors."""
    b, n, dqk = ts[0].shape
    dv = ts[2].shape[2]
    if not (8 <= dqk <= _MAX_DQK and dqk % 8 == 0 and 8 <= dv <= max_dv and dv % 8 == 0):
        raise ValueError(f"the attention kernels take d_qk in [8, {_MAX_DQK}] and d_v in "
                         f"[8, {max_dv}], multiples of 8; got d_qk={dqk}, d_v={dv}")
    if not 1 <= b <= _build.GRID_Z_MAX or n < 1:
        raise ValueError(f"the attention kernels take 1 <= B <= {_build.GRID_Z_MAX} and n >= 1, "
                         f"got B={b}, n={n}")
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the attention kernels take contiguous, 16-byte aligned tensors")


# --------------------------------------------------------------------------- #
# plain versions (CPU path and the card's comparisons)

def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    # float32 products of the inputs' values (exact for bf16) and float32 sums
    return q.float() @ k.float().transpose(1, 2)


def _plain_forward(q, k, v):
    logits = _logits(q, k)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return (attn.float() @ v.float()).to(q.dtype), torch.logsumexp(logits, dim=-1)


def spatial_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """The JAX einsum core (attention.py:188-191): float32 logits, float32
    softmax, the normalised weights cast to v's dtype, then the weighted sum
    in float32 and one cast to q's dtype."""
    _check(q, k, v)
    return _plain_forward(q, k, v)[0]


def _plain_grads(q, k, v, do):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o = spatial_attention_reference(*leaves)
        return torch.autograd.grad(o, leaves, do.to(o.dtype))


def spatial_attention_dkv_reference(q, k, v, do, lse, di):
    """dK, dV by autograd of ``spatial_attention_reference`` for the cotangent
    ``do`` (``lse`` and ``di`` are taken for the kernel's signature and not
    read)."""
    _check(q, k, v)
    return tuple(_plain_grads(q, k, v, do)[1:])


def spatial_attention_dq_reference(q, k, v, do, lse, di):
    """dQ by autograd of ``spatial_attention_reference`` for the cotangent
    ``do`` (``lse`` and ``di`` are not read)."""
    _check(q, k, v)
    return _plain_grads(q, k, v, do)[0]


def _contract_p_ds(q, k, v, do, lse, di, acc):
    """The library backward's p and ds at its rounding points, as ``acc``
    tensors: p = exp(q k^T - lse); ds = p (do v^T - di), rounded to the
    inputs' dtype when that is not float32. Returns (p, ds, rounding)."""
    _check_bwd(q, k, v, do, lse, di)
    if q.dtype == torch.float32:
        rnd = lambda t: t  # noqa: E731
    else:
        rnd = lambda t: t.to(q.dtype).to(acc)  # noqa: E731
    p = torch.exp(q.to(acc) @ k.to(acc).transpose(1, 2) - lse.to(acc)[..., None])
    dp = do.to(acc) @ v.to(acc).transpose(1, 2)
    return p, rnd(p * (dp - di.to(acc)[..., None])), rnd


def spatial_attention_dkv_contract(q, k, v, do, lse, di, acc=torch.float64):
    """dK, dV as the library's backward (and the kernel) define them, for a
    yardstick of the kernel: p = exp(q k^T - lse), dV = p^T do and dK =
    ds^T q with ds = p (do v^T - di), p and ds rounded to the inputs' dtype
    before their products (no rounding for float32 inputs). Sums in ``acc``
    (float64 unless asked otherwise), each result cast once to the inputs'
    dtype. Only the tests and the smoke call it."""
    p, ds, rnd = _contract_p_ds(q, k, v, do, lse, di, acc)
    dv = rnd(p).transpose(1, 2) @ do.to(acc)
    dk = ds.transpose(1, 2) @ q.to(acc)
    return dk.to(q.dtype), dv.to(q.dtype)


def spatial_attention_dq_contract(q, k, v, do, lse, di, acc=torch.float64):
    """dQ = ds k at the library's rounding points, as
    ``spatial_attention_dkv_contract`` defines ds."""
    _, ds, _ = _contract_p_ds(q, k, v, do, lse, di, acc)
    return (ds @ k.to(acc)).to(q.dtype)


# --------------------------------------------------------------------------- #
# kernel wrappers: plain version on a CPU tensor, the kernel on a CUDA tensor

def spatial_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              route: str = "direct") -> tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, lse (B, n) float32). On CUDA it launches
    ``csrc/spatial_attention.cu`` on the current stream and counts the
    launch under ``route`` (one of ``KERNEL_ROUTES``)."""
    with trace.span("attn.fwd"):
        _check(q, k, v)
        if route not in KERNEL_ROUTES:
            raise ValueError(f"route must be one of {KERNEL_ROUTES}, got {route!r}")
        if q.device.type == "cpu":
            return _plain_forward(q, k, v)
        _check_cuda(q, k, v)
        b, n, dqk = q.shape
        dv = v.shape[2]
        o = torch.empty((b, n, dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
        _build.launch("spatial_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), lse.data_ptr(), b, n, dqk, dv, _build.DTYPE_CODES[q.dtype])
        trace.count(f"attn.fwd.{route}")
        return o, lse


def _check_bwd(q, k, v, do, lse, di) -> None:
    _check(q, k, v)
    b, n = q.shape[:2]
    if do.shape != v.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must be {tuple(v.shape)} {q.dtype} on {q.device}, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, n) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be ({b}, {n}) float32 on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def spatial_attention_dkv(q, k, v, do, lse, di) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in the inputs' dtype, the same bits from run to run. On CUDA
    it launches ``csrc/spatial_attention_dkv.cu`` (d_v up to
    ``backward_width(d_qk)``)."""
    with trace.span("attn.dkv"):
        _check_bwd(q, k, v, do, lse, di)
        if q.device.type == "cpu":
            return spatial_attention_dkv_reference(q, k, v, do, lse, di)
        _check_cuda(q, k, v, do, lse, di, max_dv=backward_width(q.shape[2]))
        b, n, dqk = q.shape
        dv = v.shape[2]
        dk, dv_out = torch.empty_like(k), torch.empty_like(v)
        _build.launch("spatial_attention_dkv", q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
                      dv_out.data_ptr(), b, n, dqk, dv, _build.DTYPE_CODES[q.dtype])
        trace.count("attn.dkv")
        return dk, dv_out


def spatial_attention_dq(q, k, v, do, lse, di) -> torch.Tensor:
    """dq in the inputs' dtype, the same bits from run to run. On CUDA it
    launches ``csrc/spatial_attention_dq.cu`` (d_v up to
    ``backward_width(d_qk)``)."""
    with trace.span("attn.dq"):
        _check_bwd(q, k, v, do, lse, di)
        if q.device.type == "cpu":
            return spatial_attention_dq_reference(q, k, v, do, lse, di)
        _check_cuda(q, k, v, do, lse, di, max_dv=backward_width(q.shape[2]))
        b, n, dqk = q.shape
        dq = torch.empty_like(q)
        _build.launch("spatial_attention_dq", q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                      b, n, dqk, v.shape[2], _build.DTYPE_CODES[q.dtype])
        trace.count("attn.dq")
        return dq


def _round8(d: int) -> int:
    return max(8, -(-d // 8) * 8)


def attention_route(d_qk: int, d_v: int) -> tuple[str, int, int, int]:
    """(route, d_qk padded, chunk width, chunks) for the kernels: d_qk and
    the chunk width are multiples of 8, d_qk past 64 padded to 128, the
    chunks cover d_v (zero columns past it), at most ``_MAX_DV`` wide each.
    Past d_qk 128: ("einsum", d_qk, d_v, 1), the JAX package's einsum core,
    which no kernel runs."""
    if d_qk > _MAX_DQK:
        return "einsum", d_qk, d_v, 1
    chunks = -(-d_v // _MAX_DV)
    width = _round8(-(-d_v // chunks))
    dqk = _round8(d_qk) if d_qk <= 64 else _MAX_DQK
    if chunks > 1:
        route = "split"
    elif (dqk, width) != (d_qk, d_v):
        route = "padded"
    else:
        route = "direct"
    return route, dqk, width, chunks


class _SpatialAttention(torch.autograd.Function):
    """The core with its hand-written backward (the library's custom VJP),
    on v cut into column chunks of ``width`` (one chunk but on the split
    route; each chunk's forward launch counted under ``route``): the
    cotangent is cast to q's dtype; each forward chunk is cut again into
    the backward kernels' chunks of at most ``backward_width(d_qk)``
    columns, with the chunk's ``lse``; each backward chunk's ``di`` is the
    float32 product of its cotangent with its saved output; dK and dQ of
    several chunks are summed in float32 and cast once. Double backward is
    refused."""

    @staticmethod
    def forward(ctx, q, k, v, width, route):
        chunks = [c.contiguous() for c in v.split(width, dim=2)]
        outs = [spatial_attention_forward(q, k, c, route) for c in chunks]
        ctx.width = width
        ctx.save_for_backward(q, k, *chunks, *(o for o, _ in outs), *(lse for _, lse in outs))
        return outs[0][0] if len(outs) == 1 else torch.cat([o for o, _ in outs], dim=2)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, *rest = ctx.saved_tensors
        n = len(rest) // 3
        chunks, outs, lses = rest[:n], rest[n:2 * n], rest[2 * n:]
        do = do.to(q.dtype)
        bw = backward_width(q.shape[2])
        dq = dk = None
        dvs = []
        for c, o, lse, do_c in zip(chunks, outs, lses, do.split(ctx.width, dim=2)):
            for c_b, o_b, do_b in zip(c.split(bw, dim=2), o.split(bw, dim=2),
                                      do_c.split(bw, dim=2)):
                c_b, do_b = c_b.contiguous(), do_b.contiguous()
                di = (o_b.float() * do_b.float()).sum(-1)
                if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                    dk_c, dv_c = spatial_attention_dkv(q, k, c_b, do_b, lse, di)
                    dk = dk_c if dk is None else dk.float() + dk_c.float()
                    dvs.append(dv_c)
                if ctx.needs_input_grad[0]:
                    dq_c = spatial_attention_dq(q, k, c_b, do_b, lse, di)
                    dq = dq_c if dq is None else dq.float() + dq_c.float()
        dv = (dvs[0] if len(dvs) == 1 else torch.cat(dvs, dim=2)) if dvs else None
        cast = lambda t: None if t is None else t.to(q.dtype)  # noqa: E731
        return cast(dq), cast(dk), dv, None, None


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T) v``, differentiable in q, k and v: q, k (B, n, d_qk),
    v (B, n, d_v), one dtype (float32 or bfloat16); returns (B, n, d_v) in
    q's dtype. The route (``attention_route``) follows from d_qk and d_v
    alone. On CUDA the forward and backward launch the Hopper kernels on
    the current stream without synchronising, and each forward launch is
    counted under its route; on the CPU they are the plain versions. d_qk
    past 128 (the ``einsum`` route) raises: ``models/attention.py`` runs the
    einsum core there."""
    _check(q, k, v)
    d_qk, d_v = q.shape[2], v.shape[2]
    route, dqk, width, chunks = attention_route(d_qk, d_v)
    if route == "einsum":
        raise ValueError(f"d_qk {d_qk} is past the kernels' {_MAX_DQK}: the JAX package runs "
                         "its einsum core there (models/attention.py::einsum_attention)")
    if dqk != d_qk:
        q, k = F.pad(q, (0, dqk - d_qk)), F.pad(k, (0, dqk - d_qk))
    if width * chunks != d_v:
        v = F.pad(v, (0, width * chunks - d_v))
    o = _SpatialAttention.apply(q, k, v, width, route)
    return o if width * chunks == d_v else o[..., :d_v]
