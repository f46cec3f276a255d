"""The trunk conv's gradients in the port (``ops/kernels/resblock.py``)
against the JAX package: the plain ``dx`` and ``dw`` (the contracts of the
CUDA kernels ``csrc/reflect_conv3x3_{dx,dw}.cu``) against the TPU kernels
``_dx_pallas`` / ``_dw_pallas`` in interpret mode, against ``jax.vjp`` of
the JAX ``reflect_conv3x3``, and at H or W of 2 and 3 against the XLA
formulations; and the ``autograd.Function`` that carries them.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gan_variant_research_tpu.ops.pallas import resblock as jax_rb
from gan_variant_research_tpu_torch.ops.kernels import resblock as rb
from gan_variant_research_tpu_torch.ops.nn_ops import instance_norm


def _inputs(shape, c_out, seed=0):
    rng = np.random.default_rng(seed)
    c_in = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 0.5
    w = (rng.standard_normal((3, 3, c_in, c_out)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape[:3] + (c_out,)).astype(np.float32)
    return x, w, b, dy


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_vjp(x, w, b, dy):
    _, vjp = jax.vjp(jax_rb.reflect_conv3x3, *map(jnp.asarray, (x, w, b)))
    return vjp(jnp.asarray(dy))


# the shape test_pallas_resblock.py runs the TPU kernels at, a ragged one,
# and a narrow one
FP32_SHAPES = [((2, 8, 8, 128), 128), ((2, 6, 7, 24), 40), ((2, 8, 8, 16), 16)]


@pytest.mark.parametrize("shape,c_out", FP32_SHAPES)
def test_plain_dx_matches_pallas_kernel_and_vjp(shape, c_out):
    x, w, b, dy = _inputs(shape, c_out)
    got = rb.reflect_conv3x3_dx(torch.from_numpy(dy), torch.from_numpy(w)).numpy()
    # float32 sums over up to 9 * Cout terms in another order
    assert _rel(got, jax_rb._dx_pallas(jnp.asarray(dy), jnp.asarray(w))) <= 1e-4
    assert _rel(got, _jax_vjp(x, w, b, dy)[0]) <= 1e-4


@pytest.mark.parametrize("shape,c_out", FP32_SHAPES)
def test_plain_dw_matches_pallas_kernel_and_vjp(shape, c_out):
    x, w, b, dy = _inputs(shape, c_out)
    got = rb.reflect_conv3x3_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, shape[-1], c_out)
    # float32 sums over N*H*W products in another order
    assert _rel(got.numpy(), jax_rb._dw_pallas(jnp.asarray(x), jnp.asarray(dy))) <= 1e-4
    assert _rel(got.numpy(), _jax_vjp(x, w, b, dy)[1]) <= 1e-4


@pytest.mark.parametrize("shape,c_out", [((1, 3, 5, 8), 8), ((1, 2, 4, 8), 8),
                                         ((2, 2, 3, 5), 7), ((1, 3, 2, 6), 4),
                                         ((1, 2, 2, 3), 3)])
def test_small_planes_match_xla_formulations(shape, c_out):
    """At H or W of 2 and 3 the fold targets coincide or cross. The TPU
    kernel's fold breaks there (ROADMAP Queue 3); the XLA formulations of
    the JAX custom_vjp are the oracle."""
    x, w, _, dy = _inputs(shape, c_out, seed=1)
    dx = rb.reflect_conv3x3_dx(torch.from_numpy(dy), torch.from_numpy(w)).numpy()
    dw = rb.reflect_conv3x3_dw(torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    assert _rel(dx, jax_rb._xla_data_grad(jnp.asarray(dy), jnp.asarray(w))) <= 1e-4
    assert _rel(dw, jax_rb._xla_weight_grad(jnp.asarray(x), jnp.asarray(dy))) <= 1e-4


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_bf16_dx_within_two_ulps_of_pallas_kernel():
    """The TPU kernel stages the padded gradient in bf16 before the fold, so
    on the two border rows and columns it rounds each folded term at that
    term's own magnitude; the port rounds the float32 sum once. So the two
    agree to 2 bf16 ulps of the sum of the magnitudes that fold onto a
    pixel (interior pixels take a single term)."""
    _, w, _, dy = _inputs((2, 8, 8, 128), 128, seed=2)
    dy16 = torch.from_numpy(dy).bfloat16()
    got = rb.reflect_conv3x3_dx(dy16, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = jax_rb._dx_pallas(jnp.asarray(dy16.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(w))
    want = np.asarray(want.astype(jnp.float32))
    w16 = torch.from_numpy(w).bfloat16().float()
    dxp = F.conv_transpose2d(dy16.float().permute(0, 3, 1, 2), w16.permute(3, 2, 0, 1))
    magnitude = np.asarray(jax_rb._xla_reflect_pad_transpose(
        jnp.asarray(dxp.abs().permute(0, 2, 3, 1).numpy())))
    d = np.abs(got.float().numpy() - want)
    assert (d <= 2 * _bf16_ulp(magnitude)).all(), (d / _bf16_ulp(magnitude)).max()
    interior = (slice(None), slice(2, -2), slice(2, -2))
    assert (d[interior] <= _bf16_ulp(want[interior])).all()


def test_bf16_plain_gradients_keep_the_dtype_contract():
    """bf16 in: w cast to bf16, float32 products and sums (and fold), one
    cast to bf16 for dx; dw stays float32."""
    x, w, _, dy = map(torch.from_numpy, _inputs((1, 6, 5, 16), 8, seed=3))
    x16, dy16 = x.bfloat16(), dy.bfloat16()
    dx = rb.reflect_conv3x3_dx(dy16, w)
    assert torch.equal(dx, rb.reflect_conv3x3_dx(dy16.float(), w.bfloat16().float()).bfloat16())
    dw = rb.reflect_conv3x3_dw(x16, dy16)
    assert dw.dtype == torch.float32
    assert torch.equal(dw, rb.reflect_conv3x3_dw(x16.float(), dy16.float()))


def _plain_conv(x, w, b):
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return (F.conv2d(xp, w.permute(3, 2, 0, 1)) + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1)


def _plain_resblock(x, w1, b1, w2, b2):
    a1 = torch.relu(instance_norm(_plain_conv(x, w1, b1)))
    return x + instance_norm(_plain_conv(a1, w2, b2))


def test_fused_resblock_is_differentiable_through_the_function():
    """The repaired fault: the trunk conv's output carries the Function's
    node, and the gradient in x, both weights and both biases equals
    autograd of the plain path."""
    x, w1, b1, dy = _inputs((2, 6, 5, 8), 8, seed=4)
    _, w2, b2, _ = _inputs((2, 6, 5, 8), 8, seed=5)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    y = rb.reflect_conv3x3(*args[:3])
    assert type(y.grad_fn).__name__ == "_ReflectConv3x3Backward"
    probe = torch.from_numpy(dy)
    got = torch.autograd.grad((rb.fused_resblock(*args) * probe).sum(), args)
    plain = [a.detach().clone().requires_grad_() for a in args]
    want = torch.autograd.grad((_plain_resblock(*plain) * probe).sum(), plain)
    for name, g, e in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        assert g.shape == e.shape, name
        # float32; the biases before an instance norm have a gradient of 0,
        # which both sides give as rounding noise
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_function_refuses_double_backward():
    x, w, b, _ = map(torch.from_numpy, _inputs((1, 4, 4, 4), 4))
    x.requires_grad_()
    (g,) = torch.autograd.grad(rb.reflect_conv3x3(x, w, b).square().sum(), x,
                               create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), x)


def test_function_casts_the_cotangent_and_sums_db_in_float32():
    """bf16 x: dx comes back bf16, dw in the weight's float32, db the float32
    sum of the cotangent before its cast."""
    x, w, b, dy = map(torch.from_numpy, _inputs((1, 5, 4, 8), 8, seed=6))
    x16 = x.bfloat16().requires_grad_()
    w, b = w.requires_grad_(), b.requires_grad_()
    y = rb.reflect_conv3x3(x16, w, b)
    g = dy.bfloat16()
    dx, dw, db = torch.autograd.grad(y, (x16, w, b), g)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32 and db.dtype == torch.float32
    assert torch.equal(dx, rb.reflect_conv3x3_dx(g, w.detach()))
    assert torch.equal(dw, rb.reflect_conv3x3_dw(x16.detach(), g))
    assert torch.equal(db, g.float().sum(dim=(0, 1, 2)))


def test_cpu_gradients_build_and_launch_nothing():
    x, w, b, dy = map(torch.from_numpy, _inputs((1, 4, 4, 8), 8))
    x.requires_grad_()
    w.requires_grad_()
    before = (rb.LAUNCHES, rb.DX_LAUNCHES, rb.DW_LAUNCHES, dict(rb.DX_ROUTE_LAUNCHES))
    torch.autograd.grad(rb.reflect_conv3x3(x, w, b), (x, w), dy)
    rb.reflect_conv3x3_dx(dy, w.detach())
    rb.reflect_conv3x3_dw(x.detach(), dy)
    assert (rb.LAUNCHES, rb.DX_LAUNCHES, rb.DW_LAUNCHES, rb.DX_ROUTE_LAUNCHES) == before
    for fn in (rb._forward_fn, rb._dx_fn, rb._dw_fn):
        assert fn.cache_info().currsize == 0


@pytest.mark.parametrize("bad", ["dx_rank", "dx_small", "dx_w", "dw_dtype", "dw_shape"])
def test_gradient_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, w, _, dy = map(torch.from_numpy, _inputs((1, 4, 4, 8), 8))
    with pytest.raises((ValueError, TypeError)):
        if bad == "dx_rank":
            rb.reflect_conv3x3_dx(dy[0], w)
        elif bad == "dx_small":
            rb.reflect_conv3x3_dx(dy[:, :1], w)
        elif bad == "dx_w":
            rb.reflect_conv3x3_dx(dy, w[..., :4])
        elif bad == "dw_dtype":
            rb.reflect_conv3x3_dw(x, dy.bfloat16())
        else:
            rb.reflect_conv3x3_dw(x, dy[:, :3])


@pytest.mark.parametrize("shape,c_out,sms,want", [
    ((12, 64, 64, 256), 256, 132, 11),   # the trunk at batch 12: 48 blocks a split
    ((1, 2, 3, 8), 8, 132, 2),           # capped at one 64-pixel row segment a split
    ((4096, 64, 64, 256), 256, 132, 11),
])
def test_dw_split_count(shape, c_out, sms, want):
    assert rb.dw_splits(shape, c_out, sms) == want


@pytest.mark.parametrize("shape,c_in,dtype,route", [
    ((12, 64, 64, 256), 256, torch.bfloat16, "bf16_wgmma"),     # train_gan_cutpp.yaml's trunk
    ((4, 128, 128, 256), 256, torch.bfloat16, "bf16_wgmma"),    # train_gan_cutpp_512.yaml's
    ((1, 3, 2, 8), 8, torch.bfloat16, "bf16_wgmma"),            # any plane, channels of 8
    ((3, 17, 33, 70), 130, torch.bfloat16, "bf16_wgmma"),       # Cin padded to 136
    ((2, 2, 3, 21), 16, torch.bfloat16, "bf16_wgmma"),          # Cout padded to 24
    ((12, 64, 64, 256), 256, torch.float32, "f32_fma"),
])
def test_dx_route(shape, c_in, dtype, route):
    assert rb.dx_route(shape, c_in, dtype) == route
    assert route in rb.DX_ROUTES


@pytest.mark.parametrize("shape,c_out", [((3, 5, 6, 130), 70), ((2, 2, 3, 13), 21),
                                         ((1, 3, 2, 16), 24)])
def test_ragged_bf16_channels_pad_onto_the_wgmma_route(shape, c_out):
    """Channel counts that are not multiples of 8 are zero-padded to them for
    the wgmma route, and the first Cin channels of the padded input gradient
    (the route's split, emulated) are the input gradient; channels of 8 are
    passed through as they are."""
    _, w, _, dy = _inputs(shape, c_out, seed=11)
    dy_t, w_t = torch.from_numpy(dy), torch.from_numpy(w)
    dy_p, w_p = rb.pad_dx_channels(dy_t, w_t)
    c_in = shape[3]
    assert dy_p.shape == shape[:3] + (-(-c_out // 8) * 8,)
    assert w_p.shape == (3, 3, -(-c_in // 8) * 8, -(-c_out // 8) * 8)
    if c_in % 8 == 0 and c_out % 8 == 0:
        assert dy_p is dy_t and w_p is w_t
    assert torch.equal(dy_p[..., :c_out], dy_t) and not dy_p[..., c_out:].any()
    assert torch.equal(w_p[:, :, :c_in, :c_out], w_t)
    assert not w_p[:, :, c_in:].any() and not w_p[..., c_out:].any()
    got, _ = _wgmma_route_split(dy_p, w_p)
    assert _rel(got[..., :c_in].numpy(), rb.reflect_conv3x3_dx_reference(dy_t, w_t).numpy()) <= 1e-5


def test_dx_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        rb.dx_route((1, 4, 4, 8), 8, torch.float16)


def _fold_slot(h, w, i, j):
    """csrc/reflect_conv3x3_dx.cu::fold_slot: where the wgmma route keeps the
    float32 interior sum of a pixel the fold reaches, -1 for the others."""
    if i == 1:
        return j
    if i == h - 2:
        return w + j
    if j == 1:
        return 2 * w + i
    if j == w - 2:
        return 2 * w + h + i
    return -1


def _slot_pixel(h, w, slot):
    """dx_fold's pixel of a slot (checked against _fold_slot, as it does)."""
    if slot < 2 * w:
        return (1 if slot < w else h - 2), slot % w
    return (slot - 2 * w) % h, (1 if slot < 2 * w + h else w - 2)


def _wgmma_route_split(dy, w):
    """The bf16 wgmma route of csrc/reflect_conv3x3_dx.cu written out in plain
    torch, in float32: the frame pass's four lines (1-D correlations of one
    dy line with one kernel row or column), the main pass's zero-padded 9-tap
    interior (the "same" conv of dy with the flipped kernel), its epilogue
    that sets aside the interior sums of the pixels the fold reaches, and
    dx_fold, which adds the frame to them as frame_fold does."""
    n, h, width, _ = dy.shape
    dyf, wf = dy.float(), w.float()

    def line(d, taps, off, length):   # d (N, L, Cout); taps: 3 (Cin, Cout) matrices
        dp = F.pad(d, (0, 0, 2, 2))
        return torch.stack([sum(dp[:, u + off - k + 2] @ taps[k].T for k in range(3))
                            for u in range(length)], dim=1)

    top = line(dyf[:, 0], [wf[0, k] for k in range(3)], 0, width + 2)
    bot = line(dyf[:, h - 1], [wf[2, k] for k in range(3)], 0, width + 2)
    left = line(dyf[:, :, 0], [wf[k, 0] for k in range(3)], 1, h)
    right = line(dyf[:, :, width - 1], [wf[k, 2] for k in range(3)], 1, h)

    def frame_fold(i, j):
        v = torch.zeros_like(top[:, 0])
        if j == 1:
            v = v + left[:, i]
        if j == width - 2:
            v = v + right[:, i]
        for row, at in ((top, 1), (bot, h - 2)):
            if i == at:
                v = v + row[:, j + 1] + (row[:, 0] if j == 1 else 0) + (
                    row[:, width + 1] if j == width - 2 else 0)
        return v

    interior = F.conv2d(dyf.permute(0, 3, 1, 2), wf.flip(0, 1).permute(2, 3, 0, 1),
                        padding=1).permute(0, 2, 3, 1)
    dx = interior.clone()
    edge = {}
    for i in range(h):
        for j in range(width):
            if _fold_slot(h, width, i, j) >= 0:
                edge[_fold_slot(h, width, i, j)] = interior[:, i, j]
    folded = []
    for slot in range(2 * width + 2 * h):
        i, j = _slot_pixel(h, width, slot)
        if _fold_slot(h, width, i, j) == slot:
            dx[:, i, j] = edge.pop(slot) + frame_fold(i, j)
            folded.append((i, j))
    assert not edge
    return dx.to(dy.dtype), folded


@pytest.mark.parametrize("shape,c_out", [((2, 2, 2, 8), 8), ((1, 2, 3, 8), 16),
                                         ((1, 3, 2, 8), 8), ((2, 3, 3, 16), 8),
                                         ((1, 5, 4, 8), 8), ((2, 6, 7, 16), 24),
                                         ((1, 16, 16, 16), 16)])
def test_wgmma_route_split_matches_reference_and_xla(shape, c_out):
    """The frame lines, the interior and the fold slots of the wgmma route
    give the reference's input gradient, at H and W of 2 and 3 too (where
    fold targets coincide), and each pixel the fold reaches is finished
    exactly once."""
    _, w, _, dy = _inputs(shape, c_out, seed=7)
    dy_t, w_t = torch.from_numpy(dy), torch.from_numpy(w)
    got, folded = _wgmma_route_split(dy_t, w_t)
    _, h, width, _ = shape
    targets = {(i, j) for i in range(h) for j in range(width)
               if i in (1, h - 2) or j in (1, width - 2)}
    assert sorted(folded) == sorted(targets)
    # float32 sums and fold in another order
    assert _rel(got.numpy(), rb.reflect_conv3x3_dx_reference(dy_t, w_t).numpy()) <= 1e-5
    assert _rel(got.numpy(), jax_rb._xla_data_grad(jnp.asarray(dy), jnp.asarray(w))) <= 1e-4
