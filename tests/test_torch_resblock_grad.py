"""The trunk conv's gradients in the port (``ops/kernels/resblock.py``)
against the JAX package: the plain ``dx`` and ``dw`` (the contracts of the
CUDA kernels ``csrc/reflect_conv3x3_{dx,dw}.cu``) against the TPU kernels
``_dx_pallas`` / ``_dw_pallas`` in interpret mode, against ``jax.vjp`` of
the JAX ``reflect_conv3x3``, and at H or W of 2 and 3 against the XLA
formulations; the bias gradient as the ``dw`` kernel sums it, against the
stock sum and JAX's ``_rc_bwd``; and the ``autograd.Function`` that
carries them, also with its launches recorded instead of run.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gan_variant_research_tpu.ops.pallas import resblock as jax_rb
from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.models.generator_resnet import ResidualBlock
from gan_variant_research_tpu_torch.ops.kernels import _build
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
    before = dict(trace.COUNTS)
    torch.autograd.grad(rb.reflect_conv3x3(x, w, b), (x, w), dy)
    rb.reflect_conv3x3_dx(dy, w.detach())
    rb.reflect_conv3x3_dw(x.detach(), dy)
    assert trace.COUNTS == before
    assert _build.kernel.cache_info().currsize == 0


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


@pytest.mark.parametrize("shape,c_out,sms,route,want", [
    # the trunk at batch 12: 12 blocks of 128 x 128 channels x 3 taps a split,
    # 132 blocks, one wave
    ((12, 64, 64, 256), 256, 132, "bf16_wgmma", 11),
    ((1, 2, 3, 8), 8, 132, "bf16_wgmma", 2),     # capped at one 64-pixel row segment a split
    ((4096, 64, 64, 256), 256, 132, "bf16_wgmma", 11),
    ((2, 9, 9, 264), 520, 132, "bf16_wgmma", 2),  # 45 blocks a split: 90 in one wave
    ((2, 64, 64, 1024), 1024, 132, "bf16_wgmma", 1),   # 192 blocks: more than a wave
    ((12, 64, 64, 256), 256, 132, "f32_fma", 11),  # 48 blocks of 64 x 64 a split, ~4 waves
    ((1, 2, 3, 8), 8, 132, "f32_fma", 2),
])
def test_dw_split_count(shape, c_out, sms, route, want):
    assert rb.dw_splits(shape, c_out, sms, route) == want


@pytest.mark.parametrize("shape,c_out", [((3, 5, 6, 130), 70), ((2, 2, 3, 13), 21),
                                         ((1, 3, 2, 16), 24)])
def test_ragged_bf16_channels_pad_onto_the_wgmma_route(shape, c_out):
    """Channel counts that are not multiples of 8 are zero-padded to them for
    the wgmma route, and the first Cin channels of the padded input gradient
    (the route's split, emulated) are the input gradient; channels of 8 are
    passed through as they are."""
    _, w, _, dy = _inputs(shape, c_out, seed=11)
    dy_t, w_t = torch.from_numpy(dy), torch.from_numpy(w)
    dy_p, w_p = rb.pad_channels(dy_t, 3), rb.pad_channels(w_t, 2, 3)
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


@pytest.mark.parametrize("shape,c_out", [((3, 5, 6, 130), 70), ((2, 2, 3, 13), 21),
                                         ((1, 3, 2, 16), 24), ((1, 2, 5, 8), 13)])
def test_pad_dw_channels(shape, c_out):
    """Channel counts that are not multiples of 8 are zero-padded to them for
    the wgmma route, and the padded pair's weight gradient (the route's
    split, emulated) holds dw in its first Cin x Cout channels; channels of
    8 are passed through as they are."""
    x, _, _, dy = _inputs(shape, c_out, seed=12)
    x_t, dy_t = torch.from_numpy(x), torch.from_numpy(dy)
    x_p, dy_p = rb.pad_channels(x_t, 3), rb.pad_channels(dy_t, 3)
    c_in = shape[3]
    assert x_p.shape == shape[:3] + (-(-c_in // 8) * 8,)
    assert dy_p.shape == shape[:3] + (-(-c_out // 8) * 8,)
    assert (x_p is x_t) == (c_in % 8 == 0) and (dy_p is dy_t) == (c_out % 8 == 0)
    assert torch.equal(x_p[..., :c_in], x_t) and not x_p[..., c_in:].any()
    assert torch.equal(dy_p[..., :c_out], dy_t) and not dy_p[..., c_out:].any()
    got, db = _wgmma_dw_split(x_p, dy_p, splits=3)
    assert not got[:, :, c_in:].any() and not got[..., c_out:].any()
    assert not db[c_out:].any()
    want = rb.reflect_conv3x3_dw_reference(x_t, dy_t).numpy()
    assert _rel(got[:, :, :c_in, :c_out].numpy(), want) <= 1e-5


def _wgmma_dw_split(x, dy, splits):
    """The bf16 wgmma route of csrc/reflect_conv3x3_dw.cu written out in
    plain torch, in float32: the N*H*W pixels cut into image-row segments of
    64 (zero fill past W, as TMA gives), the segments split into ``splits``
    shares in order; per segment and kernel row ky, x's row hr = reflect(h +
    ky - 1) staged from column w0 - 1 to w0 + 64 (zero fill outside the
    image), each of the three taps kx reading the staged slot p + kx through
    x_chunk's remap (slot of column -1 -> column 1, of column W -> W - 2),
    its (64, Cin)^T (64, Cout) product summed into the share's partial; then
    dw_reduce's ordered sum of the partials. Returns (dw, db): db as the
    kernel's DB instance sums it (dw_sum_db): a share's segments dealt out
    to G = 3 x ceil(Cin / 128) groups (the blocks of its kernel rows and
    input-channel tiles: segment j to group j % G), each half of a group's
    segment (pixels 0-31, 32-63) added pixel by pixel in float32 into a
    segment sum, added to that half's sum; a group's partial its first
    half's sum plus its second's; then dw_reduce's sum of the partials in
    the order share, group."""
    n, h, width, c_in = x.shape
    c_out = dy.shape[3]
    xf, dyf = x.float(), dy.float()
    seg, segs_w = 64, -(-width // 64)
    total = n * h * segs_w

    def reflect(i, size):
        return -i if i < 0 else 2 * size - 2 - i if i >= size else i

    part = torch.zeros((splits, 3, 3, c_in, c_out))
    groups = 3 * -(-c_in // 128)
    part_db = torch.zeros((splits, groups, 2, c_out))   # by share, group and half segment
    for s in range(splits):
        lo = total * s // splits
        for g in range(lo, total * (s + 1) // splits):
            w0, row, img = g % segs_w * seg, g // segs_w % h, g // (segs_w * h)
            d = torch.zeros((seg, c_out))
            d[:min(seg, width - w0)] = dyf[img, row, w0:w0 + seg]
            qlo, qhi = (0 if w0 == 0 else -1), width - w0 + 1
            slots = [2 if q == qlo else q - 2 if q == qhi else q for q in range(seg + 2)]
            for ky in range(3):
                xrow = xf[img, reflect(row + ky - 1, h)]
                box = torch.zeros((seg + 2, c_in))   # slot q: column w0 - 1 + q
                for q in range(seg + 2):
                    if 0 <= w0 - 1 + q < width:
                        box[q] = xrow[w0 - 1 + q]
                for kx in range(3):
                    a = box[[slots[p + kx] for p in range(seg)]]
                    part[s, ky, kx] += a.T @ d
            for half in range(2):   # each segment of dy summed once, on group (g - lo) % G
                seg_db = torch.zeros(c_out)
                for p in range(32 * half, 32 * half + 32):
                    seg_db = seg_db + d[p]
                part_db[s, (g - lo) % groups, half] += seg_db
    out = part[0].clone()
    for s in range(1, splits):
        out += part[s]
    db = torch.zeros(c_out)
    for s in range(splits):
        for group in range(groups):
            db = db + (part_db[s, group, 0] + part_db[s, group, 1])
    return out, db


DW_SPLIT_CASES = [
    ((2, 2, 2, 8), 8, 1), ((1, 2, 3, 8), 16, 2), ((1, 3, 2, 8), 8, 3),
    ((2, 3, 3, 16), 8, 4), ((1, 5, 5, 8), 8, 2), ((2, 6, 7, 16), 24, 5),
    ((1, 3, 65, 8), 8, 2),     # two segments a row, the second one pixel wide
    ((1, 2, 130, 8), 16, 3),   # three segments a row, the last two pixels wide
    ((1, 2, 64, 8), 8, 1),     # one whole segment: column W is slot 65
]


@pytest.mark.parametrize("shape,c_out,splits", DW_SPLIT_CASES)
def test_wgmma_dw_split_matches_reference_pallas_and_xla(shape, c_out, splits):
    """The segments, the row reflect by the producer's choice of row, the
    column reflect by the slot remap, the three taps on one staged row and
    the ordered sum of the shares give the weight gradient, at H and W of 2
    and 3 and where W is not a multiple of 64 too."""
    x, _, _, dy = _inputs(shape, c_out, seed=13)
    x_t, dy_t = torch.from_numpy(x), torch.from_numpy(dy)
    got = _wgmma_dw_split(x_t, dy_t, splits)[0].numpy()
    # float32 sums over N*H*W products in another order
    assert _rel(got, rb.reflect_conv3x3_dw_reference(x_t, dy_t).numpy()) <= 1e-5
    assert _rel(got, jax_rb._xla_weight_grad(jnp.asarray(x), jnp.asarray(dy))) <= 1e-4
    assert _rel(got, jax_rb._dw_pallas(jnp.asarray(x), jnp.asarray(dy))) <= 1e-4


@pytest.mark.parametrize("shape,c_out,splits", DW_SPLIT_CASES)
@pytest.mark.parametrize("offset", [0.0, 3.0], ids=["centred", "offset"])
def test_wgmma_db_split_matches_the_stock_sum_and_jax(shape, c_out, splits, offset):
    """The bias gradient as the dw kernel's DB instance sums it (each
    share's segments dealt out to its blocks' groups, half segments of 32
    pixels in order, zero fill past W, partials added in order) is the cotangent's float32 sum over N, H and W, as the stock sum
    and JAX's ``_rc_bwd`` take it, to 1e-6 of the sum of its magnitudes a
    channel, at H and W of 2 and 3, W past a segment, and 1 to 5 shares;
    also where the cotangent is far from centred (the running sums grow)."""
    x, w, _, dy = _inputs(shape, c_out, seed=14)
    x16 = torch.from_numpy(x).bfloat16()
    g = (torch.from_numpy(dy) + offset).bfloat16()
    _, db = _wgmma_dw_split(x16, g, splits)
    assert db.dtype == torch.float32 and db.shape == (c_out,)
    scale = g.double().abs().sum(dim=(0, 1, 2))
    jax_db = jax_rb._rc_bwd((jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(w)),
                            jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))[2]
    for want in (g.float().sum(dim=(0, 1, 2)), torch.from_numpy(np.array(jax_db))):
        assert ((db.double() - want.double()).abs() <= 1e-6 * scale).all()


@pytest.fixture
def recorded_launches(monkeypatch):
    """CPU tensors sent down the kernel path with every launch recorded
    instead of run (``(kernel, args)``: pointers, None for a null one, then
    ints), on a card of 132 SMs, with counters of their own."""
    calls = []
    monkeypatch.setattr(rb, "_on_cpu", lambda t: False)
    monkeypatch.setattr(_build, "launch", lambda name, device, *args: calls.append((name, args)))
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(trace, "COUNTS", {})
    return calls


def _launched(calls, name):
    """The argument lists of the recorded launches of ``name``, each checked
    against the kernel's declared pointer and int counts."""
    got = [args for n, args in calls if n == name]
    _, n_ptr, n_int = _build.KERNELS[name]
    assert all(len(args) == n_ptr + n_int for args in got)
    return got


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bf16_wgmma"),
                                         (torch.float32, "f32_fma")])
def test_backward_asks_the_dw_kernel_for_db(dtype, route, recorded_launches):
    """Where w and b need gradients and the cotangent is in x's dtype, the
    backward launches dw with five pointers, the fifth the db it returns, and
    counts ``trunk.dw.db`` once a launch; it sums nothing itself."""
    x, w, b, dy = map(torch.from_numpy, _inputs((1, 4, 5, 8), 16, seed=15))
    x = x.to(dtype).requires_grad_()
    w, b = w.requires_grad_(), b.requires_grad_()
    splits = rb.dw_splits((1, 4, 5, 8), 16, 132, route)
    for n in (1, 2):
        y = rb.reflect_conv3x3(x, w, b)
        _, dw, db = torch.autograd.grad(y, (x, w, b), dy.to(dtype))
        args = _launched(recorded_launches, "reflect_conv3x3_dw")[n - 1]
        assert args[3] == dw.data_ptr() and args[4] == db.data_ptr()
        assert db.dtype == torch.float32 and db.shape == (16,)
        assert args[5:] == (1, 4, 5, 8, 16, splits, rb.TRUNK_ROUTES.index(route))
        assert trace.COUNTS["trunk.dw.db"] == n and trace.COUNTS[f"trunk.dw.{route}"] == n


def test_backward_keeps_the_stock_sum_where_w_is_frozen(recorded_launches):
    """No weight gradient, no dw launch: db is the stock float32 sum."""
    x, w, b, dy = map(torch.from_numpy, _inputs((1, 4, 5, 8), 8, seed=16))
    x16, g = x.bfloat16().requires_grad_(), dy.bfloat16()
    b.requires_grad_()
    _, db = torch.autograd.grad(rb.reflect_conv3x3(x16, w, b), (x16, b), g)
    assert not _launched(recorded_launches, "reflect_conv3x3_dw")
    assert len(_launched(recorded_launches, "reflect_conv3x3_dx")) == 1
    assert torch.equal(db, g.float().sum(dim=(0, 1, 2)))
    assert "trunk.dw.db" not in trace.COUNTS


def test_bias_free_block_launches_dw_with_a_null_db(recorded_launches):
    """The bias-free ResidualBlock (CycleGAN's) hands the conv an all-zero
    bias that needs no gradient: both dw launches get a null db pointer and
    nothing counts ``trunk.dw.db``."""
    block = ResidualBlock(8, use_bias=False, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_inputs((1, 4, 5, 8), 8, seed=17)[0]).bfloat16().requires_grad_()
    torch.autograd.grad(block(x).float().sum(), [x, *block.parameters()])
    launched = _launched(recorded_launches, "reflect_conv3x3_dw")
    assert len(launched) == 2 and all(args[4] is None for args in launched)
    assert trace.COUNTS["trunk.dw.bf16_wgmma"] == 2 and "trunk.dw.db" not in trace.COUNTS


def test_launch_dw_slices_db_off_padded_channels(recorded_launches):
    """On the wgmma route a Cout of 13 is padded to 16: the kernel gets the
    padded count and a db of 16, and the wrapper returns its first 13."""
    x, _, _, dy = map(torch.from_numpy, _inputs((1, 3, 4, 8), 13, seed=18))
    dw, db = rb._launch_dw(x.bfloat16(), dy.bfloat16(), with_db=True)
    (args,) = _launched(recorded_launches, "reflect_conv3x3_dw")
    assert args[4] == db.data_ptr() and args[9] == 16
    assert db.shape == (13,) and dw.shape == (3, 3, 8, 13)
    assert rb._launch_dw(x.bfloat16(), dy.bfloat16())[1] is None
