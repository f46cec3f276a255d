"""Port's trunk conv and residual block (``ops/kernels/resblock.py``) vs the
JAX package's Pallas versions, run in interpret mode on the CPU.

On a CPU tensor the wrapper takes its plain version, so these tests hold
that plain version (the CUDA kernel's contract) against the TPU kernel.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.ops.pallas import resblock as jax_rb
from gan_variant_research_tpu_torch.ops.kernels import resblock as rb

REPO_ROOT = Path(__file__).resolve().parents[1]


def _inputs(shape, c_out=None, seed=0):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    c_out = c_out or c
    x = rng.standard_normal(shape).astype(np.float32) * 0.5
    w1 = (rng.standard_normal((3, 3, c, c_out)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c_out, c_out)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _jax_plain_conv(x, w, b):
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    y = jax.lax.conv_general_dilated(
        xp, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return y + b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def flagship_like():
    # the shape test_pallas_resblock.py runs the TPU kernel at in interpret mode
    return _inputs((2, 8, 8, 128))


def test_conv_matches_jax_pallas_kernel(flagship_like):
    x, w1, b1, _, _ = flagship_like
    want = np.asarray(jax_rb.reflect_conv3x3(*map(jnp.asarray, (x, w1, b1))))
    got = rb.reflect_conv3x3(*_t(x, w1, b1)).numpy()
    # fp32 both sides, sums in another order: a few ulps of O(1) outputs
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_fused_resblock_matches_jax_pallas(flagship_like):
    args = flagship_like
    want = np.asarray(jax_rb.fused_resblock(*map(jnp.asarray, args)))
    got = rb.fused_resblock(*_t(*args)).numpy()
    # two convs and two instance norms (1/std amplifies the conv's ulps)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,c_out", [((2, 5, 7, 40), 40), ((1, 2, 3, 3), 5)])
def test_ragged_shapes_match_jax_reference(shape, c_out):
    x, w1, b1, w2, b2 = _inputs(shape, c_out, seed=1)
    got = rb.reflect_conv3x3(*_t(x, w1, b1)).numpy()
    want = np.asarray(_jax_plain_conv(*map(jnp.asarray, (x, w1, b1))))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if c_out == shape[-1]:
        got = rb.fused_resblock(*_t(x, w1, b1, w2, b2)).numpy()
        want = np.asarray(jax_rb.resblock_reference(*map(jnp.asarray, (x, w1, b1, w2, b2))))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing(flagship_like):
    x, w1, b1, _, _ = _t(*flagship_like)
    before = (rb.LAUNCHES, dict(rb.FWD_ROUTE_LAUNCHES))
    got = rb.reflect_conv3x3(x, w1, b1)
    assert torch.equal(got, rb.reflect_conv3x3_reference(x, w1, b1))
    assert (rb.LAUNCHES, rb.FWD_ROUTE_LAUNCHES) == before
    assert rb._forward_fn.cache_info().currsize == 0  # nothing was built


def test_bf16_dtype_contract():
    """bf16 in: w cast to bf16, float32 products and sums, float32 bias added
    before the one cast to bf16."""
    x, w1, b1, _, _ = _t(*_inputs((1, 6, 6, 16), seed=2))
    got = rb.reflect_conv3x3(x.bfloat16(), w1, b1)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    want = rb.reflect_conv3x3(x.bfloat16().float(), w1.bfloat16().float(), b1)
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("bad", ["rank", "dtype", "small", "w_shape", "b_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w, b = _t(*_inputs((1, 4, 4, 8))[:3])
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.half()
    elif bad == "small":
        x = x[:, :1]
    elif bad == "w_shape":
        w = w[:2]
    else:
        b = b[:3]
    with pytest.raises((ValueError, TypeError)):
        rb.reflect_conv3x3(x, w, b)


def test_module_imports_and_runs_without_nvcc(tmp_path):
    """Importing the kernel modules builds nothing, and the CPU path needs no
    compiler: run them with an empty PATH."""
    code = (
        "import torch\n"
        "from gan_variant_research_tpu_torch.ops.kernels import resblock as rb\n"
        "y = rb.reflect_conv3x3(torch.ones(1, 3, 3, 2), torch.ones(3, 3, 2, 4), torch.zeros(4))\n"
        "assert float(y[0, 1, 1, 0]) == 18.0 and rb.LAUNCHES == 0\n"
        "from gan_variant_research_tpu_torch.ops.kernels import _build\n"
        "assert not _build.BUILD_DIR.exists() or _build.library_path('reflect_conv3x3').parent == _build.BUILD_DIR\n"
    )
    env = {"PATH": str(tmp_path), "PYTHONPATH": str(REPO_ROOT),
           "HOME": os.environ.get("HOME", str(tmp_path))}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# --------------------------------------------------------------------------- #
# the bf16 wgmma route of csrc/reflect_conv3x3.cu, its index arithmetic
# written out in plain torch


def _reflect(i, size):
    return -i if i < 0 else 2 * size - 2 - i if i >= size else i


def _bf16_ulp(r):
    """One bf16 unit in the last place of each value (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(r.float().abs().clamp_min(2.0 ** -126))) - 7)


def _wgmma_fwd_split(x, w, b):
    """The bf16 wgmma route of csrc/reflect_conv3x3.cu written out in plain
    torch, in float32: tiles of two output rows y0, y0 + 1, each a segment
    of 64 pixels from column x0, and 256 output channels; the x stage holds
    the four input rows reflect(y0 - 1) .. reflect(y0 + 2) that the
    producer picks, each a box of 66 columns from x0 - 1 (zero outside the
    image and past Cin, as TMA fills it); consumer cw reads staged row cw +
    ky, each pixel p of its segment at slot p + kx through the lane's remap
    (the slot of column -1 reads column 1, that of column W reads column W
    - 2); the nine taps of each 64-channel chunk add float32 (64, 64) x (64,
    256) products into the tile's accumulator, then the float32 bias. Returns
    that float32 value, which the epilogue casts once to x's dtype; every
    output is written by exactly one tile."""
    n, h, width, c_in = x.shape
    c_out = w.shape[3]
    assert c_in % 8 == 0 and c_out % 8 == 0, "the route takes channels of 8"
    seg, bn, bk = 64, 256, 64
    k_pad, n_pad = -(-c_in // bk) * bk, -(-c_out // bn) * bn
    xf = x.float()
    wf = torch.zeros((3, 3, k_pad, n_pad))
    wf[:, :, :c_in, :c_out] = w.to(x.dtype).float()
    bias = torch.zeros(n_pad)
    bias[:c_out] = b.float()
    y = torch.full((n, h, width, c_out), float("nan"))
    for img in range(n):
        for y0 in range(0, h, 2):
            rows = [_reflect(y0 - 1 + i, h) for i in range(4)]
            for x0 in range(0, width, seg):
                box = torch.zeros((4, seg + 2, k_pad))   # slot q: column x0 - 1 + q
                for q in range(seg + 2):
                    if 0 <= x0 - 1 + q < width:
                        box[:, q, :c_in] = xf[img, rows, x0 - 1 + q]
                qlo, qhi = (0 if x0 == 0 else -1), width - x0 + 1
                slots = [[2 if q == qlo else q - 2 if q == qhi else q
                          for q in range(kx, seg + kx)] for kx in range(3)]
                valid = min(seg, width - x0)
                for co0 in range(0, c_out, bn):
                    for cw in range(2):
                        acc = torch.zeros((seg, bn))
                        for c0 in range(0, k_pad, bk):
                            for tap in range(9):
                                ky, kx = divmod(tap, 3)
                                a = box[cw + ky, slots[kx], c0:c0 + bk]
                                acc += a @ wf[ky, kx, c0:c0 + bk, co0:co0 + bn]
                        oy = y0 + cw
                        if oy < h:
                            out = acc + bias[co0:co0 + bn]
                            cols = min(bn, c_out - co0)
                            assert y[img, oy, x0:x0 + valid, co0:co0 + cols].isnan().all()
                            y[img, oy, x0:x0 + valid, co0:co0 + cols] = out[:valid, :cols]
    assert not y.isnan().any()
    return y


def _bf16_inputs(shape, c_out, seed):
    x, w, b, _, _ = _inputs(shape, c_out, seed=seed)
    return torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), torch.from_numpy(b)


def _check_fwd_split(got, xb, wb, bt):
    """The route's float32 value against the plain version and the JAX
    Pallas forward (interpret mode) on the same bf16 values in float32, and
    its one cast against the plain version's bf16 output."""
    # float32 sums of 9 * Cin exact products in another order
    want = rb.reflect_conv3x3_reference(xb.float(), wb.float(), bt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    pallas = np.asarray(jax_rb.reflect_conv3x3(
        jnp.asarray(xb.float().numpy()), jnp.asarray(wb.float().numpy()), jnp.asarray(bt.numpy())))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    # each side rounds its float32 sum once: one bf16 ulp apart at most, plus
    # the float32 sums' difference (as chip_smoke.py holds the kernel)
    ref16 = rb.reflect_conv3x3_reference(xb, wb, bt).float()
    tol = 2e-5 + 2e-5 * ref16.abs() + _bf16_ulp(ref16)
    assert bool(((got.bfloat16().float() - ref16).abs() <= tol).all())


@pytest.mark.parametrize("shape,c_out", [
    ((1, 2, 2, 8), 8),        # H, W of 2: reflect(y0 + 2) folds back into the tile
    ((1, 3, 5, 8), 16),       # H of 3: the second tile's row y0 + 1 is past H
    ((2, 5, 7, 40), 40),      # a Cin chunk partly past Cin
    ((1, 3, 65, 16), 24),     # W of 65: the last segment one pixel wide
    ((1, 3, 129, 8), 8),      # W of 129: its reflect target in the box's first slot
    ((2, 4, 9, 264), 520),    # Cin past 256, Cout past two 256-wide tiles
])
def test_wgmma_fwd_split_matches_reference_and_pallas(shape, c_out):
    """The tiles, the four rows the producer picks, the 66-column box, each
    lane's remapped column and the nine taps' float32 sums give the conv, at
    H and W of 2 and 3 and where W and the channels are not multiples of the
    tile."""
    xb, wb, bt = _bf16_inputs(shape, c_out, seed=21)
    _check_fwd_split(_wgmma_fwd_split(xb, wb, bt), xb, wb, bt)


@pytest.mark.parametrize("shape,c_out", [((2, 2, 3, 13), 21), ((1, 5, 4, 13), 21)])
def test_wgmma_fwd_split_on_padded_ragged_channels(shape, c_out):
    """Channel counts that are not multiples of 8 go through the route
    zero-padded (``pad_fwd_channels``): the first Cout channels are the
    conv, the padded ones 0."""
    xb, wb, bt = _bf16_inputs(shape, c_out, seed=22)
    got = _wgmma_fwd_split(*rb.pad_fwd_channels(xb, wb, bt))
    assert got.shape == shape[:3] + (24,) and not got[..., c_out:].any()
    _check_fwd_split(got[..., :c_out].contiguous(), xb, wb, bt)


@pytest.mark.parametrize("shape,c_out", [((3, 5, 6, 130), 70), ((2, 2, 3, 13), 21),
                                         ((1, 3, 2, 16), 24), ((1, 2, 5, 8), 13)])
def test_pad_fwd_channels(shape, c_out):
    """x, w and b zero-padded to channels of 8; channels of 8 passed through
    as they are."""
    xb, wb, bt = _bf16_inputs(shape, c_out, seed=23)
    x_p, w_p, b_p = rb.pad_fwd_channels(xb, wb, bt)
    c_in, ci_p, co_p = shape[3], -(-shape[3] // 8) * 8, -(-c_out // 8) * 8
    assert x_p.shape == shape[:3] + (ci_p,) and w_p.shape == (3, 3, ci_p, co_p)
    assert b_p.shape == (co_p,)
    assert (x_p is xb) == (c_in % 8 == 0) and (b_p is bt) == (c_out % 8 == 0)
    assert (w_p is wb) == (c_in % 8 == 0 and c_out % 8 == 0)
    assert torch.equal(x_p[..., :c_in], xb) and not x_p[..., c_in:].any()
    assert torch.equal(w_p[:, :, :c_in, :c_out], wb)
    assert not w_p[:, :, c_in:].any() and not w_p[..., c_out:].any()
    assert torch.equal(b_p[:c_out], bt) and not b_p[c_out:].any()


@pytest.mark.parametrize("shape,c_out,dtype,route", [
    ((12, 64, 64, 256), 256, torch.bfloat16, "bf16_wgmma"),     # train_gan_cutpp.yaml's trunk
    ((32, 64, 64, 256), 256, torch.bfloat16, "bf16_wgmma"),     # a served batch of 32
    ((4, 128, 128, 256), 256, torch.bfloat16, "bf16_wgmma"),    # train_gan_cutpp_512.yaml's
    ((2, 2, 3, 13), 21, torch.bfloat16, "bf16_wgmma"),          # both padded to 8
    ((12, 64, 64, 256), 256, torch.float32, "f32_fma"),
])
def test_fwd_route(shape, c_out, dtype, route):
    assert rb.fwd_route(shape, c_out, dtype) == route
    assert route in rb.FWD_ROUTES and set(rb.FWD_ROUTE_LAUNCHES) == set(rb.FWD_ROUTES)


def test_fwd_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        rb.fwd_route((1, 4, 4, 8), 8, torch.float16)
