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
    before = rb.LAUNCHES
    got = rb.reflect_conv3x3(x, w1, b1)
    assert torch.equal(got, rb.reflect_conv3x3_reference(x, w1, b1))
    assert rb.LAUNCHES == before
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
