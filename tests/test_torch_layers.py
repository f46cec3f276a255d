"""Port's primitives and layers vs the JAX package on the same inputs:
instance norm, padding, Conv2d, ConvTranspose2d, resize, color, precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.core import precision as jax_precision
from gan_variant_research_tpu.models import layers as jax_layers
from gan_variant_research_tpu.ops import color as jax_color
from gan_variant_research_tpu.ops import nn_ops as jax_nn
from gan_variant_research_tpu.ops import resize as jax_resize
from gan_variant_research_tpu_torch.convert import _hwio_to_convtranspose, _hwio_to_oihw, _tensor
from gan_variant_research_tpu_torch.core import precision
from gan_variant_research_tpu_torch.models import layers
from gan_variant_research_tpu_torch.ops import color, nn_ops, resize


def _x(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def test_instance_norm_matches_jax_fp32():
    x = _x((2, 16, 16, 8), scale=2.0, shift=1.0)
    want = np.asarray(jax_nn.instance_norm(jnp.asarray(x)))
    got = nn_ops.instance_norm(torch.from_numpy(x)).numpy()
    # fp32 E[x^2] - mean^2 over 256 positions, reduced in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_instance_norm_rounds_like_jax_in_bf16():
    """The JAX formula (normalise in the input dtype as x*scale - offset) so
    bf16 rounds at the same places: identical outputs."""
    x = _x((2, 16, 16, 8), seed=1, scale=2.0, shift=1.0)
    want = np.asarray(jax_nn.instance_norm(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = nn_ops.instance_norm(torch.from_numpy(x).bfloat16()).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["reflect", "replicate", "zero"])
def test_pad_2d_matches_jax(mode):
    x = _x((2, 5, 6, 3))
    want = np.asarray(jax_layers.pad_2d(jnp.asarray(x), 2, mode))
    got = layers.pad_2d(torch.from_numpy(x), 2, mode)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "reflect":
        np.testing.assert_array_equal(nn_ops.reflect_pad_2d(torch.from_numpy(x), 2).numpy(), want)


@pytest.mark.parametrize("k,stride,pad", [(3, 2, 1), (7, 1, 0), (7, 1, 3), (3, 1, 1)])
def test_conv2d_matches_jax(k, stride, pad):
    x = _x((2, 12, 12, 4))
    mod = jax_layers.Conv2d(6, kernel_size=k, strides=stride, padding=pad)
    params = mod.init(jax.random.PRNGKey(k + stride), jnp.asarray(x))["params"]
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    conv = layers.Conv2d(4, 6, k, strides=stride, padding=pad)
    conv.load_state_dict({"weight": _hwio_to_oihw(params["kernel"]),
                          "bias": _tensor(params["bias"])})
    got = conv(torch.from_numpy(x)).detach().numpy()
    # fp32 convs of <= 196 terms, summed in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_transpose2d_matches_jax():
    """The flipped-HWIO correlation kernel with padding (k-1-p, k-1-p+op)
    equals F.conv_transpose2d on the unflipped, transposed weight."""
    x = _x((2, 8, 8, 6), seed=3)
    mod = jax_layers.ConvTranspose2d(4, kernel_size=3, strides=2, padding=1, output_padding=1)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    convt = layers.ConvTranspose2d(6, 4, 3, strides=2, padding=1, output_padding=1)
    convt.load_state_dict({"weight": _hwio_to_convtranspose(params["kernel"]),
                           "bias": _tensor(params["bias"])})
    got = convt(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layer_init_bounds_are_torch_defaults():
    g = torch.Generator().manual_seed(0)
    conv = layers.Conv2d(4, 6, 3, generator=g)
    convt = layers.ConvTranspose2d(6, 4, 3, generator=g)
    assert conv.weight.abs().max() <= 1 / np.sqrt(9 * 4)
    assert convt.weight.abs().max() <= 1 / np.sqrt(9 * 4)
    assert conv.weight.abs().max() > 0.8 / np.sqrt(9 * 4)
    with pytest.raises(NotImplementedError):
        layers.Conv2d(4, 6, 3, use_spectral_norm=True)


@pytest.mark.parametrize("hw", [(48, 48), (24, 24), (37, 53), (32, 32)])
def test_resize_bilinear_matches_jax(hw):
    x = np.random.default_rng(4).random((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), (32, 32)))
    xt = torch.from_numpy(x)
    got = resize.resize_bilinear(xt, (32, 32))
    # antialiased triangle filter on both sides; fp32 weights in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if hw == (32, 32):
        assert got is xt


def test_color_helpers_match_jax():
    x = np.linspace(-1.2, 1.2, 1001, dtype=np.float32).reshape(1, 7, 11, 13)
    np.testing.assert_array_equal(color.to_uint8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_color.to_uint8(jnp.asarray(x))))
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    np.testing.assert_allclose(color.normalize_to_unit(torch.from_numpy(u8)).numpy(),
                               np.asarray(jax_color.normalize_to_unit(jnp.asarray(u8))),
                               atol=1e-7)
    np.testing.assert_allclose(color.denormalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_color.denormalize(jnp.asarray(x))))


@pytest.mark.parametrize("config", [
    {}, {"runtime": {"precision": "fp32"}}, {"runtime": {"precision": "bf16"}},
    {"amp": False}, {"training": {"amp": False}}, {"io": {"amp": True}},
])
def test_policy_from_config_matches_jax(config):
    got = precision.policy_from_config(config)
    want = jax_precision.policy_from_config(config)
    assert str(got.compute_dtype).split(".")[-1] == jnp.dtype(want.compute_dtype).name
    assert got.param_dtype == torch.float32
    assert got.enabled == want.enabled
