"""The port's U-Net generator (CycleGAN's ``model.generator: unet``) against
the flax module: the affine instance norm, the stride-2 ``'SAME'`` conv
(padding (0, 1) at an even size), the ``'SAME'`` transposed conv (the
dilated input padded (2, 1), the kernel not flipped), and the whole
generator at 32^2 in value and gradient (the parts to 1e-5 of the largest
value; the whole, 12 convs and 15 norms deep, to 2e-5); and the strict
weight conversion both ways. float32, JAX on the CPU, inputs from numpy seeds."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.models import generator_unet as jax_unet
from gan_variant_research_tpu_torch.convert import (
    jax_tree_from_state_dict,
    unet_state_dict_from_jax,
)
from gan_variant_research_tpu_torch.models import generator_unet as unet

NGF = 4


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


def _jitter(tree, seed):
    """The flax init (biases 0, gamma 1, beta 0) moved by N(0, 0.2): every
    leaf takes part."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.2, a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def flax_unet():
    net = jax_unet.UNetGenerator(ngf=NGF)
    params = net.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return net, _jitter(params, 1)


def test_affine_instance_norm_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 2.0, (2, 8, 6, 5)).astype(np.float32)
    mod = jax_unet.AffineInstanceNorm()
    params = _jitter(mod.init(jax.random.key(0), x)["params"], 3)
    want = mod.apply({"params": params}, x)
    norm = unet.AffineInstanceNorm(5)
    norm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    assert _rel(norm(torch.from_numpy(x)), want) <= 1e-5


@pytest.mark.parametrize("size,kernel,stride", [(16, 3, 2), (15, 3, 2), (16, 7, 1), (9, 3, 1)])
def test_same_conv_matches_flax(size, kernel, stride):
    """Keras 'same': (0, 1) at an even size and stride 2, (1, 1) at an odd
    one; k - 1 split evenly at stride 1."""
    rng = np.random.default_rng(size * kernel)
    x = rng.normal(size=(2, size, size + 2, 6)).astype(np.float32)
    mod = jax_unet._SameConv(8, kernel, strides=stride)
    params = _jitter(mod.init(jax.random.key(0), x)["params"], 4)
    want = mod.apply({"params": params}, x)
    conv = unet._SameConv(6, 8, kernel, stride)
    conv.Conv_0.load_state_dict({
        "weight": torch.from_numpy(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(params["Conv_0"]["bias"])})
    got = conv(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5
    if size % 2 == 0 and stride == 2:
        assert unet.same_padding(size, kernel, stride) == (0, 1)


@pytest.mark.parametrize("size", [8, 7])
def test_same_conv_transpose_matches_flax(size):
    """flax ConvTranspose(3, strides 2, 'SAME'): 2H x 2W out; torch's
    conv_transpose2d on the flipped kernel, its first 2H rows and columns."""
    from gan_variant_research_tpu_torch.convert import _hwio_to_convtranspose

    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 1, 6)).astype(np.float32)
    mod = fnn.ConvTranspose(5, (3, 3), strides=(2, 2), padding="SAME")
    params = _jitter(mod.init(jax.random.key(0), x)["params"], 5)
    want = mod.apply({"params": params}, x)
    up = unet._SameConvTranspose(6, 5)
    up.load_state_dict({"weight": _hwio_to_convtranspose(params["kernel"]),
                        "bias": torch.from_numpy(params["bias"])})
    got = up(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 2 * size, 2 * (size + 1), 5)
    assert _rel(got, want) <= 1e-5


def test_unet_matches_flax_in_value_and_gradient(flax_unet):
    net, params = flax_unet
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    r = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = net.apply({"params": params}, x)
    grads, gx = jax.grad(lambda p, x: jnp.sum(net.apply({"params": p}, x) * r),
                         argnums=(0, 1))(params, x)

    port = unet.UNetGenerator(ngf=NGF)
    port.load_state_dict(unet_state_dict_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_()
    yt = port(xt)
    assert yt.shape == y.shape and _rel(yt, y) <= 2e-5
    (yt * torch.from_numpy(r)).sum().backward()
    assert _rel(xt.grad, gx) <= 2e-5
    want = unet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in port.named_parameters():
        if name.endswith(".bias") and not name.startswith("_SameConv_11."):
            # an instance norm follows: the gradient is 0 up to rounding
            assert float(p.grad.abs().max()) <= 1e-4, name
        else:
            assert _rel(p.grad, want[name]) <= 2e-5, name


def test_unet_runs_in_bf16(flax_unet):
    _, params = flax_unet
    port = unet.UNetGenerator(ngf=NGF, dtype=torch.bfloat16)
    port.load_state_dict(unet_state_dict_from_jax(params))
    y = port(torch.zeros((1, 32, 32, 3)))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 32, 32, 3)


def test_conversion_round_trips_and_is_strict(flax_unet):
    _, params = flax_unet
    sd = unet_state_dict_from_jax(params)
    assert set(sd) == set(unet.UNetGenerator(ngf=NGF).state_dict())
    back = jax_tree_from_state_dict(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got.numpy(), want)

    def broken(edit):
        tree = jax.tree_util.tree_map(lambda a: a, params)
        edit(tree)
        with pytest.raises(ValueError):
            unet_state_dict_from_jax(tree)

    broken(lambda t: t["_SameConv_3"]["Conv_0"].pop("bias"))
    broken(lambda t: t["AffineInstanceNorm_2"].update(extra=np.zeros(1, np.float32)))
    broken(lambda t: t.pop("ConvTranspose_1"))
    broken(lambda t: t.update(_SameConv_12={"Conv_0": t["_SameConv_0"]["Conv_0"]}))
    broken(lambda t: t["_SameConv_0"].update(Conv_1=t["_SameConv_0"]["Conv_0"]))


def test_init_is_glorot_with_zero_biases():
    net = unet.UNetGenerator(ngf=NGF, generator=torch.Generator().manual_seed(0))
    w = net.ConvTranspose_0.weight                      # (in, out, 3, 3)
    bound = (6.0 / (9 * w.shape[0] + 9 * w.shape[1])) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert all(float(b.abs().max()) == 0 for n, b in net.named_parameters()
               if n.endswith(("bias", "beta")))
    assert all(torch.equal(g, torch.ones_like(g)) for n, g in net.named_parameters()
               if n.endswith("gamma"))
