"""The port's instance norm (``ops/kernels/instance_norm.py``): the plain
versions that ``csrc/instance_norm.cu`` mirrors against autograd of the
stock chain (``ops/nn_ops.py::instance_norm``) and against JAX, the route,
the Function's autograd wiring (on the CPU, its launches replaced by those
plain versions), the counters, and the kernels' split count."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.ops import nn_ops as jax_nn
from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.models.generator_resnet import ResNetGenerator
from gan_variant_research_tpu_torch.ops import nn_ops
from gan_variant_research_tpu_torch.ops.kernels import _build
from gan_variant_research_tpu_torch.ops.kernels import instance_norm as inm

SHAPES = [(2, 8, 8, 16), (2, 31, 31, 24), (1, 4, 4, 3)]
DTYPES = [torch.float32, torch.bfloat16]
CONSTANT = 0.7   # one channel of every input: at 31 x 31 its variance sums to < 0


def _inputs(shape, dtype, seed=0, constant=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(shape) * 1.5 + 0.4).astype(np.float32)).to(dtype)
    if constant:
        x[..., 0] = CONSTANT
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return x, g


def _chain(x, relu):
    y = nn_ops.instance_norm(x)
    return torch.relu(y) if relu else y


def _ulp(r: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each value (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(r.float().abs().clamp_min(2.0 ** -126))) - 7)


def _counts(prefix="norm."):
    return {k: v for k, v in trace.COUNTS.items() if k.startswith(prefix)}


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in _counts().items() if v != before.get(k, 0)}


@pytest.fixture
def plain_launches(monkeypatch):
    """``_InstanceNorm``'s two launches replaced by the plain versions the
    kernels mirror, so that the Function runs on a CPU tensor."""
    def forward(x, eps, relu):
        stats = inm.instance_norm_stats_reference(x)
        return x, inm.instance_norm_apply_reference(x, stats, relu, eps), stats

    def backward(g, x, stats, eps, relu):
        return inm.instance_norm_backward_reference(g.to(x.dtype), x, stats, relu, eps)

    monkeypatch.setattr(inm, "_launch_forward", forward)
    monkeypatch.setattr(inm, "_launch_backward", backward)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_reference_matches_autograd_of_the_chain(shape, dtype, relu):
    """The hand-derived backward against autograd of the stock chain (and
    ReLU). float32: 1e-6 relative by norm (float32 sums in another order).
    bf16: autograd rounds g'*scale, a + b*x and their sum to bf16, the
    hand-derived backward (as the kernel) only the sum, so each value lies
    within 2 bf16 ulps of the larger of the two terms (a half ulp for each
    of the four roundings)."""
    x, g = _inputs(shape, dtype)
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad(_chain(xr, relu), xr, g)
    stats = inm.instance_norm_stats_reference(x)
    got = inm.instance_norm_backward_reference(g, x, stats, relu)
    assert got.dtype == dtype and got.shape == x.shape
    if shape == (2, 31, 31, 24):
        assert bool((stats[:, 1, 0] < 0).all())   # the clamp bites on the constant channel
    if dtype == torch.float32:
        assert float((got - want).norm() / want.norm()) <= 1e-6
        return
    scale = torch.rsqrt(stats[:, 1].clamp(min=0) + 1e-5).bfloat16().float()[:, None, None, :]
    kept = g.float() if not relu else torch.where(_chain(x, True) > 0, g.float(), 0.0)
    t1 = kept * scale
    larger = torch.maximum(t1.abs(), (want.float() - t1).abs())
    assert float(((got.float() - want.float()).abs() / _ulp(larger)).max()) <= 2.0


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_reference_matches_jax_vjp_in_float32(shape, relu):
    """Against the JAX package's norm, without the constant channel: there
    the gradient scales with inv^3 of a variance that rounding alone sets."""
    x, g = _inputs(shape, torch.float32, seed=1, constant=False)

    def jax_norm(a):
        y = jax_nn.instance_norm(a)
        return jax.nn.relu(y) if relu else y

    _, vjp = jax.vjp(jax_norm, jnp.asarray(x.numpy()))
    want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    got = inm.instance_norm_backward_reference(g, x, inm.instance_norm_stats_reference(x), relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_function_on_the_cpu_is_the_chain_bitwise(shape, dtype, relu, plain_launches):
    """``_InstanceNorm`` with the plain versions for its launches: the
    statistics then the apply are today's chain bit for bit, and autograd
    hands the cotangent and the saved x and statistics to the hand-derived
    backward; nothing is built or counted."""
    x, g = _inputs(shape, dtype, seed=2)
    before = dict(trace.COUNTS)
    xr = x.clone().requires_grad_()
    y = inm._InstanceNorm.apply(xr, 1e-5, relu)
    assert torch.equal(y, _chain(x, relu))
    dx, = torch.autograd.grad(y, xr, g)
    stats = inm.instance_norm_stats_reference(x)
    assert torch.equal(dx, inm.instance_norm_backward_reference(g, x, stats, relu))
    assert trace.COUNTS == before
    assert _build.kernel.cache_info().currsize == 0


def test_function_refuses_double_backward(plain_launches):
    x, g = _inputs((1, 4, 4, 8), torch.bfloat16)
    xr = x.clone().requires_grad_()
    dx, = torch.autograd.grad(inm._InstanceNorm.apply(xr, 1e-5, True), xr, g, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dx.float().sum(), xr)


@pytest.mark.parametrize("device,dtype,route", [
    ("cuda", torch.bfloat16, "kernel"), ("cuda", torch.float32, "plain"),
    ("cuda", torch.float16, "plain"), ("cpu", torch.bfloat16, "plain"),
    ("cpu", torch.float32, "plain")])
def test_route_is_the_kernel_only_for_bf16_on_cuda(device, dtype, route):
    x = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert inm.norm_route(x) == route
    assert route in inm.ROUTES


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_wrapper_on_the_cpu_runs_the_chain_and_counts_plain(dtype, relu):
    x, g = _inputs((2, 31, 31, 24), dtype, seed=3)
    before = _counts()
    xr = x.clone().requires_grad_()
    y = inm.instance_norm(xr, relu=relu)
    assert torch.equal(y, _chain(x, relu))
    dx, = torch.autograd.grad(y, xr, g)
    xw = x.clone().requires_grad_()
    assert torch.equal(dx, torch.autograd.grad(_chain(xw, relu), xw, g)[0])
    assert _delta(before) == {"norm.fwd.plain": 1, "norm.bwd.plain": 1}
    with torch.no_grad():
        inm.instance_norm(x, relu=relu)
    assert _delta(before) == {"norm.fwd.plain": 2, "norm.bwd.plain": 1}
    assert _build.kernel.cache_info().currsize == 0


def test_float32_route_keeps_double_backward():
    """R1-style grad of a grad through the plain float32 route, as autograd
    of the chain gives it."""
    x, g = _inputs((2, 8, 8, 16), torch.float32, seed=4)
    grads = []
    for norm in (lambda a: inm.instance_norm(a, relu=True), lambda a: _chain(a, True)):
        xr = x.clone().requires_grad_()
        dx, = torch.autograd.grad((norm(xr) * g).sum(), xr, create_graph=True)
        grads.append(torch.autograd.grad(dx.square().sum(), xr)[0])
    assert torch.isfinite(grads[0]).all() and torch.equal(grads[0], grads[1])


def test_generator_counts_one_norm_a_stage():
    """Stem, 2 downsamplings, 2 x n_blocks trunk norms and 2 upsamplings:
    each one call of the norm forward, and one of its backward."""
    net = ResNetGenerator(ngf=4, n_blocks=2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    before = _counts()
    net(x).square().mean().backward()
    assert _delta(before) == {"norm.fwd.plain": 9, "norm.bwd.plain": 9}


@pytest.mark.parametrize("shape,sms,want", [
    ((12, 256, 256, 64), 132, 44), ((12, 128, 128, 128), 132, 44),
    ((12, 64, 64, 256), 132, 44), ((32, 64, 64, 256), 132, 16),
    ((16, 31, 31, 512), 132, 16), ((16, 64, 64, 128), 132, 33),
    ((1, 4, 4, 3), 132, 1), ((2, 31, 31, 24), 132, 2), ((48, 256, 256, 64), 132, 11)])
def test_norm_splits_fill_one_wave(shape, sms, want):
    """S shares of the pixels a (n, channel block): the grid fits one wave
    of four 256-thread blocks an SM, each thread at least 4 rows of pixels
    (16 or 32 bytes of one pixel's channels a thread in a row)."""
    n, h, w, c = shape
    splits = inm.norm_splits(shape, sms)
    assert splits == want
    vectors = c // 8 if c % 8 == 0 else c
    txn = min(vectors, 32)
    rows = 256 // txn
    blocks = n * -(-vectors // txn)
    assert splits == 1 or (blocks * splits <= 4 * sms and -(-h * w // splits) >= 4 * rows)
    assert splits == max(1, h * w // (4 * rows)) or blocks * (splits + 1) > 4 * sms
