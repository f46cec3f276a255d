"""The U-Net's affine instance norm (``ops/kernels/instance_norm.py::
affine_instance_norm``): the plain versions that ``csrc/instance_norm.cu``'s
affine instance mirrors, against autograd of the stock chain
(``ops/nn_ops.py::affine_instance_norm``) and against the JAX package's
``AffineInstanceNorm``; the Function's autograd wiring (on the CPU, its
launches replaced by those plain versions), the route, the counters, the
U-Net's graph on the CPU; and, marked ``card``, the kernel pair against the
chain on the card at the U-Net's norm shapes.

The card tests skip without CUDA. On the card (no JAX there, so no
``tests/conftest.py``): ``python -m pytest --noconftest -m card
tests/test_torch_affine_instance_norm.py``. JAX is imported inside the two
tests that compare with it."""

import types

import numpy as np
import pytest
import torch

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.models import generator_unet as unet
from gan_variant_research_tpu_torch.ops import nn_ops
from gan_variant_research_tpu_torch.ops.kernels import _build
from gan_variant_research_tpu_torch.ops.kernels import instance_norm as inm

# the U-Net's five norm shapes (256^2 x 64 down to 16^2 x 512) scaled down,
# a ragged one, and channels that are not a multiple of 8
SHAPES = [(2, 16, 16, 8), (2, 8, 8, 16), (3, 4, 4, 32), (2, 2, 2, 64), (1, 31, 31, 24),
          (2, 5, 5, 3)]
DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-5


def _ids(shape):
    return "x".join(map(str, shape))


def _inputs(shape, dtype, seed=0, device="cpu", offset=0.4, std=1.5):
    """x, the cotangent g (both in ``dtype``), gamma in [0.5, 1.5) and beta
    in [-0.5, 0.5) (float32), from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(shape) * std + offset).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, shape[3]).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(-0.5, 0.5, shape[3]).astype(np.float32))
    return (x.to(device, dtype), g.to(device, dtype), gamma.to(device), beta.to(device))


def _chain(x, gamma, beta, relu):
    y = nn_ops.affine_instance_norm(x, gamma, beta, EPS)
    return torch.relu(y) if relu else y


def _chain_grads(x, g, gamma, beta, relu):
    """(y, dx, dgamma, dbeta) of the stock chain by autograd."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    y = _chain(*leaves, relu)
    return (y.detach(), *torch.autograd.grad(y, leaves, g))


def _ulp(r: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each value (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(r.float().abs().clamp_min(2.0 ** -126))) - 7)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _counts(prefix="unet.norm"):
    return {k: v for k, v in trace.COUNTS.items() if k.startswith(prefix)}


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in _counts().items() if v != before.get(k, 0)}


@pytest.fixture
def plain_launches(monkeypatch):
    """``_AffineInstanceNorm``'s two launches replaced by the plain versions
    the kernels mirror, so that the Function runs on a CPU tensor."""
    def forward(x, gamma, beta, eps, relu):
        stats = inm.affine_norm_stats_reference(x)
        return x, inm.affine_norm_apply_reference(x, stats, gamma, beta, relu, eps), stats

    def backward(g, x, stats, gamma, beta, eps, relu):
        return inm.affine_norm_backward_reference(g.to(x.dtype), x, stats, gamma, beta, relu, eps)

    monkeypatch.setattr(inm, "_launch_affine_forward", forward)
    monkeypatch.setattr(inm, "_launch_affine_backward", backward)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_forward_references_are_the_chain_bitwise(shape, dtype, relu):
    """The statistics (float32 mean and centred variance) and the apply on
    them are the stock chain's arithmetic, bit for bit on the CPU."""
    x, _, gamma, beta = _inputs(shape, dtype)
    stats = inm.affine_norm_stats_reference(x)
    assert stats.shape == (shape[0], 2, shape[3]) and stats.dtype == torch.float32
    y = inm.affine_norm_apply_reference(x, stats, gamma, beta, relu, EPS)
    assert y.dtype == dtype and torch.equal(y, _chain(x, gamma, beta, relu))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_backward_reference_matches_autograd_of_the_chain(shape, dtype, relu):
    """The hand-derived dx, dgamma and dbeta against autograd of the chain
    (and ReLU). float32: 1e-6 relative by norm (float32 sums in another
    order; measured at most 2.7e-7 over 20 seeds). bf16: autograd also
    computes in float32 and rounds dx once, so the two lie within one bf16
    ulp of the larger of dx and the largest of its three terms gamma * r *
    (g', S1 / HW, xhat * S2 / HW) (where they cancel, float32 rounding of
    the terms moves dx by more than its own ulp); dgamma and dbeta, float32
    in both, to 1e-6 by norm."""
    x, g, gamma, beta = _inputs(shape, dtype, seed=1)
    _, *want = _chain_grads(x, g, gamma, beta, relu)
    stats = inm.affine_norm_stats_reference(x)
    dx, dgamma, dbeta = inm.affine_norm_backward_reference(g, x, stats, gamma, beta, relu, EPS)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dgamma.dtype == dbeta.dtype == torch.float32 and dgamma.shape == (shape[3],)
    assert _rel(dgamma, want[1]) <= 1e-6 and _rel(dbeta, want[2]) <= 1e-6
    if dtype == torch.float32:
        assert _rel(dx, want[0]) <= 1e-6
        return
    y = inm.affine_norm_apply_reference(x, stats, gamma, beta, False, EPS)
    kept = torch.where(y > 0, g, 0).float() if relu else g.float()
    centred = x.float() - stats[:, 0, None, None]
    r = torch.rsqrt(stats[:, 1, None, None] + EPS)
    xhat, hw = centred * r, shape[1] * shape[2]
    s1 = kept.sum(dim=(1, 2), keepdim=True) / hw
    s2 = (kept * xhat).sum(dim=(1, 2), keepdim=True) / hw
    terms = torch.maximum(torch.maximum(kept.abs(), s1.abs().expand_as(kept)), (xhat * s2).abs())
    larger = torch.maximum((gamma * r).abs() * terms, want[0].float().abs())
    assert float(((dx.float() - want[0].float()).abs() / _ulp(larger)).max()) <= 1.0


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_backward_reference_matches_jax_vjp_in_float32(shape, relu):
    """Against ``jax.vjp`` of the JAX package's ``AffineInstanceNorm`` (then
    ``jax.nn.relu``) in x, gamma and beta: to 1e-5 of each gradient's
    largest value (measured at most 1.0e-6 over 3 seeds)."""
    import jax
    import jax.numpy as jnp

    from gan_variant_research_tpu.models import generator_unet as jax_unet

    x, g, gamma, beta = _inputs(shape, torch.float32, seed=2)
    mod = jax_unet.AffineInstanceNorm()

    def norm(a, gam, bet):
        y = mod.apply({"params": {"gamma": gam, "beta": bet}}, a)
        return jax.nn.relu(y) if relu else y

    _, vjp = jax.vjp(norm, *(jnp.asarray(t.numpy()) for t in (x, gamma, beta)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g.numpy()))]
    stats = inm.affine_norm_stats_reference(x)
    got = inm.affine_norm_backward_reference(g, x, stats, gamma, beta, relu, EPS)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_function_on_the_cpu_is_the_chain_bitwise(shape, dtype, relu, plain_launches):
    """``_AffineInstanceNorm`` with the plain versions for its launches: the
    forward is the stock chain bit for bit, and autograd hands the cotangent,
    the saved x, gamma, beta and statistics to the hand-derived backward,
    whose dgamma and dbeta reach gamma and beta; nothing is built or
    counted."""
    x, g, gamma, beta = _inputs(shape, dtype, seed=3)
    before = dict(trace.COUNTS)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y = inm._AffineInstanceNorm.apply(*leaves, EPS, relu)
    assert torch.equal(y, _chain(x, gamma, beta, relu))
    got = torch.autograd.grad(y, leaves, g)
    stats = inm.affine_norm_stats_reference(x)
    want = inm.affine_norm_backward_reference(g, x, stats, gamma, beta, relu, EPS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trace.COUNTS == before
    assert _build.kernel.cache_info().currsize == 0


def test_function_refuses_double_backward(plain_launches):
    x, g, gamma, beta = _inputs((1, 4, 4, 8), torch.bfloat16)
    xr = x.clone().requires_grad_()
    dx, = torch.autograd.grad(inm._AffineInstanceNorm.apply(xr, gamma, beta, EPS, True), xr, g,
                              create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dx.float().sum(), xr)


@pytest.mark.parametrize("device,dtype,route", [
    ("cuda", torch.bfloat16, "kernel"), ("cuda", torch.float32, "plain"),
    ("cuda", torch.float16, "plain"), ("cpu", torch.bfloat16, "plain"),
    ("cpu", torch.float32, "plain")])
def test_route_is_the_kernel_only_for_bf16_on_cuda(device, dtype, route, monkeypatch,
                                                   plain_launches):
    """The wrapper takes ``_AffineInstanceNorm`` exactly where ``norm_route``
    says ``kernel``, a bf16 CUDA tensor; here the route is asked of a
    stand-in with the device and dtype, and the CPU tensor follows it."""
    assert inm.norm_route(types.SimpleNamespace(device=torch.device(device), dtype=dtype)) == route
    monkeypatch.setattr(inm, "norm_route", lambda t: route)
    x, _, gamma, beta = _inputs((1, 4, 4, 8), torch.bfloat16)
    y = inm.affine_instance_norm(x.requires_grad_(), gamma, beta, EPS, True)
    function = type(y.grad_fn).__name__ == "_AffineInstanceNormBackward"
    assert function == (route == "kernel")


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_wrapper_on_the_cpu_runs_the_chain_and_counts_plain(dtype, relu):
    """The CPU route is the chain, value and autograd graph, counted as
    ``unet.norm.fwd.plain`` a call and ``unet.norm.bwd.plain`` a backward."""
    x, g, gamma, beta = _inputs((2, 31, 31, 24), dtype, seed=4)
    before = _counts()
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y = inm.affine_instance_norm(*leaves, EPS, relu)
    want_y, *want = _chain_grads(x, g, gamma, beta, relu)
    assert torch.equal(y, want_y)
    got = torch.autograd.grad(y, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _delta(before) == {"unet.norm.fwd.plain": 1, "unet.norm.bwd.plain": 1}
    with torch.no_grad():
        inm.affine_instance_norm(x, gamma, beta, EPS, relu)
    assert _delta(before) == {"unet.norm.fwd.plain": 2, "unet.norm.bwd.plain": 1}
    assert _build.kernel.cache_info().currsize == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, _, gamma, beta = _inputs((1, 4, 4, 8), torch.float32)
    with pytest.raises(ValueError):
        inm.affine_instance_norm(x[0], gamma, beta)
    with pytest.raises(ValueError):
        inm.affine_instance_norm(x, gamma[:4], beta)


def _old_unet_forward(monkeypatch):
    """The U-Net as it was before its norms took the ReLU: the chain in
    ``AffineInstanceNorm.forward``, ``torch.relu`` in ``_conv_block``."""
    def norm(self, x):
        x32 = x.float()
        mean = x32.mean(dim=(1, 2), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
        out = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (self.gamma.float() * out + self.beta.float()).to(x.dtype)

    def block(self, h, conv, i):
        return torch.relu(getattr(self, f"AffineInstanceNorm_{i}")(conv(h)))

    monkeypatch.setattr(unet.AffineInstanceNorm, "forward", norm)
    monkeypatch.setattr(unet.UNetGenerator, "_conv_block", block)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_unet_on_the_cpu_is_the_old_graph_bitwise(dtype, monkeypatch):
    """The U-Net's output and every gradient on the CPU are what they were
    with the chain inline and the ReLU after it, bit for bit; its 15 norms
    take the ReLU, counted plain."""
    net = unet.UNetGenerator(ngf=4, dtype=dtype, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith("AffineInstanceNorm"):
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    assert all(getattr(net, f"AffineInstanceNorm_{i}").relu for i in range(unet.N_NORMS))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    r = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(2))

    def run():
        xr = x.clone().requires_grad_()
        y = net(xr)
        grads = torch.autograd.grad((y.float() * r).sum(), [xr, *net.parameters()])
        return [y.detach(), *grads]

    before = _counts()
    new = run()
    assert _delta(before) == {"unet.norm": 15, "unet.norm.fwd.plain": 15,
                              "unet.norm.bwd.plain": 15}
    _old_unet_forward(monkeypatch)
    old = run()
    assert all(torch.equal(a, b) for a, b in zip(new, old))


def test_unet_counts_45_norms_a_cyclegan_step():
    """A U-Net CycleGAN step on the CPU: 45 ``unet.norm`` (15 an apply,
    three applies), each forward and backward on the plain route."""
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

    cfg = {"data": {"img_size": 32, "load_size": 36},
           "training": {"epochs": 2, "batch_size": 1, "seed": 0},
           "optim": {"lr_g": 2e-4, "lr_d": 2e-4, "betas": [0.5, 0.999], "lr_decay_after": 1},
           "loss": {"gan": "lsgan", "lambda_cycle": 10.0, "lambda_identity": 0.5},
           "model": {"ngf": 4, "ndf": 4, "n_layers": 2, "generator": "unet"},
           "runtime": {"precision": "fp32"}}
    trainer = CycleGANTrainer(cfg, steps_per_epoch=3)
    state = trainer.init_state(seed=0, device="cpu")
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, 36, 36, 3), dtype=np.uint8))
            for _ in range(2))
    before = _counts()
    trainer.train_step(state, a, b)
    assert _delta(before) == {"unet.norm": 45, "unet.norm.fwd.plain": 45,
                              "unet.norm.bwd.plain": 45}


@pytest.mark.parametrize("relu", [False, True])
def test_module_matches_the_jax_module(relu):
    """``AffineInstanceNorm(c, relu=relu)`` against the flax module (then
    ``jax.nn.relu``), float32, to 1e-5 of the largest value."""
    from gan_variant_research_tpu.models import generator_unet as jax_unet

    x, _, gamma, beta = _inputs((2, 8, 6, 5), torch.float32, seed=6, offset=1.0, std=2.0)
    params = {"gamma": gamma.numpy(), "beta": beta.numpy()}
    want = np.asarray(jax_unet.AffineInstanceNorm().apply({"params": params}, x.numpy()))
    want = np.maximum(want, 0) if relu else want
    norm = unet.AffineInstanceNorm(5, relu=relu)
    norm.load_state_dict({"gamma": gamma, "beta": beta})
    got = norm(x).detach().numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# --------------------------------------------------------------------------- #
# on the card

# the U-Net's norm shapes at 256^2 and ngf 64 (batch apart): stem, the downs,
# the bottleneck's 16^2 x 512 (also the first up's); its G applies run at 16,
# 32 and 48 in a batch-16 CycleGAN step
CARD_SHAPES = [(256, 256, 64), (128, 128, 128), (64, 64, 256), (32, 32, 512), (16, 16, 512)]
CARD_CASES = ([(16, hwc, relu, kind) for hwc in CARD_SHAPES for relu in (False, True)
               for kind in ("centred", "offset")]
              + [(n, hwc, True, "offset") for n in (32, 48) for hwc in CARD_SHAPES])
CARD_IDS = [f"{_ids((n, *hwc))}-{'relu' if relu else 'norelu'}-{kind}"
            for n, hwc, relu, kind in CARD_CASES]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(shape, kind, seed, device):
    """A centred input (mean ~0.4, std 1.5) or an offset one (|mean| = 48,
    std 1: E[x^2] - mean^2 would lose ~11 bits of the variance to
    cancellation in float32); the cotangent, gamma and beta likewise seeded."""
    offset, std = (0.4, 1.5) if kind == "centred" else (-48.0, 1.0)
    return _inputs(shape, torch.bfloat16, seed, device, offset, std)


def _forward_errors(x, y, yp, stats, sp, gamma, beta, relu):
    """The kernel's y (on its statistics ``stats``) against the contract's
    apply on ``stats``, in bf16 ulps of the largest of |gamma * r * (x -
    mean)|, |beta| and |contract| (float32 in another order, one rounding
    each: a last-bit flip at most; y may be twice the larger term); and
    against the chain's yp (on ``sp``), as a share of one bf16 ulp of the
    chain's larger term plus delta = |gamma| * (|r_k - r| * |x - mean| + r_k
    * |mean_k - mean|), by which the exact results differ when the two
    float32 statistics differ in their last bits (past an ulp of small
    terms where |mean| is far past the std), with 1 + 2^-16 of the ulp for
    each side's float32 rounding before its bf16 one. The limit of each is
    1."""
    def terms(s):
        centred = x.float() - s[:, 0, None, None]
        r = torch.rsqrt(s[:, 1, None, None] + EPS)
        return centred, r, (gamma * r * centred).abs()

    contract = inm.affine_norm_apply_reference(x, stats, gamma, beta, relu, EPS)
    _, r_k, big_k = terms(stats)
    larger = torch.maximum(torch.maximum(big_k, beta.abs().expand_as(big_k)),
                           contract.float().abs())
    apply_ulps = float(((y.float() - contract.float()).abs() / _ulp(larger)).max())
    del contract, big_k, larger
    centred, r, big = terms(sp)
    larger = torch.maximum(torch.maximum(big, beta.abs().expand_as(big)), yp.float().abs())
    delta = gamma.double().abs() * ((r_k.double() - r.double()).abs() * centred.double().abs()
                                    + r_k.double() * (stats[:, 0] - sp[:, 0]).double().abs()
                                    [:, None, None])
    bound = _ulp(larger).double() * (1 + 2.0 ** -16) + delta
    return apply_ulps, float(((y.double() - yp.double()).abs() / bound).max())


@pytest.mark.card
@pytest.mark.parametrize("n,hwc,relu,kind", CARD_CASES, ids=CARD_IDS)
def test_kernel_pair_matches_the_chain_on_the_card(n, hwc, relu, kind, card):
    """The kernels (through ``affine_instance_norm``'s Function) against the
    stock float32 chain by autograd on the same bf16 input:

    - statistics: the mean within 4e-6 of |mean| + std and the centred
      variance within 1e-4 relative of the float64 values of the same bf16
      input;
    - y against the contract's apply on the kernel's statistics and
      against the chain (``_forward_errors``);
    - dx within 1e-2 of the chain's by norm, dgamma and dbeta per channel
      within 1e-5 of sum |g'| and of sum |g' * xhat| (float32 sums of ~1e6
      terms in another order: a thread's ~60 rows, a block's 32, the
      shares, then n, each in order; and a rare ReLU mask flip where y is
      within rounding of 0);
    - against the contract on the kernel's own statistics and mask: dx to
      2^-8 by norm, dgamma and dbeta likewise to 1e-5 of those sums;
    - the backward's ReLU mask is the forward's, and two runs give the same
      bits."""
    shape = (n, *hwc)
    x, g, gamma, beta = _card_inputs(shape, kind, n + hwc[2], card)
    before = _counts()
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y = inm.affine_instance_norm(*leaves, EPS, relu)
    dx, dgamma, dbeta = torch.autograd.grad(y, leaves, g)
    y = y.detach()
    assert _delta(before) == {"unet.norm.fwd.kernel": 1, "unet.norm.bwd.kernel": 1}

    _, y2, stats = inm._launch_affine_forward(x, gamma, beta, EPS, relu)
    second = inm._launch_affine_backward(g, x, stats, gamma, beta, EPS, relu)
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in
                                      zip((dx, dgamma, dbeta), second))

    x64 = x.double()
    mean64 = x64.mean(dim=(1, 2))
    var64 = (x64 - mean64[:, None, None]).square().mean(dim=(1, 2))
    mean_err = float(((stats[:, 0] - mean64).abs() / (mean64.abs() + var64.sqrt())).max())
    var_err = float(((stats[:, 1] - var64).abs() / var64).max())
    assert mean_err <= 4e-6 and var_err <= 1e-4, (mean_err, var_err)

    yp, dxp, dgp, dbp = _chain_grads(x, g, gamma, beta, relu)
    sp = inm.affine_norm_stats_reference(x)
    apply_ulps, fwd_share = _forward_errors(x, y, yp, stats, sp, gamma, beta, relu)
    assert apply_ulps <= 1.0 and fwd_share <= 1.0, (apply_ulps, fwd_share)
    centred = x.float() - sp[:, 0, None, None]
    r = torch.rsqrt(sp[:, 1, None, None] + EPS)

    kept = torch.where(yp > 0, g, 0).float() if relu else g.float()
    xhat = centred * r
    g_sum = kept.abs().sum(dim=(0, 1, 2))
    gx_sum = (kept * xhat).abs().sum(dim=(0, 1, 2))
    assert _rel(dx, dxp) <= 1e-2, _rel(dx, dxp)
    assert bool(((dbeta - dbp).abs() <= 1e-5 * g_sum).all()), float((dbeta - dbp).abs().max())
    assert bool(((dgamma - dgp).abs() <= 1e-5 * gx_sum).all()), float((dgamma - dgp).abs().max())

    # the contract on the kernel's own statistics, with the kernel's mask
    own = torch.where(y > 0, g, 0) if relu else g
    cdx, cdg, cdb = inm.affine_norm_backward_reference(own, x, stats, gamma, beta, False, EPS)
    assert _rel(dx, cdx) <= 2.0 ** -8, _rel(dx, cdx)
    assert bool(((dbeta - cdb).abs() <= 1e-5 * g_sum).all()), float((dbeta - cdb).abs().max())
    assert bool(((dgamma - cdg).abs() <= 1e-5 * gx_sum).all()), float((dgamma - cdg).abs().max())
    if relu:
        unmasked = inm._launch_affine_backward(own, x, stats, gamma, beta, EPS, False)
        assert all(torch.equal(a, b) for a, b in zip((dx, dgamma, dbeta), unmasked))
