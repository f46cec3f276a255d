"""The variant train step past the attention kernels' widths: at ngf 320
(d_qk 160, d_v 1280) the JAX package runs its einsum core, and so does the
port (``models/attention.py::einsum_attention``). One step of both trainers
from the same params and draws, on the parity tests' tiny config (32^2,
batch 2, 2 blocks: the depth is cut, the width is the variant's), float32.

At this width the generator's gradient is ill-conditioned in float32: the
8 x 8 trunk's instance norms over 1280 channels cancel most of each
weight's gradient, and the port run on one CPU thread instead of all moves
G's Adam moment by up to 4% of a leaf's largest value (down_1.weight; 2%
on attn_0.gamma), with or without the variant blocks. So G is held as a
whole: its moment within 2e-2 of JAX's in L2 (measured 8.6e-3), and every
parameter within Adam's first step of JAX's (3 lr). The losses, D's
moments and D's parameters keep tests/test_torch_cut_trainer.py's
tolerances."""

import numpy as np
import pytest

from gan_variant_research_tpu_torch.convert import generator_state_dict_from_jax
from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa


@pytest.fixture(scope="module")
def ngf320_step():
    import test_torch_cut_trainer as parity

    assert sa.attention_route(320 * 4 // 8, 320 * 4)[0] == "einsum"
    return parity, parity._two_steps(variant=True, ngf=320, steps=1)


def test_losses_match_jax_at_ngf320(ngf320_step):
    parity, out = ngf320_step
    parity._check_losses(out, 0)


def test_discriminator_matches_jax_at_ngf320(ngf320_step):
    parity, out = ngf320_step
    parity._check_adam_moments(out, 0, "d")
    parity._check_params(out, 0, "d_params")


def test_generator_gradient_matches_jax_at_ngf320(ngf320_step):
    """G's Adam moments (0.5 x the clipped gradient after one step) within
    2e-2 of JAX's in L2 over every leaf but the conv biases before an
    instance norm (analytically 0); the attention's leaves get a gradient."""
    parity, out = ngf320_step
    _, _, jstate, pstate = out[0]
    want = {k: v.numpy() for k, v in generator_state_dict_from_jax(
        parity._adam_state(jstate.opt_g).mu).items()}
    got = pstate.opt_g.mu
    assert set(got) == set(want)
    keys = [k for k in want if not parity._before_instance_norm(k)]
    assert float(got["attn_0.query.weight"].abs().max()) > 0
    num = sum(float(((got[k].numpy() - want[k]) ** 2).sum()) for k in keys)
    den = sum(float((want[k] ** 2).sum()) for k in keys)
    assert (num / den) ** 0.5 <= 2e-2


@pytest.mark.parametrize("which", ["g_params", "ema"])
def test_generator_params_move_as_jax_at_ngf320(ngf320_step, which):
    """Adam's first step moves each element by about lr: every element
    within 3 lr of JAX's."""
    parity, out = ngf320_step
    _, _, jstate, pstate = out[0]
    want = {k: v.numpy() for k, v in generator_state_dict_from_jax(
        getattr(jstate, which)).items()}
    got = getattr(pstate, which)
    assert set(got) == set(want)
    for k in want:
        d = np.abs(got[k].detach().numpy() - want[k])
        assert d.max() <= 3 * 2e-4, (k, d.max())
