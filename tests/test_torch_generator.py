"""Port's ResNet generator vs the JAX ``ResNetGenerator`` on converted
params: the image and the PatchNCE taps, at ngf 8, 2 blocks, 32^2, batch 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.models.generator_resnet import ResNetGenerator as JaxGenerator
from gan_variant_research_tpu_torch.convert import generator_state_dict_from_jax
from gan_variant_research_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gan_variant_research_tpu_torch.models.generator_resnet import ResNetGenerator
from gan_variant_research_tpu_torch.ops.kernels import resblock
from gan_variant_research_tpu_torch.train.cut_trainer import build_generator

TAPS = (0, 2, 3, 4, 5, 16)  # 16 does not exist: skipped, as in the JAX package


def _pair(seed=0, **cfg):
    jax_gen = JaxGenerator(ngf=8, n_blocks=2, **cfg)
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    params = jax_gen.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    gen = ResNetGenerator(ngf=8, n_blocks=2, **cfg)
    gen.load_state_dict(generator_state_dict_from_jax(params))
    return jax_gen, params, gen, x


@pytest.mark.parametrize("cfg", [
    {},
    {"use_bias": False},
    {"padding_type": "zero"},
    {"padding_type": "replicate", "activation": "leaky_relu"},
    {"activation": "leaky_relu"},  # reflect trunk off the fused-block path
])
def test_image_and_taps_match_jax(cfg):
    jax_gen, params, gen, x = _pair(**cfg)
    want, want_feats = jax_gen.apply({"params": params}, jnp.asarray(x), extract=TAPS)
    with torch.no_grad():
        got, feats = gen(torch.from_numpy(x), extract=TAPS)
    assert got.shape == (2, 32, 32, 3)
    # tanh outputs after ~10 fp32 convs and instance norms
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert len(feats) == len(want_feats) == 5
    for i, (a, b) in enumerate(zip(feats, want_feats)):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        # each tap relative to its own max: taps are not bounded like tanh
        np.testing.assert_allclose(a.numpy() / np.abs(b).max(), b / np.abs(b).max(),
                                   atol=1e-4, err_msg=f"tap {TAPS[i]}")


def test_reflect_trunk_goes_through_the_conv_wrapper(monkeypatch):
    """Every reflect trunk conv calls ``reflect_conv3x3``: 2 per block."""
    calls = []
    real = resblock.reflect_conv3x3

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(resblock, "reflect_conv3x3", counting)
    gen = ResNetGenerator(ngf=8, n_blocks=3)
    with torch.no_grad():
        gen(torch.zeros(1, 16, 16, 3))
    assert calls == [(1, 4, 4, 32)] * 6


def test_bf16_policy_runs_in_bf16():
    gen = build_generator({"ngf": 8, "n_blocks": 2}, DEFAULT_POLICY)
    with torch.no_grad():
        y = gen(torch.zeros(1, 16, 16, 3))
    assert y.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in gen.parameters())


def test_build_generator_ignores_tpu_fields_and_refuses_variants():
    cfg = {"ngf": 8, "n_blocks": 2, "use_pallas": True, "pad_free": True,
           "remat": True, "use_s2d": False, "attn_flash": "auto"}
    gen = build_generator(cfg, FP32_POLICY)
    assert sorted(n for n, _ in gen.named_children()) == sorted(
        ["initial_conv", "down_0", "down_1", "res_0", "res_1", "up_0", "up_1",
         "output_conv"])
    for flag in ("use_attention", "use_channel_attn", "use_style_dropout"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_generator({"ngf": 8, flag: True}, FP32_POLICY)


def test_converter_rejects_leftover_modules_and_leaves():
    _, params, _, _ = _pair()
    extra = dict(params, attn_3={"gamma": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="attn_3"):
        generator_state_dict_from_jax(extra)
    bad = dict(params, res_0=dict(params["res_0"], gamma=np.zeros(1, np.float32)))
    with pytest.raises(ValueError, match="gamma"):
        generator_state_dict_from_jax(bad)
