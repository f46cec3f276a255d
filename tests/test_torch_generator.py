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
VARIANTS = {"use_attention": True, "attn_layers": (0, 2), "use_channel_attn": True,
            "channel_attn_layers": (1,), "use_style_dropout": True}


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
    """The TPU-only fields change nothing; the variant flags build their
    blocks, and a variant config the JAX package refuses (an ``attn_flash``
    that is not true, false or "auto") is refused."""
    cfg = {"ngf": 8, "n_blocks": 2, "use_pallas": True, "pad_free": True,
           "remat": True, "use_s2d": False, "attn_flash": "auto"}
    gen = build_generator(cfg, FP32_POLICY)
    assert sorted(n for n, _ in gen.named_children()) == sorted(
        ["initial_conv", "down_0", "down_1", "res_0", "res_1", "up_0", "up_1",
         "output_conv"])
    variant = build_generator(dict(cfg, **VARIANTS, n_blocks=3), FP32_POLICY)
    assert {n for n, _ in variant.named_children()} >= {
        "attn_0", "attn_2", "channel_attn_1", "style_gate_0", "style_gate_1", "style_gate_2"}
    with pytest.raises(ValueError, match="attn_flash"):
        build_generator(dict(cfg, **VARIANTS, attn_flash="false"), FP32_POLICY)


def test_converter_rejects_leftover_modules_and_leaves():
    _, params, _, _ = _pair()
    extra = dict(params, attn_3={"gamma": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="attn_3"):
        generator_state_dict_from_jax(extra)
    bad = dict(params, res_0=dict(params["res_0"], gamma=np.zeros(1, np.float32)))
    with pytest.raises(ValueError, match="gamma"):
        generator_state_dict_from_jax(bad)


# --------------------------------------------------------------------------- #
# the variant generator: attention at [0, 2], channel attention at [1], style
# dropout, ngf 8, 3 blocks


def _variant_pair():
    """The JAX variant generator and its params with non-zero gains (at init
    every variant block is an identity, and the attention core would get no
    gradient and leave no trace in the output)."""
    jax_gen = JaxGenerator(ngf=8, n_blocks=3, **VARIANTS)
    x = np.random.default_rng(11).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax_gen.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    rng = np.random.default_rng(12)
    for i in (0, 2):
        params[f"attn_{i}"]["gamma"] = np.float32(0.5)
    for leaf in ("kernel", "bias"):
        shape = params["channel_attn_1"]["fc2"][leaf].shape
        params["channel_attn_1"]["fc2"][leaf] = rng.standard_normal(shape).astype(np.float32)
    for i in range(3):
        params[f"style_gate_{i}"]["gamma"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
        params[f"style_gate_{i}"]["beta"] = rng.uniform(-0.5, 0.5, 32).astype(np.float32)
    gen = ResNetGenerator(ngf=8, n_blocks=3, **VARIANTS)
    gen.load_state_dict(generator_state_dict_from_jax(params))
    return jax_gen, params, gen, x


def _style_draws(key, n_blocks, b):
    """The JAX gates' draws: block i draws with ``split(key, n_blocks)[i]``."""
    keys = jax.random.split(key, n_blocks)
    return np.stack([np.asarray(jax.random.uniform(keys[i], (b, 1, 1, 1), jnp.float32,
                                                   minval=0.4, maxval=0.9)).reshape(b)
                     for i in range(n_blocks)])


@pytest.mark.parametrize("styled", [False, True])
def test_variant_image_and_taps_match_jax(styled):
    jax_gen, params, gen, x = _variant_pair()
    taps = (0, 3, 4, 5, 6, 7)
    key = jax.random.PRNGKey(21) if styled else None
    want, want_feats = jax_gen.apply({"params": params}, jnp.asarray(x), extract=taps,
                                     style_key=key)
    alpha = torch.from_numpy(_style_draws(key, 3, 2)) if styled else None
    with torch.no_grad():
        got, feats = gen(torch.from_numpy(x), extract=taps, style_alpha=alpha)
    # tanh outputs after ~10 fp32 convs, instance norms and two attentions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert len(feats) == len(want_feats) == len(taps)
    for i, (a, b) in enumerate(zip(feats, want_feats)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy() / np.abs(b).max(), b / np.abs(b).max(),
                                   atol=1e-4, err_msg=f"tap {taps[i]}")
    if styled:   # the draws change the image
        plain = jax_gen.apply({"params": params}, jnp.asarray(x))
        assert np.abs(np.asarray(plain) - np.asarray(want)).max() > 1e-2


def test_variant_converter_round_trips_and_stays_strict():
    _, params, gen, _ = _variant_pair()
    sd = generator_state_dict_from_jax(params)
    assert set(sd) == set(gen.state_dict())
    assert sd["attn_0.gamma"].shape == () and float(sd["attn_0.gamma"]) == 0.5
    np.testing.assert_array_equal(sd["attn_2.query.weight"].numpy(),
                                  params["attn_2"]["query"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["channel_attn_1.fc2.weight"].numpy(),
                                  params["channel_attn_1"]["fc2"]["kernel"].T)
    np.testing.assert_array_equal(sd["style_gate_1.beta"].numpy(),
                                  params["style_gate_1"]["beta"])
    bad = dict(params, attn_0={k: v for k, v in params["attn_0"].items() if k != "query"})
    with pytest.raises(ValueError, match="attn_0 lacks"):
        generator_state_dict_from_jax(bad)
    fc1 = {"kernel": params["channel_attn_1"]["fc1"]["kernel"]}
    bad = dict(params, channel_attn_1=dict(params["channel_attn_1"], fc1=fc1))
    with pytest.raises(ValueError, match="lacks its leaf 'bias'"):
        generator_state_dict_from_jax(bad)
    bad = dict(params, style_gate_2=dict(params["style_gate_2"], scale=np.ones(32)))
    with pytest.raises(ValueError, match="scale"):
        generator_state_dict_from_jax(bad)
    bad = dict(params, attn_5=params["attn_0"])   # no res_5 in a 3-block tree
    with pytest.raises(ValueError, match="attn_5"):
        generator_state_dict_from_jax(bad)


def test_variant_blocks_run_after_their_host_block(monkeypatch):
    """res_i, then attn_i, channel_attn_i and style_gate_i, the tap after
    them; the taps-only pass to tap 5 (block 2) runs both attentions."""
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

    calls = []
    real = sa.spatial_attention
    monkeypatch.setattr(sa, "spatial_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    _, _, gen, x = _variant_pair()
    with torch.no_grad():
        _, feats = gen(torch.from_numpy(x), extract=(5,), taps_only=True)
    assert len(calls) == 2 and len(feats) == 1
