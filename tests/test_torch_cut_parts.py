"""The pieces of the port's CUT train step against their JAX counterparts,
on the CPU: the PatchGAN discriminator on converted weights, the
adversarial, PatchNCE and L1 losses, ``train_augment``, ``diff_augment``,
Adam behind the global-norm clip, the EMA, the step sampler, and the
flagship config dict of ``chip_smoke.py`` against the YAML.

Every random input is drawn with ``jax.random`` under the JAX function's own
key splits (``torch_jax_draws.py``) and fed to both sides."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from gan_variant_research_tpu.data import augment as jax_augment
from gan_variant_research_tpu.losses import adversarial as jax_adv
from gan_variant_research_tpu.losses import reconstruction as jax_rec
from gan_variant_research_tpu.losses.patchnce import patch_nce_loss as jax_patch_nce
from gan_variant_research_tpu.models.discriminator_patchgan import (
    MultiscaleDiscriminator as JaxDiscriminator,
)
from gan_variant_research_tpu.models.generator_resnet import ResNetGenerator as JaxGenerator
from gan_variant_research_tpu.ops import diffaugment as jax_da
from gan_variant_research_tpu.ops.nn_ops import avg_pool_3x3_s2 as jax_avg_pool
from gan_variant_research_tpu.train import ema as jax_ema
from gan_variant_research_tpu.train.optim import optimizer_from_config as jax_optimizer
from gan_variant_research_tpu_torch.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from gan_variant_research_tpu_torch.core import config as cfg_mod
from gan_variant_research_tpu_torch.core import prng
from gan_variant_research_tpu_torch.core.precision import FP32_POLICY
from gan_variant_research_tpu_torch.data.augment import train_augment
from gan_variant_research_tpu_torch.losses import adversarial, reconstruction
from gan_variant_research_tpu_torch.losses.patchnce import patch_nce_loss
from gan_variant_research_tpu_torch.models.discriminator_patchgan import MultiscaleDiscriminator
from gan_variant_research_tpu_torch.models.generator_resnet import ResNetGenerator
from gan_variant_research_tpu_torch.ops.diffaugment import diff_augment, policy_ops
from gan_variant_research_tpu_torch.ops.nn_ops import avg_pool_3x3_s2
from gan_variant_research_tpu_torch.train import ema, optim
from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer, build_discriminator
from torch_jax_draws import augment_draws, diff_augment_draws, nce_ids

REPO_ROOT = Path(__file__).resolve().parents[1]


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# --------------------------------------------------------------------------- #
# discriminator

@pytest.mark.parametrize("cfg", [
    {"ndf": 8, "n_layers": 3, "num_scales": 1, "norm": "none"},   # the flagship's shape
    {"ndf": 4, "n_layers": 2, "num_scales": 2, "norm": "instance"},
])
def test_discriminator_matches_jax(cfg):
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jd = JaxDiscriminator(**cfg)
    params = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(1), x)["params"])
    d = build_discriminator(cfg, FP32_POLICY)
    d.load_state_dict(discriminator_state_dict_from_jax(params))
    want_logits, want_feats = jd.apply({"params": params}, x, extract_features=True)
    with torch.no_grad():
        logits, feats = d(torch.from_numpy(x), extract_features=True)
    assert len(logits) == len(want_logits) == cfg["num_scales"]
    # float32 4x4 convs, sums in another order
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    for got_scale, want_scale in zip(feats, want_feats):
        assert len(got_scale) == len(want_scale) == cfg["n_layers"] + 1
        for got, want in zip(got_scale, want_scale):
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_discriminator_conversion_is_strict():
    jd = JaxDiscriminator(ndf=4, n_layers=2)
    params = jax.tree_util.tree_map(
        np.asarray, jd.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))["params"])
    sd = discriminator_state_dict_from_jax(params)
    assert sd["scale_0.conv_0.weight"].shape == (4, 3, 4, 4)      # HWIO -> OIHW
    params["scale_0"]["conv_0"]["u"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="cannot map"):
        discriminator_state_dict_from_jax(params)
    with pytest.raises(ValueError, match="MultiscaleDiscriminator"):
        discriminator_state_dict_from_jax({"initial_conv": {}})


def test_spectral_norm_is_not_ported():
    with pytest.raises(NotImplementedError, match="Variant losses and D options"):
        MultiscaleDiscriminator(ndf=4, use_spectral_norm=True)


def test_avg_pool_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 9, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(avg_pool_3x3_s2(torch.from_numpy(x)).numpy(),
                               _np(jax_avg_pool(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# losses

def _logit_maps(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, 6, 6, 1)).astype(np.float32) * 1.5 for _ in range(n)]


@pytest.mark.parametrize("scales", [1, 2])
def test_adversarial_losses_match_jax(scales):
    real, fake = _logit_maps(0, scales), _logit_maps(1, scales)
    t = lambda maps: [torch.from_numpy(m) for m in maps]
    pairs = [
        (adversarial.discriminator_hinge_loss(t(real), t(fake)),
         jax_adv.discriminator_hinge_loss(real, fake)),
        (adversarial.generator_hinge_loss(t(fake)), jax_adv.generator_hinge_loss(fake)),
    ]
    for mode in ("lsgan", "bce"):
        for is_real in (True, False):
            pairs.append((adversarial.gan_loss(t(fake), is_real, mode),
                          jax_adv.gan_loss(fake, is_real, mode)))
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    # a single map is one scale
    np.testing.assert_allclose(float(adversarial.generator_hinge_loss(t(fake)[0])),
                               float(jax_adv.generator_hinge_loss(fake[0])), rtol=1e-6)
    with pytest.raises(ValueError):
        adversarial.gan_loss(t(fake), True, "wgan")


def test_reconstruction_losses_match_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got, want in ((reconstruction.l1_loss(ta.bfloat16(), tb), jax_rec.l1_loss(
                          jnp.asarray(a).astype(jnp.bfloat16), b)),
                      (reconstruction.identity_loss(ta, tb), jax_rec.identity_loss(a, b)),
                      (reconstruction.cycle_loss(ta, tb, 10.0), jax_rec.cycle_loss(a, b, 10.0))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_patch_nce_matches_jax(dtype):
    """Two layers: one with more positions than patches, one with fewer
    (all ids then come from the smaller set, drawn with replacement)."""
    rng = np.random.default_rng(4)
    shapes = [(2, 8, 8, 16), (2, 3, 3, 32)]
    src = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tgt = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    key = jax.random.PRNGKey(5)
    want = jax_patch_nce(key, [jnp.asarray(s).astype(dtype) for s in src],
                         [jnp.asarray(t).astype(dtype) for t in tgt], 0.07, 16)
    ids = nce_ids(key, [h * w for _, h, w, _ in shapes], 16)
    assert [len(i) for i in ids] == [16, 9]
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = patch_nce_loss([torch.from_numpy(s).to(tdtype) for s in src],
                         [torch.from_numpy(t).to(tdtype) for t in tgt], ids, 0.07)
    # gathered in the features' dtype, then all float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_patch_nce_detaches_src_and_zeroes_non_finite_layers():
    rng = np.random.default_rng(6)
    src = torch.from_numpy(rng.standard_normal((1, 4, 4, 8)).astype(np.float32)).requires_grad_()
    tgt = torch.from_numpy(rng.standard_normal((1, 4, 4, 8)).astype(np.float32)).requires_grad_()
    ids = [torch.arange(8)]
    loss = patch_nce_loss([src], [tgt], ids)
    loss.backward()
    assert src.grad is None and tgt.grad is not None
    bad = torch.full((1, 4, 4, 8), float("nan"))
    assert float(patch_nce_loss([bad], [bad], ids)) == 0.0


# --------------------------------------------------------------------------- #
# augmentation

def test_train_augment_matches_jax():
    """Against the JAX function run op by op: jitted whole, XLA rounds its
    colour jitter differently inside the hue fusion (see
    test_torch_cut_trainer.py)."""
    u8 = np.random.default_rng(7).integers(0, 256, (3, 40, 36, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(8)
    with jax.disable_jit():
        want = _np(jax_augment.train_augment(key, jnp.asarray(u8), 32))
    got = train_augment(torch.from_numpy(u8), 32, augment_draws(key, 3))
    assert got.shape == (3, 32, 32, 3) and got.dtype == torch.float32
    # float32 resampling products and colour arithmetic in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("policy", [("color", "translation", "cutout"),
                                    ("translation", "cutout_light", "unknown")])
def test_diff_augment_matches_jax(policy):
    x = np.random.default_rng(9).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(10)
    want = _np(jax_da.diff_augment(key, jnp.asarray(x), policy))
    got = diff_augment(torch.from_numpy(x), policy,
                       diff_augment_draws(key, x.shape, jnp.float32, policy))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _of(draws, op):
    """The draws of every occurrence of ``op`` in a ``DiffAugmentDraws``."""
    return [v for o, v in zip(draws.ops, draws.values) if o == op]


def test_diff_augment_draws_once_per_op_like_jax():
    """A policy that repeats an op and names both cutouts: the JAX chain
    splits its key over every op, so each occurrence draws anew and each
    cutout keeps its own centre range; the port carries one draw per op."""
    policy = ("color", "color", "translation", "cutout", "cutout_light")
    x = np.random.default_rng(13).uniform(-1, 1, (4, 20, 20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    want = _np(jax_da.diff_augment(key, jnp.asarray(x), policy))
    draws = diff_augment_draws(key, x.shape, jnp.float32, policy)
    assert len(_of(draws, "brightness")) == 2 and len(_of(draws, "cutout_light")) == 1
    assert not torch.equal(*(v[0] for v in _of(draws, "brightness")))
    got = diff_augment(torch.from_numpy(x), policy, draws)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # the port's sampler: one draw per op, the light cutout in its own range
    d = prng.sample_diff_augment(torch.Generator().manual_seed(0), 64, 24, policy,
                                 torch.float32)
    assert d.ops == policy_ops(policy)
    assert not torch.equal(_of(d, "saturation")[0][0], _of(d, "saturation")[1][0])
    # centres in [0, 24 + (1 - c % 2)): c = 12 for cutout, 5 for cutout_light
    assert int(_of(d, "cutout")[0][0].max()) <= 24
    assert int(_of(d, "cutout_light")[0][0].max()) <= 23
    with pytest.raises(ValueError):
        diff_augment(torch.from_numpy(x), policy[:3], draws)


def test_diff_augment_bf16_draws_and_arithmetic():
    """A bf16 fake gets bf16 draws and bf16 arithmetic on both sides; the
    channel and image means round in another order: 2 bf16 ulps."""
    x = np.random.default_rng(11).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    key = jax.random.PRNGKey(12)
    policy = ("color", "translation", "cutout")
    want = _np(jax_da.diff_augment(key, x16, policy))
    draws = diff_augment_draws(key, x.shape, jnp.bfloat16, policy)
    assert _of(draws, "brightness")[0][0].dtype == torch.bfloat16
    got = diff_augment(torch.from_numpy(np.array(_np(x16))).bfloat16(), policy, draws)
    assert got.dtype == torch.bfloat16
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got.float().numpy() - want) <= 2 * ulp + 1e-6).all()


def test_sampler_draws_have_the_jax_shapes_ranges_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    d = prng.sample_step(gen, 4, 32, ("color", "translation", "cutout"), torch.float32,
                         torch.bfloat16, [1024, 64], 16)
    a = d.photo_aug
    assert ((a.scales >= 0.85) & (a.scales < 1.0)).all() and a.flip.dtype == torch.bool
    assert ((a.hue >= -0.02) & (a.hue <= 0.02)).all()
    assert _of(d.da_real, "brightness")[0][0].dtype == torch.float32
    assert (_of(d.da_fake, "brightness")[0][0].dtype == _of(d.da_g, "saturation")[0][0].dtype
            == torch.bfloat16)
    assert (_of(d.da_fake, "translation")[0][0].abs() <= 4).all()     # int(32 * 0.125 + 0.5)
    cut_h = _of(d.da_g, "cutout")[0][0]
    assert ((cut_h >= 0) & (cut_h < 33)).all()                      # 32 + (1 - 16 % 2)
    assert [len(i) for i in d.nce] == [16, 16] and int(d.nce[1].max()) < 64
    assert prng.sample_step(gen, 4, 32, None, torch.float32, torch.float32, [], 16).da_g is None


# --------------------------------------------------------------------------- #
# optimizer and EMA

def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


@pytest.mark.parametrize("opt_cfg,grad_scale", [
    ({"lr": 2e-4, "betas": [0.5, 0.999]}, 30.0),      # the clip fires
    ({"lr": 2e-4, "betas": [0.5, 0.999]}, 0.1),       # it does not
    ({"lr": 1e-3, "betas": [0.9, 0.99],
      "scheduler": {"enabled": True, "type": "cosine", "lr_min": 1e-4}}, 1.0),
])
def test_adam_with_clip_matches_optax_chain(opt_cfg, grad_scale):
    """Three updates; then mu, nu, count and the params against optax."""
    jopt = jax_optimizer(opt_cfg, 10.0, max_steps=5)
    popt = optim.optimizer_from_config(opt_cfg, 10.0, max_steps=5)
    jparams = {k: jnp.asarray(v) for k, v in _params(0).items()}
    pparams = {k: torch.from_numpy(v.copy()) for k, v in _params(0).items()}
    jstate, pstate = jopt.init(jparams), popt.init(pparams)
    for i in range(3):
        grads = {k: v * grad_scale for k, v in _params(10 + i).items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        pstate = popt.step(pparams, {k: torch.from_numpy(v) for k, v in grads.items()}, pstate)
    adam = [s for s in jax.tree_util.tree_leaves(jstate, is_leaf=lambda n: hasattr(n, "mu"))
            if hasattr(s, "mu")][0]
    assert pstate.count == int(adam.count) == 3
    for k in jparams:
        for got, want in ((pstate.mu[k], adam.mu[k]), (pstate.nu[k], adam.nu[k])):
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-12)
        # updates of ~lr on O(1) params: float32 rounding of the sum
        np.testing.assert_allclose(pparams[k].numpy(), _np(jparams[k]), rtol=0, atol=1e-7)


def test_clip_is_optax_rule_without_epsilon():
    g = {"a": torch.tensor([3.0, 4.0])}                    # norm 5
    assert torch.equal(optim.clip_by_global_norm(g, 5.0)["a"], torch.tensor([3.0, 4.0]))
    assert torch.allclose(optim.clip_by_global_norm(g, 2.5)["a"], torch.tensor([1.5, 2.0]))
    assert torch.equal(optim.clip_by_global_norm(g, 5.0001)["a"], g["a"])


def test_optimizer_config_errors():
    with pytest.raises(NotImplementedError, match="adamw"):
        optim.optimizer_from_config({"weight_decay": 0.01}, 10.0, None)
    with pytest.raises(ValueError, match="max_steps"):
        optim.optimizer_from_config({"scheduler": {"enabled": True}}, 10.0, None)
    assert optim.optimizer_from_config({}, 0.0, None).max_norm is None


def test_ema_matches_jax():
    shadow = {k: jnp.asarray(v) for k, v in _params(1).items()}
    params = {k: jnp.asarray(v) for k, v in _params(2).items()}
    pshadow = ema.ema_init({k: torch.from_numpy(np.array(v)) for k, v in shadow.items()})
    for _ in range(3):
        shadow = jax_ema.ema_update(shadow, params, 0.999)
        ema.ema_update(pshadow, {k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                       0.999)
    for k in shadow:
        np.testing.assert_allclose(pshadow[k].numpy(), _np(shadow[k]), rtol=0, atol=1e-7)


# --------------------------------------------------------------------------- #
# generator taps, config, trainer guards

def test_taps_only_forward_stops_after_the_last_tap():
    jg = JaxGenerator(ngf=4, n_blocks=2)
    x = np.random.default_rng(13).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jg.init(jax.random.PRNGKey(0), x)["params"])
    g = ResNetGenerator(ngf=4, n_blocks=2)
    g.load_state_dict(generator_state_dict_from_jax(params))
    with torch.no_grad():
        _, full = g(torch.from_numpy(x), extract=(0, 4, 16))
        out, taps = g(torch.from_numpy(x), extract=(0, 4, 16), taps_only=True)
    assert out is None and len(taps) == len(full) == 2
    assert all(torch.equal(a, b) for a, b in zip(taps, full))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flagship_dict_matches_the_yaml_on_every_key_the_step_reads():
    with open(REPO_ROOT / "gan_variant_research_tpu/configs/train_gan_cutpp.yaml") as f:
        reference = yaml.safe_load(f)
    flagship = _load_chip_smoke().FLAGSHIP_CUT
    absent = object()
    for key in cfg_mod.STEP_KEYS:
        assert cfg_mod.get(flagship, key, absent) == cfg_mod.get(reference, key, absent), key


def test_config_get_reads_dotted_paths_and_defaults():
    cfg = {"a": {"b": {"c": 1}, "n": None}}
    assert cfg_mod.get(cfg, "a.b.c") == 1
    assert cfg_mod.get(cfg, "a.n.x", 7) == 7 and cfg_mod.get(cfg, "a.b.c.d", 3) == 3


@pytest.mark.parametrize("weights", [{"featmatch": 1.0}, {"palette": 0.5}, {"repulsion": 0.1}])
def test_variant_weights_are_refused(weights):
    cfg = {"model": {"generator": {"ngf": 4, "n_blocks": 1},
                     "discriminator": {"ndf": 4, "n_layers": 1}},
           "loss_weights": weights}
    with pytest.raises(NotImplementedError, match="Variant losses and D options"):
        CUTTrainer(cfg)


def test_trainer_host_schedule_matches_jax_rules():
    t = CUTTrainer({"model": {"generator": {"ngf": 4, "n_blocks": 1},
                              "discriminator": {"ndf": 4, "n_layers": 1}},
                    "image_size": 32, "warmup_steps": 10, "r1": {"gamma": 10.0, "every": 4},
                    "loss_weights": {"identity_warm": 0.1, "identity_final": 0.0}})
    assert t.step_flags(0) == (True, True) and t.step_flags(3) == (False, True)
    assert t.step_flags(12) == (True, False)
    assert t.identity_weight_at(5) == pytest.approx(0.05)
    # taps of a 1-block, 2-downsampling G at 32^2: layers 0 (32^2) and 4 (up_0, 16^2)
    assert t.nce_tap_hw() == [1024, 256]


def test_init_state_is_fresh_and_seeded():
    cfg = {"model": {"generator": {"ngf": 4, "n_blocks": 1},
                     "discriminator": {"ndf": 4, "n_layers": 1}}, "seed": 3}
    t = CUTTrainer(cfg)
    a, b = t.init_state(device="cpu"), t.init_state(device="cpu")
    assert set(a.g_params) == set(t.generator.state_dict())
    assert set(a.d_params) == set(t.discriminator.state_dict())
    for k, p in a.g_params.items():
        assert p.dtype == torch.float32 and p.requires_grad and p.is_leaf
        assert torch.equal(p, b.g_params[k]) and torch.equal(a.ema[k], p)
        assert not a.opt_g.mu[k].any() and not a.opt_g.nu[k].any()
    assert a.step == 0 and a.opt_g.count == a.opt_d.count == 0
    with pytest.raises(ValueError, match="missing"):
        t.state_from_state_dicts({}, t.discriminator.state_dict(), 0, "cpu")
