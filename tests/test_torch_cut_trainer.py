"""The port's CUT train step against the JAX ``CUTTrainer``, two steps from
the same params and the same draws: step 0 with R1 and identity, step 1
with identity only. Tiny config (ngf 4, 2 blocks, 32^2, batch 2), float32,
one device, JAX on the CPU; and the same for the variant generator
(self-attention after block 0, channel attention after block 1, style
dropout), with non-zero gains and the nine-stream draws."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.data import augment as jax_augment
from gan_variant_research_tpu.train import cut_trainer as jax_cut_trainer
from gan_variant_research_tpu.train.cut_trainer import CUTTrainer as JaxCUTTrainer
from gan_variant_research_tpu_torch.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from gan_variant_research_tpu_torch.train.cut_trainer import LOSS_KEYS, CUTTrainer
from test_cut_trainer import tiny_config
from torch_jax_draws import step_draws

B, S = 2, 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_snapshot(state):
    return SimpleNamespace(**{k: _np_tree(getattr(state, k))
                              for k in ("g_params", "d_params", "ema", "opt_g", "opt_d")})


def _port_snapshot(state):
    """The port's step updates its state in place: copy what the tests read."""
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}
    adam = lambda a: SimpleNamespace(count=a.count, mu=clone(a.mu), nu=clone(a.nu))
    return SimpleNamespace(g_params=clone(state.g_params), d_params=clone(state.d_params),
                           ema=clone(state.ema), opt_g=adam(state.opt_g),
                           opt_d=adam(state.opt_d))


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside chain(clip, adam)."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no ScaleByAdamState in the optimizer state")


def _eager_train_augment(key, images_u8, image_size):
    """The JAX ``train_augment``, evaluated op by op from inside the jitted
    step. Jitted whole, XLA recomputes the colour-jitter output inside the
    fusions of ``_rgb_to_hsv`` with other rounding, so that on some pixels
    the max matches no channel and the hue takes the wrong branch (0.4% of
    the values at this size, off by up to 0.65; recorded in ROADMAP Queue
    3). The port follows the function as written."""
    def host(key_data, u8):
        with jax.disable_jit():
            out = jax_augment.train_augment(jax.random.wrap_key_data(key_data),
                                            jax.numpy.asarray(u8), image_size)
        return np.asarray(out)

    b, _, _, c = images_u8.shape
    shape = jax.ShapeDtypeStruct((b, image_size, image_size, c), jax.numpy.float32)
    return jax.pure_callback(host, shape, jax.random.key_data(key), images_u8)


VARIANT_GENERATOR = {"use_attention": True, "attn_layers": [0], "use_channel_attn": True,
                     "channel_attn_layers": [1], "use_style_dropout": True,
                     "style_dropout": {"alpha_min": 0.3, "alpha_max": 0.8}}


def _two_steps(variant: bool, ngf: int | None = None, steps: int = 2, **overrides):
    """``steps`` steps of both trainers on ``tiny_config`` (with the variant
    generator, at ``ngf``, with ``overrides``)."""
    cfg = tiny_config(batch_size=B, parallel={"num_devices": 1}, **overrides)
    if variant:
        cfg["model"]["generator"].update(VARIANT_GENERATOR)
    if ngf is not None:
        cfg["model"]["generator"]["ngf"] = ngf
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_cut_trainer, "train_augment", _eager_train_augment)
    try:
        return _run_two_steps(cfg, variant, steps)
    finally:
        patch.undo()


@pytest.fixture(scope="module")
def two_steps():
    return _two_steps(variant=False)


@pytest.fixture(scope="module")
def two_variant_steps():
    return _two_steps(variant=True)


def _variant_gains(g_params):
    """At init every variant block is an identity: gamma and fc2 are 0, so q,
    k, v and ``out`` get no gradient at all. Non-zero gains from a seed."""
    rng = np.random.default_rng(17)
    g = jax.tree_util.tree_map(np.array, g_params)
    g["attn_0"]["gamma"] = np.float32(0.5)
    for leaf in ("kernel", "bias"):
        shape = g["channel_attn_1"]["fc2"][leaf].shape
        g["channel_attn_1"]["fc2"][leaf] = 0.5 * rng.standard_normal(shape).astype(np.float32)
    for i in range(2):
        c = g[f"style_gate_{i}"]["gamma"].shape[0]
        g[f"style_gate_{i}"]["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        g[f"style_gate_{i}"]["beta"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    return jax.tree_util.tree_map(jax.numpy.asarray, g)


def _run_two_steps(cfg, variant=False, steps=2):
    from gan_variant_research_tpu.train.ema import ema_init

    jt = JaxCUTTrainer(cfg)
    jstate = jt.init_state()
    # With D's logits all inside the hinge margin, the gradient of its last
    # bias is analytically 0 (the real and fake terms cancel), and Adam
    # turns the rounding noise into a step of +-lr that moves every logit.
    # A bias of 1 puts some real logits past the margin.
    d_params = jax.tree_util.tree_map(lambda a: a, jstate.d_params)
    d_params["scale_0"]["conv_out"]["bias"] = jax.numpy.ones((1,), jax.numpy.float32)
    jstate = jstate.replace(d_params=d_params)
    if variant:
        g_params = _variant_gains(jstate.g_params)
        jstate = jstate.replace(g_params=g_params, ema=ema_init(g_params))
    pt = CUTTrainer(cfg)
    style = (2, 0.3, 0.8) if variant else None
    pstate = pt.state_from_jax(_np_tree(jstate.g_params), _np_tree(jstate.d_params),
                               device="cpu")
    rng = np.random.default_rng(7)
    fake_dtype = {"bf16": jax.numpy.bfloat16}.get(cfg["runtime"]["precision"], jax.numpy.float32)
    out = []
    for step in range(steps):
        photos = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
        monets = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
        draws = step_draws(jstate.base_key, step, B, S, pt.da_policy, fake_dtype,
                           pt.nce_tap_hw(), pt.num_patches, style=style)
        jstate, jlosses = jt.train_step(jstate, photos, monets, step=step)
        pstate, plosses = pt.train_step(pstate, torch.from_numpy(photos),
                                        torch.from_numpy(monets), step=step, draws=draws)
        out.append(({k: float(v) for k, v in jlosses.items()},
                    {k: float(v) for k, v in plosses.items()},
                    _jax_snapshot(jstate), _port_snapshot(pstate)))
    if steps == 2:
        assert pt.step_flags(0) == (True, True) and pt.step_flags(1) == (False, True)
    return out


def _before_instance_norm(name: str) -> bool:
    """G's biases with an analytic gradient of 0: the conv biases that an
    instance norm follows, and the attention key's bias (a constant shift of
    every key leaves the softmax unchanged)."""
    if name.startswith(("attn_", "channel_attn_")):
        return name.endswith("key.bias")
    return name.endswith("bias") and not name.startswith(("output_conv", "scale_"))


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.detach().numpy() - want).max()) / scale


@pytest.mark.parametrize("step", [0, 1])
def test_losses_match_jax(two_steps, step):
    _check_losses(two_steps, step)


@pytest.mark.parametrize("step", [0, 1])
def test_variant_losses_match_jax(two_variant_steps, step):
    _check_losses(two_variant_steps, step)


def _check_losses(run, step):
    want, got, _, _ = run[step]
    assert set(got) == set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        # float32 both sides; the sums of convs and reductions run in
        # another order
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    if step == 0:
        assert got["r1"] > 0
    else:
        assert got["r1"] == 0


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("net", ["g", "d"])
def test_adam_moments_match_jax(two_steps, step, net):
    """After one step mu is 0.5 x the clipped gradient, so this holds the
    gradients of both nets themselves."""
    _check_adam_moments(two_steps, step, net)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("net", ["g", "d"])
def test_variant_adam_moments_match_jax(two_variant_steps, step, net):
    """The gradients of the attention, channel-attention and style-gate
    leaves among them; ``attn_0.key.bias`` has an analytic gradient of 0 (a
    constant key shift leaves the softmax unchanged) and is compared as
    noise."""
    _, _, _, pstate = two_variant_steps[step]
    mu = pstate.opt_g.mu
    assert float(mu["attn_0.query.weight"].abs().max()) > 0
    assert float(mu["channel_attn_1.fc1.weight"].abs().max()) > 0
    _check_adam_moments(two_variant_steps, step, net)


def _check_adam_moments(run, step, net):
    _, _, jstate, pstate = run[step]
    conv = generator_state_dict_from_jax if net == "g" else discriminator_state_dict_from_jax
    adam = _adam_state(getattr(jstate, f"opt_{net}"))
    ported = getattr(pstate, f"opt_{net}")
    # the R1 step of step 0 is a second D update
    assert ported.count == int(adam.count) == step + 1 + (net == "d")
    for moment in ("mu", "nu"):
        want = {k: v.numpy() for k, v in conv(getattr(adam, moment)).items()}
        got = getattr(ported, moment)
        assert set(got) == set(want)
        net_max = max(float(np.abs(v).max()) for v in want.values())
        for k in want:
            if _before_instance_norm(k):
                # analytically 0: rounding noise on both sides, far below
                # the net's real gradients
                assert np.abs(got[k].numpy() - want[k]).max() <= 1e-4 * net_max, (moment, k)
            else:
                assert _rel(got[k], want[k]) <= 1e-4, (moment, k, _rel(got[k], want[k]))


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("which", ["g_params", "d_params", "ema"])
def test_params_match_jax(two_steps, step, which):
    """1e-5 where the reference mu is above 1e-3 of its leaf's max. Elsewhere,
    and on the conv biases before an instance norm, whose gradient is
    analytically 0, Adam's step is noise of about lr on each side: 3 lr a
    step."""
    _check_params(two_steps, step, which)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("which", ["g_params", "d_params", "ema"])
def test_variant_params_match_jax(two_variant_steps, step, which):
    _check_params(two_variant_steps, step, which)


def _check_params(run, step, which):
    _, _, jstate, pstate = run[step]
    net = "d" if which == "d_params" else "g"
    conv = generator_state_dict_from_jax if net == "g" else discriminator_state_dict_from_jax
    want = {k: v.numpy() for k, v in conv(getattr(jstate, which)).items()}
    mu = {k: v.numpy() for k, v in conv(_adam_state(getattr(jstate, f"opt_{net}")).mu).items()}
    got = getattr(pstate, which)
    assert set(got) == set(want)
    for k in want:
        d = np.abs(got[k].detach().numpy() - want[k])
        strong = np.abs(mu[k]) > 1e-3 * np.abs(mu[k]).max()
        if _before_instance_norm(k):
            strong[...] = False
        assert d[strong].max(initial=0) <= 1e-5, (k, d[strong].max())
        # Adam moves a noise leaf by about lr a step on each side
        assert d.max() <= 3 * 2e-4 * (step + 1), (k, d.max())


# --------------------------------------------------------------------------- #
# one step at other settings: the variant at other attention widths, the
# reference-literal D reals, the bf16 identity pass, warmup_steps 0


@pytest.fixture(scope="module", params=[8, 40], ids=lambda n: f"ngf{n}")
def width_step(request):
    """The variant step at ngf 8 (d_qk 4) and 40 (d_qk 20, d_v 160): the
    attention's padded route."""
    return _two_steps(variant=True, ngf=request.param, steps=1)


def test_variant_step_matches_jax_at_attention_widths(width_step):
    _check_losses(width_step, 0)
    for net in ("g", "d"):
        _check_adam_moments(width_step, 0, net)
    for which in ("g_params", "d_params", "ema"):
        _check_params(width_step, 0, which)


@pytest.fixture(scope="module")
def photo_domain_step():
    return _two_steps(variant=False, steps=1,
                      runtime={"precision": "fp32", "d_real_domain": "photo"})


def test_photo_domain_step_matches_jax(photo_domain_step):
    """``runtime.d_real_domain: photo``: D's reals are the photos, as the
    reference trains it."""
    _check_losses(photo_domain_step, 0)
    for net in ("g", "d"):
        _check_adam_moments(photo_domain_step, 0, net)
    for which in ("g_params", "d_params", "ema"):
        _check_params(photo_domain_step, 0, which)


@pytest.fixture(scope="module")
def bf16_identity_steps():
    return {fp32: _two_steps(variant=False, steps=1,
                             runtime={"precision": "bf16", "d_real_domain": "monet",
                                      "identity_fp32": fp32})[0]
            for fp32 in (False, True)}


def test_bf16_identity_pass_and_its_float32_island_match_jax(bf16_identity_steps):
    """bf16 compute: with ``runtime.identity_fp32`` the identity pass is a
    float32 island (the float32 generator on the same parameters, the same
    bf16-free inputs) and its L1 agrees with JAX's to float32 rounding (6e-7
    measured); without it the pass runs in bf16 on both sides and agrees to
    bf16 rounding of the activations, averaged by the L1 mean (1.7e-4
    measured). The bf16 pass lands much farther from the float32 island
    than the port's island does: the flag selects the pass."""
    (want16, got16, _, _), (want32, got32, _, _) = (bf16_identity_steps[False],
                                                    bf16_identity_steps[True])
    np.testing.assert_allclose(got32["identity"], want32["identity"], rtol=1e-5)
    np.testing.assert_allclose(got16["identity"], want16["identity"], rtol=2e-3)
    island = abs(got32["identity"] - want32["identity"])
    assert abs(got16["identity"] - want32["identity"]) > 10 * island
    for got in (got16, got32):
        assert all(np.isfinite(v) for v in got.values())


def test_warmup_steps_zero_diverges_from_jax_at_step_0():
    """The JAX step's device formula min(step / warmup_steps, 1) is 0/0 at
    step 0 with warmup_steps 0: identity_weight and g_loss are NaN there and
    the JAX loop's tripwire stops the run (ROADMAP Queue 3). The port takes
    the final weight and stays finite; the rest of the step agrees."""
    from gan_variant_research_tpu.train import loop as jax_loop
    from gan_variant_research_tpu_torch.train import loop as port_loop

    want, got, _, _ = _two_steps(variant=False, steps=1, warmup_steps=0)[0]
    assert np.isnan(want["g_loss"]) and np.isnan(want["identity_weight"])
    with pytest.raises(ValueError, match="NaN loss"):
        jax_loop._check_finite(0, want)
    port_loop._check_finite(0, got)
    assert all(np.isfinite(v) for v in got.values())
    assert got["identity_weight"] == 0.0 and got["identity"] == 0.0
    np.testing.assert_allclose(got["g_loss"], want["g_adv"] + want["nce"], rtol=1e-4)
    for k in ("d_loss", "g_adv", "nce", "r1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
