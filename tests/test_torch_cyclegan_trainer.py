"""The port's CycleGAN train step against the JAX ``CycleGANTrainer``: two
steps with the same draws, each from the same state (converted weights,
then the JAX state after step 0 through its payload; the second step at a
decayed learning rate), for LSGAN and BCE and for the bias-free ResNet and
the U-Net, float32, JAX on the CPU; the batched generator loss against its
six-apply form; the epoch decay against the JAX schedule; the config
checks; and checkpoint payloads restored across the packages leaf for
leaf. Sizes of ``test_cyclegan_trainer.py::tiny_cfg`` (16^2 crops of 20^2
loads, ngf 4, ndf 4, 6 blocks, 2 D layers); the U-Net at 32^2 crops of
36^2 loads, so that its innermost map is 2x2.

The generators' gradients are ill-conditioned in float32 here: the cycle
term runs one generator on the other's output, and two orders of the same
float32 sums move a leaf's gradient by up to ~3e-4 of its largest value
(ResNet) and ~4e-2 (U-Net; the JAX U-Net step jitted whole moves 1.1e-2
from the same step run op by op, so the U-Net is held against the JAX step
op by op). The U-Net alone matches flax to 1e-5 in value and gradient
(``test_torch_generator_unet.py``); the losses match to 1e-5 here."""

from types import SimpleNamespace

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.train import checkpoint as jax_ckpt
from gan_variant_research_tpu.train.cyclegan_trainer import CycleGANTrainer as JaxTrainer
from gan_variant_research_tpu_torch.convert import (
    cyclegan_generator_state_dict_from_jax,
    patchgan_state_dict_from_jax,
)
from gan_variant_research_tpu_torch.data.augment import cyclegan_augment
from gan_variant_research_tpu_torch.losses.adversarial import gan_loss
from gan_variant_research_tpu_torch.losses.reconstruction import cycle_loss, identity_loss
from gan_variant_research_tpu_torch.train import checkpoint as port_ckpt
from gan_variant_research_tpu_torch.train.cyclegan_trainer import (
    GENERATORS,
    LOSS_KEYS,
    CycleGANTrainer,
)
from test_cyclegan_trainer import tiny_cfg
from torch_jax_draws import cyclegan_draws

B = 2
# generator -> (crop, load)
SIZES = {"resnet": (16, 20), "unet": (32, 36)}
# Adam's mu and nu: each leaf within this share of its largest value (the
# float32 conditioning above; measured 3.3e-4 and 3.7e-2)
MOMENT_TOL = {"resnet": 1e-3, "unet": 5e-2}
CASES = [("resnet", "lsgan"), ("resnet", "bce"), ("unet", "lsgan"), ("unet", "bce")]


def _cfg(generator="resnet", gan="lsgan", optim=None):
    crop, load = SIZES[generator]
    # with one step an epoch, decay from epoch 0: step 1 runs at 0.75 lr
    return tiny_cfg(loss={"gan": gan}, model={"generator": generator},
                    data={"img_size": crop, "load_size": load},
                    optim={"lr_decay_after": 0, **(optim or {})})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_nets(state):
    return {"G_A2B": _np_tree(state.g_params["G_A2B"]), "G_B2A": _np_tree(state.g_params["G_B2A"]),
            "D_A": _np_tree(state.da_params), "D_B": _np_tree(state.db_params)}


def _port_snapshot(state):
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
    adam = lambda a: SimpleNamespace(count=a.count, mu=clone(a.mu), nu=clone(a.nu))  # noqa: E731
    return SimpleNamespace(g=clone(state.g_params), da=clone(state.da_params),
                           db=clone(state.db_params), opt_g=adam(state.opt_g),
                           opt_da=adam(state.opt_da), opt_db=adam(state.opt_db))


def _jax_adam(opt_state):
    """optax's ScaleByAdamState inside adam(schedule)."""
    return opt_state[0]


def _g_sd(tree, kind):
    return {f"{name}.{k}": v.numpy() for name in GENERATORS
            for k, v in cyclegan_generator_state_dict_from_jax(tree[name], kind).items()}


def _d_sd(tree):
    return {k: v.numpy() for k, v in patchgan_state_dict_from_jax(tree).items()}


def _run(generator, gan, steps=2):
    cfg = _cfg(generator, gan)
    crop, load = SIZES[generator]
    jt = JaxTrainer(cfg, steps_per_epoch=1)
    jstate = jt.init_state()
    pt = CycleGANTrainer(cfg, steps_per_epoch=1)
    pstate = pt.state_from_jax(_jax_nets(jstate), device="cpu")
    rng = np.random.default_rng(3)
    out = []
    for step in range(steps):
        if step:
            # each step from the same state: the JAX state, through its payload
            # (one Adam step turns every gradient element into a step of +-lr,
            # so elements whose gradient is rounding noise move apart by 2 lr,
            # and at these sizes the next gradient amplifies that)
            payload = _np_tree(flax.serialization.to_state_dict(jt.checkpoint_payload(jstate)))
            pstate = pt.state_from_payload(payload, step, device="cpu")
        a = rng.integers(0, 256, (B, load, load, 3), dtype=np.uint8)
        b = rng.integers(0, 256, (B, load, load, 3), dtype=np.uint8)
        draws = cyclegan_draws(jstate.base_key, step, B, load, load, crop)
        if generator == "unet":
            with jax.disable_jit():
                jstate, jlosses = jt._train_step(jstate, jnp.asarray(a), jnp.asarray(b))
        else:
            jstate, jlosses = jt.train_step(jstate, a, b)
        pstate, plosses = pt.train_step(pstate, torch.from_numpy(a), torch.from_numpy(b),
                                        draws=draws)
        jsnap = SimpleNamespace(
            g=_g_sd(jstate.g_params, generator), da=_d_sd(jstate.da_params),
            db=_d_sd(jstate.db_params),
            **{f"opt_{net}": SimpleNamespace(
                count=int(_jax_adam(getattr(jstate, f"opt_{net}")).count),
                mu=conv(_jax_adam(getattr(jstate, f"opt_{net}")).mu),
                nu=conv(_jax_adam(getattr(jstate, f"opt_{net}")).nu))
               for net, conv in (("g", lambda t: _g_sd(_np_tree(t), generator)),
                                 ("da", lambda t: _d_sd(_np_tree(t))),
                                 ("db", lambda t: _d_sd(_np_tree(t))))})
        out.append(({k: float(v) for k, v in jlosses.items()},
                    {k: float(v) for k, v in plosses.items()}, jsnap, _port_snapshot(pstate)))
    return out


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def two_steps(request):
    return request.param, _run(*request.param)


def _zero_gradient(name: str, generator: str) -> bool:
    """Leaves whose gradient is analytically 0: the U-Net's conv and
    transposed-conv biases that an instance norm follows (all but the
    output conv's). The ResNet's convs are bias-free but the output's; D's
    convs before its instance norms have no bias."""
    return (generator == "unet" and name.endswith(".bias")
            and not name.split(".", 1)[1].startswith("_SameConv_11."))


@pytest.mark.parametrize("step", [0, 1])
def test_losses_match_jax(two_steps, step):
    _, run = two_steps
    want, got, _, _ = run[step]
    assert set(got) == set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("net", ["g", "da", "db"])
def test_adam_moments_match_jax(two_steps, step, net):
    """mu and nu, each leaf to ``MOMENT_TOL`` of its largest value (of the
    net's largest on leaves whose gradient is analytically 0)."""
    (generator, _), run = two_steps
    _, _, jsnap, psnap = run[step]
    want, got = getattr(jsnap, f"opt_{net}"), getattr(psnap, f"opt_{net}")
    assert got.count == want.count == step + 1
    for moment in ("mu", "nu"):
        w, g = getattr(want, moment), getattr(got, moment)
        assert set(g) == set(w)
        net_max = max(float(np.abs(v).max()) for v in w.values())
        for k in w:
            scale = net_max if _zero_gradient(k, generator) else float(np.abs(w[k]).max())
            err = float(np.abs(g[k].numpy() - w[k]).max())
            assert err <= MOMENT_TOL[generator] * scale, (moment, k, err, scale)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("net", ["g", "da", "db"])
def test_params_match_jax(two_steps, step, net):
    """Each leaf to 1e-4 of its largest value (or 1e-4, for a leaf below 1)
    where JAX's mu is above twice ``MOMENT_TOL`` of the leaf's largest mu.
    Elsewhere Adam can turn a gradient element within the moments' error
    into a step of lr either way: within 2 lr."""
    (generator, _), run = two_steps
    _, _, jsnap, psnap = run[step]
    want, got = getattr(jsnap, net), getattr(psnap, net)
    mu = getattr(jsnap, f"opt_{net}").mu
    assert set(got) == set(want)
    for k in want:
        d = np.abs(got[k].numpy() - want[k])
        strong = np.abs(mu[k]) > 2 * MOMENT_TOL[generator] * np.abs(mu[k]).max()
        if _zero_gradient(k, generator):
            strong[...] = False
        scale = max(float(np.abs(want[k]).max()), 1.0)
        assert d[strong].max(initial=0) <= 1e-4 * scale, (k, d[strong].max(), scale)
        assert d.max() <= 2 * 2e-4 * (1 + 1e-3), (k, d.max())


# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def port_trainer():
    return CycleGANTrainer(_cfg(), steps_per_epoch=2)


def test_batched_g_matches_sequential(port_trainer):
    """The batched loss the step differentiates (three generator applies)
    against the reference's six sequential applies: the same value and the
    same gradient in every leaf, to 1e-4 of the leaf's largest value (JAX's
    test_batched_g_matches_sequential: float32 reassociation only, which the
    cycle term amplifies on elements near 0)."""
    t = port_trainer
    s = t.init_state(device="cpu")
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.integers(0, 256, (B, 20, 20, 3), dtype=np.uint8))
            for _ in range(2))
    draws = t.sample_draws(torch.Generator().manual_seed(0), a.shape)
    real_A = cyclegan_augment(a, 16, draws.aug_a)
    real_B = cyclegan_augment(b, 16, draws.aug_b)
    g = s.g_params

    def sequential():
        fake_B = t._g(g, "G_A2B", real_A)
        rec_A = t._g(g, "G_B2A", fake_B)
        fake_A = t._g(g, "G_B2A", real_B)
        rec_B = t._g(g, "G_A2B", fake_A)
        idt_B = t._g(g, "G_A2B", real_B)
        idt_A = t._g(g, "G_B2A", real_A)
        return (gan_loss(t._d(s.db_params, fake_B), True) + gan_loss(t._d(s.da_params, fake_A), True)
                + cycle_loss(rec_A, real_A, 10.0) + cycle_loss(rec_B, real_B, 10.0)
                + 0.5 * (identity_loss(idt_A, real_A) + identity_loss(idt_B, real_B)))

    seq = sequential()
    grads_seq = torch.autograd.grad(seq, list(g.values()))
    bat, _ = t.g_loss(g, s.da_params, s.db_params, real_A, real_B)
    grads_bat = torch.autograd.grad(bat, list(g.values()))
    assert float(bat.detach()) == pytest.approx(float(seq.detach()), rel=1e-5)
    for name, gb, gs in zip(g, grads_bat, grads_seq):
        assert float((gb - gs).abs().max()) <= 1e-4 * float(gs.abs().max()), name
    # the step reports the same total
    _, losses = t.train_step(s, a, b, draws=draws)
    assert float(losses["G"]) == pytest.approx(float(seq.detach()), rel=1e-5)


def _jax_update(trainer, count):
    """JAX's ``opt_g`` update of a gradient of 1 from Adam's first state at
    schedule count ``count``: minus the rate there times one Adam direction
    that does not depend on ``count``."""
    params = {"w": jnp.zeros((1,), jnp.float32)}
    adam_state, sched_state = trainer.opt_g.init(params)
    state = (adam_state, sched_state._replace(count=jnp.asarray(count, jnp.int32)))
    upd, _ = trainer.opt_g.update({"w": jnp.ones((1,), jnp.float32)}, state, params)
    return float(upd["w"][0])


@pytest.mark.parametrize("spe", [1, 7])
def test_epoch_decay_matches_jax(spe):
    """epochs 4, decay from epoch 2: counts on either side of the first
    decayed epoch and of the last epoch, and past it."""
    cfg = _cfg(optim={"lr_decay_after": 2, "lr_g": 3e-4})
    jt = JaxTrainer(cfg, steps_per_epoch=spe)
    pt = CycleGANTrainer(cfg, steps_per_epoch=spe)
    first = _jax_update(jt, 0)
    for epoch, within in [(0, 0), (1, spe - 1), (2, 0), (2, spe - 1), (3, 0), (3, spe - 1),
                          (4, 0), (5, 3)]:
        count = epoch * spe + within
        want = 3e-4 * _jax_update(jt, count) / first
        got = pt.opt_g.learning_rate(count)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (epoch, within)
    assert pt.opt_g.learning_rate(2 * spe) == pytest.approx(3e-4)
    assert pt.opt_g.learning_rate(3 * spe) == pytest.approx(1.5e-4)
    assert pt.opt_g.learning_rate(4 * spe) == 0.0


def test_bad_gan_mode_rejected():
    with pytest.raises(ValueError, match="lsgan\\|bce"):
        CycleGANTrainer(_cfg(gan="wgan"))


def test_bad_n_blocks_rejected():
    with pytest.raises(ValueError, match="6 or 9"):
        CycleGANTrainer(tiny_cfg(model={"n_blocks": 3}))


def test_spectral_norm_d_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="'Variant losses and D options'"):
        CycleGANTrainer(tiny_cfg(model={"spectral_norm_d": True}))


# --------------------------------------------------------------------------- #
# payloads across the packages


def _assert_state_matches_jax(pstate, jstate, generator):
    assert pstate.step == int(jstate.step)
    pairs = [(pstate.g_params, _g_sd(_np_tree(jstate.g_params), generator)),
             (pstate.da_params, _d_sd(_np_tree(jstate.da_params))),
             (pstate.db_params, _d_sd(_np_tree(jstate.db_params)))]
    for net in ("g", "da", "db"):
        ported, adam = getattr(pstate, f"opt_{net}"), _jax_adam(getattr(jstate, f"opt_{net}"))
        conv = (lambda t: _g_sd(_np_tree(t), generator)) if net == "g" else (
            lambda t: _d_sd(_np_tree(t)))
        assert ported.count == int(adam.count)
        assert int(getattr(jstate, f"opt_{net}")[1].count) == ported.count
        pairs += [(ported.mu, conv(adam.mu)), (ported.nu, conv(adam.nu))]
    for got, want in pairs:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].detach().numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(pstate.base_key, np.asarray(jax.random.key_data(jstate.base_key)))


@pytest.mark.parametrize("generator", ["resnet", "unet"])
def test_port_payload_restores_through_jax(tmp_path, generator):
    cfg = _cfg(generator)
    _, load = SIZES[generator]
    pt = CycleGANTrainer(cfg, steps_per_epoch=1)
    state = pt.init_state(device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(2):
        u8 = [torch.from_numpy(rng.integers(0, 256, (B, load, load, 3), dtype=np.uint8))
              for _ in range(2)]
        state, _ = pt.train_step(state, *u8)
    path = port_ckpt.save_checkpoint(tmp_path / "ckpt_e2.msgpack", state.step,
                                     pt.checkpoint_payload(state), config=cfg)
    blob = jax_ckpt.load_checkpoint(path)
    jstate = JaxTrainer(cfg, steps_per_epoch=1).state_from_payload(blob["payload"], blob["step"])
    _assert_state_matches_jax(state, jstate, generator)


@pytest.mark.parametrize("generator", ["resnet", "unet"])
def test_jax_payload_restores_through_the_port(tmp_path, generator):
    cfg = _cfg(generator)
    _, load = SIZES[generator]
    jt = JaxTrainer(cfg, steps_per_epoch=1)
    jstate = jt.init_state()
    rng = np.random.default_rng(4)
    jstate, _ = jt.train_step(jstate, *(rng.integers(0, 256, (B, load, load, 3), dtype=np.uint8)
                                        for _ in range(2)))
    path = jax_ckpt.save_checkpoint(tmp_path / "ckpt_e1.msgpack", int(jstate.step),
                                    jt.checkpoint_payload(jstate), config=cfg)
    blob = port_ckpt.load_checkpoint(path)
    pstate = CycleGANTrainer(cfg, steps_per_epoch=1).state_from_payload(
        blob["payload"], blob["step"], device="cpu")
    _assert_state_matches_jax(pstate, jstate, generator)
    # no torch_rng in a JAX checkpoint: the sampler starts from the seed
    assert torch.equal(pstate.rng.get_state(),
                       torch.Generator().manual_seed(cfg["training"]["seed"]).get_state())


def test_port_init_state_carries_the_jax_run_key():
    pt = CycleGANTrainer(_cfg(), steps_per_epoch=1)
    jstate = JaxTrainer(_cfg(), steps_per_epoch=1).init_state()
    np.testing.assert_array_equal(pt.init_state(device="cpu").base_key,
                                  np.asarray(jax.random.key_data(jstate.base_key)))


def test_optax_layout_of_the_optimizer_state(port_trainer):
    """optim_G is optax's ``adam(schedule)`` state: Adam's, then the
    schedule's count, with no clip level."""
    payload = port_trainer.checkpoint_payload(port_trainer.init_state(device="cpu"))
    jt = JaxTrainer(_cfg(), steps_per_epoch=2)
    want = jax.tree_util.tree_structure(flax.serialization.to_state_dict(jt.init_state().opt_g))
    got = jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, payload["optim_G"]))
    assert got == want
