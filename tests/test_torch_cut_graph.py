"""The CUT step split for CUDA graphs, on the CPU: host bookkeeping around a
body that reads only tensors. The body on its graph buffers (batches,
draws and float32 0-d scalars copied in, as a replay reads them) and the
eager ``train_step`` against the step as it was written before the split
(Python-float scalars in Adam and the identity merge), three steps at the
parity tests' small shapes (R1 on steps 0 and 2, identity on); the graph
key; the returned losses; the counters; Adam on tensor scalars against
optax."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from gan_variant_research_tpu.train.optim import optimizer_from_config as jax_optimizer
from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.data.augment import train_augment
from gan_variant_research_tpu_torch.losses.adversarial import (
    discriminator_hinge_loss,
    generator_hinge_loss,
)
from gan_variant_research_tpu_torch.losses.patchnce import patch_nce_loss
from gan_variant_research_tpu_torch.losses.reconstruction import identity_loss
from gan_variant_research_tpu_torch.train import optim
from gan_variant_research_tpu_torch.train.cut_trainer import (
    LOSS_KEYS,
    CUTTrainer,
    StepScalars,
    _StepGraph,
    _tensors,
)
from gan_variant_research_tpu_torch.train.ema import ema_update
from test_cut_trainer import tiny_config
from test_torch_cut_trainer import VARIANT_GENERATOR

B, S, STEPS = 2, 32, 3


def _config(variant: bool = False) -> dict:
    cfg = tiny_config(batch_size=B, parallel={"num_devices": 1})
    if variant:
        cfg["model"]["generator"].update(VARIANT_GENERATOR)
    return cfg


def _inputs(trainer: CUTTrainer, steps: int = STEPS, seed: int = 7):
    """Per step: uint8 photos and Monets, and draws from a seeded sampler."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    return [(torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)),
             trainer.sample_draws(gen, B)) for _ in range(steps)]


def _adam_as_it_was(opt: optim.Optimizer, params, grads, state):
    """``Optimizer.step`` before the split: the scalars as Python floats."""
    with torch.no_grad():
        if opt.max_norm is not None:
            grads = optim.clip_by_global_norm(grads, opt.max_norm)
        count = state.count + 1
        lr = opt.learning_rate(state.count)
        c1, c2 = 1.0 - opt.b1 ** count, 1.0 - opt.b2 ** count
        for k, p in params.items():
            g = grads[k].float()
            mu, nu = state.mu[k], state.nu[k]
            mu.mul_(opt.b1).add_((1.0 - opt.b1) * g)
            nu.mul_(opt.b2).add_((1.0 - opt.b2) * g.square())
            update = (mu / c1) / (torch.sqrt(nu / c2) + opt.eps)
            p.add_((-lr * update).to(p.dtype))
    return optim.AdamState(count, state.mu, state.nu)


def _step_as_it_was(t: CUTTrainer, state, photos_u8, monets_u8, step: int, draws):
    """``CUTTrainer.train_step`` as it was written before the split into host
    bookkeeping and a body on tensors, spans left out."""
    do_r1, do_identity = t.step_flags(step)
    batch = photos_u8.shape[0]
    g_params, d_params = state.g_params, state.d_params
    zero = torch.zeros((), dtype=torch.float32)
    photos = train_augment(photos_u8, t.image_size, draws.photo_aug)
    monets = train_augment(monets_u8, t.image_size, draws.monet_aug)
    identity_weight = t.identity_weight_at(step)
    real = photos if t.d_real_domain == "photo" else monets
    fake, src_feats = functional_call(t.generator, g_params, (photos,),
                                      {"extract": t.nce_layers, "style_alpha": draws.style_fwd})
    _, tgt_feats = functional_call(t.generator, g_params, (fake,),
                                   {"extract": t.nce_layers, "taps_only": True,
                                    "style_alpha": draws.style_nce})
    preds = t._d(d_params, torch.cat([t._aug(real, draws.da_real).float(),
                                      t._aug(fake.detach(), draws.da_fake).float()]))
    d_loss = discriminator_hinge_loss([p[:batch] for p in preds], [p[batch:] for p in preds])
    d_grads = torch.autograd.grad(d_loss, list(d_params.values()))
    opt_d = _adam_as_it_was(t.opt_d, d_params, dict(zip(d_params, d_grads)), state.opt_d)
    r1 = zero
    if do_r1:
        real32 = real.detach().float().requires_grad_()
        d_sum = sum(p.float().sum() for p in t._d(d_params, real32, fp32=True))
        (g_img,) = torch.autograd.grad(d_sum, real32, create_graph=True)
        r1 = g_img.square().sum(dim=(1, 2, 3)).mean()
        r1_grads = torch.autograd.grad(r1 * (t.r1_gamma * t.r1_every), list(d_params.values()),
                                       materialize_grads=True)
        opt_d = _adam_as_it_was(t.opt_d, d_params, dict(zip(d_params, r1_grads)), opt_d)
        r1 = r1.detach()
    g_adv = generator_hinge_loss(t._d(d_params, t._aug(fake, draws.da_g)))
    nce = patch_nce_loss(src_feats, tgt_feats, draws.nce, t.temperature)
    head = t.adv_w * g_adv + t.nce_w * nce
    g_grads = list(torch.autograd.grad(head, list(g_params.values())))
    idt = zero
    if do_identity:
        rec = functional_call(t.generator, g_params, (monets.to(t.generator.dtype),),
                              {"style_alpha": draws.style_idt})
        idt = identity_loss(rec, monets)
        idt_grads = torch.autograd.grad(idt, list(g_params.values()))
        g_grads = [g + identity_weight * ig for g, ig in zip(g_grads, idt_grads)]
        idt = idt.detach()
    opt_g = _adam_as_it_was(t.opt_g, g_params, dict(zip(g_params, g_grads)), state.opt_g)
    ema_update(state.ema, g_params, t.ema_decay)
    state.step, state.opt_g, state.opt_d = step + 1, opt_g, opt_d
    return {"d_loss": d_loss.detach(), "g_loss": (head + identity_weight * idt).detach(),
            "g_adv": g_adv.detach(), "nce": nce.detach(), "identity": idt, "r1": r1,
            "identity_weight": torch.full_like(zero, identity_weight), "featmatch": zero,
            "palette": zero, "repulsion": zero}


def _on_buffers(t: CUTTrainer, graphs: dict, state, photos_u8, monets_u8, step: int, draws):
    """What a replay does, run eagerly: the step's inputs copied into the
    key's buffers (made from the first step of the key), the body on them,
    the host's books."""
    flags = t.step_flags(step)
    values = t.step_scalars(state, step)
    g = graphs.get(flags)
    if g is None:
        g = graphs[flags] = _StepGraph(photos_u8, monets_u8, draws, values)
    else:
        g.load(photos_u8, monets_u8, draws, values)
    losses = torch.stack(t._body(state, g.photos, g.monets, g.draws, g.scalars, *flags))
    t._advance(state, step, flags[0])
    return dict(zip(LOSS_KEYS, losses.unbind()))


def _snapshot(state) -> dict:
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
    return {"g_params": clone(state.g_params), "d_params": clone(state.d_params),
            "ema": clone(state.ema), "g_mu": clone(state.opt_g.mu), "g_nu": clone(state.opt_g.nu),
            "d_mu": clone(state.opt_d.mu), "d_nu": clone(state.opt_d.nu),
            "counts": (state.opt_g.count, state.opt_d.count, state.step)}


def _run(how: str, variant: bool = False):
    t = CUTTrainer(_config(variant))
    state = t.init_state(seed=5, device="cpu")
    graphs = {}
    out = []
    for step, (photos, monets, draws) in enumerate(_inputs(t)):
        if how == "as_it_was":
            losses = _step_as_it_was(t, state, photos, monets, step, draws)
        elif how == "train_step":
            state, losses = t.train_step(state, photos, monets, step=step, draws=draws)
        else:
            losses = _on_buffers(t, graphs, state, photos, monets, step, draws)
        out.append(({k: float(v) for k, v in losses.items()}, _snapshot(state)))
    if how == "buffers":
        # the R1 key's buffers were made at step 0 and loaded at step 2
        assert set(graphs) == {(True, True), (False, True)}
    return t, out


@pytest.fixture(scope="module")
def as_it_was():
    trainer, out = _run("as_it_was")
    assert [trainer.step_flags(s) for s in range(STEPS)] == [(True, True), (False, True),
                                                            (True, True)]
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("how", ["buffers", "train_step"])
def test_body_equals_the_step_as_it_was(as_it_was, how):
    """Leaf for leaf, within test_torch_cut_trainer.py's tolerances: losses
    1e-4 relative (1e-6 absolute), Adam's moments 1e-4 of the leaf's max,
    parameters and EMA 1e-5; the counts equal."""
    _, got = _run(how)
    for step, ((want_l, want_s), (got_l, got_s)) in enumerate(zip(as_it_was, got)):
        assert set(got_l) == set(want_l) == set(LOSS_KEYS)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(got_l[k], want_l[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step} {k}")
        assert got_s["counts"] == want_s["counts"]
        for part in ("g_mu", "g_nu", "d_mu", "d_nu"):
            for k, want in want_s[part].items():
                assert _rel(got_s[part][k], want) <= 1e-4, (step, part, k)
        for part in ("g_params", "d_params", "ema"):
            for k, want in want_s[part].items():
                assert float((got_s[part][k] - want).abs().max()) <= 1e-5, (step, part, k)
    assert got[0][0]["r1"] > 0 and got[1][0]["r1"] == 0 and got[2][0]["r1"] > 0


def test_variant_body_on_buffers_equals_train_step():
    """The variant generator's style-gate draws ride in the buffers too."""
    _, eager = _run("train_step", variant=True)
    _, buffered = _run("buffers", variant=True)
    for (want_l, want_s), (got_l, got_s) in zip(eager, buffered):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(got_l[k], want_l[k], rtol=1e-4, atol=1e-6, err_msg=k)
        for part in ("g_params", "ema", "d_params"):
            for k, want in want_s[part].items():
                assert float((got_s[part][k] - want).abs().max()) <= 1e-5, (part, k)


def test_load_copies_every_draw_and_fills_the_scalars():
    t = CUTTrainer(_config(variant=True))
    state = t.init_state(seed=5, device="cpu")
    (p0, m0, d0), (p1, m1, d1) = _inputs(t, steps=2)
    assert d0.style_fwd is not None and d0.da_real is not None
    g = _StepGraph(p0, m0, d0, t.step_scalars(state, 0))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(_tensors(g.draws), _tensors(d0)))
    values = StepScalars(*(0.5 + i for i in range(len(StepScalars._fields))))
    buffers = [g.photos, g.monets, *_tensors(g.draws), *g.scalars]
    g.load(p1, m1, d1, values)
    assert [b.data_ptr() for b in [g.photos, g.monets, *_tensors(g.draws), *g.scalars]] == [
        b.data_ptr() for b in buffers]
    assert torch.equal(g.photos, p1) and torch.equal(g.monets, m1)
    assert len(_tensors(g.draws)) == len(_tensors(d1))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(g.draws), _tensors(d1)))
    assert all(s.dtype == torch.float32 and s.dim() == 0 and float(s) == v
               for s, v in zip(g.scalars, values))


def test_a_new_state_or_batch_shape_gives_a_new_key():
    t = CUTTrainer(_config())
    state = t.init_state(seed=5, device="cpu")
    photos, monets, _ = _inputs(t, steps=1)[0]
    key = t._graph_key(state, photos, monets, True, True)
    assert t._graph_key(state, photos.clone(), monets.clone(), True, True) == key
    assert t._graph_key(state, photos, monets, False, True) != key
    assert t._graph_key(state, photos[:1], monets[:1], True, True) != key
    assert t._graph_key(state, photos.float(), monets, True, True) != key
    other = t.init_state(seed=5, device="cpu")
    assert t._graph_key(other, photos, monets, True, True) != key
    # a state restored from a checkpoint payload is a new state
    restored = t.state_from_payload(_numpy_payload(t.checkpoint_payload(state)), step=0,
                                    device="cpu")
    assert t._graph_key(restored, photos, monets, True, True) != key
    # one leaf moved to new memory is a new key
    state.ema[next(iter(state.ema))] = state.ema[next(iter(state.ema))].clone()
    assert t._graph_key(state, photos, monets, True, True) != key


def _numpy_payload(tree):
    if isinstance(tree, dict):
        return {k: _numpy_payload(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return tree


@pytest.mark.parametrize("how", ["train_step", "buffers"])
def test_returned_losses_are_fresh_each_call(how):
    """The losses of a call are one tensor of their own: a later call, which
    on the card overwrites the graph's outputs and scalars, leaves them as
    they were."""
    t = CUTTrainer(_config())
    state = t.init_state(seed=5, device="cpu")
    graphs = {}
    seen = []
    for step, (photos, monets, draws) in enumerate(_inputs(t)):
        if how == "train_step":
            state, losses = t.train_step(state, photos, monets, step=step, draws=draws)
        else:
            losses = _on_buffers(t, graphs, state, photos, monets, step, draws)
        seen.append((losses, {k: float(v) for k, v in losses.items()}))
    storages = {losses["d_loss"].untyped_storage().data_ptr() for losses, _ in seen}
    assert len(storages) == STEPS
    scalars = {s.untyped_storage().data_ptr() for g in graphs.values() for s in g.scalars}
    for losses, values in seen:
        assert len({v.untyped_storage().data_ptr() for v in losses.values()}) == 1
        assert not scalars & {losses["identity_weight"].untyped_storage().data_ptr()}
        assert {k: float(v) for k, v in losses.items()} == values
        assert all(v.dtype == torch.float32 and v.dim() == 0 for v in losses.values())


def test_the_cpu_path_counts_eager_steps_only():
    t = CUTTrainer(_config())
    state = t.init_state(seed=5, device="cpu")
    names = ("cut.graph.eager", "cut.graph.capture", "cut.graph.replay")
    before = {k: trace.COUNTS.get(k, 0) for k in names}
    for step, (photos, monets, _) in enumerate(_inputs(t)):
        state, _ = t.train_step(state, photos, monets, step=step)
    after = {k: trace.COUNTS.get(k, 0) for k in names}
    assert {k: after[k] - before[k] for k in names} == {
        "cut.graph.eager": STEPS, "cut.graph.capture": 0, "cut.graph.replay": 0}
    assert t._graphs == {} and t._pool is None


def test_step_scalars_follow_the_counts_and_the_warmup():
    t = CUTTrainer(_config())
    state = t.init_state(seed=5, device="cpu")
    state.opt_g.count, state.opt_d.count = 4, 9
    sc = t.step_scalars(state, 3)
    assert (sc.g_lr, sc.g_c1, sc.g_c2) == t.opt_g.scalars(4) == (
        2e-4, 1.0 - 0.5 ** 5, 1.0 - 0.999 ** 5)
    assert (sc.d_lr, sc.d_c1, sc.d_c2) == t.opt_d.scalars(9)
    assert (sc.r1_lr, sc.r1_c1, sc.r1_c2) == t.opt_d.scalars(10)
    assert sc.identity_weight == t.identity_weight_at(3)


OPT_CASES = [
    ({"lr": 2e-4, "betas": [0.5, 0.999]}, 30.0),      # the clip fires
    ({"lr": 2e-4, "betas": [0.5, 0.999]}, 0.1),       # it does not
    ({"lr": 1e-3, "betas": [0.9, 0.99],
      "scheduler": {"enabled": True, "type": "cosine", "lr_min": 1e-4}}, 1.0),
]


def _opt_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


@pytest.mark.parametrize("opt_cfg,grad_scale", OPT_CASES)
def test_adam_update_on_tensor_scalars_matches_optax(opt_cfg, grad_scale):
    """``Optimizer.update`` fed ``scalars(count)`` as float32 0-d tensors, as
    the graph's buffers hold them, three updates against optax's chain; the
    same bits as ``Optimizer.step`` and as the Python-float arithmetic it
    replaced."""
    jopt = jax_optimizer(opt_cfg, 10.0, max_steps=5)
    popt = optim.optimizer_from_config(opt_cfg, 10.0, max_steps=5)
    jparams = {k: jnp.asarray(v) for k, v in _opt_params(0).items()}
    runs = {how: {k: torch.from_numpy(v.copy()) for k, v in _opt_params(0).items()}
            for how in ("update", "step", "as_it_was")}
    states = {how: popt.init(p) for how, p in runs.items()}
    jstate = jopt.init(jparams)
    for i in range(3):
        grads = {k: v * grad_scale for k, v in _opt_params(10 + i).items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        st = states["update"]
        scalars = [torch.full((), v, dtype=torch.float32) for v in popt.scalars(st.count)]
        popt.update(runs["update"], tg, st, *scalars)
        states["update"] = optim.AdamState(st.count + 1, st.mu, st.nu)
        states["step"] = popt.step(runs["step"], tg, states["step"])
        states["as_it_was"] = _adam_as_it_was(popt, runs["as_it_was"], tg, states["as_it_was"])
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu")][0]
    for k in jparams:
        got = runs["update"][k]
        np.testing.assert_allclose(states["update"].mu[k].numpy(), np.asarray(adam.mu[k]),
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(states["update"].nu[k].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(got.numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-7)
        assert torch.equal(got, runs["step"][k]) and torch.equal(got, runs["as_it_was"][k])
    assert states["update"].count == states["step"].count == int(adam.count) == 3
