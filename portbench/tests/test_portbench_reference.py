"""The plain reference against the program's CPU path in float32, at ngf 8,
32^2 and batch 2: one step of each trainer on the same weights, images and
draws, and one served batch. The benchmark's parameter names are the
program's state-dict names."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from portbench import compare
from portbench import draws as D
from portbench import measure as M
from portbench.reference import nets
from portbench.reference import steps as ref

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 11


def _config(name: str) -> dict:
    cfg = copy.deepcopy(json.loads((ROOT / f"portbench/configs/{name}.json").read_text())["train"])
    if name == "cut_flagship":
        cfg["image_size"] = 32
        cfg["model"]["generator"]["ngf"] = 8
        cfg["model"]["discriminator"]["ndf"] = 8
        cfg["patchnce"]["num_patches"] = 16
    else:
        cfg["data"].update(img_size=32, load_size=36)
        cfg["model"].update(ngf=8, ndf=8)
    cfg.setdefault("runtime", {})["precision"] = "fp32"
    return cfg


def test_parameter_names_are_the_programs():
    from gan_variant_research_tpu_torch.core.precision import FP32_POLICY
    from gan_variant_research_tpu_torch.train.cut_trainer import build_discriminator, build_generator
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import build_cyclegan_generator
    from gan_variant_research_tpu_torch.models.discriminator_patchgan import PatchGANDiscriminator

    def shapes(module):
        return {k: tuple(v.shape) for k, v in module.state_dict().items()}

    spec = lambda s: {k: shape for k, shape, _ in s}  # noqa: E731
    cfg = _config("cut_flagship")
    assert spec(nets.generator_spec(8, 9, 2, True)) == shapes(
        build_generator(cfg["model"]["generator"], FP32_POLICY))
    assert spec(nets.patchgan_spec(8, 3, "none", "scale_0.")) == shapes(
        build_discriminator(cfg["model"]["discriminator"], FP32_POLICY))
    assert spec(nets.generator_spec(8, 9, 2, False)) == shapes(
        build_cyclegan_generator({"ngf": 8, "n_blocks": 9}, FP32_POLICY))
    assert spec(nets.patchgan_spec(8, 3, "instance")) == shapes(
        PatchGANDiscriminator(ndf=8, norm="instance"))


def test_params_from_one_draw_follow_the_fan_in():
    spec = nets.generator_spec(8, 2, 2, True)
    p = nets.make_params(spec, torch.Generator().manual_seed(1), "cpu")
    q = nets.make_params(spec, torch.Generator().manual_seed(1), "cpu")
    for name, shape, fan_in in spec:
        assert p[name].shape == shape and torch.equal(p[name], q[name])
        assert float(p[name].abs().max()) <= fan_in ** -0.5


# float32 on both sides, one step: the losses agree to float32 rounding.
# A weight gradient through an instance norm sums terms that cancel, so
# float32 alone moves it by up to ~0.5% of the leaf (the same reference
# call twice on inputs 1e-7 apart reads 0.43% at this size). The change
# after one Adam update is lr per element whatever the sign; D's R1 step
# adds a second update, whose size follows the ratio of two gradients
# (1.0e-3 read on one bias of D here).
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-2, "change_gap": 1e-2, "d_grad_diff": 1e-2}


def test_cut_step_matches_the_program():
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    from portbench.drivers.cut_train import LOSSES, program_draws

    cfg = _config("cut_flagship")
    w = D.cut_weights(SEED, cfg, "cpu")
    imgs = D.image_ring(SEED, "images", 1, 4, 32, "cpu")[0]
    trainer = CUTTrainer(cfg)
    state = trainer.state_from_state_dicts(w["g"], w["d"], 1, "cpu")
    cut = ref.CUT(cfg)
    st = cut.new_state(w["g"], w["d"])
    gen_p, gen_r = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    prog = {"losses": [], "grad": None}
    want = {"losses": [], "grad": None}
    for step in (0,):          # an R1 step
        d = D.cut_step(gen_p, cfg, 2)
        state, losses = trainer.train_step(state, imgs[:2], imgs[2:], step=step,
                                           draws=program_draws(d, torch.float32))
        prog["losses"].append({k: float(losses[k]) for k in LOSSES})
        want["losses"].append(cut.step(st, imgs[:2], imgs[2:], D.cut_step(gen_r, cfg, 2), step))
        if step == 0:
            prog["grad"] = M.first_grads({"g": state.opt_g.mu, "d": state.opt_d.mu}, 0.5)
            want["grad"] = M.first_grads({"g": st["opt_g"].mu, "d": st["opt_d"].mu}, 0.5)
            prog["d_grad"] = M.first_grad_tensors({"d": state.opt_d.mu}, 0.5)
            want["d_grad"] = M.first_grad_tensors({"d": st["opt_d"].mu}, 0.5)
    init = {"g": w["g"], "d": w["d"], "ema": w["g"]}
    prog["change"] = M.changes({"g": state.g_params, "d": state.d_params, "ema": state.ema}, init)
    want["change"] = M.changes({"g": st["g"], "d": st["d"], "ema": st["ema"]}, init)
    assert want["losses"][0]["r1"] > 0
    numbers = compare.train_numbers(prog, want)
    assert all(v <= LIMITS[k] for k, (v, _) in numbers.items()), numbers


@pytest.mark.parametrize("gan", ["lsgan", "bce"])
def test_cyclegan_step_matches_the_program(gan):
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

    from portbench.drivers.cyclegan_train import LOSSES, program_draws

    cfg = _config("cyclegan_resnet9")
    cfg["loss"]["gan"] = gan
    w = D.cyclegan_weights(SEED, cfg, "cpu")
    imgs = D.image_ring(SEED, "images", 1, 4, 36, "cpu")[0]
    trainer = CycleGANTrainer(cfg, steps_per_epoch=3)
    state = trainer.state_from_state_dicts(w, 1, "cpu")
    cg = ref.CycleGAN(cfg, 3)
    st = cg.new_state(w)
    d = D.cyclegan_step(torch.Generator().manual_seed(5), cfg, 2)
    state, losses = trainer.train_step(state, imgs[:2], imgs[2:], draws=program_draws(d))
    want_losses = cg.step(st, imgs[:2], imgs[2:], d)
    g_init = {f"{g}.{k}": v for g in ("G_A2B", "G_B2A") for k, v in w[g].items()}
    g_now = {f"{g}.{k}": v for g in ("G_A2B", "G_B2A") for k, v in st[g].items()}
    init = {"G": g_init, "D_A": w["D_A"], "D_B": w["D_B"]}
    prog = {"losses": [{k: float(losses[k]) for k in LOSSES}],
            "grad": M.first_grads({"G": state.opt_g.mu, "D_A": state.opt_da.mu,
                                   "D_B": state.opt_db.mu}, 0.5),
            "d_grad": M.first_grad_tensors({"D_A": state.opt_da.mu, "D_B": state.opt_db.mu}, 0.5),
            "change": M.changes({"G": state.g_params, "D_A": state.da_params,
                                 "D_B": state.db_params}, init)}
    want = {"losses": [want_losses],
            "grad": M.first_grads({"G": st["opt_g"].mu, "D_A": st["opt_da"].mu,
                                   "D_B": st["opt_db"].mu}, 0.5),
            "d_grad": M.first_grad_tensors({"D_A": st["opt_da"].mu, "D_B": st["opt_db"].mu}, 0.5),
            "change": M.changes({"G": g_now, "D_A": st["D_A"], "D_B": st["D_B"]}, init)}
    numbers = compare.train_numbers(prog, want)
    assert all(v <= LIMITS[k] for k, (v, _) in numbers.items()), numbers


def test_served_batch_matches_the_program():
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.core.precision import FP32_POLICY
    from gan_variant_research_tpu_torch.train.cut_trainer import build_generator

    cfg = _config("cut_flagship")
    spec = nets.generator_spec(8, 9, 2, True)
    w = nets.make_params(spec, torch.Generator().manual_seed(3), "cpu")
    net = build_generator(cfg["model"]["generator"], FP32_POLICY)
    net.load_state_dict(w)
    photos = D.image_ring(SEED, "images", 1, 3, 32, "cpu")[0]
    served = stylize_batch(net.eval(), photos, 32)
    want = ref.serve(w, photos)
    # float32 on both sides: a level apart only where the value sits on a
    # rounding edge
    assert (served.int() - want.int()).abs().max() <= 1
    assert compare.image_gap(served, want)[0] < 0.01


def test_fp8_control_rounds_operands_and_gradients():
    x = torch.tensor([1.0, 1.0625, 1.125, -448.0, 3.0])
    assert torch.equal(nets.FP8.operand(x), torch.tensor([1.0, 1.0, 1.125, -448.0, 3.0]))
    y = torch.randn(64, requires_grad=True)
    nets.FP8.operand(y).sum().backward()
    assert torch.equal(y.grad, torch.ones(64))     # straight through
    # the gradient into a conv in e5m2: two mantissa bits under the scale
    z = torch.ones(4, requires_grad=True)
    (nets.FP8.result(z) * torch.tensor([57344.0, 1.1 * 57344 / 4, 3.0, 5.0])).sum().backward()
    assert z.grad[0] == 57344.0 and z.grad[1] == 16384.0
