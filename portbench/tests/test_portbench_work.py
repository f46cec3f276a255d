"""The benchmark's work arithmetic: pinned numbers, and the trunk conv calls
it counts against the calls the program makes in a step (on the CPU, at a
small size)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from portbench import draws as D
from portbench.work import flops

ROOT = Path(__file__).resolve().parents[2]
CUT = json.loads((ROOT / "portbench/configs/cut_flagship.json").read_text())["train"]
CYCLEGAN = json.loads((ROOT / "portbench/configs/cyclegan_resnet9.json").read_text())["train"]


def test_generator_and_discriminator_forward():
    assert flops.generator_fwd_flops(256) / 1e9 == pytest.approx(99.1, abs=0.05)
    assert flops.discriminator_fwd_flops(256) / 1e9 == pytest.approx(6.29, abs=0.01)
    # the taps-only pass stops after up_0 (tap 12; tap 16 does not exist)
    taps = flops.generator_taps_fwd_flops(256, [0, 4, 8, 12, 16])
    assert flops.generator_fwd_flops(256) - taps == pytest.approx(
        flops.conv_flops(256, 256, 64, 3, 7) + 2.0 * 128 * 128 * 128 * 64 * 9)


def test_trunk_numbers_of_perf_md():
    """58.0 GFLOP a trunk call at batch 12; 2.783 of a batch-32 forward's
    3.171 TFLOP."""
    f, nbytes = flops.trunk_conv_work(12, 64, 64, 256, "fwd")
    assert f / 1e9 == pytest.approx(58.0, abs=0.05)
    assert nbytes == 2 * 12 * 64 * 64 * 256 * 2 + 9 * 256 * 256 * 2 + 256 * 4
    assert flops.serve_batch_flops(CUT, 32) / 1e12 == pytest.approx(3.171, abs=0.001)
    trunk = 18 * flops.trunk_conv_work(32, 64, 64, 256, "fwd")[0]
    assert trunk / 1e12 == pytest.approx(2.783, abs=0.001)
    # operation-bound: 58.0 GFLOP / 989 TFLOP/s
    assert flops.bound_s(*flops.trunk_conv_work(12, 64, 64, 256, "dx")) * 1e3 == pytest.approx(
        0.0586, abs=1e-4)


def test_cut_step_pass_accounting():
    g, d = flops.generator_fwd_flops(256), flops.discriminator_fwd_flops(256)
    taps = flops.generator_taps_fwd_flops(256, CUT["patchnce"]["nce_layers"])
    warm = flops.cut_step_flops(CUT, 12, 1)
    assert warm == pytest.approx(12 * (3 * (2 * g + taps) + 8 * d))
    assert flops.cut_step_flops(CUT, 12, 16) - warm == pytest.approx(12 * 6 * d)
    assert flops.cut_step_flops(CUT, 12, 20001) == pytest.approx(12 * (3 * (g + taps) + 8 * d))
    period = sum(flops.cut_step_flops(CUT, 12, s) for s in range(16)) / 16
    assert period / 1e12 == pytest.approx(11.20, abs=0.01)


def test_cyclegan_step():
    assert flops.cyclegan_step_flops(CYCLEGAN, 16) / 1e12 == pytest.approx(30.15, abs=0.01)
    assert flops.cyclegan_trunk_passes(CYCLEGAN, 16) == [(32, 9), (48, 9), (16, 9)]


# --------------------------------------------------------------------------- #
# the counted trunk calls against the program's own, on the CPU

def _tiny_cut():
    cfg = copy.deepcopy(CUT)
    cfg.update(image_size=32)
    cfg["model"]["generator"].update(ngf=8, n_blocks=3)
    cfg["model"]["discriminator"]["ndf"] = 8
    cfg["patchnce"]["num_patches"] = 16
    cfg["runtime"]["precision"] = "fp32"
    return cfg


@pytest.fixture
def trunk_calls(monkeypatch):
    """(batch, kind) of every trunk conv call the program makes."""
    from gan_variant_research_tpu_torch.ops.kernels import resblock as rb

    calls = []

    def counted(kind, fn, batch_arg):
        def wrapper(*a, **kw):
            calls.append((a[batch_arg].shape[0], kind))
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(rb, "reflect_conv3x3_reference", counted("fwd", rb.reflect_conv3x3_reference, 0))
    monkeypatch.setattr(rb, "reflect_conv3x3_dx", counted("dx", rb.reflect_conv3x3_dx, 0))
    monkeypatch.setattr(rb, "reflect_conv3x3_dw", counted("dw", rb.reflect_conv3x3_dw, 0))
    return calls


@pytest.mark.parametrize("step", [0, 1, 20000])
def test_cut_trunk_calls_match_the_program(trunk_calls, step):
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    cfg = _tiny_cut()
    trainer = CUTTrainer(cfg)
    w = D.cut_weights(7, cfg, "cpu")
    state = trainer.state_from_state_dicts(w["g"], w["d"], 7, "cpu")
    imgs = D.image_ring(7, "images", 1, 4, 32, "cpu")[0]
    trainer.train_step(state, imgs[:2], imgs[2:], step=step)
    want = flops.trunk_calls(flops.cut_trunk_passes(cfg, 2, step))
    assert sorted(trunk_calls) == sorted(want)


def test_cyclegan_and_serve_trunk_calls_match_the_program(trunk_calls):
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.train.cut_trainer import build_generator
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
    from gan_variant_research_tpu_torch.core.precision import FP32_POLICY

    cfg = copy.deepcopy(CYCLEGAN)
    cfg["data"].update(img_size=32, load_size=36)
    cfg["model"].update(ngf=8, ndf=8, n_blocks=6)
    cfg["runtime"]["precision"] = "fp32"
    trainer = CycleGANTrainer(cfg)
    state = trainer.state_from_state_dicts(D.cyclegan_weights(3, cfg, "cpu"), 3, "cpu")
    imgs = D.image_ring(3, "images", 1, 4, 36, "cpu")[0]
    trainer.train_step(state, imgs[:2], imgs[2:])
    assert sorted(trunk_calls) == sorted(flops.trunk_calls(flops.cyclegan_trunk_passes(cfg, 2)))

    trunk_calls.clear()
    cut = _tiny_cut()
    net = build_generator(cut["model"]["generator"], FP32_POLICY).eval()
    stylize_batch(net, torch.zeros((5, 32, 32, 3), dtype=torch.uint8), 32)
    assert trunk_calls == flops.trunk_calls([(5, 3)], kinds=("fwd",))
