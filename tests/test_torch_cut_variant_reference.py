"""The variant generator and its CUT step against the benchmark's plain
reference (``portbench/reference/variant.py``), and the variant's spans.

Float32 on the CPU at ngf 8, 32^2 and batch 2, all nine blocks, with
attention after blocks 3 and 7, the channel gate after 5 and a style gate
after each block, as ``portbench/configs/cut_variant.json`` places them.
Weights come from ``portbench/draws_variant.py``: attention gamma, fc2
and the style gates' gamma and beta away from their identity init, so
that every variant block is on the path (at init a check passes with the
attention deleted).
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch
from torch.func import functional_call

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.core.precision import FP32_POLICY
from gan_variant_research_tpu_torch.train.cut_trainer import (
    CUTTrainer,
    build_generator,
    param_leaves,
)
from portbench import compare
from portbench import draws as D
from portbench import draws_variant as V
from portbench import measure as M
from portbench.drivers import cut_variant_train as drv
from portbench.reference import variant as ref

ROOT = Path(__file__).resolve().parents[1]
# a seed at which the channel gate's two hidden units (C / 16 at ngf 8) are
# not both dead under the ReLU, in every configuration below: at ngf 8 a
# quarter of the draws leave fc1 and fc2's weight without a gradient (2 of
# the 8 seeds from 2^33 + 17 did); the cells' 16 units are not at risk
SEED = 2 ** 33 + 18
B, S = 2, 32
TAPS = (0, 4, 8, 12)
BLOCKS = {"attention": ("use_attention",), "channel": ("use_channel_attn",),
          "style": ("use_style_dropout",),
          "all": ("use_attention", "use_channel_attn", "use_style_dropout")}


def _config(on=BLOCKS["all"]) -> dict:
    config = json.loads((ROOT / "portbench/configs/cut_variant.json").read_text())
    cfg = copy.deepcopy(config["train"])
    cfg["image_size"] = S
    cfg["model"]["generator"]["ngf"] = 8
    cfg["model"]["discriminator"]["ndf"] = 8
    cfg["patchnce"]["num_patches"] = 16
    cfg["runtime"]["precision"] = "fp32"
    for key in ("use_attention", "use_channel_attn", "use_style_dropout"):
        cfg["model"]["generator"][key] = key in on
    return cfg


def _images():
    return D.image_ring(SEED, "images", 1, 2 * B, S, "cpu")[0]


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


# float32 on both sides: the program's instance norm (E[x^2] - mean^2) and
# NHWC convs round differently from the reference's two-pass variance and
# NCHW convs; through the nine blocks and both gates that reads ~4e-6 of
# the largest value forward and ~7e-6 of a leaf's gradient norm. 1e-4
# leaves 15x.
FORWARD_TOL = 1e-4


@pytest.mark.parametrize("blocks", list(BLOCKS))
def test_generator_matches_the_reference(blocks):
    cfg = _config(BLOCKS[blocks])
    g_cfg = cfg["model"]["generator"]
    w = V.variant_weights(SEED, cfg, "cpu")["g"]
    spec = {name for name, _, _ in V.variant_spec(g_cfg)}
    assert spec and all(any(k.startswith(p) for p in ("attn_", "channel_attn_", "style_gate_"))
                        for k in spec)
    net = build_generator(g_cfg, FP32_POLICY)
    params = param_leaves(net, w, "cpu")
    x = _images()[:B].permute(0, 3, 1, 2).float() / 127.5 - 1.0
    alpha = V.style_step(torch.Generator().manual_seed(3), cfg, B)[0]
    out, feats = functional_call(net, params, (x.permute(0, 2, 3, 1),),
                                 {"extract": TAPS, "style_alpha": alpha})
    leaves = {k: v.detach().clone().requires_grad_() for k, v in w.items()}
    want, want_feats = ref.generator(leaves, x, g_cfg, alpha, taps=TAPS)
    for got, exp in zip([out] + feats, [want] + want_feats):
        got, exp = got.detach().permute(0, 3, 1, 2), exp.detach()
        assert float((got - exp).abs().max()) <= FORWARD_TOL * float(exp.abs().max())
    # gradients of one loss over every output, leaf by leaf; leaves whose
    # gradient is nought to rounding (a bias before an instance norm, the
    # key's bias under the softmax) are left out
    loss = lambda o, fs: o.square().mean() + sum(f.square().mean() for f in fs)  # noqa: E731
    got = torch.autograd.grad(loss(out, feats), list(params.values()))
    exp = torch.autograd.grad(loss(want, want_feats), list(leaves.values()))
    norms = {k: float(e.norm()) for k, e in zip(leaves, exp)}
    keep = compare.moved_leaves(norms)
    assert spec & keep == spec - {k for k in spec if k.endswith("key.bias")}, spec - keep
    for k, a, e in zip(leaves, got, exp):
        if k in keep:
            assert float((a - e).norm()) <= FORWARD_TOL * norms[k], k


def _step_numbers(cut_ref) -> tuple[dict, dict]:
    """One step (0: R1 and the identity warmup) of the program and of
    ``cut_ref`` on the same weights, images and draws: (program, reference)
    numbers as ``compare.train_numbers`` reads them."""
    cfg = cut_ref.cfg
    w = V.variant_weights(SEED, cfg, "cpu")
    imgs = _images()
    trainer = CUTTrainer(cfg)
    state = trainer.state_from_state_dicts(w["g"], w["d"], 1, "cpu")
    st = cut_ref.new_state(w["g"], w["d"])
    d = drv.step_draws(torch.Generator().manual_seed(5), torch.Generator().manual_seed(6), cfg, B)
    state, losses = trainer.train_step(state, imgs[:B], imgs[B:], step=0,
                                       draws=drv.program_draws(d, torch.float32))
    want = cut_ref.step(st, imgs[:B], imgs[B:], d, 0)
    assert want["r1"] > 0 and want["identity"] > 0
    init = {"g": w["g"], "d": w["d"], "ema": w["g"]}
    prog = {"losses": [{k: float(losses[k]) for k in want}],
            "grad": M.first_grads({"g": state.opt_g.mu, "d": state.opt_d.mu}, 0.5),
            "d_grad": M.first_grad_tensors({"d": state.opt_d.mu}, 0.5),
            "change": M.changes({"g": state.g_params, "d": state.d_params, "ema": state.ema},
                                init)}
    truth = {"losses": [want],
             "grad": M.first_grads({"g": st["opt_g"].mu, "d": st["opt_d"].mu}, 0.5),
             "d_grad": M.first_grad_tensors({"d": st["opt_d"].mu}, 0.5),
             "change": M.changes({"g": st["g"], "d": st["d"], "ema": st["ema"]}, init)}
    return prog, truth


# One float32 step on both sides. The losses agree to float32 rounding
# through the nets (8e-7 read here). The generator's inputs already differ
# by ~6e-6 (the two ``train_augment``s round differently), and the step's
# G gradient can be ill-conditioned in its small leaves (the attention
# gammas, the q biases, the gates' parameters: sums that cancel, through
# ReLU kinks and a softmax): here grad_gap reads 3.6e-5, but at seed
# 2^31 + 77 of the same size the program reads 2.0e-2 and the reference
# against itself on weights 5e-6 apart (relative) 1.1e-2. The change after
# one Adam update is +-lr per element whatever the sign (1.7e-4 read); D's
# gradient passes no variant block (its inputs are detached; 1.4e-6 read).
# The reference without its attention reads 0.053, 0.61, 0.072 and 0.086.
STEP_LIMITS = {"loss_gap": 1e-4, "grad_gap": 6e-2, "change_gap": 6e-2, "d_grad_diff": 1e-3}


def test_variant_step_matches_the_reference():
    prog, truth = _step_numbers(ref.CUTVariant(_config()))
    numbers = compare.train_numbers(prog, truth)
    assert all(v <= STEP_LIMITS[k] for k, (v, _) in numbers.items()), numbers
    # the variant's leaves are among those compared
    keep = compare.moved_leaves(truth["grad"]["g"])
    assert {"attn_3.gamma", "attn_7.gamma", "attn_7.value.weight", "channel_attn_5.fc2.weight",
            "style_gate_4.gamma", "style_gate_8.beta"} <= keep


def test_the_reference_without_attention_misses_the_program():
    """The check cannot pass with the attention missing: the reference with
    its attention blocks dropped misses the program by more than the
    step's limits."""
    prog, truth = _step_numbers(ref.CUTVariant(_config(), drop_attention=True))
    numbers = compare.train_numbers(prog, truth)
    missed = {k: v for k, (v, _) in numbers.items() if v > STEP_LIMITS[k]}
    assert missed.get("loss_gap", 0) > 10 * STEP_LIMITS["loss_gap"], numbers
    assert missed.get("grad_gap", 0) > 3 * STEP_LIMITS["grad_gap"], numbers


def test_variant_step_spans():
    """One eager variant step with spans on: each G pass runs the two
    attention blocks, the channel gate and nine style gates, each block's
    forward kernel wrapper inside its block span, and each backward wrapper
    in the phase that takes the gradient: 4 passes' worth under the photo
    forward and the taps-only forward (``cut.g_forward``), whose backward
    runs in ``cut.g_head``, and 2 in ``cut.identity``."""
    cfg = _config()
    trainer = CUTTrainer(cfg)
    w = V.variant_weights(SEED, cfg, "cpu")
    state = trainer.state_from_state_dicts(w["g"], w["d"], 1, "cpu")
    imgs = _images()
    assert trace.span("variant.attn") is trace.span("attn.dq")     # off: the shared no-op
    trace.enable()
    try:
        trainer.train_step(state, imgs[:B], imgs[B:], step=0)
    finally:
        trace.disable()
    spans = trace.take()
    by_id = {s.id: s for s in spans}
    parents = {}
    for s in spans:
        parents.setdefault(s.name, []).append(by_id[s.parent].name if s.parent else None)
    count = lambda name: len(parents.get(name, []))  # noqa: E731
    assert (count("variant.attn"), count("variant.channel"), count("variant.style")) == (6, 3, 27)
    assert (count("attn.fwd"), count("attn.dkv"), count("attn.dq")) == (6, 6, 6)
    assert sorted(parents["attn.fwd"]) == ["variant.attn"] * 6
    for name in ("variant.attn", "variant.channel", "variant.style"):
        phases = parents[name]
        assert phases.count("cut.g_forward") == 2 * phases.count("cut.identity"), (name, phases)
        assert set(phases) == {"cut.g_forward", "cut.identity"}
    for name in ("attn.dkv", "attn.dq"):
        assert sorted(parents[name]) == ["cut.g_head"] * 4 + ["cut.identity"] * 2
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
