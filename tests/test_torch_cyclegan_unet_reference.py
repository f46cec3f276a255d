"""The U-Net CycleGAN against the benchmark's plain reference
(``portbench/reference/unet.py``), the reference against the JAX U-Net,
the cell's configuration, its FLOPs, and the U-Net's spans.

Float32 on the CPU at ngf 8, 64^2 (72^2 loads) and batch 2, on
``portbench/draws_unet.py``'s weights: the conv biases, gamma and beta are
drawn away from the program's init (0, 1, 0), so that the affine and the
output conv's bias are on the path.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from gan_variant_research_tpu.models import generator_unet as jax_unet
from gan_variant_research_tpu_torch.convert import (
    jax_tree_from_state_dict,
    unet_state_dict_from_jax,
)
from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.core.config import load_config, override_config
from gan_variant_research_tpu_torch.models.generator_unet import N_NORMS, UNetGenerator
from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from portbench import compare
from portbench import draws as D
from portbench import draws_unet as U
from portbench import measure as M
from portbench.drivers.cyclegan_unet_train import LOSSES, NETS, program_draws
from portbench.reference import unet as ref
from portbench.work import unet as work

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 11
B, S, LOAD, NGF = 2, 64, 72, 8
# the biases ahead of a norm, which cancel in it: 11 convs and 4 transposed convs
CANCELLED = ({f"_SameConv_{i}.Conv_0.bias" for i in range(11)}
             | {f"ConvTranspose_{i}.bias" for i in range(4)})


def _config() -> dict:
    cfg = copy.deepcopy(json.loads((ROOT / "portbench/configs/cyclegan_unet.json").read_text())
                        ["train"])
    cfg["data"].update(img_size=S, load_size=LOAD)
    cfg["model"].update(ngf=NGF, ndf=NGF)
    cfg["runtime"]["precision"] = "fp32"
    return cfg


def _weights() -> dict:
    return U.cyclegan_unet_weights(SEED, _config(), "cpu")


def _inputs() -> tuple[torch.Tensor, torch.Tensor]:
    """NCHW images in [-1, 1] and a cotangent, (B, 3, S, S)."""
    gen = torch.Generator().manual_seed(3)
    return (torch.rand((B, 3, S, S), generator=gen) * 2 - 1,
            torch.randn((B, 3, S, S), generator=gen))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread: at these sizes an op is microseconds of work,
    and where other test processes share the cores, a thread pool in each
    makes a train step ~40x slower (0.3 s alone, 13 s beside them). One
    thread also keeps the float32 readings below independent of the
    machine's core count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def test_parameter_names_are_the_programs():
    spec = {name: shape for name, shape, _ in U.unet_spec(NGF)}
    assert spec == {k: tuple(v.shape) for k, v in UNetGenerator(ngf=NGF).state_dict().items()}
    w = _weights()["G_A2B"]
    for name, _, (lo, hi) in U.unet_spec(NGF):
        assert lo <= float(w[name].min()) and float(w[name].max()) <= hi, name
    gammas = torch.cat([w[f"AffineInstanceNorm_{i}.gamma"] for i in range(N_NORMS)])
    assert float((gammas - 1).abs().mean()) > 0.2      # off identity


# float32 on both sides: the program's NHWC convs, its transposed conv
# (``conv_transpose2d`` on the flipped kernel, sliced) and its norm round
# differently from the reference's NCHW convs, dilated correlation and
# norm; through 16 convs and 15 norms that reads 4.6e-6 of the largest
# value forward and 2.4e-6 of a leaf's gradient norm. 1e-4 leaves 20x.
FORWARD_TOL = 1e-4


def test_generator_matches_the_reference():
    w = _weights()["G_A2B"]
    x, r = _inputs()
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    out = functional_call(UNetGenerator(ngf=NGF), params, (x.permute(0, 2, 3, 1),))
    want = ref.generator(leaves, x)
    got = out.permute(0, 3, 1, 2)
    gap, top = (got - want).detach().abs().max(), want.detach().abs().max()
    assert float(gap) <= FORWARD_TOL * float(top)
    grads = torch.autograd.grad((got * r).sum(), list(params.values()))
    exp = torch.autograd.grad((want * r).sum(), list(leaves.values()))
    norms = {k: float(e.norm()) for k, e in zip(leaves, exp)}
    # every leaf but the cancelled biases moves, the output bias and the
    # affines included
    assert set(leaves) - compare.moved_leaves(norms) == CANCELLED
    for k, a, e in zip(leaves, grads, exp):
        if k not in CANCELLED:
            assert float((a - e).norm()) <= FORWARD_TOL * norms[k], k


def test_reference_matches_the_jax_unet():
    """The reference on the flax U-Net's own parameters (``convert.py``'s
    tree of the draws): value and every moved leaf's gradient, which holds
    the reference's transposed conv (the flax kernel, un-flipped) against
    ``lax.conv_transpose``."""
    w = _weights()["G_B2A"]
    x, r = _inputs()
    tree = jax.tree_util.tree_map(lambda t: t.numpy(), jax_tree_from_state_dict(w))
    x_nhwc, r_nhwc = (t.permute(0, 2, 3, 1).numpy() for t in (x, r))
    net = jax_unet.UNetGenerator(ngf=NGF)
    want = np.array(net.apply({"params": tree}, x_nhwc)).transpose(0, 3, 1, 2)
    jax_grads = unet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: (net.apply({"params": p}, x_nhwc) * r_nhwc).sum())(tree)))
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    got = ref.generator(leaves, x)
    assert float((got.detach() - torch.from_numpy(want)).abs().max()) <= (
        FORWARD_TOL * float(np.abs(want).max()))
    grads = dict(zip(leaves, torch.autograd.grad((got * r).sum(), list(leaves.values()))))
    for k, g in grads.items():
        if k not in CANCELLED:
            e = jax_grads[k]
            assert float((g - e).norm()) <= FORWARD_TOL * float(e.norm()), k


def _step_numbers(gan: str) -> tuple[dict, dict]:
    """Three steps of ``CycleGANTrainer.train_step`` on the U-Net and of
    the reference step on the same weights, images and draws: (program,
    reference) numbers as ``compare.train_numbers`` reads them."""
    cfg = _config()
    cfg["loss"]["gan"] = gan
    w = _weights()
    imgs = D.image_ring(SEED, "images", 3, 2 * B, LOAD, "cpu", 4)
    trainer = CycleGANTrainer(cfg, steps_per_epoch=3)
    state = trainer.state_from_state_dicts(w, 1, "cpu")
    cg = ref.CycleGANUNet(cfg, 3)
    st = cg.new_state(w)
    gen_p, gen_r = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    prog, want = {"losses": []}, {"losses": []}
    for k in range(3):
        im = imgs[k]
        state, losses = trainer.train_step(state, im[:B], im[B:],
                                           draws=program_draws(D.cyclegan_step(gen_p, cfg, B)))
        prog["losses"].append({key: float(losses[key]) for key in LOSSES})
        want["losses"].append(cg.step(st, im[:B], im[B:], D.cyclegan_step(gen_r, cfg, B)))
        if k == 0:
            for out, opts in ((prog, (state.opt_g, state.opt_da, state.opt_db)),
                              (want, (st["opt_g"], st["opt_da"], st["opt_db"]))):
                mus = dict(zip(("G", "D_A", "D_B"), (o.mu for o in opts)))
                out["grad"] = M.first_grads(mus, 0.5)
                out["d_grad"] = M.first_grad_tensors({k: mus[k] for k in ("D_A", "D_B")}, 0.5)
    g_init = {f"{g}.{k}": v for g in NETS for k, v in w[g].items()}
    init = {"G": g_init, "D_A": w["D_A"], "D_B": w["D_B"]}
    prog["change"] = M.changes({"G": state.g_params, "D_A": state.da_params,
                                "D_B": state.db_params}, init)
    want["change"] = M.changes({"G": {f"{g}.{k}": v for g in NETS for k, v in st[g].items()},
                                "D_A": st["D_A"], "D_B": st["D_B"]}, init)
    return prog, want


# float32 on both sides, the cell's numbers. The first step's losses agree
# to float32 rounding (2.1e-7 read). G's first gradient passes up to 16
# convs and 15 norms whose projections cancel most of it: 4.1e-3 (LSGAN)
# and 4.9e-3 (BCE) of a leaf here. D's gradient passes no U-Net (its
# inputs are detached): 1.9e-6. The change over 3 steps is ill-conditioned
# at this size in the small affine leaves (8 elements at ngf 8): after
# Adam's first update, +-lr per element whatever the gradient's size, the
# second and third follow ratios of gradients that nearly cancel, so the
# reference against itself on weights 1e-7 apart already reads 0.10-0.11
# after 3 steps (0.067 after 2, 7e-5 after 1); the program reads 0.10
# (LSGAN) and 0.19 (BCE) here, 0.06-0.13 at three other seeds. The limit
# 0.3 still fails an unchanged state (1).
STEP_LIMITS = {"loss_gap": 1e-5, "grad_gap": 2e-2, "change_gap": 0.3, "d_grad_diff": 1e-4}


@pytest.mark.parametrize("gan", ["lsgan", "bce"])
def test_unet_step_matches_the_reference(gan):
    prog, want = _step_numbers(gan)
    numbers = compare.train_numbers(prog, want)
    assert set(numbers) == set(json.loads(
        (ROOT / "portbench/workloads/cyclegan_unet.train_b16.json").read_text())["limits"])
    assert all(v <= STEP_LIMITS[k] for k, (v, _) in numbers.items()), numbers
    # the affines and the output bias are among the leaves compared
    keep = compare.moved_leaves(want["grad"]["G"])
    assert {"G_A2B.AffineInstanceNorm_0.gamma", "G_B2A.AffineInstanceNorm_14.beta",
            "G_A2B._SameConv_11.Conv_0.bias"} <= keep
    assert not {f"{g}.{b}" for g in NETS for b in CANCELLED} & keep


def test_config_is_baseline_tpu_with_the_unet():
    """``train`` is ``baseline_tpu.yaml`` as parsed, with the generator as
    ``--set model.generator=unet`` sets it; nothing reduced."""
    config = json.loads((ROOT / "portbench/configs/cyclegan_unet.json").read_text())
    yaml_cfg = load_config(ROOT / "gan_variant_research_tpu_torch/configs/baseline_tpu.yaml")
    assert config["train"] == override_config(yaml_cfg, ["model.generator=unet"])
    assert config["reduced"] == []
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "cyclegan_unet")
    assert entry["source"] == config["source"] and len(entry["source"]) <= 200


def test_flops_follow_the_modules():
    """``work/unet.py``'s FLOPs a layer equal 2 x the MACs of the port's
    convs (each output pixel through the kernel) and transposed convs (each
    input pixel), counted by hooks in the order the layers run."""
    from gan_variant_research_tpu_torch.models.generator_unet import _SameConvTranspose
    from gan_variant_research_tpu_torch.models.layers import Conv2d

    net = UNetGenerator(ngf=NGF)
    flops = []

    def hook(module, inputs, out):
        pixels = (inputs[0] if isinstance(module, _SameConvTranspose) else out).shape[:3]
        flops.append(2.0 * pixels.numel() * module.weight.numel())

    for module in net.modules():
        if isinstance(module, (Conv2d, _SameConvTranspose)):
            module.register_forward_hook(hook)
    net(torch.zeros((1, S, S, 3)))
    assert flops == work.unet_layer_flops(S, NGF)
    assert work.unet_fwd_flops(256) == pytest.approx(60.448e9, rel=1e-4)


def test_unet_step_spans():
    """One step with spans on: 45 affine norms (15 an apply, 3 applies),
    each level once an apply inside ``cyclegan.g_loss``, each ``unet.norm``
    inside a level."""
    cfg = _config()
    trainer = CycleGANTrainer(cfg, steps_per_epoch=3)
    state = trainer.state_from_state_dicts(_weights(), 1, "cpu")
    imgs = D.image_ring(SEED, "images", 1, 2 * B, LOAD, "cpu", 4)[0]
    assert trace.span("unet.norm") is trace.span("unet.encoder")    # off: the shared no-op
    before = trace.COUNTS.get("unet.norm", 0)
    trace.enable()
    try:
        trainer.train_step(state, imgs[:B], imgs[B:])
    finally:
        trace.disable()
    assert trace.COUNTS["unet.norm"] - before == 45
    spans = trace.take()
    by_id = {s.id: s for s in spans}
    parents = {}
    for s in spans:
        parents.setdefault(s.name, []).append(by_id[s.parent].name if s.parent else None)
    for level in ("unet.encoder", "unet.bottleneck", "unet.decoder"):
        assert parents[level] == ["cyclegan.g_loss"] * 3, level
    assert len(parents["unet.norm"]) == 45
    assert (parents["unet.norm"].count("unet.encoder"), parents["unet.norm"].count(
        "unet.bottleneck"), parents["unet.norm"].count("unet.decoder")) == (15, 6, 24)
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
