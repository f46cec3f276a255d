"""Driver: ``CUTTrainer.train_step`` on the variant generator in a closed loop.

As ``drivers/cut_train.py`` (whose draws it imports), on the variant's
inputs: the state is built on ``draws_variant.variant_weights``, each
checked step's draws carry the benchmark's style alphas (the three G
passes' ``StepDraws.style_*``), and the reference is
``reference/variant.py::CUTVariant``. The window and the late read of the
losses are ``cut_train``'s. ``ctx`` adds ``attn_calls``, the traced steps'
attention kernel calls from the configuration's shapes, beside
``trunk_calls`` and ``trunk_geom``, and ``attn_counts``, the program's
``attn.*`` launch counters after set-up; standard error gets those and
the traced stretch's attention and trunk launches a step.

``correct`` takes ``compare.train_numbers``' ``loss_gap``, ``change_gap``
and ``d_grad_diff`` of the checked steps, and a ``grad_gap`` of its own:
after the window, each of the program's variant blocks alone (the
generator's modules in its compute dtype, the attention through the
kernels) on ``draws_variant.block_inputs`` and the seed's weights, against
``reference/variant.py::block_grads``: the worst leaf of ``compare.diff_gap``
over every block parameter and input whose gradient is not nought to
rounding. The step's own first gradient of a variant leaf passes the whole
bf16 generator backward above it (18 and more instance norms), which moves
its direction by tens of percent whatever the blocks do; the blocks alone
are held to their own rounding.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from portbench import compare
from portbench import draws as D
from portbench import draws_variant as V
from portbench import measure as M
from portbench.drivers import cut_train
from portbench.harness import metric_reader
from portbench.readers_attention import ATTENTION, launches, launches_by_name
from portbench.reference import nets
from portbench.reference.variant import CUTVariant, block_grads, variant_blocks
from portbench.work import attention as A
from portbench.work import flops


def step_draws(gen: torch.Generator, style_gen: torch.Generator, cfg: dict, b: int) -> dict:
    """One step's draws: ``draws.cut_step``'s and ``style``, (3, n_blocks,
    b), from a stream of its own."""
    return {**D.cut_step(gen, cfg, b), "style": V.style_step(style_gen, cfg, b)}


def program_draws(d: dict, compute: torch.dtype):
    """The benchmark's draws as the program's ``StepDraws``."""
    fwd, nce, idt = d["style"]
    return dataclasses.replace(cut_train.program_draws(d, compute),
                               style_fwd=fwd, style_nce=nce, style_idt=idt)


def _generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    return D.generator(seed, "draws", device), D.generator(seed, "draws.style", device)


def reference(cell: dict, seed: int, device, cast=nets.FP32, half: bool = False,
              drop_attention: bool = False) -> dict:
    """The reference's losses, first gradients and changes over the checked
    steps, from the seed alone; with ``half``, on the first half of each
    batch, and with ``drop_attention`` without the attention blocks (faults
    the check must catch)."""
    wl, cfg = cell["workload"], cell["config"]["train"]
    b, start = wl["batch"], wl["start_step"]
    w = V.variant_weights(seed, cfg, device)
    blocks = block_grads(w["g"], cfg["model"]["generator"], *V.block_inputs(seed, cfg, b, device),
                         cast=cast, drop_attention=drop_attention)
    images = D.image_ring(seed, "images", wl["ring"], 2 * b, cfg["image_size"], device)
    gen, style_gen = _generators(seed, device)
    cut = CUTVariant(cfg, cast, drop_attention)
    st = cut.new_state(w["g"], w["d"])
    n = b // 2 if half else b
    losses, grad = [], None
    for k in range(wl["checked_steps"]):
        d = step_draws(gen, style_gen, cfg, b)
        if half:
            d = {**D.half(d, b), "style": d["style"][..., :n]}
        imgs = images[k % wl["ring"]]
        losses.append(cut.step(st, imgs[:n], imgs[b:b + n], d, start + k))
        if k == 0:
            b1 = cfg["optim"]["G"]["betas"][0]
            grad = M.first_grads({"g": st["opt_g"].mu, "d": st["opt_d"].mu}, b1)
            d_grad = M.first_grad_tensors({"d": st["opt_d"].mu}, b1)
    change = M.changes({"g": st["g"], "d": st["d"], "ema": st["ema"]},
                       {"g": w["g"], "d": w["d"], "ema": w["g"]})
    return {"losses": losses, "grad": grad, "change": change, "d_grad": d_grad,
            "blocks": blocks}


def program_blocks(trainer, cell: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``block_grads`` of the program: each variant block of
    ``trainer.generator`` through ``functional_call`` on the seed's
    weights, NHWC in the compute dtype."""
    from torch.func import functional_call

    cfg = cell["config"]["train"]
    w = V.variant_weights(seed, cfg, device)["g"]
    x, dy, style = V.block_inputs(seed, cfg, cell["workload"]["batch"], device)
    dtype = trainer.policy.compute_dtype

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous().to(dtype)

    out = {}
    for name, kind, i in variant_blocks(cfg["model"]["generator"]):
        prefix = name + "."
        leaves = {k[len(prefix):]: v.detach().clone().requires_grad_() for k, v in w.items()
                  if k.startswith(prefix)}
        xi = nhwc(x).requires_grad_()
        args = (xi, style[i]) if kind == "style" else (xi,)
        y = functional_call(getattr(trainer.generator, name), leaves, args)
        grads = torch.autograd.grad(y, [*leaves.values(), xi], grad_outputs=nhwc(dy),
                                    allow_unused=True)
        for k, g in zip(leaves, grads):
            out[prefix + k] = torch.zeros_like(leaves[k]) if g is None else g.float()
        out[prefix + "dx"] = grads[-1].float().permute(0, 3, 1, 2)
    return out


def numbers(prog: dict, ref: dict) -> dict[str, tuple[float, str]]:
    """``compare.train_numbers`` with ``grad_gap`` taken on the variant
    blocks alone (the module docstring says why)."""
    keep = compare.moved_leaves(compare.norms(ref["blocks"]))
    return {**compare.train_numbers(prog, ref),
            "grad_gap": compare.diff_gap(prog["blocks"], ref["blocks"], keep)}


def checked(cell: dict, seed: int, device, marks: list | None = None):
    """Set-up's first part, as ``cut_train.checked`` on the variant's
    weights and draws. Returns (trainer, state, photos, monets, the
    program's numbers)."""
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    wl, cfg = cell["workload"], cell["config"]["train"]
    b, ring, start = wl["batch"], wl["ring"], wl["start_step"]
    trainer = CUTTrainer(cfg)
    w = V.variant_weights(seed, cfg, device)
    state = trainer.state_from_state_dicts(w["g"], w["d"], D.subseed(seed, "program"), device)
    images = D.image_ring(seed, "images", ring, 2 * b, cfg["image_size"], device)
    photos = [images[i, :b] for i in range(ring)]
    monets = [images[i, b:] for i in range(ring)]
    gen, style_gen = _generators(seed, device)
    if marks is not None:
        marks.append(("build", time.time()))
    losses_seen, grad = [], None
    for k in range(wl["checked_steps"]):
        draws = program_draws(step_draws(gen, style_gen, cfg, b), trainer.policy.compute_dtype)
        state, losses = trainer.train_step(state, photos[k % ring], monets[k % ring],
                                           step=start + k, draws=draws)
        losses_seen.append({key: float(losses[key]) for key in cut_train.LOSSES})
        if k == 0:
            b1 = cfg["optim"]["G"]["betas"][0]
            grad = M.first_grads({"g": state.opt_g.mu, "d": state.opt_d.mu}, b1)
            d_grad = M.first_grad_tensors({"d": state.opt_d.mu}, b1)
    change = M.changes({"g": state.g_params, "d": state.d_params, "ema": state.ema},
                       {"g": w["g"], "d": w["d"], "ema": w["g"]})
    if marks is not None:
        marks.append(("checked steps", time.time()))
    return trainer, state, photos, monets, {"losses": losses_seen, "grad": grad,
                                            "change": change, "d_grad": d_grad}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from gan_variant_research_tpu_torch.core import trace as program_trace

    wl, cfg = cell["workload"], cell["config"]["train"]
    b, ring = wl["batch"], wl["ring"]
    marks = [("imports", time.time())]
    trainer, state, photos, monets, prog = checked(cell, seed, device, marks)
    first = wl["start_step"] + wl["checked_steps"]
    pending = []
    failed = 0

    def drain():
        nonlocal failed
        host = {k: float(v) for k, v in sorted(pending.pop(0).items())}
        failed += not all(abs(v) < float("inf") for v in host.values())

    def call(i):
        nonlocal state
        s = first + i
        state, step_losses = trainer.train_step(state, photos[s % ring], monets[s % ring], step=s)
        pending.append(step_losses)
        while len(pending) > 1:
            drain()

    # one step on the program's own draws, then the window from the next
    call(0)
    drain()
    first += 1
    counts = {k: v for k, v in sorted(program_trace.COUNTS.items()) if k.startswith("attn.")}
    print(f"set-up attention launches: {counts}", file=sys.stderr)
    out = M.measure(wl, seconds, trace, device, t_start, call,
                    flops_of=lambda i: (flops.cut_step_flops(cfg, b, first + i)
                                        + A.variant_step_flops(cfg, b, first + i)),
                    trunk_of=lambda i: flops.trunk_calls(flops.cut_trunk_passes(cfg, b, first + i)),
                    marks=marks)
    while pending:
        drain()
    out["attempted"], out["failed"] = out["calls"], failed
    out["e2e"] = {"train_images_per_s": out["window"]["images"] / out["window"]["seconds"],
                  "train_step_p95_ms": out["window"]["p95_ms"],
                  "peak_mem_gib": out["peak_mem_gib"], "setup_s": out["setup_s"]}
    ctx = out["ctx"]
    ctx["trunk_geom"] = (cfg["image_size"], cfg["model"]["generator"]["ngf"],
                         cfg["model"]["generator"]["n_downsampling"])
    ctx["attn_counts"] = counts
    if trace:
        traced = first + out["calls"]
        ctx["attn_calls"] = [c for i in range(wl["trace_calls"])
                             for c in A.attention_calls(cfg, b, traced + i)]
        trunk = metric_reader(cell, "trunk_roofline.train").KERNELS
        print(f"traced launches a step: attention {launches(ctx, ATTENTION)}, "
              f"trunk {launches_by_name(ctx, trunk)}", file=sys.stderr)
    prog["blocks"] = program_blocks(trainer, cell, seed, device)
    del state, trainer, call, photos, monets, pending
    M.free_memory(device)
    M.full_precision()
    out["checks"] = M.checks(numbers(prog, reference(cell, seed, device)), wl["limits"])
    return out
