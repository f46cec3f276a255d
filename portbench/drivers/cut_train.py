"""Driver: ``CUTTrainer.train_step`` in a closed loop, as ``train_cut`` drives it.

Set-up builds one trainer and state on weights made from the seed, runs
the workload's ``checked_steps`` through ``train_step`` with the
benchmark's draws (what the reference follows), one more step on the
program's own draws, and hands that state to the window. The window runs
whole periods of ``period`` steps (one R1 step in each at ``r1.every``)
on a ring of ``ring`` distinct uint8 photo and Monet batches already on the
card, passes the step index, and reads each step's losses one step late
(``float`` of each, in sorted key order, as the loop does).
"""

from __future__ import annotations

import time

import torch

from portbench import compare
from portbench import draws as D
from portbench import measure as M
from portbench.reference import nets
from portbench.reference import steps as ref
from portbench.work import flops

LOSSES = ("d_loss", "g_loss", "nce", "identity", "r1")


def program_draws(d: dict, compute: torch.dtype):
    """The benchmark's draws as the program's ``StepDraws``."""
    from gan_variant_research_tpu_torch.core.prng import StepDraws
    from gan_variant_research_tpu_torch.data.augment import AugmentDraws
    from gan_variant_research_tpu_torch.ops.diffaugment import DiffAugmentDraws

    def da(ops, dtype):
        return DiffAugmentDraws(tuple(op for op, _ in ops), tuple(
            tuple(v.to(dtype) if v.is_floating_point() else v for v in vals) for _, vals in ops))

    return StepDraws(photo_aug=AugmentDraws(**d["photo_aug"]),
                     monet_aug=AugmentDraws(**d["monet_aug"]),
                     da_real=da(d["da_real"], torch.float32), da_fake=da(d["da_fake"], compute),
                     da_g=da(d["da_g"], compute), nce=list(d["nce"]))


def reference(cell: dict, seed: int, device, cast=nets.FP32, half: bool = False) -> dict:
    """The reference's losses, first gradients and changes over the checked
    steps, from the seed alone; with ``half``, on the first half of each
    batch (a fault the check must catch)."""
    wl, cfg = cell["workload"], cell["config"]["train"]
    b, start = wl["batch"], wl["start_step"]
    w = D.cut_weights(seed, cfg, device)
    images = D.image_ring(seed, "images", wl["ring"], 2 * b, cfg["image_size"], device)
    gen = D.generator(seed, "draws", device)
    cut = ref.CUT(cfg, cast)
    st = cut.new_state(w["g"], w["d"])
    n = b // 2 if half else b
    losses, grad = [], None
    for k in range(wl["checked_steps"]):
        d = D.cut_step(gen, cfg, b)
        imgs = images[k % wl["ring"]]
        losses.append(cut.step(st, imgs[:n], imgs[b:b + n], D.half(d, b) if half else d,
                               start + k))
        if k == 0:
            b1 = cfg["optim"]["G"]["betas"][0]
            grad = M.first_grads({"g": st["opt_g"].mu, "d": st["opt_d"].mu}, b1)
            d_grad = M.first_grad_tensors({"d": st["opt_d"].mu}, b1)
    change = M.changes({"g": st["g"], "d": st["d"], "ema": st["ema"]},
                       {"g": w["g"], "d": w["d"], "ema": w["g"]})
    return {"losses": losses, "grad": grad, "change": change, "d_grad": d_grad}


def checked(cell: dict, seed: int, device, marks: list | None = None):
    """Set-up's first part: the trainer and state on the seed's weights, the
    image ring, and the checked steps on the benchmark's draws. Returns
    (trainer, state, photos, monets, the program's numbers); ``marks``
    gets the times the build and the checked steps end."""
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    wl, cfg = cell["workload"], cell["config"]["train"]
    b, ring, start = wl["batch"], wl["ring"], wl["start_step"]
    trainer = CUTTrainer(cfg)
    w = D.cut_weights(seed, cfg, device)
    state = trainer.state_from_state_dicts(w["g"], w["d"], D.subseed(seed, "program"), device)
    images = D.image_ring(seed, "images", ring, 2 * b, cfg["image_size"], device)
    photos = [images[i, :b] for i in range(ring)]
    monets = [images[i, b:] for i in range(ring)]
    gen = D.generator(seed, "draws", device)
    if marks is not None:
        marks.append(("build", time.time()))
    losses_seen, grad = [], None
    for k in range(wl["checked_steps"]):
        draws = program_draws(D.cut_step(gen, cfg, b), trainer.policy.compute_dtype)
        state, losses = trainer.train_step(state, photos[k % ring], monets[k % ring],
                                           step=start + k, draws=draws)
        losses_seen.append({key: float(losses[key]) for key in LOSSES})
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
    out = M.measure(wl, seconds, trace, device, t_start, call,
                    flops_of=lambda i: flops.cut_step_flops(cfg, b, first + i),
                    trunk_of=lambda i: flops.trunk_calls(flops.cut_trunk_passes(cfg, b, first + i)),
                    marks=marks)
    while pending:
        drain()
    out["attempted"], out["failed"] = out["calls"], failed
    out["e2e"] = {"train_images_per_s": out["window"]["images"] / out["window"]["seconds"],
                  "train_step_p95_ms": out["window"]["p95_ms"],
                  "peak_mem_gib": out["peak_mem_gib"], "setup_s": out["setup_s"]}
    out["ctx"]["trunk_geom"] = (cfg["image_size"], cfg["model"]["generator"]["ngf"],
                                cfg["model"]["generator"]["n_downsampling"])
    del state, trainer, call, photos, monets, pending
    M.free_memory(device)
    M.full_precision()
    numbers = compare.train_numbers(prog, reference(cell, seed, device))
    out["checks"] = M.checks(numbers, wl["limits"])
    return out
