"""Driver: ``CycleGANTrainer.train_step`` in a closed loop, as
``train_cyclegan`` drives it within an epoch.

Set-up builds one trainer (``steps_per_epoch`` as the loop sets it for the
workload's dataset sizes) and state on weights made from the seed, runs the
``checked_steps`` with the benchmark's crop and flip draws (what the
reference follows), one more step on the program's own draws, and hands
that state to the window. The window steps on a ring of ``ring`` distinct
uint8 A and B batches at the load size, already on the card, and sums the
losses on the card without reading them, as the loop does until an
epoch's end; the sums are read once the window has closed.
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

LOSSES = ("G", "D_A", "D_B")


def program_draws(d: dict):
    from gan_variant_research_tpu_torch.core.prng import CycleGANDraws
    from gan_variant_research_tpu_torch.data.augment import CropFlipDraws

    return CycleGANDraws(aug_a=CropFlipDraws(**d["aug_a"]), aug_b=CropFlipDraws(**d["aug_b"]))


def steps_per_epoch(wl: dict) -> int:
    """``max(|A|, |B|) // batch``, the loop's epoch length."""
    return max(wl["dataset_a"], wl["dataset_b"]) // wl["batch"]


def reference(cell: dict, seed: int, device, cast=nets.FP32, half: bool = False) -> dict:
    """The reference's losses, first gradients and changes over the checked
    steps, from the seed alone; with ``half``, on the first half of each
    batch."""
    wl, cfg = cell["workload"], cell["config"]["train"]
    b = wl["batch"]
    w = D.cyclegan_weights(seed, cfg, device)
    images = D.image_ring(seed, "images", wl["ring"], 2 * b, cfg["data"]["load_size"], device,
                          wl.get("smooth", 0))
    gen = D.generator(seed, "draws", device)
    cg = ref.CycleGAN(cfg, steps_per_epoch(wl), cast)
    st = cg.new_state(w)
    n = max(b // 2, 1) if half else b
    losses, grad = [], None
    for k in range(wl["checked_steps"]):
        d = D.cyclegan_step(gen, cfg, b)
        imgs = images[k % wl["ring"]]
        losses.append(cg.step(st, imgs[:n], imgs[b:b + n], D.half(d, b) if half else d))
        if k == 0:
            b1 = cfg["optim"]["betas"][0]
            grad = M.first_grads({"G": st["opt_g"].mu, "D_A": st["opt_da"].mu,
                                  "D_B": st["opt_db"].mu}, b1)
            d_grad = M.first_grad_tensors({"D_A": st["opt_da"].mu, "D_B": st["opt_db"].mu}, b1)
    g_now = {f"{g}.{k}": v for g in ("G_A2B", "G_B2A") for k, v in st[g].items()}
    g_init = {f"{g}.{k}": v for g in ("G_A2B", "G_B2A") for k, v in w[g].items()}
    change = M.changes({"G": g_now, "D_A": st["D_A"], "D_B": st["D_B"]},
                       {"G": g_init, "D_A": w["D_A"], "D_B": w["D_B"]})
    return {"losses": losses, "grad": grad, "change": change, "d_grad": d_grad}


def checked(cell: dict, seed: int, device, marks: list | None = None):
    """Set-up's first part: the trainer and state on the seed's weights, the
    image ring, and the checked steps on the benchmark's draws. Returns
    (trainer, state, A batches, B batches, the program's numbers);
    ``marks`` gets the times the build and the checked steps end."""
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

    wl, cfg = cell["workload"], cell["config"]["train"]
    b, ring = wl["batch"], wl["ring"]
    trainer = CycleGANTrainer(cfg, steps_per_epoch=steps_per_epoch(wl))
    w = D.cyclegan_weights(seed, cfg, device)
    state = trainer.state_from_state_dicts(w, D.subseed(seed, "program"), device)
    images = D.image_ring(seed, "images", ring, 2 * b, cfg["data"]["load_size"], device,
                          wl.get("smooth", 0))
    a_batches = [images[i, :b] for i in range(ring)]
    b_batches = [images[i, b:] for i in range(ring)]
    gen = D.generator(seed, "draws", device)
    if marks is not None:
        marks.append(("build", time.time()))
    losses_seen, grad = [], None
    for k in range(wl["checked_steps"]):
        state, losses = trainer.train_step(state, a_batches[k % ring], b_batches[k % ring],
                                           draws=program_draws(D.cyclegan_step(gen, cfg, b)))
        losses_seen.append({key: float(losses[key]) for key in LOSSES})
        if k == 0:
            b1 = cfg["optim"]["betas"][0]
            grad = M.first_grads({"G": state.opt_g.mu, "D_A": state.opt_da.mu,
                                  "D_B": state.opt_db.mu}, b1)
            d_grad = M.first_grad_tensors({"D_A": state.opt_da.mu, "D_B": state.opt_db.mu}, b1)
    g_init = {f"{g}.{k}": v for g in ("G_A2B", "G_B2A") for k, v in w[g].items()}
    change = M.changes({"G": state.g_params, "D_A": state.da_params, "D_B": state.db_params},
                       {"G": g_init, "D_A": w["D_A"], "D_B": w["D_B"]})
    if marks is not None:
        marks.append(("checked steps", time.time()))
    return trainer, state, a_batches, b_batches, {"losses": losses_seen, "grad": grad,
                                                  "change": change, "d_grad": d_grad}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import LOSS_KEYS

    wl, cfg = cell["workload"], cell["config"]["train"]
    b, ring = wl["batch"], wl["ring"]
    marks = [("imports", time.time())]
    trainer, state, a_batches, b_batches, prog = checked(cell, seed, device, marks)

    first = wl["checked_steps"]
    sums = torch.zeros(len(LOSS_KEYS), dtype=torch.float64, device=device)

    def call(i):
        nonlocal state, sums
        s = first + i
        state, step_losses = trainer.train_step(state, a_batches[s % ring], b_batches[s % ring])
        sums += torch.stack([step_losses[k] for k in LOSS_KEYS]).double()

    call(0)
    first += 1
    out = M.measure(wl, seconds, trace, device, t_start, call,
                    flops_of=lambda i: flops.cyclegan_step_flops(cfg, b),
                    trunk_of=lambda i: flops.trunk_calls(flops.cyclegan_trunk_passes(cfg, b)),
                    marks=marks)
    finite = bool(torch.isfinite(sums).all())
    out["attempted"], out["failed"] = out["calls"], 0 if finite else out["calls"]
    out["e2e"] = {"train_images_per_s": out["window"]["images"] / out["window"]["seconds"],
                  "train_step_p95_ms": out["window"]["p95_ms"],
                  "peak_mem_gib": out["peak_mem_gib"], "setup_s": out["setup_s"]}
    out["ctx"]["trunk_geom"] = (cfg["data"]["img_size"], cfg["model"]["ngf"], 2)
    del state, trainer, call, a_batches, b_batches, sums
    M.free_memory(device)
    M.full_precision()
    numbers = compare.train_numbers(prog, reference(cell, seed, device))
    out["checks"] = M.checks(numbers, wl["limits"])
    return out
