"""Driver: ``CycleGANTrainer.train_step`` on the U-Net generator
(``model.generator: unet``) in a closed loop.

As ``drivers/cyclegan_train.py`` (whose draws, epoch length and loss keys
it takes), on the U-Net's inputs: the state is built on
``draws_unet.cyclegan_unet_weights``, the reference is
``reference/unet.py::CycleGANUNet``, the model FLOPs are
``work/unet.py``'s, and no trunk conv runs (``trunk_of`` is empty). The
window steps on the ring of uint8 A and B batches on the card and sums the
losses there, read once the window has closed.

With ``trace`` it also runs the program's span and phase stretches
(``portbench/phases.py``) after the harness's traced stretches, for
``unet_norm_ms.train``; a program without spans gives neither. Standard
error gets the ``unet.norm`` count of set-up's steps and of the span
stretch's (45 a step).
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import compare, phases
from portbench import draws as D
from portbench import draws_unet as U
from portbench import measure as M
from portbench.drivers.cyclegan_train import LOSSES, program_draws, steps_per_epoch
from portbench.reference import nets
from portbench.reference.unet import CycleGANUNet
from portbench.work import unet as work

NETS = ("G_A2B", "G_B2A")


def _numbers(opts: dict, b1: float) -> tuple[dict, dict]:
    """(first gradient norms, D's first gradients) from the Adams' first
    moments after one step; ``opts`` maps G, D_A, D_B to them."""
    return (M.first_grads(opts, b1),
            M.first_grad_tensors({k: v for k, v in opts.items() if k != "G"}, b1))


def reference(cell: dict, seed: int, device, cast=nets.FP32, half: bool = False) -> dict:
    """The reference's losses, first gradients and changes over the checked
    steps, from the seed alone; with ``half``, on the first half of each
    batch."""
    wl, cfg = cell["workload"], cell["config"]["train"]
    b = wl["batch"]
    w = U.cyclegan_unet_weights(seed, cfg, device)
    images = D.image_ring(seed, "images", wl["ring"], 2 * b, cfg["data"]["load_size"], device,
                          wl.get("smooth", 0))
    gen = D.generator(seed, "draws", device)
    cg = CycleGANUNet(cfg, steps_per_epoch(wl), cast)
    st = cg.new_state(w)
    n = max(b // 2, 1) if half else b
    losses = []
    for k in range(wl["checked_steps"]):
        d = D.cyclegan_step(gen, cfg, b)
        imgs = images[k % wl["ring"]]
        losses.append(cg.step(st, imgs[:n], imgs[b:b + n], D.half(d, b) if half else d))
        if k == 0:
            grad, d_grad = _numbers({"G": st["opt_g"].mu, "D_A": st["opt_da"].mu,
                                     "D_B": st["opt_db"].mu}, cfg["optim"]["betas"][0])
    g_now = {f"{g}.{k}": v for g in NETS for k, v in st[g].items()}
    g_init = {f"{g}.{k}": v for g in NETS for k, v in w[g].items()}
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
    w = U.cyclegan_unet_weights(seed, cfg, device)
    state = trainer.state_from_state_dicts(w, D.subseed(seed, "program"), device)
    images = D.image_ring(seed, "images", ring, 2 * b, cfg["data"]["load_size"], device,
                          wl.get("smooth", 0))
    a_batches = [images[i, :b] for i in range(ring)]
    b_batches = [images[i, b:] for i in range(ring)]
    gen = D.generator(seed, "draws", device)
    if marks is not None:
        marks.append(("build", time.time()))
    losses_seen = []
    for k in range(wl["checked_steps"]):
        state, losses = trainer.train_step(state, a_batches[k % ring], b_batches[k % ring],
                                           draws=program_draws(D.cyclegan_step(gen, cfg, b)))
        losses_seen.append({key: float(losses[key]) for key in LOSSES})
        if k == 0:
            grad, d_grad = _numbers({"G": state.opt_g.mu, "D_A": state.opt_da.mu,
                                     "D_B": state.opt_db.mu}, cfg["optim"]["betas"][0])
    g_init = {f"{g}.{k}": v for g in NETS for k, v in w[g].items()}
    change = M.changes({"G": state.g_params, "D_A": state.da_params, "D_B": state.db_params},
                       {"G": g_init, "D_A": w["D_A"], "D_B": w["D_B"]})
    if marks is not None:
        marks.append(("checked steps", time.time()))
    return trainer, state, a_batches, b_batches, {"losses": losses_seen, "grad": grad,
                                                  "change": change, "d_grad": d_grad}


def norm_count() -> int | None:
    """The program's ``unet.norm`` counter, or ``None`` without one."""
    trace = phases.program_trace()
    return None if trace is None else trace.COUNTS.get("unet.norm", 0)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import LOSS_KEYS

    wl, cfg = cell["workload"], cell["config"]["train"]
    b, ring = wl["batch"], wl["ring"]
    marks = [("imports", time.time())]
    counted = norm_count()
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
    if counted is not None:
        print(f"set-up unet.norm count: {norm_count() - counted} over {first} steps",
              file=sys.stderr)
    out = M.measure(wl, seconds, trace, device, t_start, call,
                    flops_of=lambda i: work.cyclegan_unet_step_flops(cfg, b),
                    trunk_of=lambda i: [], marks=marks)
    if trace:
        done = out["calls"] + wl["trace_calls"] + wl["trace_gap_calls"]
        out["ctx"].update(phases.stretches(call, done, wl, device))
        counts = out["ctx"].get("counts", {})
        print(f"span stretch unet.norm count: {counts.get('unet.norm')} over "
              f"{wl['trace_calls']} steps", file=sys.stderr)
    finite = bool(torch.isfinite(sums).all())
    out["attempted"], out["failed"] = out["calls"], 0 if finite else out["calls"]
    out["e2e"] = {"train_images_per_s": out["window"]["images"] / out["window"]["seconds"],
                  "train_step_p95_ms": out["window"]["p95_ms"],
                  "peak_mem_gib": out["peak_mem_gib"], "setup_s": out["setup_s"]}
    del state, trainer, call, a_batches, b_batches, sums
    M.free_memory(device)
    M.full_precision()
    numbers = compare.train_numbers(prog, reference(cell, seed, device))
    out["checks"] = M.checks(numbers, wl["limits"])
    return out
