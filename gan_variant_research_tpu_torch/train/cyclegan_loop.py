"""CycleGAN training loop.

Counterpart of ``gan_variant_research_tpu/train/cyclegan_loop.py::
train_cyclegan``: an epoch is ``max(|A|, |B|) // batch`` steps of the
unpaired loader (``data.root/domain_a`` and ``domain_b`` at ``load_size``,
seeded with ``training.seed``); every epoch, and at ``max_steps``, the
epoch line and a JSON line in ``log_dir/cyclegan_log.jsonl`` (truncated on
a fresh run) with the epoch's loss averages and images/s; NaN stops the
run; ``ckpt_e{epoch}.msgpack`` every ``save_every`` epochs and at
``max_steps``, in the background unless ``training.async_save`` is false
(the payload is copied to the host before the next step, which updates the
state in place); ``--resume auto`` continues from ``latest_checkpoint``,
the loader fast-forwarded to the resumed step.

The JAX loop reads every step's losses on the host; here they are summed on
the device in float64, in step order, and read once an epoch: the same
averages without a synchronisation a step. ``runtime.steps_per_call`` scan
windows are a TPU lever, accepted and ignored.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import torch

from gan_variant_research_tpu_torch.data.loader import UnpairedLoader, make_source
from gan_variant_research_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from gan_variant_research_tpu_torch.train.cyclegan_trainer import LOSS_KEYS, CycleGANTrainer

# the JAX step's losses come back as a pytree dict, in sorted key order
LOG_KEYS = tuple(sorted(LOSS_KEYS))


def train_cyclegan(config: dict, max_steps_override: int | None = None,
                   resume: str | None = None, device: torch.device | str = "cuda",
                   stats: dict | None = None):
    """Run CycleGAN training on ``device`` (the card unless the caller asks
    for the CPU); returns (final state, trainer). ``stats``, when given, is
    filled with the run's host-clock figures: ``steps``, ``wall_s`` (the
    step loop), ``loader_wait_s`` (time spent in ``next(loader)``) and
    ``saves`` (``(kind, epoch, seconds)`` of each save as the loop sees it:
    ``async`` the time ``AsyncCheckpointer.save`` held the loop, ``sync`` a
    whole write)."""
    device = torch.device(device)
    stats = {} if stats is None else stats
    stats.update(steps=0, wall_s=0.0, loader_wait_s=0.0, saves=[])
    data_cfg, t_cfg = config["data"], config["training"]
    root = Path(data_cfg["root"])
    load_size = data_cfg.get("load_size", 286)
    batch = t_cfg["batch_size"]
    source_a = make_source(root / data_cfg["domain_a"], load_size)
    source_b = make_source(root / data_cfg["domain_b"], load_size)
    steps_per_epoch = max(len(source_a), len(source_b)) // batch
    trainer = CycleGANTrainer(config, steps_per_epoch=steps_per_epoch)

    # the resume point comes first: the loader fast-forwards to it
    save_dir = Path(t_cfg["save_dir"])
    start_step, resume_blob = 0, None
    if resume:
        path = latest_checkpoint(save_dir) if resume == "auto" else resume
        if resume == "auto" and path is None:
            print("No checkpoint found for auto-resume; starting fresh")
        elif path is not None:
            resume_blob = load_checkpoint(path)
            start_step = resume_blob["step"]
            print(f"Resuming from step {start_step} ({path})")

    save_dir.mkdir(parents=True, exist_ok=True)
    log_path = Path(t_cfg["log_dir"]) / "cyclegan_log.jsonl" if t_cfg.get("log_dir") else None
    if log_path:
        log_path.parent.mkdir(parents=True, exist_ok=True)
        if start_step == 0:
            log_path.write_text("")   # a fresh run truncates; a resumed one appends

    runtime_cfg = config.get("runtime") or {}
    if int(runtime_cfg.get("steps_per_call", 1)) > 1:
        print(f"runtime.steps_per_call={runtime_cfg['steps_per_call']}: the port takes "
              "single steps (the same computation)")
    total_epochs = t_cfg["epochs"]
    max_steps = max_steps_override or t_cfg.get("max_steps") or total_epochs * steps_per_epoch
    save_every = t_cfg.get("save_every", 10)

    loader = UnpairedLoader(source_a, source_b, batch_size=batch, size=load_size,
                            seed=t_cfg.get("seed", 0), num_workers=data_cfg.get("num_workers", 4),
                            device=device, start_step=start_step)
    ckpt_writer = AsyncCheckpointer() if t_cfg.get("async_save", True) else None
    try:
        if resume_blob is not None:
            state = trainer.state_from_payload(resume_blob["payload"], start_step, device=device)
        else:
            state = trainer.init_state(device=device)
        # the epoch's loss sums, on the device, in LOG_KEYS order
        sums = torch.zeros(len(LOG_KEYS), dtype=torch.float64, device=device)
        in_epoch = 0

        def save(epoch: int):
            path = save_dir / f"ckpt_e{epoch}.msgpack"
            t0 = time.perf_counter()
            payload = trainer.checkpoint_payload(state)
            if ckpt_writer is not None:
                ckpt_writer.save(path, state.step, payload, config=config,
                                 metrics={"epoch": epoch},
                                 on_done=lambda p: print(f"Saved checkpoint to {p}"))
                stats["saves"].append(("async", epoch, time.perf_counter() - t0))
            else:
                save_checkpoint(path, state.step, payload, config=config,
                                metrics={"epoch": epoch})
                stats["saves"].append(("sync", epoch, time.perf_counter() - t0))
                print(f"Saved checkpoint to {path}")

        step = start_step
        t0 = t_loop = time.perf_counter()
        while step < max_steps:
            t_wait = time.perf_counter()
            a_u8, b_u8 = next(loader)
            stats["loader_wait_s"] += time.perf_counter() - t_wait
            state, losses = trainer.train_step(state, a_u8, b_u8)
            sums += torch.stack([losses[k] for k in LOG_KEYS]).double()
            in_epoch += 1
            step += 1
            stats["steps"] += 1

            if step % steps_per_epoch == 0 or step == max_steps:
                epoch = step // max(1, steps_per_epoch)
                avg = dict(zip(LOG_KEYS, (sums / in_epoch).tolist()))
                rate = (step - start_step) * batch / (time.perf_counter() - t0)
                print(f"Epoch {epoch}/{total_epochs} "
                      + " | ".join(f"{k}: {v:.3f}" for k, v in avg.items())
                      + f" | {rate:.1f} img/s")
                if log_path:
                    with open(log_path, "a") as f:
                        f.write(json.dumps({"epoch": epoch, "step": step, **avg,
                                            "images_per_sec": rate}) + "\n")
                sums.zero_()
                in_epoch = 0
                if any(not math.isfinite(v) for v in avg.values()):
                    raise ValueError(f"NaN loss at epoch {epoch}: {avg}")
                if epoch % save_every == 0 or step == max_steps:
                    save(epoch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["wall_s"] = time.perf_counter() - t_loop
        if ckpt_writer is not None:
            ckpt_writer.wait()   # a failed background write surfaces here
    finally:
        if ckpt_writer is not None:
            try:
                ckpt_writer.close()
            except Exception:
                # the success path surfaced it through wait(); do not mask
                # an exception of the run with the write's
                pass
        loader.close()
    return state, trainer
