"""CUT training loop.

Counterpart of ``gan_variant_research_tpu/train/loop.py::train_cut``:
config -> dirs -> tracker -> resume point -> loader -> train state -> step
loop with per-step CSV lines, per-N-step averaged JSON lines (with
``images_per_sec`` and ``step_time_ms``), periodic checkpoints (in the
background by default), a NaN tripwire, then a synchronous
``ckpt_final.msgpack`` and the loss plot.

- Each step's losses are read after the next step is queued, so the host
  does not wait for the card between steps.
- ``--resume auto`` continues from ``latest_checkpoint``; the loader
  fast-forwards to the resumed step, and the checkpoint restores the step
  sampler's state, so a resumed run takes the uninterrupted run's steps.
- No periodic save at ``max_steps``: the final checkpoint holds that state.
- ``runtime.steps_per_call``, ``runtime.donate`` and
  ``runtime.profile_dir`` are TPU levers, accepted and ignored: K single
  steps are what a scan window of K computes. Inline metrics
  (``metrics.compute_fid`` / ``compute_clip_distance``) wait for the Eval
  item of the ROADMAP and raise.
"""

from __future__ import annotations

import importlib.util
import math
import time
from pathlib import Path

import torch

from gan_variant_research_tpu_torch.data.loader import UnpairedLoader
from gan_variant_research_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer
from gan_variant_research_tpu_torch.train.loss_tracker import Averager, LossTracker


def resolve_ckpt_every(config: dict) -> int:
    """Checkpoint cadence in steps: ``metrics.save_checkpoint_every`` or its
    alias ``checkpoint.every_steps`` (both set and different raises), 2000
    when neither is; 0 turns periodic checkpoints off."""
    m = (config.get("metrics") or {}).get("save_checkpoint_every")
    c = (config.get("checkpoint") or {}).get("every_steps")
    if m is not None and c is not None and int(m) != int(c):
        raise ValueError(
            f"metrics.save_checkpoint_every={m} and checkpoint.every_steps={c} "
            "disagree. They are aliases for the checkpoint cadence (the "
            "reference reads metrics.save_checkpoint_every and ignores "
            "checkpoint.every_steps); set both to the same value or drop one "
            "from the config.")
    value = m if m is not None else c
    return int(value) if value is not None else 2000


def _check_finite(step: int, losses: dict) -> None:
    bad = {k: v for k, v in losses.items() if k != "identity_weight" and not math.isfinite(v)}
    if bad:
        raise ValueError(f"NaN loss detected at step {step}: {losses}. "
                         "Training stopped to prevent corruption.")


def train_cut(config: dict, resume: str | None = None, max_steps_override: int | None = None,
              device: torch.device | str = "cuda", stats: dict | None = None):
    """Run CUT training on ``device`` (the card unless the caller asks for
    the CPU); returns (final state, trainer). ``stats``, when given, is
    filled with the run's host-clock figures: ``steps``, ``wall_s`` (the
    step loop), ``loader_wait_s`` (time spent in ``next(loader)``) and
    ``saves`` (``(kind, step, seconds)`` of each save as the loop sees
    it: ``async`` is the time ``AsyncCheckpointer.save`` held the loop,
    ``sync`` a whole write)."""
    metrics_cfg = config.get("metrics") or {}
    if metrics_cfg.get("compute_fid") or metrics_cfg.get("compute_clip_distance"):
        raise NotImplementedError("inline metrics (metrics.compute_fid / compute_clip_distance) "
                                  "are not ported yet (ROADMAP.md Queue 1, item 4, "
                                  "'Variant losses and D options')")
    device = torch.device(device)
    stats = {} if stats is None else stats
    stats.update(steps=0, wall_s=0.0, loader_wait_s=0.0, saves=[])

    out_cfg = config["output"]
    ckpt_dir = Path(out_cfg["checkpoint_dir"])
    log_dir = Path(out_cfg["log_dir"])
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    log_dir.mkdir(parents=True, exist_ok=True)
    trainer = CUTTrainer(config)

    # the resume point comes first: the loader fast-forwards to it
    start_step, resume_blob = 0, None
    if resume:
        path = latest_checkpoint(ckpt_dir) if resume == "auto" else resume
        if resume == "auto" and path is None:
            print("No checkpoint found for auto-resume; starting fresh")
        elif path is not None:
            resume_blob = load_checkpoint(path)
            start_step = resume_blob["step"]
            print(f"Resuming from step {start_step} ({path})")

    data_cfg = config["data"]
    if data_cfg.get("use_tfrec"):
        photos_path, monet_path = data_cfg["photos_tfrec"], data_cfg["monet_tfrec"]
    else:
        photos_path, monet_path = data_cfg["photos_dir"], data_cfg["monet_dir"]
    io_cfg = config.get("io") or {}
    tracker = LossTracker(log_dir).start()
    averager = Averager()
    loader = UnpairedLoader(
        photos_path, monet_path, batch_size=config["batch_size"], size=config["image_size"],
        seed=config.get("seed", 42),
        num_workers=io_cfg.get("num_workers", config.get("num_workers", 8)),
        prefetch=config.get("prefetch_factor", 4), device=device, start_step=start_step)
    ckpt_writer = None
    try:
        print(f"Photos: {loader.num_photos}, Monet: {loader.num_monets}")
        if resume_blob is not None:
            state = trainer.state_from_payload(resume_blob["payload"], resume_blob["step"],
                                               device=device)
        else:
            state = trainer.init_state(device=device)
        n_g = sum(p.numel() for p in state.g_params.values())
        print(f"Generator parameters: {int(n_g):,}")

        max_steps = max_steps_override or config.get("max_steps")
        if not max_steps:
            max_steps = config.get("epochs", 70) * (loader.num_photos // config["batch_size"])
        print(f"Training for {max_steps} steps")
        runtime_cfg = config.get("runtime") or {}
        if int(runtime_cfg.get("steps_per_call", 1)) > 1:
            print(f"runtime.steps_per_call={runtime_cfg['steps_per_call']}: the port takes "
                  "single steps (the same computation)")

        log_cfg = config.get("log") or {}
        log_every = log_cfg.get("every_steps", config.get("log_every", 100))
        ckpt_every = resolve_ckpt_every(config)
        ckpt_cfg = config.get("checkpoint") or {}
        keep_last_n = ckpt_cfg.get("keep_last_n", 5)
        if ckpt_cfg.get("async_save", True):
            ckpt_writer = AsyncCheckpointer()

        pending: list = []          # (step, device losses), read one step late
        step = start_step
        t_window = time.perf_counter()
        imgs_in_window = 0
        last_tick = start_step

        def drain(entry):
            s, device_losses = entry
            # in the JAX loop's key order: its losses come back as a sorted pytree
            host = {k: float(device_losses[k]) for k in sorted(device_losses)}
            _check_finite(s, host)
            tracker.log(s, host["d_loss"], host["g_loss"])
            averager.add(host)

        def bookkeeping(s: int):
            nonlocal t_window, imgs_in_window, last_tick
            if log_every and s % log_every == 0 and s > 0:
                avg = averager.averages()
                dt = time.perf_counter() - t_window
                if dt > 0:
                    avg["images_per_sec"] = imgs_in_window / dt
                    avg["step_time_ms"] = 1000.0 * dt / max(1, s - last_tick)
                last_tick = s
                tracker.log_json_line(s, avg)
                if log_cfg.get("verbose", True):
                    print(f"Step {s}: " + " | ".join(f"{k}: {v:.4f}" for k, v in avg.items()))
                averager.clear()
                t_window = time.perf_counter()
                imgs_in_window = 0
            # not at max_steps: the final checkpoint holds that state
            if ckpt_every and s % ckpt_every == 0 and s > 0 and s != max_steps:
                path = ckpt_dir / f"ckpt_step{s}.msgpack"
                t0 = time.perf_counter()
                if ckpt_writer is not None:
                    ckpt_writer.save(path, state.step, trainer.checkpoint_payload(state),
                                     config=config, keep_last_n=keep_last_n,
                                     on_done=lambda p: print(f"\nSaved checkpoint to {p}"))
                    stats["saves"].append(("async", s, time.perf_counter() - t0))
                else:
                    save_checkpoint(path, state.step, trainer.checkpoint_payload(state),
                                    config=config, keep_last_n=keep_last_n)
                    stats["saves"].append(("sync", s, time.perf_counter() - t0))
                    print(f"\nSaved checkpoint to {path}")

        t_loop = time.perf_counter()
        while step < max_steps:
            t0 = time.perf_counter()
            photos_u8, monets_u8 = next(loader)
            stats["loader_wait_s"] += time.perf_counter() - t0
            state, losses = trainer.train_step(state, photos_u8, monets_u8, step=step)
            pending.append((step, losses))
            imgs_in_window += config["batch_size"]
            while len(pending) > 1:
                drain(pending.pop(0))
            # the label is the completed-step count, which state.step now is
            bookkeeping(step + 1)
            step += 1
            stats["steps"] += 1
        while pending:
            drain(pending.pop(0))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["wall_s"] = time.perf_counter() - t_loop

        if ckpt_writer is not None:
            ckpt_writer.wait()   # a failed background write surfaces here
        final = ckpt_dir / "ckpt_final.msgpack"
        t0 = time.perf_counter()
        save_checkpoint(final, state.step, trainer.checkpoint_payload(state), config=config)
        stats["saves"].append(("sync", state.step, time.perf_counter() - t0))
        print(f"\nTraining complete. Final checkpoint: {final}")
    finally:
        if ckpt_writer is not None:
            try:
                ckpt_writer.close()
            except Exception:
                # the success path surfaced it through wait(); do not mask
                # an exception of the run with the write's
                pass
        tracker.close()
        loader.close()

    history = tracker.load_history()
    if history["steps"]:
        if importlib.util.find_spec("matplotlib") is None:
            print("matplotlib is not installed: the loss plot was skipped")
        else:
            from gan_variant_research_tpu_torch.train.plotting import plot_training_losses

            plot_training_losses(log_dir, history["steps"], history["d_losses"],
                                 history["g_losses"])
    return state, trainer
