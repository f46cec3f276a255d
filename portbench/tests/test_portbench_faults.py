"""``correct`` against the faults it must catch and against the control.

Each cell runs through the harness on the CPU at a small size (ngf 8,
32^2, batch 2 or 4, the program in float32, so that a sound run reads far
under the cell's limits), with the timed path broken underneath: a step
that returns its state unchanged, half of the batch left out (the mean
over the rest), an answer altered where it is produced. A sound run reads
``correct``, each broken one not. The cell's control (the reference with
its convs in float8 e4m3 in the program's place) fails one of its limits.
A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import control, harness

SEED = 2 ** 31 + 77
TRAIN_CELLS = ("cut_flagship.train_warmup_b12", "cyclegan_resnet9.train_b16")


def tiny(name: str, batch: int | None = None) -> dict:
    cell = harness.load_cell(name)
    cfg = cell["config"]["train"]
    if "patchnce" in cfg:
        cfg["image_size"] = 32
        cfg["model"]["generator"]["ngf"] = 8
        cfg["model"]["discriminator"]["ndf"] = 8
        cfg["patchnce"]["num_patches"] = 16
    else:
        cfg["data"].update(img_size=32, load_size=36)
        cfg["model"].update(ngf=8, ndf=8)
    cfg["runtime"]["precision"] = "fp32"
    wl = cell["workload"]
    wl.update(batch=batch or min(wl["batch"], 4), ring=3, trace_calls=2, trace_gap_calls=1)
    return cell


def run(cell) -> dict:
    return harness.run_cell(cell, SEED, 0.2, False, "cpu", 0.0)


def _half(x, b: int):
    """Every per-sample tensor of a draws object cut to its first b // 2."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _half(getattr(x, f.name), b)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_half(v, b) for v in x)
    if isinstance(x, torch.Tensor) and x.dim() == 1 and x.shape[0] == b:
        return x[: b // 2]
    return x


def _trainer(cell):
    if cell["workload"]["driver"] == "cut_train":
        from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer
        return CUTTrainer, ("g_params", "d_params", "ema"), "d_loss"
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
    return CycleGANTrainer, ("g_params", "da_params", "db_params"), "D_A"


def fault_unchanged(cell, monkeypatch):
    cls, fields, _ = _trainer(cell)
    step = cls.train_step

    def unchanged(self, state, a, b, *args, **kw):
        keep = {f: {k: v.detach().clone() for k, v in getattr(state, f).items()} for f in fields}
        state, losses = step(self, state, a, b, *args, **kw)
        with torch.no_grad():
            for f in fields:
                for k, v in getattr(state, f).items():
                    v.copy_(keep[f][k])
        return state, losses

    monkeypatch.setattr(cls, "train_step", unchanged)


def fault_half_batch(cell, monkeypatch):
    cls, _, _ = _trainer(cell)
    step = cls.train_step

    def half(self, state, a, b, *args, draws=None, **kw):
        n = a.shape[0]
        return step(self, state, a[: n // 2], b[: n // 2], *args,
                    draws=None if draws is None else _half(draws, n), **kw)

    monkeypatch.setattr(cls, "train_step", half)


def fault_altered_loss(cell, monkeypatch):
    cls, _, key = _trainer(cell)
    step = cls.train_step

    def altered(self, *args, **kw):
        state, losses = step(self, *args, **kw)
        return state, dict(losses, **{key: losses[key] * 1.5})

    monkeypatch.setattr(cls, "train_step", altered)


def fault_altered_answer(cell, monkeypatch):
    from gan_variant_research_tpu_torch.cli import generate_folder as gf
    serve = gf.stylize_batch

    def altered(*args, **kw):
        out = serve(*args, **kw).clone()
        out[0] = 255 - out[0]
        return out

    monkeypatch.setattr(gf, "stylize_batch", altered)


def fault_served_half_batch(cell, monkeypatch):
    from gan_variant_research_tpu_torch.cli import generate_folder as gf
    serve = gf.stylize_batch

    def half(net, u8, size=256):
        out = serve(net, u8[: len(u8) // 2], size)
        return torch.cat([out, torch.zeros_like(out[: len(u8) - len(out)])])

    monkeypatch.setattr(gf, "stylize_batch", half)


FAULTS = [(c, f) for c in TRAIN_CELLS
          for f in (fault_unchanged, fault_half_batch, fault_altered_loss)]
FAULTS += [("cut_flagship.serve_b32", f) for f in (fault_altered_answer, fault_served_half_batch)]


@pytest.mark.parametrize("name", TRAIN_CELLS + ("cut_flagship.serve_b32",))
def test_a_sound_run_is_correct(name):
    result = run(tiny(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_run_is_not_correct(name, fault, monkeypatch):
    cell = tiny(name)
    fault(cell, monkeypatch)
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", TRAIN_CELLS + ("cut_flagship.serve_b32",))
def test_the_control_fails_a_limit(name):
    cell = tiny(name)
    serving = cell["workload"]["driver"] == "serve"
    readings = (control.serving_readings if serving else control.training_readings)(
        cell, SEED, "cpu")["control_fp8"]
    limits = cell["workload"]["limits"]
    assert any(v > limits[k] for k, v in readings.items()), (readings, limits)
