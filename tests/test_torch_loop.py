"""The port's training loop and CLI on the CPU: a 4-step ``train_cut`` at
ngf 8, 32^2, batch 2 against the JAX ``train_cut`` (the files it writes:
CSV rows, JSON-line keys and labels, checkpoint names), a run resumed from
its checkpoint against the uninterrupted one (bitwise), the cadence and
tripwire helpers against JAX, and ``gvr-torch-train-cutpp``. JAX on the
CPU."""

import json
import math

import numpy as np
import pytest
import torch
from PIL import Image

from gan_variant_research_tpu.data import native_loader
from gan_variant_research_tpu.train import loop as jax_loop
from gan_variant_research_tpu_torch.cli import train_cutpp
from gan_variant_research_tpu_torch.train import checkpoint as ck
from gan_variant_research_tpu_torch.train import loop
from test_cut_trainer import tiny_config

STEPS = 4


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for name, n in (("photos", 7), ("monet", 5)):
        (root / name).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
                root / name / f"{i:03d}.png")
    return root


def _config(data_dirs, out, **overrides):
    cfg = tiny_config(batch_size=2, parallel={"num_devices": 1}, max_steps=STEPS)
    cfg["model"]["generator"]["ngf"] = 8
    cfg.update(data={"photos_dir": str(data_dirs / "photos"),
                     "monet_dir": str(data_dirs / "monet")},
               output={"checkpoint_dir": str(out / "ckpt"), "log_dir": str(out / "logs")},
               log={"every_steps": 2, "verbose": True}, metrics={"save_checkpoint_every": 2},
               checkpoint={"keep_last_n": 5, "async_save": True}, io={"num_workers": 2})
    cfg.update(overrides)
    return cfg


def _files(out):
    rows = (out / "logs" / "losses_history.csv").read_text().splitlines()
    lines = [(line.split(": ", 1)[0], json.loads(line.split(": ", 1)[1]))
             for line in (out / "logs" / "train_log.txt").read_text().splitlines()]
    return rows, lines, sorted(p.name for p in (out / "ckpt").iterdir())


def test_train_cut_writes_the_jax_runs_files(tmp_path, data_dirs, monkeypatch):
    monkeypatch.setattr(native_loader, "decode_jpeg", lambda path: None)
    stats = {}
    state, _ = loop.train_cut(_config(data_dirs, tmp_path / "port"), device="cpu", stats=stats)
    jax_loop.train_cut(_config(data_dirs, tmp_path / "jax"))
    rows, lines, ckpts = _files(tmp_path / "port")
    j_rows, j_lines, j_ckpts = _files(tmp_path / "jax")
    assert rows[0] == j_rows[0] == "step,d_loss,g_loss"
    assert [r.split(",")[0] for r in rows[1:]] == [r.split(",")[0] for r in j_rows[1:]] == [
        str(s) for s in range(STEPS)]
    assert all(math.isfinite(float(x)) for r in rows[1:] for x in r.split(",")[1:])
    assert [label for label, _ in lines] == [label for label, _ in j_lines] == ["Step 2", "Step 4"]
    assert [list(d) for _, d in lines] == [list(d) for _, d in j_lines]
    assert {"images_per_sec", "step_time_ms"} <= set(lines[0][1])
    # no periodic save at max_steps: ckpt_step2 and the final one
    assert ckpts == j_ckpts == ["ckpt_final.msgpack", "ckpt_step2.msgpack"]
    assert ck._stored_step(tmp_path / "port" / "ckpt" / "ckpt_final.msgpack") == STEPS
    assert state.step == STEPS and stats["steps"] == STEPS
    assert [kind for kind, _, _ in stats["saves"]] == ["async", "sync"]


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, data_dirs):
    """4 straight steps against 2, a checkpoint, ``--resume auto`` and 2
    more: the same parameters, moments, EMA and losses, bit for bit."""
    straight, _ = loop.train_cut(_config(data_dirs, tmp_path / "a"), device="cpu")
    loop.train_cut(_config(data_dirs, tmp_path / "b", max_steps=STEPS // 2), device="cpu")
    resumed, _ = loop.train_cut(_config(data_dirs, tmp_path / "b"), resume="auto", device="cpu")
    assert resumed.step == straight.step == STEPS
    for part in ("g_params", "d_params", "ema"):
        for name, t in getattr(straight, part).items():
            assert torch.equal(getattr(resumed, part)[name], t), (part, name)
    for part in ("opt_g", "opt_d"):
        a, b = getattr(straight, part), getattr(resumed, part)
        assert a.count == b.count
        assert all(torch.equal(a.mu[n], b.mu[n]) and torch.equal(a.nu[n], b.nu[n])
                   for n in a.mu)
    assert torch.equal(straight.rng.get_state(), resumed.rng.get_state())
    assert _files(tmp_path / "a")[0] == _files(tmp_path / "b")[0]


@pytest.mark.parametrize("config", [
    {}, {"metrics": {"save_checkpoint_every": 50}}, {"checkpoint": {"every_steps": 30}},
    {"metrics": {"save_checkpoint_every": 0}},
    {"metrics": {"save_checkpoint_every": 10}, "checkpoint": {"every_steps": 10}},
    {"metrics": {"save_checkpoint_every": 10}, "checkpoint": {"every_steps": 20}},
    {"metrics": None, "checkpoint": None}])
def test_resolve_ckpt_every_matches_jax(config):
    def run(fn):
        try:
            return fn(config)
        except ValueError as e:
            return str(e)

    assert run(loop.resolve_ckpt_every) == run(jax_loop.resolve_ckpt_every)


@pytest.mark.parametrize("losses", [
    {"d_loss": 1.0, "g_loss": 2.0}, {"d_loss": float("nan"), "g_loss": 2.0},
    {"g_loss": float("inf")}, {"identity_weight": float("nan"), "d_loss": 0.5}])
def test_check_finite_matches_jax(losses):
    def run(fn):
        try:
            fn(3, losses)
            return None
        except ValueError as e:
            return str(e)

    assert run(loop._check_finite) == run(jax_loop._check_finite)


def test_inline_metrics_are_refused_naming_the_eval_item(tmp_path, data_dirs):
    cfg = _config(data_dirs, tmp_path, metrics={"compute_fid": True})
    with pytest.raises(NotImplementedError, match="'Variant losses and D options'"):
        loop.train_cut(cfg, device="cpu")


def test_cli_trains_on_the_cpu_and_refuses_a_missing_card(tmp_path, data_dirs, monkeypatch,
                                                          capsys):
    sets = [f"data.photos_dir={data_dirs / 'photos'}", f"data.monet_dir={data_dirs / 'monet'}",
            f"output.checkpoint_dir={tmp_path / 'ckpt'}", f"output.log_dir={tmp_path / 'logs'}",
            "image_size=32", "batch_size=2", "max_steps=2", "model.generator.ngf=4",
            "model.generator.n_blocks=1", "model.discriminator.ndf=4",
            "model.discriminator.n_layers=1", "patchnce.num_patches=8", "log.every_steps=1",
            "runtime.precision=fp32", "runtime.steps_per_call=2", "io.num_workers=1"]
    # without matplotlib the loop says that it skipped the plot
    real_find_spec = loop.importlib.util.find_spec
    monkeypatch.setattr(loop.importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real_find_spec(name, *a))
    state, trainer = train_cutpp.main(["--strict-config", "--device", "cpu",
                                       "--set", *sets[:8], "--set", *sets[8:]])
    assert state.step == 2 and trainer.image_size == 32
    assert next(iter(state.g_params.values())).device.type == "cpu"
    out = capsys.readouterr().out
    assert "the loss plot was skipped" in out and "steps_per_call=2" in out
    assert (tmp_path / "ckpt" / "ckpt_final.msgpack").exists()
    assert train_cutpp.parse_args([]).config == str(train_cutpp.DEFAULT_CONFIG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cutpp.main(["--set", *sets])
