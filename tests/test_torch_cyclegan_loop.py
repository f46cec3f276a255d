"""The port's CycleGAN loop and CLI on the CPU: ``train_cyclegan`` on tiny
seeded JPEG folders beside the JAX loop (the port fed the JAX run's initial
weights and draws): the same steps per epoch, checkpoint names, log keys
and epoch labels, the loss averages to 1e-4; a run resumed from its epoch
checkpoint against the uninterrupted one (bitwise); and
``gvr-torch-train-cyclegan`` on the CPU and without a card. Sizes of
``test_cyclegan_loop.py`` (24^2 JPEGs loaded at 20^2, 16^2 crops, ngf 4)."""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gan_variant_research_tpu.data import native_loader
from gan_variant_research_tpu.train.cyclegan_loop import train_cyclegan as jax_train_cyclegan
from gan_variant_research_tpu.train.cyclegan_trainer import CycleGANTrainer as JaxTrainer
from gan_variant_research_tpu_torch.cli import train_cyclegan as cli
from gan_variant_research_tpu_torch.train import checkpoint as ck
from gan_variant_research_tpu_torch.train.cyclegan_loop import train_cyclegan
from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from torch_jax_draws import cyclegan_draws

B, CROP, LOAD = 2, 16, 20


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cyclegan_data")
    for name, n, seed in (("a", 6, 0), ("b", 4, 1)):
        rng = np.random.default_rng(seed)
        (root / name).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)).save(
                root / name / f"{i:03d}.jpg", quality=90)
    return root


def _cfg(root, out, **training):
    return {
        "data": {"root": str(root), "domain_a": "a", "domain_b": "b",
                 "img_size": CROP, "load_size": LOAD, "num_workers": 2},
        "training": {"epochs": 2, "batch_size": B, "amp": False, "seed": 0,
                     "save_dir": str(out / "ckpts"), "log_dir": str(out / "logs"),
                     "save_every": 1, **training},
        "optim": {"lr_g": 2e-4, "lr_d": 2e-4, "betas": [0.5, 0.999], "lr_decay_after": 1},
        "loss": {"gan": "lsgan", "lambda_cycle": 10.0, "lambda_identity": 0.5},
        "model": {"ngf": 4, "ndf": 4, "n_blocks": 6, "n_layers": 2,
                  "spectral_norm_d": False, "generator": "resnet"},
        "runtime": {"precision": "fp32"},
        "parallel": {"num_devices": 1},
    }


def _log(out):
    return [json.loads(line) for line in (out / "logs" / "cyclegan_log.jsonl").read_text()
            .splitlines()]


def test_train_cyclegan_writes_the_jax_runs_files(tmp_path, data_root, monkeypatch):
    """2 epochs of max(6, 4) // 2 = 3 steps. The port starts from the JAX
    run's weights and takes the JAX draws, so its epoch averages follow the
    JAX run's: to 1e-2, as the runs drift apart in float32 (Adam's first
    step moves each parameter by lr either way, also where the gradient is
    rounding noise; measured 2.7e-3 at epoch 2, and one step matches to 1e-5
    in ``test_torch_cyclegan_trainer.py``). The logged averages are the
    means of the port's step losses, in the JAX ``Averager``'s float64
    arithmetic."""
    monkeypatch.setattr(native_loader, "decode_jpeg", lambda path: None)
    cfg_jax, cfg_port = _cfg(data_root, tmp_path / "jax"), _cfg(data_root, tmp_path / "port")
    jstate, jtrainer = jax_train_cyclegan(cfg_jax)
    jinit = JaxTrainer(cfg_jax, steps_per_epoch=3).init_state()
    nets = {"G_A2B": jinit.g_params["G_A2B"], "G_B2A": jinit.g_params["G_B2A"],
            "D_A": jinit.da_params, "D_B": jinit.db_params}
    nets = jax.tree_util.tree_map(np.asarray, nets)
    real_step = CycleGANTrainer.train_step

    step_losses = []

    def jax_draws_step(self, state, a_u8, b_u8, draws=None):
        draws = cyclegan_draws(jinit.base_key, state.step, B, LOAD, LOAD, CROP)
        state, losses = real_step(self, state, a_u8, b_u8, draws=draws)
        step_losses.append({k: float(v) for k, v in losses.items()})
        return state, losses

    monkeypatch.setattr(CycleGANTrainer, "init_state",
                        lambda self, seed=None, device="cuda": self.state_from_jax(
                            nets, device=device))
    monkeypatch.setattr(CycleGANTrainer, "train_step", jax_draws_step)
    stats = {}
    state, trainer = train_cyclegan(cfg_port, device="cpu", stats=stats)

    assert trainer.steps_per_epoch == jtrainer.steps_per_epoch == 3
    assert state.step == int(jstate.step) == 6 and stats["steps"] == 6
    names = lambda out: sorted(p.name for p in (out / "ckpts").iterdir())  # noqa: E731
    assert names(tmp_path / "port") == names(tmp_path / "jax") == [
        "ckpt_e1.msgpack", "ckpt_e2.msgpack"]
    log, jlog = _log(tmp_path / "port"), _log(tmp_path / "jax")
    assert [list(d) for d in log] == [list(d) for d in jlog]
    assert [(d["epoch"], d["step"]) for d in log] == [(1, 3), (2, 6)]
    for epoch, (got, want) in enumerate(zip(log, jlog)):
        for k in ("D_A", "D_B", "G", "adv", "cycle", "idt"):
            steps = [d[k] for d in step_losses[3 * epoch:3 * epoch + 3]]
            assert got[k] == sum(steps) / len(steps), (got["epoch"], k)
            assert got[k] == pytest.approx(want[k], rel=1e-2), (got["epoch"], k)
    blob = ck.load_checkpoint(tmp_path / "port" / "ckpts" / "ckpt_e2.msgpack")
    assert blob["step"] == 6 and blob["metrics"] == {"epoch": 2}
    assert [kind for kind, _, _ in stats["saves"]] == ["async", "async"]


def _states_equal(a, b):
    for part in ("g_params", "da_params", "db_params"):
        for name, t in getattr(a, part).items():
            assert torch.equal(getattr(b, part)[name], t), (part, name)
    for part in ("opt_g", "opt_da", "opt_db"):
        x, y = getattr(a, part), getattr(b, part)
        assert x.count == y.count
        assert all(torch.equal(x.mu[n], y.mu[n]) and torch.equal(x.nu[n], y.nu[n]) for n in x.mu)
    assert a.step == b.step
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    np.testing.assert_array_equal(a.base_key, b.base_key)


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, data_root):
    """4 straight steps against 2, ``ckpt_e1`` and ``--resume auto`` for 2
    more (epochs of 2 steps with batch 3; the learning rate decays from
    epoch 1, so the resumed steps need the restored Adam count)."""
    over = dict(batch_size=3, epochs=3)
    straight, _ = train_cyclegan(_cfg(data_root, tmp_path / "a", max_steps=4, **over),
                                 device="cpu")
    train_cyclegan(_cfg(data_root, tmp_path / "b", max_steps=2, **over), device="cpu")
    resumed, _ = train_cyclegan(_cfg(data_root, tmp_path / "b", max_steps=4, **over),
                                resume="auto", device="cpu")
    _states_equal(straight, resumed)
    assert resumed.step == 4 and straight.opt_g.count == 4
    # the resumed run appended its epoch to the log; the epochs' averages match
    strip = lambda out: [{k: v for k, v in d.items() if k != "images_per_sec"}  # noqa: E731
                         for d in _log(out)]
    assert strip(tmp_path / "a") == strip(tmp_path / "b")
    assert [d["epoch"] for d in strip(tmp_path / "b")] == [1, 2]


def test_cli_trains_on_the_cpu_and_refuses_a_missing_card(tmp_path, data_root, monkeypatch,
                                                          capsys):
    sets = [f"data.root={data_root}", "data.domain_a=a", "data.domain_b=b", "data.img_size=16",
            "data.load_size=20", "data.num_workers=1", f"training.save_dir={tmp_path / 'ck'}",
            f"training.log_dir={tmp_path / 'logs'}", "training.batch_size=2",
            "training.max_steps=2", "model.ngf=4", "model.ndf=4", "model.n_blocks=6",
            "model.n_layers=2", "runtime.precision=fp32", "runtime.steps_per_call=4"]
    state, trainer = cli.main(["--strict-config", "--device", "cpu",
                               "--set", *sets[:8], "--set", *sets[8:]])
    assert state.step == 2 and trainer.crop == 16
    assert next(iter(state.g_params.values())).device.type == "cpu"
    assert "steps_per_call=4" in capsys.readouterr().out
    assert (tmp_path / "ck" / "ckpt_e0.msgpack").exists()
    assert cli.parse_args([]).config == str(cli.DEFAULT_CONFIG)
    assert cli.DEFAULT_CONFIG.name == "baseline.yaml"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--set", *sets])
