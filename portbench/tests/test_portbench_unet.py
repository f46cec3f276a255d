"""The U-Net CycleGAN cell: ``correct`` against the faults it must catch and
against the control, the driver's span and phase stretches, the
``unet_norm_ms.train`` reader, and the driver's import hygiene, on CPU runs
at the fault tests' small size (ngf 8, 32^2, batch 4, the program in
float32)."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from portbench.tests import test_portbench_faults as F
from portbench.tests.test_portbench_faults import SEED, run, tiny
from portbench.tests.test_portbench_harness import _loaded_after

UNET = "cyclegan_unet.train_b16"


def fault_affine_deleted(cell, monkeypatch):
    """Every affine norm without its gamma and beta (drawn off identity):
    the normalised input alone, gamma and beta kept in the graph with a
    gradient of zero."""
    from gan_variant_research_tpu_torch.models import generator_unet as gu

    def normalised(self, x):
        x32 = x.float()
        mean = x32.mean(dim=(1, 2), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
        out = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (out + 0.0 * (self.gamma.sum() + self.beta.sum())).to(x.dtype)

    monkeypatch.setattr(gu.AffineInstanceNorm, "forward", normalised)


FAULTS = (F.fault_unchanged, F.fault_half_batch, F.fault_altered_loss, fault_affine_deleted)


def test_a_sound_run_is_correct():
    result = run(tiny(UNET))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(harness.load_cell(UNET)["workload"]["limits"])


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    cell = tiny(UNET)
    fault(cell, monkeypatch)
    result = run(cell)
    assert not result["correct"], result["checks"]


def test_the_control_fails_a_limit():
    cell = tiny(UNET)
    readings = control.training_readings(cell, SEED, "cpu")["control_fp8"]
    limits = cell["workload"]["limits"]
    assert any(v > limits[k] for k, v in readings.items()), (readings, limits)


def test_a_traced_run_runs_the_stretches():
    """The driver's span stretch counts 45 ``unet.norm`` a step, and its
    phase stretch has the gap calls' root spans; on the CPU no device op
    runs, so the reader has nothing to read."""
    cell = tiny(UNET)
    wl = cell["workload"]
    out = harness.driver(cell).run(cell, SEED, 0.2, True, "cpu", 0.0)
    ctx = out["ctx"]
    assert ctx["counts"]["unet.norm"] == 45 * wl["trace_calls"]
    names = [s[0] for s in ctx["spans"]]
    assert names.count("cyclegan.step") == wl["trace_calls"]
    assert names.count("unet.decoder") == 3 * wl["trace_calls"]
    assert ctx["phases"]["roots"] == wl["trace_gap_calls"]
    assert harness.metric_reader(cell, "unet_norm_ms.train").read(ctx) is None


def test_the_unet_norm_reader():
    """Device seconds launched in ``unet.norm`` spans over the phase
    stretch's root spans, in ms; nothing without the stretch, its roots or
    the span (a program without it)."""
    read = harness.metric_reader(harness.load_cell(UNET), "unet_norm_ms.train").read
    phases = {"device": {"unet.norm": 0.128, "unet.decoder": 0.5, "cyclegan.g_backward": 1.0},
              "idle": {}, "ops": {"unet.norm": 900}, "roots": 2, "root_ops": 1800}
    assert read({"phases": phases}) == pytest.approx(64.0)
    assert read({"window": {}}) is None and read({"phases": {}}) is None
    assert read({"phases": {**phases, "roots": 0}}) is None
    assert read({"phases": {**phases, "device": {"cyclegan.g_backward": 1.0}}}) is None


def test_the_driver_reference_and_draws_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench import harness\n"
            f"cell = harness.load_cell('{UNET}')\n"
            "harness.driver(cell)\n"
            "for m in cell['per_layer']:\n"
            "    harness.metric_reader(cell, m['name'])\n"
            "import portbench.work.unet\n"
            "import gan_variant_research_tpu_torch.train.cyclegan_trainer\n")
    assert harness.forbidden_modules(_loaded_after(code)) == []
    loaded = _loaded_after("import sys; sys.path.insert(0, '.')\n"
                           "import portbench.reference.unet, portbench.draws_unet")
    assert not {m.split(".", 1)[0] for m in loaded} & {
        "jax", "jaxlib", "flax", "optax", "gan_variant_research_tpu",
        "gan_variant_research_tpu_torch"}
