"""The variant cell and the steady cell: the attention kernels' work and
bounds, the attention readers, the driver's import hygiene, and ``correct``
against the faults it must catch, on CPU runs at the fault tests' small
size (ngf 8, 32^2, batch 4, the program in float32)."""

from __future__ import annotations

import dataclasses

import pytest

from portbench import control, control_variant, harness
from portbench.tests import test_portbench_faults as F
from portbench.tests.test_portbench_faults import SEED, run, tiny
from portbench.tests.test_portbench_harness import _loaded_after
from portbench.work import attention as A
from portbench.work import flops

VARIANT, STEADY = "cut_variant.train_warmup_b12", "cut_flagship.train_steady_b12"


def test_attention_bounds_are_the_kernel_tables():
    """PERF.md's kernel table: the forward, dK/dV and dQ bounds at the
    variant's (12, 4096, 32, 256), compute-bound."""
    for kind, ms in (("fwd", 0.1173), ("dkv", 0.2345), ("dq", 0.1303)):
        f, nbytes = A.attention_work(12, 4096, 32, 256, kind)
        assert round(flops.bound_s(f, nbytes) * 1e3, 4) == ms
        assert f / flops.PEAK_BF16_FLOPS > nbytes / flops.PEAK_BYTES_PER_S
    assert A.attention_work(1, 2, 8, 8, "fwd") == (2.0 * 4 * 16, 2 * 2 * 8 * 2 * 2 + 2 * 4)


def test_the_variant_steps_attention_calls_and_flops():
    cfg = harness.load_cell(VARIANT)["config"]["train"]
    warm, steady = A.attention_calls(cfg, 12, 0), A.attention_calls(cfg, 12, 20000)
    assert [sum(c[0] == k for c in warm) for k in A.KINDS] == [6, 6, 6]
    assert [sum(c[0] == k for c in steady) for k in A.KINDS] == [4, 4, 4]
    assert set(c[1:] for c in warm) == {(12, 4096, 32, 256)}
    # the two blocks add ~22% to a generator forward
    share = 2 * A.block_fwd_flops(4096, 256, 32) / flops.generator_fwd_flops(256)
    assert 0.21 < share < 0.23
    assert A.variant_step_flops(cfg, 12, 0) == pytest.approx(
        3 * 12 * 3 * 2 * A.block_fwd_flops(4096, 256, 32))
    flagship = harness.load_cell("cut_flagship.train_warmup_b12")["config"]["train"]
    assert A.attention_calls(flagship, 12, 0) == [] and A.variant_step_flops(flagship, 12, 0) == 0


def _ctx(names, calls=1):
    ops = [(n, 10.0 * i, 10.0 * i + 5.0) for i, n in enumerate(names)]
    return {"trace": {"ops": ops, "calls": calls},
            "attn_calls": [(k, 12, 4096, 32, 256) for k in A.KINDS]}


def test_the_attention_readers():
    cell = harness.load_cell(VARIANT)
    roof = harness.metric_reader(cell, "attn_roofline.train")
    ms = harness.metric_reader(cell, "attn_ms.train")
    names = ["void (anonymous namespace)::attn_fwd_bf16<32>(CUtensorMap)", "attn_dkv_bf16<32>",
             "attn_dq_wgmma<32>", "at::native::elementwise_kernel", "fwd_main_wgmma"]
    ctx = _ctx(names)
    bound = A.attention_bound_s(ctx["attn_calls"])
    assert roof.read(ctx) == pytest.approx(100.0 * bound / 15e-6)
    assert ms.read(ctx) == pytest.approx(15e-3)
    # a route that launches more (or fewer) kernels than the shapes give
    assert roof.read(_ctx(names + ["attn_dq_wgmma<32>"])) is None
    assert roof.read(_ctx(names[1:])) is None
    assert roof.read({"window": {}}) is None and ms.read({"window": {}}) is None
    no_attention = _ctx(names[3:])
    assert ms.read(no_attention) is None and roof.read(no_attention) is None


def test_the_variant_driver_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench import harness\n"
            f"cell = harness.load_cell('{VARIANT}')\n"
            "harness.driver(cell)\n"
            "for m in cell['per_layer']:\n"
            "    harness.metric_reader(cell, m['name'])\n"
            "import portbench.readers_attention, portbench.work.attention\n")
    assert harness.forbidden_modules(_loaded_after(code)) == []
    loaded = _loaded_after("import sys; sys.path.insert(0, '.')\n"
                           "import portbench.reference.variant, portbench.draws_variant")
    assert not {m.split(".", 1)[0] for m in loaded} & {
        "jax", "jaxlib", "flax", "optax", "gan_variant_research_tpu",
        "gan_variant_research_tpu_torch"}


def _as_cut(cell: dict) -> dict:
    """The cell as ``test_portbench_faults``' faults take it: the variant's
    driver runs ``CUTTrainer`` too."""
    return {**cell, "workload": {**cell["workload"], "driver": "cut_train"}}


def fault_half_batch_styles(cell, monkeypatch):
    """``fault_half_batch`` with the (n_blocks, B) style alphas cut too."""
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    step = CUTTrainer.train_step
    styles = ("style_fwd", "style_nce", "style_idt")

    def half(self, state, a, b, *args, draws=None, **kw):
        n = a.shape[0]
        if draws is not None:
            draws = dataclasses.replace(F._half(draws, n), **{
                f: getattr(draws, f)[:, : n // 2] for f in styles if getattr(draws, f) is not None})
        return step(self, state, a[: n // 2], b[: n // 2], *args, draws=draws, **kw)

    monkeypatch.setattr(CUTTrainer, "train_step", half)


def fault_attention_dropped(cell, monkeypatch):
    """The attention blocks run and their output is dropped: each returns
    its input (the attention's parameters stay in the graph, with a
    gradient of zero)."""
    from gan_variant_research_tpu_torch.models.attention import SelfAttention2d

    forward = SelfAttention2d.forward
    monkeypatch.setattr(SelfAttention2d, "forward",
                        lambda self, x: x + 0.0 * (forward(self, x) - x))


def _doubled(kind):
    def fault(cell, monkeypatch):
        from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

        monkeypatch.setattr(sa, *control_variant.doubled(kind))

    fault.__name__ = f"fault_{kind}_doubled"
    fault.__doc__ = f"The attention backward's {kind} doubled: a kernel off by a scale factor."
    return fault


FAULTS = [(STEADY, f) for f in (F.fault_unchanged, F.fault_half_batch, F.fault_altered_loss)]
FAULTS += [(VARIANT, f) for f in (F.fault_unchanged, fault_half_batch_styles, F.fault_altered_loss,
                                  fault_attention_dropped, *map(_doubled, ("dk", "dv", "dq")))]


@pytest.mark.parametrize("name", [VARIANT, STEADY])
def test_a_sound_run_is_correct(name):
    result = run(tiny(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(harness.load_cell(name)["workload"]["limits"])


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_run_is_not_correct(name, fault, monkeypatch):
    cell = tiny(name)
    fault(_as_cut(cell), monkeypatch)
    result = run(cell)
    assert not result["correct"], result["checks"]


def test_the_steady_control_fails_a_limit():
    cell = tiny(STEADY)
    readings = control.training_readings(cell, SEED, "cpu")["control_fp8"]
    limits = cell["workload"]["limits"]
    assert any(v > limits[k] for k, v in readings.items() if k in limits), (readings, limits)


def test_the_variant_readings_past_their_limits():
    """``control_variant.py``'s readings: the program under every limit; the
    control and each planted fault but the half batch past one, and the
    blocks' faults past ``grad_gap``'s (the half batch leaves the blocks
    alone and fails the step's numbers, as the run above shows)."""
    cell = tiny(VARIANT)
    limits = cell["workload"]["limits"]
    r = control_variant.readings(cell, SEED, "cpu", program=True)
    assert all(r["program"][k] < v for k, v in limits.items()), r["program"]
    for name in ("control_fp8", "fault_attention_dropped", "fault_dk_doubled",
                 "fault_dv_doubled", "fault_dq_doubled"):
        assert r[name]["grad_gap"] > limits["grad_gap"], (name, r[name])
