"""``core/trace.py``: spans off by default and free of effects, the train
steps' phase spans (CUT and CycleGAN), their place in ``torch.profiler``'s
timeline, and the launch counters. Tiny configurations on the CPU (ngf 8,
32^2, batch 2); the trunk's spans and counters open only on the card."""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer
from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

B, S = 2, 32
CUT_CONFIG = {
    "image_size": S, "batch_size": B, "seed": 3, "warmup_steps": 10,
    "grad_clip_g": 10.0, "grad_clip_d": 10.0,
    "optim": {"G": {"lr": 2e-4, "betas": [0.5, 0.999]},
              "D": {"lr": 2e-4, "betas": [0.5, 0.999]}},
    "loss_weights": {"adv": 1.0, "patchnce": 1.0, "identity_warm": 0.1, "identity_final": 0.0},
    "model": {"generator": {"ngf": 8, "n_blocks": 1},
              "discriminator": {"ndf": 8, "n_layers": 2, "num_scales": 1}},
    "patchnce": {"num_patches": 16, "temperature": 0.07, "nce_layers": [0, 4, 8]},
    "diffaugment": {"enable": True, "policy": ["color", "translation", "cutout"]},
    "r1": {"gamma": 10.0, "every": 2},
    "ema": {"decay": 0.999},
    "runtime": {"precision": "fp32"},
}
CYCLEGAN_CONFIG = {
    "data": {"img_size": S, "load_size": S + 4},
    "training": {"epochs": 2, "batch_size": B, "seed": 0},
    "optim": {"lr_g": 2e-4, "lr_d": 2e-4, "betas": [0.5, 0.999], "lr_decay_after": 1},
    "loss": {"gan": "lsgan", "lambda_cycle": 10.0, "lambda_identity": 0.5},
    "model": {"ngf": 8, "ndf": 8, "n_blocks": 6, "n_layers": 2, "generator": "resnet"},
    "runtime": {"precision": "fp32"},
}
UPDATES = ("optim.clip", "optim.adam", "ema.update")


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _u8(seed: int, size: int = S):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8))
            for _ in range(2)]


@pytest.fixture(scope="module")
def cut():
    return CUTTrainer(CUT_CONFIG)


def _traced(fn):
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.take()


def _check_tree(spans, root: str, step: int) -> dict:
    """Every span carries ``step``, lies inside its parent, and has a
    parent unless it is the root; returns {name: [spans]}."""
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [root]
    for s in spans:
        assert s.step == step, s
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
            assert p.thread == s.thread
    names = {}
    for s in spans:
        names.setdefault(s.name, []).append(s)
    return names


def _parents(names: dict, spans, name: str) -> list[str]:
    by_id = {s.id: s for s in spans}
    return sorted(by_id[s.parent].name for s in names.get(name, []))


def test_spans_are_off_by_default_and_shared():
    assert trace.span("cut.step") is trace.span("optim.adam", step=3)
    with trace.span("cut.step"):
        pass
    assert trace.take() == []


@pytest.mark.parametrize("step,r1,identity", [(0, True, True), (11, False, False)])
def test_cut_step_spans(cut, step, r1, identity):
    """Step 0 is an R1 step in the identity warmup; step 11 neither. The
    step samples its own draws."""
    state = cut.init_state(seed=1, device="cpu")
    photos, monets = _u8(step)
    _, spans = _traced(lambda: cut.train_step(state, photos, monets, step=step))
    names = _check_tree(spans, "cut.step", step)
    phases = {"cut.draws", "cut.augment", "cut.g_forward", "cut.d_step", "cut.g_head"}
    phases |= {"cut.r1"} if r1 else set()
    phases |= {"cut.identity"} if identity else set()
    assert set(names) == {"cut.step", *phases, *UPDATES}
    assert _parents(names, spans, "cut.draws") == ["cut.step"]
    for phase in phases:
        assert len(names[phase]) == 1 and _parents(names, spans, phase) == ["cut.step"]
    # D's Adam in the D step (and again in R1), G's in the root, the EMA
    # after it; each clipped
    adam_in = ["cut.d_step", "cut.step"] + (["cut.r1"] if r1 else [])
    assert _parents(names, spans, "optim.adam") == sorted(adam_in)
    assert _parents(names, spans, "optim.clip") == sorted(adam_in)
    assert _parents(names, spans, "ema.update") == ["cut.step"]


def test_cut_step_spans_with_given_draws(cut):
    state = cut.init_state(seed=1, device="cpu")
    photos, monets = _u8(5)
    draws = cut.sample_draws(torch.Generator().manual_seed(2), B)
    _, spans = _traced(lambda: cut.train_step(state, photos, monets, step=3, draws=draws))
    names = _check_tree(spans, "cut.step", 3)
    assert "cut.draws" not in names and "cut.r1" not in names and "cut.identity" in names


def test_cyclegan_step_spans():
    trainer = CycleGANTrainer(CYCLEGAN_CONFIG, steps_per_epoch=3)
    state = trainer.init_state(seed=0, device="cpu")
    state.step = 4
    a, b = _u8(7, S + 4)
    _, spans = _traced(lambda: trainer.train_step(state, a, b))
    names = _check_tree(spans, "cyclegan.step", 4)
    phases = ("cyclegan.draws", "cyclegan.augment", "cyclegan.g_loss", "cyclegan.g_backward",
              "cyclegan.d_a", "cyclegan.d_b")
    assert set(names) == {"cyclegan.step", *phases, "optim.adam"}
    for phase in phases:
        assert len(names[phase]) == 1 and _parents(names, spans, phase) == ["cyclegan.step"]
    # no clip in CycleGAN; one Adam in each update phase
    assert _parents(names, spans, "optim.adam") == ["cyclegan.d_a", "cyclegan.d_b",
                                                    "cyclegan.g_backward"]
    starts = [names[p][0].start_ns for p in phases]
    assert starts == sorted(starts)


def test_cut_step_is_bitwise_the_same_with_spans_on(cut):
    photos, monets = _u8(9)
    runs = []
    for on in (False, True):
        state = cut.init_state(seed=4, device="cpu")
        torch.manual_seed(0)
        step = lambda: cut.train_step(state, photos, monets, step=0)  # noqa: E731
        (state, losses), spans = _traced(step) if on else (step(), [])
        assert bool(spans) == on
        runs.append((losses, state))
    (l0, s0), (l1, s1) = runs
    assert l0.keys() == l1.keys() and all(torch.equal(l0[k], l1[k]) for k in l0)
    for attr in ("g_params", "d_params", "ema"):
        a, b = getattr(s0, attr), getattr(s1, attr)
        assert all(torch.equal(a[k], b[k]) for k in a), attr
    assert all(torch.equal(s0.opt_g.nu[k], s1.opt_g.nu[k]) for k in s0.opt_g.nu)


def test_spans_are_profiler_annotations_on_the_shared_clock(cut):
    """With ``enable(profiler=True)`` each span is a user annotation of the
    same name in torch.profiler's kineto events, starting within 1 ms of
    the span's own ``time.time_ns()`` start. A first range is opened and
    closed before: PyTorch sets up its record path on the first
    ``record_function`` of a process (~1 ms), which is no clock offset."""
    from torch.profiler import ProfilerActivity, profile

    state = cut.init_state(seed=1, device="cpu")
    photos, monets = _u8(2)
    trace.enable(profiler=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("first"):
                pass
        trace.take()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            cut.train_step(state, photos, monets, step=1)
    finally:
        trace.disable()
    spans = trace.take()
    annotations = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            annotations.setdefault(e.name(), []).append(e.start_ns())
    assert len(spans) >= 8
    for s in spans:
        starts = annotations.get(s.name, [])
        assert starts, s.name
        assert min(abs(t - s.start_ns) for t in starts) < 1_000_000, s


def test_spans_on_another_thread_have_no_parent_and_carry_the_step():
    """A span opened on another thread (the autograd engine's device
    thread) while a root is open has no parent there, and the root's step."""
    trace.enable()
    with trace.span("cut.step", step=7):
        with trace.span("cut.g_head"):
            t = threading.Thread(target=lambda: trace.span("trunk.dx").__enter__().__exit__())
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    with trace.span("after"):
        pass
    trace.disable()
    spans = {s.name: s for s in trace.take()}
    assert spans["trunk.dx"].parent is None and spans["trunk.dx"].step == 7
    assert spans["trunk.dx"].thread != spans["cut.g_head"].thread
    assert spans["cut.g_head"].parent == spans["cut.step"].id
    assert spans["after"].step is None


def test_counts_add_up_across_threads():
    """Counters are shared by the host thread and the autograd engine's
    device thread: no update may be lost."""
    key, threads, per = "test.trace.stress", 16, 2000
    trace.COUNTS.pop(key, None)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [trace.count(key) for _ in range(per)])
                   for _ in range(threads)]
        t0 = time.monotonic()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers) and time.monotonic() - t0 < 30
    finally:
        sys.setswitchinterval(old)
    assert trace.COUNTS.pop(key) == threads * per
