#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: serving and training,
the flagship generator and the variant one, MiFID/FID evaluation, and
CycleGAN training and serving.

    python3 chip_smoke.py

Phases, one line each:

1. device   - requires CUDA (there is no CPU fallback); prints the card's
              name and power limit as nvidia-smi gives them;
2. build    - builds the seven hand-written kernels from csrc/ (nvcc,
              sm_90a), all at once, with ptxas's spills and wgmma
              serialisation for each;
3. kernels  - each kernel against its plain PyTorch version on the card
              (TF32 off): the trunk conv, its input grad (dx) and its
              weight grad (dw), at the trunk shapes in float32 and bf16
              (also at the 512^2 trunk's (2, 128, 128, 256) and CycleGAN's
              (1|3|48, 64, 64, 256)) and at ragged
              shapes down to H, W of 2 and 3 (the forward and dw also at
              Cin 136 and 264, Cout 72 and 520, W 65 and 129), every
              forward, dx and dw route (float32 FMA, bf16 wgmma, channels
              that are not multiples of 8 zero-padded to them) named on its
              line; the forward within 2e-5 (+ 2e-5 relative, + one bf16
              ulp in bf16) of the plain version, dw within 1e-4 of the
              largest value; the forward, dw and bf16 dx run twice must be
              bitwise equal. dw's bias gradient (resblock._launch_dw with
              with_db) at every dw case, both routes: dw bitwise the one
              without it, db within 1e-6 of sum |dy| of the float64 sum of
              dy per channel, twice bitwise equal, counted trunk.dw.db. The
              attention forward, dK/dV and dQ at (B, n, d_qk, d_v) =
              (12, 4096, 32, 256) in float32 and bf16, (32, 4096,
              32, 256) and (2, 16384, 32, 256) in bf16, ragged shapes, the
              bf16 forward's tile edges (n of 4097 and 129, d_qk 8 and 64, d_v
              8 and 136) and dK/dV's (n of 127, 128, 129 and 4097 at B = 1,
              d_qk 8, 24 and 64, d_v 8, 72 and 136) and dQ's (n of 1, 63, 65,
              129, 200 and 4097, B up to 3, d_qk 8 to 64, d_v 8 to 256), and
              the d_qk-128 instance at (12, 4096, 128, 256), (12, 4096, 128,
              128) and its tile edges (2, 4097, 128, 256), (3, 129, 72, 136)
              and (2, 129, 128, 40), in float32 and bf16 (its backward on the
              first 128 columns of v, with the whole forward's lse):
              float32 within 1e-5 (forward) and 1e-4 (gradients) of the
              largest value; the bf16 forward at most twice as far from the
              float32 plain version as the bf16 plain version is; bf16 dK/dV
              and dQ within one bf16 rounding of the largest value of the
              contract version (the library's rounding points, float64 sums)
              and, by RMS, at most twice as far from the float32 plain version
              as the bf16 plain version is; each attention kernel run twice
              bitwise equal (the forward's o and lse too). tolerance: the bf16
              dK/dV and dQ over 8 input seeds at (2, 16384, 32, 256) and (12,
              4096, 32, 256), each output's error (max and RMS) against a
              float64 core and against the contract version, for the kernel,
              the plain version and the contract version with float32 sums,
              and the same check on every seed;
   norm     - the instance-norm kernels (csrc/instance_norm.cu) against
              the plain chain (ops/nn_ops.py::instance_norm, then the ReLU),
              with and without the ReLU, at every shape the cells run
              (NORM_SHAPES: the generator's stem, down and trunk outputs at
              batches 12, 32, 16 and 48, CycleGAN's D at 16) and ragged ones
              (NORM_EDGES): the Function and its counters (norm.fwd.kernel,
              norm.bwd.kernel), the forward bitwise the plain apply on the
              kernel's own statistics, and bitwise the chain in every (n, c)
              whose bf16 scale and offset both sides round alike (where the
              float32 sums, added in another order, straddle a bf16 rounding
              point, scale and offset differ by one ulp at most and y by 4
              ulps of the larger of x * scale and offset), the backward
              within 2e-2 by norm of autograd of the chain and within 2^-8
              by norm of the hand-derived backward on the kernel's own
              statistics, the backward's ReLU mask the forward's, two
              launches bitwise equal; a constant channel reported (its
              gradient is rounding noise times inv^3); forward and backward
              timed at NORM_TIMED (queued CUDA events; each kernel on the
              profiler's clock) beside the chain and the byte bounds;
4. autograd - the gradients of one float32 trunk conv and of one float32
              attention core (4, 4096, 32, 256) through their
              autograd.Functions against autograd of the plain versions;
5. serve    - the flagship CUT generator (ResNet-9, ngf 64, 9 blocks,
              bf16 compute, fp32 params; weights made from a seed with numpy
              in the JAX package's layout, converted by convert.py) serves 3
              batches of 8 seeded 256x256 photos through stylize_batch, 18
              trunk launches a batch, every one on the forward's bf16 wgmma
              route, and 23 norm forwards on the kernel route; a float32
              forward at batch 2 through
              the kernel and through the plain version agree to 1e-3.
              serve_variant: the same with self-attention after blocks 3
              and 7, channel attention after block 5 and style gates
              (gains non-zero): 18 trunk and 2 attention launches a batch,
              no backward kernel; float32 kernel vs plain to 1e-3;
6. train    - the flagship CUT step (train_gan_cutpp.yaml as FLAGSHIP_CUT:
              batch 12, 256^2, bf16, PatchGAN ndf 64 with 3 layers, DiffAugment,
              PatchNCE 256 patches on [0, 4, 8, 12, 16], R1 gamma 10 every
              16, identity warmup) runs 4 steps through CUTTrainer.train_step
              with seeded uint8 batches; step 0 is an R1 step. Every step
              launches 54 trunk forwards, 54 dx and 54 dw (3 G passes x 18
              trunk convs, each with its backward; every dw also sums the
              conv's bias gradient, trunk.dw.db) and 68 instance norms
              with their backward (23 + 22 + 23), every forward, dx and dw
              on its bf16 wgmma route, every norm on the kernel route: the
              wrappers count them on the host
              where the step's body runs there, twice on the first step of a
              graph key (eager, then the capture), never on a replay
              (cut.graph.* counters); losses finite; G, D and
              EMA moved. Then one float32 step at batch 2 through the kernels
              and through the plain versions, from one state and one set of
              draws: losses agree to 1e-4, Adam's mu per leaf to 1e-3 of the
              leaf's max. train_variant: 4 variant steps (VARIANT_CUT), each
              launching 54/54/54 trunk and 6/6/6 attention kernels (fwd, dK/dV,
              dQ: 2 blocks x 3 G passes), every trunk forward, dx and dw on
              its wgmma route;
              losses finite; the attention,
              channel-attention and style-gate parameters and their EMA
              moved. Float32 at batch 2: the variant step amplifies any
              rounding in the attention core, so the kernel path is held to
              be no farther from a float64-core path than the plain path is
              (see phase_train_variant);
   cut_graph - the flagship step graphed (CUDA graphs, CUTTrainer.train_step)
              against the same body run eagerly and run eagerly again, from
              one set of weights, batches and draws, under
              cudnn.deterministic: 34 steps (R1 on 0, 16 and 32), graph
              counters eager 2, capture 2, replay 32; every loss and every
              parameter, Adam moment and EMA leaf equal in every bit, or no
              farther from the eager path than twice the eager path's
              distance from itself plus tests/test_torch_cut_trainer.py's
              1e-4; 16 more steps timed on both paths (host ms a call, device
              ms a step from CUDA events); a state rebuilt from the graphed
              state's checkpoint payload at step 64 captures both keys anew
              and matches over 4 steps; the variant generator (VARIANT_CUT)
              over 17 steps; max_memory_allocated, max_memory_reserved and
              the graph pool's bytes;
7. timing   - trunk conv at batch 32 (serving) and 12 (the train step), dx and
              dw at batch 12, bf16, against their plain versions and cuDNN's
              bf16 calls (CUDA events), and the forward's main pass, dx's
              three kernels (frame, main, fold) and dw's two (main, reduce)
              apart on the profiler's device clock; the attention kernels at
              (12, 4096, 32, 256) bf16 against their plain versions (dQ's
              kernel also on the device clock), and the forward, the backward
              alone and forward + backward against
              scaled_dot_product_attention, and the forward at the served
              shape (32, 4096, 32, 256) against it too; a served batch of 32
              of each generator; ms per train step (warmup and R1) of each on
              the kernel path and the plain path; a torch.profiler op table of
              a served batch and of a warmup step of each, with the device's
              busy time and idle share. dw_db: dw with and without the bias
              gradient at (12|1|48, 64, 64, 256) bf16 (CUDA events: without,
              with, with, without; and each queued ahead of the device).

8. attention_widths - variant generators at ngf 8, 40, 96, 160, 256 and
              320 (d_qk 4, 20, 48, 80, 128, 160; d_v 32, 160, 384, 640,
              1024, 1280), full depth, 256^2: one served batch of 4 and one
              bf16 train step at batch 4 each, asserting the launches of each
              attention route and kernel as WIDTH_ROUTES writes them out (ngf
              8 and 40 padded, 96 split: 2 x 192; 160 split on the d_qk-128
              instance, d_qk 80 padded to 128, 3 x 216, each backward in 128
              + 88; 256 split on it, 4 x 256, each backward in 2 x 128; 320
              the einsum core, no kernel launched, counted under einsum); the
              routed core at (4, 4096, d_qk, d_v) of each width the kernels
              take against its plain version: float32 to the kernels'
              tolerances, bf16 forward by the forward's rule, bf16 backward
              by bf16_backward_check, the split route's dK and dQ within one
              bf16 rounding of each backward chunk's largest value plus one of
              the sum's (each chunk's output is rounded, then their float32
              sum once more); the split forward and backward at (12, 4096,
              48, 384) timed beside SDPA; the d_qk-128 instance at (12, 4096,
              128, 256) timed beside its plain version and SDPA, its backward
              kernels at their 128-column chunk;
9. train_run - train_cut on the flagship config (batch 12, 256^2, random
              weights from the config's seed) from a seeded folder of 60
              photo and 40 Monet JPEGs: 240 steps, an async checkpoint every
              80 (keep_last_n 2), a JSON line every 40; then --resume auto
              with max_steps 320. Asserts the checkpoint files, that
              latest_checkpoint picks ckpt_final, that the state restored
              from it equals the saved one bitwise, the resumed loader's
              first batch indices, 54/54/54 trunk launches on every step (an
              eager step of each graph key in each run, counted on the host
              at it and at its capture; replays on the other steps), finite
              losses in every CSV row and JSON line; prints steps/s, the
              share of the loop's wall time spent in next(loader), the async
              and synchronous save times and the checkpoint's size.
10. eval     - the port's MiFID/FID evaluation (evalsuite/cli.py::
              run_evaluation) on seeded folders of 7,000 fake and 300 real
              256^2 JPEGs (the Kaggle submission's minimum and the Monet
              set), Inception weights from a numpy seed (He-normal convs,
              well-conditioned BatchNorm statistics), batch 64 at 299^2 in
              float32 with TF32 off, KID and precision/recall on, run twice:
              the real-stats cache empty, then hit. Asserts finite scores,
              the cache hit with the first run's scores, the JSON report,
              text summary and worst-cases CSV in the JAX schema, the card's
              features of 64 images within 1e-4 of the largest value of the
              port's CPU features, and no hand-written kernel launched;
              prints the extractor's images/s on the card, each stage's
              seconds and the decode thread's share of the wall time.

11. cyclegan - the trunk forward, dx and dw at (1, 64, 64, 256) and (48,
              64, 64, 256) bf16 beside their plain versions, cuDNN and their
              bounds; one float32 CycleGAN step at batch 1 (the port's
              configs/baseline.yaml: bias-free ResNet-9 ngf 64, PatchGAN ndf
              64 with instance norm, 256^2 crops of 286^2, LSGAN) through the
              kernels and through the plain versions from one state and one
              set of draws: losses to 1e-4, Adam's mu per leaf to 1e-3 of the
              leaf's max; 1 + 10 bf16 steps at baseline.yaml (batch 1) and
              baseline_tpu.yaml (batch 16), each launching (no dw summing a
              bias gradient: the trunk is bias-free) 54/54/54 trunk
              kernels on their bf16 wgmma routes, and of the U-Net option
              (batch 1, no trunk launch): losses finite, all four nets moved,
              ms a step, peak memory, one profiled step's device busy time and
              idle share; cli/train_cyclegan.main on seeded folders of 48 A
              and 32 B 300^2 JPEGs (batch 4, 12 steps an epoch, a checkpoint
              every 2 epochs, 48 steps), then --resume auto to 72: the
              checkpoint names, the restored state bitwise the saved one,
              54/54/54 launches on every step, one log line an epoch, steps/s
              and the loader's wait share; cli/generate_folder.main on the last
              checkpoint in both directions over 32 photos (uint8 JPEGs of
              256^2 and the zip), and stylize_batch at batch 32 timed.

Any failure raises and exits non-zero. The second-to-last line is the
kernel table as JSON (each row's times and bound at the shape its
`launches` run at: the trunk forward's at the train step's batch 12, with
its batch-32 served time, bound and cuDNN time beside them; the attention
rows also carry the d_qk-128 instance's launches and times under
``dqk128_*``, and SDPA's backward at d_v 256 beside the port's; the trunk
rows CycleGAN's launches and times under ``cyclegan_*``); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
CONV_SHAPE = (4, 64, 64, 256)          # the trunk conv of a 256^2 serve
TRAIN_SHAPE = (12, 64, 64, 256)        # the trunk conv of a batch-12 train step
SERVE_BATCH, SERVE_BATCHES, TIME_BATCH = 8, 3, 32
FLAGSHIP = {"ngf": 64, "n_blocks": 9, "n_downsampling": 2}
TRUNK_CONVS = 2 * FLAGSHIP["n_blocks"]
TRAIN_STEPS = 4
CYCLEGAN_BATCHES = (1, 3, 48)          # trunk batches of CycleGAN's G passes
CYCLEGAN_SHAPES = tuple((n, 64, 64, 256) for n in CYCLEGAN_BATCHES)

# The keys of gan_variant_research_tpu/configs/train_gan_cutpp.yaml that the
# train step reads (core/config.py::STEP_KEYS); tests/test_torch_cut_parts.py
# holds this dict against the YAML.
FLAGSHIP_CUT = {
    "image_size": 256, "batch_size": 12, "seed": 42, "warmup_steps": 20000,
    "grad_clip_g": 10.0, "grad_clip_d": 10.0,
    "optim": {net: {"lr": 2.0e-4, "betas": [0.5, 0.999], "weight_decay": 0.0,
                    "scheduler": {"enabled": False, "type": "cosine", "lr_min": 5.0e-5}}
              for net in ("G", "D")},
    "loss_weights": {"adv": 1.0, "patchnce": 1.0, "identity_warm": 0.1,
                     "identity_final": 0.0},
    "model": {
        "generator": {"n_downsampling": 2, "n_blocks": 9, "ngf": 64, "norm": "instance",
                      "activation": "relu", "padding_type": "reflect",
                      "use_attention": False, "use_channel_attn": False,
                      "use_style_dropout": False},
        "discriminator": {"num_scales": 1, "ndf": 64, "n_layers": 3, "norm": "none",
                          "use_spectral_norm": False},
    },
    "patchnce": {"num_patches": 256, "temperature": 0.07, "nce_layers": [0, 4, 8, 12, 16]},
    "diffaugment": {"enable": True, "policy": ["color", "translation", "cutout"]},
    "r1": {"gamma": 10.0, "every": 16},
    "ema": {"decay": 0.999},
    "runtime": {"precision": "bf16", "d_real_domain": "monet"},
}

# The variant generator: the generator half of scripts/probe_variant_step.py
# (self-attention after blocks 3 and 7, channel attention after block 5,
# style dropout with alpha in [0.4, 0.9]) on the flagship CUT step.
VARIANT_G = {"use_attention": True, "attn_layers": [3, 7], "use_channel_attn": True,
             "channel_attn_layers": [5], "use_style_dropout": True,
             "style_dropout": {"alpha_min": 0.4, "alpha_max": 0.9}}
VARIANT_CUT = copy.deepcopy(FLAGSHIP_CUT)
VARIANT_CUT["model"]["generator"].update(VARIANT_G)
ATTN_BLOCKS = len(VARIANT_G["attn_layers"])
ATTN_SHAPE = (12, 4096, 32, 256)        # (B, n, d_qk, d_v) of a batch-12 step's trunk
# H100 SXM dense peaks (NVIDIA's data sheet) for the bounds
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def bf16_ulp(r: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each value (8 significant bits)."""
    mag = r.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def conv_inputs(shape, c_out, dtype, gen):
    n, h, w, c = shape
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    wt = (torch.randn((3, 3, c, c_out), device="cuda", generator=gen) / (3 * c ** 0.5)).to(dtype)
    b = torch.randn(c_out, device="cuda", generator=gen) * 0.1
    return x, wt, b


def cudnn_conv(x, w, b):
    """What stock PyTorch does in the working dtype: reflect pad, then cuDNN,
    then the bias (rounded twice in bf16, unlike the kernel's contract)."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.conv2d(xp, w.to(x.dtype).permute(3, 2, 0, 1)) + b.to(x.dtype).view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1).contiguous()


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def uniform_conv(rng, kh, c_in, c_out, fan_in):
    """A JAX conv's ``kernel`` (HWIO) and ``bias`` with PyTorch's default
    init bounds U(+-1/sqrt(fan_in))."""
    bound = 1.0 / np.sqrt(fan_in)
    return {"kernel": rng.uniform(-bound, bound, (kh, kh, c_in, c_out)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (c_out,)).astype(np.float32)}


def flagship_params(rng: np.random.Generator, ngf: int = FLAGSHIP["ngf"]) -> dict:
    """The JAX generator's param tree at the flagship depth and width ``ngf``
    (the flagship's by default), with PyTorch's default init bounds
    U(+-1/sqrt(fan_in))."""
    n_down, n_blocks = FLAGSHIP["n_downsampling"], FLAGSHIP["n_blocks"]
    conv = lambda kh, c_in, c_out, fan_in: uniform_conv(rng, kh, c_in, c_out, fan_in)
    params = {"initial_conv": conv(7, 3, ngf, 49 * 3)}
    for i in range(n_down):
        c = ngf * 2 ** i
        params[f"down_{i}"] = conv(3, c, 2 * c, 9 * c)
    c = ngf * 2 ** n_down
    for i in range(n_blocks):
        c1, c2 = conv(3, c, c, 9 * c), conv(3, c, c, 9 * c)
        params[f"res_{i}"] = {"conv1_kernel": c1["kernel"], "conv1_bias": c1["bias"],
                              "conv2_kernel": c2["kernel"], "conv2_bias": c2["bias"]}
    for i in range(n_down):
        c = ngf * 2 ** (n_down - i)
        params[f"up_{i}"] = conv(3, c, c // 2, 9 * (c // 2))
    params["output_conv"] = conv(7, ngf, 3, 49 * ngf)
    return params


def flagship_d_params(rng: np.random.Generator) -> dict:
    """The JAX PatchGAN param tree (ndf 64, 3 layers, one scale). The last
    bias is 1, so that some real logits start past the hinge margin: with
    all logits inside it, that bias has an analytic gradient of 0 and Adam
    would turn rounding noise into a full step."""
    ndf, n_layers = 64, 3
    chans = [3] + [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
    scale = {f"conv_{n}": uniform_conv(rng, 4, chans[n], chans[n + 1], 16 * chans[n])
             for n in range(n_layers + 1)}
    scale["conv_out"] = uniform_conv(rng, 4, chans[-1], 1, 16 * chans[-1])
    scale["conv_out"]["bias"][:] = 1.0
    return {"scale_0": scale}


@contextlib.contextmanager
def trunk_conv(resblock, fn):
    """Route the trunk through ``fn`` (a plain version) for a comparison."""
    real = resblock.reflect_conv3x3
    resblock.reflect_conv3x3 = fn
    try:
        yield
    finally:
        resblock.reflect_conv3x3 = real


def drop_counts(prefix: str) -> None:
    """Set the launch counters under ``prefix`` to 0."""
    from gan_variant_research_tpu_torch.core import trace

    for key in [k for k in trace.COUNTS if k.startswith(prefix)]:
        del trace.COUNTS[key]


def route_counts(resblock) -> dict:
    """{op: {route: launches}} of the trunk's forward, dx and dw, read from
    ``trace.COUNTS``."""
    from gan_variant_research_tpu_torch.core import trace

    return {op: {r: trace.COUNTS.get(f"trunk.{op}.{r}", 0) for r in resblock.TRUNK_ROUTES}
            for op in ("fwd", "dx", "dw")}


def counts(resblock) -> tuple[int, int, int]:
    """The trunk's forward, dx and dw launches over every route."""
    return tuple(sum(by_route.values()) for by_route in route_counts(resblock).values())


def reset_counts(resblock) -> None:
    drop_counts("trunk.")


def db_count() -> int:
    """dw launches that also summed the bias gradient (``trunk.dw.db``)."""
    from gan_variant_research_tpu_torch.core import trace

    return trace.COUNTS.get("trunk.dw.db", 0)


def check_routes(resblock, before: dict, want: dict, what: str) -> None:
    """Every trunk forward, dx and dw launched since ``before``
    (``route_counts``) took its bf16 wgmma route: ``want[op]`` launches of
    each op, all on that route."""
    for op, now in route_counts(resblock).items():
        got = {k: v - before[op][k] for k, v in now.items()}
        check(got == dict(dict.fromkeys(now, 0), bf16_wgmma=want[op]),
              f"{what}: {op} launches by route {got}, want {want[op]} on bf16_wgmma")


GRAPH_COUNTERS = ("eager", "capture", "replay")


def graph_counts() -> dict:
    """``cut.graph.{eager,capture,replay}`` from ``trace.COUNTS``."""
    from gan_variant_research_tpu_torch.core import trace

    return {k: trace.COUNTS.get(f"cut.graph.{k}", 0) for k in GRAPH_COUNTERS}


def graph_delta(before: dict) -> dict:
    now = graph_counts()
    return {k: now[k] - before[k] for k in GRAPH_COUNTERS}


def host_runs(ran: dict, what: str) -> int:
    """How many times a CUT step ran its body on the host, from its
    ``graph_delta``: 2 on the first step of a key (eager, then the capture,
    which launches nothing on the card), 0 on a replay. The wrappers count a
    kernel's launch on the host, so a step's counts are its launches times
    this; the card runs them once a step either way."""
    check(ran["eager"] + ran["replay"] == 1 and ran["capture"] == ran["eager"],
          f"{what}: the step ran {ran}, want one eager step with its capture or one replay")
    return ran["eager"] + ran["capture"]


def before_instance_norm(name: str) -> bool:
    """G's conv biases that an instance norm follows: analytic gradient 0."""
    return name.endswith("bias") and not name.startswith("output_conv")


# --------------------------------------------------------------------------- #

def phase_build() -> None:
    from gan_variant_research_tpu_torch.ops.kernels import _build

    builds = {name: functools.partial(_build.kernel, name) for name in _build.KERNELS}

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        for name, fut in futures.items():
            seconds = fut.result()
            # ptxas's report: spilled bytes over all entries, and whether it
            # serialised any wgmma (warnings C7510-C7515; C7517 and C7519 only
            # note a wait or fence it added)
            log = _build.library_path(name).with_suffix(".log").read_text()
            spills = sum(map(int, re.findall(r"(\d+) bytes spill stores", log)))
            phase("build", kernel=name, seconds=f"{seconds:.2f}", spill_store_bytes=spills,
                  wgmma_serialized=bool(re.search(r"\(C751[0-5]\)", log)),
                  library=_build.library_path(name).relative_to(REPO))


def phase_kernels(gen) -> dict:
    from gan_variant_research_tpu_torch.ops.kernels import resblock

    errs = {}
    # forward routes: float32 FMA; bf16 wgmma (the trunks of
    # train_gan_cutpp.yaml at serve and train batches, and of _512.yaml; Cin
    # past 64-channel chunks (136, 264) and Cout past 256-wide tiles (520)
    # or short of them (72); W past 64-pixel segments (65, 129: the last
    # segment one pixel wide, its reflect target in the box's first slot);
    # H, W of 2 and 3 (the row reflect folds back into the tile); one
    # 64-channel chunk and about four tiles a block (the x stage that holds
    # a tile's output is the one the tile after next loads); channels padded
    # to 8 (Cin 130 and 13, Cout 70 and 21))
    cases = [(CONV_SHAPE, 256, torch.float32), (CONV_SHAPE, 256, torch.bfloat16),
             (TRAIN_SHAPE, 256, torch.bfloat16), ((2, 128, 128, 256), 256, torch.bfloat16),
             ((16, 64, 64, 64), 64, torch.bfloat16),
             ((2, 5, 7, 40), 40, torch.float32), ((2, 5, 7, 40), 40, torch.bfloat16),
             ((3, 17, 33, 130), 70, torch.float32), ((3, 17, 33, 130), 70, torch.bfloat16),
             ((3, 17, 33, 136), 72, torch.bfloat16), ((2, 9, 9, 264), 520, torch.bfloat16),
             ((2, 5, 65, 16), 24, torch.bfloat16), ((1, 3, 129, 8), 8, torch.bfloat16),
             ((2, 2, 2, 16), 24, torch.bfloat16), ((1, 3, 2, 8), 8, torch.bfloat16),
             ((2, 2, 3, 13), 21, torch.float32), ((2, 2, 3, 13), 21, torch.bfloat16),
             ((1, 3, 3, 8), 16, torch.bfloat16)]
    # the CycleGAN trunks: batch 1 and 3 (baseline.yaml's passes) and 48
    # (baseline_tpu.yaml's largest), on a generator of their own, so that
    # every other case here and in the phases after keeps its inputs
    cases += [((n, 64, 64, 256), 256, dtype) for n in CYCLEGAN_BATCHES
              for dtype in (torch.float32, torch.bfloat16)]
    cg_gen = torch.Generator(device="cuda").manual_seed(13)
    case_gen = lambda shape: cg_gen if shape in CYCLEGAN_SHAPES else gen  # noqa: E731
    for shape, c_out, dtype in cases:
        x, w, b = conv_inputs(shape, c_out, dtype, case_gen(shape))
        route = resblock.trunk_route(dtype)
        before = route_counts(resblock)["fwd"]
        y = resblock.reflect_conv3x3(x, w, b)
        y2 = resblock.reflect_conv3x3(x, w, b)
        torch.cuda.synchronize()
        check(route_counts(resblock)["fwd"][route] - before[route] == 2,
              f"reflect_conv3x3 {shape} {dtype}: not launched on {route}")
        r = resblock.reflect_conv3x3_reference(x, w, b)
        check(y.dtype == dtype and y.shape == r.shape, f"{shape} {dtype}: bad output")
        d = (y.float() - r.float()).abs()
        # float32 sums of 9*Cin exact products, in another order (and, for
        # bf16, through the tensor cores' accumulator)
        tol = 2e-5 + 2e-5 * r.float().abs()
        if dtype == torch.bfloat16:
            # each side rounds its float32 sum once: one bf16 ulp apart at most
            tol = tol + bf16_ulp(r)
        bad = int((d > tol).sum())
        errs[("fwd", shape, dtype)] = float(d.max())
        phase("kernel", name="reflect_conv3x3", route=route, shape="x".join(map(str, shape)),
              c_out=c_out, dtype=str(dtype).split(".")[-1], max_abs_err=f"{d.max().item():.3e}",
              differing=f"{(d > 0).float().mean().item():.5f}", over_tol=bad,
              bitwise_repeatable=bool(torch.equal(y, y2)))
        check(bad == 0, f"reflect_conv3x3 {shape} {dtype}: {bad} values over tolerance")
        check(torch.equal(y, y2), f"reflect_conv3x3 {shape} {dtype}: two runs differ")

    # dx and dw routes: float32 FMA; bf16 wgmma (the trunks of
    # train_gan_cutpp.yaml and _512.yaml; dx: Cin past one 256-wide block,
    # Cout past 64-wide K-stages; dw: Cin past 128-wide blocks (136, 264) and
    # their second 64-channel box, Cout past them (72, 520), W past 64-pixel
    # segments (65, 129); channels padded to 8 (Cin 130, Cout 21), ragged
    # planes, H, W of 2 and 3)
    grad_cases = [(TRAIN_SHAPE, 256, torch.float32), (TRAIN_SHAPE, 256, torch.bfloat16),
                  ((2, 128, 128, 256), 256, torch.float32),
                  ((2, 128, 128, 256), 256, torch.bfloat16),
                  ((3, 17, 33, 130), 70, torch.float32), ((3, 17, 33, 130), 70, torch.bfloat16),
                  ((3, 17, 33, 136), 72, torch.bfloat16), ((2, 9, 9, 264), 512, torch.bfloat16),
                  ((2, 9, 9, 264), 520, torch.bfloat16), ((2, 5, 65, 16), 24, torch.bfloat16),
                  ((1, 3, 129, 8), 8, torch.bfloat16),
                  ((2, 2, 3, 13), 21, torch.float32), ((2, 2, 3, 13), 21, torch.bfloat16),
                  ((1, 3, 2, 8), 8, torch.float32), ((1, 3, 2, 8), 8, torch.bfloat16),
                  ((2, 2, 2, 16), 24, torch.bfloat16)]
    grad_cases += [((n, 64, 64, 256), 256, dtype) for n in CYCLEGAN_BATCHES
                   for dtype in (torch.float32, torch.bfloat16)]
    for shape, c_out, dtype in grad_cases:
        x, w, _ = conv_inputs(shape, c_out, dtype, case_gen(shape))
        dy = torch.randn(shape[:3] + (c_out,), device="cuda",
                         generator=case_gen(shape)).to(dtype)
        route = resblock.trunk_route(dtype)
        label = dict(shape="x".join(map(str, shape)), c_out=c_out, dtype=str(dtype).split(".")[-1])

        before = route_counts(resblock)["dx"]
        dx = resblock.reflect_conv3x3_dx(dy, w)
        dx2 = resblock.reflect_conv3x3_dx(dy, w)
        torch.cuda.synchronize()
        check(route_counts(resblock)["dx"][route] - before[route] == 2,
              f"dx {shape} {dtype}: not launched on {route}")
        r = resblock.reflect_conv3x3_dx_reference(dy, w)
        check(dx.dtype == dtype and dx.shape == x.shape, f"dx {shape} {dtype}: bad output")
        d = (dx.float() - r.float()).abs()
        # float32 sums and fold in another order: 2e-5 of the largest value;
        # in bf16 both sides round once, so one bf16 ulp more
        tol = 2e-5 * r.float().abs().max()
        if dtype == torch.bfloat16:
            tol = tol + bf16_ulp(r)
        bad = int((d > tol).sum())
        errs[("dx", shape, dtype)] = float(d.max())
        phase("kernel", name="reflect_conv3x3_dx", route=route, **label,
              max_abs_err=f"{d.max().item():.3e}",
              differing=f"{(d > 0).float().mean().item():.5f}", over_tol=bad,
              bitwise_repeatable=bool(torch.equal(dx, dx2)))
        check(bad == 0, f"reflect_conv3x3_dx {shape} {dtype}: {bad} values over tolerance")
        check(torch.equal(dx, dx2), f"reflect_conv3x3_dx {shape} {dtype}: two runs differ")

        before = route_counts(resblock)["dw"]
        dw = resblock.reflect_conv3x3_dw(x, dy)
        dw2 = resblock.reflect_conv3x3_dw(x, dy)
        torch.cuda.synchronize()
        check(route_counts(resblock)["dw"][route] - before[route] == 2,
              f"dw {shape} {dtype}: not launched on {route}")
        r = resblock.reflect_conv3x3_dw_reference(x, dy)
        check(dw.dtype == torch.float32 and dw.shape == r.shape, f"dw {shape} {dtype}: bad output")
        # float32 sums over N*H*W products in another order
        d = (dw - r).abs()
        rel = float(d.max() / r.abs().max())
        errs[("dw", shape, dtype)] = float(d.max())
        phase("kernel", name="reflect_conv3x3_dw", route=route, **label,
              max_abs_err=f"{d.max().item():.3e}",
              rel_to_max=f"{rel:.3e}", bitwise_repeatable=bool(torch.equal(dw, dw2)))
        check(rel <= 1e-4, f"reflect_conv3x3_dw {shape} {dtype}: {rel} of max over 1e-4")
        check(torch.equal(dw, dw2), f"reflect_conv3x3_dw {shape} {dtype}: two runs differ")

        # the same kernel with the bias gradient: dw unchanged, db the sum
        # of dy's exact values (float32 sums in another order than float64's)
        before_db = db_count()
        dw3, db = resblock._launch_dw(x, dy, with_db=True)
        dw4, db2 = resblock._launch_dw(x, dy, with_db=True)
        torch.cuda.synchronize()
        check(db_count() - before_db == 2, f"dw+db {shape} {dtype}: not counted trunk.dw.db")
        r_db = dy.double().sum(dim=(0, 1, 2))
        scale = dy.double().abs().sum(dim=(0, 1, 2))
        d_db = (db.double() - r_db).abs() / scale
        errs[("db", shape, dtype)] = float(d_db.max())
        phase("kernel", name="reflect_conv3x3_dw+db", route=route, **label,
              db_max_err_over_abs_sum=f"{d_db.max().item():.3e}",
              dw_bitwise_without_db=bool(torch.equal(dw3, dw)),
              bitwise_repeatable=bool(torch.equal(db, db2) and torch.equal(dw3, dw4)))
        check(db.dtype == torch.float32 and db.shape == (c_out,), f"db {shape} {dtype}: bad output")
        check(torch.equal(dw3, dw), f"dw+db {shape} {dtype}: dw differs from dw without db")
        check(float(d_db.max()) <= 1e-6, f"db {shape} {dtype}: {float(d_db.max())} of sum |dy|")
        check(torch.equal(db, db2) and torch.equal(dw3, dw4),
              f"dw+db {shape} {dtype}: two runs differ")
    return errs


# Every shape the cells run the norm at: the ResNet generator's stem / up_1,
# down_0 / up_0 and down_1 / trunk outputs at the CUT batch 12, the served
# batch 32 and CycleGAN's G batches 16, 32 and 48; CycleGAN's D at batch 16.
NORM_SHAPES = tuple((n, 256 // 2 ** i, 256 // 2 ** i, 64 * 2 ** i)
                    for n in (12, 32, 16, 48) for i in range(3)) + (
    (16, 64, 64, 128), (16, 32, 32, 256), (16, 31, 31, 512))
# ragged shapes: C not a multiple of 8 (one channel a thread), C past one
# block of 256 channels, H * W under a block's rows
NORM_EDGES = ((1, 4, 4, 3), (2, 31, 31, 24), (3, 5, 7, 520), (2, 9, 9, 136), (1, 2, 2, 8),
              (2, 3, 3, 1000))
NORM_TIMED = ((12, 64, 64, 256), (12, 256, 256, 64), (32, 64, 64, 256), (32, 256, 256, 64))
NORM_KERNELS = {"fwd": ("inorm_fwd_stats", "inorm_fwd_finalize", "inorm_fwd_apply"),
                "bwd": ("inorm_bwd_stats", "inorm_bwd_finalize", "inorm_bwd_apply")}
NORM_FLAGSHIP_STEP = 23 + 22 + 23      # full, taps-only and identity passes
NORM_SERVED_BATCH = 23


def norm_chain(x, relu):
    from gan_variant_research_tpu_torch.ops import nn_ops

    y = nn_ops.instance_norm(x)
    return torch.relu(y) if relu else y


def norm_counts() -> dict:
    from gan_variant_research_tpu_torch.core import trace

    return {f"{d}.{r}": trace.COUNTS.get(f"norm.{d}.{r}", 0)
            for d in ("fwd", "bwd") for r in ("kernel", "plain")}


def check_norm_counts(before: dict, fwd: int, bwd: int, what: str) -> dict:
    """The norm counters' deltas since ``before``, checked against ``fwd``
    and ``bwd`` kernel calls and no plain one; returns the deltas read."""
    got = {k: v - before[k] for k, v in norm_counts().items()}
    want = {"fwd.kernel": fwd, "fwd.plain": 0, "bwd.kernel": bwd, "bwd.plain": 0}
    check(got == want, f"{what}: norm calls by route {got}, want {want}")
    return got


def norm_device_launches(prof) -> dict | None:
    """How many times each norm kernel ran on the card in a torch.profiler
    session (its device events), by direction: ``{"fwd": n, "bwd": n}``,
    the three kernels of a direction checked to have run alike; None if the
    session holds no device event at all (the tracer now and then returns
    none, ``kernel_device_us``)."""
    from torch.autograd import DeviceType

    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not names:
        return None
    ran = {k: sum(k in n for n in names) for ks in NORM_KERNELS.values() for k in ks}
    out = {}
    for d, ks in NORM_KERNELS.items():
        check(len({ran[k] for k in ks}) == 1, f"norm {d} kernels ran unalike: {ran}")
        out[d] = ran[ks[0]]
    return out


def larger_term_ulps(got, want, terms) -> float:
    """The largest |got - want| in bf16 ulps of the larger of ``terms``
    (the two values each result is rounded from)."""
    larger = torch.maximum(terms[0].float().abs(), terms[1].float().abs())
    return float(((got.float() - want.float()).abs() / bf16_ulp(larger)).max())


def norm_forward_vs_chain(x, y, yp, stats, sp, relu, eps) -> dict:
    """The kernel's forward ``y`` against its contract on its own statistics
    ``stats`` (bitwise) and against the chain's ``yp``: bitwise in each (n, c)
    whose bf16 scale and offset the two statistics round alike; where the
    float32 sums (added in another order, ~1e-7 apart) straddle a bf16
    rounding point, the two scales and offsets lie one bf16 ulp apart at
    most, and y within 4 ulps of the larger of x * scale and offset (2 from
    x * scale, 1 from the offset, 1 from rounding y)."""
    from gan_variant_research_tpu_torch.ops.kernels import instance_norm as inm

    scale_k, offset_k, _, _ = inm._scale_offset(x, stats, eps)
    scale_p, offset_p, _, _ = inm._scale_offset(x, sp, eps)
    flipped = (scale_k != scale_p) | (offset_k != offset_p)
    alike = ~flipped.expand_as(x)
    step = max(larger_term_ulps(scale_k, scale_p, (scale_k, scale_p)),
               larger_term_ulps(offset_k, offset_p, (offset_k, offset_p)))
    contract = inm.instance_norm_apply_reference(x, stats, relu, eps)
    return {"contract_bitwise": torch.equal(y, contract),
            "alike_bitwise": torch.equal(y[alike], yp[alike]),
            "flipped": int(flipped.sum()), "channels": flipped.numel(), "coef_ulps": step,
            "ulps": larger_term_ulps(y, yp, (x * scale_p, offset_p.expand_as(x)))}


def check_norm_forward(f: dict, what: str) -> None:
    check(f["contract_bitwise"], f"{what}: forward not bitwise its contract on its statistics")
    check(f["alike_bitwise"], f"{what}: forward not bitwise the chain where scale and offset agree")
    check(f["flipped"] <= max(1, f["channels"] // 100) and f["coef_ulps"] <= 1.0
          and f["ulps"] <= 4.0,
          f"{what}: {f['flipped']} of {f['channels']} (n, c) round scale or offset otherwise "
          f"({f['coef_ulps']} ulps), forward {f['ulps']} ulps from the chain")


def phase_norm(gen) -> dict:
    """The norm kernels against the plain chain at every shape the cells
    run, forward and backward, with and without the ReLU; bitwise repeats;
    then times at NORM_TIMED. Returns {shape: times}."""
    from gan_variant_research_tpu_torch.ops.kernels import instance_norm as inm

    eps = 1e-5
    worst = {"fwd_ulps": 0.0, "bwd_rel": 0.0, "bwd_ulps": 0.0, "bwd_rel_contract": 0.0}
    for shape in NORM_SHAPES + NORM_EDGES:
        x = (torch.randn(shape, device="cuda", generator=gen) * 1.3 + 0.2).bfloat16()
        g = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        for relu in (False, True):
            before = norm_counts()
            xr = x.clone().requires_grad_()
            y = inm.instance_norm(xr, relu=relu)
            dx, = torch.autograd.grad(y, xr, g)
            y = y.detach()
            check_norm_counts(before, 1, 1, f"norm {shape} relu={relu}")
            _, y2, stats = inm._launch_forward(x, eps, relu)
            dx2 = inm._launch_backward(g, x, stats, eps, relu)
            check(torch.equal(y, y2) and torch.equal(dx, dx2),
                  f"norm {shape} relu={relu}: two launches differ")
            xp = x.clone().requires_grad_()
            yp = norm_chain(xp, relu)
            dxp, = torch.autograd.grad(yp, xp, g)
            sp = inm.instance_norm_stats_reference(x)
            yp = yp.detach()
            fwd = norm_forward_vs_chain(x, y, yp, stats, sp, relu, eps)
            fwd_ulps = fwd["ulps"]
            bwd_rel = float((dx.float() - dxp.float()).norm() / dxp.float().norm())
            # against the hand-derived backward on the kernel's own statistics
            # and the forward's ReLU mask (the kernel's own mask is that mask),
            # by norm, and in ulps of the largest of g' * scale, a and b * x
            # (reported): G1 and G2 are rounded to bf16 (as autograd's
            # sum_to_size leaves them) after float32 sums in another order,
            # and where d_scale and d_offset * mean cancel, one such rounding
            # moves a and b by more than their own ulp
            kept = g if not relu else torch.where(y > 0, g, torch.zeros_like(g))
            contract = inm.instance_norm_backward_reference(kept, x, stats, False, eps)
            check(not relu or torch.equal(dx, inm._launch_backward(kept, x, stats, eps, False)),
                  f"norm {shape}: the backward's ReLU mask is not the forward's")
            _, scale_k, a, b = inm.backward_terms(kept, x, stats, False, eps)
            largest = torch.maximum(torch.maximum((kept.float() * scale_k.float()).abs(),
                                                  a.abs().expand(x.shape)),
                                    (b * x.float()).abs())
            bwd_ulps = larger_term_ulps(dx, contract, (largest, largest))
            bwd_rel_contract = float((dx.float() - contract.float()).norm()
                                     / contract.float().norm())
            stat_rel = float(((stats - sp).abs() / sp.abs().clamp_min(1e-6))[:, 0].max())
            phase("norm", shape="x".join(map(str, shape)), relu=relu,
                  fwd_bitwise_share=f"{float((y == yp).float().mean()):.6f}",
                  fwd_max_ulps_of_larger_term=f"{fwd_ulps:.2f}",
                  fwd_nc_rounded_otherwise=f"{fwd['flipped']}/{fwd['channels']}",
                  mean_max_rel=f"{stat_rel:.2e}", bwd_rel_norm_vs_plain=f"{bwd_rel:.3e}",
                  bwd_rel_norm_vs_contract=f"{bwd_rel_contract:.3e}",
                  bwd_max_ulps_vs_contract=f"{bwd_ulps:.2f}", repeat="bitwise")
            check_norm_forward(fwd, f"norm {shape} relu={relu}")
            check(bwd_rel <= 2e-2, f"norm {shape}: backward {bwd_rel} from the plain chain")
            check(bwd_rel_contract <= 2.0 ** -8,
                  f"norm {shape}: backward {bwd_rel_contract} from its contract")
            worst = {k: max(worst[k], v) for k, v in
                     (("fwd_ulps", fwd_ulps), ("bwd_rel", bwd_rel), ("bwd_ulps", bwd_ulps),
                      ("bwd_rel_contract", bwd_rel_contract))}
            del xr, y, dx, y2, dx2, xp, yp, dxp, contract, kept, a, b, largest
        del x, g
        torch.cuda.empty_cache()
    phase("norm", cases=2 * len(NORM_SHAPES + NORM_EDGES),
          **{f"worst_{k}": f"{v:.3e}" for k, v in worst.items()})

    # a constant channel: the variance is rounding alone and the gradient
    # scales with inv^3 (~3e7), so kernel and chain, each on its own float32
    # sums, agree in the forward only; reported, and held finite
    x = (torch.randn(NORM_TIMED[0], device="cuda", generator=gen) * 1.3 + 0.2).bfloat16()
    x[..., 0] = 0.7
    g = torch.randn(x.shape, device="cuda", generator=gen).bfloat16()
    for relu in (False, True):
        _, y, stats = inm._launch_forward(x, eps, relu)
        dx = inm._launch_backward(g, x, stats, eps, relu)
        xp = x.clone().requires_grad_()
        yp = norm_chain(xp, relu)
        dxp, = torch.autograd.grad(yp, xp, g)
        sp = inm.instance_norm_stats_reference(x)
        fwd = norm_forward_vs_chain(x, y, yp.detach(), stats, sp, relu, eps)
        rest = float((dx[..., 1:].float() - dxp[..., 1:].float()).norm()
                     / dxp[..., 1:].float().norm())
        phase("norm", case="constant_channel", shape="x".join(map(str, x.shape)), relu=relu,
              var_kernel=f"{float(stats[0, 1, 0]):.3e}", var_plain=f"{float(sp[0, 1, 0]):.3e}",
              fwd_max_ulps_of_larger_term=f"{fwd['ulps']:.2f}",
              fwd_nc_rounded_otherwise=f"{fwd['flipped']}/{fwd['channels']}",
              dx_channel0_max_kernel=f"{float(dx[..., 0].float().abs().max()):.3e}",
              dx_channel0_max_plain=f"{float(dxp[..., 0].float().abs().max()):.3e}",
              bwd_rel_norm_other_channels=f"{rest:.3e}")
        check_norm_forward(fwd, f"norm constant channel relu={relu}")
        check(bool(torch.isfinite(dx).all()), f"norm constant channel relu={relu}: dx not finite")
    del x, g, dx, dxp, xp, yp

    times = {}
    for shape in NORM_TIMED:
        x = (torch.randn(shape, device="cuda", generator=gen) * 1.3 + 0.2).bfloat16()
        g = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        _, _, stats = inm._launch_forward(x, eps, True)
        numel = x.numel()
        row = {"fwd": queued_us(lambda: inm._launch_forward(x, eps, True)) / 1e3,
               "bwd": queued_us(lambda: inm._launch_backward(g, x, stats, eps, True)) / 1e3}
        def plain_fwd():
            with torch.no_grad():
                norm_chain(x, True)

        def plain_both():
            xr = x.detach().requires_grad_()
            torch.autograd.grad(norm_chain(xr, True), xr, g)

        def kernel_both():
            xr = x.detach().requires_grad_()
            torch.autograd.grad(inm.instance_norm(xr, relu=True), xr, g)

        row["plain_fwd"] = queued_us(plain_fwd, 10) / 1e3
        row["plain_fwd_bwd"] = queued_us(plain_both, 10) / 1e3
        row["fwd_bwd"] = queued_us(kernel_both, 10) / 1e3
        # bound: each input byte read once, each output written once; and the
        # bytes this design moves (x read twice forward, g and x twice backward)
        row["bound_fwd"] = 4 * numel / PEAK_BYTES * 1e3
        row["bound_bwd"] = 6 * numel / PEAK_BYTES * 1e3
        row["moved_fwd"] = 6 * numel / PEAK_BYTES * 1e3
        row["moved_bwd"] = 10 * numel / PEAK_BYTES * 1e3
        phase("timing", op="instance_norm_relu", shape="x".join(map(str, shape)), dtype="bf16",
              splits=inm.norm_splits(shape, torch.cuda.get_device_properties(0).multi_processor_count),
              fwd_ms=f"{row['fwd']:.4f}", bwd_ms=f"{row['bwd']:.4f}",
              fwd_bwd_ms=f"{row['fwd_bwd']:.4f}", plain_fwd_ms=f"{row['plain_fwd']:.4f}",
              plain_fwd_bwd_ms=f"{row['plain_fwd_bwd']:.4f}",
              fwd_share_of_bound=f"{row['bound_fwd'] / row['fwd']:.3f}",
              bwd_share_of_bound=f"{row['bound_bwd'] / row['bwd']:.3f}",
              fwd_share_of_moved=f"{row['moved_fwd'] / row['fwd']:.3f}",
              bwd_share_of_moved=f"{row['moved_bwd'] / row['bwd']:.3f}")
        times[shape] = row
        del x, g, stats
        torch.cuda.empty_cache()
    return times


def phase_norm_parts(gen) -> None:
    """The norm's kernels apart, on the device clock (torch.profiler), at
    the timed shapes with the ReLU. Run last: a CUT graph captured during
    or after a profiler session can crash the host at a replay after a
    later session and another capture (PyTorch's tracer, with or without
    these kernels), so the smoke profiles only once its long-lived graphs
    are captured."""
    from gan_variant_research_tpu_torch.ops.kernels import instance_norm as inm

    eps = 1e-5
    for shape in NORM_TIMED:
        x = (torch.randn(shape, device="cuda", generator=gen) * 1.3 + 0.2).bfloat16()
        g = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        _, _, stats = inm._launch_forward(x, eps, True)
        parts = {}
        for d, fn in (("fwd", lambda: inm._launch_forward(x, eps, True)),
                      ("bwd", lambda: inm._launch_backward(g, x, stats, eps, True))):
            for k, v in kernel_device_us(fn, 20, {k: k for k in NORM_KERNELS[d]}).items():
                parts[f"{k}_ms"] = f"{v / 1e3:.4f}"
        phase("timing", op="instance_norm_relu_parts", shape="x".join(map(str, shape)),
              dtype="bf16", **parts)
        del x, g, stats
        torch.cuda.empty_cache()


def phase_autograd(gen) -> None:
    from gan_variant_research_tpu_torch.ops.kernels import resblock

    x, w, b = conv_inputs((4, 64, 64, 256), 256, torch.float32, gen)
    g = torch.randn((4, 64, 64, 256), device="cuda", generator=gen)
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    y = resblock.reflect_conv3x3(*leaves)
    check(type(y.grad_fn).__name__ == "_ReflectConv3x3Backward", f"grad_fn {y.grad_fn}")
    got = torch.autograd.grad(y, leaves, g)
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(resblock.reflect_conv3x3_reference(*leaves), leaves, g)
    rels = [float((a - e).abs().max() / e.abs().max()) for a, e in zip(got, want)]
    phase("autograd", shape="4x64x64x256", dtype="float32",
          **{f"{n}_rel_to_max": f"{r:.3e}" for n, r in zip(("dx", "dw", "db"), rels)})
    check(max(rels) <= 1e-4, f"trunk conv gradients differ from autograd: {rels}")


def phase_serve(rng):
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.convert import generator_state_dict_from_jax
    from gan_variant_research_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.train.cut_trainer import build_generator

    net = build_generator(FLAGSHIP, DEFAULT_POLICY)
    net.load_state_dict(generator_state_dict_from_jax(flagship_params(rng)))
    net = net.to("cuda").eval()
    photos = [torch.from_numpy(rng.integers(0, 256, (SERVE_BATCH, 256, 256, 3), dtype=np.uint8))
              .cuda() for _ in range(SERVE_BATCHES)]
    torch.cuda.synchronize()
    reset_counts(resblock)
    served = []
    for u8 in photos:
        before, routes, norms = counts(resblock)[0], route_counts(resblock), norm_counts()
        out = stylize_batch(net, u8)
        torch.cuda.synchronize()
        check_norm_counts(norms, NORM_SERVED_BATCH, 0, "flagship batch")
        fwd = counts(resblock)[0] - before
        check(fwd == TRUNK_CONVS, f"{fwd} trunk launches in a batch, want {TRUNK_CONVS}")
        check_routes(resblock, routes, {"fwd": TRUNK_CONVS, "dx": 0, "dw": 0}, "flagship batch")
        served.append(out)
    launches = counts(resblock)
    check(launches[1:] == (0, 0), f"serving launched backward kernels: {launches}")
    for out in served:
        check(out.dtype == torch.uint8 and tuple(out.shape) == (SERVE_BATCH, 256, 256, 3),
              f"served {out.dtype} {tuple(out.shape)}")
        check(float(out.float().std()) > 1.0, "served images are flat")
    with trunk_conv(resblock, resblock.reflect_conv3x3_reference):
        plain_served = stylize_batch(net, photos[0])
    level = (served[0].int() - plain_served.int()).abs()
    phase("serve", model="resnet9-ngf64-9blocks", dtype="bf16", batches=SERVE_BATCHES,
          batch=SERVE_BATCH, launches=launches[0], fwd_route="bf16_wgmma",
          uint8_vs_plain_identical=f"{(level == 0).float().mean().item():.5f}",
          uint8_vs_plain_max_levels=int(level.max()))

    net32 = build_generator(FLAGSHIP, FP32_POLICY)
    net32.load_state_dict(net.state_dict())
    net32 = net32.to("cuda").eval()
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        y_kernel = net32(x)
        with trunk_conv(resblock, resblock.reflect_conv3x3_reference):
            y_plain = net32(x)
    torch.cuda.synchronize()
    fp32_err = float((y_kernel - y_plain).abs().max())
    check(bool(torch.isfinite(y_kernel).all()), "non-finite generator output")
    phase("serve", model="resnet9-ngf64-9blocks", dtype="fp32", batch=2,
          tanh_max_abs_diff_vs_plain=f"{fp32_err:.3e}")
    check(fp32_err <= 1e-3, f"fp32 forward differs from the plain path by {fp32_err}")
    return net, launches[0]


def phase_train(rng, g_tree, d_tree):
    """4 bf16 steps at batch 12, then the fp32 kernel-vs-plain step."""
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    cfg = FLAGSHIP_CUT
    b, s = cfg["batch_size"], cfg["image_size"]
    trainer = CUTTrainer(cfg)
    state = trainer.state_from_jax(g_tree, d_tree, device="cuda")
    start = {k: {n: t.detach().clone() for n, t in getattr(state, k).items()}
             for k in ("g_params", "d_params", "ema")}
    batches = [(torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda(),
                torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda())
               for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    want = (3 * TRUNK_CONVS,) * 3
    reset_counts(resblock)
    r1_values = []
    for photos, monets in batches:
        before, routes, ran = counts(resblock), route_counts(resblock), graph_counts()
        norms, dbs = norm_counts(), db_count()
        state, losses = trainer.train_step(state, photos, monets)
        torch.cuda.synchronize()
        step_counts = tuple(a - c for a, c in zip(counts(resblock), before))
        ran = graph_delta(ran)
        host = host_runs(ran, "flagship step")
        check_routes(resblock, routes, dict.fromkeys(routes, host * 3 * TRUNK_CONVS),
                     "flagship step")
        dbs = db_count() - dbs
        check(dbs == host * 3 * TRUNK_CONVS,
              f"flagship step: {dbs} dw launches summed db, want {host} x {3 * TRUNK_CONVS}")
        host_norms = check_norm_counts(norms, host * NORM_FLAGSHIP_STEP,
                                       host * NORM_FLAGSHIP_STEP, "flagship step")
        vals = {k: float(v) for k, v in losses.items()}
        r1_values.append(vals["r1"])
        check(all(np.isfinite(v) for v in vals.values()), f"non-finite losses {vals}")
        phase("train", step=state.step - 1, r1_step=trainer.step_flags(state.step - 1)[0],
              graph="replay" if ran["replay"] else "eager+capture",
              host_launches_fwd_dx_dw="/".join(map(str, step_counts)), host_dw_db=dbs,
              host_norm_fwd_bwd=f"{host_norms['fwd.kernel']}/{host_norms['bwd.kernel']}",
              fwd_dx_dw_route="bf16_wgmma",
              **{k: f"{v:.5f}" for k, v in vals.items() if k in
                 ("d_loss", "g_loss", "g_adv", "nce", "identity", "r1")})
        check(step_counts == tuple(host * w for w in want),
              f"step counted {step_counts} (fwd, dx, dw) on the host, want {host} x {want}")
    # each step launched ``want`` on the card: eagerly or in its replay
    launches = tuple(TRAIN_STEPS * w for w in want)
    check(r1_values[0] > 0 and not any(r1_values[1:]), f"R1 cadence: {r1_values}")
    moved = {k: max(float((getattr(state, k)[n].detach() - t).abs().max())
                    for n, t in start[k].items()) for k in start}
    phase("train", model="cut-resnet9-ngf64+patchgan-ndf64", dtype="bf16", batch=b,
          steps=TRAIN_STEPS, launches_fwd_dx_dw="/".join(map(str, launches)),
          **{f"{k}_max_move": f"{v:.3e}" for k, v in moved.items()})
    check(all(v > 0 for v in moved.values()), f"parameters did not move: {moved}")

    # one float32 step at batch 2, kernel path against plain path; cuDNN's
    # nondeterministic algorithms (the other convs, on both paths) alone
    # move Adam's mu by up to 1e-2 of a leaf's max between two runs of one
    # path, so the step runs under cudnn.deterministic
    photos, monets = (t[:2] for t in batches[0])
    loss_rel, mu_rels, _ = fp32_step_vs_plain(cfg, g_tree, d_tree, photos, monets)
    worst = sorted(mu_rels, key=mu_rels.get, reverse=True)[:4]
    mu_rel = mu_rels[worst[0]]
    phase("train", dtype="fp32", batch=2, vs="plain", loss_max_rel=f"{loss_rel:.3e}",
          adam_mu_max_rel_to_leaf_max=f"{mu_rel:.3e}",
          worst_leaves=",".join(f"{n}={mu_rels[n]:.2e}" for n in worst))
    check(loss_rel <= 1e-4, f"fp32 step losses differ from the plain path by {loss_rel}")
    check(mu_rel <= 1e-3, f"fp32 step Adam mu differs from the plain path by {mu_rel}")
    return trainer, state, batches, launches


def device_busy_ms(prof) -> float:
    """The union of the device-side event intervals of a profile, in ms."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def kernel_device_us(fn, iters: int, names: dict) -> dict:
    """Mean device time in us of each CUDA kernel whose name contains
    ``names[k]``, over ``iters`` calls of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        # a session now and then gets no device events from the tracer
        # (seen once in ten, and twice running once): take another before
        # giving up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = {}
        for e in prof.key_averages():
            for k, name in names.items():
                if name in e.key:
                    total = (e.device_time_total if hasattr(e, "device_time_total")
                             else e.cuda_time_total)
                    got[k] = total / iters
        if set(got) == set(names):
            break
    check(set(got) == set(names), f"profiler saw {sorted(got)} of {sorted(names)}")
    return got


def profile_once(fn, op: str, rows: int, **fields) -> dict:
    """One torch.profiler op table of one call of ``fn`` (after a warm
    call), its device busy time and the card's idle share; returns the
    wall, the busy time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = device_busy_ms(prof)
    events = prof.key_averages()
    sort_by = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
               else "self_cuda_time_total")
    print(events.table(sort_by=sort_by, row_limit=rows), flush=True)
    idle = max(0.0, 1 - busy / wall)
    norms = norm_device_launches(prof)
    phase("timing", op=op, **fields, wall_ms=f"{wall:.2f}", device_busy_ms=f"{busy:.2f}",
          idle_share=f"{idle:.4f}", device_norm_fwd_bwd=(
              "not_measured" if norms is None else f"{norms['fwd']}/{norms['bwd']}"))
    return {"profiled_wall_ms": wall, "device_busy_ms": busy, "idle_share": idle,
            "norm_launches": norms}


def phase_timing(gen, rng, net, trainer, state, batches):
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    # the forward at the served shape (batch 32) and at the train step's
    # (batch 12), where its 54 launches a step run: plain, kernel, kernel,
    # plain, and cuDNN, in one call; its main pass on the device clock
    conv_ms = {}
    for shape in ((TIME_BATCH, 64, 64, 256), TRAIN_SHAPE):
        x, w, b = conv_inputs(shape, 256, torch.bfloat16, gen)
        kernel = lambda: resblock.reflect_conv3x3(x, w, b)  # noqa: E731
        plain = lambda: resblock.reflect_conv3x3_reference(x, w, b)  # noqa: E731
        p1, k1, k2, p2 = (event_ms(f, iters=10) for f in (plain, kernel, kernel, plain))
        lib = event_ms(lambda: cudnn_conv(x, w, b), iters=10)
        conv_ms[shape[0]] = {"kernel": (k1 + k2) / 2, "plain": (p1 + p2) / 2, "cudnn_bf16": lib}
        main_us = kernel_device_us(kernel, 10, {"main": "fwd_main_wgmma"})["main"]
        flop = 2 * 9 * int(np.prod(shape)) * 256
        phase("timing", op="reflect_conv3x3", shape="x".join(map(str, shape)), dtype="bf16",
              route=resblock.trunk_route(torch.bfloat16),
              kernel_ms=f"{k1:.4f}/{k2:.4f}", plain_ms=f"{p1:.4f}/{p2:.4f}",
              cudnn_bf16_ms=f"{lib:.4f}", main_us=f"{main_us:.2f}",
              kernel_tflops=f"{flop / conv_ms[shape[0]]['kernel'] / 1e9:.2f}",
              main_tflops=f"{flop / main_us / 1e6:.2f}")

    x, w, _ = conv_inputs(TRAIN_SHAPE, 256, torch.bfloat16, gen)
    dy = torch.randn(TRAIN_SHAPE, device="cuda", generator=gen).to(torch.bfloat16)
    flop = 2 * 9 * int(np.prod(TRAIN_SHAPE)) * 256
    # cuDNN's bf16 backward-data and backward-weight of the conv on the
    # reflect-padded input: one PyTorch call each, without the fold of dx
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w_oihw, dy_nchw = w.permute(3, 2, 0, 1).contiguous(), dy.permute(0, 3, 1, 2)

    def cudnn_grad(mask):
        return lambda: torch.ops.aten.convolution_backward(
            dy_nchw, xp, w_oihw, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask)

    grad_ms = {}
    for op, kernel, plain, args, library in (
            ("dx", resblock.reflect_conv3x3_dx, resblock.reflect_conv3x3_dx_reference, (dy, w),
             cudnn_grad([True, False, False])),
            ("dw", resblock.reflect_conv3x3_dw, resblock.reflect_conv3x3_dw_reference, (x, dy),
             cudnn_grad([False, True, False]))):
        # plain, kernel, kernel, plain in one call
        p1 = event_ms(lambda: plain(*args), iters=10)
        k1 = event_ms(lambda: kernel(*args), iters=10)
        k2 = event_ms(lambda: kernel(*args), iters=10)
        p2 = event_ms(lambda: plain(*args), iters=10)
        lib = event_ms(library, iters=10)
        grad_ms[op] = ((k1 + k2) / 2, (p1 + p2) / 2, lib)
        phase("timing", op=f"reflect_conv3x3_{op}", shape="x".join(map(str, TRAIN_SHAPE)),
              dtype="bf16", kernel_ms=f"{k1:.4f}/{k2:.4f}", plain_ms=f"{p1:.4f}/{p2:.4f}",
              cudnn_bf16_ms=f"{lib:.4f}", kernel_tflops=f"{flop / grad_ms[op][0] / 1e9:.2f}")
    # dx's kernels apart (its route for the trunk: frame pass, wgmma main pass, fold)
    parts = kernel_device_us(lambda: resblock.reflect_conv3x3_dx(dy, w), 10,
                             {"frame": "dx_frame_mma", "main": "dx_main_wgmma", "fold": "dx_fold"})
    phase("timing", op="reflect_conv3x3_dx_parts", shape="x".join(map(str, TRAIN_SHAPE)),
          dtype="bf16", route=resblock.trunk_route(dy.dtype),
          **{f"{k}_us": f"{v:.2f}" for k, v in parts.items()},
          main_tflops=f"{flop / parts['main'] / 1e6:.2f}")
    # dw's kernels apart (its route for the trunk: the partials' wgmma pass,
    # the ordered reduce)
    parts = kernel_device_us(lambda: resblock.reflect_conv3x3_dw(x, dy), 10,
                             {"main": "dw_partial_wgmma", "reduce": "dw_reduce"})
    phase("timing", op="reflect_conv3x3_dw_parts", shape="x".join(map(str, TRAIN_SHAPE)),
          dtype="bf16", route=resblock.trunk_route(x.dtype),
          **{f"{k}_us": f"{v:.2f}" for k, v in parts.items()},
          main_tflops=f"{flop / parts['main'] / 1e6:.2f}")

    u8 = torch.from_numpy(rng.integers(0, 256, (TIME_BATCH, 256, 256, 3), dtype=np.uint8)).cuda()

    serve = {"kernel": wall_ms(lambda: stylize_batch(net, u8), 3)}
    with trunk_conv(resblock, resblock.reflect_conv3x3_reference):
        serve["plain"] = wall_ms(lambda: stylize_batch(net, u8), 3)
    with trunk_conv(resblock, cudnn_conv):
        serve["cudnn_bf16"] = wall_ms(lambda: stylize_batch(net, u8), 3)
    phase("timing", op="stylize_batch", batch=TIME_BATCH, dtype="bf16",
          **{f"{k}_ms": f"{v:.3f}" for k, v in serve.items()},
          **{f"{k}_img_per_s": f"{TIME_BATCH / v * 1e3:.2f}" for k, v in serve.items()})
    profile_once(lambda: stylize_batch(net, u8), "stylize_batch_profile", rows=12,
                 batch=TIME_BATCH)

    photos, monets = batches[0]
    step_ms = {}
    for path in ("kernel", "plain"):
        fn = resblock.reflect_conv3x3 if path == "kernel" else resblock.reflect_conv3x3_reference
        # a trainer of its own for the plain path: a trainer's graphs hold
        # the path they were captured on
        t = trainer if path == "kernel" else CUTTrainer(trainer.config)
        with trunk_conv(resblock, fn):
            for kind, step in (("warmup", 1), ("r1", 0)):
                step_ms[(path, kind)] = wall_ms(
                    lambda s=step, t=t: t.train_step(state, photos, monets, step=s), 4)
    phase("timing", op="train_step", batch=photos.shape[0], dtype="bf16",
          **{f"{p}_{k}_ms": f"{v:.2f}" for (p, k), v in step_ms.items()},
          kernel_warmup_steps_per_s=f"{1e3 / step_ms[('kernel', 'warmup')]:.3f}")

    # the norm kernels the card ran in one replayed warmup step
    norms = profile_once(lambda: trainer.train_step(state, photos, monets, step=1),
                         "train_step_profile", rows=40, kind="warmup")["norm_launches"]
    want = dict.fromkeys(NORM_KERNELS, NORM_FLAGSHIP_STEP)
    check(norms in (None, want), f"a replayed warmup step ran norm kernels {norms}, want {want}")
    return conv_ms, grad_ms, norms


# --------------------------------------------------------------------------- #
# the variant generator: the attention kernels, serving and training


def bound_ms(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """The least time for ``flops`` operations and ``nbytes`` of traffic on
    the card's published peaks, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_flops(shape) -> dict:
    """Operations of each attention kernel from its shapes: the forward
    (q k^T, p v), dK/dV (p recomputed, p^T do, do v^T, ds^T q) and dQ (p
    recomputed, do v^T, ds k)."""
    b, n, dqk, dv = shape
    pairs = 2 * b * n * n
    return {"fwd": pairs * (dqk + dv), "dkv": pairs * (2 * dqk + 2 * dv),
            "dq": pairs * (2 * dqk + dv)}


def attention_bytes(shape, itemsize: int) -> dict:
    """Each input read once, each output written once."""
    b, n, dqk, dv = shape
    qk, vv, row = b * n * dqk * itemsize, b * n * dv * itemsize, b * n * 4
    return {"fwd": 2 * qk + 2 * vv + row,                 # q, k, v -> o, lse
            "dkv": 2 * qk + 2 * vv + 2 * row + qk + vv,   # q, k, v, do, lse, di -> dk, dv
            "dq": 2 * qk + 2 * vv + 2 * row + qk}         # ... -> dq


def attention_inputs(shape, dtype, gen):
    b, n, dqk, dv = shape
    q = (torch.randn((b, n, dqk), device="cuda", generator=gen) * 0.5).to(dtype)
    k = (torch.randn((b, n, dqk), device="cuda", generator=gen) * 0.5).to(dtype)
    v = torch.randn((b, n, dv), device="cuda", generator=gen).to(dtype)
    do = torch.randn((b, n, dv), device="cuda", generator=gen).to(dtype)
    return q, k, v, do


def attn_route_counts(sa) -> dict:
    """{route: attention forward launches}, the einsum core's calls under
    ``einsum``, read from ``trace.COUNTS``."""
    from gan_variant_research_tpu_torch.core import trace

    return {r: trace.COUNTS.get(f"attn.fwd.{r}", 0) for r in sa.ATTN_ROUTES}


def attn_counts(sa) -> tuple[int, int, int]:
    """The attention kernels' forward (every kernel route), dK/dV and dQ
    launches."""
    from gan_variant_research_tpu_torch.core import trace

    fwd = attn_route_counts(sa)
    return (sum(fwd[r] for r in sa.KERNEL_ROUTES), trace.COUNTS.get("attn.dkv", 0),
            trace.COUNTS.get("attn.dq", 0))


def reset_attn_counts(sa) -> None:
    """Every attention counter to 0, the routes' and the einsum core's too."""
    drop_counts("attn.")


@contextlib.contextmanager
def attention_core(sa, fn):
    """Route the variant blocks' attention core through ``fn``."""
    real = sa.spatial_attention
    sa.spatial_attention = fn
    try:
        yield
    finally:
        sa.spatial_attention = real


@contextlib.contextmanager
def plain_path(resblock, sa):
    """The trunk conv and the attention core on their plain versions."""
    with attention_core(sa, sa.spatial_attention_reference), \
            trunk_conv(resblock, resblock.reflect_conv3x3_reference):
        yield


ATTN_CASES = [((12, 4096, 32, 256), torch.float32), (ATTN_SHAPE, torch.bfloat16),
              ((32, 4096, 32, 256), torch.bfloat16), ((2, 16384, 32, 256), torch.bfloat16),
              ((2, 1000, 16, 72), torch.float32), ((2, 1000, 16, 72), torch.bfloat16),
              ((1, 64, 8, 64), torch.float32), ((1, 64, 8, 64), torch.bfloat16),
              ((3, 130, 64, 136), torch.bfloat16), ((1, 7, 24, 8), torch.float32),
              # the bf16 forward's tile edges: 128 query rows a block, 64 keys a
              # tile, d_qk padded to 16/32/64, d_v to one 256-wide tile
              ((2, 4097, 32, 256), torch.bfloat16), ((3, 129, 8, 256), torch.bfloat16),
              ((2, 129, 64, 256), torch.bfloat16), ((2, 333, 32, 8), torch.bfloat16),
              ((2, 777, 24, 136), torch.bfloat16),
              # the bf16 dK/dV's tile edges: 128 keys a block, 64 queries a tile
              # (32 at d_qk 64), v and do in 64-column boxes; one image
              ((1, 127, 24, 72), torch.bfloat16), ((1, 128, 64, 8), torch.bfloat16),
              ((1, 129, 8, 136), torch.bfloat16), ((1, 4097, 64, 256), torch.bfloat16),
              ((1, 4097, 24, 72), torch.bfloat16),
              # the bf16 dQ's tile edges: 128 queries a block, 64 keys a tile, d_qk
              # padded to 16/32/64, do and v in 1, 3 or 4 64-column boxes; one key,
              # less than a tile, image boundaries at ragged n (and (2, 4097, 32,
              # 256) above)
              ((1, 1, 8, 8), torch.bfloat16), ((2, 63, 32, 256), torch.bfloat16),
              ((3, 129, 24, 8), torch.bfloat16), ((1, 200, 64, 136), torch.bfloat16),
              ((2, 65, 16, 192), torch.bfloat16),
              # the d_qk-128 instance (q and k in two 64-column boxes; the
              # backward on the first 128 columns of v, with the 256-wide
              # forward's lse): the ngf-256 variant's core at batch 12, its
              # backward chunk width, and its tile edges (n of 4097 and 129,
              # d_qk 72 zero-filled to 128 by TMA, ragged d_v)
              *((shape, dtype) for shape in ((12, 4096, 128, 256), (12, 4096, 128, 128),
                                             (2, 4097, 128, 256), (3, 129, 72, 136),
                                             (2, 129, 128, 40))
                for dtype in (torch.float32, torch.bfloat16))]


def phase_attention_kernels(gen, cases=ATTN_CASES) -> dict:
    """Each attention kernel against its plain version. float32: within
    1e-5 (forward) and 1e-4 (gradients) of the largest value. bf16: the
    kernel and the plain version round at other places (the unnormalised p
    here, the normalised weights there; in the backward ds here, dp there),
    so the forward is held against the float32 plain version on the same
    bf16 inputs, and may be at most twice as far from it as the plain
    version is; dK/dV and dQ are held to the contract version, which rounds
    where they do (``bf16_backward_check``). Every kernel run twice must
    agree bitwise. Where d_v is wider than the backward kernels take
    (``backward_width``), the backward runs on the first chunk of v that
    they take, with the whole forward's lse."""
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

    contract = attention_backwards(sa)["contract"]
    errs = {}
    for shape, dtype in cases:
        q, k, v, do = attention_inputs(shape, dtype, gen)
        label = dict(shape="x".join(map(str, shape)), dtype=str(dtype).split(".")[-1])
        if shape[3] > sa.backward_width(shape[2]):
            label["bwd_d_v"] = sa.backward_width(shape[2])
        o, lse = sa.spatial_attention_forward(q, k, v)
        o2, lse2 = sa.spatial_attention_forward(q, k, v)
        vb, dob, ob = (t[..., :sa.backward_width(shape[2])].contiguous() for t in (v, do, o))
        di = (ob.float() * dob.float()).sum(-1)
        dk, dv = sa.spatial_attention_dkv(q, k, vb, dob, lse, di)
        dk2, dv2 = sa.spatial_attention_dkv(q, k, vb, dob, lse, di)
        dq = sa.spatial_attention_dq(q, k, vb, dob, lse, di)
        dq2 = sa.spatial_attention_dq(q, k, vb, dob, lse, di)
        torch.cuda.synchronize()
        got = {"fwd": (o,), "dkv": (dk, dv), "dq": (dq,)}
        plain = {"fwd": (sa.spatial_attention_reference(q, k, v),),
                 "dkv": sa.spatial_attention_dkv_reference(q, k, vb, dob, lse, di),
                 "dq": (sa.spatial_attention_dq_reference(q, k, vb, dob, lse, di),)}
        check(all(a.dtype == dtype and a.shape == b.shape for kind in got
                  for a, b in zip(got[kind], plain[kind])), f"attention {shape} {dtype}: bad output")
        if dtype == torch.bfloat16:
            f32 = [t.float() for t in (q, k, vb, dob)]
            truth = {"fwd": (sa.spatial_attention_reference(q.float(), k.float(), v.float()),),
                     "dkv": sa.spatial_attention_dkv_reference(*f32, lse, di),
                     "dq": (sa.spatial_attention_dq_reference(*f32, lse, di),)}
            dq_c, dk_c, dv_c = per_image(contract, q, k, vb, dob, lse, di)
            contracts = {"dkv": (dk_c, dv_c), "dq": (dq_c,)}
        for kind in got:
            worst, fields = 0.0, {}
            names = {"fwd": ("o",), "dkv": ("dk", "dv"), "dq": ("dq",)}[kind]
            for j, (name, a, p_) in enumerate(zip(names, got[kind], plain[kind])):
                d = float((a.float() - p_.float()).abs().max())
                scale = float(p_.float().abs().max())
                fields[f"{name}_max_abs_err"] = f"{d:.3e}"
                worst = max(worst, d)
                if dtype == torch.float32:
                    tol = (1e-5 if kind == "fwd" else 1e-4) * scale
                    fields[f"{name}_rel_to_max"] = f"{d / scale:.3e}"
                    check(d <= tol, f"attention {kind} {name} {shape} fp32: {d} over {tol}")
                elif kind == "fwd":
                    t = truth[kind][j]
                    e_k = float((a.float() - t).abs().max())
                    e_p = float((p_.float() - t).abs().max())
                    fields[f"{name}_err_vs_f32"] = f"{e_k:.3e}"
                    fields[f"{name}_plain_err_vs_f32"] = f"{e_p:.3e}"
                    check(e_k <= 2 * e_p + 1e-6 * scale,
                          f"attention {kind} {name} {shape} bf16: {e_k} from float32, "
                          f"the plain version {e_p}")
                else:
                    verdict = bf16_backward_check(a, contracts[kind][j], p_, truth[kind][j])
                    fields.update({f"{name}_{k_}": f"{v_:.3e}" for k_, v_ in verdict.items()
                                   if k_ != "ok"})
                    check(verdict["ok"], f"attention {kind} {name} {shape} bf16: {verdict}")
            # each block owns its rows: every kernel run twice gives the same bits
            first = {"fwd": (o, lse), "dkv": got["dkv"], "dq": got["dq"]}[kind]
            again = {"fwd": (o2, lse2), "dkv": (dk2, dv2), "dq": (dq2,)}[kind]
            same = all(torch.equal(a, b) for a, b in zip(first, again))
            fields["bitwise_repeatable"] = same
            check(same, f"attention {kind} {shape} {dtype}: two runs differ")
            errs[(kind, shape, dtype)] = worst
            phase("kernel", name=f"spatial_attention_{kind}" if kind != "fwd"
                  else "spatial_attention", **label, **fields)
        del q, k, v, do, o, lse, o2, lse2, vb, dob, ob, di, got, plain
        torch.cuda.empty_cache()
    return errs


def per_image(fn, *ts):
    """``fn`` over one image of the (B, ...) tensors at a time, its
    (tuple of) results concatenated: one image's (n, n) maps at a time."""
    outs = [fn(*(t[i:i + 1] for t in ts)) for i in range(ts[0].shape[0])]
    return tuple(torch.cat(x) for x in zip(*outs))


def attention_grads_float64(q, k, v, do):
    """(dq, dk, dv) of softmax(q k^T) v in float64 from the inputs' values,
    with its own lse and di: the yardstick of the tolerance phase."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(1, 2), dim=-1)
    ds = p * (do @ v.transpose(1, 2) - ((p @ v) * do).sum(-1, keepdim=True))
    return ds @ k, ds.transpose(1, 2) @ q, p.transpose(1, 2) @ do


def attention_backwards(sa) -> dict:
    """Each backward as (q, k, v, do, lse, di) -> (dq, dk, dv): the kernels,
    the plain version (autograd), and the contract versions with float64
    and with float32 sums."""
    def contract(acc):
        return lambda *a: (sa.spatial_attention_dq_contract(*a, acc=acc),
                           *sa.spatial_attention_dkv_contract(*a, acc=acc))

    return {"kernel": lambda *a: (sa.spatial_attention_dq(*a), *sa.spatial_attention_dkv(*a)),
            "plain": lambda q, k, v, do, lse, di: sa._plain_grads(q, k, v, do),
            "contract": contract(torch.float64), "contract32": contract(torch.float32)}


def error_stats(a, ref) -> tuple[float, float]:
    """The largest and the root-mean-square difference, in float64."""
    d = a.double() - ref.double()
    return float(d.abs().max()), float(d.square().mean().sqrt())


def bf16_backward_check(a, contract, plain, truth) -> dict:
    """The check of a bf16 backward kernel's output ``a``: within one bf16
    rounding of the largest value of the contract version (the library's
    rounding points, float64 sums), and an RMS distance from the float32
    plain version ``truth`` at most twice the bf16 plain version's."""
    e_c = error_stats(a, contract)[0]
    tol = float(bf16_ulp(contract.float().abs().max()))
    rms_k, rms_p = error_stats(a, truth)[1], error_stats(plain, truth)[1]
    return {"vs_contract_max": e_c, "vs_contract_tol": tol, "rms_vs_f32": rms_k,
            "plain_rms_vs_f32": rms_p, "ok": e_c <= tol and rms_k <= 2 * rms_p}


TOL_SHAPES = ((2, 16384, 32, 256), ATTN_SHAPE)
TOL_SEEDS = 8


def phase_attention_tolerance(shapes=TOL_SHAPES, seeds=TOL_SEEDS) -> None:
    """The bf16 backward kernels (dQ, dK/dV) over ``seeds`` input seeds at
    each shape: the kernel's, the plain version's and the contract
    version's error against the float64 core and against the contract, each
    as a maximum and an RMS relative to the float64 core's largest value;
    the contract with float32 sums gives the float32 summation error. Also
    the ratios of the former rule (kernel over plain version, distance from
    the float32 plain version) by maximum and by RMS. Every seed is
    reported before the check (``bf16_backward_check``) is applied."""
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

    backwards = attention_backwards(sa)
    failed = []
    for shape in shapes:
        summary = {}
        for seed in range(seeds):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v, do = attention_inputs(shape, torch.bfloat16, gen)
            o, lse = sa.spatial_attention_forward(q, k, v)
            di = (o.float() * do.float()).sum(-1)
            args = (q, k, v, do, lse, di)
            got = {src: per_image(fn, *args) for src, fn in backwards.items()}
            f64 = per_image(attention_grads_float64, q, k, v, do)
            f32 = per_image(backwards["plain"], *(t.float() for t in (q, k, v, do)), lse, di)
            for j, out in enumerate(("dq", "dk", "dv")):
                scale = float(f64[j].abs().max())
                fields = {}
                for src in got:
                    for ref, against in (("f64", f64[j]), ("contract", got["contract"][j])):
                        if src != ref:
                            m, r = error_stats(got[src][j], against)
                            fields[f"{src}_vs_{ref}_max"] = m / scale
                            fields[f"{src}_vs_{ref}_rms"] = r / scale
                (mk, rk), (mp, rp) = (error_stats(got[s][j], f32[j]) for s in ("kernel", "plain"))
                fields["rule_max_ratio"], fields["rule_rms_ratio"] = mk / mp, rk / rp
                verdict = bf16_backward_check(got["kernel"][j], got["contract"][j],
                                              got["plain"][j], f32[j])
                fields["kernel_vs_contract_ulps"] = (verdict["vs_contract_max"]
                                                     / verdict["vs_contract_tol"])
                if not verdict["ok"]:
                    failed.append((shape, seed, out, verdict))
                for key, val in fields.items():
                    summary.setdefault((out, key), []).append(val)
                phase("tolerance", shape="x".join(map(str, shape)), seed=seed, out=out,
                      ok=verdict["ok"], **{k_: f"{v_:.3e}" for k_, v_ in fields.items()})
            del q, k, v, do, o, lse, di, got, f64, f32
            torch.cuda.empty_cache()
        for out in ("dq", "dk", "dv"):
            phase("tolerance_summary", shape="x".join(map(str, shape)), seeds=seeds, out=out,
                  **{f"{key}_worst": f"{max(vals):.3e}" for (o_, key), vals in summary.items()
                     if o_ == out})
    check(not failed, f"bf16 backward kernels outside the check: {failed}")


def phase_attention_autograd(gen) -> None:
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

    q, k, v, do = attention_inputs((4, 4096, 32, 256), torch.float32, gen)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = sa.spatial_attention(*leaves)
    check(type(o.grad_fn).__name__ == "_SpatialAttentionBackward", f"grad_fn {o.grad_fn}")
    got = torch.autograd.grad(o, leaves, do)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(sa.spatial_attention_reference(*leaves), leaves, do)
    rels = [float((a - e).abs().max() / e.abs().max()) for a, e in zip(got, want)]
    phase("autograd", op="spatial_attention", shape="4x4096x32x256", dtype="float32",
          **{f"{n}_rel_to_max": f"{r:.3e}" for n, r in zip(("dq", "dk", "dv"), rels)})
    check(max(rels) <= 1e-4, f"attention gradients differ from autograd: {rels}")


def variant_params(rng: np.random.Generator, ngf: int = FLAGSHIP["ngf"]) -> dict:
    """The JAX variant generator's param tree at the flagship depth and width
    ``ngf``: the trunk plus attn_3, attn_7, channel_attn_5 and nine style
    gates, with non-zero gains (at init every variant block is an identity
    and the attention core gets no gradient)."""
    params = flagship_params(rng, ngf)
    c = ngf * 2 ** FLAGSHIP["n_downsampling"]
    for i in VARIANT_G["attn_layers"]:
        params[f"attn_{i}"] = {name: uniform_conv(rng, 1, c, width, c)
                               for name, width in (("query", c // 8), ("key", c // 8),
                                                   ("value", c), ("out", c))}
        params[f"attn_{i}"]["gamma"] = np.float32(0.5)
    for i in VARIANT_G["channel_attn_layers"]:
        inner = c // 16
        params[f"channel_attn_{i}"] = {
            "fc1": {"kernel": rng.uniform(-1, 1, (c, inner)).astype(np.float32) / np.sqrt(c),
                    "bias": np.zeros(inner, np.float32)},
            "fc2": {"kernel": rng.uniform(-1, 1, (inner, c)).astype(np.float32) / np.sqrt(inner),
                    "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32)}}
    for i in range(FLAGSHIP["n_blocks"]):
        params[f"style_gate_{i}"] = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                                     "beta": rng.uniform(-0.5, 0.5, c).astype(np.float32)}
    return params


def phase_serve_variant(rng):
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.convert import generator_state_dict_from_jax
    from gan_variant_research_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa
    from gan_variant_research_tpu_torch.train.cut_trainer import build_generator

    gcfg = dict(FLAGSHIP, **VARIANT_G)
    net = build_generator(gcfg, DEFAULT_POLICY)
    net.load_state_dict(generator_state_dict_from_jax(variant_params(rng)))
    net = net.to("cuda").eval()
    photos = [torch.from_numpy(rng.integers(0, 256, (SERVE_BATCH, 256, 256, 3), dtype=np.uint8))
              .cuda() for _ in range(SERVE_BATCHES)]
    torch.cuda.synchronize()
    reset_counts(resblock)
    reset_attn_counts(sa)
    served = []
    for u8 in photos:
        before, routes = (counts(resblock)[0], *attn_counts(sa)), route_counts(resblock)
        out = stylize_batch(net, u8)
        torch.cuda.synchronize()
        step = tuple(a - b for a, b in zip((counts(resblock)[0], *attn_counts(sa)), before))
        check_routes(resblock, routes, {"fwd": TRUNK_CONVS, "dx": 0, "dw": 0}, "variant batch")
        check(step == (TRUNK_CONVS, ATTN_BLOCKS, 0, 0),
              f"a variant batch launched {step} (trunk, attention fwd/dkv/dq), "
              f"want {(TRUNK_CONVS, ATTN_BLOCKS, 0, 0)}")
        served.append(out)
    launches = (counts(resblock), attn_counts(sa))
    check(launches[0][1:] == (0, 0), f"serving launched trunk backward kernels: {launches}")
    for out in served:
        check(out.dtype == torch.uint8 and tuple(out.shape) == (SERVE_BATCH, 256, 256, 3),
              f"served {out.dtype} {tuple(out.shape)}")
        check(float(out.float().std()) > 1.0, "served images are flat")
    with plain_path(resblock, sa):
        plain_served = stylize_batch(net, photos[0])
    level = (served[0].int() - plain_served.int()).abs()
    phase("serve_variant", model="resnet9-ngf64-9blocks+attn[3,7]+chattn[5]+style",
          dtype="bf16", batches=SERVE_BATCHES, batch=SERVE_BATCH,
          launches_trunk=launches[0][0], launches_attn_fwd_dkv_dq="/".join(map(str, launches[1])),
          uint8_vs_plain_identical=f"{(level == 0).float().mean().item():.5f}",
          uint8_vs_plain_max_levels=int(level.max()))

    net32 = build_generator(gcfg, FP32_POLICY)
    net32.load_state_dict(net.state_dict())
    net32 = net32.to("cuda").eval()
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        y_kernel = net32(x)
        with plain_path(resblock, sa):
            y_plain = net32(x)
    torch.cuda.synchronize()
    fp32_err = float((y_kernel - y_plain).abs().max())
    check(bool(torch.isfinite(y_kernel).all()), "non-finite variant generator output")
    phase("serve_variant", dtype="fp32", batch=2, tanh_max_abs_diff_vs_plain=f"{fp32_err:.3e}")
    check(fp32_err <= 1e-3, f"fp32 variant forward differs from the plain path by {fp32_err}")
    return net


def zero_gradient_leaf(name: str) -> bool:
    """G's leaves with an analytic gradient of 0: the conv biases that an
    instance norm follows, and the attention key's bias (a constant shift
    of every key leaves the softmax unchanged)."""
    if name.startswith(("attn_", "channel_attn_", "style_gate_")):
        return name.endswith("key.bias")
    return before_instance_norm(name)


def phase_train_variant(rng, g_tree, d_tree):
    """4 bf16 variant steps at batch 12, then the fp32 kernel-vs-plain step."""
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    cfg = VARIANT_CUT
    b, s = cfg["batch_size"], cfg["image_size"]
    trainer = CUTTrainer(cfg)
    state = trainer.state_from_jax(g_tree, d_tree, device="cuda")
    start = {k: {n: t.detach().clone() for n, t in getattr(state, k).items()}
             for k in ("g_params", "ema")}
    batches = [(torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda(),
                torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda())
               for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    want = (3 * TRUNK_CONVS,) * 3 + (3 * ATTN_BLOCKS,) * 3
    reset_counts(resblock)
    reset_attn_counts(sa)
    for photos, monets in batches:
        before, routes = (*counts(resblock), *attn_counts(sa)), route_counts(resblock)
        ran, dbs = graph_counts(), db_count()
        state, losses = trainer.train_step(state, photos, monets)
        torch.cuda.synchronize()
        step_counts = tuple(a - c for a, c in zip((*counts(resblock), *attn_counts(sa)), before))
        ran = graph_delta(ran)
        host = host_runs(ran, "variant step")
        check_routes(resblock, routes, dict.fromkeys(routes, host * 3 * TRUNK_CONVS),
                     "variant step")
        dbs = db_count() - dbs
        check(dbs == host * 3 * TRUNK_CONVS,
              f"variant step: {dbs} dw launches summed db, want {host} x {3 * TRUNK_CONVS}")
        vals = {k: float(v) for k, v in losses.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"non-finite losses {vals}")
        phase("train_variant", step=state.step - 1, r1_step=trainer.step_flags(state.step - 1)[0],
              graph="replay" if ran["replay"] else "eager+capture",
              host_launches_trunk="/".join(map(str, step_counts[:3])), host_dw_db=dbs,
              host_launches_attn="/".join(map(str, step_counts[3:])),
              **{k: f"{v:.5f}" for k, v in vals.items() if k in
                 ("d_loss", "g_loss", "g_adv", "nce", "identity", "r1")})
        check(step_counts == tuple(host * w for w in want),
              f"variant step counted {step_counts} (trunk fwd/dx/dw, attention fwd/dkv/dq) on "
              f"the host, want {host} x {want}")
    launches = tuple(TRAIN_STEPS * w for w in want[3:])
    moved = {}
    for kind in ("g_params", "ema"):
        for prefix in ("attn_", "channel_attn_", "style_gate_"):
            moved[f"{kind}:{prefix}"] = max(
                float((getattr(state, kind)[n].detach() - t).abs().max())
                for n, t in start[kind].items() if n.startswith(prefix))
    phase("train_variant", model="cut-resnet9-ngf64+attn[3,7]+chattn[5]+style", dtype="bf16",
          batch=b, steps=TRAIN_STEPS, launches_attn_fwd_dkv_dq="/".join(map(str, launches)),
          **{f"{k}_max_move": f"{v:.3e}" for k, v in moved.items()})
    check(all(v > 0 for v in moved.values()), f"variant parameters did not move: {moved}")

    # float32 steps at batch 2: the kernel path, the plain path, and the
    # plain path with the attention core in float64 and with its keys
    # reordered. The variant step amplifies any float32 rounding in the
    # attention: the reordered plain path alone moves Adam's mu by ~1e-2 of
    # a leaf's max, and with the style gates' instance norm over the
    # residual stream and PatchNCE's normalisation by up to ~1 on the
    # scalar gamma (PERF.md §6). So the
    # kernel path is held to be no farther from the float64 path than the
    # plain path is (twice, plus 1e-4), on the variant without those two
    # (attention and channel attention); the full variant step is reported.
    photos, monets = (t[:2] for t in batches[0])
    held_cfg = copy.deepcopy(cfg)
    held_cfg["model"]["generator"]["use_style_dropout"] = False
    held_cfg["loss_weights"]["patchnce"] = 0.0
    no_gates = {k: v for k, v in g_tree.items() if not k.startswith("style_gate_")}
    for name, step_cfg, tree in (("full", cfg, g_tree), ("attention+channel", held_cfg, no_gates)):
        loss_rel, mu_rels, to_f64 = fp32_step_vs_plain(step_cfg, tree, d_tree, photos, monets)
        worst = sorted(mu_rels, key=mu_rels.get, reverse=True)[:3]
        phase("train_variant", dtype="fp32", batch=2, step=name, held=name != "full",
              loss_max_rel_vs_plain=f"{loss_rel:.3e}",
              adam_mu_max_rel_vs_plain=f"{mu_rels[worst[0]]:.3e}",
              kernel_mu_max_rel_vs_f64_core=f"{to_f64['kernel']:.3e}",
              plain_mu_max_rel_vs_f64_core=f"{to_f64['plain']:.3e}",
              reordered_mu_max_rel_vs_f64_core=f"{to_f64['reordered']:.3e}",
              reordered_mu_max_rel_vs_plain=f"{to_f64['reordered_vs_plain']:.3e}",
              worst_leaves_vs_plain=",".join(f"{n}={mu_rels[n]:.2e}" for n in worst))
    check(loss_rel <= 1e-4, f"fp32 variant step losses differ from the plain path by {loss_rel}")
    check(to_f64["kernel"] <= 2 * to_f64["plain"] + 1e-4,
          f"fp32 variant step: the kernel path's Adam mu is {to_f64['kernel']} from the "
          f"float64-core path, the plain path's {to_f64['plain']}")
    return trainer, state, batches, launches


# --------------------------------------------------------------------------- #
# the CUT step as CUDA graphs against the same body run eagerly

GRAPH_STEPS, GRAPH_TIMED, GRAPH_RESUME_AT, GRAPH_RESUMED = 34, 16, 64, 4
GRAPH_VARIANT_STEPS = 17
# losses to 1e-4 relative (1e-6 absolute), every leaf to 1e-4 of its largest
# value: tests/test_torch_cut_trainer.py's parity tolerances
GRAPH_LOSS_RTOL, GRAPH_LEAF_REL = 1e-4, 1e-4


def eager_cut_step(trainer, state, photos, monets, step: int, draws) -> dict:
    """``CUTTrainer.train_step`` with its body always run eagerly (the CPU
    path's route, on the card): never captured or replayed."""
    from gan_variant_research_tpu_torch.train.cut_trainer import LOSS_KEYS

    do_r1, do_identity = trainer.step_flags(step)
    losses = trainer._eager(state, photos, monets, draws, trainer.step_scalars(state, step),
                            do_r1, do_identity)
    trainer._advance(state, step, do_r1)
    return {k: float(v) for k, v in zip(LOSS_KEYS, losses.unbind())}


def cut_leaves(state) -> dict:
    """Every tensor of a CUT state the step writes: parameters, moments, EMA."""
    out = {}
    for part in ("g_params", "d_params", "ema"):
        out.update({f"{part}:{k}": v for k, v in getattr(state, part).items()})
    for opt in ("opt_g", "opt_d"):
        for m in ("mu", "nu"):
            out.update({f"{opt}.{m}:{k}": v for k, v in getattr(getattr(state, opt), m).items()})
    return out


def cut_state_gap(a, b) -> tuple[bool, float, str]:
    """(a and b equal in every bit, the largest |a - b| of a leaf over the
    leaf's largest |b|, that leaf) over ``cut_leaves``; the largest leaves
    out G's leaves whose gradient is analytically 0 (``zero_gradient_leaf``:
    rounding noise that Adam scales up to steps of lr)."""
    la, lb = cut_leaves(a), cut_leaves(b)
    same, worst, where = True, 0.0, ""
    for k, y in lb.items():
        x = la[k].detach()
        y = y.detach()
        if not torch.equal(x, y):
            same = False
            part, name = k.split(":", 1)
            if part in ("g_params", "ema", "opt_g.mu", "opt_g.nu") and zero_gradient_leaf(name):
                continue
            rel = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
            if rel > worst:
                worst, where = rel, k
    return same and a.opt_g.count == b.opt_g.count and a.opt_d.count == b.opt_d.count, \
        worst, where


def loss_gap(a: list[dict], b: list[dict]) -> float:
    """The largest |a - b| over max(|b|, 1e-2) of any loss of any step (the
    floor keeps losses at 0, as r1 off its steps, from dividing by 0)."""
    return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-2) for x, y in zip(a, b) for k in y)


def numpy_payload(tree):
    """A checkpoint payload with its tensors as numpy arrays on the host, as
    ``load_checkpoint`` gives them."""
    if isinstance(tree, dict):
        return {k: numpy_payload(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def graph_pool_bytes() -> int:
    """Bytes of the allocator's segments in CUDA graph pools (pool id other
    than (0, 0))."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def graphed_vs_eager(name: str, cfg, g_tree, d_tree, rng, steps: int) -> dict:
    """``steps`` steps of ``cfg`` from one set of weights, batches and
    draws: graphed (``train_step``), eagerly (``eager_cut_step``) and eagerly
    again (the eager path's own run-to-run difference), under
    ``cudnn.deterministic``. Returns the trainers, states and numbers."""
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    b, s = cfg["batch_size"], cfg["image_size"]
    batches = [(torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda(),
                torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda())
               for _ in range(4)]
    trainers = {path: CUTTrainer(cfg) for path in ("graphed", "eager", "eager2")}
    states = {path: t.state_from_jax(g_tree, d_tree, device="cuda") for path, t in trainers.items()}
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    draws = [trainers["graphed"].sample_draws(gen, b) for _ in range(steps)]
    losses = {path: [] for path in trainers}
    torch.cuda.synchronize()
    ran = dict.fromkeys(GRAPH_COUNTERS, 0)
    for step in range(steps):
        photos, monets = batches[step % len(batches)]
        for path, t in trainers.items():
            if path == "graphed":
                before = graph_counts()
                states[path], out = t.train_step(states[path], photos, monets, step=step,
                                                 draws=draws[step])
                ran = {k: n + graph_delta(before)[k] for k, n in ran.items()}
                out = {k: float(v) for k, v in out.items()}
            else:
                out = eager_cut_step(t, states[path], photos, monets, step, draws[step])
            losses[path].append(out)
    torch.cuda.synchronize()
    return {"name": name, "trainers": trainers, "states": states, "batches": batches,
            "gen": gen, "losses": losses, "ran": ran}


def check_graphed(run: dict, what: str, **fields) -> None:
    """The graphed state and losses against the eager path's: equal in every
    bit, or no farther than the eager path is from itself (twice, plus the
    parity tolerances)."""
    st, ls = run["states"], run["losses"]
    same, leaf, where = cut_state_gap(st["graphed"], st["eager"])
    _, leaf_noise, _ = cut_state_gap(st["eager2"], st["eager"])
    loss = loss_gap(ls["graphed"], ls["eager"])
    loss_noise = loss_gap(ls["eager2"], ls["eager"])
    first = [loss_gap(ls[p][:3], ls["eager"][:3]) for p in ("graphed", "eager2")]
    same = same and loss == 0.0
    phase("cut_graph", check=what, bitwise=same, leaf_max_rel=f"{leaf:.3e}", worst_leaf=where,
          eager_vs_eager_leaf_max_rel=f"{leaf_noise:.3e}", loss_max_rel=f"{loss:.3e}",
          eager_vs_eager_loss_max_rel=f"{loss_noise:.3e}",
          first_3_steps_loss_max_rel=f"{first[0]:.3e}",
          eager_vs_eager_first_3_steps=f"{first[1]:.3e}", **fields)
    check(same or (leaf <= 2 * leaf_noise + GRAPH_LEAF_REL
                   and loss <= 2 * loss_noise + GRAPH_LOSS_RTOL),
          f"{what}: graphed vs eager leaves {leaf} ({where}), losses {loss}; the eager path "
          f"from itself {leaf_noise}, {loss_noise}")


def timed_steps(fn, first: int, n: int) -> tuple[float, float]:
    """(mean host ms a call, device ms a step from CUDA events around the
    ``n`` calls ``fn(step)`` from ``first``, after a synchronise)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host = 0.0
    start.record()
    for step in range(first, first + n):
        t0 = time.perf_counter()
        fn(step)
        host += time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return host / n * 1e3, start.elapsed_time(end) / n


def phase_cut_graph(rng) -> dict:
    """The flagship CUT step graphed against the same body run eagerly on
    the card, from one set of weights, batches and draws: GRAPH_STEPS steps
    (R1 on 0, 16, 32), then a period of GRAPH_TIMED steps timed on both
    paths, then a state rebuilt from the graphed state's checkpoint payload
    run GRAPH_RESUMED steps from step GRAPH_RESUME_AT (an R1 step) on both;
    the variant generator (VARIANT_CUT) over GRAPH_VARIANT_STEPS. The
    counters: two eager steps and two captures, then replays only."""
    from gan_variant_research_tpu_torch.train.cut_trainer import LOSS_KEYS

    cfg = FLAGSHIP_CUT
    b = cfg["batch_size"]
    torch.backends.cudnn.deterministic = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = graphed_vs_eager("flagship", cfg, flagship_params(rng), flagship_d_params(rng), rng,
                           GRAPH_STEPS)
    want = {"eager": 2, "capture": 2, "replay": GRAPH_STEPS - 2}
    check(run["ran"] == want, f"flagship graph counters {run['ran']}, want {want}")
    r1 = [x["r1"] > 0 for x in run["losses"]["graphed"]]
    check(r1 == [s % 16 == 0 for s in range(GRAPH_STEPS)], f"R1 cadence {r1}")
    check_graphed(run, f"flagship {GRAPH_STEPS} steps", **{f"graph_{k}": v
                                                          for k, v in run["ran"].items()})
    pool = graph_pool_bytes()
    phase("cut_graph", model="cut-resnet9-ngf64+patchgan-ndf64", batch=b,
          max_memory_allocated_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
          max_memory_reserved_gib=f"{torch.cuda.max_memory_reserved() / 2**30:.3f}",
          graph_pool_gib=f"{pool / 2**30:.3f}")

    # a period of steps, timed on each path
    trainers, states, batches = run["trainers"], run["states"], run["batches"]
    draws = [trainers["graphed"].sample_draws(run["gen"], b) for _ in range(GRAPH_TIMED)]
    first = GRAPH_STEPS

    def graphed(step):
        photos, monets = batches[step % len(batches)]
        states["graphed"], out = trainers["graphed"].train_step(
            states["graphed"], photos, monets, step=step, draws=draws[step - first])
        run["losses"]["graphed"].append(out)

    def eager(path):
        def one(step):
            # eager_cut_step without its reads of the losses, which wait
            photos, monets = batches[step % len(batches)]
            do_r1, do_identity = trainers[path].step_flags(step)
            out = trainers[path]._eager(states[path], photos, monets, draws[step - first],
                                        trainers[path].step_scalars(states[path], step),
                                        do_r1, do_identity)
            trainers[path]._advance(states[path], step, do_r1)
            run["losses"][path].append(dict(zip(LOSS_KEYS, out.unbind())))
        return one

    ran = graph_counts()
    times = {"graphed": timed_steps(graphed, first, GRAPH_TIMED)}
    ran = graph_delta(ran)
    check(ran == {"eager": 0, "capture": 0, "replay": GRAPH_TIMED},
          f"timed period ran {ran}, want replays only")
    times["eager"] = timed_steps(eager("eager"), first, GRAPH_TIMED)
    for step in range(first, first + GRAPH_TIMED):   # the third state, not timed
        eager("eager2")(step)
    torch.cuda.synchronize()
    for path in run["losses"]:
        run["losses"][path] = [{k: float(v) for k, v in x.items()} for x in run["losses"][path]]
    phase("cut_graph", timed=f"steps {first}-{first + GRAPH_TIMED - 1}",
          graphed_host_ms_a_call=f"{times['graphed'][0]:.3f}",
          graphed_device_ms_a_step=f"{times['graphed'][1]:.3f}",
          eager_host_ms_a_call=f"{times['eager'][0]:.3f}",
          eager_device_ms_a_step=f"{times['eager'][1]:.3f}",
          graphed_images_per_s=f"{b / times['graphed'][1] * 1e3:.2f}",
          eager_images_per_s=f"{b / times['eager'][1] * 1e3:.2f}")
    check_graphed(run, f"flagship {GRAPH_STEPS + GRAPH_TIMED} steps")

    # a state rebuilt from the graphed state's payload: a new key, captured anew
    graphed_t = trainers["graphed"]
    payload = numpy_payload(graphed_t.checkpoint_payload(states["graphed"]))
    for path, t in trainers.items():
        states[path] = t.state_from_payload(payload, GRAPH_RESUME_AT, device="cuda")
    diff = states_equal(states["graphed"], states["eager"])
    check(not diff, f"the states rebuilt from one payload differ in {diff}")
    draws = [graphed_t.sample_draws(run["gen"], b) for _ in range(GRAPH_RESUMED)]
    run["losses"] = {path: [] for path in trainers}
    ran = dict.fromkeys(GRAPH_COUNTERS, 0)
    for i in range(GRAPH_RESUMED):
        step = GRAPH_RESUME_AT + i
        photos, monets = batches[step % len(batches)]
        before = graph_counts()
        states["graphed"], out = graphed_t.train_step(states["graphed"], photos, monets,
                                                      step=step, draws=draws[i])
        ran = {k: n + graph_delta(before)[k] for k, n in ran.items()}
        run["losses"]["graphed"].append({k: float(v) for k, v in out.items()})
        for path in ("eager", "eager2"):
            run["losses"][path].append(eager_cut_step(trainers[path], states[path], photos,
                                                      monets, step, draws[i]))
    want = {"eager": 2, "capture": 2, "replay": GRAPH_RESUMED - 2}
    check(ran == want, f"restored state's graph counters {ran}, want {want}")
    check_graphed(run, f"restored at {GRAPH_RESUME_AT}, {GRAPH_RESUMED} steps",
                  **{f"graph_{k}": v for k, v in ran.items()})
    out = {"times": times, "pool_bytes": pool}
    del run, trainers, states, batches, draws, payload, graphed_t
    torch.cuda.empty_cache()

    # the variant generator (attention kernels, style-gate draws)
    vrun = graphed_vs_eager("variant", VARIANT_CUT, variant_params(rng), flagship_d_params(rng),
                            rng, GRAPH_VARIANT_STEPS)
    want = {"eager": 2, "capture": 2, "replay": GRAPH_VARIANT_STEPS - 2}
    check(vrun["ran"] == want, f"variant graph counters {vrun['ran']}, want {want}")
    check_graphed(vrun, f"variant {GRAPH_VARIANT_STEPS} steps",
                  **{f"graph_{k}": v for k, v in vrun["ran"].items()})
    del vrun
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return out


def attention_float64(q, k, v):
    """The attention core in float64, the yardstick of the float32 step."""
    attn = torch.softmax(q.double() @ k.double().transpose(1, 2), dim=-1)
    return (attn @ v.double()).to(q.dtype)


def attention_reordered(q, k, v):
    """The plain attention core with the keys (and values) in another fixed
    order: the same function, only its float32 sums reordered."""
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

    perm = torch.randperm(k.shape[1], generator=torch.Generator().manual_seed(0)).to(k.device)
    return sa.spatial_attention_reference(q, k[:, perm], v[:, perm])


def fp32_step_vs_plain(cfg, g_tree, d_tree, photos, monets):
    """One float32 step of ``cfg`` (``eager_cut_step``: its body run
    eagerly) from one state and one set of draws on the kernel path, the
    plain path, and (with attention) the plain path with the attention core
    in float64 and with its keys reordered, under
    ``cudnn.deterministic``. Adam mu is compared per leaf relative to the
    leaf's max (to the net's max on leaves with an analytic gradient of 0).
    Returns (the losses' largest relative difference kernel vs plain, mu
    kernel vs plain per leaf, and with attention the largest mu difference
    of the kernel, the plain and the reordered path from the float64 path,
    and of the reordered path from the plain one)."""
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    cfg32 = copy.deepcopy(cfg)
    cfg32["runtime"]["precision"] = "fp32"
    t32 = CUTTrainer(cfg32)
    draws = t32.sample_draws(torch.Generator(device="cuda").manual_seed(1), photos.shape[0])
    results = {}
    torch.backends.cudnn.deterministic = True
    cores = {"f64": attention_float64, "reordered": attention_reordered}
    attention = cfg32["model"]["generator"].get("use_attention", False)
    for path in ("kernel", "plain", *(cores if attention else ())):
        st = t32.state_from_jax(g_tree, d_tree, device="cuda")
        with contextlib.ExitStack() as stack:
            if path != "kernel":
                stack.enter_context(plain_path(resblock, sa))
            if path in cores:
                stack.enter_context(attention_core(sa, cores[path]))
            # the step's body run eagerly: a capture would hold the path
            # (and the float64 and reordered cores cannot be captured)
            losses = eager_cut_step(t32, st, photos, monets, 0, draws)
        results[path] = (st, losses)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False

    def mu_diff(a, b):
        rels = {}
        for net, opt in (("g", "opt_g"), ("d", "opt_d")):
            ma, mb = getattr(results[a][0], opt).mu, getattr(results[b][0], opt).mu
            net_max = max(float(t.abs().max()) for t in mb.values())
            for n in mb:
                scale = net_max if net == "g" and zero_gradient_leaf(n) else float(mb[n].abs().max())
                rels[f"{net}:{n}"] = float((ma[n] - mb[n]).abs().max()) / max(scale, 1e-30)
        return rels

    lk, lp = results["kernel"][1], results["plain"][1]
    loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-6) for k in lk)
    to_f64 = {}
    if attention:
        to_f64 = {path: max(mu_diff(path, "f64").values())
                  for path in ("kernel", "plain", "reordered")}
        to_f64["reordered_vs_plain"] = max(mu_diff("reordered", "plain").values())
    return loss_rel, mu_diff("kernel", "plain"), to_f64


def sdpa(q, k, v):
    """The one PyTorch call for the same function (a yardstick, never called
    by the port): one head, q, k (B, 1, n, d_qk), v (B, 1, n, d_v), scale 1."""
    return F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None],
                                          scale=1.0)[:, 0]


def phase_timing_variant(gen, rng, net, trainer, state, batches) -> dict:
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    shape = ATTN_SHAPE
    q, k, v, do = attention_inputs(shape, torch.bfloat16, gen)
    o, lse = sa.spatial_attention_forward(q, k, v)
    di = (o.float() * do.float()).sum(-1)
    ops = {"fwd": (lambda: sa.spatial_attention_forward(q, k, v),
                   lambda: sa.spatial_attention_reference(q, k, v)),
           "dkv": (lambda: sa.spatial_attention_dkv(q, k, v, do, lse, di),
                   lambda: sa.spatial_attention_dkv_reference(q, k, v, do, lse, di)),
           "dq": (lambda: sa.spatial_attention_dq(q, k, v, do, lse, di),
                  lambda: sa.spatial_attention_dq_reference(q, k, v, do, lse, di))}
    flops, nbytes = attention_flops(shape), attention_bytes(shape, 2)
    times = {}
    for kind, (kernel, plain) in ops.items():
        # plain, kernel, kernel, plain in one call
        p1 = event_ms(plain, iters=3)
        k1 = event_ms(kernel, iters=10)
        k2 = event_ms(kernel, iters=10)
        p2 = event_ms(plain, iters=3)
        times[kind] = ((k1 + k2) / 2, (p1 + p2) / 2)
        bound, by = bound_ms(flops[kind], nbytes[kind], PEAK_BF16_FLOPS)
        # dQ's kernel on the profiler's device clock too
        device = {}
        if kind == "dq":
            us = kernel_device_us(kernel, 10, {"dq": "attn_dq_wgmma"})["dq"]
            device = {"kernel_device_us": f"{us:.2f}"}
        phase("timing", op=f"spatial_attention_{kind}", shape="x".join(map(str, shape)),
              dtype="bf16", kernel_ms=f"{k1:.4f}/{k2:.4f}", plain_ms=f"{p1:.4f}/{p2:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by, **device,
              kernel_tflops=f"{flops[kind] / times[kind][0] / 1e9:.2f}")

    # fwd+bwd through the Function, the plain version and SDPA
    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(fn(*leaves), leaves, do)

    library = {"fwd": event_ms(lambda: sdpa(q, k, v), iters=10),
               "fwd_bwd": event_ms(lambda: fwd_bwd(sdpa), iters=10)}
    # SDPA's backward alone (dQ, dK and dV in one call), on a retained graph
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_lib = sdpa(*leaves)
    library["bwd"] = event_ms(lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True),
                              iters=10)
    del leaves, o_lib
    pair = {"kernel": event_ms(lambda: fwd_bwd(sa.spatial_attention), iters=10),
            "plain": event_ms(lambda: fwd_bwd(sa.spatial_attention_reference), iters=3)}
    b, n, dqk, dv = shape
    # the least work of a forward and a backward: q k^T and p v, then dV,
    # dp, dK and dQ with p kept
    least = 2 * b * n * n * (dqk + dv) + 2 * b * n * n * (3 * dqk + 2 * dv)
    phase("timing", op="spatial_attention_fwd_bwd", shape="x".join(map(str, shape)), dtype="bf16",
          **{f"{k}_ms": f"{v:.4f}" for k, v in pair.items()},
          sdpa_fwd_ms=f"{library['fwd']:.4f}", sdpa_fwd_bwd_ms=f"{library['fwd_bwd']:.4f}",
          sdpa_bwd_ms=f"{library['bwd']:.4f}",
          kernel_dkv_plus_dq_ms=f"{times['dkv'][0] + times['dq'][0]:.4f}",
          kernel_fwd_tflops=f"{flops['fwd'] / times['fwd'][0] / 1e9:.2f}",
          kernel_fwd_bwd_tflops=f"{least / pair['kernel'] / 1e9:.2f}",
          sdpa_fwd_tflops=f"{flops['fwd'] / library['fwd'] / 1e9:.2f}",
          sdpa_fwd_bwd_tflops=f"{least / library['fwd_bwd'] / 1e9:.2f}")
    del q, k, v, do, o, lse, di
    torch.cuda.empty_cache()

    # the forward at the served shape (a batch-32 variant serve), beside SDPA
    served = (TIME_BATCH,) + shape[1:]
    q, k, v, _ = attention_inputs(served, torch.bfloat16, gen)
    s1 = event_ms(lambda: sdpa(q, k, v), iters=10)
    k1 = event_ms(lambda: sa.spatial_attention_forward(q, k, v), iters=10)
    k2 = event_ms(lambda: sa.spatial_attention_forward(q, k, v), iters=10)
    s2 = event_ms(lambda: sdpa(q, k, v), iters=10)
    fl = attention_flops(served)["fwd"]
    bound, by = bound_ms(fl, attention_bytes(served, 2)["fwd"], PEAK_BF16_FLOPS)
    phase("timing", op="spatial_attention_fwd_served", shape="x".join(map(str, served)),
          dtype="bf16", kernel_ms=f"{k1:.4f}/{k2:.4f}", sdpa_ms=f"{s1:.4f}/{s2:.4f}",
          bound_ms=f"{bound:.4f}", bound_by=by, kernel_tflops=f"{fl / (k1 + k2) * 2 / 1e9:.2f}",
          sdpa_tflops=f"{fl / (s1 + s2) * 2 / 1e9:.2f}")
    del q, k, v
    torch.cuda.empty_cache()

    u8 = torch.from_numpy(rng.integers(0, 256, (TIME_BATCH, 256, 256, 3), dtype=np.uint8)).cuda()
    serve = {"kernel": wall_ms(lambda: stylize_batch(net, u8), 3)}
    with plain_path(resblock, sa):
        serve["plain"] = wall_ms(lambda: stylize_batch(net, u8), 2)
    phase("timing", op="stylize_batch_variant", batch=TIME_BATCH, dtype="bf16",
          **{f"{k}_ms": f"{v:.3f}" for k, v in serve.items()},
          **{f"{k}_img_per_s": f"{TIME_BATCH / v * 1e3:.2f}" for k, v in serve.items()})
    profile_once(lambda: stylize_batch(net, u8), "stylize_batch_variant_profile", rows=12,
                 batch=TIME_BATCH)

    photos, monets = batches[0]
    step_ms = {}
    for path in ("kernel", "plain"):
        # a trainer of its own for the plain path, as in phase_timing
        t = trainer if path == "kernel" else CUTTrainer(trainer.config)
        with plain_path(resblock, sa) if path == "plain" else contextlib.nullcontext():
            for kind, step in (("warmup", 1), ("r1", 0)):
                step_ms[(path, kind)] = wall_ms(
                    lambda s=step, t=t: t.train_step(state, photos, monets, step=s), 3)
    phase("timing", op="train_step_variant", batch=photos.shape[0], dtype="bf16",
          **{f"{p}_{k}_ms": f"{v:.2f}" for (p, k), v in step_ms.items()},
          kernel_warmup_steps_per_s=f"{1e3 / step_ms[('kernel', 'warmup')]:.3f}")
    profile_once(lambda: trainer.train_step(state, photos, monets, step=1),
                 "train_step_variant_profile", rows=30, kind="warmup")
    return {"times": times, "library": library}

# --------------------------------------------------------------------------- #
# attention widths: variant generators whose attention the kernels take
# through a route (ops/kernels/spatial_attention.py::attention_route)

# ngf: (route, the route's count a core call, (forward, dK/dV, dQ) kernel
# launches a core call), written out from the kernels' limits (d_qk and
# d_v multiples of 8, d_qk past 64 padded to the 128 instance, d_v <= 256
# forward and <= 128 backward at d_qk 128, the einsum core past d_qk 128),
# not read off ``attention_route``
WIDTH_ROUTES = {8: ("padded", 1, (1, 1, 1)),      # d_qk 4 -> 8, d_v 32
                40: ("padded", 1, (1, 1, 1)),     # d_qk 20 -> 24, d_v 160
                96: ("split", 2, (2, 2, 2)),      # d_qk 48, d_v 384 -> 2 x 192
                # d_qk 80 -> 128, d_v 640 -> 3 x 216, each 128 + 88 backward
                160: ("split", 3, (3, 6, 6)),
                # d_qk 128, d_v 1024 -> 4 x 256, each 2 x 128 backward
                256: ("split", 4, (4, 8, 8)),
                320: ("einsum", 1, (0, 0, 0))}    # d_qk 160: the einsum core
WIDTH_NGFS = tuple(WIDTH_ROUTES)
DQK128_NGFS = (160, 256)                # the widths the d_qk-128 instance carries
WIDTH_BATCH = 4
SPLIT_SHAPE = (12, 4096, 48, 384)       # the ngf-96 variant's core at batch 12
DQK128_SHAPE = (12, 4096, 128, 256)     # the d_qk-128 instance at batch 12


def routed_grads(fn, q, k, v, do):
    """(o, (dq, dk, dv)) of ``fn`` by autograd."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o = fn(*leaves)
        grads = torch.autograd.grad(o, leaves, do)
    return o.detach(), grads


def backward_chunks(sa, d_qk: int, d_v: int) -> list[tuple[int, int]]:
    """The column ranges of v that the backward kernels take one launch
    each on ``spatial_attention``'s route: each forward chunk cut again at
    ``backward_width``, clipped to d_v."""
    _, dqk, width, _ = sa.attention_route(d_qk, d_v)
    bw = sa.backward_width(dqk)
    return [(b0, min(b0 + bw, c0 + width, d_v)) for c0 in range(0, d_v, width)
            for b0 in range(c0, min(c0 + width, d_v), bw)]


def split_contract(sa, q, k, v, do, o, chunks):
    """The contract version of the split route: each backward chunk of v
    (``backward_chunks``) takes the contract backward (float64 sums, the
    kernels' bf16 rounding points) with its own di; dV is the chunks side
    by side, dK and dQ their sums in float64. Returns ((dq, dk, dv), the bf16
    tolerance of each): one rounding of each chunk's largest value (each
    chunk's kernel output is rounded to bf16) plus one of the sum's (the sum
    is cast once). dV keeps the one rounding of the unsplit check."""
    lse = torch.logsumexp(q.float() @ k.float().transpose(1, 2), dim=-1)
    sums = {"dq": 0.0, "dk": 0.0}
    tol = {"dq": 0.0, "dk": 0.0}
    dvs = []
    for c0, c1 in chunks:
        v_c, do_c, o_c = (t[..., c0:c1].contiguous() for t in (v, do, o))
        di = (o_c.float() * do_c.float()).sum(-1)
        dq_c = per_image(lambda *a: (sa.spatial_attention_dq_contract(*a),), q, k, v_c, do_c,
                         lse, di)[0]
        dk_c, dv_c = per_image(sa.spatial_attention_dkv_contract, q, k, v_c, do_c, lse, di)
        for name, t in (("dq", dq_c), ("dk", dk_c)):
            sums[name] = sums[name] + t.double()
            tol[name] += float(bf16_ulp(t.float().abs().max()))
        dvs.append(dv_c)
    dv = torch.cat(dvs, dim=2)
    for name in tol:
        tol[name] += float(bf16_ulp(sums[name].float().abs().max()))
    tol["dv"] = float(bf16_ulp(dv.float().abs().max()))
    return (sums["dq"], sums["dk"], dv), tol


def phase_attention_widths(gen, rng) -> dict:
    """Variant generators at ngf 8, 40, 96, 160, 256 and 320 (full depth,
    256^2): one served batch of 4 and one bf16 train step at batch 4 each,
    the launches of each route and kernel asserted; then the routed core at
    each width the kernels take (4, 4096, d_qk, d_v) against its plain
    version, the split route and the d_qk-128 instance timed beside SDPA."""
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.convert import generator_state_dict_from_jax
    from gan_variant_research_tpu_torch.core.precision import DEFAULT_POLICY
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer, build_generator

    b, s = WIDTH_BATCH, 256
    u8 = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda()
    routes_seen = dict.fromkeys(sa.ATTN_ROUTES, 0)
    dqk128_launches = [0, 0, 0]
    for ngf in WIDTH_NGFS:
        c = ngf * 2 ** FLAGSHIP["n_downsampling"]
        d_qk, d_v = c // 8, c
        route, calls, per_call = WIDTH_ROUTES[ngf]
        _, dqk_pad, width, _ = sa.attention_route(d_qk, d_v)
        gcfg = dict(FLAGSHIP, ngf=ngf, **VARIANT_G)
        net = build_generator(gcfg, DEFAULT_POLICY)
        net.load_state_dict(generator_state_dict_from_jax(variant_params(rng, ngf)))
        net = net.to("cuda").eval()
        photos = u8()
        torch.cuda.synchronize()
        reset_attn_counts(sa)
        out = stylize_batch(net, photos)
        torch.cuda.synchronize()
        want = (dict(dict.fromkeys(sa.ATTN_ROUTES, 0), **{route: ATTN_BLOCKS * calls}),
                (ATTN_BLOCKS * per_call[0], 0, 0))
        served = (attn_route_counts(sa), attn_counts(sa))
        check(served == want, f"ngf {ngf}: a served batch launched {served}, want {want}")
        check(out.dtype == torch.uint8 and tuple(out.shape) == (b, s, s, 3)
              and float(out.float().std()) > 1.0, f"ngf {ngf}: served {out.dtype} "
              f"{tuple(out.shape)} std {float(out.float().std())}")
        with plain_path(resblock, sa):
            plain_out = stylize_batch(net, photos)
        level = (out.int() - plain_out.int()).abs()
        del net, out, plain_out

        cfg = copy.deepcopy(VARIANT_CUT)
        cfg["model"]["generator"]["ngf"] = ngf
        cfg["batch_size"] = b
        trainer = CUTTrainer(cfg)
        state = trainer.state_from_jax(variant_params(rng, ngf), flagship_d_params(rng),
                                       device="cuda")
        monets = u8()
        torch.cuda.synchronize()
        reset_attn_counts(sa)
        ran = graph_counts()
        state, losses = trainer.train_step(state, photos, monets, step=1)
        torch.cuda.synchronize()
        host = host_runs(graph_delta(ran), f"ngf {ngf} train step")
        # 3 G passes, each with its backward; counted on the host by the
        # eager run and the capture, launched once on the card
        want_step = (dict(dict.fromkeys(sa.ATTN_ROUTES, 0), **{route: 3 * ATTN_BLOCKS * calls}),
                     tuple(3 * ATTN_BLOCKS * x for x in per_call))
        counted = (attn_route_counts(sa), attn_counts(sa))
        check(counted == ({r: host * n for r, n in want_step[0].items()},
                          tuple(host * n for n in want_step[1])),
              f"ngf {ngf}: a train step counted {counted} on the host, want {host} x "
              f"{want_step}")
        stepped = want_step
        vals = {k: float(v) for k, v in losses.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"ngf {ngf}: non-finite losses {vals}")
        routes_seen[route] += served[0][route] + stepped[0][route]
        if ngf in DQK128_NGFS:
            for i, x in enumerate(np.add(served[1], stepped[1])):
                dqk128_launches[i] += int(x)
        phase("attention_widths", model=f"resnet9-ngf{ngf}-9blocks+attn[3,7]+chattn[5]+style",
              d_qk=d_qk, d_v=d_v, route=route, kernel_d_qk=dqk_pad if route != "einsum" else "-",
              chunk_width=width, chunks=calls if route != "einsum" else 0,
              bwd_chunks=per_call[1], serve_batch=b, serve_route_launches=served[0][route],
              serve_uint8_vs_plain_max_levels=int(level.max()),
              step_route_launches=stepped[0][route],
              step_fwd_dkv_dq="/".join(map(str, stepped[1])),
              **{k: f"{v:.5f}" for k, v in vals.items() if k in ("d_loss", "g_loss", "nce")})
        del trainer, state, losses, photos, monets
        torch.cuda.empty_cache()
    check(all(routes_seen[r] > 0 for r in ("padded", "split", "einsum")),
          f"the padded, split and einsum routes were not all taken: {routes_seen}")

    # the routed core at each width the kernels take against its plain version
    for ngf in WIDTH_NGFS:
        c = ngf * 2 ** FLAGSHIP["n_downsampling"]
        shape = (b, 4096, c // 8, c)
        route = sa.attention_route(c // 8, c)[0]
        if route == "einsum":
            continue
        chunks = backward_chunks(sa, c // 8, c)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = attention_inputs(shape, dtype, gen)
            o, grads = routed_grads(sa.spatial_attention, q, k, v, do)
            o_p, grads_p = routed_grads(sa.spatial_attention_reference, q, k, v, do)
            fields = {}
            if dtype == torch.float32:
                for name, a, p_, rel in (("o", o, o_p, 1e-5), *(
                        (n_, a_, b_, 1e-4) for n_, a_, b_ in zip(("dq", "dk", "dv"),
                                                                 grads, grads_p))):
                    d, scale = float((a - p_).abs().max()), float(p_.abs().max())
                    fields[f"{name}_rel_to_max"] = f"{d / scale:.3e}"
                    check(d <= rel * scale, f"routed {route} {shape} fp32 {name}: {d} over "
                          f"{rel * scale}")
            else:
                f32 = [t.float() for t in (q, k, v, do)]
                o_t, grads_t = routed_grads(sa.spatial_attention_reference, *f32)
                e_k, e_p = float((o.float() - o_t).abs().max()), float((o_p.float() - o_t)
                                                                        .abs().max())
                fields.update(o_err_vs_f32=f"{e_k:.3e}", o_plain_err_vs_f32=f"{e_p:.3e}")
                check(e_k <= 2 * e_p + 1e-6 * float(o_t.abs().max()),
                      f"routed {route} {shape} bf16 o: {e_k} from float32, the plain {e_p}")
                if len(chunks) == 1:
                    lse = torch.logsumexp(q.float() @ k.float().transpose(1, 2), dim=-1)
                    di = (o.float() * do.float()).sum(-1)
                    dq_c, = per_image(lambda *a: (sa.spatial_attention_dq_contract(*a),),
                                      q, k, v, do, lse, di)
                    dk_c, dv_c = per_image(sa.spatial_attention_dkv_contract, q, k, v, do,
                                           lse, di)
                    contract = (dq_c, dk_c, dv_c)
                    tols = None
                else:
                    contract, tols = split_contract(sa, q, k, v, do, o, chunks)
                for name, a, con, p_, t in zip(("dq", "dk", "dv"), grads, contract, grads_p,
                                               grads_t):
                    verdict = bf16_backward_check(a, con, p_, t)
                    if tols is not None:   # the split route's tolerance (split_contract)
                        verdict["vs_contract_tol"] = tols[name]
                        verdict["ok"] = (verdict["vs_contract_max"] <= tols[name]
                                         and verdict["rms_vs_f32"] <= 2 * verdict[
                                             "plain_rms_vs_f32"])
                    fields.update({f"{name}_{k_}": f"{v_:.3e}" for k_, v_ in verdict.items()
                                   if k_ != "ok"})
                    check(verdict["ok"], f"routed {route} {shape} bf16 {name}: {verdict}")
            phase("kernel", name="spatial_attention_routed", route=route,
                  shape="x".join(map(str, shape)), dtype=str(dtype).split(".")[-1],
                  bwd_chunks=len(chunks), **fields)
            del q, k, v, do, o, grads, o_p, grads_p
            torch.cuda.empty_cache()

    # the split route at batch 12, forward and backward, beside SDPA
    q, k, v, do = attention_inputs(SPLIT_SHAPE, torch.bfloat16, gen)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_k, o_l = sa.spatial_attention(*leaves), sdpa(*leaves)
    times = {
        "fwd": event_ms(lambda: sa.spatial_attention(q, k, v), iters=10),
        "bwd": event_ms(lambda: torch.autograd.grad(o_k, leaves, do, retain_graph=True),
                        iters=10),
        "sdpa_fwd": event_ms(lambda: sdpa(q, k, v), iters=10),
        "sdpa_bwd": event_ms(lambda: torch.autograd.grad(o_l, leaves, do, retain_graph=True),
                             iters=10)}
    flops, nbytes = attention_flops(SPLIT_SHAPE), attention_bytes(SPLIT_SHAPE, 2)
    bounds = {"fwd": bound_ms(flops["fwd"], nbytes["fwd"], PEAK_BF16_FLOPS),
              "bwd": bound_ms(flops["dkv"] + flops["dq"], nbytes["dkv"] + nbytes["dq"],
                              PEAK_BF16_FLOPS)}
    phase("timing", op="spatial_attention_split", shape="x".join(map(str, SPLIT_SHAPE)),
          dtype="bf16", route=sa.attention_route(*SPLIT_SHAPE[2:])[0],
          **{f"{k}_ms": f"{v:.4f}" for k, v in times.items()},
          **{f"{k}_bound_ms": f"{v[0]:.4f}" for k, v in bounds.items()})
    del q, k, v, do, leaves, o_k, o_l
    torch.cuda.empty_cache()
    return {"routes": routes_seen, "split_times": times, "dqk128_launches": dqk128_launches,
            "dqk128": dqk128_timing(gen)}


def dqk128_timing(gen) -> dict:
    """The d_qk-128 instance at DQK128_SHAPE, bf16, on CUDA events: the
    forward at d_v 256 and each backward kernel at its chunk width (d_v
    128, the forward's lse), beside the plain versions and SDPA (forward at
    d_v 256, its backward at each chunk), with their bounds."""
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

    q, k, v, do = attention_inputs(DQK128_SHAPE, torch.bfloat16, gen)
    bw = sa.backward_width(DQK128_SHAPE[2])
    bwd_shape = (*DQK128_SHAPE[:3], bw)
    o, lse = sa.spatial_attention_forward(q, k, v)
    vb, dob, ob = (t[..., :bw].contiguous() for t in (v, do, o))
    di = (ob.float() * dob.float()).sum(-1)
    ops = {"fwd": (lambda: sa.spatial_attention_forward(q, k, v),
                   lambda: sa.spatial_attention_reference(q, k, v)),
           "dkv": (lambda: sa.spatial_attention_dkv(q, k, vb, dob, lse, di),
                   lambda: sa.spatial_attention_dkv_reference(q, k, vb, dob, lse, di)),
           "dq": (lambda: sa.spatial_attention_dq(q, k, vb, dob, lse, di),
                  lambda: sa.spatial_attention_dq_reference(q, k, vb, dob, lse, di))}
    out = {}
    for kind, (kernel, plain) in ops.items():
        shape = DQK128_SHAPE if kind == "fwd" else bwd_shape
        bound = bound_ms(attention_flops(shape)[kind], attention_bytes(shape, 2)[kind],
                         PEAK_BF16_FLOPS)
        out[kind] = {"shape": list(shape), "ms": event_ms(kernel, iters=10),
                     "plain_ms": event_ms(plain, iters=3), "bound_ms": bound[0],
                     "bound_by": bound[1]}
    # SDPA: the forward at d_v 256; its backward (dK, dV and dQ in one call)
    # at the backward kernels' chunk, and at d_v 256 beside the port's whole
    # backward there (two chunk pairs through the autograd.Function)
    leaves = [t.detach().requires_grad_() for t in (q, k, vb)]
    o_l = sdpa(*leaves)
    out["fwd"]["library_ms"] = event_ms(lambda: sdpa(q, k, v), iters=10)
    bwd_lib = event_ms(lambda: torch.autograd.grad(o_l, leaves, dob, retain_graph=True),
                       iters=10)
    out["dkv"]["library_ms"] = out["dq"]["library_ms"] = bwd_lib
    leaves256 = [t.detach().requires_grad_() for t in (q, k, v)]
    o256 = sdpa(*leaves256)
    bwd_lib256 = event_ms(lambda: torch.autograd.grad(o256, leaves256, do, retain_graph=True),
                          iters=10)
    o_port = sa.spatial_attention(*leaves256)
    bwd_port256 = event_ms(lambda: torch.autograd.grad(o_port, leaves256, do,
                                                       retain_graph=True), iters=10)
    for kind in ("dkv", "dq"):
        out[kind]["library_dv256_ms"] = bwd_lib256
        out[kind]["port_backward_dv256_ms"] = bwd_port256
    phase("timing", op="spatial_attention_dqk128", dtype="bf16",
          **{f"{kind}_{key}": (f"{val:.4f}" if isinstance(val, float) else
                               "x".join(map(str, val)) if isinstance(val, list) else val)
             for kind, row in out.items() for key, val in row.items()})
    del q, k, v, do, o, lse, vb, dob, ob, di, leaves, o_l, leaves256, o256, o_port
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# a training run: train_cut on the flagship config, checkpoints, resume

RUN_STEPS, RUN_MORE, RUN_CKPT_EVERY, RUN_LOG_EVERY = 240, 80, 80, 40
RUN_PHOTOS, RUN_MONETS = 60, 40


def write_image_folder(folder: Path, count: int, rng: np.random.Generator) -> None:
    """``count`` seeded 256x256 JPEGs: smooth colour fields with noise, so
    that the decode does real work."""
    from PIL import Image

    folder.mkdir(parents=True)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32) / 255.0
    for i in range(count):
        a = rng.uniform(0, 1, (3, 3))
        img = np.stack([a[c, 0] * yy + a[c, 1] * xx + a[c, 2] for c in range(3)], -1)
        img = img / img.max() * 200 + rng.normal(0, 12, (256, 256, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            folder / f"{i:04d}.jpg", quality=90)


def states_equal(a, b) -> list[str]:
    """The names of the fields of two train states (CUT's or CycleGAN's)
    where ``a`` and ``b`` differ in any bit."""
    from gan_variant_research_tpu_torch.train.optim import AdamState

    diff = []
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if isinstance(x, dict):
            same = all(torch.equal(x[n], y[n]) for n in x)
        elif isinstance(x, AdamState):
            same = x.count == y.count and all(
                torch.equal(x.mu[n], y.mu[n]) and torch.equal(x.nu[n], y.nu[n]) for n in x.mu)
        elif isinstance(x, torch.Generator):
            same = torch.equal(x.get_state(), y.get_state())
        else:
            same = bool(np.array_equal(x, y))
        if not same:
            diff.append(field.name)
    return diff


def phase_train_run() -> dict:
    """``train_cut`` on the flagship config (FLAGSHIP_CUT, batch 12, 256^2)
    from a seeded JPEG folder: RUN_STEPS steps with an async checkpoint every
    RUN_CKPT_EVERY (keep_last_n 2) and a JSON line every RUN_LOG_EVERY, then
    ``--resume auto`` with max_steps raised by RUN_MORE."""
    import shutil

    from gan_variant_research_tpu_torch.data.loader import UnpairedLoader, _EpochStream
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.train import checkpoint as ck
    from gan_variant_research_tpu_torch.train import loop
    from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer

    root = REPO / "build" / "train_run"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(5)
    write_image_folder(root / "photo_jpg", RUN_PHOTOS, rng)
    write_image_folder(root / "monet_jpg", RUN_MONETS, rng)
    cfg = copy.deepcopy(FLAGSHIP_CUT)
    cfg.update(max_steps=RUN_STEPS, prefetch_factor=4,
               data={"photos_dir": str(root / "photo_jpg"),
                     "monet_dir": str(root / "monet_jpg")},
               output={"checkpoint_dir": str(root / "ckpt"), "log_dir": str(root / "logs")},
               metrics={"save_checkpoint_every": RUN_CKPT_EVERY},
               checkpoint={"keep_last_n": 2, "async_save": True},
               log={"every_steps": RUN_LOG_EVERY, "verbose": False}, io={"num_workers": 8})

    # every step's trunk launches, and the loader's first batch of each run
    step_launches, first_indices = [], []
    real_step, real_next = CUTTrainer.train_step, UnpairedLoader.__next__

    def counted_step(self, *a, **kw):
        before, ran = counts(resblock), graph_counts()
        out = real_step(self, *a, **kw)
        host = host_runs(graph_delta(ran), "train_cut step")
        # the host's counts per run of the body on the host (0 on a replay)
        step_launches.append(tuple((x - y) // max(host, 1)
                                   for x, y in zip(counts(resblock), before)))
        return out

    def recorded_next(self):
        out = real_next(self)
        if len(first_indices) < len(runs) and self.last_indices is not None:
            first_indices.append(self.last_indices)
        return out

    runs = []
    CUTTrainer.train_step, UnpairedLoader.__next__ = counted_step, recorded_next
    reset_counts(resblock)
    try:
        runs.append({})
        state, trainer = loop.train_cut(cfg, device="cuda", stats=runs[0])
        saved = sorted(p.name for p in (root / "ckpt").glob("*.msgpack"))
        latest = ck.latest_checkpoint(root / "ckpt")
        blob = ck.load_checkpoint(latest)
        restored = trainer.state_from_payload(blob["payload"], blob["step"], device="cuda")
        diff = states_equal(state, restored)
        del restored, blob
        cfg2 = dict(cfg, max_steps=RUN_STEPS + RUN_MORE)
        runs.append({})
        state2, _ = loop.train_cut(cfg2, resume="auto", device="cuda", stats=runs[1])
    finally:
        CUTTrainer.train_step, UnpairedLoader.__next__ = real_step, real_next
    launches = counts(resblock)

    want_files = [f"ckpt_step{s}.msgpack" for s in range(RUN_CKPT_EVERY, RUN_STEPS,
                                                         RUN_CKPT_EVERY)][-2:]
    check(saved == sorted(want_files + ["ckpt_final.msgpack"]),
          f"checkpoints {saved}, want {sorted(want_files + ['ckpt_final.msgpack'])}")
    check(latest == root / "ckpt" / "ckpt_final.msgpack", f"latest_checkpoint picked {latest}")
    check(not diff, f"the restored state differs from the saved one in {diff}")
    check(state2.step == RUN_STEPS + RUN_MORE, f"the resumed run ended at step {state2.step}")
    streams = []
    for seed, n in ((cfg["seed"], RUN_PHOTOS), (cfg["seed"] + 1, RUN_MONETS)):
        st = _EpochStream(range(n), cfg["batch_size"], seed, None)
        st.skip(RUN_STEPS)
        streams.append(st.next_indices())
    first = [_EpochStream(range(n), cfg["batch_size"], seed, None).next_indices()
             for seed, n in ((cfg["seed"], RUN_PHOTOS), (cfg["seed"] + 1, RUN_MONETS))]
    check(len(first_indices) == 2 and first_indices[0] == tuple(first)
          and first_indices[1] == tuple(streams),
          f"the resumed loader's first batch {first_indices[1:]} is not the stream's "
          f"{streams}")
    want = (3 * TRUNK_CONVS,) * 3
    n_steps = RUN_STEPS + RUN_MORE
    # a replayed step counts nothing on the host: it reads (0, 0, 0) here
    check(len(step_launches) == n_steps
          and all(x in (want, (0, 0, 0)) for x in step_launches)
          and sum(x == want for x in step_launches) == 4,
          f"{len(step_launches)} steps; host counts other than {want} a run of the body, "
          f"or not the 4 eager steps (two keys, two runs): "
          f"{sorted(set(step_launches) - {want, (0, 0, 0)})}")
    check(launches == (2 * 4 * want[0],) * 3, f"train run counted {launches} on the host")
    # each step launched ``want`` on the card, eagerly or in its replay
    launches = (n_steps * want[0],) * 3
    with open(root / "logs" / "losses_history.csv") as f:
        rows = f.read().splitlines()[1:]
    losses = [float(x) for r in rows for x in r.split(",")[1:]]
    check(len(rows) == n_steps and all(np.isfinite(losses)),
          f"{len(rows)} CSV rows, want {n_steps}, all finite")
    lines = (root / "logs" / "train_log.txt").read_text().splitlines()
    logged = [json.loads(line.split(": ", 1)[1]) for line in lines]
    check(len(logged) == n_steps // RUN_LOG_EVERY
          and all({"d_loss", "g_loss", "images_per_sec", "step_time_ms"} <= set(d)
                  and all(np.isfinite(v) for v in d.values()) for d in logged),
          f"{len(logged)} JSON lines, want {n_steps // RUN_LOG_EVERY} with finite losses, "
          "images_per_sec and step_time_ms")

    final = root / "ckpt" / "ckpt_final.msgpack"
    n_leaves = sum(t.numel() for part in ("g_params", "d_params", "ema")
                   for t in getattr(state2, part).values()) + sum(
        t.numel() for opt in (state2.opt_g, state2.opt_d) for m in (opt.mu, opt.nu)
        for t in m.values())
    saves = [x for r in runs for x in r["saves"]]
    async_s = [t for kind, _, t in saves if kind == "async"]
    sync_s = [t for kind, _, t in saves if kind == "sync"]
    wall = sum(r["wall_s"] for r in runs)
    wait = sum(r["loader_wait_s"] for r in runs)
    out = {"steps": n_steps, "steps_per_s": n_steps / wall, "loader_wait_share": wait / wall,
           "async_save_s": async_s, "sync_save_s": sync_s,
           "checkpoint_bytes": final.stat().st_size, "float32_leaves": n_leaves,
           "launches": launches}
    phase("train_run", model="cut-resnet9-ngf64+patchgan-ndf64", dtype="bf16",
          batch=cfg["batch_size"], steps=f"{RUN_STEPS}+{RUN_MORE}",
          launches_fwd_dx_dw="/".join(map(str, launches)), checkpoints=",".join(saved),
          resumed_from=RUN_STEPS,
          steps_per_s=f"{out['steps_per_s']:.3f}",
          run_steps_per_s="/".join(f"{r['steps'] / r['wall_s']:.3f}" for r in runs),
          loader_wait_share=f"{out['loader_wait_share']:.4f}",
          async_save_s="/".join(f"{t:.3f}" for t in async_s),
          sync_save_s="/".join(f"{t:.3f}" for t in sync_s),
          checkpoint_mb=f"{out['checkpoint_bytes'] / 1e6:.1f}", float32_leaves=n_leaves,
          restored_bitwise=not diff, csv_rows=len(rows), json_lines=len(logged))
    shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------------------- #
# MiFID/FID evaluation on the card: the Kaggle sizes, seeded weights

EVAL_FAKE, EVAL_REAL, EVAL_BATCH, EVAL_SIZE = 7000, 300, 64, 299
EVAL_CHECK_IMAGES = 64
EVAL_REPORT_KEYS = {"run", "scores", "hashes", "notes", "memorization_analysis"}
EVAL_RUN_KEYS = {"name", "timestamp_utc", "fake_dir", "real_mode", "real_dir_or_tfds",
                 "num_fake", "num_real", "img_size", "batch_size", "num_workers", "warnings"}
EVAL_CSV_HEADER = ["rank", "fake_path", "distance", "cosine_similarity", "nearest_real_path"]


def write_jpeg_folder(folder: Path, count: int, seed: int, size: int = 256) -> None:
    """``count`` size x size JPEGs, each from its own numpy seed (smooth
    colour fields with noise), written from a pool of 8 threads."""
    from PIL import Image

    folder.mkdir(parents=True)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)

    def one(i):
        rng = np.random.default_rng((seed, i))
        a = rng.uniform(0, 1, (3, 3))
        img = np.stack([a[c, 0] * yy + a[c, 1] * xx + a[c, 2] for c in range(3)], -1)
        img = img / img.max() * 200 + rng.normal(0, 12, (size, size, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(folder / f"{i:05d}.jpg",
                                                                     quality=90)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(count)))


def seeded_inception_state_dict(seed: int = 0) -> dict:
    """Weights for the port's InceptionV3FID from numpy streams keyed by each
    leaf's name: He-normal conv kernels and well-conditioned BatchNorm
    statistics (scale U(0.9, 1.1), bias N(0, 0.05), mean N(0, 0.1), var
    U(0.9, 1.1)), so that activations stay O(1) through the ~90 convs: the
    rule of the JAX package's golden pool3 weights."""
    import zlib

    from gan_variant_research_tpu_torch.evalsuite.inception import InceptionV3FID

    sd = {}
    for name, t in InceptionV3FID().state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        rng = np.random.default_rng((zlib.crc32(name.encode()) << 8) ^ seed)
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if name.endswith("conv.weight"):
            a = rng.normal(0.0, (2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5, shape)
        elif leaf in ("weight", "running_var"):
            a = rng.uniform(0.9, 1.1, shape)
        elif leaf == "bias":
            a = rng.normal(0.0, 0.05, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    return sd


def phase_eval() -> dict:
    """``run_evaluation`` of the port on the card over seeded folders of
    EVAL_FAKE fake and EVAL_REAL real 256^2 JPEGs (the Kaggle submission's
    minimum and the Monet set), seeded Inception weights, batch 64 at 299^2
    in float32 with TF32 off, KID and precision/recall on: first with the
    real-stats cache empty, then from it. Asserts finite scores, the cache
    hit with the first run's scores, the reports in the JAX schema, the
    card's features for EVAL_CHECK_IMAGES images within 1e-4 of the
    largest value of the port's CPU features, and that no hand-written
    kernel launched. Prints the extractor's images/s on the card, each
    stage's seconds and the decode thread's share of the wall time."""
    import csv
    import shutil

    from gan_variant_research_tpu_torch.evalsuite.cli import run_evaluation
    from gan_variant_research_tpu_torch.evalsuite.datasets import iter_batches
    from gan_variant_research_tpu_torch.evalsuite.inception import InceptionFID
    from gan_variant_research_tpu_torch.evalsuite.utils import enumerate_images
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

    root = REPO / "build" / "eval"
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    write_jpeg_folder(root / "fake", EVAL_FAKE, 1)
    write_jpeg_folder(root / "real", EVAL_REAL, 2)
    weights = root / "inception_seeded.pth"
    torch.save(seeded_inception_state_dict(), weights)
    setup_s = time.perf_counter() - t
    cfg = {"name": "smoke", "fake_dir": str(root / "fake"), "real_dir": str(root / "real"),
           "real_mode": "folder", "out_dir": str(root / "reports"),
           "cache_dir": str(root / "cache"), "batch_size": EVAL_BATCH, "num_workers": 8,
           "img_size": EVAL_SIZE, "cosine_eps": 0.1, "use_cache": True,
           "inception_weights": str(weights), "kid": True, "pr": True}

    reset_counts(resblock)
    reset_attn_counts(sa)
    runs = []
    for _ in range(2):
        stats = {}
        t = time.perf_counter()
        report = run_evaluation(copy.deepcopy(cfg), device="cuda", stats=stats)
        torch.cuda.synchronize()
        runs.append((report, stats, time.perf_counter() - t))
    launched = (counts(resblock), attn_counts(sa), attn_route_counts(sa))
    check(launched == ((0, 0, 0), (0, 0, 0), dict.fromkeys(sa.ATTN_ROUTES, 0)),
          f"eval launched hand-written kernels: {launched}")

    (first, st1, wall1), (second, st2, wall2) = runs
    scores = first["scores"]
    values = [scores["fid"], scores["mifid"], scores["kid"]["kid_mean"],
              scores["kid"]["kid_std"], scores["precision_recall"]["precision"],
              scores["precision_recall"]["recall"]]
    check(all(np.isfinite(v) for v in values), f"non-finite eval scores {scores}")
    check(st1["extractor"]["images"] == EVAL_FAKE + EVAL_REAL
          and st2["extractor"]["images"] == EVAL_FAKE,
          f"images extracted {st1['extractor']['images']}, {st2['extractor']['images']}: "
          "the second run must take the real set from the cache")
    check(second["scores"] == scores, f"the cached run's scores {second['scores']} differ "
          f"from the first run's {scores}")
    check(set(first) == EVAL_REPORT_KEYS and set(first["run"]) == EVAL_RUN_KEYS
          and set(scores) == {"mifid", "fid", "cosine_min_distance", "kid", "precision_recall"}
          and first["run"]["num_fake"] == EVAL_FAKE and first["run"]["num_real"] == EVAL_REAL,
          f"report keys {sorted(first)}, run {sorted(first['run'])}, scores {sorted(scores)}")
    csvs = sorted((root / "reports").glob("*_worst_cases.csv"))
    summaries = sorted((root / "cache" / "logs").glob("*.txt"))
    check(len(csvs) == 2 and len(summaries) == 2 and len(list(
        (root / "reports").glob("*_report.json"))) == 2, "reports, summaries or CSVs missing")
    with open(csvs[0]) as f:
        rows = list(csv.reader(f))
    check(rows[0] == EVAL_CSV_HEADER and len(rows) == 17, f"worst-cases CSV {rows[:2]}")
    check("KAGGLE MiFID EVALUATION REPORT" in summaries[0].read_text(), "text summary")

    # the card's features against the port's CPU features on the same images
    paths = enumerate_images(root / "fake")[:EVAL_CHECK_IMAGES]
    batch, _ = next(iter_batches(paths, EVAL_CHECK_IMAGES, EVAL_SIZE, 8))
    card = InceptionFID(weights, device="cuda")
    got = card.features_u8(batch)
    want = InceptionFID(weights, device="cpu").features_u8(batch)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    check(got.shape == (EVAL_CHECK_IMAGES, 2048) and err <= 1e-4 * scale,
          f"card features {err} from the CPU's, over 1e-4 of {scale}")

    # the extractor's rate on the card: device-resident uint8 batches
    u8 = torch.from_numpy(batch).cuda()
    ms = event_ms(lambda: card.features(u8), iters=10)
    extract_s = [st["stage_s"]["4_building"] + st["stage_s"]["5_computing"] for st in (st1, st2)]
    out = {"images_per_s": EVAL_CHECK_IMAGES / ms * 1e3, "batch_ms": ms,
           "feature_max_abs_err": err, "feature_scale": scale, "scores": scores,
           "stage_s": [st1["stage_s"], st2["stage_s"]], "wall_s": [wall1, wall2],
           "decode_share": [st["extractor"]["decode_s"] / w
                            for st, w in ((st1, wall1), (st2, wall2))]}
    phase("eval", model="inception-v3-fid(seeded)", fake=EVAL_FAKE, real=EVAL_REAL,
          img_size=EVAL_SIZE, batch=EVAL_BATCH, dtype="float32", tf32=False,
          fid=f"{scores['fid']:.4f}", mifid=f"{scores['mifid']:.4f}",
          kid=f"{scores['kid']['kid_mean']:.6f}",
          precision=scores["precision_recall"]["precision"],
          recall=scores["precision_recall"]["recall"], cache_hit_scores_equal=True,
          card_vs_cpu_features_max_abs_err=f"{err:.3e}", feature_scale=f"{scale:.3e}",
          kernel_launches=0, setup_s=f"{setup_s:.2f}")
    for i, (st, wall) in enumerate(((st1, wall1), (st2, wall2))):
        phase("eval_stages", run=("cache_empty", "cache_hit")[i], wall_s=f"{wall:.3f}",
              images=st["extractor"]["images"], decode_s=f"{st['extractor']['decode_s']:.3f}",
              decode_share=f"{out['decode_share'][i]:.4f}",
              extract_images_per_s=f"{st['extractor']['images'] / extract_s[i]:.1f}",
              **{f"{k}_s": f"{v:.3f}" for k, v in st["stage_s"].items()})
    phase("timing", op="inception_fid_features", batch=EVAL_CHECK_IMAGES,
          shape=f"{EVAL_CHECK_IMAGES}x{EVAL_SIZE}x{EVAL_SIZE}x3", dtype="float32", tf32=False,
          batch_ms=f"{ms:.3f}", images_per_s=f"{out['images_per_s']:.1f}")
    del card, u8
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# CycleGAN: the trunk kernels at its batches, its step, a run and serving

CYCLEGAN_CONFIGS = REPO / "gan_variant_research_tpu_torch" / "configs"
CYCLEGAN_TIMED_STEPS = 10
CG_RUN_A, CG_RUN_B, CG_RUN_SIZE = 48, 32, 300
CG_RUN_BATCH, CG_RUN_STEPS, CG_RUN_MORE, CG_RUN_SAVE_EVERY = 4, 48, 24, 2
CG_SERVE_PHOTOS = 32


def cyclegan_config(name: str, **model) -> dict:
    """The port's copy of a shipped CycleGAN config (read by the port's
    ``load_config``), ``model`` keys overridden."""
    from gan_variant_research_tpu_torch.core.config import load_config

    cfg = load_config(CYCLEGAN_CONFIGS / name)
    cfg["model"].update(model)
    return cfg


def cyclegan_batches(rng, cfg, n):
    b, load = cfg["training"]["batch_size"], cfg["data"]["load_size"]
    return [tuple(torch.from_numpy(rng.integers(0, 256, (b, load, load, 3), dtype=np.uint8))
                  .cuda() for _ in range(2)) for _ in range(n)]


def cyclegan_fp32_vs_plain(cfg) -> tuple[float, dict]:
    """One float32 step of ``cfg`` at batch 1 on the kernel path and on the
    plain path, from one seeded state and one set of draws, under
    ``cudnn.deterministic``. Returns (the losses' largest relative
    difference, Adam mu's difference per leaf over the leaf's largest
    value)."""
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

    cfg32 = copy.deepcopy(cfg)
    cfg32["runtime"]["precision"] = "fp32"
    cfg32["training"]["batch_size"] = 1
    trainer = CycleGANTrainer(cfg32, steps_per_epoch=1)
    (a, b), = cyclegan_batches(np.random.default_rng(21), cfg32, 1)
    draws = trainer.sample_draws(torch.Generator(device="cuda").manual_seed(1), a.shape)
    torch.backends.cudnn.deterministic = True
    results = {}
    for path in ("kernel", "plain"):
        state = trainer.init_state(device="cuda")
        with contextlib.ExitStack() as stack:
            if path == "plain":
                stack.enter_context(plain_path(resblock, sa))
            state, losses = trainer.train_step(state, a, b, draws=draws)
        results[path] = (state, {k: float(v) for k, v in losses.items()})
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    lk, lp = results["kernel"][1], results["plain"][1]
    loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-6) for k in lk)
    rels = {}
    for opt in ("opt_g", "opt_da", "opt_db"):
        mk, mp = getattr(results["kernel"][0], opt).mu, getattr(results["plain"][0], opt).mu
        for n in mp:
            rels[f"{opt}:{n}"] = (float((mk[n] - mp[n]).abs().max())
                                  / max(float(mp[n].abs().max()), 1e-30))
    return loss_rel, rels


def cyclegan_steps(name: str, cfg, rng, expect_trunk: bool) -> dict:
    """A warmup step and CYCLEGAN_TIMED_STEPS bf16 steps of ``cfg`` from a
    seeded state on seeded uint8 batches: every step's trunk launches (54
    forwards, 54 dx, 54 dw, each on its bf16 wgmma route, or none without a
    ResNet), finite losses, all four nets moved; ms a step over the timed
    steps run back to back (host clock ending in a synchronise), peak
    memory, then one profiled step."""
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

    trainer = CycleGANTrainer(cfg, steps_per_epoch=1)
    state = trainer.init_state(device="cuda")
    start = {k: {n: t.detach().clone() for n, t in getattr(state, k).items()}
             for k in ("g_params", "da_params", "db_params")}
    batches = cyclegan_batches(rng, cfg, CYCLEGAN_TIMED_STEPS + 1)
    want = (3 * TRUNK_CONVS,) * 3 if expect_trunk else (0, 0, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(resblock)
    losses_seen = []
    for i, (a, b) in enumerate(batches):
        if i == 1:   # the first step warms up
            torch.cuda.synchronize()
            t = time.perf_counter()
        before, routes, dbs = counts(resblock), route_counts(resblock), db_count()
        state, losses = trainer.train_step(state, a, b)
        step_counts = tuple(x - y for x, y in zip(counts(resblock), before))
        check(step_counts == want, f"{name} step {i} launched {step_counts}, want {want}")
        # the bias-free trunk: no dw launch sums a bias gradient
        check(db_count() == dbs, f"{name} step {i}: {db_count() - dbs} dw launches summed db")
        if expect_trunk:
            check_routes(resblock, routes, dict.fromkeys(routes, want[0]), f"{name} step")
        losses_seen.append(losses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = counts(resblock)
    for i, losses in enumerate(losses_seen):
        vals = {k: float(v) for k, v in losses.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"{name} step {i}: losses {vals}")
    last_losses = {k: float(v) for k, v in losses_seen[-1].items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = {k: max(float((getattr(state, k)[n].detach() - t).abs().max())
                    for n, t in start[k].items()) for k in start}
    g_moved = {g: max(float((state.g_params[n].detach() - t).abs().max())
                      for n, t in start["g_params"].items() if n.startswith(g))
               for g in ("G_A2B", "G_B2A")}
    check(all(v > 0 for v in (*moved.values(), *g_moved.values())),
          f"{name}: parameters did not move: {moved} {g_moved}")
    ms = wall / CYCLEGAN_TIMED_STEPS * 1e3
    b = cfg["training"]["batch_size"]
    phase("cyclegan", cell=name, generator=cfg["model"]["generator"], dtype="bf16", batch=b,
          steps=f"1+{CYCLEGAN_TIMED_STEPS}", launches_fwd_dx_dw="/".join(map(str, launches)),
          per_step="/".join(map(str, want)), step_ms=f"{ms:.2f}",
          images_per_s=f"{b / ms * 1e3:.2f}", peak_memory_gb=f"{peak_gb:.2f}",
          **{f"{k}_max_move": f"{v:.3e}" for k, v in {**moved, **g_moved}.items()},
          **{k: f"{v:.4f}" for k, v in last_losses.items()})
    a, b_u8 = batches[-1]
    busy = profile_once(lambda: trainer.train_step(state, a, b_u8), f"cyclegan_step_{name}",
                        rows=15)
    del trainer, state, batches, start
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gb": peak_gb, "launches": launches, **busy}


def queued_us(fn, iters: int = 50) -> float:
    """Device time in us of one call of ``fn``, whatever the host's launch
    cost: ``iters`` calls are queued behind a spin kernel and timed on CUDA
    events from its end, so the device runs them back to back. Checked:
    the spin is still running when the last call is queued (else the
    spin is lengthened and the timing taken again)."""
    fn()
    torch.cuda.synchronize()
    cycles = iters * 400_000            # ~200 us of spin a call at 2 GHz
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) * 1e3 / iters
        cycles *= 4
    raise RuntimeError("chip_smoke: the host did not queue the calls ahead of the device")


def phase_dw_db_timing(gen) -> None:
    """dw with and without the bias gradient at the CUT trunk's (12, 64, 64,
    256) and CycleGAN's (1, ...) and (48, ...), bf16: CUDA events around
    back-to-back calls in the order without, with, with, without, and each
    queued ahead of the device (``queued_us``, the device's time where the
    host's launch cost sets the events' pace at batch 1)."""
    from gan_variant_research_tpu_torch.ops.kernels import resblock

    for n in (TRAIN_SHAPE[0], CYCLEGAN_BATCHES[0], CYCLEGAN_BATCHES[-1]):
        shape = (n, 64, 64, 256)
        x, _, _ = conv_inputs(shape, 256, torch.bfloat16, gen)
        dy = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        without = lambda: resblock._launch_dw(x, dy)  # noqa: E731
        with_db = lambda: resblock._launch_dw(x, dy, with_db=True)  # noqa: E731
        iters = 20 if n == 1 else 10
        a1, b1, b2, a2 = (event_ms(f, iters) for f in (without, with_db, with_db, without))
        dev_a, dev_b = queued_us(without), queued_us(with_db)
        phase("timing", op="reflect_conv3x3_dw_db", shape="x".join(map(str, shape)),
              dtype="bf16", without_db_ms=f"{a1:.4f}/{a2:.4f}", with_db_ms=f"{b1:.4f}/{b2:.4f}",
              with_over_without=f"{(b1 + b2) / (a1 + a2):.4f}",
              without_db_device_us=f"{dev_a:.2f}", with_db_device_us=f"{dev_b:.2f}",
              device_with_over_without=f"{dev_b / dev_a:.4f}")
        del x, dy
    torch.cuda.empty_cache()


def cyclegan_kernel_timing(gen) -> dict:
    """The trunk forward, dx and dw at CycleGAN's (1, 64, 64, 256) and
    (48, 64, 64, 256), bf16, on CUDA events: kernel, plain, kernel, plain,
    then cuDNN's call (reflect pad + conv + bias; backward-data;
    backward-weight), and each bound; the kernel's and cuDNN's calls also
    queued ahead of the device (``queued_us``: at batch 1, events around
    back-to-back calls time the host's launch cost)."""
    from gan_variant_research_tpu_torch.ops.kernels import resblock

    out = {}
    for n in (CYCLEGAN_BATCHES[0], CYCLEGAN_BATCHES[-1]):
        shape = (n, 64, 64, 256)
        x, w, b = conv_inputs(shape, 256, torch.bfloat16, gen)
        dy = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        w_oihw, dy_nchw = w.permute(3, 2, 0, 1).contiguous(), dy.permute(0, 3, 1, 2)
        grad = lambda mask: (lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            dy_nchw, xp, w_oihw, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask))
        ops = {"fwd": (lambda: resblock.reflect_conv3x3(x, w, b),
                       lambda: resblock.reflect_conv3x3_reference(x, w, b),
                       lambda: cudnn_conv(x, w, b)),
               "dx": (lambda: resblock.reflect_conv3x3_dx(dy, w),
                      lambda: resblock.reflect_conv3x3_dx_reference(dy, w),
                      grad([True, False, False])),
               "dw": (lambda: resblock.reflect_conv3x3_dw(x, dy),
                      lambda: resblock.reflect_conv3x3_dw_reference(x, dy),
                      grad([False, True, False]))}
        flop = 2 * 9 * int(np.prod(shape)) * 256
        act, w_bytes = int(np.prod(shape)) * 2, 9 * 256 * 256 * 2
        nbytes = {"fwd": 2 * act + w_bytes + 256 * 4, "dx": 2 * act + w_bytes,
                  "dw": 2 * act + 9 * 256 * 256 * 4}
        iters = 20 if n == 1 else 10
        for op, (kernel, plain, library) in ops.items():
            k1 = event_ms(kernel, iters)
            p1 = event_ms(plain, 3)
            k2 = event_ms(kernel, iters)
            p2 = event_ms(plain, 3)
            lib = event_ms(library, iters)
            bound = bound_ms(flop, nbytes[op], PEAK_BF16_FLOPS)
            dev_us, lib_dev_us = queued_us(kernel), queued_us(library)
            out[(op, n)] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                            "bound_ms": bound[0], "bound_by": bound[1],
                            "device_ms": dev_us / 1e3, "library_device_ms": lib_dev_us / 1e3}
            phase("timing", op=f"reflect_conv3x3_{op}" if op != "fwd" else "reflect_conv3x3",
                  cell="cyclegan", shape="x".join(map(str, shape)), dtype="bf16",
                  kernel_ms=f"{k1:.4f}/{k2:.4f}", plain_ms=f"{p1:.4f}/{p2:.4f}",
                  cudnn_bf16_ms=f"{lib:.4f}", bound_ms=f"{bound[0]:.4f}",
                  kernel_vs_cudnn=f"{(k1 + k2) / 2 / lib:.3f}",
                  kernel_device_us=f"{dev_us:.2f}", cudnn_device_us=f"{lib_dev_us:.2f}")
        del x, w, b, dy, xp, w_oihw, dy_nchw
    torch.cuda.empty_cache()
    return out


def phase_cyclegan(gen) -> dict:
    """The CycleGAN slice on the card: the trunk kernels timed at its
    batches; the float32 step at batch 1 through the kernels against the
    plain path; bf16 steps at baseline.yaml (batch 1) and baseline_tpu.yaml
    (batch 16), and the U-Net at batch 1; a run through
    ``cli/train_cyclegan.main`` from seeded JPEG folders, then ``--resume
    auto``; serving its last checkpoint in both directions through
    ``cli/generate_folder.main``."""
    import shutil
    import zipfile

    from PIL import Image

    from gan_variant_research_tpu_torch.cli import generate_folder as gf
    from gan_variant_research_tpu_torch.cli import train_cyclegan as cli
    from gan_variant_research_tpu_torch.data.loader import UnpairedLoader
    from gan_variant_research_tpu_torch.ops.kernels import resblock
    from gan_variant_research_tpu_torch.train import checkpoint as ck
    from gan_variant_research_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

    out = {"kernels": cyclegan_kernel_timing(gen)}
    base, tpu = cyclegan_config("baseline.yaml"), cyclegan_config("baseline_tpu.yaml")

    # 1. float32, batch 1: the kernels against the plain path
    loss_rel, mu_rels = cyclegan_fp32_vs_plain(base)
    worst = sorted(mu_rels, key=mu_rels.get, reverse=True)[:4]
    phase("cyclegan", cell="fp32_vs_plain", batch=1, loss_max_rel=f"{loss_rel:.3e}",
          adam_mu_max_rel_to_leaf_max=f"{mu_rels[worst[0]]:.3e}",
          worst_leaves=",".join(f"{n}={mu_rels[n]:.2e}" for n in worst))
    check(loss_rel <= 1e-4, f"CycleGAN fp32 step losses differ from the plain path by {loss_rel}")
    check(mu_rels[worst[0]] <= 1e-3,
          f"CycleGAN fp32 step Adam mu differs from the plain path by {mu_rels[worst[0]]}")

    # 2., 3. bf16 steps: baseline.yaml, baseline_tpu.yaml, the U-Net option
    rng = np.random.default_rng(23)
    out["baseline"] = cyclegan_steps("baseline", base, rng, expect_trunk=True)
    out["baseline_tpu"] = cyclegan_steps("baseline_tpu", tpu, rng, expect_trunk=True)
    out["unet"] = cyclegan_steps("unet", cyclegan_config("baseline.yaml", generator="unet"), rng,
                                 expect_trunk=False)

    # 4. a run through the CLI, then --resume auto
    root = REPO / "build" / "cyclegan_run"
    shutil.rmtree(root, ignore_errors=True)
    write_jpeg_folder(root / "photo_jpg", CG_RUN_A, 31, CG_RUN_SIZE)
    write_jpeg_folder(root / "monet_jpg", CG_RUN_B, 32, CG_RUN_SIZE)
    sets = [f"data.root={root}", "data.num_workers=8",
            f"training.batch_size={CG_RUN_BATCH}", f"training.save_every={CG_RUN_SAVE_EVERY}",
            f"training.save_dir={root / 'ckpt'}", f"training.log_dir={root / 'logs'}"]
    step_launches, waits = [], []
    real_step, real_next = CycleGANTrainer.train_step, UnpairedLoader.__next__

    def counted_step(self, *a, **kw):
        before = counts(resblock)
        result = real_step(self, *a, **kw)
        step_launches.append(tuple(x - y for x, y in zip(counts(resblock), before)))
        return result

    def timed_next(self):
        t = time.perf_counter()
        batch = real_next(self)
        waits.append(time.perf_counter() - t)
        return batch

    CycleGANTrainer.train_step, UnpairedLoader.__next__ = counted_step, timed_next
    reset_counts(resblock)
    walls = []
    try:
        for max_steps, resume in ((CG_RUN_STEPS, []), (CG_RUN_STEPS + CG_RUN_MORE,
                                                       ["--resume", "auto"])):
            t = time.perf_counter()
            state, trainer = cli.main(["--config", str(CYCLEGAN_CONFIGS / "baseline.yaml"),
                                       "--strict-config", *resume, "--set", *sets,
                                       f"training.max_steps={max_steps}"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if not resume:
                saved = sorted(p.name for p in (root / "ckpt").glob("*.msgpack"))
                blob = ck.load_checkpoint(ck.latest_checkpoint(root / "ckpt"))
                restored = trainer.state_from_payload(blob["payload"], blob["step"],
                                                      device="cuda")
                diff = states_equal(state, restored)
                del restored, blob
    finally:
        CycleGANTrainer.train_step, UnpairedLoader.__next__ = real_step, real_next
    launches = counts(resblock)
    n_steps = CG_RUN_STEPS + CG_RUN_MORE
    spe = max(CG_RUN_A, CG_RUN_B) // CG_RUN_BATCH
    epochs = n_steps // spe
    want_ckpts = [f"ckpt_e{e}.msgpack" for e in range(CG_RUN_SAVE_EVERY, CG_RUN_STEPS // spe + 1,
                                                      CG_RUN_SAVE_EVERY)]
    check(saved == sorted(want_ckpts), f"checkpoints {saved}, want {sorted(want_ckpts)}")
    check(not diff, f"the restored CycleGAN state differs from the saved one in {diff}")
    check(state.step == n_steps, f"the resumed run ended at step {state.step}")
    want = (3 * TRUNK_CONVS,) * 3
    check(len(step_launches) == n_steps and all(x == want for x in step_launches),
          f"{len(step_launches)} run steps; launches other than {want}: "
          f"{sorted(set(step_launches) - {want})}")
    check(launches == (n_steps * want[0],) * 3, f"CycleGAN run launched {launches}")
    logged = [json.loads(line) for line in
              (root / "logs" / "cyclegan_log.jsonl").read_text().splitlines()]
    check([d["epoch"] for d in logged] == list(range(1, epochs + 1))
          and all(np.isfinite(v) for d in logged for v in d.values()),
          f"log epochs {[d['epoch'] for d in logged]}, want 1..{epochs}, all finite")
    wall, wait = sum(walls), sum(waits)
    out["run"] = {"steps": n_steps, "steps_per_s": n_steps / wall, "loader_wait_share": wait / wall,
                  "launches": launches}
    phase("cyclegan", cell="run", config="baseline.yaml", batch=CG_RUN_BATCH,
          images=f"{CG_RUN_A}+{CG_RUN_B}@{CG_RUN_SIZE}", steps=f"{CG_RUN_STEPS}+{CG_RUN_MORE}",
          launches_fwd_dx_dw="/".join(map(str, launches)), checkpoints=",".join(saved),
          restored_bitwise=not diff, log_epochs=len(logged),
          steps_per_s=f"{out['run']['steps_per_s']:.3f}",
          run_wall_s="/".join(f"{w:.2f}" for w in walls),
          loader_wait_share=f"{out['run']['loader_wait_share']:.4f}")
    del state, trainer

    # 5. serving the run's last checkpoint in both directions
    last = root / "ckpt" / f"ckpt_e{epochs}.msgpack"
    write_jpeg_folder(root / "photos", CG_SERVE_PHOTOS, 33)
    for direction in ("A2B", "B2A"):
        dst, zpath = root / f"served_{direction}", root / f"{direction}.zip"
        gf.main(["--ckpt", str(last), "--photos", str(root / "photos"), "--out", str(dst),
                 "--direction", direction, "--zip", str(zpath)])
        written = sorted(dst.glob("*.jpg"))
        with Image.open(written[0]) as im:
            arr = np.asarray(im)
        with zipfile.ZipFile(zpath) as zf:
            names = sorted(zf.namelist())
        check(len(written) == CG_SERVE_PHOTOS and arr.dtype == np.uint8
              and arr.shape == (256, 256, 3) and names == sorted(
                  f"{i}.jpg" for i in range(CG_SERVE_PHOTOS)),
              f"served {direction}: {len(written)} JPEGs, {arr.dtype} {arr.shape}, zip {names[:3]}")
    net, _ = gf.load_generator_params(last, direction="A2B")
    net = net.to("cuda")
    u8 = torch.from_numpy(rng.integers(0, 256, (TIME_BATCH, 256, 256, 3), dtype=np.uint8)).cuda()
    reset_counts(resblock)
    served = gf.stylize_batch(net, u8)
    torch.cuda.synchronize()
    check(served.dtype == torch.uint8 and tuple(served.shape) == (TIME_BATCH, 256, 256, 3)
          and counts(resblock) == (TRUNK_CONVS, 0, 0),
          f"served {served.dtype} {tuple(served.shape)}, launches {counts(resblock)}")
    serve_ms = wall_ms(lambda: gf.stylize_batch(net, u8), 5)
    out["serve_ms"] = serve_ms
    phase("cyclegan", cell="serve", generator="resnet-bias-free", batch=TIME_BATCH,
          directions="A2B,B2A", photos=CG_SERVE_PHOTOS, stylize_batch_ms=f"{serve_ms:.3f}",
          images_per_s=f"{TIME_BATCH / serve_ms * 1e3:.2f}")
    del net, u8, served
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build, 3. kernels, 4. autograd (plain versions in full float32)
    phase_build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernels(gen)
    errs.update(phase_attention_kernels(gen))
    norm_times = phase_norm(gen)
    phase_attention_tolerance()
    phase_autograd(gen)
    phase_attention_autograd(gen)

    # 5. serve, 6. train: the flagship generator, then the variant one
    rng = np.random.default_rng(0)
    net, serve_launches = phase_serve(rng)
    trainer, state, batches, train_launches = phase_train(
        rng, flagship_params(rng), flagship_d_params(rng))
    vnet = phase_serve_variant(rng)
    vtrainer, vstate, vbatches, attn_launches = phase_train_variant(
        rng, variant_params(rng), flagship_d_params(rng))
    phase_cut_graph(np.random.default_rng(16))

    # 7. timing
    conv_ms, grad_ms, norm_launches = phase_timing(gen, rng, net, trainer, state, batches)
    phase_dw_db_timing(torch.Generator(device="cuda").manual_seed(20))
    attn = phase_timing_variant(gen, rng, vnet, vtrainer, vstate, vbatches)
    del net, trainer, state, batches, vnet, vtrainer, vstate, vbatches
    torch.cuda.empty_cache()

    # 8. attention widths, 9. a training run, each with its counts set to 0
    widths = phase_attention_widths(gen, np.random.default_rng(11))
    run = phase_train_run()

    # 10. MiFID/FID evaluation, with every count set to 0 (it launches none)
    phase_eval()

    # 11. CycleGAN: kernels at its batches, steps, a run, serving
    cg = phase_cyclegan(gen)

    phase_norm_parts(gen)
    bf16 = torch.bfloat16
    serve_shape = (TIME_BATCH, 64, 64, 256)
    flops = lambda shape: 2 * 9 * int(np.prod(shape)) * 256
    act = lambda shape: int(np.prod(shape)) * 2
    w_bytes = 9 * 256 * 256 * 2
    fwd_bound = lambda shape: bound_ms(flops(shape), 2 * act(shape) + w_bytes + 256 * 4,
                                       PEAK_BF16_FLOPS)
    conv_bounds = {
        "dx": bound_ms(flops(TRAIN_SHAPE), 2 * act(TRAIN_SHAPE) + w_bytes, PEAK_BF16_FLOPS),
        "dw": bound_ms(flops(TRAIN_SHAPE), 2 * act(TRAIN_SHAPE) + 9 * 256 * 256 * 4,
                       PEAK_BF16_FLOPS)}
    attn_bounds = {k: bound_ms(attention_flops(ATTN_SHAPE)[k], attention_bytes(ATTN_SHAPE, 2)[k],
                               PEAK_BF16_FLOPS) for k in ("fwd", "dkv", "dq")}

    def row(name, replaces, launches, err, ms, plain_ms, bound, library_ms, covers=None, **extra):
        # library_covers: the rows whose work library_ms does, all in one call
        # (SDPA's backward computes dK, dV and dQ: compare it with the pair)
        return {"name": name, "route": "cuda",
                "source": f"gan_variant_research_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, "library_covers": covers or [name], **extra}

    resblock_py = "gan_variant_research_tpu/ops/pallas/resblock.py:{}"
    flash_py = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} "
                "(gan_variant_research_tpu/models/attention.py:129)")
    times = attn["times"]
    attn_bwd = ["spatial_attention_dkv", "spatial_attention_dq"]

    def cyclegan(op, i):
        # per step of baseline.yaml / baseline_tpu.yaml, and over the CLI run;
        # times, bounds and cuDNN's at (1|48, 64, 64, 256)
        k = cg["kernels"]
        return {"cyclegan_launches": {"per_step": 3 * TRUNK_CONVS,
                                      "run": cg["run"]["launches"][i]},
                **{f"cyclegan_{key}": {f"{n}x64x64x256": k[(op, n)][key]
                                       for n in (CYCLEGAN_BATCHES[0], CYCLEGAN_BATCHES[-1])}
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                               "library_device_ms")}}

    def dqk128(kind, i):
        # the d_qk-128 instance (ngf 160 and 256 in attention_widths): its
        # launches there, its times at DQK128_SHAPE (backward at its chunk)
        row = widths["dqk128"][kind]
        return {"dqk128_launches": widths["dqk128_launches"][i],
                **{f"dqk128_{key}": val for key, val in row.items()}}

    print(json.dumps({"kernels": [
        # the times, bound and library time at the train step's batch 12,
        # where its `launches` run; the served batch of 32 beside them
        row("reflect_conv3x3", resblock_py.format(156), train_launches[0],
            errs[("fwd", TRAIN_SHAPE, bf16)], conv_ms[TRAIN_SHAPE[0]]["kernel"],
            conv_ms[TRAIN_SHAPE[0]]["plain"], fwd_bound(TRAIN_SHAPE),
            conv_ms[TRAIN_SHAPE[0]]["cudnn_bf16"], shape=list(TRAIN_SHAPE),
            serve_shape=list(serve_shape), serve_launches=serve_launches,
            serve_ms=conv_ms[TIME_BATCH]["kernel"], serve_plain_ms=conv_ms[TIME_BATCH]["plain"],
            serve_bound_ms=fwd_bound(serve_shape)[0],
            serve_library_ms=conv_ms[TIME_BATCH]["cudnn_bf16"],
            train_run_launches=run["launches"][0], **cyclegan("fwd", 0)),
        row("reflect_conv3x3_dx", resblock_py.format(229), train_launches[1],
            errs[("dx", TRAIN_SHAPE, bf16)], grad_ms["dx"][0], grad_ms["dx"][1],
            conv_bounds["dx"], grad_ms["dx"][2], train_run_launches=run["launches"][1],
            **cyclegan("dx", 1)),
        row("reflect_conv3x3_dw", resblock_py.format(297), train_launches[2],
            errs[("dw", TRAIN_SHAPE, bf16)], grad_ms["dw"][0], grad_ms["dw"][1],
            conv_bounds["dw"], grad_ms["dw"][2], train_run_launches=run["launches"][2],
            **cyclegan("dw", 2)),
        row("spatial_attention", flash_py.format(758), attn_launches[0],
            errs[("fwd", ATTN_SHAPE, bf16)], times["fwd"][0], times["fwd"][1],
            attn_bounds["fwd"], attn["library"]["fwd"], **dqk128("fwd", 0)),
        row("spatial_attention_dkv", flash_py.format(1121), attn_launches[1],
            errs[("dkv", ATTN_SHAPE, bf16)], times["dkv"][0], times["dkv"][1],
            attn_bounds["dkv"], attn["library"]["bwd"], attn_bwd, **dqk128("dkv", 1)),
        row("spatial_attention_dq", flash_py.format(1456), attn_launches[2],
            errs[("dq", ATTN_SHAPE, bf16)], times["dq"][0], times["dq"][1],
            attn_bounds["dq"], attn["library"]["bwd"], attn_bwd, **dqk128("dq", 2)),
        # no TPU kernel: XLA fuses the JAX formula; times at the trunk shape,
        # forward and backward apart, and at the stem's (12, 256, 256, 64)
        {"name": "instance_norm", "route": "cuda",
         "source": "gan_variant_research_tpu_torch/csrc/instance_norm.cu",
         "replaces": "none (ops/nn_ops.py::instance_norm, fused by XLA in the JAX package)",
         # each kernel's runs in one replayed warmup step (torch.profiler)
         "launches_a_step": norm_launches,
         **{f"{k}_{'x'.join(map(str, shape))}": norm_times[shape][k]
            for shape in NORM_TIMED[:2]
            for k in ("fwd", "bwd", "fwd_bwd", "plain_fwd", "plain_fwd_bwd", "bound_fwd",
                      "bound_bwd")}},
    ], "serve_launches": serve_launches}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
