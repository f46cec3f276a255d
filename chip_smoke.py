#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: serving and training.

    python3 chip_smoke.py

Phases, one line each:

1. device   - requires CUDA (there is no CPU fallback); prints the card's
              name and power limit as nvidia-smi gives them;
2. build    - builds the three hand-written kernels from csrc/ (nvcc,
              sm_90a), all at once;
3. kernels  - each kernel against its plain PyTorch version on the card
              (TF32 off): the trunk conv, its input grad (dx) and its
              weight grad (dw), at the trunk shapes in float32 and bf16
              and at ragged shapes down to H, W of 2 and 3; dw run twice
              must be bitwise equal;
4. autograd - the gradient of one float32 trunk conv through the
              autograd.Function against autograd of the plain version;
5. serve    - the flagship CUT generator (ResNet-9, ngf 64, 9 blocks,
              bf16 compute, fp32 params; weights made from a seed with numpy
              in the JAX package's layout, converted by convert.py) serves 3
              batches of 8 seeded 256x256 photos through stylize_batch, 18
              trunk launches a batch; a float32 forward at batch 2 through
              the kernel and through the plain version agree to 1e-3;
6. train    - the flagship CUT step (train_gan_cutpp.yaml as FLAGSHIP_CUT:
              batch 12, 256^2, bf16, PatchGAN ndf 64 with 3 layers, DiffAugment,
              PatchNCE 256 patches on [0, 4, 8, 12, 16], R1 gamma 10 every
              16, identity warmup) runs 4 steps through CUTTrainer.train_step
              with seeded uint8 batches; step 0 is an R1 step. Every step
              must launch 54 trunk forwards, 54 dx and 54 dw (3 G passes x 18
              trunk convs, each with its backward); losses finite; G, D and
              EMA moved. Then one float32 step at batch 2 through the kernels
              and through the plain versions, from one state and one set of
              draws: losses agree to 1e-4, Adam's mu per leaf to 1e-3 of the
              leaf's max;
7. timing   - trunk conv at batch 32 (serving) and dx, dw at batch 12 (the
              train step), bf16, against their plain versions (CUDA events);
              a served batch of 32; ms per train step (warmup and R1) on the
              kernel path and the plain path; one torch.profiler op table of
              a warmup step.

Any failure raises and exits non-zero. The second-to-last line is the
kernel table as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
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

# The keys of gan_variant_research_tpu/configs/train_gan_cutpp.yaml that the
# train step reads (core/config.py::STEP_KEYS); tests/test_torch_cut_parts.py
# holds this dict against the YAML. The machine with the card has no PyYAML.
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


def uniform_conv(rng, kh, c_in, c_out, fan_in):
    """A JAX conv's ``kernel`` (HWIO) and ``bias`` with PyTorch's default
    init bounds U(+-1/sqrt(fan_in))."""
    bound = 1.0 / np.sqrt(fan_in)
    return {"kernel": rng.uniform(-bound, bound, (kh, kh, c_in, c_out)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (c_out,)).astype(np.float32)}


def flagship_params(rng: np.random.Generator) -> dict:
    """The JAX generator's param tree at the flagship width, with PyTorch's
    default init bounds U(+-1/sqrt(fan_in))."""
    ngf, n_down, n_blocks = FLAGSHIP["ngf"], FLAGSHIP["n_downsampling"], FLAGSHIP["n_blocks"]
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


def counts(resblock) -> tuple[int, int, int]:
    return resblock.LAUNCHES, resblock.DX_LAUNCHES, resblock.DW_LAUNCHES


def reset_counts(resblock) -> None:
    resblock.LAUNCHES = resblock.DX_LAUNCHES = resblock.DW_LAUNCHES = 0


def before_instance_norm(name: str) -> bool:
    """G's conv biases that an instance norm follows: analytic gradient 0."""
    return name.endswith("bias") and not name.startswith("output_conv")


# --------------------------------------------------------------------------- #

def phase_build() -> None:
    from gan_variant_research_tpu_torch.ops.kernels import _build, resblock

    builds = {"reflect_conv3x3": resblock._forward_fn, "reflect_conv3x3_dx": resblock._dx_fn,
              "reflect_conv3x3_dw": resblock._dw_fn}

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        for name, fut in futures.items():
            phase("build", kernel=name, seconds=f"{fut.result():.2f}",
                  library=_build.library_path(name).relative_to(REPO))


def phase_kernels(gen) -> dict:
    from gan_variant_research_tpu_torch.ops.kernels import resblock

    errs = {}
    cases = [(CONV_SHAPE, 256, torch.float32), (CONV_SHAPE, 256, torch.bfloat16),
             ((2, 5, 7, 40), 40, torch.float32), ((2, 5, 7, 40), 40, torch.bfloat16),
             ((3, 17, 33, 130), 70, torch.float32), ((3, 17, 33, 130), 70, torch.bfloat16),
             ((2, 2, 3, 13), 21, torch.bfloat16)]
    for shape, c_out, dtype in cases:
        x, w, b = conv_inputs(shape, c_out, dtype, gen)
        y = resblock.reflect_conv3x3(x, w, b)
        torch.cuda.synchronize()
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
        phase("kernel", name="reflect_conv3x3", shape="x".join(map(str, shape)),
              c_out=c_out, dtype=str(dtype).split(".")[-1], max_abs_err=f"{d.max().item():.3e}",
              differing=f"{(d > 0).float().mean().item():.5f}", over_tol=bad)
        check(bad == 0, f"reflect_conv3x3 {shape} {dtype}: {bad} values over tolerance")

    grad_cases = [(TRAIN_SHAPE, 256, torch.float32), (TRAIN_SHAPE, 256, torch.bfloat16),
                  ((3, 17, 33, 130), 70, torch.float32), ((3, 17, 33, 130), 70, torch.bfloat16),
                  ((2, 2, 3, 13), 21, torch.float32), ((2, 2, 3, 13), 21, torch.bfloat16),
                  ((1, 3, 2, 8), 8, torch.float32), ((1, 3, 2, 8), 8, torch.bfloat16)]
    for shape, c_out, dtype in grad_cases:
        x, w, _ = conv_inputs(shape, c_out, dtype, gen)
        dy = torch.randn(shape[:3] + (c_out,), device="cuda", generator=gen).to(dtype)
        label = dict(shape="x".join(map(str, shape)), c_out=c_out, dtype=str(dtype).split(".")[-1])

        dx = resblock.reflect_conv3x3_dx(dy, w)
        torch.cuda.synchronize()
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
        phase("kernel", name="reflect_conv3x3_dx", **label, max_abs_err=f"{d.max().item():.3e}",
              differing=f"{(d > 0).float().mean().item():.5f}", over_tol=bad)
        check(bad == 0, f"reflect_conv3x3_dx {shape} {dtype}: {bad} values over tolerance")

        dw = resblock.reflect_conv3x3_dw(x, dy)
        dw2 = resblock.reflect_conv3x3_dw(x, dy)
        torch.cuda.synchronize()
        r = resblock.reflect_conv3x3_dw_reference(x, dy)
        check(dw.dtype == torch.float32 and dw.shape == r.shape, f"dw {shape} {dtype}: bad output")
        # float32 sums over N*H*W products in another order
        d = (dw - r).abs()
        rel = float(d.max() / r.abs().max())
        errs[("dw", shape, dtype)] = float(d.max())
        phase("kernel", name="reflect_conv3x3_dw", **label, max_abs_err=f"{d.max().item():.3e}",
              rel_to_max=f"{rel:.3e}", bitwise_repeatable=bool(torch.equal(dw, dw2)))
        check(rel <= 1e-4, f"reflect_conv3x3_dw {shape} {dtype}: {rel} of max over 1e-4")
        check(torch.equal(dw, dw2), f"reflect_conv3x3_dw {shape} {dtype}: two runs differ")
    return errs


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
        before = resblock.LAUNCHES
        out = stylize_batch(net, u8)
        torch.cuda.synchronize()
        check(resblock.LAUNCHES - before == TRUNK_CONVS,
              f"{resblock.LAUNCHES - before} trunk launches in a batch, want {TRUNK_CONVS}")
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
          batch=SERVE_BATCH, launches=launches[0],
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
        before = counts(resblock)
        state, losses = trainer.train_step(state, photos, monets)
        torch.cuda.synchronize()
        step_counts = tuple(a - c for a, c in zip(counts(resblock), before))
        vals = {k: float(v) for k, v in losses.items()}
        r1_values.append(vals["r1"])
        check(all(np.isfinite(v) for v in vals.values()), f"non-finite losses {vals}")
        phase("train", step=state.step - 1, r1_step=trainer.step_flags(state.step - 1)[0],
              launches_fwd_dx_dw="/".join(map(str, step_counts)),
              **{k: f"{v:.5f}" for k, v in vals.items() if k in
                 ("d_loss", "g_loss", "g_adv", "nce", "identity", "r1")})
        check(step_counts == want, f"step launched {step_counts} (fwd, dx, dw), want {want}")
    launches = counts(resblock)
    check(r1_values[0] > 0 and not any(r1_values[1:]), f"R1 cadence: {r1_values}")
    moved = {k: max(float((getattr(state, k)[n].detach() - t).abs().max())
                    for n, t in start[k].items()) for k in start}
    phase("train", model="cut-resnet9-ngf64+patchgan-ndf64", dtype="bf16", batch=b,
          steps=TRAIN_STEPS, launches_fwd_dx_dw="/".join(map(str, launches)),
          **{f"{k}_max_move": f"{v:.3e}" for k, v in moved.items()})
    check(all(v > 0 for v in moved.values()), f"parameters did not move: {moved}")

    # one float32 step at batch 2, kernel path against plain path
    cfg32 = copy.deepcopy(cfg)
    cfg32["runtime"]["precision"] = "fp32"
    t32 = CUTTrainer(cfg32)
    photos, monets = (t[:2] for t in batches[0])
    draws = t32.sample_draws(torch.Generator(device="cuda").manual_seed(1), 2)
    results = []
    # cuDNN's nondeterministic algorithms (the other convs, on both paths)
    # alone move Adam's mu by up to 1e-2 of a leaf's max between two runs of
    # one path; deterministic ones leave ~2e-5 between the paths
    torch.backends.cudnn.deterministic = True
    for path in ("kernel", "plain"):
        st = t32.state_from_jax(g_tree, d_tree, device="cuda")
        fn = resblock.reflect_conv3x3 if path == "kernel" else resblock.reflect_conv3x3_reference
        with trunk_conv(resblock, fn):
            st, losses = t32.train_step(st, photos, monets, step=0, draws=draws)
        results.append((st, {k: float(v) for k, v in losses.items()}))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    (sk, lk), (sp, lp) = results
    loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-6) for k in lk)
    mu_rels = {}
    for net, opt in (("g", "opt_g"), ("d", "opt_d")):
        mk, mp = getattr(sk, opt).mu, getattr(sp, opt).mu
        net_max = max(float(t.abs().max()) for t in mp.values())
        for n in mp:
            # G's biases before an instance norm: gradient 0, rounding noise
            scale = net_max if net == "g" and before_instance_norm(n) else float(mp[n].abs().max())
            mu_rels[f"{net}:{n}"] = float((mk[n] - mp[n]).abs().max()) / max(scale, 1e-30)
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


def phase_timing(gen, rng, net, trainer, state, batches):
    from torch.profiler import ProfilerActivity, profile

    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.ops.kernels import resblock

    x, w, b = conv_inputs((TIME_BATCH, 64, 64, 256), 256, torch.bfloat16, gen)
    conv_ms = {name: event_ms(lambda f=f: f(x, w, b), iters=10)
               for name, f in (("kernel", resblock.reflect_conv3x3),
                               ("plain", resblock.reflect_conv3x3_reference),
                               ("cudnn_bf16", cudnn_conv))}
    flop = 2 * 9 * TIME_BATCH * 64 * 64 * 256 * 256
    phase("timing", op="reflect_conv3x3", shape=f"{TIME_BATCH}x64x64x256", dtype="bf16",
          **{f"{k}_ms": f"{v:.4f}" for k, v in conv_ms.items()},
          kernel_tflops=f"{flop / conv_ms['kernel'] / 1e9:.2f}")

    x, w, _ = conv_inputs(TRAIN_SHAPE, 256, torch.bfloat16, gen)
    dy = torch.randn(TRAIN_SHAPE, device="cuda", generator=gen).to(torch.bfloat16)
    flop = 2 * 9 * int(np.prod(TRAIN_SHAPE)) * 256
    grad_ms = {}
    for op, kernel, plain, args in (
            ("dx", resblock.reflect_conv3x3_dx, resblock.reflect_conv3x3_dx_reference, (dy, w)),
            ("dw", resblock.reflect_conv3x3_dw, resblock.reflect_conv3x3_dw_reference, (x, dy))):
        # plain, kernel, kernel, plain in one call
        p1 = event_ms(lambda: plain(*args), iters=10)
        k1 = event_ms(lambda: kernel(*args), iters=10)
        k2 = event_ms(lambda: kernel(*args), iters=10)
        p2 = event_ms(lambda: plain(*args), iters=10)
        grad_ms[op] = ((k1 + k2) / 2, (p1 + p2) / 2)
        phase("timing", op=f"reflect_conv3x3_{op}", shape="x".join(map(str, TRAIN_SHAPE)),
              dtype="bf16", kernel_ms=f"{k1:.4f}/{k2:.4f}", plain_ms=f"{p1:.4f}/{p2:.4f}",
              kernel_tflops=f"{flop / grad_ms[op][0] / 1e9:.2f}")

    u8 = torch.from_numpy(rng.integers(0, 256, (TIME_BATCH, 256, 256, 3), dtype=np.uint8)).cuda()

    def wall_ms(fn, iters: int, warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / iters * 1e3

    serve = {"kernel": wall_ms(lambda: stylize_batch(net, u8), 3)}
    with trunk_conv(resblock, resblock.reflect_conv3x3_reference):
        serve["plain"] = wall_ms(lambda: stylize_batch(net, u8), 3)
    with trunk_conv(resblock, cudnn_conv):
        serve["cudnn_bf16"] = wall_ms(lambda: stylize_batch(net, u8), 3)
    phase("timing", op="stylize_batch", batch=TIME_BATCH, dtype="bf16",
          **{f"{k}_ms": f"{v:.3f}" for k, v in serve.items()},
          **{f"{k}_img_per_s": f"{TIME_BATCH / v * 1e3:.2f}" for k, v in serve.items()})

    photos, monets = batches[0]
    step_ms = {}
    for path in ("kernel", "plain"):
        fn = resblock.reflect_conv3x3 if path == "kernel" else resblock.reflect_conv3x3_reference
        with trunk_conv(resblock, fn):
            for kind, step in (("warmup", 1), ("r1", 0)):
                step_ms[(path, kind)] = wall_ms(
                    lambda s=step: trainer.train_step(state, photos, monets, step=s), 4)
    phase("timing", op="train_step", batch=photos.shape[0], dtype="bf16",
          **{f"{p}_{k}_ms": f"{v:.2f}" for (p, k), v in step_ms.items()},
          kernel_warmup_steps_per_s=f"{1e3 / step_ms[('kernel', 'warmup')]:.3f}")

    trainer.train_step(state, photos, monets, step=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_step(state, photos, monets, step=1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = device_busy_ms(prof)
    events = prof.key_averages()
    sort_by = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
               else "self_cuda_time_total")
    print(events.table(sort_by=sort_by, row_limit=40), flush=True)
    phase("timing", op="train_step_profile", kind="warmup", wall_ms=f"{wall:.2f}",
          device_busy_ms=f"{busy:.2f}", idle_share=f"{max(0.0, 1 - busy / wall):.4f}")
    return conv_ms, grad_ms


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
    phase_autograd(gen)

    # 5. serve, 6. train
    rng = np.random.default_rng(0)
    net, serve_launches = phase_serve(rng)
    trainer, state, batches, train_launches = phase_train(rng, flagship_params(rng),
                                                          flagship_d_params(rng))

    # 7. timing
    conv_ms, grad_ms = phase_timing(gen, rng, net, trainer, state, batches)

    source = "gan_variant_research_tpu_torch/csrc/{}.cu"
    replaces = "gan_variant_research_tpu/ops/pallas/resblock.py:{}"
    bf16 = torch.bfloat16
    print(json.dumps({"kernels": [
        {"name": "reflect_conv3x3", "route": "cuda", "source": source.format("reflect_conv3x3"),
         "replaces": replaces.format(156), "launches": train_launches[0],
         "max_abs_err": errs[("fwd", CONV_SHAPE, bf16)],
         "ms": conv_ms["kernel"], "plain_ms": conv_ms["plain"]},
        {"name": "reflect_conv3x3_dx", "route": "cuda",
         "source": source.format("reflect_conv3x3_dx"), "replaces": replaces.format(229),
         "launches": train_launches[1], "max_abs_err": errs[("dx", TRAIN_SHAPE, bf16)],
         "ms": grad_ms["dx"][0], "plain_ms": grad_ms["dx"][1]},
        {"name": "reflect_conv3x3_dw", "route": "cuda",
         "source": source.format("reflect_conv3x3_dw"), "replaces": replaces.format(297),
         "launches": train_launches[2], "max_abs_err": errs[("dw", TRAIN_SHAPE, bf16)],
         "ms": grad_ms["dw"][0], "plain_ms": grad_ms["dw"][1]},
    ], "serve_launches": serve_launches}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
