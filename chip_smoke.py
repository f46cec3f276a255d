#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:

1. device  - requires CUDA (there is no CPU fallback); prints the card's
             name and power limit as nvidia-smi gives them;
2. build   - builds every hand-written kernel from csrc/ (nvcc, sm_90a);
3. kernels - each kernel against its plain PyTorch version on the card, at
             the serving path's shape in float32 and bf16, and at ragged
             shapes;
4. slice   - the flagship CUT generator (ResNet-9, ngf 64, 9 blocks, bf16
             compute, fp32 params; weights made from a seed with numpy in
             the JAX package's param layout, converted by convert.py) serves
             3 batches of 8 seeded 256x256 photos through stylize_batch; each
             batch must launch the trunk kernel 18 times. Then one float32
             forward at batch 2 through the kernel and through the plain
             version must agree to 1e-3;
5. timing  - batch 32, 256^2, bf16: the trunk conv and the whole served
             batch, kernel path against plain paths.

Any failure raises and exits non-zero. The second-to-last line is the
kernel table as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
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
SERVE_BATCH, SERVE_BATCHES, TIME_BATCH = 8, 3, 32
FLAGSHIP = {"ngf": 64, "n_blocks": 9, "n_downsampling": 2}
TRUNK_CONVS = 2 * FLAGSHIP["n_blocks"]


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


def flagship_params(rng: np.random.Generator) -> dict:
    """The JAX generator's param tree at the flagship width, with PyTorch's
    default init bounds U(+-1/sqrt(fan_in))."""
    ngf, n_down, n_blocks = FLAGSHIP["ngf"], FLAGSHIP["n_downsampling"], FLAGSHIP["n_blocks"]

    def conv(kh, c_in, c_out, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return {"kernel": rng.uniform(-bound, bound, (kh, kh, c_in, c_out)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, (c_out,)).astype(np.float32)}

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


@contextlib.contextmanager
def trunk_conv(resblock, fn):
    """Route the trunk through ``fn`` (a plain version) for a comparison."""
    real = resblock.reflect_conv3x3
    resblock.reflect_conv3x3 = fn
    try:
        yield
    finally:
        resblock.reflect_conv3x3 = real


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.convert import generator_state_dict_from_jax
    from gan_variant_research_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
    from gan_variant_research_tpu_torch.ops.kernels import _build, resblock
    from gan_variant_research_tpu_torch.train.cut_trainer import build_generator

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    resblock._forward_fn()
    phase("build", kernel="reflect_conv3x3", seconds=f"{time.perf_counter() - t0:.2f}",
          library=_build.library_path("reflect_conv3x3").relative_to(REPO))

    # 3. kernel vs plain version, full float32 on both sides
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
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
        torch.cuda.synchronize()
        check(y.dtype == dtype and y.shape == r.shape, f"{shape} {dtype}: bad output")
        d = (y.float() - r.float()).abs()
        # float32 sums of 9*Cin exact products, in another order (and, for
        # bf16, through the tensor cores' accumulator)
        tol = 2e-5 + 2e-5 * r.float().abs()
        if dtype == torch.bfloat16:
            # each side rounds its float32 sum once: one bf16 ulp apart at most
            tol = tol + bf16_ulp(r)
        bad = int((d > tol).sum())
        errs[(shape, dtype)] = float(d.max())
        phase("kernel", name="reflect_conv3x3", shape="x".join(map(str, shape)),
              c_out=c_out, dtype=str(dtype).split(".")[-1], max_abs_err=f"{d.max().item():.3e}",
              differing=f"{(d > 0).float().mean().item():.5f}", over_tol=bad)
        check(bad == 0, f"reflect_conv3x3 {shape} {dtype}: {bad} values over tolerance")

    # 4. the slice: flagship generator, served through stylize_batch
    rng = np.random.default_rng(0)
    net = build_generator(FLAGSHIP, DEFAULT_POLICY)
    net.load_state_dict(generator_state_dict_from_jax(flagship_params(rng)))
    net = net.to("cuda").eval()
    photos = [torch.from_numpy(rng.integers(0, 256, (SERVE_BATCH, 256, 256, 3), dtype=np.uint8))
              .cuda() for _ in range(SERVE_BATCHES)]
    torch.cuda.synchronize()
    resblock.LAUNCHES = 0
    served = []
    for u8 in photos:
        before = resblock.LAUNCHES
        out = stylize_batch(net, u8)
        torch.cuda.synchronize()
        check(resblock.LAUNCHES - before == TRUNK_CONVS,
              f"{resblock.LAUNCHES - before} trunk launches in a batch, want {TRUNK_CONVS}")
        served.append(out)
    launches = resblock.LAUNCHES
    for out in served:
        check(out.dtype == torch.uint8 and tuple(out.shape) == (SERVE_BATCH, 256, 256, 3),
              f"served {out.dtype} {tuple(out.shape)}")
        check(float(out.float().std()) > 1.0, "served images are flat")
    with trunk_conv(resblock, resblock.reflect_conv3x3_reference):
        plain_served = stylize_batch(net, photos[0])
    level = (served[0].int() - plain_served.int()).abs()
    phase("slice", model="resnet9-ngf64-9blocks", dtype="bf16", batches=SERVE_BATCHES,
          batch=SERVE_BATCH, launches=launches,
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
    phase("slice", model="resnet9-ngf64-9blocks", dtype="fp32", batch=2,
          tanh_max_abs_diff_vs_plain=f"{fp32_err:.3e}")
    check(fp32_err <= 1e-3, f"fp32 forward differs from the plain path by {fp32_err}")

    # 5. timing at batch 32, bf16
    x, w, b = conv_inputs((TIME_BATCH, 64, 64, 256), 256, torch.bfloat16, gen)
    conv_ms = {name: event_ms(lambda f=f: f(x, w, b), iters=10)
               for name, f in (("kernel", resblock.reflect_conv3x3),
                               ("plain", resblock.reflect_conv3x3_reference),
                               ("cudnn_bf16", cudnn_conv))}
    flop = 2 * 9 * TIME_BATCH * 64 * 64 * 256 * 256
    phase("timing", op="reflect_conv3x3", shape=f"{TIME_BATCH}x64x64x256", dtype="bf16",
          **{f"{k}_ms": f"{v:.4f}" for k, v in conv_ms.items()},
          kernel_tflops=f"{flop / conv_ms['kernel'] / 1e9:.2f}")

    u8 = torch.from_numpy(rng.integers(0, 256, (TIME_BATCH, 256, 256, 3), dtype=np.uint8)).cuda()

    def serve_ms() -> float:
        for _ in range(2):
            stylize_batch(net, u8)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            stylize_batch(net, u8)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 5 * 1e3

    serve = {"kernel": serve_ms()}
    with trunk_conv(resblock, resblock.reflect_conv3x3_reference):
        serve["plain"] = serve_ms()
    with trunk_conv(resblock, cudnn_conv):
        serve["cudnn_bf16"] = serve_ms()
    phase("timing", op="stylize_batch", batch=TIME_BATCH, dtype="bf16",
          **{f"{k}_ms": f"{v:.3f}" for k, v in serve.items()},
          **{f"{k}_img_per_s": f"{TIME_BATCH / v * 1e3:.2f}" for k, v in serve.items()})

    print(json.dumps({"kernels": [{
        "name": "reflect_conv3x3",
        "route": "cuda",
        "source": "gan_variant_research_tpu_torch/csrc/reflect_conv3x3.cu",
        "replaces": "gan_variant_research_tpu/ops/pallas/resblock.py:156",
        "launches": launches,
        "max_abs_err": errs[(CONV_SHAPE, torch.bfloat16)],
        "ms": conv_ms["kernel"],
        "plain_ms": conv_ms["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
