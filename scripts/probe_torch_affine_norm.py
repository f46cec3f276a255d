#!/usr/bin/env python3
"""The PyTorch port's affine instance-norm kernel pair (the U-Net's norm and
ReLU: gan_variant_research_tpu_torch/csrc/instance_norm.cu's affine
instance) timed against the stock float32 chain on one NVIDIA GPU.

    python3 scripts/probe_torch_affine_norm.py

Builds the library and prints ptxas's registers and spilled bytes for each
affine kernel; then, at the U-Net's stem (16, 256, 256, 64) and bottleneck
(48, 16, 16, 512) norms, bf16 with the ReLU: a check against the chain (y
and dx by norm), then CUDA events over 20 calls each of the kernels'
forward, backward, and forward and backward through autograd, beside the
stock chain's forward and forward with backward (order kernel, chain,
kernel, chain; the two runs printed), each launch also queued behind a
spin so that the device's time shows without the host's; the unique-byte
bound (x read and y written: 4 bytes an element forward; g and x read, dx
written: 6 backward) and the bytes this design moves (6 and 10) at 3.35
TB/s; last, each kernel's device time under torch.profiler. Needs a GPU;
prints one line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from gan_variant_research_tpu_torch.ops import nn_ops  # noqa: E402
from gan_variant_research_tpu_torch.ops.kernels import _build  # noqa: E402
from gan_variant_research_tpu_torch.ops.kernels import instance_norm as inm  # noqa: E402

SHAPES = {"stem": (16, 256, 256, 64), "bottleneck": (48, 16, 16, 512)}
PARTS = ("inorm_fwd_stats", "inorm_fwd_finalize", "inorm_fwd_apply", "inorm_bwd_stats",
         "inorm_bwd_finalize", "inorm_bwd_apply")
EPS = 1e-5


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def ptxas() -> list[str]:
    """Registers and spill stores of each affine kernel in the build log."""
    log = _build.library_path("instance_norm").with_suffix(".log").read_text()
    lines = []
    for name, entry in re.findall(r"Compiling entry function '(\w*affine\w*)'(.*?)"
                                  r"(?=Compiling entry|\Z)", log, re.S):
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.search(r"(\d+) bytes spill stores", entry)
        lines.append(f"{name} registers={regs.group(1) if regs else '?'} "
                     f"spill_store_bytes={spills.group(1) if spills else '?'}")
    return lines


def chain(x, gamma, beta):
    return torch.relu(nn_ops.affine_instance_norm(x, gamma, beta, EPS))


def parts_us(fn, iters: int = 10) -> dict:
    """Mean device us a call of each affine kernel (by name, template
    instances and overloads summed) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    got = {}
    for e in prof.key_averages():
        for part in PARTS:
            if re.search(rf"affine::{part}\b", e.key):
                total = getattr(e, "device_time_total", None) or e.cuda_time_total
                got[part] = got.get(part, 0.0) + total / iters
    return got


def main() -> int:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.kernel("affine_instance_norm")
    print(f"card {card()}", flush=True)
    for line in ptxas():
        print(f"ptxas {line}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for label, shape in SHAPES.items():
        x = (torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.4).bfloat16()
        g = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        gamma = torch.rand(shape[3], device="cuda", generator=gen) + 0.5
        beta = torch.rand(shape[3], device="cuda", generator=gen) - 0.5
        _, y, stats = inm._launch_affine_forward(x, gamma, beta, EPS, True)
        dx, _, _ = inm._launch_affine_backward(g, x, stats, gamma, beta, EPS, True)
        xr = x.clone().requires_grad_()
        yp = chain(xr, gamma, beta)
        dxp, = torch.autograd.grad(yp, xr, g)
        yp = yp.detach()
        rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())  # noqa: E731
        print(f"check {label} shape={'x'.join(map(str, shape))} y_rel={rel(y, yp):.3e} "
              f"dx_rel={rel(dx, dxp):.3e}", flush=True)
        cs.check(rel(y, yp) <= 1e-2 and rel(dx, dxp) <= 1e-2, f"{label}: kernels off the chain")
        inputs[label] = (x, g, gamma, beta, stats)
        del y, dx, xr, yp, dxp

    for label, (x, g, gamma, beta, stats) in inputs.items():
        numel = x.numel()

        def kernel_both():
            leaves = [t.detach().requires_grad_() for t in (x, gamma, beta)]
            torch.autograd.grad(inm.affine_instance_norm(*leaves, EPS, True), leaves, g)

        def chain_fwd():
            with torch.no_grad():
                chain(x, gamma, beta)

        def chain_both():
            leaves = [t.detach().requires_grad_() for t in (x, gamma, beta)]
            torch.autograd.grad(chain(*leaves), leaves, g)

        calls = {"fwd": lambda: inm._launch_affine_forward(x, gamma, beta, EPS, True),
                 "bwd": lambda: inm._launch_affine_backward(g, x, stats, gamma, beta, EPS, True),
                 "fwd_bwd": kernel_both, "chain_fwd": chain_fwd, "chain_fwd_bwd": chain_both}
        runs = {k: [] for k in calls}
        for _ in range(2):
            for k, fn in calls.items():
                runs[k].append(cs.event_ms(fn, 20))
        queued = {k: cs.queued_us(calls[k], 20) / 1e3 for k in ("fwd", "bwd", "chain_fwd_bwd")}
        bound = {"fwd": 4 * numel / cs.PEAK_BYTES * 1e3, "bwd": 6 * numel / cs.PEAK_BYTES * 1e3}
        moved = {"fwd": 6 * numel / cs.PEAK_BYTES * 1e3, "bwd": 10 * numel / cs.PEAK_BYTES * 1e3}
        print(f"timing {label} shape={'x'.join(map(str, x.shape))} "
              + " ".join(f"{k}_ms={v[0]:.4f}/{v[1]:.4f}" for k, v in runs.items())
              + " " + " ".join(f"{k}_queued_ms={v:.4f}" for k, v in queued.items())
              + f" bound_fwd_ms={bound['fwd']:.4f} bound_bwd_ms={bound['bwd']:.4f}"
              + f" moved_fwd_ms={moved['fwd']:.4f} moved_bwd_ms={moved['bwd']:.4f}"
              + f" fwd_share_of_bound={bound['fwd'] / queued['fwd']:.3f}"
              + f" bwd_share_of_bound={bound['bwd'] / queued['bwd']:.3f}"
              + f" chain_over_kernels={queued['chain_fwd_bwd'] / (queued['fwd'] + queued['bwd']):.2f}",
              flush=True)

    # the profiler last: its sessions come after every timing
    for label, (x, g, gamma, beta, stats) in inputs.items():
        us = {**parts_us(lambda: inm._launch_affine_forward(x, gamma, beta, EPS, True)),
              **parts_us(lambda: inm._launch_affine_backward(g, x, stats, gamma, beta, EPS,
                                                             True))}
        print(f"parts {label} " + " ".join(f"{k}_us={v:.2f}" for k, v in us.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
