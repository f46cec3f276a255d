#!/usr/bin/env python3
"""Variants of the PyTorch port's bf16 trunk forward kernel
(gan_variant_research_tpu_torch/csrc/reflect_conv3x3.cu, the wgmma route)
built, checked and timed side by side on one NVIDIA GPU.

    python3 scripts/probe_torch_fwd.py [variant ...]

A variant is the source with text edits (EDITS, joined with "+"; "base" is
the source as it is; tests/test_torch_packaging.py holds every edit to the
current source). Each is built with the port's nvcc flags into
build/probe_fwd/ (all builds in parallel); its line gives ptxas's
registers, spilled bytes and whether it serialised a wgmma for the wgmma
kernel. Each is checked against the plain version at the smoke's bf16
forward shapes (within one bf16 ulp + 2e-5 of the plain version, two runs
bitwise equal) where it still computes the conv, and timed at the trunk
shapes (12, 64, 64, 256) and (32, 64, 64, 256) bf16 beside stock bf16
reflect pad + cuDNN conv + bias: CUDA events over 20 calls, in the order
variants, variants reversed, twice, and the main pass's device time under
torch.profiler; and the wrapper's host time per call at a shape whose
device work is negligible. Variants that drop work ("noload", "nomma",
"nostore") no longer compute the conv: they split the time of the one they
come from. Needs a GPU; prints one line per variant.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from gan_variant_research_tpu_torch.ops.kernels import _build  # noqa: E402
from gan_variant_research_tpu_torch.ops.kernels import resblock as rb  # noqa: E402

EDITS = {
    "base": [],
    # the producer arrives without loading: the full barriers complete at once
    "noload": [("          mbar_expect_tx(xbar, 4 * F_XQ * 128);", "          mbar_arrive(xbar);"),
               ("            tma_load_4d(xdst + i * F_XROW, &tx, c * F_BK, tl.x0 - 1,\n"
                "                        reflect_index(tl.y0 - 1 + i, H), tl.n, xbar);",
                "            (void)i;"),
               ("            mbar_expect_tx(wbar, wboxes * F_WBOX);", "            mbar_arrive(wbar);"),
               ("              tma_load_3d(wdst + j * F_WBOX, &tw, tl.co0 + 64 * j, c * F_BK, tap, "
                "wbar);", "              (void)wdst;")],
    "nomma": [("          wgmma_rs_n256(acc, a[kk], make_desc(wt + kk * 2048, F_WBOX, 1024, 1));",
               "          acc[0] += __uint_as_float(a[kk][0]) + (float)wt;")],
    "nostore": [("    if (tid == 0 && oy < H) {", "    if (tid == 0 && oy < H && acc[0] == 12345.f) {")],
    # a ring of two A fragments: two products in flight a consumer, and a w
    # stage released two products after its last one instead of four
    "ring2": [("  uint32_t a[4][4];   // a ring of A fragments, one a product", "  uint32_t a[2][4];"),
              ("          wgmma_wait<3>();   // product p - 4, the last to read a[kk], has retired\n"
               "          if (kk == 3 && (c > 0 || tap > 0)) {",
               "          wgmma_wait<1>();\n          if (kk == 1 && (c > 0 || tap > 0)) {"),
              ("ldsm_x4(a[kk], ", "ldsm_x4(a[kk & 1], "),
              ("wgmma_rs_n256(acc, a[kk], ", "wgmma_rs_n256(acc, a[kk & 1], ")],
}
DEFAULT = ["base", "noload", "nomma", "nostore", "ring2"]
KERNELS = {"main": "fwd_main_wgmma"}
CASES = [((12, 64, 64, 256), 256), ((2, 128, 128, 256), 256), ((3, 17, 33, 136), 72),
         ((2, 9, 9, 264), 520), ((2, 5, 65, 16), 24), ((1, 3, 129, 8), 8),
         ((2, 2, 2, 16), 24), ((1, 3, 2, 8), 8), ((1, 3, 3, 8), 16), ((2, 2, 3, 13), 21),
         ((3, 17, 33, 130), 70), ((2, 5, 7, 40), 40), ((16, 64, 64, 64), 64),
         ((64, 64, 64, 256), 256), ((4, 32, 32, 512), 264)]


def variant_source(src: str, variant: str) -> str:
    """The source with the variant's edits."""
    for name in variant.split("+"):
        for old, new in EDITS[name]:
            if old not in src:
                raise RuntimeError(f"{variant}: edit {name} no longer applies to the source")
            src = src.replace(old, new)
    return src


def ptxas_report(log: str, kernel: str) -> str:
    """Registers and spill stores of ``kernel``'s entry in an -Xptxas -v log,
    and whether ptxas serialised a wgmma anywhere (C7510-C7515)."""
    regs = spills = "?"
    entry = re.search(rf"Compiling entry function '\w*{kernel}\w*'(.*?)(?=Compiling entry|\Z)",
                      log, re.S)
    if entry:
        m = re.search(r"Used (\d+) registers", entry.group(1))
        regs = m.group(1) if m else "?"
        m = re.search(r"(\d+) bytes spill stores", entry.group(1))
        spills = m.group(1) if m else "?"
    return (f"registers={regs} spill_store_bytes={spills} "
            f"wgmma_serialized={bool(re.search(r'C751[0-5]', log))}")


def build(variants):
    src = (_build.CSRC / "reflect_conv3x3.cu").read_text()
    out = REPO / "build" / "probe_fwd"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        cu = out / f"{v.replace('+', '_')}.cu"
        cu.write_text(variant_source(src, v))
        procs[v] = (cu, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for v, (cu, proc) in procs.items():
        log = proc.communicate()[0]
        cu.with_suffix(".log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log[-3000:]}")
        print(f"build {v} {ptxas_report(log, 'fwd_main_wgmma')}", flush=True)
        fn = ctypes.CDLL(str(cu.with_suffix(".so"))).reflect_conv3x3_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[v] = fn
    return fns


def correct(gen, verbose: bool) -> tuple[bool, float]:
    """Every case within one bf16 ulp + 2e-5 (+ 2e-5 relative) of the plain
    version and bitwise repeatable; the worst error as a share of that
    tolerance."""
    ok, worst = True, 0.0
    for shape, c_out in CASES:
        x, w, b = cs.conv_inputs(shape, c_out, torch.bfloat16, gen)
        y, y2 = rb.reflect_conv3x3(x, w, b), rb.reflect_conv3x3(x, w, b)
        r = rb.reflect_conv3x3_reference(x, w, b)
        d = (y.float() - r.float()).abs()
        tol = 2e-5 + 2e-5 * r.float().abs() + cs.bf16_ulp(r)
        bad = int((d > tol).sum())
        same = torch.equal(y, y2)
        worst = max(worst, float((d / tol).max()))
        ok &= bad == 0 and same
        if verbose:
            print(f"case {'x'.join(map(str, shape))} c_out={c_out} max_abs_err={float(d.max()):.3e} "
                  f"over_tol={bad} bitwise_repeatable={same}", flush=True)
    return ok, worst


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_torch_fwd: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    variants = argv or DEFAULT
    fns = build(variants)
    real = rb._forward_fn
    use = lambda v: setattr(rb, "_forward_fn", lambda: fns[v])  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    computes = {}
    for v in variants:
        use(v)
        computes[v] = correct(gen, verbose=v == "base")
        torch.cuda.synchronize()
        print(f"check {v} computes_conv={computes[v][0]} worst_share_of_tol={computes[v][1]:.3f}",
              flush=True)
    for shape in (cs.TRAIN_SHAPE, (cs.TIME_BATCH, 64, 64, 256)):
        x, w, b = cs.conv_inputs(shape, 256, torch.bfloat16, gen)
        call = lambda: rb.reflect_conv3x3(x, w, b)  # noqa: E731
        cudnn = lambda: cs.cudnn_conv(x, w, b)  # noqa: E731
        ms = {v: [] for v in ["cudnn", *variants]}
        for _ in range(2):
            ms["cudnn"].append(cs.event_ms(cudnn, 20))
            for v in variants + variants[::-1]:
                use(v)
                ms[v].append(cs.event_ms(call, 20))
            ms["cudnn"].append(cs.event_ms(cudnn, 20))
        label = "x".join(map(str, shape))
        print(f"cudnn_bf16 shape={label} event_ms={'/'.join(f'{t:.4f}' for t in ms['cudnn'])}",
              flush=True)
        flop = 2 * 9 * int(torch.tensor(shape).prod()) * 256
        for v in variants:
            use(v)
            us = cs.kernel_device_us(call, 10, KERNELS)
            print(f"variant {v} shape={label} computes_conv={computes[v][0]} "
                  f"event_ms={'/'.join(f'{t:.4f}' for t in ms[v])} "
                  + " ".join(f"{k}_us={t:.2f}" for k, t in us.items())
                  + f" main_tflops={flop / us['main'] / 1e6:.2f}", flush=True)
    # the wrapper's host cost: at a shape whose device work is negligible
    # the calls run at the host's rate
    x, w, b = cs.conv_inputs((1, 2, 2, 8), 8, torch.bfloat16, gen)
    for v in variants:
        use(v)
        host_ms = cs.wall_ms(lambda: rb.reflect_conv3x3(x, w, b), 200)
        print(f"host {v} shape=1x2x2x8 us_per_call={host_ms * 1e3:.1f}", flush=True)
    rb._forward_fn = real
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
