#!/usr/bin/env python3
"""Variants of the PyTorch port's bf16 trunk weight-gradient kernel
(gan_variant_research_tpu_torch/csrc/reflect_conv3x3_dw.cu, the wgmma
route) built, checked and timed side by side on one NVIDIA GPU.

    python3 scripts/probe_torch_dw.py [variant ...]

A variant is the source with text edits (EDITS, joined with "+"; "base" is
the source as it is; tests/test_torch_packaging.py holds every edit to the
current source). Each is built with the port's
nvcc flags into build/probe_dw/ (all builds in parallel); its line gives
ptxas's registers, spilled bytes and whether it serialised a wgmma for the
wgmma kernel. Each is checked against the plain version at the smoke's dw
shapes (within 1e-4 of the largest value, two runs bitwise equal) where it
still computes dw, and its bias gradient (``with_db``) against the float64
sum of dy (within 1e-6 of sum |dy| a channel, dw bitwise the one without
it, two runs bitwise equal); each is timed at the batch-12 trunk shape (12,
64, 64, 256) bf16 without and with the bias gradient beside cuDNN's bf16
backward-weight call: CUDA events over 20 calls, in the order variants,
variants reversed, twice, and the main pass's and the reduce's device times
under torch.profiler. Variants that drop work
("noload", "nomma", "nostore") no longer compute dw: they split the time of
the one they come from. Needs a GPU; prints one line per variant.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from gan_variant_research_tpu_torch.ops.kernels import _build  # noqa: E402
from gan_variant_research_tpu_torch.ops.kernels import resblock as rb  # noqa: E402

# The consumer's k16 step, as it is and as it was first written.
STEP_BODY_NOW = """#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // product 12j + 3kk + kx; 12 a segment, so its slot is static
        const int r = (3 * kk + kx) % 4;
        wgmma_wait<3>();   // product 12j + 3kk + kx - 4, the last to read a[r], has retired
        // and with it (at kk 1, kx 0) the last product of segment j - 1
        if (kk == 1 && kx == 0 && j > 0) mbar_arrive(empty + 8 * ((j - 1) % W_STAGES));
        ldsm_x4_trans(a[r], x_chunk(xt, kk * 16 + kx + krow, qlo, qhi, chunk));
        wgmma_fence();
        wgmma_rs_n128(acc[kx], a[r], db);
        wgmma_commit();
      }
"""
STEP_BODY_FIRST = """#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        ldsm_x4_trans(a[kk & 1][kx], x_chunk(xt, kk * 16 + kx + krow, qlo, qhi, chunk));
      wgmma_fence();
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) wgmma_rs_n128(acc[kx], a[kk & 1][kx], db);
      wgmma_commit();
      wgmma_wait<1>();
      if (kk == 0 && j > 0) mbar_arrive(empty + 8 * ((j - 1) % W_STAGES));
"""

EDITS = {
    "base": [],
    "stages4": [("constexpr int W_STAGES = 6;", "constexpr int W_STAGES = 4;")],
    # the producer arrives without loading: the full barriers complete at once
    "noload": [("        mbar_expect_tx(bar, bytes);", "        mbar_arrive(bar);"),
               ("        tma_load_4d(stage, &tdy, co0, w0, h, n, bar);\n", ""),
               ("        if (dy2) tma_load_4d(stage + W_DYBOX, &tdy, co0 + 64, w0, h, n, bar);\n", ""),
               ("        tma_load_4d(stage + W_XOFF, &tx, ci0, w0 - 1, hr, n, bar);\n", ""),
               ("        if (x2) tma_load_4d(stage + W_XOFF + W_XBOX, &tx, ci0 + 64, w0 - 1, hr, n, "
                "bar);\n", "")],
    "nomma": [("        wgmma_rs_n128(acc[kx], a[r], db);",
               "        acc[kx][0] += __uint_as_float(a[r][0]);")],
    "nostore": [("      const int ci = ci0 + cw * 64 + wl * 16 + g + 8 * h;\n      if (ci >= Cin) continue;",
                 "      const int ci = ci0 + cw * 64 + wl * 16 + g + 8 * h;\n"
                 "      if (ci >= Cin || acc[kx][0] != 12345.f) continue;")],
    # the first design: one wgmma group a k16 step, the three taps' A
    # fragments double-buffered across steps (ptxas serialises it: C7512)
    "stepgroups": [("  uint32_t a[4][4];   // a ring of A fragments, one a product",
                    "  uint32_t a[2][3][4];"),
                   (STEP_BODY_NOW, STEP_BODY_FIRST)],
}
DEFAULT = ["base", "stepgroups", "stages4", "noload", "nomma", "nostore"]
KERNELS = {"main": "dw_partial_wgmma", "reduce": "dw_reduce"}
CASES = [((12, 64, 64, 256), 256), ((2, 128, 128, 256), 256), ((3, 17, 33, 136), 72),
         ((2, 9, 9, 264), 520), ((2, 5, 65, 8), 8), ((1, 3, 129, 16), 24),
         ((2, 2, 2, 16), 24), ((1, 3, 2, 8), 8), ((2, 2, 3, 13), 21)]


def variant_source(src: str, variant: str) -> str:
    """The source with the variant's edits."""
    for name in variant.split("+"):
        for old, new in EDITS[name]:
            if old not in src:
                raise RuntimeError(f"{variant}: edit {name} no longer applies to the source")
            src = src.replace(old, new)
    return src


def ptxas_report(log: str, kernel: str) -> str:
    """Registers and spill stores of each of ``kernel``'s entries (its
    template instances, in the log's order) in an -Xptxas -v log, and
    whether ptxas serialised a wgmma anywhere (C7510-C7515)."""
    found = []
    for entry in re.findall(rf"Compiling entry function '\w*{kernel}\w*'(.*?)(?=Compiling entry|\Z)",
                            log, re.S):
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.search(r"(\d+) bytes spill stores", entry)
        found.append(f"{regs.group(1) if regs else '?'}/{spills.group(1) if spills else '?'}")
    return (f"registers/spill_store_bytes={','.join(found) or '?'} "
            f"wgmma_serialized={bool(re.search(r'C751[0-5]', log))}")


def build(variants):
    src = (_build.CSRC / "reflect_conv3x3_dw.cu").read_text()
    out = REPO / "build" / "probe_dw"
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
        print(f"build {v} {ptxas_report(log, 'dw_partial_wgmma')}", flush=True)
        fns[v] = _build.bind(ctypes.CDLL(str(cu.with_suffix(".so"))), "reflect_conv3x3_dw")
    return fns


def correct(gen) -> tuple[bool, float, bool, float]:
    """Whether the kernel computes dw at CASES, its worst distance from the
    plain version over the largest value; whether it computes db, its worst
    distance from the float64 sum over sum |dy|."""
    ok, worst, ok_db, worst_db = True, 0.0, True, 0.0
    for shape, c_out in CASES:
        x, _, _ = cs.conv_inputs(shape, c_out, torch.bfloat16, gen)
        dy = torch.randn(shape[:3] + (c_out,), device="cuda", generator=gen).bfloat16()
        dw, dw2 = rb.reflect_conv3x3_dw(x, dy), rb.reflect_conv3x3_dw(x, dy)
        r = rb.reflect_conv3x3_dw_reference(x, dy)
        rel = float((dw - r).abs().max() / r.abs().max())
        worst = max(worst, rel)
        ok &= rel <= 1e-4 and torch.equal(dw, dw2)
        (dw3, db), (_, db2) = rb._launch_dw(x, dy, with_db=True), rb._launch_dw(x, dy, with_db=True)
        rel_db = float(((db.double() - dy.double().sum(dim=(0, 1, 2))).abs()
                        / dy.double().abs().sum(dim=(0, 1, 2))).max())
        worst_db = max(worst_db, rel_db)
        ok_db &= rel_db <= 1e-6 and torch.equal(db, db2) and torch.equal(dw3, dw)
    return ok, worst, ok_db, worst_db


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_torch_dw: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    variants = argv or DEFAULT
    fns = build(variants)
    real = _build.kernel
    use = lambda v: setattr(_build, "kernel",  # noqa: E731
                            lambda n: fns[v] if n == "reflect_conv3x3_dw" else real(n))
    gen = torch.Generator(device="cuda").manual_seed(0)
    computes = {}
    for v in variants:
        use(v)
        computes[v] = correct(gen)
        torch.cuda.synchronize()
        print(f"check {v} computes_dw={computes[v][0]} worst_rel_to_max={computes[v][1]:.3e} "
              f"computes_db={computes[v][2]} worst_db_over_abs_sum={computes[v][3]:.3e}",
              flush=True)
    x, _, _ = cs.conv_inputs(cs.TRAIN_SHAPE, 256, torch.bfloat16, gen)
    _, w, _ = cs.conv_inputs(cs.TRAIN_SHAPE, 256, torch.bfloat16, gen)
    dy = torch.randn(cs.TRAIN_SHAPE, device="cuda", generator=gen).bfloat16()
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w_oihw, dy_nchw = w.permute(3, 2, 0, 1).contiguous(), dy.permute(0, 3, 1, 2)
    cudnn = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        dy_nchw, xp, w_oihw, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [False, True, False])
    call = lambda: rb.reflect_conv3x3_dw(x, dy)  # noqa: E731
    call_db = lambda: rb._launch_dw(x, dy, with_db=True)  # noqa: E731
    ms = {v: [] for v in ["cudnn", *variants, *(f"{v}+db" for v in variants)]}
    for _ in range(2):
        ms["cudnn"].append(cs.event_ms(cudnn, 20))
        for v in variants + variants[::-1]:
            use(v)
            ms[v].append(cs.event_ms(call, 20))
            ms[f"{v}+db"].append(cs.event_ms(call_db, 20))
        ms["cudnn"].append(cs.event_ms(cudnn, 20))
    print(f"cudnn_backward_weight event_ms={'/'.join(f'{t:.4f}' for t in ms['cudnn'])}",
          flush=True)
    flop = 2 * 9 * 12 * 64 * 64 * 256 * 256
    for v in variants:
        use(v)
        for db, fn in (("", call), ("+db", call_db)):
            us = cs.kernel_device_us(fn, 10, KERNELS)
            print(f"variant {v}{db} computes_dw={computes[v][0]} "
                  f"event_ms={'/'.join(f'{t:.4f}' for t in ms[v + db])} "
                  + " ".join(f"{k}_us={t:.2f}" for k, t in us.items())
                  + f" main_tflops={flop / us['main'] / 1e6:.2f}", flush=True)
    _build.kernel = real
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
