#!/usr/bin/env python3
"""Variants of the PyTorch port's bf16 trunk input-gradient kernel
(gan_variant_research_tpu_torch/csrc/reflect_conv3x3_dx.cu, the wgmma
route) built and timed side by side on one NVIDIA GPU.

    python3 scripts/probe_torch_dx.py [variant ...]

A variant is the source with text edits (EDITS, joined with "+"; "base" is
the source as it is; tests/test_torch_packaging.py holds every edit to the
current source). Each is built with the port's nvcc flags into
build/probe_dx/ (all builds in parallel), checked against the plain version
where it still computes dx, and timed at the batch-12 trunk shape (12, 64,
64, 256) bf16 beside cuDNN's backward-data call: CUDA events over 20 calls,
in the order variants, variants reversed, twice, and each kernel's device
time under torch.profiler. Variants that drop work ("noload", "nomma",
"nostore", "k0", "noepi", "fnoload", "fnomma") no longer compute
dx: they split the time of the one they come from. Event
times of a call that does little are bound by the host's time a call,
printed as host_us; read the device times there. Needs a GPU; prints one
line per variant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from gan_variant_research_tpu_torch.ops.kernels import _build  # noqa: E402
from gan_variant_research_tpu_torch.ops.kernels import resblock as rb  # noqa: E402

# The wgmma main pass's epilogue: the lines between these markers.
EPILOGUE = ("      // epilogue stores begin", "      // epilogue stores end")

# The first design's epilogue: the frame folded onto a pixel in the main
# pass (its `edge` argument is then the frame), no fold pass.
FOLD_IN_EPILOGUE = """      bf16* dst = dx_n + ((size_t)oy * W + ox) * Cin + tl.ci0 + 2 * t;
      const bool edge_px = oy <= 1 || oy >= H - 2 || ox <= 1 || ox >= W - 2;
#pragma unroll
      for (int c = 0; c < G_BN / 8; ++c) {
        const int ci = tl.ci0 + 8 * c + 2 * t;
        if (ci < Cin) {
          float v0 = acc[4 * c + 2 * h], v1 = acc[4 * c + 2 * h + 1];
          if (edge_px) {
            v0 += frame_fold(edge_n, H, W, Cin, oy, ox, ci);
            v1 += frame_fold(edge_n, H, W, Cin, oy, ox, ci + 1);
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) = __floats2bfloat162_rn(v0, v1);
        }
      }
"""

EDITS = {
    "base": [],
    "fold_in_epilogue": [
        (EPILOGUE, FOLD_IN_EPILOGUE),
        ("    float* edge_n = edge + (size_t)tl.n * (2 * W + 2 * H) * Cin;",
         "    float* edge_n = edge + (size_t)tl.n * (2 * (W + 2) + 2 * H) * Cin;"),
        ("      tdy, tw, edge, static_cast<bf16*>(dx), (int)tiles, H, W, Cin, Cout);",
         "      tdy, tw, frame, static_cast<bf16*>(dx), (int)tiles, H, W, Cin, Cout);"),
        ("  dx_fold<<<dim3(2 * W + 2 * H, N), 128, 0, s>>>(edge, frame, static_cast<bf16*>(dx), "
         "H, W, Cin);", "")],
    # the main pass without its TMA loads (the full barriers complete at once)
    "noload": [("          mbar_expect_tx(full + 8 * s, G_STAGE);", "          mbar_arrive(full + 8 * s);"),
               ("          tma_load_4d(a, &tdy, co0, tl.x0 + tap % 3 - 1, tl.y0 + tap / 3 - 1, tl.n, "
                "full + 8 * s);\n", ""),
               ("          tma_load_3d(a + G_A, &tw, co0, tl.ci0, 8 - tap, full + 8 * s);\n", "")],
    "nomma": [("      for (int kk = 0; kk < G_BK / 16; ++kk)\n        wgmma_ss_n256",
               "      for (int kk = 0; kk < 0; ++kk)\n        wgmma_ss_n256")],
    "nostore": [("      const int slot = fold_slot(H, W, oy, ox);",
                 "      const int slot = fold_slot(H, W, oy, ox);\n      if (acc[0] != 12345.f) continue;")],
    "k4": [("  const int ksteps = 9 * chunks;", "  const int ksteps = 36 * chunks;")],
    "k0": [("  const int ksteps = 9 * chunks;", "  const int ksteps = 0 * chunks;")],
    "noepi": [("    if (oy >= H) continue;", "    continue;")],
    "fnoload": [("    FrameRound f;\n    frame_load(f, dyn, w, l, W, Cin, Cout, ci0, 0, u0);",
                 "    FrameRound f{};"),
                ("      if (co0 + GF_CO < Cout) frame_load(f, dyn, w, l, W, Cin, Cout, ci0, co0 + GF_CO, "
                 "u0);\n", "")],
    "fnomma": [("              mma_bf16(acc[j], a, lds32(&ws[k][j * 8 + g][c]), "
                "lds32(&ws[k][j * 8 + g][c + 8]));",
                "              acc[j][0] += __uint_as_float(a[0] ^ lds32(&ws[k][j * 8 + g][c]));")],
}
DEFAULT = ["base", "fold_in_epilogue", "noload", "noload+k4", "nomma", "nostore", "k0",
           "k0+noepi", "fnoload", "fnomma"]
KERNELS = {"frame": "dx_frame_mma", "main": "dx_main_wgmma", "fold": "dx_fold"}
CASES = [((12, 64, 64, 256), 256), ((2, 128, 128, 256), 256), ((1, 3, 2, 8), 8),
         ((2, 2, 3, 16), 24), ((3, 17, 33, 136), 72), ((2, 9, 9, 264), 512)]


def variant_source(src: str, variant: str) -> str:
    """The source with the variant's edits."""
    for name in variant.split("+"):
        for old, new in EDITS[name]:
            if isinstance(old, tuple):   # the text between two marker lines
                start, end = src.find(old[0]), src.find(old[1])
                if start < 0 or end < start:
                    raise RuntimeError(f"{variant}: markers of {name} not in the source")
                old = src[src.index("\n", start) + 1:end]
            if old not in src:
                raise RuntimeError(f"{variant}: edit {name} no longer applies to the source")
            src = src.replace(old, new)
    return src


def build(variants):
    src = (_build.CSRC / "reflect_conv3x3_dx.cu").read_text()
    out = REPO / "build" / "probe_dx"
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
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log[-3000:]}")
        print(f"build {v} wgmma_serialized={'C7515' in log}", flush=True)
        fn = ctypes.CDLL(str(cu.with_suffix(".so"))).reflect_conv3x3_dx
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[v] = fn
    return fns


def correct(gen) -> bool:
    ok = True
    for shape, c_out in CASES:
        _, w, _ = cs.conv_inputs(shape, c_out, torch.bfloat16, gen)
        dy = torch.randn(shape[:3] + (c_out,), device="cuda", generator=gen).bfloat16()
        dx, dx2 = rb.reflect_conv3x3_dx(dy, w), rb.reflect_conv3x3_dx(dy, w)
        r = rb.reflect_conv3x3_dx_reference(dy, w)
        d = (dx.float() - r.float()).abs()
        ok &= bool((d <= 2e-5 * r.float().abs().max() + cs.bf16_ulp(r)).all()) and torch.equal(dx, dx2)
    return ok


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_torch_dx: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    variants = argv or DEFAULT
    fns = build(variants)
    real = rb._dx_fn
    use = lambda v: setattr(rb, "_dx_fn", lambda: fns[v])  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    computes = {}
    for v in variants:
        use(v)
        computes[v] = correct(gen)
    _, w, _ = cs.conv_inputs(cs.TRAIN_SHAPE, 256, torch.bfloat16, gen)
    x, _, _ = cs.conv_inputs(cs.TRAIN_SHAPE, 256, torch.bfloat16, gen)
    dy = torch.randn(cs.TRAIN_SHAPE, device="cuda", generator=gen).bfloat16()
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w_oihw, dy_nchw = w.permute(3, 2, 0, 1).contiguous(), dy.permute(0, 3, 1, 2)
    cudnn = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        dy_nchw, xp, w_oihw, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [True, False, False])
    call = lambda: rb.reflect_conv3x3_dx(dy, w)  # noqa: E731
    ms = {v: [] for v in ["cudnn", *variants]}
    for _ in range(2):
        ms["cudnn"].append(cs.event_ms(cudnn, 20))
        for v in variants + variants[::-1]:
            use(v)
            ms[v].append(cs.event_ms(call, 20))
        ms["cudnn"].append(cs.event_ms(cudnn, 20))
    print(f"cudnn_backward_data event_ms={'/'.join(f'{t:.4f}' for t in ms['cudnn'])}", flush=True)
    for v in variants:
        use(v)
        names = {k: n for k, n in KERNELS.items() if not (k == "fold" and "fold_in" in v)}
        us = cs.kernel_device_us(call, 10, names)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        print(f"variant {v} computes_dx={computes[v]} "
              f"event_ms={'/'.join(f'{t:.4f}' for t in ms[v])} host_us={host_us:.1f} "
              + " ".join(f"{k}_us={t:.2f}" for k, t in us.items()), flush=True)
    rb._dx_fn = real
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
