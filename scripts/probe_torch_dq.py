#!/usr/bin/env python3
"""Variants of the PyTorch port's bf16 attention dQ kernel
(gan_variant_research_tpu_torch/csrc/spatial_attention_dq.cu, the wgmma
kernel) built, checked and timed side by side on one NVIDIA GPU.

    python3 scripts/probe_torch_dq.py [variant ...]

A variant is the source with text edits (EDITS, joined with "+"; "base" is
the source as it is; tests/test_torch_packaging.py holds every edit to the
current source). Each is built with the port's nvcc flags into
build/probe_dq/ (all builds in parallel); its line gives ptxas's registers,
spilled bytes and whether it serialised a wgmma for the wgmma kernel. Each
is checked at the smoke's bf16 attention cases (chip_smoke.ATTN_CASES: the
trunk shapes, ragged n and widths, the dQ kernel's tile edges) with
chip_smoke.bf16_backward_check (within one bf16 rounding of the contract
version's largest value, and by RMS at most twice as far from the float32
plain version as the bf16 plain version is) and for two runs bitwise
equal, where it still computes dQ; and timed at (12, 4096, 32, 256) bf16
beside the dK/dV kernel: CUDA events over 20 calls, in the order variants,
variants reversed, twice, and the kernel's device time under
torch.profiler. Variants that drop work ("noload", "nomma", "nostore") no
longer compute dQ: they split the time of the one they come from.
"do_smem" is the fallback design: do stays in shared memory and is read by
the wgmma as an operand (dp on wgmma.m64n128k16 from shared memory), with
128-key tiles in a ring of two (d_qk 64 and 128 refused: two stages do not fit
at 64, and the 128 instance is not probed).
"noturns" lets the two
consumers start their products whenever they are ready, in place of taking
turns. Needs a GPU; prints one line per variant.
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
from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa  # noqa: E402


def _wgmma_ss_n128() -> str:
    """d (64 x 128, float32) = or += a b^T, both from shared memory,
    K-major: the product do_smem adds for its 128-key tiles."""
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return ("__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, "
            "int scale_d) {\n  asm volatile(\n"
            '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
            '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {' + regs
            + '}, %64, %65, p, 1, 1, 0, 0;\\n}\\n"\n'
            f"      : {outs}\n"
            '      : "l"(da), "l"(db), "r"(scale_d));\n}\n\n')


EXP2 = "__device__ __forceinline__ float fast_exp2(float x) {"
EDITS = {
    "base": [],
    # the producer arrives without loading the key ring: its full barriers
    # complete at once (q and do are still loaded once)
    "noload": [("        mbar_expect_tx(full + 8 * s, L::K_TILE + boxes * V_BOX);\n"
                "        for (int c = 0; c < L::NBOX; ++c)\n"
                "          tma_load(base + L::K + s * L::K_TILE + c * L::K_BOX, &tk, c * L::BOXC, "
                "j * BKW, b,\n"
                "                   full + 8 * s);\n"
                "        for (int c = 0; c < boxes; ++c)\n"
                "          tma_load(base + L::V + s * L::V_TILE + c * V_BOX, &tv, 64 * c, j * BKW, b, "
                "full + 8 * s);\n",
                "        mbar_arrive(full + 8 * s);\n")],
    # no wgmma: each product becomes one register add that keeps its inputs live
    "nomma": [("wgmma_ss(s, make_desc(q_rows + box * L::Q_BOX + col, 16, 8 * L::RB, L::MODE), "
               "make_desc(k_tile + box * L::K_BOX + col, 16, 8 * L::RB, L::MODE), kk);",
               "s[kk] += (float)(k_tile + col);"),
              ("wgmma_rs_kmajor(dp, do_a[4 * c + kk], "
               "make_desc(v_tile + c * V_BOX + kk * 32, 16, 1024, 1), c | kk);",
               "dp[kk] += __uint_as_float(do_a[4 * c + kk][0]) + (float)v_tile;"),
              ("wgmma_rs(dq_acc, da[kk], "
               "make_desc(k_tile + kk * 16 * L::RB, L::K_BOX, 8 * L::RB, L::MODE));",
               "dq_acc[kk] += __uint_as_float(da[kk][0]);")],
    # no dq stores (kept behind a test the accumulator practically never passes)
    "nostore": [("    if (row >= n) continue;\n    bf16* qrow",
                 "    if (row >= n || dq_acc[0] != 12345.f) continue;\n    bf16* qrow")],
    # the fallback design: do read from shared memory by the wgmma, 128-key tiles
    "do_smem": [("constexpr int BKW = 64;       // keys per tile",
                 "constexpr int BKW = 128;      // keys per tile"),
                ("static constexpr int STAGES = DQK == 64 ? 3 : 4;",
                 "static constexpr int STAGES = 2;"),
                # two stages of 128 keys do not fit at d_qk 64: refused there,
                # and at d_qk 128 (not probed)
                ("    if (dqk <= 64) return launch_wgmma<64>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);\n"
                 "    return launch_wgmma<128>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);",
                 "    return static_cast<int>(cudaErrorNotSupported);"),
                (EXP2, _wgmma_ss_n128() + EXP2),
                ("if (c < boxes) ldsm_x4(", "if (c < 0) ldsm_x4("),
                ("const uint32_t (&do_a)[4 * Layout<DQK>::DVB][4], uint32_t q_rows,",
                 "const uint32_t (&do_a)[4 * Layout<DQK>::DVB][4], uint32_t do_rows, "
                 "uint32_t q_rows,"),
                ("mma_s_dp<DQK>(s, dp, do_a, q_rows, base + L::K, base + L::V, boxes);",
                 "mma_s_dp<DQK>(s, dp, do_a, base + L::DO + cw * 64 * 128, q_rows, base + L::K, "
                 "base + L::V, boxes);"),
                ("mma_s_dp<DQK>(s, dp, do_a, q_rows, base + L::K + stage1 * L::K_TILE,",
                 "mma_s_dp<DQK>(s, dp, do_a, base + L::DO + cw * 64 * 128, q_rows, "
                 "base + L::K + stage1 * L::K_TILE,"),
                ("wgmma_rs_kmajor(dp, do_a[4 * c + kk], make_desc(v_tile",
                 "wgmma_ss(dp, make_desc(do_rows + c * DO_BOX + kk * 32, 16, 1024, 1), "
                 "make_desc(v_tile")],
    # the consumers start their products whenever they are ready, not in turn
    "noturns": [('asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + cw) : "memory");', "(void)cw;"),
                ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - cw) : "memory");', "(void)cw;")],
}
DEFAULT = ["base", "noload", "nomma", "nostore", "do_smem", "noturns", "do_smem+noturns"]
KERNELS = {"main": "attn_dq_wgmma"}
# the smoke's bf16 cases that the backward kernels take whole
CASES = [shape for shape, dtype in cs.ATTN_CASES
         if dtype == torch.bfloat16 and shape[3] <= sa.backward_width(shape[2])]


def variant_source(src: str, variant: str) -> str:
    """The source with the variant's edits."""
    for name in variant.split("+"):
        for old, new in EDITS[name]:
            if old not in src:
                raise RuntimeError(f"{variant}: edit {name} no longer applies to the source")
            src = src.replace(old, new)
    return src


def ptxas_report(log: str, kernel: str) -> str:
    """Registers and spill stores of ``kernel``'s entries in an -Xptxas -v
    log (one per d_qk instance), and whether ptxas serialised a wgmma
    anywhere (C7510-C7515)."""
    regs, spills = [], []
    for entry in re.finditer(rf"Compiling entry function '\w*{kernel}\w*'(.*?)(?=Compiling entry|\Z)",
                             log, re.S):
        m = re.search(r"Used (\d+) registers", entry.group(1))
        regs.append(m.group(1) if m else "?")
        m = re.search(r"(\d+) bytes spill stores", entry.group(1))
        spills.append(m.group(1) if m else "?")
    return (f"registers={'/'.join(regs) or '?'} spill_store_bytes={'/'.join(spills) or '?'} "
            f"wgmma_serialized={bool(re.search(r'C751[0-5]', log))}")


def build(variants):
    src = (_build.CSRC / "spatial_attention_dq.cu").read_text()
    out = REPO / "build" / "probe_dq"
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
        print(f"build {v} {ptxas_report(log, KERNELS['main'])}", flush=True)
        fns[v] = _build.bind(ctypes.CDLL(str(cu.with_suffix(".so"))), "spatial_attention_dq")
    return fns


def correct(gen, verbose: bool) -> tuple[bool, float, int]:
    """Every case the variant takes passes ``bf16_backward_check`` and two
    runs are bitwise equal; the worst error against the contract in units of
    its tolerance, and the number of cases the variant refused."""
    contract = lambda *a: (sa.spatial_attention_dq_contract(*a),)  # noqa: E731
    ok, worst, refused = True, 0.0, 0
    for shape in CASES:
        q, k, v, do = cs.attention_inputs(shape, torch.bfloat16, gen)
        o, lse = sa.spatial_attention_forward(q, k, v)
        di = (o.float() * do.float()).sum(-1)
        try:
            dq, dq2 = (sa.spatial_attention_dq(q, k, v, do, lse, di) for _ in range(2))
            torch.cuda.synchronize()
        except RuntimeError:   # a launch the variant refuses (do_smem at d_qk 64 and 128)
            refused += 1
            continue
        (dq_c,) = cs.per_image(contract, q, k, v, do, lse, di)
        plain = sa.spatial_attention_dq_reference(q, k, v, do, lse, di)
        truth = sa.spatial_attention_dq_reference(*(t.float() for t in (q, k, v, do)), lse, di)
        verdict = cs.bf16_backward_check(dq, dq_c, plain, truth)
        same = torch.equal(dq, dq2)
        share = verdict["vs_contract_max"] / verdict["vs_contract_tol"]
        worst = max(worst, share)
        ok &= verdict["ok"] and same
        if verbose or not verdict["ok"]:
            print(f"case {'x'.join(map(str, shape))} vs_contract_ulps={share:.3f} "
                  f"rms_vs_f32={verdict['rms_vs_f32']:.3e} "
                  f"plain_rms_vs_f32={verdict['plain_rms_vs_f32']:.3e} "
                  f"ok={verdict['ok']} bitwise_repeatable={same}", flush=True)
        del q, k, v, do, o, lse, di, dq, dq2, dq_c, plain, truth
        torch.cuda.empty_cache()
    return ok, worst, refused


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_torch_dq: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    variants = argv or DEFAULT
    fns = build(variants)
    real = _build.kernel
    use = lambda v: setattr(_build, "kernel",  # noqa: E731
                            lambda n: fns[v] if n == "spatial_attention_dq" else real(n))
    gen = torch.Generator(device="cuda").manual_seed(0)
    computes = {}
    for v in variants:
        use(v)
        computes[v] = correct(gen, verbose=v == "base")
        print(f"check {v} computes_dq={computes[v][0]} worst_ulps_vs_contract={computes[v][1]:.3f} "
              f"cases_refused={computes[v][2]}/{len(CASES)}", flush=True)
    shape = cs.ATTN_SHAPE
    q, k, v_, do = cs.attention_inputs(shape, torch.bfloat16, gen)
    o, lse = sa.spatial_attention_forward(q, k, v_)
    di = (o.float() * do.float()).sum(-1)
    call = lambda: sa.spatial_attention_dq(q, k, v_, do, lse, di)  # noqa: E731
    dkv = lambda: sa.spatial_attention_dkv(q, k, v_, do, lse, di)  # noqa: E731
    ms = {v: [] for v in ["dkv", *variants]}
    for _ in range(2):
        ms["dkv"].append(cs.event_ms(dkv, 20))
        for v in variants + variants[::-1]:
            use(v)
            ms[v].append(cs.event_ms(call, 20))
        ms["dkv"].append(cs.event_ms(dkv, 20))
    label = "x".join(map(str, shape))
    flop = cs.attention_flops(shape)["dq"]
    bound = cs.bound_ms(flop, cs.attention_bytes(shape, 2)["dq"], cs.PEAK_BF16_FLOPS)[0]
    print(f"dkv shape={label} event_ms={'/'.join(f'{t:.4f}' for t in ms['dkv'])}", flush=True)
    for v in variants:
        use(v)
        us = cs.kernel_device_us(call, 10, KERNELS)
        print(f"variant {v} shape={label} computes_dq={computes[v][0]} "
              f"event_ms={'/'.join(f'{t:.4f}' for t in ms[v])} "
              + " ".join(f"{k_}_us={t:.2f}" for k_, t in us.items())
              + f" main_tflops={flop / us['main'] / 1e6:.2f} bound_ms={bound:.4f}", flush=True)
    _build.kernel = real
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
