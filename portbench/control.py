"""Readings that set the limits of ``correct``: the control and the faults.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]
    python3 portbench/control.py --profiler-check

For each seed, the cell's numbers read by the reference's lower-precision
control (its convs in float8 e4m3 under a per-tensor scale, the step below
the configurations' bf16) and by the faults the check must catch, each put
in the program's place against the float32 reference: for a training cell
the half-batch step (the first half of each batch, the mean over it); for
serving one answer altered (image 0 of a batch inverted) and half of the
batch left out (zeros). A state left unchanged reads 1 by ``change_gap``'s
measure and needs no run. One JSON line a seed.

``--profiler-check`` holds the profiler's device time of the trunk kernels
against CUDA events at the reporting cells' trunk shapes, before the
rooflines trust it. Neither is part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def training_readings(cell: dict, seed: int, device="cuda", program: bool = False,
                      faults: bool = True) -> dict:
    from portbench import compare
    from portbench import measure as M
    from portbench.harness import driver
    from portbench.reference import nets

    drv = driver(cell)
    out = {}
    if program:
        M.program_precision()
        prog = drv.checked(cell, seed, device)[-1]
        M.free_memory(device)
    M.full_precision()
    truth = drv.reference(cell, seed, device)
    if program:
        out["program"] = {k: v for k, (v, _) in compare.train_numbers(prog, truth).items()}
    runs = [("control_fp8", {"cast": nets.FP8})] if faults else []
    if faults and cell["workload"]["batch"] > 1:      # a batch of one has no half to leave out
        runs.append(("fault_half_batch", {"half": True}))
    for name, kw in runs:
        numbers = compare.train_numbers(drv.reference(cell, seed, device, **kw), truth)
        out[name] = {k: v for k, (v, _) in numbers.items()}
        M.free_memory(device)
    return out


def serving_readings(cell: dict, seed: int, device="cuda") -> dict:
    from portbench import compare
    from portbench import draws as D
    from portbench.harness import driver
    from portbench.reference import nets

    drv = driver(cell)
    wl, size = cell["workload"], cell["config"]["train"]["image_size"]
    photos = D.image_ring(seed, "images", wl["ring"], wl["batch"], size, device).flatten(0, 1).cpu()
    truth = drv.reference(cell, seed, device, photos)
    control = drv.reference(cell, seed, device, photos, nets.FP8)
    altered = truth.clone()
    altered[::wl["batch"]] = 255 - altered[::wl["batch"]]
    halved = truth.clone().view(wl["ring"], wl["batch"], *truth.shape[1:])
    halved[:, wl["batch"] // 2:] = 0
    return {name: {"image_gap": compare.image_gap(x, truth)[0]}
            for name, x in (("control_fp8", control), ("fault_altered_answer", altered),
                            ("fault_half_batch", halved.flatten(0, 1)))}


TRUNK_SHAPES = (12, 16, 32, 48)      # the trunk batches of the reporting cells


def profiler_check() -> list[dict]:
    """Per trunk kernel kind and batch: the ms a call on CUDA events (calls
    queued behind a spin kernel, so the device runs them back to back),
    and on the profiler's durations (every device op, and the trunk
    kernels that ``trunk_roofline.train`` names)."""
    import torch

    from gan_variant_research_tpu_torch.ops.kernels import resblock as rb
    from portbench import harness

    pattern = harness.metric_reader(harness.load_cell("cut_flagship.train_warmup_b12", ROOT),
                                    "trunk_roofline.train").KERNELS
    import re

    rx = re.compile(pattern)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    iters = 50
    for n in TRUNK_SHAPES:
        x = torch.randn((n, 64, 64, 256), device="cuda", generator=gen).bfloat16()
        dy = torch.randn((n, 64, 64, 256), device="cuda", generator=gen).bfloat16()
        w = (torch.randn((3, 3, 256, 256), device="cuda", generator=gen) / 48).bfloat16()
        b = torch.zeros(256, device="cuda")
        calls = {"fwd": lambda: rb.reflect_conv3x3(x, w, b),
                 "dx": lambda: rb.reflect_conv3x3_dx(dy, w),
                 "dw": lambda: rb.reflect_conv3x3_dw(x, dy)}
        for kind, fn in calls.items():
            with torch.no_grad():
                fn()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(iters * 1_000_000)
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                queued = not start.query()
                torch.cuda.synchronize()
                events_ms = start.elapsed_time(end) / iters
                t = harness.profile_stretch(lambda: [fn() for _ in range(iters)], "cuda")
            all_ms = sum(e - a for _, a, e in t["ops"]) / 1e3 / iters
            named_ms = sum(e - a for name, a, e in t["ops"] if rx.search(name)) / 1e3 / iters
            rows.append({"kind": kind, "batch": n, "events_ms": events_ms, "queued": queued,
                         "profiler_all_ms": all_ms, "profiler_trunk_ms": named_ms,
                         "names": sorted({name[:60] for name, _, _ in t["ops"]})})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--profiler-check", action="store_true")
    p.add_argument("--program", action="store_true",
                   help="also the program's checked steps against the reference (training cells)")
    p.add_argument("--no-faults", action="store_true", help="skip the control and the faults")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    if args.profiler_check:
        for row in profiler_check():
            print(json.dumps(row), flush=True)
    if args.workload:
        cell = harness.load_cell(args.workload, ROOT)
        serving = cell["workload"]["driver"] == "serve"
        for seed in args.seeds:
            t = time.time()
            r = (serving_readings(cell, seed) if serving else training_readings(
                cell, seed, program=args.program, faults=not args.no_faults))
            print(json.dumps({"workload": args.workload, "seed": seed, **r,
                              "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
