"""The readings that set the variant cell's limits, and the witness of what
its step-level first gradient reads.

    python3 portbench/control_variant.py --workload <name> --seeds <n> [<n> ...] [--program]
    python3 portbench/control_variant.py --workload <name> --seeds <n> [<n> ...] --witness

Readings, for each seed, in the numbers the variant driver decides
``correct`` by (``drivers/cut_variant_train.py::numbers``), each put in the
program's place against the float32 reference: the float8 control
(``nets.FP8``, the blocks' products too), the half batch, the attention
dropped (``reference/variant.py``'s ``drop_attention``), and with
``--program`` the program's own checked steps and blocks, and the
program's blocks with the attention backward's dK, dV or dQ doubled
(``fault_dk_doubled``, ``fault_dv_doubled``, ``fault_dq_doubled``: a
kernel off by a scale factor). The half batch leaves the blocks alone.

``--witness``: the program's checked steps three ways, in its bf16 with the
attention kernels, in float32 (``runtime.precision`` fp32, TF32 off, the
kernels' float32 instances) and in bf16 with the attention on the einsum
core (plain PyTorch, no kernel), each against the float32 reference:
``compare.train_numbers`` and, per G leaf, the reference's first-gradient
norm and each run's ``leaf_gap`` of it. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def doubled(kind: str):
    """(name, replacement) of the attention wrapper in
    ``ops/kernels/spatial_attention.py`` that doubles dK, dV or dQ."""
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa

    if kind == "dq":
        dq = sa.spatial_attention_dq
        return "spatial_attention_dq", lambda *a: 2 * dq(*a)
    dkv = sa.spatial_attention_dkv

    def wrong(*a):
        dk, dv = dkv(*a)
        return (2 * dk, dv) if kind == "dk" else (dk, 2 * dv)

    return "spatial_attention_dkv", wrong


def readings(cell: dict, seed: int, device="cuda", program: bool = False) -> dict:
    from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa
    from portbench import measure as M
    from portbench.harness import driver
    from portbench.reference import nets

    drv = driver(cell)
    out, prog, faults = {}, None, {}
    if program:
        M.program_precision()
        trainer, *_, prog = drv.checked(cell, seed, device)
        prog["blocks"] = drv.program_blocks(trainer, cell, seed, device)
        for kind in ("dk", "dv", "dq"):
            with mock.patch.object(sa, *doubled(kind)):
                faults[f"fault_{kind}_doubled"] = drv.program_blocks(trainer, cell, seed, device)
        del trainer, _
        M.free_memory(device)
    M.full_precision()
    truth = drv.reference(cell, seed, device)

    def read(x):
        return {k: v for k, (v, _) in drv.numbers(x, truth).items()}

    if program:
        out["program"] = read(prog)
        for name, blocks in faults.items():
            out[name] = {"grad_gap": read({**prog, "blocks": blocks})["grad_gap"]}
    for name, kw in (("control_fp8", {"cast": nets.FP8}), ("fault_half_batch", {"half": True}),
                     ("fault_attention_dropped", {"drop_attention": True})):
        out[name] = read(drv.reference(cell, seed, device, **kw))
        M.free_memory(device)
    return out


def _einsum_attention():
    """The attention blocks on the einsum core, as past d_qk 128."""
    from gan_variant_research_tpu_torch.models import attention

    route = attention.attention_core.attention_route
    return mock.patch.object(attention.attention_core, "attention_route",
                             lambda d_qk, d_v: ("einsum",) + tuple(route(d_qk, d_v)[1:]))


def witness(cell: dict, seed: int, device="cuda") -> dict:
    from portbench import compare
    from portbench import measure as M
    from portbench.harness import driver
    from portbench.reference.variant import variant_blocks

    drv = driver(cell)
    runs = {}
    for name, precision, patch in (("bf16", "bf16", contextlib.nullcontext()),
                                   ("fp32", "fp32", contextlib.nullcontext()),
                                   ("bf16_einsum", "bf16", _einsum_attention())):
        c = copy.deepcopy(cell)
        c["config"]["train"]["runtime"]["precision"] = precision
        M.full_precision() if precision == "fp32" else M.program_precision()
        with patch:
            runs[name] = drv.checked(c, seed, device)[-1]
        M.free_memory(device)
    M.full_precision()
    truth = drv.reference(cell, seed, device)
    ref = truth["grad"]["g"]
    median = statistics.median(ref.values())
    variant = tuple(name + "." for name, _, _ in variant_blocks(cell["config"]["train"]["model"]
                                                                ["generator"]))
    leaves, summary = {}, {}
    for k, r in ref.items():
        leaves[k] = [r] + [abs(p["grad"]["g"][k] - r) / max(r, median, 1e-30)
                           for p in runs.values()]
    for i, name in enumerate(runs, start=1):
        var = {k: v[i] for k, v in leaves.items() if k.startswith(variant)}
        rest = {k: v[i] for k, v in leaves.items() if not k.startswith(variant)}
        worst_v, worst_r = max(var, key=var.get), max(rest, key=rest.get)
        summary[name] = {
            "numbers": {k: v for k, (v, _) in compare.train_numbers(runs[name], truth).items()},
            "variant_worst": [worst_v, var[worst_v]],
            "variant_median": statistics.median(var.values()),
            "other_worst": [worst_r, rest[worst_r]]}
    return {"median_leaf": median, "summary": summary,
            "leaves": {k: v for k, v in leaves.items() if k.startswith(variant)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--witness", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control_variant: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t = time.time()
        r = witness(cell, seed) if args.witness else readings(cell, seed, program=args.program)
        print(json.dumps({"workload": args.workload, "seed": seed, **r,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
