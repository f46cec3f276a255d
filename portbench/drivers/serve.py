"""Driver: ``stylize_batch`` in a closed loop, as ``stylize_folder`` drives it.

Set-up builds the configuration's generator in its serving precision on
weights made from the seed and puts a ring of ``ring`` distinct uint8
photo batches in pinned host memory. Each call of the window hands one
batch to ``stylize_batch`` (which copies it to the card, scales it to
[-1, 1], runs the generator and returns uint8) and copies the result back
to pinned host memory, the copies ``stylize_folder`` pays; the JPEG codec
is left out. ``kept`` batches, drawn from the seed among the first the
window serves, are copied to buffers of their own, and checked against the
reference once the window has closed.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import compare
from portbench import draws as D
from portbench import measure as M
from portbench.reference import nets
from portbench.reference import steps as ref
from portbench.work import flops


def kept_calls(seed: int, wl: dict, seconds: float) -> list[int]:
    """The window calls whose outputs are checked: ``kept`` of the first
    ``seconds * kept_per_s`` (at least ``kept``)."""
    pool = max(wl["kept"], int(seconds * wl["kept_per_s"]))
    return sorted(random.Random(D.subseed(seed, "kept")).sample(range(pool), wl["kept"]))


def generator_spec(cfg: dict):
    g = cfg["model"]["generator"]
    return nets.generator_spec(g["ngf"], g["n_blocks"], g["n_downsampling"], True)


def reference(cell: dict, seed: int, device, inputs: torch.Tensor,
              cast=nets.FP32) -> torch.Tensor:
    """The reference's uint8 images for ``inputs`` (uint8 NHWC), in blocks
    of the served batch."""
    wl, cfg = cell["workload"], cell["config"]["train"]
    g = cfg["model"]["generator"]
    w = nets.make_params(generator_spec(cfg), D.generator(seed, "weights.g", device), device)
    return torch.cat([ref.serve(w, inputs[i:i + wl["batch"]].to(device), g["n_blocks"],
                                g["n_downsampling"], cast).cpu()
                      for i in range(0, len(inputs), wl["batch"])])


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from gan_variant_research_tpu_torch.cli.generate_folder import stylize_batch
    from gan_variant_research_tpu_torch.core.precision import policy_from_config
    from gan_variant_research_tpu_torch.train.cut_trainer import build_generator

    wl, cfg = cell["workload"], cell["config"]["train"]
    b, ring, size = wl["batch"], wl["ring"], cfg["image_size"]
    marks = [("imports", time.time())]
    net = build_generator(cfg["model"]["generator"], policy_from_config(cfg))
    net.load_state_dict(nets.make_params(generator_spec(cfg),
                                         D.generator(seed, "weights.g", device), device))
    net = net.to(device).eval()
    pin = torch.device(device).type == "cuda"
    photos = D.image_ring(seed, "images", ring, b, size, device)
    host_in = torch.empty(photos.shape, dtype=torch.uint8, pin_memory=pin).copy_(photos)
    host_out = torch.empty(photos.shape, dtype=torch.uint8, pin_memory=pin)
    kept = kept_calls(seed, wl, seconds)
    kept_out = torch.empty((len(kept), *photos.shape[1:]), dtype=torch.uint8, pin_memory=pin)
    del photos
    slot_of_kept = {c: j for j, c in enumerate(kept)}
    first, window = 0, False
    marks.append(("build", time.time()))

    def call(i):
        s = first + i
        out = stylize_batch(net, host_in[s % ring], size)
        j = slot_of_kept.get(i) if window else None
        (kept_out[j] if j is not None else host_out[s % ring]).copy_(out, non_blocking=pin)

    for i in range(wl["warm_calls"]):
        call(i)
    first, window = wl["warm_calls"], True
    out = M.measure(wl, seconds, trace, device, t_start, call,
                    flops_of=lambda i: flops.serve_batch_flops(cfg, b),
                    trunk_of=lambda i: flops.trunk_calls(
                        [(b, cfg["model"]["generator"]["n_blocks"])], kinds=("fwd",)),
                    marks=marks)
    due = [j for j, c in enumerate(kept) if c < out["calls"]]
    served = kept_out[due].clone()
    inputs = host_in[[(first + kept[j]) % ring for j in due]]
    out["attempted"], out["failed"] = out["window"]["images"], 0
    out["e2e"] = {"serve_images_per_s": out["window"]["images"] / out["window"]["seconds"],
                  "peak_mem_gib": out["peak_mem_gib"], "setup_s": out["setup_s"]}
    g = cfg["model"]["generator"]
    out["ctx"]["trunk_geom"] = (size, g["ngf"], g["n_downsampling"])
    del net, call, host_in, host_out, kept_out
    M.free_memory(device)
    M.full_precision()
    if len(served):
        gap, where = compare.image_gap(served.flatten(0, 1),
                                       reference(cell, seed, device, inputs.flatten(0, 1)))
        numbers = {"image_gap": (gap, f"image{where}")}
    else:
        numbers = {}
    out["checks"] = M.checks(numbers, wl["limits"])
    return out
