"""The variant generator's inputs from ``--seed``: its blocks' parameters and
the style gates' draws, beside ``draws.py``.

``variant_spec`` names the attention, channel-gate and style-gate
parameters in the program's state-dict names (``models/attention.py``).
``variant_weights`` draws them on top of ``draws.cut_weights``' G (which
it leaves as it is): every weight and bias from U(-1/sqrt(fan_in),
1/sqrt(fan_in)), as ``nets.make_params`` draws, the dense layers' biases
included, then three choices that put the blocks on the path (at the
program's init gamma = 0 and fc2 = 0 make the attention and the gate
identities, and q, k, v get no gradient):

- each attention ``gamma`` from U(0.5, 1);
- each style gate's ``gamma`` from U(0.5, 1.5) and ``beta`` from
  U(-0.5, 0.5).

``style_step`` draws one step's gate alphas, (3, n_blocks, B) from
U(alpha_min, alpha_max): the photo forward's, the fake's and the identity
pass's, as the program's ``StepDraws.style_fwd``, ``style_nce`` and
``style_idt``.

``block_inputs`` draws what ``reference/variant.py::block_grads`` and the
program's blocks take: an input and a cotangent at the trunk's shape, each
N(0, 1) rounded to bfloat16 (so that a bf16 program and the float32
reference start from the same values), and one set of style alphas.
"""

from __future__ import annotations

import torch

from portbench import draws as D
from portbench.reference.nets import make_params
from portbench.reference.variant import ATTN_REDUCTION, SE_REDUCTION

ATTN_GAMMA = (0.5, 1.0)
STYLE_GAMMA = (0.5, 1.5)
STYLE_BETA = (-0.5, 0.5)


def variant_spec(g_cfg: dict) -> list[tuple[str, tuple, int]]:
    """(name, shape, fan_in) of the variant blocks' parameters for a
    ``model.generator`` configuration. A 1 x 1 conv's weight is OIHW; a
    dense weight is (out, in); a gate's ``gamma`` and ``beta`` take the
    fan-in 1 (they are redrawn by ``variant_weights``)."""
    c = g_cfg["ngf"] * 2 ** g_cfg["n_downsampling"]
    inner, hidden = max(c // ATTN_REDUCTION, 1), max(c // SE_REDUCTION, 1)
    spec = []
    for i in range(g_cfg["n_blocks"]):
        if g_cfg.get("use_attention") and i in g_cfg["attn_layers"]:
            a = f"attn_{i}."
            spec.append((a + "gamma", (), 1))
            for conv, c_out in (("query", inner), ("key", inner), ("value", c), ("out", c)):
                spec += [(f"{a}{conv}.weight", (c_out, c, 1, 1), c),
                         (f"{a}{conv}.bias", (c_out,), c)]
        if g_cfg.get("use_channel_attn") and i in g_cfg["channel_attn_layers"]:
            s = f"channel_attn_{i}."
            spec += [(s + "fc1.weight", (hidden, c), c), (s + "fc1.bias", (hidden,), c),
                     (s + "fc2.weight", (c, hidden), hidden), (s + "fc2.bias", (c,), hidden)]
        if g_cfg.get("use_style_dropout"):
            spec += [(f"style_gate_{i}.gamma", (c,), 1), (f"style_gate_{i}.beta", (c,), 1)]
    return spec


def _uniform_(t: torch.Tensor, gen: torch.Generator, lo: float, hi: float) -> None:
    t.copy_(torch.rand(t.shape, generator=gen, device=gen.device) * (hi - lo) + lo)


def variant_weights(seed: int, cfg: dict, device) -> dict:
    """``draws.cut_weights`` with the variant blocks' parameters added to
    ``g`` (the ResNet's own parameters drawn as for the flagship)."""
    w = D.cut_weights(seed, cfg, device)
    gen = D.generator(seed, "weights.variant", device)
    extra = make_params(variant_spec(cfg["model"]["generator"]), gen, device)
    for name, t in extra.items():
        if name.startswith("attn_") and name.endswith(".gamma"):
            _uniform_(t, gen, *ATTN_GAMMA)
        elif name.startswith("style_gate_"):
            _uniform_(t, gen, *(STYLE_GAMMA if name.endswith(".gamma") else STYLE_BETA))
    w["g"] = {**w["g"], **extra}
    return w


def style_step(gen: torch.Generator, cfg: dict, b: int) -> torch.Tensor:
    """One step's style alphas, (3, n_blocks, b) float32."""
    g = cfg["model"]["generator"]
    lo, hi = g["style_dropout"]["alpha_min"], g["style_dropout"]["alpha_max"]
    u = torch.rand((3, g["n_blocks"], b), generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def block_inputs(seed: int, cfg: dict, b: int, device) -> tuple:
    """(x, dy, style): x and dy (b, C, S, S) float32 at the trunk's channels
    C and side S, style (n_blocks, b)."""
    g = cfg["model"]["generator"]
    c, side = g["ngf"] * 2 ** g["n_downsampling"], cfg["image_size"] >> g["n_downsampling"]
    gen = D.generator(seed, "blocks", device)
    x, dy = (torch.randn((b, c, side, side), generator=gen, device=device)
             .bfloat16().float() for _ in range(2))
    return x, dy, style_step(gen, cfg, b)[0]
