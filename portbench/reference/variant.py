"""The plain reference of the CUT variant generator and its train step, float32.

Written from the published blocks on NCHW tensors with ``torch`` alone,
reusing ``nets``' convs, instance norm and reflect padding, in the
program's state-dict names (``portbench/draws_variant.py`` gives the
spec):

- SAGAN self-attention (Zhang et al. 2018, https://arxiv.org/abs/1805.08318)
  after the blocks in ``attn_layers``: ``x + gamma * W_o(softmax(q k^T) v)``
  with q = W_q x, k = W_k x, v = W_v x, every W a 1 x 1 conv with a bias;
  q and k have C / 8 channels; the (B, n, n) attention map over all n = H W
  positions is materialised;
- the squeeze-and-excitation gate (Hu et al. 2018,
  https://arxiv.org/abs/1709.01507) after the blocks in
  ``channel_attn_layers``: ``x * 2 sigmoid(fc2(relu(fc1(mean x))))`` with
  C / 16 hidden units;
- the style-dropout gate after every block:
  ``alpha x + (1 - alpha)(gamma IN(x) + beta)`` for a per-sample alpha.

Departures from the papers, as the program runs the blocks:

- SAGAN scales no logits (softmax of q k^T as it stands, as the paper
  writes it) and its q, k, v convs keep their biases; the paper's max
  pooling of k and v (BigGAN's variant) is not used: every position
  attends to every position;
- the SE gate is ``2 sigmoid`` in place of ``sigmoid``, so that a gate of
  zero logits passes its input unchanged; its dense layers have biases;
- the style gate is the repository's own (no paper): the instance norm
  has no affine of its own, ``gamma`` and ``beta`` are the gate's;
- each block's variant blocks follow it in the order attention, channel
  gate, style gate; a tap of the block sees its output after all three.

``cast`` is the precision of every product (``nets.FP32``; ``nets.FP8``
for the control): the convs as ``nets`` casts them, and the attention's
two products and the gate's dense layers the same way.

``CUTVariant`` is ``steps.CUT`` on this generator: the forward on the
photos, the taps-only forward on the fake and the identity pass take
their own style draws, ``draws["style"][0]``, ``[1]`` and ``[2]`` (each
(n_blocks, B)), as the program's ``StepDraws.style_fwd``, ``style_nce``
and ``style_idt``. With ``drop_attention`` the attention blocks return
their input: a fault the check must catch.

``block_grads`` is each variant block alone on one input and one
cotangent: the first gradient of its parameters and of its input.
"""

from __future__ import annotations

import torch

from portbench.reference import nets
from portbench.reference import steps

# the program's widths (``models/attention.py``): q and k of C / 8
# channels, the SE gate's C / 16 hidden units
ATTN_REDUCTION = 8
SE_REDUCTION = 16


def _matmul(a: torch.Tensor, b: torch.Tensor, cast) -> torch.Tensor:
    return cast.result(cast.operand(a) @ cast.operand(b))


def self_attention(p: dict, name: str, x: torch.Tensor, cast=nets.FP32) -> torch.Tensor:
    """SAGAN's block ``name`` (``attn_<i>.``) on NCHW ``x``."""
    b, c, h, w = x.shape
    q = nets.conv(x, p[name + "query.weight"], p[name + "query.bias"], cast=cast).flatten(2)
    k = nets.conv(x, p[name + "key.weight"], p[name + "key.bias"], cast=cast).flatten(2)
    v = nets.conv(x, p[name + "value.weight"], p[name + "value.bias"], cast=cast).flatten(2)
    attn = torch.softmax(_matmul(q.transpose(1, 2), k, cast), dim=-1)    # (B, n, n)
    o = _matmul(v, attn.transpose(1, 2), cast).view(b, c, h, w)           # o_c,i = sum_j a_ij v_c,j
    out = nets.conv(o, p[name + "out.weight"], p[name + "out.bias"], cast=cast)
    return x + p[name + "gamma"] * out


def channel_gate(p: dict, name: str, x: torch.Tensor, cast=nets.FP32) -> torch.Tensor:
    """The SE gate ``name`` (``channel_attn_<i>.``) on NCHW ``x``; the dense
    weights are (out, in)."""
    pooled = x.mean(dim=(2, 3))
    z = torch.relu(_matmul(pooled, p[name + "fc1.weight"].T, cast) + p[name + "fc1.bias"])
    z = _matmul(z, p[name + "fc2.weight"].T, cast) + p[name + "fc2.bias"]
    return x * (2.0 * torch.sigmoid(z))[:, :, None, None]


def style_gate(p: dict, name: str, x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The style gate ``name`` (``style_gate_<i>.``) on NCHW ``x`` for the
    per-sample ``alpha`` (B,)."""
    a = alpha.view(-1, 1, 1, 1)
    styled = (p[name + "gamma"].view(1, -1, 1, 1) * nets.instance_norm(x)
              + p[name + "beta"].view(1, -1, 1, 1))
    return a * x + (1.0 - a) * styled


def generator(p: dict, x: torch.Tensor, g_cfg: dict, style: torch.Tensor | None = None,
              taps=(), taps_only: bool = False, cast=nets.FP32,
              drop_attention: bool = False):
    """``nets.generator``'s stages with each residual block followed by its
    variant blocks as ``g_cfg`` (the configuration's ``model.generator``)
    places them; ``style`` (n_blocks, B) feeds the style gates (without it
    they pass their input, as the program's do). Returns (image,
    features at the stage ids ``taps``)."""
    n_down, n_blocks = g_cfg["n_downsampling"], g_cfg["n_blocks"]
    attn = set(g_cfg["attn_layers"]) if g_cfg.get("use_attention") else set()
    channel = set(g_cfg["channel_attn_layers"]) if g_cfg.get("use_channel_attn") else set()
    styled = bool(g_cfg.get("use_style_dropout")) and style is not None
    g = p.get

    def norm_relu(y):
        return torch.relu(nets.instance_norm(y))

    stages = [lambda h: norm_relu(nets.conv(nets.reflect(h, 3), p["initial_conv.weight"],
                                            g("initial_conv.bias"), cast=cast))]
    for i in range(n_down):
        stages.append(lambda h, i=i: norm_relu(nets.conv(
            h, p[f"down_{i}.weight"], g(f"down_{i}.bias"), 2, 1, cast)))

    def block(h, i):
        r = f"res_{i}."
        t = norm_relu(nets.conv(nets.reflect(h, 1), p[r + "conv1_weight"], g(r + "conv1_bias"),
                                cast=cast))
        h = h + nets.instance_norm(nets.conv(nets.reflect(t, 1), p[r + "conv2_weight"],
                                             g(r + "conv2_bias"), cast=cast))
        if i in attn and not drop_attention:
            h = self_attention(p, f"attn_{i}.", h, cast)
        if i in channel:
            h = channel_gate(p, f"channel_attn_{i}.", h, cast)
        if styled:
            h = style_gate(p, f"style_gate_{i}.", h, style[i])
        return h

    stages += [lambda h, i=i: block(h, i) for i in range(n_blocks)]
    for i in range(n_down):
        stages.append(lambda h, i=i: norm_relu(nets.conv_transpose(
            h, p[f"up_{i}.weight"], g(f"up_{i}.bias"), cast)))
    tap_set = set(taps)
    last = max((t for t in tap_set if t < len(stages)), default=-1)
    feats = []
    h = x
    for idx, stage in enumerate(stages):
        h = stage(h)
        if idx in tap_set:
            feats.append(h)
        if taps_only and idx == last:
            return None, feats
    out = torch.tanh(nets.conv(nets.reflect(h, 3), p["output_conv.weight"],
                               p["output_conv.bias"], cast=cast))
    return out, feats


def variant_blocks(g_cfg: dict) -> list[tuple[str, str, int]]:
    """(name, kind, trunk block) of each variant block in the order the
    generator runs them; kind is ``attn``, ``channel`` or ``style``."""
    out = []
    for i in range(g_cfg["n_blocks"]):
        if g_cfg.get("use_attention") and i in g_cfg["attn_layers"]:
            out.append((f"attn_{i}", "attn", i))
        if g_cfg.get("use_channel_attn") and i in g_cfg["channel_attn_layers"]:
            out.append((f"channel_attn_{i}", "channel", i))
        if g_cfg.get("use_style_dropout"):
            out.append((f"style_gate_{i}", "style", i))
    return out


def block_grads(p: dict, g_cfg: dict, x: torch.Tensor, dy: torch.Tensor,
                style: torch.Tensor, cast=nets.FP32,
                drop_attention: bool = False) -> dict[str, torch.Tensor]:
    """Each variant block alone on NCHW ``x`` with the cotangent ``dy`` (the
    gradient of sum(block(x) * dy)), and ``style`` (n_blocks, B) for the
    style gates: ``{block.leaf: its first gradient}`` and ``{block.dx:
    the input's}``. A parameter the block leaves out reads zero."""
    out = {}
    for name, kind, i in variant_blocks(g_cfg):
        prefix = name + "."
        leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()
                  if k.startswith(prefix)}
        xi = x.detach().clone().requires_grad_()
        if kind == "attn":
            y = xi if drop_attention else self_attention(leaves, prefix, xi, cast)
        elif kind == "channel":
            y = channel_gate(leaves, prefix, xi, cast)
        else:
            y = style_gate(leaves, prefix, xi, style[i])
        grads = torch.autograd.grad((y * dy).sum(), [*leaves.values(), xi], allow_unused=True)
        for (k, v), g in zip([*leaves.items(), (prefix + "dx", xi)], grads):
            out[k] = torch.zeros_like(v) if g is None else g.detach()
    return out


class CUTVariant(steps.CUT):
    """``steps.CUT`` on the variant generator. ``step``'s draws carry
    ``style`` (3, n_blocks, B): the style draws of the step's G passes in
    the order ``steps.CUT.step`` makes them (the photos, the fake, the
    identity pass)."""

    def __init__(self, cfg: dict, cast=nets.FP32, drop_attention: bool = False):
        super().__init__(cfg, cast)
        self.g_cfg = cfg["model"]["generator"]
        self.drop_attention = drop_attention
        self._style: list[torch.Tensor] = []

    def G(self, p, x, **kw):
        style = self._style.pop(0) if self._style else None
        return generator(p, x, self.g_cfg, style, cast=self.cast,
                         drop_attention=self.drop_attention, **kw)

    def step(self, st: dict, photos_u8, monets_u8, draws: dict, step: int) -> dict:
        self._style = list(draws["style"].unbind(0))
        try:
            return super().step(st, photos_u8, monets_u8, draws, step)
        finally:
            self._style = []
