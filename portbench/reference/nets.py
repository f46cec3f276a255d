"""The plain reference nets: the ResNet generator and the PatchGAN, float32.

Written from the published architectures (Johnson et al.'s ResNet
generator as CycleGAN and CUT use it; the 70 x 70 PatchGAN) on NCHW
tensors with ``torch.nn.functional`` alone. Parameters come as a dict of
tensors under the names the benchmark gives them (``generator_spec``,
``patchgan_spec``), which are the names the program's state dicts use.

``cast`` is the convs' precision: ``FP32`` for the reference; ``FP8`` for
the lower-precision control, which trains as FP8 training does (the
operands of every conv forward in e4m3 and the gradient into every conv
in e5m2, each under a per-tensor scale).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS_IN = 1e-5


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 ``dtype`` under a per-tensor scale (its
    largest magnitude to ``top``), back in float32."""
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3; the gradient passes straight through."""
    xd = x.detach()
    return x + (_round(xd, torch.float8_e4m3fn, 448.0) - xd)


def _gradient_rounded(rounding):
    """The identity, whose gradient is rounded by ``rounding``
    (differentiably, so that R1's double backward passes through)."""
    class Rounded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            gd = g.detach()
            return g + (rounding(gd) - gd)
    return Rounded.apply


class Precision:
    """``operand`` is applied to a conv's input and weight, ``result`` to its
    output (on the way back, to the gradient into the conv)."""

    def __init__(self, operand, result):
        self.operand, self.result = operand, result


FP32 = Precision(lambda x: x, lambda y: y)
FP8 = Precision(fp8_e4m3,
                _gradient_rounded(lambda g: _round(g, torch.float8_e5m2, 57344.0)))


# --------------------------------------------------------------------------- #
# parameter specs: (name, shape, fan_in) in the program's state-dict names

def generator_spec(ngf: int = 64, n_blocks: int = 9, n_down: int = 2,
                   use_bias: bool = True) -> list[tuple[str, tuple, int]]:
    """The ResNet generator's parameters. Conv weights are OIHW; a
    transposed conv's weight is (in, out, kh, kw) with fan-in kh kw out;
    the residual convs are ``res_i.conv{1,2}_weight``; the output conv
    keeps its bias in both lineages."""
    spec = []

    def conv(name, c_out, c_in, k, bias=use_bias, transposed=False):
        shape = (c_in, c_out, k, k) if transposed else (c_out, c_in, k, k)
        fan_in = k * k * (c_out if transposed else c_in)
        spec.append((f"{name}weight", shape, fan_in))
        if bias:
            spec.append((f"{name}bias", (c_out,), fan_in))

    conv("initial_conv.", ngf, 3, 7)
    for i in range(n_down):
        m = 2 ** i
        conv(f"down_{i}.", ngf * m * 2, ngf * m, 3)
    c = ngf * 2 ** n_down
    for i in range(n_blocks):
        conv(f"res_{i}.conv1_", c, c, 3)
        conv(f"res_{i}.conv2_", c, c, 3)
    for i in range(n_down):
        m = 2 ** (n_down - i)
        conv(f"up_{i}.", ngf * m // 2, ngf * m, 3, transposed=True)
    conv("output_conv.", 3, ngf, 7, bias=True)
    return spec


def patchgan_spec(ndf: int = 64, n_layers: int = 3, norm: str = "none",
                  prefix: str = "") -> list[tuple[str, tuple, int]]:
    """The PatchGAN's parameters: 4 x 4 convs ``conv_0`` .. ``conv_{n}``
    and ``conv_out``; with instance norm the middle convs have no bias."""
    spec = []
    mid_bias = norm != "instance"

    def conv(name, c_out, c_in, bias):
        spec.append((f"{prefix}{name}.weight", (c_out, c_in, 4, 4), 16 * c_in))
        if bias:
            spec.append((f"{prefix}{name}.bias", (c_out,), 16 * c_in))

    conv("conv_0", ndf, 3, True)
    c = ndf
    for n in range(1, n_layers + 1):
        nf = ndf * min(2 ** n, 8)
        conv(f"conv_{n}", nf, c, mid_bias)
        c = nf
    conv("conv_out", 1, c, True)
    return spec


def make_params(spec, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Every parameter of ``spec`` from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (PyTorch's default conv init) in one draw on ``device``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    bounds = torch.tensor([1.0 / math.sqrt(f) for _, _, f in spec], device=device)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    flat = (u * 2.0 - 1.0) * torch.repeat_interleave(bounds, torch.tensor(sizes, device=device))
    return {name: t.view(shape) for (name, shape, _), t in zip(spec, flat.split(sizes))}


# --------------------------------------------------------------------------- #
# layers

def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS_IN)


def conv(x, w, b, stride=1, padding=0, cast=FP32):
    y = cast.result(F.conv2d(cast.operand(x), cast.operand(w), None, stride, padding))
    return y if b is None else y + b.view(1, -1, 1, 1)


def conv_transpose(x, w, b, cast=FP32):
    y = cast.result(F.conv_transpose2d(cast.operand(x), cast.operand(w), None, 2, 1, 1))
    return y if b is None else y + b.view(1, -1, 1, 1)


def reflect(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


# --------------------------------------------------------------------------- #
# nets

def generator(p: dict, x: torch.Tensor, n_blocks: int = 9, n_down: int = 2,
              taps=(), taps_only: bool = False, cast=FP32):
    """ResNet generator on NCHW ``x`` in [-1, 1]: reflect-pad 7 x 7 stem,
    stride-2 downsamplings, residual blocks (reflect pad, 3 x 3 conv,
    instance norm, ReLU, reflect pad, 3 x 3 conv, instance norm, added to
    the input), stride-2 transposed convs, reflect-pad 7 x 7 output conv and
    tanh; instance norm and ReLU after every other conv. Returns (image,
    features at the stage ids ``taps``); with ``taps_only`` the image is
    None and the net stops after the last tap that exists."""
    g = p.get
    stages = [lambda h: torch.relu(instance_norm(
        conv(reflect(h, 3), p["initial_conv.weight"], g("initial_conv.bias"), cast=cast)))]
    for i in range(n_down):
        stages.append(lambda h, i=i: torch.relu(instance_norm(conv(
            h, p[f"down_{i}.weight"], g(f"down_{i}.bias"), 2, 1, cast))))

    def block(h, i):
        r = f"res_{i}."
        t = torch.relu(instance_norm(conv(reflect(h, 1), p[r + "conv1_weight"],
                                          g(r + "conv1_bias"), cast=cast)))
        return h + instance_norm(conv(reflect(t, 1), p[r + "conv2_weight"],
                                      g(r + "conv2_bias"), cast=cast))

    stages += [lambda h, i=i: block(h, i) for i in range(n_blocks)]
    for i in range(n_down):
        stages.append(lambda h, i=i: torch.relu(instance_norm(conv_transpose(
            h, p[f"up_{i}.weight"], g(f"up_{i}.bias"), cast))))
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
    out = torch.tanh(conv(reflect(h, 3), p["output_conv.weight"], p["output_conv.bias"],
                          cast=cast))
    return out, feats


def patchgan(p: dict, x: torch.Tensor, n_layers: int = 3, norm: str = "none",
             prefix: str = "", cast=FP32) -> torch.Tensor:
    """70 x 70 PatchGAN on NCHW ``x``: 4 x 4 convs with zero padding 1 and
    LeakyReLU 0.2, stride 2 up to ``conv_{n_layers - 1}`` and stride 1
    after, instance norm after the middle convs when ``norm`` says so, and
    the 1-channel ``conv_out``: the logit map (B, 1, H', W')."""
    g = lambda name: p.get(prefix + name)  # noqa: E731
    h = F.leaky_relu(conv(x, g("conv_0.weight"), g("conv_0.bias"), 2, 1, cast), 0.2)
    for n in range(1, n_layers + 1):
        h = conv(h, g(f"conv_{n}.weight"), g(f"conv_{n}.bias"), 2 if n < n_layers else 1, 1,
                 cast)
        if norm == "instance":
            h = instance_norm(h)
        h = F.leaky_relu(h, 0.2)
    return conv(h, g("conv_out.weight"), g("conv_out.bias"), 1, 1, cast)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 levels: clamp, (x + 1) / 2 * 255, round half to even."""
    return torch.round((torch.clamp(x, -1.0, 1.0) * 0.5 + 0.5) * 255.0).to(torch.uint8)
