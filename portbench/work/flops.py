"""Model FLOPs and trunk-conv work from shapes, and the card's peaks.

The benchmark's own arithmetic: nothing here reads the program. A conv's
FLOPs are 2 x MACs; a training pass counts 3 x its forward (the forward,
the input gradient and the weight gradient), the convention of the
scaling literature. Elementwise work, norms, the optimizer and the
PatchNCE matmuls (< 0.1% of a step) are left out.

Pass accounting of the CUT step (``CUTTrainer.train_step``), per image:

- G: the forward on the photos (every layer), the taps-only forward on the
  fake (it stops after the last tapped layer), and in the identity warmup
  the forward on the Monets, each with its backward: 3 x forward each;
- D: the D step on 2 images a sample (3 x forward), the G head's forward
  on the fake with its input gradient (2 x forward), and on R1 steps the
  float32 D's forward, its input gradient with a graph, and the gradient
  of that into D's weights (6 x forward).

CycleGAN's step (``CycleGANTrainer.train_step``) at batch b: three G
applies of 2b, 3b and b images, each with its backward; D_A and D_B on the
fakes with their input gradients (2 x forward each, b images), and the two
D steps on 2b images each (3 x forward).
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, from NVIDIA's data sheet (at its 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def conv_flops(out_h: int, out_w: int, c_in: int, c_out: int, k: int) -> float:
    """2 x MACs of a dense k x k conv producing (out_h, out_w, c_out)."""
    return 2.0 * out_h * out_w * c_out * c_in * k * k


def generator_layer_flops(image_size: int, ngf: int = 64, n_blocks: int = 9,
                          n_down: int = 2) -> list[float]:
    """Forward FLOPs per image of each stage of the ResNet generator, in the
    order of its tap ids (stem, downsamplings, residual blocks, upsamplings),
    then the output conv."""
    s, ch = image_size, ngf
    layers = [conv_flops(s, s, 3, ngf, 7)]
    for _ in range(n_down):
        s //= 2
        layers.append(conv_flops(s, s, ch, ch * 2, 3))
        ch *= 2
    layers += [2 * conv_flops(s, s, ch, ch, 3)] * n_blocks
    for _ in range(n_down):
        # a stride-2 transposed conv: every input pixel through the k^2 kernel
        layers.append(2.0 * s * s * ch * (ch // 2) * 9)
        s *= 2
        ch //= 2
    layers.append(conv_flops(s, s, ch, 3, 7))
    return layers


def generator_fwd_flops(image_size: int, ngf: int = 64, n_blocks: int = 9,
                        n_down: int = 2) -> float:
    """One generator forward per image."""
    return sum(generator_layer_flops(image_size, ngf, n_blocks, n_down))


def generator_taps_fwd_flops(image_size: int, taps, ngf: int = 64, n_blocks: int = 9,
                             n_down: int = 2) -> float:
    """The taps-only forward per image: the stages up to the last tap that
    exists."""
    layers = generator_layer_flops(image_size, ngf, n_blocks, n_down)
    n_stages = len(layers) - 1
    last = max((t for t in taps if 0 <= t < n_stages), default=-1)
    return sum(layers[:last + 1])


def discriminator_fwd_flops(image_size: int, ndf: int = 64, n_layers: int = 3) -> float:
    """One PatchGAN forward per image (4 x 4 convs, padding 1; stride 2 up to
    conv_{n_layers - 1}, stride 1 after)."""
    hw, ch = image_size // 2, ndf
    total = conv_flops(hw, hw, 3, ndf, 4)
    for n in range(1, n_layers):
        nf = ndf * min(2 ** n, 8)
        hw //= 2
        total += conv_flops(hw, hw, ch, nf, 4)
        ch = nf
    nf = ndf * min(2 ** n_layers, 8)
    total += conv_flops(hw - 1, hw - 1, ch, nf, 4)
    total += conv_flops(hw - 2, hw - 2, nf, 1, 4)
    return total


def _g_d(size: int, g_cfg: dict, d_cfg: dict) -> tuple[float, float]:
    """(G forward, D forward) per image; a multiscale D sums its pyramid
    (each AvgPool(3, 2, 1) level half the size)."""
    g = generator_fwd_flops(size, g_cfg.get("ngf", 64), g_cfg.get("n_blocks", 9),
                            g_cfg.get("n_downsampling", 2))
    d = sum(discriminator_fwd_flops(-(-size // 2 ** i), d_cfg.get("ndf", 64),
                                    d_cfg.get("n_layers", 3))
            for i in range(int(d_cfg.get("num_scales", 1))))
    return g, d


def cut_step_flops(cfg: dict, batch: int, step: int) -> float:
    """Model FLOPs of CUT step ``step`` at ``batch`` (its identity pass and
    R1 as the step index decides)."""
    size = int(cfg.get("image_size", 256))
    g_cfg, d_cfg = cfg["model"]["generator"], cfg["model"]["discriminator"]
    g, d = _g_d(size, g_cfg, d_cfg)
    taps = generator_taps_fwd_flops(size, cfg["patchnce"]["nce_layers"], g_cfg.get("ngf", 64),
                                    g_cfg.get("n_blocks", 9), g_cfg.get("n_downsampling", 2))
    warmup = int(cfg.get("warmup_steps", 20000))
    identity = step < warmup and float(cfg["loss_weights"]["identity_warm"]) > 0
    r1 = float(cfg["r1"]["gamma"]) > 0 and step % int(cfg["r1"]["every"]) == 0
    g_passes = 3 * (g + taps + (g if identity else 0.0))
    d_passes = (6 + 2 + (6 if r1 else 0)) * d
    return batch * (g_passes + d_passes)


def cyclegan_step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one CycleGAN step at ``batch``."""
    size = int(cfg["data"]["img_size"])
    m = cfg["model"]
    g, d = _g_d(size, {"ngf": m["ngf"], "n_blocks": m["n_blocks"]},
                {"ndf": m["ndf"], "n_layers": m.get("n_layers", 3)})
    return batch * (3 * 6 * g + (2 * 2 + 2 * 2 * 3) * d)


def serve_batch_flops(cfg: dict, batch: int) -> float:
    """The generator forward of one served batch."""
    g_cfg = cfg["model"]["generator"]
    return batch * generator_fwd_flops(int(cfg.get("image_size", 256)), g_cfg.get("ngf", 64),
                                       g_cfg.get("n_blocks", 9), g_cfg.get("n_downsampling", 2))


# --------------------------------------------------------------------------- #
# the trunk's reflect 3x3 convs

def trunk_conv_work(n: int, h: int, w: int, c: int, kind: str,
                    itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one trunk conv call at (n, h, w, c) -> c channels:
    ``fwd`` reads x, w and the float32 bias and writes y; ``dx`` reads dy
    and w and writes dx; ``dw`` reads x and dy and writes the float32 dw.
    Each input byte is read once and each output byte written once."""
    flops = 2.0 * 9 * n * h * w * c * c
    act = n * h * w * c * itemsize
    if kind == "fwd":
        nbytes = 2 * act + 9 * c * c * itemsize + c * 4
    elif kind == "dx":
        nbytes = 2 * act + 9 * c * c * itemsize
    elif kind == "dw":
        nbytes = 2 * act + 9 * c * c * 4
    else:
        raise ValueError(f"kind must be fwd|dx|dw, got {kind!r}")
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time for the work on the card's peaks."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def trunk_calls(passes, kinds=("fwd", "dx", "dw")) -> list[tuple[int, str]]:
    """(batch, kind) of every trunk conv call of G passes given as (batch,
    residual blocks run) pairs: two convs a block, each kind once."""
    return [(b, k) for b, blocks in passes for _ in range(2 * blocks) for k in kinds]


def cut_trunk_passes(cfg: dict, batch: int, step: int) -> list[tuple[int, int]]:
    """(batch, blocks) of CUT step ``step``'s G passes: the photos, the
    taps-only pass on the fake (the blocks before its last tap), and the
    identity pass in the warmup."""
    g_cfg = cfg["model"]["generator"]
    n_down, n_blocks = g_cfg.get("n_downsampling", 2), g_cfg.get("n_blocks", 9)
    n_stages = 1 + 2 * n_down + n_blocks
    last = max((t for t in cfg["patchnce"]["nce_layers"] if 0 <= t < n_stages), default=-1)
    passes = [(batch, n_blocks), (batch, min(max(last - n_down, 0), n_blocks))]
    if step < int(cfg.get("warmup_steps", 20000)) and float(cfg["loss_weights"]["identity_warm"]) > 0:
        passes.append((batch, n_blocks))
    return passes


def cyclegan_trunk_passes(cfg: dict, batch: int) -> list[tuple[int, int]]:
    """(batch, blocks) of a CycleGAN step's three G applies."""
    n_blocks = cfg["model"]["n_blocks"]
    return [(2 * batch, n_blocks), (3 * batch, n_blocks), (batch, n_blocks)]


def trunk_bound_s(calls, size: int, ngf: int, n_down: int) -> float:
    """The summed bound of ``calls`` ((batch, kind) pairs) at the trunk's
    shape for ``size``^2 images."""
    hw, c = size >> n_down, ngf << n_down
    return sum(bound_s(*trunk_conv_work(b, hw, hw, c, kind)) for b, kind in calls)
