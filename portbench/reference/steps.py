"""The plain reference's train steps and serving, float32.

- ``cut_step``: CUT (Park et al. 2020) with DiffAugment on D's inputs, the
  hinge loss, PatchNCE on the generator's tapped features, lazy R1 as a
  second D update every ``r1.every`` steps, the identity L1 during the
  warmup, Adam behind optax's global-norm clip, and the EMA of G;
- ``cyclegan_step``: CycleGAN (Zhu et al. 2017) with its six generator
  applies written out, LSGAN or BCE, the cycle and identity L1s, one Adam
  over both generators and one per discriminator, without a clip;
- ``serve``: uint8 NHWC photos -> [-1, 1] -> generator -> uint8 levels.

Parameters and Adam moments are dicts of float32 tensors, updated in place.
``cast`` is the nets' precision (``nets.FP32``, or ``nets.FP8`` for the
control).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from portbench.reference import nets
from portbench.reference.augment import cyclegan_augment, diff_augment, train_augment


@dataclasses.dataclass
class Adam:
    """optax's ``adam`` (eps 1e-8 outside the root), behind
    ``clip_by_global_norm(max_norm)`` when ``max_norm`` is set: the
    gradients are scaled by max_norm / norm where norm >= max_norm."""

    lr: float
    b1: float
    b2: float
    max_norm: float | None
    eps: float = 1e-8
    count: int = 0
    mu: dict = dataclasses.field(default_factory=dict)
    nu: dict = dataclasses.field(default_factory=dict)

    @torch.no_grad()
    def update(self, params: dict, grads: dict, lr: float | None = None) -> None:
        if self.max_norm is not None:
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            if norm >= self.max_norm:
                grads = {k: g / norm * self.max_norm for k, g in grads.items()}
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        lr = self.lr if lr is None else lr
        for k, p in params.items():
            g = grads[k]
            mu = self.mu.setdefault(k, torch.zeros_like(p))
            nu = self.nu.setdefault(k, torch.zeros_like(p))
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g.square(), alpha=1.0 - self.b2)
            p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))


def _grads(loss, params: dict) -> dict:
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}


def _leaves(params: dict) -> dict:
    return {k: v.detach().requires_grad_() for k, v in params.items()}


# --------------------------------------------------------------------------- #
# CUT

def patch_nce(src: list, tgt: list, ids: list, temperature: float) -> torch.Tensor:
    """PatchNCE: per tapped layer, the features at the drawn positions
    (one set for the batch), L2-normalised (eps 1e-6), logits tgt . src /
    T clamped to +-50, cross-entropy against the same position; the mean
    over samples and positions, then over layers."""
    total = 0.0
    for s, t, i in zip(src, tgt, ids):
        s = s.detach().flatten(2)[:, :, i].transpose(1, 2)
        t = t.flatten(2)[:, :, i].transpose(1, 2)
        s = s / s.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        t = t / t.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        logits = (t @ s.transpose(1, 2) / temperature).clamp(-50.0, 50.0)
        target = torch.arange(logits.shape[1], device=logits.device).expand(logits.shape[0], -1)
        loss = F.cross_entropy(logits.flatten(0, 1), target.flatten())
        total = total + torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))
    return total / len(src)


class CUT:
    """The CUT step on a config dict (the benchmark's ``configs/*.json``
    ``train`` block). ``state``: ``g``, ``d``, ``ema`` parameter dicts and
    the two ``Adam``s."""

    def __init__(self, cfg: dict, cast=nets.FP32):
        self.cfg, self.cast = cfg, cast
        g, d = cfg["model"]["generator"], cfg["model"]["discriminator"]
        self.g_kw = dict(n_blocks=g["n_blocks"], n_down=g["n_downsampling"])
        self.d_layers, self.d_norm = d["n_layers"], d["norm"]
        if d.get("num_scales", 1) != 1:
            raise ValueError("the reference takes one discriminator scale")
        self.size = cfg["image_size"]

    def new_state(self, g: dict, d: dict) -> dict:
        opt = lambda net: Adam(self.cfg["optim"][net]["lr"], *self.cfg["optim"][net]["betas"],  # noqa: E731
                               max_norm=self.cfg[f"grad_clip_{net.lower()}"] or None)
        g = {k: v.detach().clone() for k, v in g.items()}
        d = {k: v.detach().clone() for k, v in d.items()}
        return {"g": g, "d": d, "ema": {k: v.clone() for k, v in g.items()},
                "opt_g": opt("G"), "opt_d": opt("D")}

    def G(self, p, x, **kw):
        return nets.generator(p, x, cast=self.cast, **self.g_kw, **kw)

    def D(self, p, x):
        return nets.patchgan(p, x, self.d_layers, self.d_norm, "scale_0.", self.cast)

    def step(self, st: dict, photos_u8, monets_u8, draws: dict, step: int) -> dict:
        """One step; returns the losses as floats."""
        cfg = self.cfg
        lw = cfg["loss_weights"]
        warm = lw["identity_warm"] + (lw["identity_final"] - lw["identity_warm"]) * min(
            step / cfg["warmup_steps"], 1.0)
        every, gamma = cfg["r1"]["every"], cfg["r1"]["gamma"]
        taps = cfg["patchnce"]["nce_layers"]
        g, d = _leaves(st["g"]), _leaves(st["d"])

        photos = train_augment(photos_u8, self.size, draws["photo_aug"])
        monets = train_augment(monets_u8, self.size, draws["monet_aug"])
        real = monets if cfg["runtime"]["d_real_domain"] == "monet" else photos
        fake, src = self.G(g, photos, taps=taps)
        _, tgt = self.G(g, fake, taps=taps, taps_only=True)

        pr = self.D(d, diff_augment(real, draws["da_real"]))
        pf = self.D(d, diff_augment(fake.detach(), draws["da_fake"]))
        d_loss = 0.5 * (torch.relu(1.0 - pr).mean() + torch.relu(1.0 + pf).mean())
        st["opt_d"].update(st["d"], _grads(d_loss, d))

        r1 = torch.zeros(())
        if gamma > 0 and step % every == 0:
            d = _leaves(st["d"])
            x = real.detach().requires_grad_()
            (gx,) = torch.autograd.grad(self.D(d, x).sum(), x, create_graph=True)
            r1 = gx.square().sum(dim=(1, 2, 3)).mean()
            st["opt_d"].update(st["d"], _grads(r1 * (gamma * every), d))

        d = {k: v.detach() for k, v in st["d"].items()}
        g_adv = -self.D(d, diff_augment(fake, draws["da_g"])).mean()
        nce = patch_nce(src, tgt, draws["nce"], cfg["patchnce"]["temperature"])
        head = lw["adv"] * g_adv + lw["patchnce"] * nce
        grads = _grads(head, g)
        idt = torch.zeros(())
        if warm > 0:
            rec, _ = self.G(g, monets)
            idt = (rec - monets).abs().mean()
            grads = {k: v + warm * gi for (k, v), gi in zip(grads.items(), _grads(idt, g).values())}
        st["opt_g"].update(st["g"], grads)
        decay = cfg["ema"]["decay"]
        with torch.no_grad():
            for k, s in st["ema"].items():
                s.mul_(decay).add_(st["g"][k], alpha=1.0 - decay)
        return {k: float(v.detach()) for k, v in (
            ("d_loss", d_loss), ("g_loss", head + warm * idt), ("nce", nce), ("r1", r1),
            ("identity", idt))}


# --------------------------------------------------------------------------- #
# CycleGAN

def _gan(pred: torch.Tensor, real: bool, mode: str) -> torch.Tensor:
    target = torch.ones_like(pred) if real else torch.zeros_like(pred)
    if mode == "lsgan":
        return (pred - target).square().mean()
    return F.binary_cross_entropy_with_logits(pred, target)


class CycleGAN:
    """The CycleGAN step on a config dict. ``state``: ``G_A2B``, ``G_B2A``,
    ``D_A``, ``D_B`` parameter dicts and ``opt_g`` (both generators, keys
    ``G_A2B.<name>``), ``opt_da``, ``opt_db``. ``steps_per_epoch`` sets the
    epoch of the learning-rate decay."""

    def __init__(self, cfg: dict, steps_per_epoch: int, cast=nets.FP32):
        self.cfg, self.cast, self.spe = cfg, cast, steps_per_epoch
        self.n_blocks = cfg["model"]["n_blocks"]
        self.crop = cfg["data"]["img_size"]
        self.mode = cfg["loss"]["gan"]

    def new_state(self, nets_: dict) -> dict:
        o = self.cfg["optim"]
        adam = lambda lr: Adam(lr, *o["betas"], max_norm=None)  # noqa: E731
        st = {k: {n: v.detach().clone() for n, v in p.items()} for k, p in nets_.items()}
        st.update(opt_g=adam(o["lr_g"]), opt_da=adam(o["lr_d"]), opt_db=adam(o["lr_d"]))
        return st

    def lr(self, base: float, count: int) -> float:
        """Constant to ``lr_decay_after`` epochs, then linear to 0 at
        ``epochs``, the epoch read from the update count."""
        epochs, start = self.cfg["training"]["epochs"], self.cfg["optim"]["lr_decay_after"]
        epoch = count // self.spe
        if epoch < start:
            return base
        return base * min(max(1.0 - (epoch - start) / max(1, epochs - start), 0.0), 1.0)

    def G(self, p, x):
        return nets.generator(p, x, self.n_blocks, 2, cast=self.cast)[0]

    def D(self, p, x):
        return nets.patchgan(p, x, 3, "instance", cast=self.cast)

    def step(self, st: dict, a_u8, b_u8, draws: dict) -> dict:
        loss_cfg = self.cfg["loss"]
        lam_c, lam_i = loss_cfg["lambda_cycle"], loss_cfg["lambda_identity"]
        real_a = cyclegan_augment(a_u8, self.crop, draws["aug_a"])
        real_b = cyclegan_augment(b_u8, self.crop, draws["aug_b"])
        ga, gb = _leaves(st["G_A2B"]), _leaves(st["G_B2A"])
        da = {k: v.detach() for k, v in st["D_A"].items()}
        db = {k: v.detach() for k, v in st["D_B"].items()}
        fake_b, fake_a = self.G(ga, real_a), self.G(gb, real_b)
        rec_a, rec_b = self.G(gb, fake_b), self.G(ga, fake_a)
        idt_a, idt_b = self.G(gb, real_a), self.G(ga, real_b)
        adv = _gan(self.D(db, fake_b), True, self.mode) + _gan(self.D(da, fake_a), True, self.mode)
        cyc = lam_c * ((rec_a - real_a).abs().mean() + (rec_b - real_b).abs().mean())
        idt = lam_i * ((idt_a - real_a).abs().mean() + (idt_b - real_b).abs().mean())
        total = adv + cyc + idt
        joint = {f"G_A2B.{k}": v for k, v in ga.items()} | {f"G_B2A.{k}": v for k, v in gb.items()}
        params = {f"G_A2B.{k}": v for k, v in st["G_A2B"].items()}
        params |= {f"G_B2A.{k}": v for k, v in st["G_B2A"].items()}
        opt = st["opt_g"]
        opt.update(params, _grads(total, joint), self.lr(opt.lr, opt.count))

        out = {"G": float(total.detach())}
        for name, real, fake in (("D_A", real_a, fake_a), ("D_B", real_b, fake_b)):
            d = _leaves(st[name])
            pr, pf = self.D(d, real), self.D(d, fake.detach())
            loss = 0.5 * (_gan(pr, True, self.mode) + _gan(pf, False, self.mode))
            opt = st["opt_da" if name == "D_A" else "opt_db"]
            opt.update(st[name], _grads(loss, d), self.lr(opt.lr, opt.count))
            out[name] = float(loss.detach())
        return out


# --------------------------------------------------------------------------- #
# serving

@torch.no_grad()
def serve(g: dict, photos_u8: torch.Tensor, n_blocks: int = 9, n_down: int = 2,
          cast=nets.FP32) -> torch.Tensor:
    """uint8 NHWC photos at the served size -> uint8 NHWC images."""
    x = photos_u8.permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
    y, _ = nets.generator(g, x, n_blocks, n_down, cast=cast)
    return nets.to_uint8(y).permute(0, 2, 3, 1)
