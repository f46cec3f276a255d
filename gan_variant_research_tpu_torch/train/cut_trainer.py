"""CUT training: builders, the train state and the train step.

Counterpart of ``gan_variant_research_tpu/train/cut_trainer.py``
(``build_generator``, ``build_discriminator``, ``CUTTrainState``,
``CUTTrainer``). The step follows the JAX ``_train_step`` in order:

1. augment both uint8 domains (``data/augment.py``);
2. one generator forward on the photos with the PatchNCE taps, and a
   taps-only forward on the (non-detached) fake;
3. the D hinge step on DiffAug(real) and DiffAug(detached fake); reals are
   Monets unless ``runtime.d_real_domain: photo``;
4. on R1 steps (``r1.every``), a second D step: the float32 D on the same
   parameters, ``torch.autograd.grad(create_graph=True)`` to the images,
   penalty scaled by gamma * every;
5. the G head (hinge on DiffAug(fake) against the updated D, plus PatchNCE
   with detached src features), differentiated into G's parameters only;
6. during the identity warmup, the L1 identity pass (bf16 unless
   ``runtime.identity_fp32``), weighted into G's gradient;
7. Adam behind the global-norm clip for G, then the EMA.

With style dropout the three generator passes take the step's three
draws of gate alphas (``StepDraws.style_fwd``, ``style_nce``,
``style_idt``), as the JAX step hands them three keys.

Modules are stateless templates, as flax modules are: the state holds the
parameters as dicts of tensors and the step calls the modules through
``torch.func.functional_call``. The step updates the state's tensors in
place and returns the state. On CUDA every reflect trunk conv, forward and
backward, runs on the hand-written kernels, whatever the config's
``use_pallas`` says.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from gan_variant_research_tpu_torch.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from gan_variant_research_tpu_torch.core import config as cfg_mod
from gan_variant_research_tpu_torch.core.precision import FP32_POLICY, Policy, policy_from_config
from gan_variant_research_tpu_torch.core.prng import StepDraws, sample_step
from gan_variant_research_tpu_torch.data.augment import train_augment
from gan_variant_research_tpu_torch.losses.adversarial import (
    discriminator_hinge_loss,
    generator_hinge_loss,
)
from gan_variant_research_tpu_torch.losses.patchnce import patch_nce_loss
from gan_variant_research_tpu_torch.losses.reconstruction import identity_loss
from gan_variant_research_tpu_torch.models.discriminator_patchgan import MultiscaleDiscriminator
from gan_variant_research_tpu_torch.models.generator_resnet import ResNetGenerator
from gan_variant_research_tpu_torch.ops.diffaugment import diff_augment
from gan_variant_research_tpu_torch.train.ema import ema_init, ema_update
from gan_variant_research_tpu_torch.train.optim import AdamState, optimizer_from_config

LOSS_KEYS = ("d_loss", "g_loss", "g_adv", "nce", "identity", "r1",
             "identity_weight", "featmatch", "palette", "repulsion")

_VARIANT_ITEM = "ROADMAP.md Queue 1 item 7, 'Variant losses and D options'"


def build_generator(gen_cfg: dict, policy: Policy,
                    generator: torch.Generator | None = None) -> ResNetGenerator:
    """``model.generator`` config -> ``ResNetGenerator`` in the policy's
    compute dtype. The TPU-only fields (``use_pallas``, ``pad_free``,
    ``remat``, ``use_s2d``) are read by the JAX package only and ignored
    here: on CUDA the trunk always runs the hand-written kernel, and
    ``attn_flash`` is validated and otherwise ignored (the attention core is
    the hand-written kernel on CUDA, the plain version on the CPU).
    ``generator`` seeds the parameter init."""
    sd = gen_cfg.get("style_dropout") or {}
    return ResNetGenerator(
        output_nc=3,
        ngf=gen_cfg.get("ngf", 64),
        n_blocks=gen_cfg.get("n_blocks", 9),
        n_downsampling=gen_cfg.get("n_downsampling", 2),
        padding_type=gen_cfg.get("padding_type", "reflect"),
        norm=gen_cfg.get("norm", "instance"),
        activation=gen_cfg.get("activation", "relu"),
        use_attention=gen_cfg.get("use_attention", False),
        attn_layers=tuple(gen_cfg.get("attn_layers", (3, 7))),
        attn_flash=gen_cfg.get("attn_flash", "auto"),
        use_channel_attn=gen_cfg.get("use_channel_attn", False),
        channel_attn_layers=tuple(gen_cfg.get("channel_attn_layers", (5,))),
        use_style_dropout=gen_cfg.get("use_style_dropout", False),
        alpha_min=sd.get("alpha_min", 0.4),
        alpha_max=sd.get("alpha_max", 0.9),
        dtype=policy.compute_dtype,
        generator=generator,
    )


def build_discriminator(disc_cfg: dict, policy: Policy,
                        generator: torch.Generator | None = None) -> MultiscaleDiscriminator:
    """``model.discriminator`` config -> ``MultiscaleDiscriminator``."""
    return MultiscaleDiscriminator(
        ndf=disc_cfg.get("ndf", 64),
        n_layers=disc_cfg.get("n_layers", 3),
        num_scales=disc_cfg.get("num_scales", 1),
        norm=disc_cfg.get("norm", "none"),
        use_spectral_norm=disc_cfg.get("use_spectral_norm", False),
        dtype=policy.compute_dtype,
        generator=generator,
    )


@dataclasses.dataclass
class CUTTrainState:
    """``g_params`` / ``d_params``: float32 leaf tensors keyed by the
    modules' ``state_dict`` names; ``ema`` the G shadow; ``rng`` the
    generator of the step's draws, on the parameters' device."""

    step: int
    g_params: dict[str, torch.Tensor]
    d_params: dict[str, torch.Tensor]
    opt_g: AdamState
    opt_d: AdamState
    ema: dict[str, torch.Tensor]
    rng: torch.Generator


class CUTTrainer:
    """Owns the module templates, the optimizers and the step."""

    def __init__(self, config: dict):
        get = lambda path, default=None: cfg_mod.get(config, path, default)
        self.config = config
        self.policy = policy_from_config(config)
        gen_cfg = get("model.generator", {})
        disc_cfg = get("model.discriminator", {})
        self.generator = build_generator(gen_cfg, self.policy)
        self.discriminator = build_discriminator(disc_cfg, self.policy)
        # float32 twins on the same parameters: the R1 and identity islands
        self.generator_f32 = build_generator(gen_cfg, FP32_POLICY)
        self.discriminator_f32 = build_discriminator(disc_cfg, FP32_POLICY)
        max_steps = get("max_steps")
        self.opt_g = optimizer_from_config(get("optim.G", {}), get("grad_clip_g", 10.0), max_steps)
        self.opt_d = optimizer_from_config(get("optim.D", {}), get("grad_clip_d", 10.0), max_steps)

        self.image_size = int(get("image_size", 256))
        self.adv_w = float(get("loss_weights.adv", 1.0))
        self.nce_w = float(get("loss_weights.patchnce", 1.0))
        variants = {"featmatch": get("loss_weights.featmatch", 0.0),
                    "palette": get("loss_weights.palette", 0.0)
                    if get("palette.enabled", True) else 0.0,
                    "repulsion": get("loss_weights.repulsion", 0.0)
                    if get("repulsion.enabled", True) else 0.0}
        for name, weight in variants.items():
            if float(weight) > 0:
                raise NotImplementedError(f"loss_weights.{name} > 0 is not ported yet "
                                          f"({_VARIANT_ITEM})")
        self.nce_layers = tuple(get("patchnce.nce_layers", (0, 4, 8, 12, 16)))
        self.temperature = float(get("patchnce.temperature", 0.07))
        self.num_patches = int(get("patchnce.num_patches", 256))
        self.r1_gamma = float(get("r1.gamma", 0.0))
        self.r1_every = int(get("r1.every", 16))
        self.da_policy = (tuple(get("diffaugment.policy", ()))
                          if get("diffaugment.enable", False) else None)
        self.ema_decay = float(get("ema.decay", 0.999))
        self.identity_fp32 = bool(get("runtime.identity_fp32", False))
        self.d_real_domain = get("runtime.d_real_domain", "monet")
        if self.d_real_domain not in ("photo", "monet"):
            raise ValueError(f"runtime.d_real_domain must be photo|monet, got {self.d_real_domain}")

    # ------------------------------------------------------------------ #

    def init_state(self, seed: int | None = None,
                   device: torch.device | str = "cuda") -> CUTTrainState:
        """Fresh parameters (PyTorch's default init, seeded), zero Adam
        moments, the EMA shadow as a copy, on ``device`` (the card unless
        the caller asks for the CPU)."""
        seed = int(seed if seed is not None else self.config.get("seed", 42))
        gen = torch.Generator().manual_seed(seed)
        g = build_generator(self.config["model"]["generator"], self.policy, gen)
        d = build_discriminator(self.config["model"]["discriminator"], self.policy, gen)
        return self.state_from_state_dicts(g.state_dict(), d.state_dict(), seed, device)

    def state_from_jax(self, g_params: dict, d_params: dict, seed: int | None = None,
                       device: torch.device | str = "cuda") -> CUTTrainState:
        """A fresh state on JAX param trees (nested dicts of arrays),
        converted by ``convert.py``, on ``device`` (the card unless the
        caller asks for the CPU)."""
        seed = int(seed if seed is not None else self.config.get("seed", 42))
        return self.state_from_state_dicts(generator_state_dict_from_jax(g_params),
                                           discriminator_state_dict_from_jax(d_params),
                                           seed, device)

    def state_from_state_dicts(self, g_sd: dict, d_sd: dict, seed: int,
                               device: torch.device | str) -> CUTTrainState:
        def leaves(module, sd):
            names = set(module.state_dict())
            if set(sd) != names:
                raise ValueError(f"state dict keys differ from the module's: missing "
                                 f"{sorted(names - set(sd))}, unexpected {sorted(set(sd) - names)}")
            return {k: v.detach().to(device=device, dtype=torch.float32).clone()
                    .requires_grad_() for k, v in sd.items()}

        g_params = leaves(self.generator, g_sd)
        d_params = leaves(self.discriminator, d_sd)
        return CUTTrainState(
            step=0, g_params=g_params, d_params=d_params,
            opt_g=self.opt_g.init(g_params), opt_d=self.opt_d.init(d_params),
            ema=ema_init(g_params),
            rng=torch.Generator(device=device).manual_seed(seed))

    # ------------------------------------------------------------------ #

    def identity_weight_at(self, step: int) -> float:
        """Identity warmup weight: identity_warm -> identity_final, linear
        over ``warmup_steps``."""
        get = lambda path, default: cfg_mod.get(self.config, path, default)
        warm = float(get("loss_weights.identity_warm", 0.1))
        final = float(get("loss_weights.identity_final", 0.0))
        warmup = int(get("warmup_steps", 20000))
        frac = min(step / warmup, 1.0) if warmup > 0 else 1.0
        return warm + (final - warm) * frac

    def step_flags(self, step: int) -> tuple[bool, bool]:
        """(do_r1, do_identity) for a step index, decided on the host."""
        do_r1 = self.r1_gamma > 0 and step % self.r1_every == 0
        return do_r1, self.identity_weight_at(step) > 0

    def nce_tap_hw(self) -> list[int]:
        """H*W of each tapped layer that exists, in layer order."""
        n_down = self.generator.n_down
        sizes = ([self.image_size]
                 + [self.image_size >> i for i in range(1, n_down + 1)]
                 + [self.image_size >> n_down] * self.generator.n_blocks
                 + [self.image_size >> (n_down - 1 - i) for i in range(n_down)])
        return [sizes[i] ** 2 for i in sorted(set(self.nce_layers)) if 0 <= i < len(sizes)]

    def sample_draws(self, rng: torch.Generator, batch: int) -> StepDraws:
        g = self.generator
        return sample_step(rng, batch, self.image_size, self.da_policy,
                           real_dtype=torch.float32, fake_dtype=self.policy.compute_dtype,
                           tap_hw=self.nce_tap_hw() if self.nce_w > 0 else [],
                           num_patches=self.num_patches,
                           style=(g.n_blocks, *g.alpha_range) if g.use_style_dropout else None)

    # ------------------------------------------------------------------ #

    def _d(self, params, x, fp32: bool = False):
        model = self.discriminator_f32 if fp32 else self.discriminator
        return functional_call(model, params, (x,))

    def _aug(self, x, draws):
        return x if self.da_policy is None else diff_augment(x, self.da_policy, draws)

    def train_step(self, state: CUTTrainState, photos_u8: torch.Tensor,
                   monets_u8: torch.Tensor, step: int | None = None,
                   draws: StepDraws | None = None):
        """One training step on uint8 NHWC batches on the state's device.
        ``step`` defaults to ``state.step``; ``draws=None`` samples them from
        ``state.rng``. Returns (state, losses) with the losses as float32
        0-d tensors under ``LOSS_KEYS``; the state is updated in place."""
        step = state.step if step is None else int(step)
        do_r1, do_identity = self.step_flags(step)
        batch = photos_u8.shape[0]
        if draws is None:
            draws = self.sample_draws(state.rng, batch)
        g_params, d_params = state.g_params, state.d_params
        zero = torch.zeros((), dtype=torch.float32, device=photos_u8.device)

        photos = train_augment(photos_u8, self.image_size, draws.photo_aug)
        monets = train_augment(monets_u8, self.image_size, draws.monet_aug)
        identity_weight = self.identity_weight_at(step)
        real = photos if self.d_real_domain == "photo" else monets

        # one G forward serves the D step, the adversarial head and both
        # sides of PatchNCE
        if self.nce_w > 0:
            fake, src_feats = functional_call(
                self.generator, g_params, (photos,),
                {"extract": self.nce_layers, "style_alpha": draws.style_fwd})
            _, tgt_feats = functional_call(
                self.generator, g_params, (fake,),
                {"extract": self.nce_layers, "taps_only": True, "style_alpha": draws.style_nce})
        else:
            fake = functional_call(self.generator, g_params, (photos,),
                                   {"style_alpha": draws.style_fwd})
            src_feats = tgt_feats = []

        # ---------------- D step ----------------
        real_aug = self._aug(real, draws.da_real)
        fake_aug = self._aug(fake.detach(), draws.da_fake)
        preds = self._d(d_params, torch.cat([real_aug.float(), fake_aug.float()]))
        d_loss = discriminator_hinge_loss([p[:batch] for p in preds],
                                          [p[batch:] for p in preds])
        d_grads = torch.autograd.grad(d_loss, list(d_params.values()))
        opt_d = self.opt_d.step(d_params, dict(zip(d_params, d_grads)), state.opt_d)

        # ---------------- lazy R1: a second D step ----------------
        if do_r1:
            real32 = real.detach().float().requires_grad_()
            d_sum = sum(p.float().sum() for p in self._d(d_params, real32, fp32=True))
            (g_img,) = torch.autograd.grad(d_sum, real32, create_graph=True)
            r1 = g_img.square().sum(dim=(1, 2, 3)).mean()
            # conv_out's bias does not reach the image gradient: its grad is 0
            r1_grads = torch.autograd.grad(r1 * (self.r1_gamma * self.r1_every),
                                           list(d_params.values()), materialize_grads=True)
            opt_d = self.opt_d.step(d_params, dict(zip(d_params, r1_grads)), opt_d)
            r1 = r1.detach()
        else:
            r1 = zero

        # ---------------- G head, against the updated D ----------------
        g_adv = generator_hinge_loss(self._d(d_params, self._aug(fake, draws.da_g)))
        nce = (patch_nce_loss(src_feats, tgt_feats, draws.nce, self.temperature)
               if self.nce_w > 0 else zero)
        head = self.adv_w * g_adv + self.nce_w * nce
        # into G's parameters only: nothing lands in D's gradients
        g_grads = list(torch.autograd.grad(head, list(g_params.values())))

        if do_identity:
            idt_gen = self.generator_f32 if self.identity_fp32 else self.generator
            rec = functional_call(idt_gen, g_params, (monets.to(idt_gen.dtype),),
                                  {"style_alpha": draws.style_idt})
            idt = identity_loss(rec, monets)
            idt_grads = torch.autograd.grad(idt, list(g_params.values()))
            g_grads = [g + identity_weight * ig for g, ig in zip(g_grads, idt_grads)]
            idt = idt.detach()
        else:
            idt = zero

        opt_g = self.opt_g.step(g_params, dict(zip(g_params, g_grads)), state.opt_g)
        ema_update(state.ema, g_params, self.ema_decay)

        state.step, state.opt_g, state.opt_d = step + 1, opt_g, opt_d
        losses = {
            "d_loss": d_loss.detach(),
            "g_loss": (head + identity_weight * idt).detach(),
            "g_adv": g_adv.detach(),
            "nce": nce.detach(),
            "identity": idt,
            "r1": r1,
            "identity_weight": torch.full_like(zero, identity_weight),
            "featmatch": zero,
            "palette": zero,
            "repulsion": zero,
        }
        return state, losses
