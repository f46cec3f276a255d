"""CycleGAN training: the builders, the train state and the step.

Counterpart of ``gan_variant_research_tpu/train/cyclegan_trainer.py``
(``_build_generator``, ``CycleGANTrainState``, ``CycleGANTrainer``). The
step is the JAX ``_train_step`` (:246-315):

1. both uint8 domains through ``cyclegan_augment`` (crop, flip, [-1, 1]);
2. the joint generator loss in its batched form, three generator applies
   (``G_A2B(cat(A, B))``, ``G_B2A(cat(B, A, fake_B))``, ``G_A2B(fake_A)``)
   in place of the reference's six, exact because both generators are
   per-sample networks: LSGAN or BCE adversarial terms through D_B and D_A,
   lambda_cycle L1 cycles, lambda_identity L1 identities;
3. one Adam over the joint ``{G_A2B, G_B2A}`` parameters;
4. D_A on ``cat(A, fake_A.detach())`` and D_B on ``cat(B,
   fake_B.detach())``, each ``0.5 (real + fake)``, each with its own Adam.

No gradient clip; every Adam follows the epoch decay (``train/optim.py``),
its epoch read from its own update count. The generator is the ResNet
with bias-free convs but the output conv (``use_bias=False``; the trunk
kernel gets a zero bias), or the U-Net (``model.generator: unet``, which
runs no hand-written kernel). Modules are stateless templates driven by
``torch.func.functional_call``; the step updates the state's tensors in
place and returns the state. ``g_params`` holds both generators, keyed
``G_A2B.<name>`` and ``G_B2A.<name>``, so ``jax_tree_from_state_dict``
gives the JAX joint tree.

``checkpoint_payload`` / ``state_from_payload`` write and read the JAX
trainer's payload (``G_A2B``, ``G_B2A``, ``D_A``, ``D_B``, ``da_spectral``
/ ``db_spectral`` ``{}``, ``optim_G`` / ``optim_D_A`` / ``optim_D_B`` in
optax's ``adam(schedule)`` layout, ``base_key``); the port's RNG state rides
under ``torch_rng``, which the JAX restore does not read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import functional_call

from gan_variant_research_tpu_torch.convert import (
    cyclegan_generator_state_dict_from_jax,
    cyclegan_state_from_jax,
    jax_tree_from_state_dict,
    patchgan_state_dict_from_jax,
)
from gan_variant_research_tpu_torch.core import trace
from gan_variant_research_tpu_torch.core.precision import Policy, policy_from_config
from gan_variant_research_tpu_torch.core.prng import CycleGANDraws, jax_base_key, sample_cyclegan
from gan_variant_research_tpu_torch.data.augment import cyclegan_augment
from gan_variant_research_tpu_torch.losses.adversarial import gan_loss
from gan_variant_research_tpu_torch.losses.reconstruction import cycle_loss, identity_loss
from gan_variant_research_tpu_torch.models.discriminator_patchgan import PatchGANDiscriminator
from gan_variant_research_tpu_torch.models.generator_resnet import ResNetGenerator
from gan_variant_research_tpu_torch.models.generator_unet import UNetGenerator
from gan_variant_research_tpu_torch.train.cut_trainer import param_leaves
from gan_variant_research_tpu_torch.train.optim import AdamState, Optimizer

LOSS_KEYS = ("G", "D_A", "D_B", "adv", "cycle", "idt")
GENERATORS = ("G_A2B", "G_B2A")

_VARIANT_ITEM = "ROADMAP.md Queue 1, 'Variant losses and D options'"


def build_cyclegan_generator(model_cfg: dict, policy: Policy,
                             generator: torch.Generator | None = None):
    """``model`` config -> the bias-free ``ResNetGenerator`` or, with
    ``generator: unet``, the ``UNetGenerator``, in the policy's compute
    dtype. ``use_s2d`` and ``pad_free`` are TPU levers, ignored. ``generator``
    seeds the parameter init."""
    kind = model_cfg.get("generator", "resnet")
    if kind == "unet":
        return UNetGenerator(ngf=model_cfg.get("ngf", 64), dtype=policy.compute_dtype,
                             generator=generator)
    if kind != "resnet":
        raise ValueError(f"model.generator must be resnet|unet, got {kind!r}")
    return ResNetGenerator(ngf=model_cfg.get("ngf", 64), n_blocks=model_cfg.get("n_blocks", 9),
                           use_bias=False, dtype=policy.compute_dtype, generator=generator)


@dataclasses.dataclass
class CycleGANTrainState:
    """``g_params``: both generators' float32 leaves, ``G_A2B.<name>`` and
    ``G_B2A.<name>``; ``da_params`` / ``db_params`` the discriminators';
    ``rng`` the generator of the step's draws, on the parameters' device;
    ``base_key`` the JAX run key's data (uint32 (2,)), carried for the
    checkpoint."""

    step: int
    g_params: dict[str, torch.Tensor]
    da_params: dict[str, torch.Tensor]
    db_params: dict[str, torch.Tensor]
    opt_g: AdamState
    opt_da: AdamState
    opt_db: AdamState
    rng: torch.Generator
    base_key: np.ndarray


class CycleGANTrainer:
    """Owns the module templates, the three optimizers and the step.
    ``steps_per_epoch`` sets the epoch of the learning-rate decay (the loop
    passes ``max(|A|, |B|) // batch``)."""

    def __init__(self, config: dict, steps_per_epoch: int | None = None):
        self.config = config
        self.policy = policy_from_config(config)
        model_cfg = config["model"]
        kind = model_cfg.get("generator", "resnet")
        if kind == "resnet" and model_cfg.get("n_blocks", 9) not in (6, 9):
            raise ValueError("CycleGAN baseline uses 6 or 9 res blocks")
        if model_cfg.get("spectral_norm_d", False):
            raise NotImplementedError(f"model.spectral_norm_d is not ported yet ({_VARIANT_ITEM})")
        self.generator = build_cyclegan_generator(model_cfg, self.policy)
        self.discriminator = self._build_discriminator()

        opt_cfg, t_cfg = config["optim"], config["training"]
        self.steps_per_epoch = steps_per_epoch or 1
        epochs = int(t_cfg["epochs"])
        decay = (self.steps_per_epoch, int(opt_cfg.get("lr_decay_after", epochs)), epochs)
        b1, b2 = (float(b) for b in opt_cfg.get("betas", [0.5, 0.999]))
        adam = lambda lr: Optimizer(lr=float(lr), b1=b1, b2=b2, max_norm=None,  # noqa: E731
                                    epoch_decay=decay)
        self.opt_g, self.opt_da, self.opt_db = (adam(opt_cfg["lr_g"]), adam(opt_cfg["lr_d"]),
                                                adam(opt_cfg["lr_d"]))

        loss_cfg = config.get("loss") or {}
        self.gan_mode = loss_cfg.get("gan", "lsgan")
        if self.gan_mode not in ("lsgan", "bce"):
            raise ValueError(f"loss.gan must be lsgan|bce, got {self.gan_mode}")
        self.lambda_cycle = float(loss_cfg.get("lambda_cycle", 10.0))
        self.lambda_identity = float(loss_cfg.get("lambda_identity", 0.5))
        self.crop = int(config["data"].get("img_size", 256))

    def _build_discriminator(self, generator: torch.Generator | None = None):
        model_cfg = self.config["model"]
        return PatchGANDiscriminator(ndf=model_cfg.get("ndf", 64),
                                     n_layers=model_cfg.get("n_layers", 3), norm="instance",
                                     dtype=self.policy.compute_dtype, generator=generator)

    # ------------------------------------------------------------------ #

    def init_state(self, seed: int | None = None,
                   device: torch.device | str = "cuda") -> CycleGANTrainState:
        """Fresh parameters (each module's own init, seeded: glorot for the
        U-Net, PyTorch's default otherwise), zero Adam moments, on
        ``device`` (the card unless the caller asks for the CPU)."""
        seed = int(seed if seed is not None else self.config["training"].get("seed", 0))
        gen = torch.Generator().manual_seed(seed)
        nets = {name: build_cyclegan_generator(self.config["model"], self.policy, gen)
                .state_dict() for name in GENERATORS}
        nets.update({name: self._build_discriminator(gen).state_dict() for name in ("D_A", "D_B")})
        return self.state_from_state_dicts(nets, seed, device)

    def state_from_jax(self, trees: dict, seed: int | None = None,
                       device: torch.device | str = "cuda") -> CycleGANTrainState:
        """A fresh state on the JAX nets ``trees`` (``G_A2B``, ``G_B2A``,
        ``D_A``, ``D_B``: nested dicts of arrays), on ``device`` (the card
        unless the caller asks for the CPU)."""
        seed = int(seed if seed is not None else self.config["training"].get("seed", 0))
        kind = self.config["model"].get("generator", "resnet")
        return self.state_from_state_dicts(cyclegan_state_from_jax(trees, kind), seed, device)

    def state_from_state_dicts(self, nets: dict, seed: int,
                               device: torch.device | str) -> CycleGANTrainState:
        g_params = {}
        for name in GENERATORS:
            g_params.update(param_leaves(self.generator, nets[name], device, f"{name}."))
        da = param_leaves(self.discriminator, nets["D_A"], device)
        db = param_leaves(self.discriminator, nets["D_B"], device)
        return CycleGANTrainState(
            step=0, g_params=g_params, da_params=da, db_params=db,
            opt_g=self.opt_g.init(g_params), opt_da=self.opt_da.init(da),
            opt_db=self.opt_db.init(db),
            rng=torch.Generator(device=device).manual_seed(seed),
            base_key=jax_base_key(seed, splits=5))

    # ------------------------------------------------------------------ #

    def checkpoint_payload(self, state: CycleGANTrainState) -> dict:
        """The JAX trainer's payload in the JAX layout, and ``torch_rng``,
        the step sampler's state. Leaves are tensors on the state's device
        and may alias the state: the writers copy them to the host."""
        tree = jax_tree_from_state_dict
        g = tree(state.g_params)
        return {
            "G_A2B": g["G_A2B"],
            "G_B2A": g["G_B2A"],
            "D_A": tree(state.da_params),
            "D_B": tree(state.db_params),
            "da_spectral": {},
            "db_spectral": {},
            "optim_G": self.opt_g.state_dict(state.opt_g, tree),
            "optim_D_A": self.opt_da.state_dict(state.opt_da, tree),
            "optim_D_B": self.opt_db.state_dict(state.opt_db, tree),
            "base_key": np.asarray(state.base_key, dtype=np.uint32),
            "torch_rng": state.rng.get_state(),
        }

    def state_from_payload(self, payload: dict, step: int,
                           device: torch.device | str = "cuda") -> CycleGANTrainState:
        """A train state from a checkpoint payload of either package (numpy
        leaves, as ``load_checkpoint`` gives them), on ``device`` (the card
        unless the caller asks for the CPU). Each Adam's count, and so the
        learning rate's epoch, comes from the payload. Without
        ``torch_rng`` (a JAX checkpoint) the step sampler starts from the
        config's seed."""
        if payload.get("da_spectral") or payload.get("db_spectral"):
            raise NotImplementedError(f"a checkpoint with spectral-norm state ({_VARIANT_ITEM})")
        seed = int(self.config["training"].get("seed", 0))
        kind = self.config["model"].get("generator", "resnet")
        state = self.state_from_jax(payload, seed, device)

        # JAX trees of Adam moments -> the port's dicts of tensors
        def g_leaves(tree):
            return {f"{name}.{k}": v.to(device) for name in GENERATORS
                    for k, v in cyclegan_generator_state_dict_from_jax(tree[name], kind).items()}

        def d_leaves(tree):
            return {k: v.to(device) for k, v in patchgan_state_dict_from_jax(tree).items()}

        state.step = int(step)
        state.opt_g = self.opt_g.load_state_dict(payload["optim_G"], g_leaves)
        state.opt_da = self.opt_da.load_state_dict(payload["optim_D_A"], d_leaves)
        state.opt_db = self.opt_db.load_state_dict(payload["optim_D_B"], d_leaves)
        state.base_key = np.array(payload["base_key"], dtype=np.uint32)
        if "torch_rng" in payload:
            state.rng.set_state(torch.from_numpy(np.array(payload["torch_rng"], np.uint8)))
        return state

    # ------------------------------------------------------------------ #

    def sample_draws(self, rng: torch.Generator, shape) -> CycleGANDraws:
        """One step's draws for uint8 batches of ``shape`` (B, H, W, C)."""
        b, h, w = shape[:3]
        return sample_cyclegan(rng, b, h, w, self.crop)

    def _g(self, g_params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        prefix = f"{name}."
        params = {k[len(prefix):]: v for k, v in g_params.items() if k.startswith(prefix)}
        return functional_call(self.generator, params, (x,))

    def _d(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.discriminator, params, (x,))

    def g_loss(self, g_params: dict, da_params: dict, db_params: dict,
               real_A: torch.Tensor, real_B: torch.Tensor):
        """The joint generator loss in its batched form (three applies).
        Returns (total, (fake_A, fake_B, adv, cycle, idt))."""
        nb = real_A.shape[0]
        out_ab = self._g(g_params, "G_A2B", torch.cat([real_A, real_B]))
        fake_B, idt_B = out_ab[:nb], out_ab[nb:]
        out_ba = self._g(g_params, "G_B2A", torch.cat([real_B, real_A, fake_B.to(real_B.dtype)]))
        fake_A, idt_A, rec_A = out_ba[:nb], out_ba[nb:2 * nb], out_ba[2 * nb:]
        rec_B = self._g(g_params, "G_A2B", fake_A)

        adv = (gan_loss(self._d(db_params, fake_B), True, self.gan_mode)
               + gan_loss(self._d(da_params, fake_A), True, self.gan_mode))
        cyc = (cycle_loss(rec_A, real_A, self.lambda_cycle)
               + cycle_loss(rec_B, real_B, self.lambda_cycle))
        idt = self.lambda_identity * (identity_loss(idt_A, real_A) + identity_loss(idt_B, real_B))
        return adv + cyc + idt, (fake_A, fake_B, adv, cyc, idt)

    def _d_step(self, opt: Optimizer, params: dict, opt_state: AdamState,
                real: torch.Tensor, fake: torch.Tensor):
        nb = real.shape[0]
        preds = self._d(params, torch.cat([real.float(), fake.float()]))
        loss = 0.5 * (gan_loss(preds[:nb], True, self.gan_mode)
                      + gan_loss(preds[nb:], False, self.gan_mode))
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), opt.step(params, dict(zip(params, grads)), opt_state)

    def train_step(self, state: CycleGANTrainState, a_u8: torch.Tensor, b_u8: torch.Tensor,
                   draws: CycleGANDraws | None = None):
        """One step on uint8 NHWC batches at the load size, on the state's
        device; ``draws=None`` samples them from ``state.rng``. Returns
        (state, losses) with the losses as float32 0-d tensors under
        ``LOSS_KEYS``; the state is updated in place. Its phases are the
        spans ``cyclegan.<phase>`` under ``cyclegan.step``
        (``core/trace.py``)."""
        with trace.span("cyclegan.step", step=state.step):
            if draws is None:
                with trace.span("cyclegan.draws"):
                    draws = self.sample_draws(state.rng, a_u8.shape)
            with trace.span("cyclegan.augment"):
                real_A = cyclegan_augment(a_u8, self.crop, draws.aug_a)
                real_B = cyclegan_augment(b_u8, self.crop, draws.aug_b)

            g_params = state.g_params
            with trace.span("cyclegan.g_loss"):
                total, (fake_A, fake_B, adv, cyc, idt) = self.g_loss(
                    g_params, state.da_params, state.db_params, real_A, real_B)
            with trace.span("cyclegan.g_backward"):
                g_grads = torch.autograd.grad(total, list(g_params.values()))
                opt_g = self.opt_g.step(g_params, dict(zip(g_params, g_grads)), state.opt_g)

            with trace.span("cyclegan.d_a"):
                loss_da, opt_da = self._d_step(self.opt_da, state.da_params, state.opt_da,
                                               real_A, fake_A.detach())
            with trace.span("cyclegan.d_b"):
                loss_db, opt_db = self._d_step(self.opt_db, state.db_params, state.opt_db,
                                               real_B, fake_B.detach())

            state.step += 1
            state.opt_g, state.opt_da, state.opt_db = opt_g, opt_da, opt_db
            losses = {"G": total.detach(), "D_A": loss_da, "D_B": loss_db, "adv": adv.detach(),
                      "cycle": cyc.detach(), "idt": idt.detach()}
        return state, losses
