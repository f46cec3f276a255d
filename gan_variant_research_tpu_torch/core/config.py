"""The keys of a CUT config that the port's train step reads.

The JAX package reads its YAML configs (``gan_variant_research_tpu/
configs/*.yaml``) as nested dicts; so does the port, which takes the dict
and never parses YAML (the machine with the card has no PyYAML).
``STEP_KEYS`` lists, as dotted paths, every key ``train/cut_trainer.py``
reads; ``get`` reads one with its default.
"""

from __future__ import annotations

from typing import Any

STEP_KEYS = (
    "image_size", "batch_size", "seed", "warmup_steps", "max_steps",
    "grad_clip_g", "grad_clip_d",
    *(f"optim.{net}.{k}" for net in ("G", "D")
      for k in ("lr", "betas", "weight_decay", "scheduler.enabled",
                "scheduler.type", "scheduler.lr_min")),
    *(f"loss_weights.{k}" for k in ("adv", "patchnce", "identity_warm",
                                    "identity_final", "featmatch", "palette",
                                    "repulsion")),
    *(f"model.generator.{k}" for k in ("ngf", "n_blocks", "n_downsampling",
                                       "padding_type", "norm", "activation",
                                       "use_attention", "attn_layers", "attn_flash",
                                       "use_channel_attn", "channel_attn_layers",
                                       "use_style_dropout", "style_dropout.alpha_min",
                                       "style_dropout.alpha_max")),
    *(f"model.discriminator.{k}" for k in ("ndf", "n_layers", "num_scales",
                                           "norm", "use_spectral_norm")),
    "patchnce.num_patches", "patchnce.temperature", "patchnce.nce_layers",
    "diffaugment.enable", "diffaugment.policy",
    "r1.gamma", "r1.every", "ema.decay",
    "runtime.precision", "runtime.identity_fp32", "runtime.d_real_domain",
)

_MISSING = object()


def get(config: dict, path: str, default: Any = None) -> Any:
    """``config`` at the dotted ``path``; ``default`` where a key is absent
    or its section is null."""
    node: Any = config
    for key in path.split("."):
        if not isinstance(node, dict):
            return default
        node = node.get(key, _MISSING)
        if node is _MISSING or node is None:
            return default
    return node
