"""CUT trainer pieces ported so far: `build_generator`.

Counterpart of ``gan_variant_research_tpu/train/cut_trainer.py::
build_generator``. The train step comes with a later port slice.
"""

from __future__ import annotations

import torch

from gan_variant_research_tpu_torch.core.precision import Policy
from gan_variant_research_tpu_torch.models.generator_resnet import ResNetGenerator


def build_generator(gen_cfg: dict, policy: Policy,
                    generator: torch.Generator | None = None) -> ResNetGenerator:
    """``model.generator`` config -> ``ResNetGenerator`` in the policy's
    compute dtype. The TPU-only fields (``use_pallas``, ``pad_free``,
    ``remat``, ``use_s2d``, ``attn_flash``) are read by the JAX package only
    and ignored here: on CUDA the trunk always runs the hand-written kernel.
    ``generator`` seeds the parameter init."""
    return ResNetGenerator(
        output_nc=3,
        ngf=gen_cfg.get("ngf", 64),
        n_blocks=gen_cfg.get("n_blocks", 9),
        n_downsampling=gen_cfg.get("n_downsampling", 2),
        padding_type=gen_cfg.get("padding_type", "reflect"),
        norm=gen_cfg.get("norm", "instance"),
        activation=gen_cfg.get("activation", "relu"),
        use_attention=gen_cfg.get("use_attention", False),
        use_channel_attn=gen_cfg.get("use_channel_attn", False),
        use_style_dropout=gen_cfg.get("use_style_dropout", False),
        dtype=policy.compute_dtype,
        generator=generator,
    )
