"""The JAX package's random draws, made under its own key splits, handed
to the PyTorch port's functions (which take their draws as tensors).

Each helper mirrors the ``jax.random`` calls of one JAX function:
``train_augment`` (data/augment.py), ``diff_augment`` (ops/diffaugment.py),
``patch_nce_loss`` (losses/patchnce.py), and the whole CUT step
(train/cut_trainer.py::_train_step, keys from ``step_keys``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gan_variant_research_tpu.core.prng import step_keys
from gan_variant_research_tpu_torch.core.prng import StepDraws
from gan_variant_research_tpu_torch.data.augment import AugmentDraws
from gan_variant_research_tpu_torch.ops.diffaugment import DiffAugmentDraws, policy_ops

STEP_KEY_NAMES = ("photo_aug", "monet_aug", "da_real", "da_fake", "da_g", "nce")
STYLE_KEY_NAMES = ("style_fwd", "style_nce", "style_idt")


def _t(a, dtype=None):
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    t = torch.from_numpy(a.copy()).reshape(-1)
    return t.to(dtype) if dtype is not None else t


def augment_draws(key, b, scale_range=(0.85, 1.0), jitter=(0.05, 0.05, 0.05, 0.02)):
    """``train_augment``: crop (scales, then two offsets), flip, jitter."""
    k_crop, k_flip, k_jit = jax.random.split(key, 3)
    ks, ki, kj = jax.random.split(k_crop, 3)
    kb, kc, kst, kh = jax.random.split(k_jit, 4)
    br, co, sa, hu = jitter
    u = lambda k, shape, lo=0.0, hi=1.0: _t(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    return AugmentDraws(
        scales=u(ks, (b,), *scale_range),
        off_i=u(ki, (b,)),
        off_j=u(kj, (b,)),
        flip=u(k_flip, (b, 1, 1, 1)) < 0.5,
        brightness=u(kb, (b, 1, 1, 1), 1.0 - br, 1.0 + br),
        contrast=u(kc, (b, 1, 1, 1), 1.0 - co, 1.0 + co),
        saturation=u(kst, (b, 1, 1, 1), 1.0 - sa, 1.0 + sa),
        hue=u(kh, (b, 1, 1), -hu, hu),
    )


def diff_augment_draws(key, shape, dtype, policy):
    """``diff_augment`` of a ``shape`` tensor of JAX ``dtype``: one key per
    op, in policy order; translation and cutout split theirs for the two
    axes."""
    b, h, w, _ = shape
    ops = policy_ops(policy)
    keys = jax.random.split(key, len(ops))
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    values = []
    for k, op in zip(keys, ops):
        if op in ("brightness", "saturation", "contrast"):
            values.append((_t(jax.random.uniform(k, (b, 1, 1, 1), dtype=dtype), torch_dtype),))
        elif op == "translation":
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            kx, ky = jax.random.split(k)
            values.append((_t(jax.random.randint(kx, (b,), -sh, sh + 1)),
                           _t(jax.random.randint(ky, (b,), -sw, sw + 1))))
        else:
            ratio = 0.5 if op == "cutout" else 0.2
            ch, cw = int(h * ratio + 0.5), int(w * ratio + 0.5)
            kx, ky = jax.random.split(k)
            values.append((_t(jax.random.randint(kx, (b, 1, 1), 0, h + (1 - ch % 2))),
                           _t(jax.random.randint(ky, (b, 1, 1), 0, w + (1 - cw % 2)))))
    return DiffAugmentDraws(ops, tuple(values))


def nce_ids(key, tap_hw, num_patches):
    """``patch_nce_loss``: layer i draws with ``fold_in(key, i)``."""
    return [_t(jax.random.randint(jax.random.fold_in(key, i), (min(num_patches, hw),), 0, hw))
            for i, hw in enumerate(tap_hw)]


def style_alphas(key, n_blocks, b, alpha_min=0.4, alpha_max=0.9):
    """The style gates of one generator pass (generator_resnet.py:257-293,
    attention.py:258-261): block i draws ``uniform(split(key, n_blocks)[i],
    (b, 1, 1, 1))`` in float32. Returns (n_blocks, b)."""
    keys = jax.random.split(key, n_blocks)
    return torch.stack([_t(jax.random.uniform(keys[i], (b, 1, 1, 1), jnp.float32,
                                              minval=alpha_min, maxval=alpha_max))
                        for i in range(n_blocks)])


def step_draws(base_key, step, b, image_size, policy, fake_dtype, tap_hw, num_patches,
               style=None):
    """Every draw of one JAX ``_train_step`` (float32 reals). ``style``
    (n_blocks, alpha_min, alpha_max) with style dropout: the step then
    splits its key over the nine names (cut_trainer.py:501-504), which
    changes every stream, and draws the three passes' gate alphas."""
    names = STEP_KEY_NAMES + (STYLE_KEY_NAMES if style is not None else ())
    keys = step_keys(base_key, step, names)
    alphas = {name: style_alphas(keys[name], style[0], b, *style[1:]) if style else None
              for name in STYLE_KEY_NAMES}
    shape = (b, image_size, image_size, 3)
    da = lambda name, dtype: (diff_augment_draws(keys[name], shape, dtype, policy)
                              if policy is not None else None)
    return StepDraws(
        photo_aug=augment_draws(keys["photo_aug"], b),
        monet_aug=augment_draws(keys["monet_aug"], b),
        da_real=da("da_real", jnp.float32),
        da_fake=da("da_fake", fake_dtype),
        da_g=da("da_g", fake_dtype),
        nce=nce_ids(keys["nce"], tap_hw, num_patches),
        **alphas,
    )
