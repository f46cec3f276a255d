"""CUT configs: loading, ``--set`` overrides, schema validation and the keys
the port's train step reads.

Counterpart of ``gan_variant_research_tpu/core/config.py`` (``ConfigError``,
``load_config``, ``_coerce``, ``override_config``, ``validate_config``,
``deep_update``, ``CUT_SCHEMA``, ``CYCLEGAN_SCHEMA``). YAML is read with
``yaml.safe_load``, as there; PyYAML is imported inside the two functions
that read it, so importing the port does not load it.

``STEP_KEYS`` lists, as dotted paths, every key ``train/cut_trainer.py``
reads; ``get`` reads one with its default.
"""

from __future__ import annotations

import copy
import warnings
from pathlib import Path
from typing import Any, Mapping


class ConfigError(ValueError):
    """Raised for invalid configs (unknown keys in strict mode, bad types)."""


def load_config(path: str | Path) -> dict:
    """Load a YAML config file into a plain nested dict."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    if not isinstance(cfg, dict):
        raise ConfigError(f"Config root must be a mapping, got {type(cfg)!r}")
    return cfg


# --------------------------------------------------------------------------- #
# overrides, validation

def _coerce(value: str) -> Any:
    """A ``--set`` string as bool, None, int, float or a flat list when it
    reads as one, else the string (the JAX package's coercion)."""
    low = value.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith("[") and value.endswith("]"):
        # list values (e.g. --set model.generator.attn_layers=[1,3])
        import yaml

        try:
            parsed = yaml.safe_load(value)
        except yaml.YAMLError:
            return value
        if isinstance(parsed, list) and all(
                isinstance(x, (bool, int, float, str)) or x is None for x in parsed):
            return parsed
    return value


def override_config(config: dict, overrides: list[str]) -> dict:
    """Apply ``key.path=value`` overrides in place and return the config.
    Entries without ``=`` are skipped; missing mappings on the path are
    created."""
    for override in overrides:
        if "=" not in override:
            continue
        key_path, value = override.split("=", 1)
        keys = key_path.split(".")
        current = config
        for key in keys[:-1]:
            if key not in current or not isinstance(current[key], dict):
                current[key] = {}
            current = current[key]
        current[keys[-1]] = _coerce(value)
    return config


# A schema is a nested dict: leaf values are a type / tuple of types / the
# sentinel ANY; ``dict`` leaves mean "any mapping allowed below".
ANY = object()


def validate_config(config: Mapping, schema: Mapping, strict: bool = False,
                    _path: str = "") -> list[str]:
    """Validate ``config`` against ``schema``; returns the problems found.
    Unknown keys raise ``ConfigError`` in strict mode and warn otherwise;
    type mismatches always raise."""
    problems: list[str] = []
    for key, value in config.items():
        here = f"{_path}.{key}" if _path else str(key)
        if key not in schema:
            problems.append(f"unknown config key: {here}")
            continue
        spec = schema[key]
        if spec is ANY or spec is dict:
            continue
        if isinstance(spec, Mapping):
            if not isinstance(value, Mapping):
                if value is None:
                    continue  # empty section
                raise ConfigError(f"{here}: expected mapping, got {type(value).__name__}")
            problems.extend(validate_config(value, spec, strict=strict, _path=here))
        else:
            types = spec if isinstance(spec, tuple) else (spec,)
            if value is not None and not isinstance(value, types):
                if float in types and isinstance(value, int):
                    continue  # an int where a float is expected
                raise ConfigError(
                    f"{here}: expected {'/'.join(t.__name__ for t in types)}, "
                    f"got {type(value).__name__} ({value!r})")
    if problems:
        msg = "; ".join(problems)
        if strict:
            raise ConfigError(msg)
        warnings.warn(msg, stacklevel=2)
    return problems


def deep_update(base: dict, extra: Mapping) -> dict:
    """Recursively merge ``extra`` into a deep copy of ``base``."""
    out = copy.deepcopy(base)
    for k, v in extra.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_num = (int, float)

# Schema for the CUT training config (the JAX package's CUT_SCHEMA): every
# key of configs/train_gan_cutpp.yaml, the JAX package's additions under
# ``runtime`` and ``parallel`` included.
CUT_SCHEMA: dict = {
    "image_size": int,
    "batch_size": int,
    "epochs": int,
    "max_steps": int,
    "seed": int,
    "warmup_steps": int,
    "grad_clip_g": _num,
    "grad_clip_d": _num,
    "amp": bool,
    "log_every": int,
    "num_workers": int,
    "prefetch_factor": int,
    "pin_memory": bool,
    "data": {
        "photos_dir": str,
        "monet_dir": str,
        "photos_tfrec": str,
        "monet_tfrec": str,
        "use_tfrec": bool,
    },
    "output": {"checkpoint_dir": str, "log_dir": str},
    "optim": {
        "G": {
            "lr": _num,
            "betas": list,
            "weight_decay": _num,
            "scheduler": {"type": str, "lr_min": _num, "enabled": bool},
        },
        "D": {
            "lr": _num,
            "betas": list,
            "weight_decay": _num,
            "scheduler": {"type": str, "lr_min": _num, "enabled": bool},
        },
    },
    "loss_weights": {
        "adv": _num,
        "patchnce": _num,
        "identity_warm": _num,
        "identity_final": _num,
        "palette": _num,
        "repulsion": _num,
        "featmatch": _num,
    },
    "model": {
        "generator": {
            "base": str,
            "n_downsampling": int,
            "n_blocks": int,
            "ngf": int,
            "norm": str,
            "activation": str,
            "padding_type": str,
            "use_attention": bool,
            "attn_layers": list,
            "attn_flash": (bool, str),
            "use_channel_attn": bool,
            "channel_attn_layers": list,
            "use_style_dropout": bool,
            "style_dropout": {"alpha_min": _num, "alpha_max": _num},
            "remat": bool,
            "use_pallas": bool,
            "pad_free": bool,
            "use_s2d": bool,
        },
        "discriminator": {
            "base": str,
            "num_scales": int,
            "ndf": int,
            "n_layers": int,
            "norm": str,
            "use_spectral_norm": bool,
            "receptive_field": int,
        },
    },
    "patchnce": {
        "num_patches": int,
        "temperature": _num,
        "nce_layers": list,
        "nce_includes_all_negatives_from_minibatch": bool,
    },
    "diffaugment": {"enable": bool, "policy": list},
    "r1": {"gamma": _num, "every": int},
    "ema": {"decay": _num, "warmup_steps": int},
    "eval": {"every_steps": int, "num_samples": int},
    "metrics": {
        "compute_fid": bool,
        "compute_clip_distance": bool,
        "eval_every": int,
        "save_checkpoint_every": int,
    },
    "early_stop": dict,
    "checkpoint": {"every_steps": int, "keep_last_n": int, "async_save": bool},
    "io": {"num_workers": int, "pin_memory": bool, "amp": bool},
    "log": {"every_steps": int, "verbose": bool},
    "clip_features": dict,
    "palette": dict,
    "palette_prior": dict,
    "repulsion": dict,
    # TPU-native additions
    "runtime": {
        "platform": str,          # "tpu" | "cpu" (tests)
        "precision": str,         # "bf16" | "fp32"
        "donate": bool,
        "d_real_domain": str,     # "photo" (reference-literal) | "monet" (CUT-correct)
        "identity_fp32": bool,
        "steps_per_call": int,    # lax.scan window size (1 = plain stepping)
        "profile_dir": str,
    },
    "parallel": {
        "data_axis": str,
        "num_devices": int,       # None/absent → all local devices
        "multihost": (bool, str),  # False | True | "auto" (coordinator env)
    },
}


# Schema for the CycleGAN config (the JAX package's CYCLEGAN_SCHEMA, which
# mirrors Basic_GAN/configs/baseline.yaml). ``model.use_s2d``,
# ``model.pad_free``, ``runtime.donate``, ``runtime.steps_per_call`` and
# ``parallel.*`` are TPU levers: accepted and ignored.
CYCLEGAN_SCHEMA: dict = {
    "data": {
        "root": str,
        "domain_a": str,
        "domain_b": str,
        "img_size": int,
        "load_size": int,
        "num_workers": int,
    },
    "training": {
        "epochs": int,
        "batch_size": int,
        "amp": bool,
        "seed": int,
        "save_dir": str,
        "log_dir": str,
        "save_every": int,
        "max_steps": int,
        "async_save": bool,
    },
    "optim": {
        "lr_g": _num,
        "lr_d": _num,
        "betas": list,
        "lr_decay_after": int,
    },
    "loss": {"gan": str, "lambda_cycle": _num, "lambda_identity": _num},
    "model": {
        "ngf": int,
        "ndf": int,
        "n_blocks": int,
        "n_layers": int,
        "spectral_norm_d": bool,
        "generator": str,  # "resnet" | "unet"
        "use_s2d": bool,
        "pad_free": bool,
    },
    "runtime": {"device": str, "platform": str, "precision": str,
                "donate": bool,
                "steps_per_call": int},
    "parallel": {"data_axis": str, "num_devices": int, "multihost": (bool, str)},
}

# --------------------------------------------------------------------------- #
# the keys the train step reads

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
