"""CUT configs: the YAML reader, ``--set`` overrides, schema validation and
the keys the port's train step reads.

Counterpart of ``gan_variant_research_tpu/core/config.py`` (``ConfigError``,
``load_config``, ``_coerce``, ``override_config``, ``validate_config``,
``deep_update``, ``CUT_SCHEMA``, ``CYCLEGAN_SCHEMA``). The machine with the card has no PyYAML:
``load_config`` reads YAML with ``parse_yaml``, a reader of the subset the
JAX package's ``configs/*.yaml`` use (block mappings and sequences by
indentation, ``#`` comments, one-line flow sequences and mappings, plain and
quoted scalars) that resolves scalars as ``yaml.safe_load`` does (YAML 1.1:
``yes``/``on`` are booleans, ``~`` is null, a float needs its dot). It
refuses what it does not read (anchors, tags, block scalars, multi-line
flow collections).

``STEP_KEYS`` lists, as dotted paths, every key ``train/cut_trainer.py``
reads; ``get`` reads one with its default.
"""

from __future__ import annotations

import copy
import re
import warnings
from pathlib import Path
from typing import Any, Mapping


class ConfigError(ValueError):
    """Raised for invalid configs (unknown keys in strict mode, bad types,
    YAML outside the reader's subset)."""


# --------------------------------------------------------------------------- #
# the YAML subset

# PyYAML's implicit resolvers (yaml/resolver.py), sexagesimal forms left out
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")


def _plain(text: str) -> Any:
    """A plain scalar, resolved as PyYAML's SafeLoader resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _SEXAGESIMAL.match(text):
        raise ConfigError(f"sexagesimal number {text!r} is outside the YAML subset read here")
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t != "0" and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    if text[:1] in "&*!|>%@`":
        raise ConfigError(f"YAML feature in {text!r} is outside the subset read here")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


class _Flow:
    """One line's scalar or flow collection, read left to right."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def fail(self, what: str):
        raise ConfigError(f"{self.where}: {what} in {self.s!r}")

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == q:
                if q == "'" and self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if c == "\\" and q == '"':
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                    continue
                n = {"x": 2, "u": 4, "U": 8}.get(e)
                if n is None:
                    self.fail(f"unknown escape \\{e}")
                out.append(chr(int(self.s[self.i + 2:self.i + 2 + n], 16)))
                self.i += 2 + n
                continue
            out.append(c)
            self.i += 1
        self.fail("unterminated quoted scalar")

    def value(self, in_flow: bool) -> Any:
        self.ws()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in "'\"":
            return self.quoted()
        stops = ",]}" if in_flow else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stops and not (
                in_flow and self.s[j] == ":" and self.s[j + 1:j + 2] in (" ", ",", "]", "}", "")):
            j += 1
        text, self.i = self.s[self.i:j].strip(), j
        return _plain(text)

    def sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(True))
            self.ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "]":
                self.fail("expected ',' or ']'")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value(True)
            self.ws()
            if self.s[self.i:self.i + 1] != ":":
                self.fail("expected ':' in a flow mapping")
            self.i += 1
            out[key] = self.value(True)
            self.ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "}":
                self.fail("expected ',' or '}'")

    def whole(self) -> Any:
        v = self.value(False)
        self.ws()
        if self.i != len(self.s):
            self.fail("text after the value")
        return v


def _strip_comment(line: str) -> str:
    """``line`` without its ``#`` comment (a ``#`` at the start or after a
    blank, outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str, where: str):
    """``key: rest`` -> (key, rest), or None when ``text`` is no mapping
    entry."""
    if text[:1] in "'\"":
        f = _Flow(text, where)
        key = f.quoted()
        rest = text[f.i:]
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:].strip()
    m = re.match(r"^([^:#\[\]{},]+?):(?:\s+|$)(.*)$", text)
    if m is None:
        return None
    return _plain(m.group(1).strip()), m.group(2)


def parse_yaml(text: str, name: str = "<yaml>") -> Any:
    """The document in ``text`` as ``yaml.safe_load`` gives it, for the
    subset described above."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ConfigError(f"{name}:{n}: tab in indentation")
        body = _strip_comment(raw)
        if body.strip() in ("", "---"):
            continue
        lines.append((n, len(body) - len(body.lstrip()), body.strip()))
    pos = 0

    def block(indent: int) -> Any:
        nonlocal pos
        n, ind, body = lines[pos]
        if body.startswith("- ") or body == "-":
            out = []
            while pos < len(lines) and lines[pos][1] == indent and (
                    lines[pos][2].startswith("- ") or lines[pos][2] == "-"):
                n, ind, body = lines[pos]
                item = body[1:].strip()
                pos += 1
                if item:
                    if _split_key(item, f"{name}:{n}") is not None:
                        raise ConfigError(f"{name}:{n}: a mapping inside a block sequence "
                                          "is outside the subset read here")
                    out.append(_Flow(item, f"{name}:{n}").whole())
                else:
                    out.append(nested(indent))
            return out
        out = {}
        while pos < len(lines) and lines[pos][1] == indent:
            n, ind, body = lines[pos]
            kv = _split_key(body, f"{name}:{n}")
            if kv is None:
                raise ConfigError(f"{name}:{n}: expected 'key: value', got {body!r}")
            key, rest = kv
            pos += 1
            if key in out:
                raise ConfigError(f"{name}:{n}: duplicate key {key!r}")
            out[key] = _Flow(rest, f"{name}:{n}").whole() if rest else nested(indent)
        return out

    def nested(indent: int) -> Any:
        """The block under an entry: deeper lines, or a sequence at the same
        indentation (YAML lets ``- `` items sit under their key); else
        null."""
        if pos < len(lines):
            n, ind, body = lines[pos]
            if ind > indent or (ind == indent and (body.startswith("- ") or body == "-")):
                return block(ind)
        return None

    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][2], name) is None and not (
            lines[0][2].startswith("- ")):
        return _Flow(lines[0][2], f"{name}:{lines[0][0]}").whole()
    root = block(lines[0][1])
    if pos != len(lines):
        n, ind, body = lines[pos]
        raise ConfigError(f"{name}:{n}: unexpected indentation at {body!r}")
    return root


def load_config(path: str | Path) -> dict:
    """Load a YAML config file into a plain nested dict."""
    cfg = parse_yaml(Path(path).read_text(), str(path))
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
        try:
            parsed = parse_yaml(value)
        except ConfigError:
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
