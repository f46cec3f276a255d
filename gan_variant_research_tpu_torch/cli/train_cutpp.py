"""CUT training CLI of the port, the flags of the JAX package's
``cli/train_cutpp.py`` and ``--device``:

    gvr-torch-train-cutpp --config train_gan_cutpp.yaml --resume auto \\
        --set max_steps=2000 data.photos_dir=data/photo_jpg [--device cuda]

The default config is the port's copy of the flagship
``configs/train_gan_cutpp.yaml``. Trains on ``--device`` (default ``cuda``,
the current CUDA device); it raises when there is no CUDA device, unless
the caller passes ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from gan_variant_research_tpu_torch.core.config import (
    CUT_SCHEMA,
    load_config,
    override_config,
    validate_config,
)
from gan_variant_research_tpu_torch.train.loop import train_cut

DEFAULT_CONFIG = Path(__file__).parent.parent / "configs" / "train_gan_cutpp.yaml"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train CUT (PyTorch port)")
    parser.add_argument("--config", type=str, default=str(DEFAULT_CONFIG),
                        help="Path to config file")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint to resume from, or 'auto' for latest")
    parser.add_argument("--set", nargs="+", action="append", default=[], dest="overrides",
                        help="Override config values; repeatable "
                             "(e.g. --set loss_weights.adv=0.5 model.generator.ngf=32)")
    parser.add_argument("--strict-config", action="store_true",
                        help="Error (not warn) on unknown config keys")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on: cuda (default), cuda:N or cpu")
    return parser.parse_args(argv)


def training_device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device that is not there raises
    (there is no silent CPU run)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; "
                           "pass --device cpu to train on the CPU")
    return device


def main(argv=None):
    args = parse_args(argv)
    device = training_device(args.device)
    config = load_config(args.config)
    config = override_config(config, [kv for group in args.overrides for kv in group])
    validate_config(config, CUT_SCHEMA, strict=args.strict_config)
    print(f"Using device: {device}")
    return train_cut(config, resume=args.resume, device=device)


if __name__ == "__main__":
    main()
