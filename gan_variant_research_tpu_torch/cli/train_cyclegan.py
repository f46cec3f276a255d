"""CycleGAN training CLI of the port, the flags of the JAX package's
``cli/train_cyclegan.py`` and ``--device``:

    gvr-torch-train-cyclegan --config baseline.yaml --resume auto \\
        --set data.root=data training.max_steps=2000 [--device cuda]

The default config is the port's copy of ``configs/baseline.yaml`` (batch
1); ``configs/baseline_tpu.yaml`` is the batch-16 preset. Trains on
``--device`` (default ``cuda``, the current CUDA device); it raises when
there is no CUDA device, unless the caller passes ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from gan_variant_research_tpu_torch.cli.train_cutpp import training_device
from gan_variant_research_tpu_torch.core.config import (
    CYCLEGAN_SCHEMA,
    load_config,
    override_config,
    validate_config,
)
from gan_variant_research_tpu_torch.train.cyclegan_loop import train_cyclegan

DEFAULT_CONFIG = Path(__file__).parent.parent / "configs" / "baseline.yaml"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the CycleGAN baseline (PyTorch port)")
    parser.add_argument("--config", type=str, default=str(DEFAULT_CONFIG))
    parser.add_argument("--set", nargs="+", action="append", default=[], dest="overrides",
                        help="Override config values; repeatable "
                             "(e.g. --set training.batch_size=16 model.generator=unet)")
    parser.add_argument("--strict-config", action="store_true",
                        help="Error (not warn) on unknown config keys")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint path, or 'auto' for the newest ckpt_e*.msgpack in "
                             "training.save_dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on: cuda (default), cuda:N or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = training_device(args.device)
    config = load_config(args.config)
    config = override_config(config, [kv for group in args.overrides for kv in group])
    validate_config(config, CYCLEGAN_SCHEMA, strict=args.strict_config)
    print(f"Using device: {device}")
    return train_cyclegan(config, resume=args.resume, device=device)


if __name__ == "__main__":
    main()
