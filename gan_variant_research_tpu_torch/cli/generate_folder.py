"""Batch inference / submission generation CLI (PyTorch).

Counterpart of ``gan_variant_research_tpu/cli/generate_folder.py``:

    python -m gan_variant_research_tpu_torch.cli.generate_folder \\
        --ckpt ckpt_final.msgpack --photos data/photo_jpg --out out_dir \\
        [--batch 32] [--size 256] [--limit N] [--no-ema] [--zip images.zip]
        [--device cuda]

- reads the JAX package's msgpack checkpoint; EMA-first restore
  (``ema_G.shadow``, then ``generator`` with a warning); the generator is
  rebuilt from the config stored in the checkpoint; a CycleGAN checkpoint
  (``G_A2B`` / ``G_B2A``, no EMA) serves the generator ``--direction``
  names, the bias-free ResNet or the U-Net as its ``model`` config says;
- recursive listing over 7 extensions, mirrored output tree, ``__dupN``
  names on collisions;
- host: PIL decode and bilinear resize to size^2; device: ``stylize_batch``;
  host: PIL JPEG encode, quality 95, 4:4:4, optimize;
- ``--zip`` also packs flat-renamed ``0.jpg..N.jpg`` for submission.

Serves on ``--device`` (default ``cuda``, the current CUDA device); it
raises when there is no CUDA device, unless the caller passes
``--device cpu``. A variant checkpoint (self-attention, channel attention,
style dropout) serves with no style draws, so its style gates pass their
input through, as in the JAX package.
"""

from __future__ import annotations

import argparse
import sys
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gan_variant_research_tpu_torch.convert import (
    cyclegan_generator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from gan_variant_research_tpu_torch.core.precision import DEFAULT_POLICY, policy_from_config
from gan_variant_research_tpu_torch.data.folders import enumerate_images
from gan_variant_research_tpu_torch.ops.color import to_uint8
from gan_variant_research_tpu_torch.ops.resize import resize_bilinear
from gan_variant_research_tpu_torch.train.checkpoint import load_checkpoint
from gan_variant_research_tpu_torch.train.cut_trainer import build_generator
from gan_variant_research_tpu_torch.train.cyclegan_trainer import build_cyclegan_generator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Stylize a photo folder with a trained generator")
    p.add_argument("--ckpt", required=True, help="Checkpoint (.msgpack)")
    p.add_argument("--photos", required=True, help="Input photo folder (recursive)")
    p.add_argument("--out", required=True, help="Output folder (mirrors input tree)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--limit", type=int, default=None, help="Max images to process")
    p.add_argument("--no-ema", action="store_true", help="Use raw generator params")
    p.add_argument("--direction", choices=("A2B", "B2A"), default="A2B",
                   help="For CycleGAN checkpoints: serve G_A2B or G_B2A")
    p.add_argument("--zip", dest="zip_path", default=None,
                   help="Also write a flat submission zip (0.jpg..N.jpg)")
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on: cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def serving_device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device that is not there raises
    (serving never moves to the CPU unless asked)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; "
                           "pass --device cpu to serve on the CPU")
    return device


def load_generator_params(ckpt_path: str | Path, use_ema: bool = True,
                          direction: str = "A2B"):
    """EMA-first parameter selection and generator reconstruction from the
    stored config; for a CycleGAN checkpoint, the generator of ``direction``
    (``A2B`` or ``B2A``). Returns (generator on the CPU in eval mode,
    config)."""
    blob = load_checkpoint(ckpt_path)
    payload = blob["payload"]
    config = blob["config"] or {}
    policy = policy_from_config(config) if config else DEFAULT_POLICY

    if "G_A2B" in payload:   # CycleGAN joint checkpoint
        key = {"A2B": "G_A2B", "B2A": "G_B2A"}[direction]
        model_cfg = config.get("model") or {}
        generator = build_cyclegan_generator(model_cfg, policy)
        generator.load_state_dict(cyclegan_generator_state_dict_from_jax(
            payload[key], model_cfg.get("generator", "resnet")))
        print(f"CycleGAN checkpoint: serving {key}", file=sys.stderr)
        return generator.eval(), config

    params = None
    if use_ema:
        params = (payload.get("ema_G") or {}).get("shadow")
        if params is None:
            print("WARNING: checkpoint has no EMA shadow; falling back to "
                  "raw generator params", file=sys.stderr)
    if params is None:
        params = payload.get("generator")
    if params is None:
        raise KeyError(f"No generator parameters found in {ckpt_path} "
                       "(looked for ema_G.shadow and generator)")

    gen_cfg = (config.get("model") or {}).get("generator") or {}
    generator = build_generator(gen_cfg, policy)
    generator.load_state_dict(generator_state_dict_from_jax(params))
    return generator.eval(), config


def stylize_batch(generator: torch.nn.Module, u8_nhwc: torch.Tensor,
                  size: int = 256) -> torch.Tensor:
    """The device step: uint8 NHWC -> [0, 1] -> bilinear resize to size^2 ->
    [-1, 1] -> generator -> uint8 NHWC, on the generator's device."""
    device = next(generator.parameters()).device
    with torch.inference_mode():
        x01 = u8_nhwc.to(device, non_blocking=True).float() / 255.0
        x = torch.clamp(resize_bilinear(x01, (size, size)), 0.0, 1.0) * 2.0 - 1.0
        return to_uint8(generator(x))


def stylize_folder(generator: torch.nn.Module, photos_dir: str | Path,
                   out_dir: str | Path, size: int = 256, batch: int = 32,
                   limit: int | None = None, quality: int = 95,
                   zip_path: str | None = None) -> list[Path]:
    """Stylize every image under ``photos_dir`` into the mirrored tree under
    ``out_dir`` as JPEGs; returns the written paths in input order. The
    next batch decodes on host threads while the device runs this one, and
    a batch's JPEGs encode while the device runs the next. A failed write
    (a full disk, an unwritable ``out_dir``) raises once the batch after it
    has run, and no further batch is decoded or run."""
    # imported here: stylize_batch alone must not need PIL
    from PIL import Image

    photos_dir = Path(photos_dir)
    out_dir = Path(out_dir)
    paths = enumerate_images(photos_dir, recursive=True)
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"No images found under {photos_dir}")

    def load_img(p: Path) -> np.ndarray:
        with Image.open(p) as im:
            im = im.convert("RGB")
            if im.size != (size, size):
                im = im.resize((size, size), Image.BILINEAR)
            return np.asarray(im, dtype=np.uint8)

    # Distinct inputs must never overwrite one output: "x.png" and "x.jpg"
    # both become "x.jpg". Later ones in input order get a "__dupN" stem and
    # a warning. Names are assigned here, in order, before the writes start.
    assigned: set[Path] = set()

    def output_path(p: Path) -> Path:
        rel = p.relative_to(photos_dir)
        dst = (out_dir / rel).with_suffix(".jpg")
        if dst in assigned:
            base, k = dst, 1
            while dst in assigned:
                dst = base.with_name(f"{base.stem}__dup{k}.jpg")
                k += 1
            print(f"Warning: output name collision for {rel}; writing {dst.name}")
        assigned.add(dst)
        return dst

    def save_img(dst: Path, img: np.ndarray) -> Path:
        dst.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img, "RGB").save(dst, format="JPEG", quality=quality,
                                         subsampling=0, optimize=True)
        return dst

    chunks = [paths[i:i + batch] for i in range(0, len(paths), batch)]
    written: list[Path] = []
    with ThreadPoolExecutor(max_workers=4) as decode_pool, \
            ThreadPoolExecutor(max_workers=4) as write_pool:
        def decode(chunk):
            return [decode_pool.submit(load_img, p) for p in chunk]

        pending, writing = decode(chunks[0]), []
        try:
            for ci, chunk in enumerate(chunks):
                arr = np.stack([f.result() for f in pending])
                if ci + 1 < len(chunks):
                    pending = decode(chunks[ci + 1])
                out = stylize_batch(generator, torch.from_numpy(arr), size).cpu().numpy()
                # the last batch's writes had this batch's device step to finish;
                # a failure among them raises here, before the next batch
                written += [f.result() for f in writing]
                writing = [write_pool.submit(save_img, output_path(p), img)
                           for p, img in zip(chunk, out)]
                print(f"\r{min((ci + 1) * batch, len(paths))}/{len(paths)} images",
                      end="", flush=True)
            written += [f.result() for f in writing]
        finally:
            for f in pending:
                f.cancel()
    print()

    if zip_path:
        with zipfile.ZipFile(zip_path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
            for idx, f in enumerate(written):
                zf.write(f, arcname=f"{idx}.jpg")
        print(f"Submission zip: {zip_path} ({len(written)} images)")
    return written


def main(argv=None):
    args = parse_args(argv)
    device = serving_device(args.device)
    generator, _ = load_generator_params(args.ckpt, use_ema=not args.no_ema,
                                         direction=args.direction)
    print(f"Serving on {device}", file=sys.stderr)
    stylize_folder(generator.to(device), args.photos, args.out, size=args.size,
                   batch=args.batch, limit=args.limit, quality=args.quality,
                   zip_path=args.zip_path)


if __name__ == "__main__":
    main()
