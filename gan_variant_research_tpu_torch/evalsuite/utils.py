"""Eval utilities: recursive image enumeration, the SHA1 list hash
(relpath and size), count validation with the Kaggle thresholds and
warnings, the filename-overlap leak check and the printing timer.

The port's own copy of ``gan_variant_research_tpu/evalsuite/utils.py`` (the
port imports nothing of the JAX package). ``compute_image_list_hash`` is
the same function, so either package keys the real-stats cache of a folder
with the same hash."""

from __future__ import annotations

import hashlib
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any


def enumerate_images(path: str | Path, recursive: bool = True) -> list[Path]:
    path_obj = Path(path)
    if not path_obj.exists():
        raise FileNotFoundError(f"Path does not exist: {path}")
    if not path_obj.is_dir():
        raise NotADirectoryError(f"Path is not a directory: {path}")
    exts = {".jpg", ".jpeg", ".png"}
    it = path_obj.rglob("*") if recursive else path_obj.glob("*")
    return sorted({p for p in it if p.is_file() and p.suffix.lower() in exts})


def compute_image_list_hash(image_paths: list[Path], base_path: Path | None = None) -> str:
    """SHA1 over sorted 'relpath:size' lines."""
    hasher = hashlib.sha1()
    for img_path in sorted(image_paths):
        rel = img_path
        if base_path:
            try:
                rel = img_path.relative_to(base_path)
            except ValueError:
                rel = img_path
        try:
            size = img_path.stat().st_size
        except OSError:
            size = 0
        hasher.update(f"{rel.as_posix()}:{size}\n".encode())
    return hasher.hexdigest()


def validate_image_counts(fake_images: list[Path], real_images: list[Path]) -> dict[str, Any]:
    num_fake, num_real = len(fake_images), len(real_images)
    warnings = []
    if num_fake < 7000:
        warnings.append(
            f"Fake image count ({num_fake}) is below expected range (7000-10000)")
    elif num_fake > 10000:
        warnings.append(
            f"Fake image count ({num_fake}) is above expected range (7000-10000)")
    if num_real < 300:
        warnings.append(
            f"Real image count ({num_real}) is below expected minimum (300)")
    if num_fake == 0:
        raise ValueError("No fake images found!")
    if num_real == 0:
        raise ValueError("No real images found!")
    fake_bytes = sum(p.stat().st_size for p in fake_images)
    real_bytes = sum(p.stat().st_size for p in real_images)
    return {
        "num_fake": num_fake,
        "num_real": num_real,
        "fake_total_mb": fake_bytes / (1024 * 1024),
        "real_total_mb": real_bytes / (1024 * 1024),
        "warnings": warnings,
        "valid": len(warnings) == 0,
    }


def check_dataset_overlap(fake_paths: list[Path], real_paths: list[Path]) -> dict[str, Any]:
    fake_names = {p.name for p in fake_paths}
    real_names = {p.name for p in real_paths}
    overlap = fake_names & real_names
    return {
        "has_overlap": len(overlap) > 0,
        "overlap_count": len(overlap),
        "overlap_examples": sorted(overlap)[:10] if overlap else [],
    }


@contextmanager
def timer(name: str, verbose: bool = True):
    result: dict = {}
    start = time.time()
    if verbose:
        print(f"[Timer] Starting: {name}")
    try:
        yield result
    finally:
        result["elapsed"] = time.time() - start
        if verbose:
            print(f"[Timer] Completed: {name} in {result['elapsed']:.2f}s")
