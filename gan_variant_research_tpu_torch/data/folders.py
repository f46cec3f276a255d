"""Image-folder enumeration. The port's own copy of
``gan_variant_research_tpu/data/folders.py::enumerate_images`` (the JAX
package's ``data/__init__.py`` imports jax)."""

from __future__ import annotations

from pathlib import Path

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}


def enumerate_images(folder: str | Path, recursive: bool = True) -> list[Path]:
    """Sorted image files under ``folder`` (recursively by default), any case
    of the seven extensions."""
    folder = Path(folder)
    if not folder.is_dir():
        raise FileNotFoundError(f"Image folder not found: {folder}")
    it = folder.rglob("*") if recursive else folder.glob("*")
    return sorted(p for p in it if p.is_file() and p.suffix.lower() in _EXTS)
