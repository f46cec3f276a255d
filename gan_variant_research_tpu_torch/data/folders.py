"""Image-folder enumeration with the JAX package's conventions. The port's
own copy of ``gan_variant_research_tpu/data/folders.py`` (the JAX
package's ``data/__init__.py`` imports jax).

- ``list_images``: the training folders, sorted, non-recursive, jpg, jpeg
  and png in either case;
- ``enumerate_images``: the serving and eval folders, sorted, recursive by
  default, seven extensions in either case.
"""

from __future__ import annotations

from pathlib import Path

_BASIC_EXTS = {".jpg", ".jpeg", ".png"}
_EXTS = _BASIC_EXTS | {".bmp", ".webp", ".tif", ".tiff"}


def list_images(folder: str | Path) -> list[Path]:
    """Sorted image files directly in ``folder`` (jpg, jpeg, png)."""
    folder = Path(folder)
    if not folder.is_dir():
        raise FileNotFoundError(f"Image folder not found: {folder}")
    return sorted(p for p in folder.iterdir()
                  if p.is_file() and p.suffix.lower() in _BASIC_EXTS)


def enumerate_images(folder: str | Path, recursive: bool = True) -> list[Path]:
    """Sorted image files under ``folder`` (recursively by default), any case
    of the seven extensions."""
    folder = Path(folder)
    if not folder.is_dir():
        raise FileNotFoundError(f"Image folder not found: {folder}")
    it = folder.rglob("*") if recursive else folder.glob("*")
    return sorted(p for p in it if p.is_file() and p.suffix.lower() in _EXTS)
