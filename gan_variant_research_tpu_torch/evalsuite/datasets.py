"""Eval inputs: folders of images, decoded to RGB uint8 and resized with
PIL bilinear to img_size^2 (299 for Inception), NHWC.

Counterpart of ``gan_variant_research_tpu/evalsuite/datasets.py`` for
folder inputs. The JAX package decodes JPEGs with its native libjpeg codec,
pixel-identical to PIL's decode by its own test, and resizes with PIL
either way; here PIL does both, so the pixels are the same. TFRecord shards
are not read yet (ROADMAP Queue 1 item 5): such an input raises.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator

import numpy as np

_TFREC_EXTS = (".tfrec", ".tfrecord")


def is_tfrecord_input(path: str | Path) -> bool:
    """True for a ``*.tfrec*`` file or a directory holding one: the JAX
    package's detection rule."""
    p = Path(path)
    if p.is_file():
        return p.suffix.lower() in _TFREC_EXTS
    return p.is_dir() and any(c.suffix.lower() in _TFREC_EXTS for c in p.iterdir())


def enumerate_eval_inputs(path: str | Path) -> list[Path]:
    """The images of a folder, recursively, sorted; a TFRecord input
    raises."""
    from gan_variant_research_tpu_torch.evalsuite.utils import enumerate_images

    if is_tfrecord_input(path):
        raise NotImplementedError(
            f"{path}: TFRecord eval inputs are not ported yet (ROADMAP Queue 1 item 5, "
            "TFRecord input); unpack the shards to a folder of JPEGs, or score them with "
            "the JAX package's gvr-eval")
    return enumerate_images(path)


def load_eval_image(path: str | Path, img_size: int = 299) -> np.ndarray:
    """uint8 HWC RGB, PIL-bilinear resized to img_size^2."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode != "RGB":
            img = img.convert("RGB")
        if img.size != (img_size, img_size):
            img = img.resize((img_size, img_size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def iter_batches(paths: list[Path], batch_size: int = 64, img_size: int = 299,
                 num_workers: int = 8, pad_to_batch: bool = True
                 ) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (uint8 NHWC batch, n_valid), decoded on a pool of
    ``num_workers`` threads (PIL releases the interpreter lock while it
    decodes). The last batch is zero-padded to ``batch_size`` unless
    ``pad_to_batch`` is False; ``n_valid`` marks its real rows."""
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for i in range(0, len(paths), batch_size):
            chunk = paths[i:i + batch_size]
            batch = np.stack(list(pool.map(lambda p: load_eval_image(p, img_size), chunk)))
            n_valid = len(chunk)
            if pad_to_batch and n_valid < batch_size:
                pad = np.zeros((batch_size - n_valid, *batch.shape[1:]), np.uint8)
                batch = np.concatenate([batch, pad])
            yield batch, n_valid
