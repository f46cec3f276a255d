"""Threaded host loader of fixed-shape uint8 NHWC batches, staged on the card.

Counterpart of ``gan_variant_research_tpu/data/loader.py``: JPEG/PNG
decode and an optional bicubic resize on host threads, all augmentation on
the device (``data/augment.py``), and two independently reshuffled
infinite epoch streams (photos and Monets). The index order is the JAX
loader's, number for number: it is a pure function of the seed, the source
sizes and the batch size (numpy's ``default_rng(seed)`` for the photos,
``seed + 1`` for the Monets, drop_last), and ``start_step`` fast-forwards
it without decoding, so a resumed run sees the batches the uninterrupted
one would have.

In place of the JAX loader's ``jax.device_put`` staging: a producer thread
decodes each batch into pinned host buffers and copies them to the card
without blocking, on a side stream; ``__next__`` makes the caller's stream
wait on the copy's event. On the CPU, batches are CPU tensors. One process;
slicing the global batch across processes waits for the data-parallel item
of the ROADMAP. The native libjpeg codec and TFRecord input are not ported:
PIL decodes, and a ``.tfrec`` source raises.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gan_variant_research_tpu_torch.data.folders import list_images

_TFREC_EXTS = (".tfrec", ".tfrecord")


def load_image_u8(path: str | Path, size: int | None = None) -> np.ndarray:
    """Decode to RGB uint8 HWC with PIL; bicubic-resize to size^2 when the
    image is another size (the JAX function's PIL path)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if size is not None and im.size != (size, size):
            im = im.resize((size, size), Image.BICUBIC)
        return np.asarray(im, dtype=np.uint8)


class ImageFolderSource:
    """A folder of images decoded to a fixed uint8 resolution."""

    def __init__(self, folder: str | Path, size: int):
        self.paths = list_images(folder)
        if not self.paths:
            raise FileNotFoundError(f"No images found in {folder}")
        self.size = size

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int) -> np.ndarray:
        return load_image_u8(self.paths[idx], self.size)


def make_source(path, size: int):
    """An ``ImageFolderSource`` for a folder; an already-built source (any
    object with ``__len__`` and ``get(idx) -> HWC uint8``) passes through.
    TFRecord shards raise."""
    if not isinstance(path, (str, Path)):
        return path
    p = Path(path)
    if (p.is_file() and p.suffix.lower() in _TFREC_EXTS) or (
            p.is_dir() and any(c.suffix.lower() in _TFREC_EXTS for c in p.iterdir())):
        raise NotImplementedError(
            f"{p}: TFRecord input is not ported yet (ROADMAP.md Queue 1, "
            "'Serving, the rest'); point data.photos_dir / monet_dir at image folders")
    return ImageFolderSource(p, size)


class _EpochStream:
    """Infinite stream of batch indices: a fresh permutation each epoch,
    drop_last; ``skip(n)`` fast-forwards n batches without decoding."""

    def __init__(self, source, batch_size: int, seed: int, pool: ThreadPoolExecutor):
        if len(source) < batch_size:
            raise ValueError(
                f"Dataset has {len(source)} images < batch_size {batch_size}; "
                "drop_last leaves no complete batch (shrink the batch or add data)")
        self.source = source
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.pool = pool
        self._order: list[int] = []
        self._pos = 0

    def next_indices(self) -> list[int]:
        if self._pos + self.batch_size > len(self._order):
            self._order = self.rng.permutation(len(self.source)).tolist()
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return idx

    def skip(self, n: int) -> None:
        for _ in range(n):
            self.next_indices()

    def decode_into(self, idx: list[int], out: np.ndarray) -> None:
        for i, img in enumerate(self.pool.map(self.source.get, idx)):
            out[i] = img


class _Slot:
    """One batch's host buffers (photos, Monets; pinned for the card) and
    the event of their last copy to the card."""

    def __init__(self, shape, pin: bool):
        self.host = [torch.empty(shape, dtype=torch.uint8, pin_memory=pin) for _ in range(2)]
        self.copied: torch.cuda.Event | None = None


class UnpairedLoader:
    """Two-domain unpaired loader with background prefetch.

    ``next(loader)`` gives (photos_u8, monets_u8), uint8 NHWC tensors on
    ``device``; ``last_indices`` holds the source indices of the batch it
    gave last. A producer thread keeps ``prefetch`` batches decoded (and, on
    the card, copied) ahead of the step. Decode errors re-raise in the
    consumer, on every later call."""

    def __init__(self, photos_dir, monet_dir, batch_size: int, size: int, seed: int = 42,
                 num_workers: int = 8, prefetch: int = 4, device: torch.device | str = "cuda",
                 start_step: int = 0):
        self.device = torch.device(device)
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self.photos = _EpochStream(make_source(photos_dir, size), batch_size, seed, self.pool)
        self.monets = _EpochStream(make_source(monet_dir, size), batch_size, seed + 1, self.pool)
        if start_step:
            self.photos.skip(start_step)
            self.monets.skip(start_step)
        self.last_indices: tuple[list[int], list[int]] | None = None
        on_card = self.device.type == "cuda"
        if on_card:
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
        # the producer writes a slot again only after its last copy's event
        depth = max(1, prefetch)
        self._slots = [_Slot((batch_size, size, size, 3), on_card) for _ in range(depth + 2)]
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    @property
    def num_photos(self):
        return len(self.photos.source)

    @property
    def num_monets(self):
        return len(self.monets.source)

    def _stage(self, slot: _Slot):
        """The slot's batch on the device: CPU tensors (copies, the slot is
        reused) or device copies on the side stream."""
        if self.device.type != "cuda":
            return tuple(h.clone() for h in slot.host)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = tuple(h.to(self.device, non_blocking=True) for h in slot.host)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._stream)
        return out + (slot.copied,)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            i = 0
            while not self._stop.is_set():
                slot = self._slots[i % len(self._slots)]
                i += 1
                if slot.copied is not None:
                    slot.copied.synchronize()   # its last copy has left the buffers
                idx = (self.photos.next_indices(), self.monets.next_indices())
                for stream, ix, host in zip((self.photos, self.monets), idx, slot.host):
                    stream.decode_into(ix, host.numpy())
                if not self._put((idx, self._stage(slot))):
                    return
        except Exception as e:  # re-raised in the consumer, on every later call
            self._error = e
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._error is not None:
            raise self._error
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        self.last_indices, batch = item
        if self.device.type != "cuda":
            return batch
        photos, monets, copied = batch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(copied)
        for t in (photos, monets):
            t.record_stream(stream)   # allocated on the side stream, used on this one
        return photos, monets

    def close(self):
        """Stop the producer (draining the queue so that it can exit) and the
        decode pool."""
        self._stop.set()
        for _ in range(60):
            if not self._thread.is_alive():
                break
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.5)
        self.pool.shutdown(wait=not self._thread.is_alive(), cancel_futures=True)
