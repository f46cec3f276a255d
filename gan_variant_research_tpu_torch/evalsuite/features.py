"""Feature extraction on the card, and the real-stats cache.

Counterpart of ``gan_variant_research_tpu/evalsuite/features.py``. Each set
is extracted once. The host decodes the next batches while the card runs
the Inception forward of this one: a bounded prefetch thread takes decoded
batches from ``iter_batches``, copies each into pinned host memory and
from there to the card, non-blocking, on a side stream; the forward's
stream waits for that copy's event. The thread stops when its consumer
goes away, and an error in it (a corrupt image) is raised in the consumer.

The real set's statistics (mu, sigma, features, n) are cached as a
compressed npz keyed by the dataset's SHA1 list hash and the extractor's
identity, with the JAX package's file name and keys: either package reads
the other's cache file.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from gan_variant_research_tpu_torch.evalsuite.datasets import iter_batches
from gan_variant_research_tpu_torch.evalsuite.frechet import gaussian_stats
from gan_variant_research_tpu_torch.evalsuite.inception import InceptionFID


def _prefetch_to_device(batches, device: str | torch.device = "cpu", depth: int = 2,
                        stats: dict | None = None):
    """Yield (uint8 tensor on ``device``, n_valid) for each (batch, n_valid)
    of ``batches``, staged by a background thread at most ``depth`` ahead.
    On a CUDA device the thread pins each batch and copies it on a side
    stream; the tensor is safe to use on the consumer's current stream.
    ``stats["decode_s"]`` (if given) adds up the thread's time in
    ``batches``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer is gone, so that an
        # abandoned generator never leaves the thread parked on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            stream = torch.cuda.Stream(device) if cuda else None
            it = iter(batches)
            while True:
                t = time.perf_counter()
                try:
                    batch, n_valid = next(it)
                except StopIteration:
                    break
                finally:
                    if stats is not None:
                        stats["decode_s"] = stats.get("decode_s", 0.0) + time.perf_counter() - t
                host = torch.from_numpy(batch)
                if cuda:
                    with torch.cuda.stream(stream):
                        staged = host.pin_memory().to(device, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(stream)
                    item = (staged, n_valid, done)
                else:
                    item = (host, n_valid, None)
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
            put(e)

    threading.Thread(target=producer, daemon=True, name="eval-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            staged, n_valid, done = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                staged.record_stream(current)
            yield staged, n_valid
    finally:
        stop.set()
        try:  # unblock a producer parked on a full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


class InceptionFeatureExtractor:
    """Batched pool3 feature extraction over an image-path list, on
    ``device`` (the card by default)."""

    def __init__(self, weights_path: str | Path | None = None, allow_random: bool = False,
                 batch_size: int = 64, img_size: int = 299, num_workers: int = 8,
                 device: str | torch.device = "cuda"):
        self.net = InceptionFID(weights_path, allow_random=allow_random, device=device)
        self.batch_size = batch_size
        self.img_size = img_size
        self.num_workers = num_workers
        # seconds the prefetch thread spent decoding, and images extracted
        self.stats = {"decode_s": 0.0, "images": 0}
        # the identity of the feature space: part of the real-stats cache
        # key (stats from random weights or another resolution must never
        # serve another extractor); the JAX package's tag
        if weights_path is not None:
            w = Path(weights_path)
            weights_id = f"{w.name}:{w.stat().st_size}"
        else:
            weights_id = "random" if allow_random else "default"
        self.identity_tag = f"{weights_id}:{img_size}"

    def extract(self, paths: list[Path], desc: str = "images", verbose: bool = True
                ) -> np.ndarray:
        feats = []
        done = 0
        batches = iter_batches(paths, self.batch_size, self.img_size, self.num_workers)
        for batch, n_valid in _prefetch_to_device(batches, self.net.device,
                                                  stats=self.stats):
            feats.append(self.net.features(batch)[:n_valid])
            done += n_valid
            if verbose:
                print(f"\r{desc}: {done}/{len(paths)}", end="", flush=True)
        if verbose:
            print()
        self.stats["images"] += done
        return torch.cat(feats).cpu().numpy()


def cache_path_for(cache_dir: str | Path, dataset_hash: str, extractor_tag: str = "") -> Path:
    """The cache file of (dataset, extractor): the same real folder through
    random weights, other weights or another input size lives in another
    feature space."""
    suffix = ""
    if extractor_tag:
        suffix = "-" + hashlib.sha1(extractor_tag.encode()).hexdigest()[:12]
    return Path(cache_dir) / "real_stats" / f"{dataset_hash}{suffix}.npz"


def save_cached_stats(path: Path, mu, sigma, features, n: int):
    """Written to a temporary file and renamed, so that a crash mid-write
    leaves no truncated cache."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + ".tmp.npz")   # savez keeps a .npz name
    np.savez_compressed(tmp, mu=mu, sigma=sigma, features=features, n=n)
    os.replace(tmp, path)


def load_cached_stats(path: Path):
    if not path.exists():
        return None
    try:
        with np.load(path) as data:
            return {"mu": data["mu"], "sigma": data["sigma"], "features": data["features"],
                    "n": int(data["n"])}
    except Exception as e:  # noqa: BLE001 - a corrupt or truncated cache is recomputed
        print(f"WARNING: ignoring unreadable stats cache {path}: {e}")
        return None


def compute_or_load_real_stats(extractor: InceptionFeatureExtractor, real_paths: list[Path],
                               dataset_hash: str, cache_dir: str | Path,
                               use_cache: bool = True, verbose: bool = True):
    """Cached (mu, sigma, features, n) of the real set."""
    path = cache_path_for(cache_dir, dataset_hash, getattr(extractor, "identity_tag", ""))
    if use_cache:
        cached = load_cached_stats(path)
        if cached is not None and cached["n"] == len(real_paths):
            if verbose:
                print(f"Loaded cached real stats: {path}")
            return cached
    feats = extractor.extract(real_paths, desc="Real images", verbose=verbose)
    mu, sigma = gaussian_stats(feats)
    if use_cache:
        save_cached_stats(path, mu, sigma, feats, len(real_paths))
        if verbose:
            print(f"Cached real stats: {path}")
    return {"mu": mu, "sigma": sigma, "features": feats, "n": len(real_paths)}
