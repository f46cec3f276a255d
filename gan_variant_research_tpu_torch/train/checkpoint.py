"""Checkpoint I/O in the JAX package's format, without flax.

Counterpart of ``gan_variant_research_tpu/train/checkpoint.py``: one
msgpack file a checkpoint, ``{"config_json", "metrics_json", "payload",
"step"}`` with the keys sorted at every level, so that ``step`` ends the
file. The bytes are flax's (``train/msgpack_codec.py``): a file either
package writes, the other reads.

- ``save_checkpoint``: atomic (``path.tmp``, then ``os.replace``), with the
  ``keep_last_n`` rule that never prunes past the file just written;
- ``AsyncCheckpointer``: one background writer, depth one, sticky errors,
  ``on_done`` once the file is durable. The port's train step updates its
  tensors in place, so ``save`` always copies the payload to host memory on
  the caller's thread before it returns;
- ``load_checkpoint``: array leaves as numpy arrays (bfloat16 widened to
  float32), flax's chunked arrays reassembled;
- ``latest_checkpoint``: what ``--resume auto`` continues from, comparing
  the step stored in each file (read from its last bytes).
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from gan_variant_research_tpu_torch.train import msgpack_codec

_STEP_RE = re.compile(r"ckpt_step(\d+)\.msgpack$")


def to_host(tree: Any, copy: bool = True) -> Any:
    """Every leaf as a numpy array on the host, as the JAX ``_to_host``
    (``np.asarray`` of every leaf; tensors copied off the card). With
    ``copy`` the copy is taken now, of every leaf: a later in-place step
    does not reach it. Without it, host leaves are shared (for a caller that
    is done with them before it returns)."""
    if isinstance(tree, dict):
        return {str(k): to_host(v, copy) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=copy).numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy() if copy else tree
    return np.asarray(tree)


def save_checkpoint(path: str | Path, step: int, payload: dict[str, Any],
                    config: dict | None = None, metrics: dict | None = None,
                    keep_last_n: int | None = None) -> Path:
    """Write ``payload`` (nested dicts of tensors or arrays) with ``step``,
    ``config`` and ``metrics`` to ``path``, atomically. With
    ``keep_last_n``, older ``ckpt_step*.msgpack`` siblings at or below this
    file's step are pruned to N (``ckpt_final`` is never pruned)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {
        "step": int(step),
        "payload": to_host(payload, copy=False),
        "config_json": json.dumps(config or {}),
        "metrics_json": json.dumps(metrics or {}),
    }
    data = msgpack_codec.pack(blob)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)

    if keep_last_n is not None and keep_last_n > 0:
        cur_m = _STEP_RE.search(path.name)
        cur = int(cur_m.group(1)) if cur_m else None
        steps = sorted((int(m.group(1)), p) for p in path.parent.glob("ckpt_step*.msgpack")
                       if (m := _STEP_RE.search(p.name)))
        # after a rollback resume the directory can hold files of a run that
        # went further; counting them would prune the file just written, so
        # only files at or below it are pruned
        eligible = [(n, p) for n, p in steps if cur is None or n <= cur]
        for _, p in eligible[:-keep_last_n]:
            p.unlink(missing_ok=True)
    return path


class AsyncCheckpointer:
    """Checkpoint writes on one background thread, overlapping training.

    - depth one: ``save`` first waits for the write in flight;
    - ``save`` copies the payload to host memory before it returns (the
      step updates the state's tensors in place), so only serialisation and
      the disk write overlap the next steps;
    - atomic through ``save_checkpoint``;
    - errors are sticky: a failed write re-raises on every later ``save``,
      ``wait`` and ``close``;
    - ``on_done(path)`` runs on the writer thread once the file is durable.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._inflight: Future | None = None

    def save(self, path: str | Path, step: int, payload: dict[str, Any],
             config: dict | None = None, metrics: dict | None = None,
             keep_last_n: int | None = None,
             on_done: Callable[[Path], None] | None = None) -> Future:
        self.wait()
        payload = to_host(payload)

        def job() -> Path:
            p = save_checkpoint(path, step, payload, config=config, metrics=metrics,
                                keep_last_n=keep_last_n)
            if on_done is not None:
                on_done(p)
            return p

        self._inflight = self._pool.submit(job)
        return self._inflight

    def wait(self) -> None:
        """Block until the write in flight is durable; re-raise its error
        (the future is cleared only on success)."""
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def load_checkpoint(path: str | Path) -> dict[str, Any]:
    """Read a checkpoint of either package. Returns ``{"step", "payload",
    "config", "metrics"}``; array leaves are numpy arrays (bfloat16 leaves
    widened to float32)."""
    with open(path, "rb") as f:
        blob = msgpack_codec.unpack(f.read())
    return {
        "step": int(blob["step"]),
        "payload": blob["payload"],
        "config": json.loads(blob.get("config_json", "{}")),
        "metrics": json.loads(blob.get("metrics_json", "{}")),
    }


def _peek_tail_step(tail: bytes) -> int | None:
    """A trailing ``"step": <uint>`` entry decoded from a file's last bytes;
    ``None`` unless the fixstr key and its uint end exactly at the end."""
    key = b"\xa4step"
    i = tail.rfind(key)
    if i < 0:
        return None
    v = tail[i + len(key):]
    if not v:
        return None
    b = v[0]
    if b <= 0x7F:
        return b if len(v) == 1 else None
    n = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8}.get(b)
    if n is None or len(v) != 1 + n:
        return None
    return int.from_bytes(v[1:], "big")


def _stored_step(path: Path) -> int:
    """The step recorded inside a checkpoint, from its last 16 bytes (the
    sorted keys put ``step`` last); a full parse for any other layout."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - 16))
        step = _peek_tail_step(f.read())
        if step is not None:
            return step
        f.seek(0)
        return int(msgpack_codec.unpack(f.read())["step"])


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """The checkpoint ``--resume auto`` continues from: the highest
    ``ckpt_step*`` (else CycleGAN's ``ckpt_e*``), unless ``ckpt_final``
    stores a step at least as far along (a completed run later extended
    leaves a stale ``ckpt_final`` behind newer periodic files)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    best, best_step = None, -1
    for p in ckpt_dir.glob("ckpt_step*.msgpack"):
        m = _STEP_RE.search(p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    if best is None:
        for p in ckpt_dir.glob("ckpt_e*.msgpack"):
            m = re.search(r"ckpt_e(\d+)", p.name)
            if m and int(m.group(1)) > best_step:
                best, best_step = p, int(m.group(1))
    final = ckpt_dir / "ckpt_final.msgpack"
    if final.exists() and (best is None or _stored_step(final) >= _stored_step(best)):
        return final
    return best
