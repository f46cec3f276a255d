"""Checkpoint reader for the JAX package's msgpack files, without flax.

Counterpart of ``gan_variant_research_tpu/train/checkpoint.py::
load_checkpoint`` (reader only). flax serialises arrays as msgpack ext type
1 holding the msgpack triple ``(shape, dtype_name, buffer)``, scalars as ext
type 3 (the same triple, 0-d) and complex numbers as ext type 2.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _array_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the 16 stored bits to float32
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    raise ValueError(f"unknown msgpack ext type {code} in checkpoint")


def _reject_chunked(tree, path: str = "payload") -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise NotImplementedError(
                f"{path} is a flax chunked array (a leaf over msgpack's size "
                "limit); this reader does not reassemble chunked arrays")
        for k, v in tree.items():
            _reject_chunked(v, f"{path}/{k}")


def load_checkpoint(path: str | Path) -> dict[str, Any]:
    """Read a checkpoint written by the JAX package's ``save_checkpoint``.
    Returns ``{"step", "payload", "config", "metrics"}``; array leaves of the
    payload are numpy arrays (bf16 leaves widened to float32)."""
    import msgpack

    with open(path, "rb") as f:
        blob = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    payload = blob["payload"]
    _reject_chunked(payload)
    return {
        "step": int(blob["step"]),
        "payload": payload,
        "config": json.loads(blob.get("config_json", "{}")),
        "metrics": json.loads(blob.get("metrics_json", "{}")),
    }
