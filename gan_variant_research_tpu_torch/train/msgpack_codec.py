"""flax's checkpoint bytes on ``msgpack``.

Counterpart of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore`` as the JAX package's ``train/checkpoint.py`` calls them,
without flax. ``msgpack`` is imported inside ``pack`` and ``unpack``, so
importing the port does not load it. flax's ext types:

- 1: a numpy array, the msgpack triple ``(shape, dtype_name, buffer)``
  (C order; ``bfloat16`` is widened to float32 on reading, numpy has no
  bfloat16);
- 2: a Python complex, the msgpack pair ``(real, imag)``;
- 3: a numpy scalar, packed as a 0-d array.

``pack`` writes what flax writes for the same tree, byte for byte: dict
keys sorted at every level (flax copies the tree through
``jax.tree_util.tree_map``, which sorts them) and arrays above
``MAX_CHUNK_SIZE`` bytes as flax's ``__msgpack_chunked_array__`` dicts.
``unpack`` reassembles those.
"""

from __future__ import annotations

from typing import Any

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax.serialization.MAX_CHUNK_SIZE: msgpack's limit is 2**31 - 1 bytes a leaf
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


def _sorted(node: Any, chunk: bool = True) -> Any:
    """``node`` as flax packs it: every dict's keys sorted (str keys only, as
    flax's reader takes), and array leaves over ``MAX_CHUNK_SIZE`` bytes
    chunked, in flax's own key order, where flax chunks them (the root and
    dict values, not in lists)."""
    if type(node) is dict:
        if any(type(k) is not str for k in node):
            raise TypeError("map keys must be str")
        return {k: _sorted(node[k], chunk) for k in sorted(node)}
    if type(node) is list:
        return [_sorted(v, False) for v in node]
    if chunk and isinstance(node, np.ndarray) and node.size * node.dtype.itemsize > MAX_CHUNK_SIZE:
        size = max(1, int(MAX_CHUNK_SIZE / node.dtype.itemsize))
        flat = node.reshape(-1)
        return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(node.shape)},
                "chunks": {str(i): flat[j:j + size]
                           for i, j in enumerate(range(0, flat.size, size))}}
    return node


def _ext_pack(obj: Any) -> Any:
    import msgpack

    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialised")
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        return msgpack.ExtType(code, msgpack.packb((arr.shape, arr.dtype.name,
                                                    arr.tobytes("C"))))
    if isinstance(obj, complex):
        return msgpack.ExtType(EXT_COMPLEX, msgpack.packb((obj.real, obj.imag)))
    return obj   # msgpack raises TypeError on it


def pack(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for ``tree``
    (nested dicts with str keys; leaves numpy arrays and scalars, Python
    int, float, bool, str, bytes, complex or None)."""
    import msgpack

    return msgpack.packb(_sorted(tree), default=_ext_pack, strict_types=True)


def _ext_unpack(code: int, data: bytes) -> Any:
    import msgpack

    if code == EXT_COMPLEX:
        return complex(*msgpack.unpackb(data))
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        return msgpack.ExtType(code, data)
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the 16 stored bits to float32 (exact)
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32).reshape(shape)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)
    return arr if code == EXT_NDARRAY else arr[()]


def _unchunk(node: Any) -> Any:
    if isinstance(node, dict):
        if CHUNKED in node:
            if not node.get("chunks"):
                raise ValueError("a chunked array leaf without chunks")
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def unpack(data) -> Any:
    """What ``flax.serialization.msgpack_restore`` returns for ``data``:
    arrays as read-only numpy arrays (bfloat16 widened to float32), flax's
    chunked arrays reassembled, msgpack arrays as lists."""
    import msgpack

    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False))
