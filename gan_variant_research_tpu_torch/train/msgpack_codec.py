"""The msgpack subset that flax's checkpoints use, without ``msgpack``.

Counterpart of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore`` as the JAX package's ``train/checkpoint.py`` calls them
(the machine with the card need not have ``msgpack`` or flax). The subset:
maps (str keys), arrays, str, bin, int and uint, float32/64, bool, nil, and
flax's ext types:

- 1: a numpy array, the msgpack triple ``(shape, dtype_name, buffer)``
  (C order; ``bfloat16`` is widened to float32 on reading, numpy has no
  bfloat16);
- 2: a Python complex, the msgpack pair ``(real, imag)``;
- 3: a numpy scalar, packed as a 0-d array.

``pack`` writes what flax writes for the same tree, byte for byte: dict
keys sorted at every level (flax copies the tree through
``jax.tree_util.tree_map``, which sorts them), every integer in its
shortest form, floats as float64, and arrays above ``MAX_CHUNK_SIZE`` bytes
as flax's ``__msgpack_chunked_array__`` dicts. ``unpack`` reassembles
those.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax.serialization.MAX_CHUNK_SIZE: msgpack's limit is 2**31 - 1 bytes a leaf
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------- #
# packing

def _pack_int(v: int, out: list) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(bytes((v,)))
        elif v <= 0xFF:
            out.append(b"\xcc" + bytes((v,)))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + struct.pack(">H", v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + struct.pack(">I", v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + struct.pack(">Q", v))
        else:
            raise OverflowError(f"int {v} does not fit msgpack's 64 bits")
    elif v >= -32:
        out.append(struct.pack(">b", v))
    elif v >= -0x80:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif v >= -0x8000:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form below ``fix_max``, then the 8-, 16-
    and 32-bit forms in ``codes`` (``None`` where a form does not exist)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] is not None and n <= 0xFF:
        out.append(bytes((codes[0], n)))
    elif n <= 0xFFFF:
        out.append(bytes((codes[1],)) + struct.pack(">H", n))
    elif n <= 0xFFFFFFFF:
        out.append(bytes((codes[2],)) + struct.pack(">I", n))
    else:
        raise ValueError(f"msgpack object of length {n} is too long")


def _pack_bin(b: bytes, out: list) -> None:
    _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes((fixed[n], code)))
    elif n <= 0xFF:
        out.append(bytes((0xC7, n, code)))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">H", n) + bytes((code,)))
    else:
        out.append(b"\xc9" + struct.pack(">I", n) + bytes((code,)))
    out.append(data)


def _array_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack triple of shape (an array
    of ints), dtype name (str) and the C-order buffer (bin)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    out: list = []
    _pack_len(3, 0x90, 16, (None, 0xDC, 0xDD), out)
    _pack_len(arr.ndim, 0x90, 16, (None, 0xDC, 0xDD), out)
    for d in arr.shape:
        _pack_int(int(d), out)
    _pack_obj(arr.dtype.name, out)
    _pack_bin(arr.tobytes("C"), out)
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: a dict in flax's own key order (not sorted)."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size]
                       for i, j in enumerate(range(0, flat.size, size))}}


def _pack_obj(obj: Any, out: list, sort: bool = True) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif type(obj) in (bytes, bytearray):
        _pack_bin(bytes(obj), out)
    elif type(obj) is dict:
        keys = sorted(obj) if sort else list(obj)
        _pack_len(len(keys), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k in keys:
            if type(k) is not str:
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            _pack_obj(k, out)
            _pack_obj(obj[k], out, sort)
    elif type(obj) is list:
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack_obj(v, out, sort)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            # flax chunks after its sorting copy: the chunk dict keeps its order
            _pack_obj(_chunk(obj), out, sort=False)
        else:
            _pack_ext(EXT_NDARRAY, _array_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_bytes(np.asarray(obj)), out)
    elif type(obj) is complex:
        inner: list = [b"\x92"]
        _pack_obj(obj.real, inner)
        _pack_obj(obj.imag, inner)
        _pack_ext(EXT_COMPLEX, b"".join(inner), out)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__} (flax's msgpack subset)")


def pack(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for ``tree``
    (nested dicts with str keys; leaves numpy arrays and scalars, Python
    int, float, bool, str, bytes, complex or None)."""
    out: list = []
    _pack_obj(tree, out)
    return b"".join(out)


# --------------------------------------------------------------------------- #
# unpacking

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self, raw: bool = False) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.sint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            code = self.sint(1)
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.uint(1 << (b - 0xD9)), raw)
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 << (b - 0xDC)), raw)
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 << (b - 0xDE)), raw)
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside flax's subset")

    def str(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def array(self, n: int, raw: bool) -> list:
        return [self.obj(raw) for _ in range(n)]

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == EXT_NPSCALAR:
            return _array_from_bytes(data)[()]
        if code == EXT_COMPLEX:
            re, im = _Reader(data).obj()
            return complex(re, im)
        raise ValueError(f"unknown msgpack ext type {code}")


def _array_from_bytes(data) -> np.ndarray:
    reader = _Reader(data)
    shape, dtype_name, buffer = reader.obj(raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the 16 stored bits to float32 (exact)
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


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
    arrays as numpy arrays (read-only views of ``data``; bfloat16 widened to
    float32), flax's chunked arrays reassembled, msgpack arrays as lists."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)
