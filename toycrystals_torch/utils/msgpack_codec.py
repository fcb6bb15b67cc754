"""msgpack encoder and decoder for the trees that flax.serialization writes.

The JAX package writes its checkpoints with `flax.serialization.msgpack_serialize`
and reads them with `msgpack_restore`. The port has neither flax nor the
`msgpack` package, so this module carries the subset of the format those two
use, in plain Python:

- nil, bool, int, float (float64; float32 is read too), str, bin, array, map;
- ext 1, an ndarray: a packed (shape, dtype name, C-order bytes) triple;
- ext 3, a numpy scalar, packed the same way as a 0-d array.

`packb(tree)` gives the same bytes as `msgpack_serialize(tree)`: the keys of
the tree's dicts in sorted order (flax copies the tree through
`jax.tree_util.tree_map`, which sorts them), the smallest int, str, bin,
array, map and ext headers, float64 for Python floats, and arrays of more
than `MAX_CHUNK_SIZE` bytes split into flax's `__msgpack_chunked_array__`
form. Types are matched exactly, as under
msgpack's `strict_types`: a numpy scalar goes to ext 3 even where it
subclasses `float`, and a tuple raises.

`unpackb(data)` gives what `msgpack_restore(data)` gives: dicts, lists and
Python scalars, numpy arrays for ext 1 (read-only views of `data`), numpy
scalars for ext 3, chunked arrays reassembled. numpy has no bfloat16, so a
bfloat16 array decodes to a `Bfloat16Array` holding its bits as uint16.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class Bfloat16Array:
    """A bfloat16 array as its raw bits (uint16, C order). `np.asarray(a)`
    gives the values as float32, which holds every bfloat16 exactly."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        if bits.dtype != np.uint16:
            raise TypeError(f"bfloat16 bits must be uint16, got {bits.dtype}")
        self.bits = bits

    @property
    def shape(self) -> tuple[int, ...]:
        return self.bits.shape

    def __array__(self, dtype=None, copy=None):
        values = (self.bits.astype(np.uint32) << 16).view(np.float32)
        return values if dtype is None else values.astype(dtype)

    def __repr__(self) -> str:
        return f"Bfloat16Array(shape={self.shape})"


# ---------------------------------------------------------------- encoding


def _pack_int(v: int, out: bytearray) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            out += struct.pack(">bi", -46, v) if v >= -(1 << 31) else struct.pack(">bq", -45, v)
        else:
            out += struct.pack(">bb", -48, v) if v >= -(1 << 7) else struct.pack(">bh", -47, v)
    elif v < (1 << 7):
        out += struct.pack(">b", v)
    elif v < (1 << 16):
        out += struct.pack(">BB", 0xCC, v) if v < (1 << 8) else struct.pack(">BH", 0xCD, v)
    elif v < (1 << 32):
        out += struct.pack(">BI", 0xCE, v)
    elif v < (1 << 64):
        out += struct.pack(">BQ", 0xCF, v)
    else:
        raise OverflowError(f"int {v} does not fit in 64 bits")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A header: the fix form (code | n) for n < fix_max, else the 8-, 16- or
    32-bit length form in `codes` (None where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < (1 << 8):
        out += struct.pack(">BB", codes[0], n)
    elif n < (1 << 16):
        out += struct.pack(">BH", codes[1], n)
    elif n < (1 << 32):
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"length {n} exceeds msgpack's 2**32 - 1")


def _pack_bin(b: bytes, out: bytearray) -> None:
    _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out += b


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_bytes(shape: tuple[int, ...], dtype_name: str, raw: bytes) -> bytes:
    """flax's `_ndarray_to_bytes`: packb((shape, dtype name, raw bytes))."""
    out = bytearray()
    out.append(0x93)
    _pack_len(len(shape), out, 0x90, 16, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(dtype_name, out)
    _pack_bin(raw, out)
    return bytes(out)


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    return _array_bytes(a.shape, a.dtype.name, a.tobytes("C"))


def _pack(obj: Any, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is str:
        _pack_str(obj, out)
    elif t is bytes or t is bytearray:
        _pack_bin(bytes(obj), out)
    elif t is dict:
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list:
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif t is Bfloat16Array:
        _pack_ext(_EXT_NDARRAY, _array_bytes(obj.bits.shape, "bfloat16",
                                             obj.bits.tobytes("C")), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _nbytes(a) -> int:
    return a.bits.nbytes if type(a) is Bfloat16Array else a.nbytes


def _chunk(a) -> dict:
    """flax's `_chunk`: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    bf16 = type(a) is Bfloat16Array
    flat = (a.bits if bf16 else a).reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / flat.dtype.itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): Bfloat16Array(c) if bf16 else c for i, c in enumerate(chunks)}}


def _sorted_copy(tree):
    """The copy `jax.tree_util.tree_map(lambda x: x, tree)` makes: every dict
    rebuilt with its keys in sorted order."""
    if type(tree) is dict:
        return {k: _sorted_copy(tree[k]) for k in sorted(tree)}
    if type(tree) is list:
        return [_sorted_copy(v) for v in tree]
    return tree


def _chunk_leaves(tree):
    """flax's `_chunk_array_leaves_in_place`: arrays over MAX_CHUNK_SIZE bytes
    at the root or as dict values (not in lists). The chunked form's keys stay
    in the order flax inserts them."""
    if isinstance(tree, (np.ndarray, Bfloat16Array)):
        return _chunk(tree) if _nbytes(tree) > MAX_CHUNK_SIZE else tree
    if type(tree) is dict:
        return {k: _chunk_leaves(v) if isinstance(v, (dict, np.ndarray, Bfloat16Array)) else v
                for k, v in tree.items()}
    return tree


def packb(tree: Any) -> bytes:
    """The bytes `flax.serialization.msgpack_serialize(tree)` writes."""
    out = bytearray()
    _pack(_chunk_leaves(_sorted_copy(tree)), out)
    return bytes(out)


# ---------------------------------------------------------------- decoding


def _dtype(name: str):
    return None if name == "bfloat16" else np.dtype(name)


class _Reader:
    def __init__(self, data) -> None:
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        self.pos = p + n
        return self.mv[p:p + n]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, raw: bool = False):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F, raw)
        if 0x90 <= c <= 0x9F:
            return [self.read(raw) for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._str(c & 0x1F, raw)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c])))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
            return self._ext(self.unpack(">b"), n)
        if c == 0xCA:
            return self.unpack(">f")
        if c == 0xCB:
            return self.unpack(">d")
        if 0xCC <= c <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[c - 0xCC])
        if 0xD4 <= c <= 0xD8:
            code = self.unpack(">b")
            return self._ext(code, 1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            return self._str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c]), raw)
        if c in (0xDC, 0xDD):
            return [self.read(raw) for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if c == 0xDE else ">I"), raw)
        raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")

    def _str(self, n: int, raw: bool):
        b = self.take(n)
        return bytes(b) if raw else str(b, "utf-8")

    def _map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.read(raw)
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"map key of type {type(k).__name__} is not str or bytes")
            out[k] = self.read(raw)
        return out

    def _ext(self, code: int, n: int):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        inner = _Reader(self.take(n))
        if inner.take(1)[0] != 0x93:
            raise ValueError("ndarray ext payload is not a 3-element array")
        shape = inner.read(raw=True)
        name = inner.read(raw=True).decode("ascii")
        c = inner.take(1)[0]
        size = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(c)
        if size is None:
            raise ValueError("ndarray ext payload holds no bin buffer")
        buf = inner.take(inner.unpack(size))
        dt = _dtype(name)
        a = np.frombuffer(buf, dtype=np.uint16 if dt is None else dt).reshape(shape)
        if code == _EXT_NPSCALAR:
            return Bfloat16Array(a) if dt is None else a[()]
        return Bfloat16Array(a) if dt is None else a


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and type(chunks[0]) is Bfloat16Array:
        return Bfloat16Array(np.concatenate([c.bits for c in chunks]).reshape(shape))
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    if type(tree) is dict:
        if CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if type(v) is dict:
                tree[k] = _unchunk_leaves(v)
    return tree


def unpackb(data) -> Any:
    """What `flax.serialization.msgpack_restore(data)` returns (bfloat16
    arrays as `Bfloat16Array`)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} bytes left after the msgpack object")
    return _unchunk_leaves(tree)
