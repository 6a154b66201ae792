"""Model pytrees in flax's msgpack checkpoint layout, read and written here.

Counterpart of ``save_pytree``/``load_pytree`` of
``bluerov2_dynamics_tpu/utils/checkpoint.py``, which serialise through
``flax.serialization``.  The card's machine has neither flax nor
``msgpack``, so this module reads and writes the subset of msgpack that
layout uses, byte for byte as flax writes it:

* maps with string keys (nested dicts; a list or tuple is written as
  flax writes it, a map from ``"0"``, ``"1"``, ...), strings, binaries,
  nil, booleans, integers, floats and arrays;
* numpy arrays (and torch tensors, written from the host) as msgpack
  extension type 1, whose payload is itself msgpack: ``(shape, dtype
  name, C-order bytes)``; numpy scalars as extension type 3, the same
  payload at shape ``()``.

Orbax checkpoints are not ported (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    the (code, struct format, limit) ``codes`` that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _head(out, len(b), 0xa0, 32, ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16),
                                  (0xdb, ">I", 1 << 32)))
    out += b


def _pack_bin(out: bytearray, b: bytes) -> None:
    _head(out, len(b), None, 0, ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16),
                                 (0xc6, ">I", 1 << 32)))
    out += b


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _head(out, len(data), None, 0, ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16),
                                        (0xc9, ">I", 1 << 32)))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    inner = bytearray([0x93])            # a 3-array: shape, dtype name, bytes
    _head(inner, a.ndim, 0x90, 16, ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32)))
    for n in a.shape:
        _pack_int(inner, int(n))
    _pack_str(inner, a.dtype.name)
    _pack_bin(inner, a.tobytes("C"))
    return bytes(inner)


def _pack(out: bytearray, x) -> None:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if x is None:
        out.append(0xc0)
    elif x is True or x is False:
        out.append(0xc3 if x else 0xc2)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        _pack_str(out, x)
    elif isinstance(x, (bytes, bytearray)):
        _pack_bin(out, bytes(x))
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 16, ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32)))
        for k, v in x.items():
            _pack_str(out, str(k))
            _pack(out, v)
    elif isinstance(x, (list, tuple)):       # flax's state dict of a sequence
        _pack(out, {str(i): v for i, v in enumerate(x)})
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def to_bytes(tree) -> bytes:
    """``tree`` (nested dicts of arrays, tensors and plain values) in
    flax's msgpack layout."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.value() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.take(c & 0x1f).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
        if c in ints:
            v = self.num(ints[c])
            return float(v) if c in (0xca, 0xcb) else v
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I",
                0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H",
                0xc9: ">I"}
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        if c not in lens:
            raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
        n = self.num(lens[c])
        if c <= 0xc6:
            return self.take(n)
        if c <= 0xc9:
            return self.ext(n)
        if c <= 0xdb:
            return self.take(n).decode("utf-8")
        if c <= 0xdd:
            return [self.value() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.num(">b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, buf = _Reader(data).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            raise ValueError("bfloat16 arrays are not supported")
        a = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape, order="C").copy()
        return a[()] if code == _EXT_NPSCALAR else a


def _unchunk(tree):
    """flax writes an array over 2**30 bytes as a map of chunks; rejoin it."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def from_bytes(data: bytes):
    """The tree of a flax msgpack checkpoint: dicts, numpy arrays and
    plain values."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes left after the msgpack object")
    return _unchunk(tree)


def _check_like(tree, like, path="") -> None:
    if isinstance(like, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"checkpoint holds no map at {path or '/'}")
        missing = set(map(str, like)) - set(tree)
        extra = set(tree) - set(map(str, like))
        if missing or extra:
            raise ValueError(f"checkpoint keys at {path or '/'} differ: missing "
                             f"{sorted(missing)}, unexpected {sorted(extra)}")
        for k, v in like.items():
            _check_like(tree[str(k)], v, f"{path}/{k}")


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def save_pytree(path, tree) -> None:
    """Write ``tree`` to ``path`` in flax's msgpack layout (parent
    directories made), every map's keys sorted as the JAX package's
    ``save_pytree`` sorts them (its ``jax.tree.map``): the same tree gives
    the same bytes from either package."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(to_bytes(_sorted(tree)))


def load_pytree(path, like=None):
    """The tree saved at ``path`` (by this module or by flax).  With
    ``like``, its map keys must match the file's at every level, as
    ``flax.serialization.from_bytes`` requires; the values are the file's."""
    tree = from_bytes(Path(path).read_bytes())
    if like is not None:
        _check_like(tree, like)
    return tree
