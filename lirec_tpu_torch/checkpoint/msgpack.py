"""A msgpack decoder and encoder for the JAX package's checkpoint files, in
plain Python.

``unpackb`` decodes one msgpack object (every family of the spec: nil,
bool, the positive and negative fixints, int8-64 and uint8-64, float32/64,
fixstr/str8-32, bin8-32, fixarray/array16-32, fixmap/map16-32 and
fixext/ext8-32) as ``msgpack.unpackb(data, raw=False)`` does: arrays become
lists, str is decoded as UTF-8, bin stays bytes, map keys must be str or
bytes, and each ext goes to ``ext_hook(code, data)``.

``msgpack_restore`` decodes a file of ``flax.serialization.to_bytes`` as
``flax.serialization.msgpack_restore`` does, with flax's extension types
(``flax/serialization.py``): 1 = ndarray, payload ``packb((shape,
dtype name, C-order bytes))``; 2 = complex, payload ``packb((real,
imag))``; 3 = numpy scalar, an ndarray payload of shape (). It refuses by
name what it cannot decode exactly: flax's chunked arrays (leaves over
2**30 bytes), an unknown ext code, and a dtype name that is not one of
numpy's built-in numeric types (``bfloat16`` needs ml_dtypes).

``packb`` encodes one object as ``msgpack.packb(obj, strict_types=True)``
does (use_bin_type, float64 floats, the smallest header of each family):
None, bool, int, float, str, bytes, lists and dicts of them, each by its
exact type. ``to_bytes`` encodes a state dict as
``flax.serialization.to_bytes`` does (the JAX package's checkpoint files):
dicts in their own key order, numpy arrays as ext 1, numpy scalars
(np.float64 too, which subclasses float) as ext 3 and complex as ext 2.
``msgpack_serialize`` is ``flax.serialization.msgpack_serialize``: the
same, with every dict's keys sorted (flax copies the tree through
jax.tree_util first). The same tree gives flax's bytes. A tuple is not
encoded (flax's state dicts hold none), nor an array over 2**30 bytes
(flax would chunk it, and ``msgpack_restore`` refuses chunked arrays).

Neither the ``msgpack`` nor the ``flax`` package is imported: the port
reads and writes these files where neither is installed.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional

import numpy as np

__all__ = ["unpackb", "msgpack_restore", "packb", "to_bytes",
           "msgpack_serialize", "MsgpackError"]

# numpy's built-in numeric dtypes, by the names flax writes (dtype.name)
_NUMPY_DTYPES = {np.dtype(c).name for c in "?bBhHiIlLqQefdFD"}
_CHUNKED = "__msgpack_chunked_array__"
_FIXED = {  # code -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
# code -> (kind, bytes of its length field)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_MAX_LEAF_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE
# (lowest, highest, struct format with its code byte), in msgpack's order
_INT_FORMATS = (
    (0, 0x7F, ">B"), (-0x20, -1, ">b"), (0x80, 0xFF, ">BB", 0xCC),
    (-0x80, -1, ">Bb", 0xD0), (0x100, 0xFFFF, ">BH", 0xCD),
    (-0x8000, -1, ">Bh", 0xD1), (0x10000, 0xFFFFFFFF, ">BI", 0xCE),
    (-0x80000000, -1, ">Bi", 0xD2), (0x100000000, 2 ** 64 - 1, ">BQ", 0xCF),
    (-2 ** 63, -1, ">Bq", 0xD3),
)
# family -> (code of the 1-byte-length form or None, 2-byte, 4-byte);
# fixstr/fixarray/fixmap are handled apart
_HEADERS = {"str": (0xD9, 0xDA, 0xDB), "bin": (0xC4, 0xC5, 0xC6),
            "array": (None, 0xDC, 0xDD), "map": (None, 0xDE, 0xDF),
            "ext": (0xC7, 0xC8, 0xC9)}
_FIX = {"str": (0xA0, 0x1F), "array": (0x90, 0x0F), "map": (0x80, 0x0F)}
_FIXEXT_CODES = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


class MsgpackError(ValueError):
    """Bytes this decoder cannot turn into the object they encode."""


class _Reader:
    def __init__(self, data, ext_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError("truncated msgpack data at byte %d"
                               % self.pos)
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self) -> Any:
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if code <= 0x8F:
            return self.map(code & 0x0F)
        if code <= 0x9F:
            return [self.obj() for _ in range(code & 0x0F)]
        if code <= 0xBF:
            return self.text(code & 0x1F)
        if code in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[code]
        if code in _FIXED:
            return self.unpack(*_FIXED[code])
        if code in _FIXEXT:
            return self.ext(_FIXEXT[code])
        if code not in _SIZED:
            raise MsgpackError("byte 0x%02x at %d starts no msgpack object"
                               % (code, self.pos - 1))
        kind, width = _SIZED[code]
        n = self.unpack(_LENGTH[width], width)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.text(n)
        if kind == "array":
            return [self.obj() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                raise MsgpackError("map key %r is not str or bytes" % (key,))
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b", 1)
        data = bytes(self.take(n))
        if self.ext_hook is None:
            raise MsgpackError("msgpack ext type %d and no ext_hook" % code)
        return self.ext_hook(code, data)


def unpackb(data: bytes,
            ext_hook: Optional[Callable[[int, bytes], Any]] = None) -> Any:
    """Decode one msgpack object that fills `data`."""
    reader = _Reader(data, ext_hook)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise MsgpackError("%d bytes after the msgpack object"
                           % (len(reader.data) - reader.pos))
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buffer = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _NUMPY_DTYPES:
        raise MsgpackError(
            "array dtype %r is not a numpy built-in dtype; this reader "
            "does not decode it" % name)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _flax_ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    raise MsgpackError("unknown msgpack ext code %d: flax writes 1 "
                       "(ndarray), 2 (complex) and 3 (numpy scalar)" % code)


def _refuse_chunked(tree) -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise MsgpackError(
                "flax chunked array (%s, a leaf over 2**30 bytes): not "
                "decoded by this reader" % _CHUNKED)
        for value in tree.values():
            _refuse_chunked(value)


def msgpack_restore(data: bytes) -> Any:
    """The tree of ``flax.serialization.msgpack_restore(data)``: dicts,
    lists and Python scalars, numpy arrays (read-only views of `data`'s
    bytes, as flax gives them) and numpy scalars."""
    tree = unpackb(data, ext_hook=_flax_ext)
    _refuse_chunked(tree)
    return tree


def _header(out: list, family: str, n: int) -> None:
    """The smallest header msgpack writes for `n` items / bytes."""
    if family in _FIX and n <= _FIX[family][1]:
        out.append(bytes([_FIX[family][0] + n]))
        return
    one, two, four = _HEADERS[family]
    if one is not None and n <= 0xFF:
        out.append(struct.pack(">BB", one, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", two, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", four, n))
    else:
        raise ValueError("msgpack %s of %d is too large" % (family, n))


def _int(out: list, value: int) -> None:
    for fmt in _INT_FORMATS:
        low, high, pattern = fmt[:3]
        if low <= value <= high:
            out.append(struct.pack(pattern, *fmt[3:], value))
            return
    raise OverflowError("Integer value out of range")


def _ext(out: list, code: int, data: bytes) -> None:
    if len(data) in _FIXEXT_CODES:
        out.append(bytes([_FIXEXT_CODES[len(data)]]))
    else:
        _header(out, "ext", len(data))
    out.append(struct.pack("b", code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ndarray payload: packb((shape, dtype name, C-order bytes))."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes are not encoded")
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise MsgpackError(
            "array of %d bytes: flax chunks leaves over 2**30 bytes, and "
            "this encoder does not" % arr.nbytes)
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: list, obj: Any, flax_ext: bool, sort_keys: bool) -> None:
    kind = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif kind is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif kind is int:
        _int(out, obj)
    elif kind in (bytes, bytearray):
        _header(out, "bin", len(obj))
        out.append(bytes(obj))
    elif kind is str:
        data = obj.encode("utf-8")
        _header(out, "str", len(data))
        out.append(data)
    elif kind is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif kind is list:
        _header(out, "array", len(obj))
        for item in obj:
            _pack(out, item, flax_ext, sort_keys)
    elif kind is dict:
        _header(out, "map", len(obj))
        items = sorted(obj.items(), key=lambda kv: kv[0]) if sort_keys \
            else obj.items()
        for key, value in items:
            _pack(out, key, flax_ext, sort_keys)
            _pack(out, value, flax_ext, sort_keys)
    elif flax_ext and isinstance(obj, np.ndarray):
        _ext(out, 1, _ndarray_bytes(obj))
    elif flax_ext and isinstance(obj, np.generic):
        _ext(out, 3, _ndarray_bytes(np.asarray(obj)))
    elif flax_ext and kind is complex:
        _ext(out, 2, packb([obj.real, obj.imag]))
    else:
        raise TypeError("Cannot serialize %r" % (obj,))


def packb(obj: Any) -> bytes:
    """The bytes of ``msgpack.packb(obj, strict_types=True)``."""
    out: list = []
    _pack(out, obj, flax_ext=False, sort_keys=False)
    return b"".join(out)


def to_bytes(tree: Any) -> bytes:
    """The bytes of ``flax.serialization.to_bytes(tree)`` for a state dict
    of dicts, lists, Python scalars, numpy arrays (each at most 2**30
    bytes), numpy scalars and complex numbers."""
    out: list = []
    _pack(out, tree, flax_ext=True, sort_keys=False)
    return b"".join(out)


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree)``: those
    of ``to_bytes`` with every dict's keys sorted."""
    out: list = []
    _pack(out, tree, flax_ext=True, sort_keys=True)
    return b"".join(out)
