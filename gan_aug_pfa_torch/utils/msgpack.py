"""A reader of flax's ``.msgpack`` checkpoints, without the ``msgpack`` or
``flax`` packages (the card's machine has neither).

``unpackb(data)`` decodes the MessagePack format: nil, bool, every int
(positive and negative fixint, int/uint 8 to 64), float32 and float64,
str (fixstr, str8/16/32, UTF-8), bin (bin8/16/32, as ``bytes``), arrays
(fixarray, array16/32, as lists), maps (fixmap, map16/32, as dicts) and
ext (fixext 1-16, ext8/16/32), as ``msgpack.unpackb`` with its defaults
does.  An ext becomes ``ExtType(code, data)`` unless an ``ext_hook`` maps
it.

``restore(data)`` is flax's ``msgpack_restore``: flax's ext codes
(``flax/serialization.py`` ``_MsgpackExtType``) become values --

  1 ``ndarray``: a packed ``(shape, dtype name, C-order bytes)``, as a
    numpy array that views the input without a copy (read-only), or for
    ``bfloat16``, which numpy lacks, a ``torch.bfloat16`` tensor;
  2 native complex: a packed ``(real, imag)``, as ``complex``;
  3 numpy scalar: an ndarray ext of shape (), as a numpy scalar (a 0-dim
    ``torch.bfloat16`` tensor for bfloat16) --

and the dicts flax writes for arrays above 2**30 bytes,
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``,
are put back together.  flax writes tuples and lists as dicts keyed "0",
"1", ..., and dict keys as strings.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_FIXED = {  # type byte -> (struct format, size) of int and float payloads
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class ExtType(NamedTuple):
    """An ext value no hook mapped (``msgpack.ExtType``'s fields)."""

    code: int
    data: bytes


class _Decoder:
    """One pass over ``buf``.  ``views``: bin payloads as memoryview slices
    of the input (no copy) instead of ``bytes``."""

    def __init__(self, buf, ext_hook: Optional[Callable] = None,
                 views: bool = False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.ext_hook = ext_hook
        self.views = views

    def _take(self, n: int) -> memoryview:
        start = self.pos
        end = start + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated input at byte {start}")
        self.pos = end
        return self.buf[start:end]

    def _length(self, size: int) -> int:
        return struct.unpack(_LEN[size], self._take(size))[0]

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _bin(self, n: int):
        v = self._take(n)
        return v if self.views else v.tobytes()

    def _array(self, n: int) -> list:
        return [self.decode() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.decode()
            out[k] = self.decode()
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        data = self._take(n)
        if self.ext_hook is not None:
            return self.ext_hook(code, data)
        return ExtType(code, data.tobytes())

    def decode(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return self._array(b & 0x0F)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self._take(size))[0]
        if 0xC4 <= b <= 0xC6:
            return self._bin(self._length(1 << (b - 0xC4)))
        if 0xC7 <= b <= 0xC9:
            return self._ext(self._length(1 << (b - 0xC7)))
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self._str(self._length(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self._array(self._length(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self._map(self._length(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: invalid type byte 0x{b:02x} at byte "
                         f"{self.pos - 1}")


def unpackb(data, ext_hook: Optional[Callable] = None) -> Any:
    """Decode one MessagePack object that fills ``data`` (bytes-like).
    ``ext_hook(code, data)`` maps an ext (``data`` a memoryview of the
    input)."""
    dec = _Decoder(data, ext_hook)
    out = dec.decode()
    if dec.pos != len(dec.buf):
        raise ValueError(f"msgpack: {len(dec.buf) - dec.pos} extra bytes "
                         "after the object")
    return out


def _ndarray(data):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, buffer)."""
    dec = _Decoder(data, views=True)
    shape, name, buf = dec.decode()
    if isinstance(name, (bytes, memoryview)):
        name = bytes(name).decode()
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _flax_ext(code: int, data):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    return ExtType(code, data.tobytes())


def _indexed(d: dict) -> list:
    """flax's tuple-as-dict ``{"0": a, "1": b, ...}`` as a list."""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree):
    """Put flax's chunked arrays back together, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(_indexed(tree["shape"]))
        chunks = _indexed(tree["chunks"])
        if chunks and isinstance(chunks[0], torch.Tensor):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data) -> Any:
    """flax's ``msgpack_restore`` of ``data`` (bytes-like): nested dicts
    with numpy (or, for bfloat16, torch) array leaves."""
    return _unchunk(unpackb(data, ext_hook=_flax_ext))
