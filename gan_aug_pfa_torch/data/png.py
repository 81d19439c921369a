"""PNG decoder and writer on the standard library's ``zlib`` and numpy.

Decodes the files that evaluation and training read without PIL: every
combination of bit depth and colour type that the PNG specification
allows (gray at 1, 2, 4, 8 and 16 bits, palette at 1, 2, 4 and 8, RGB,
gray + alpha and RGBA at 8 and 16), non-interlaced or Adam7-interlaced,
all five scanline filters.  ``decode_rgb`` and ``decode_gray`` give the
bytes of PIL's ``convert("RGB")`` and ``convert("L")`` (checked against
Pillow 12.1.0 by tests/test_torch_data.py):

* alpha and ``tRNS`` are dropped;
* gray from colour is PIL's ITU-R 601-2 integer luma
  ``(r*19595 + g*38470 + b*7471 + 0x8000) >> 16``;
* gray at 1, 2 and 4 bits is scaled to 8 (x255, x85, x17); palette
  indices at those depths are not, they index the PLTE;
* 16-bit gray (PIL's mode ``I;16``) is clipped to 255, so 256 and 65535
  both give 255; 16-bit RGB, RGBA and gray + alpha give the high byte of
  each sample.

Anything else raises ``ValueError``: a file that is not a PNG, truncated
or corrupt data, a palette index past the PLTE, and combinations the
specification forbids (a 16-bit palette, 1-bit RGB, ...).  The JAX
package's loader falls back to PIL on a file its own decoder refuses, so
it also reads formats other than PNG; this decoder does not.  CRCs are not
checked.

``write_png`` writes 8-bit gray (H, W) and RGB (H, W, 3) arrays the way
Pillow 12.1.0's ``Image.fromarray(a).save(path)`` does, and the files are
byte-identical to PIL's (tests/test_torch_synthesis.py): PIL's per-row
filter choice (the filtered row with the least sum of bytes read as signed
magnitudes, trying None, Up, Sub and Paeth in that order and keeping the
first of equals; Average is tried only under PIL's ``optimize``), zlib
level 6 with memLevel 9 and the ``Z_FILTERED`` strategy, and IDAT chunks
of max(65536, 4 * width) bytes, as PIL's encoder hands them out.

Unfiltering works on runs of rows with the same filter: None and Sub runs
in one numpy step each, Up runs as a cumulative sum down the run, and
Average/Paeth rows one by one (each byte depends on its left neighbour
after decoding).  An interlaced file is seven sub-images, one for each
Adam7 pass, each with its own filter rows; they are unfiltered in turn
and scattered into the full image.

This module is the plain version.  The scanner, the caches, the stream
and single-pair evaluation decode through ``data/native_loader.py``, which
runs this module's parse and conversions with the unfilter in C
(``csrc/png_decode.c``).
"""

from __future__ import annotations

import collections
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# The bit depths the specification allows for each colour type.
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _read_chunks(data: bytes) -> Tuple[dict, bytes, bytes]:
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, idat, plte = 8, None, [], b""
    while pos + 8 <= len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        ctype = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError("truncated PNG chunk")
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            if length < 13:
                raise ValueError("short IHDR")
            ihdr = {
                "width": int.from_bytes(body[0:4], "big"),
                "height": int.from_bytes(body[4:8], "big"),
                "bit_depth": body[8],
                "color_type": body[9],
                "compression": body[10],
                "filter": body[11],
                "interlace": body[12],
            }
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    return ihdr, b"".join(idat), plte


def _unfilter_average(src: np.ndarray, up: np.ndarray, bpp: int) -> bytes:
    out = bytearray(src.tobytes())
    prev = up.tobytes()
    for x in range(bpp):
        out[x] = (out[x] + (prev[x] >> 1)) & 0xFF
    for x in range(bpp, len(out)):
        out[x] = (out[x] + ((out[x - bpp] + prev[x]) >> 1)) & 0xFF
    return bytes(out)


def _unfilter_paeth(src: np.ndarray, up: np.ndarray, bpp: int) -> bytes:
    out = bytearray(src.tobytes())
    prev = up.tobytes()
    for x in range(bpp):  # a = c = 0: the predictor is b
        out[x] = (out[x] + prev[x]) & 0xFF
    for x in range(bpp, len(out)):
        a, b, c = out[x - bpp], prev[x], prev[x - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[x] = (out[x] + pred) & 0xFF
    return bytes(out)


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    ftypes = rows[:, 0]
    src = rows[:, 1:]
    if ftypes.size and ftypes.max() > 4:
        raise ValueError(f"bad PNG filter type {int(ftypes.max())}")
    img = np.empty((height, stride), np.uint8)
    zero = np.zeros(stride, np.uint8)
    y = 0
    while y < height:
        ft = ftypes[y]
        end = y + 1
        while end < height and ftypes[end] == ft:
            end += 1
        run = src[y:end]
        prev = img[y - 1] if y else zero
        if ft == 0:  # None
            img[y:end] = run
        elif ft == 1:  # Sub: running sum over pixels, per channel
            img[y:end] = np.cumsum(
                run.reshape(end - y, -1, bpp), axis=1, dtype=np.uint8
            ).reshape(end - y, stride)
        elif ft == 2:  # Up: running sum down the run from the row above
            img[y:end] = np.cumsum(run, axis=0, dtype=np.uint8) + prev
        else:
            fn = _unfilter_average if ft == 3 else _unfilter_paeth
            for r in range(y, end):
                img[r] = np.frombuffer(
                    fn(src[r], img[r - 1] if r else zero, bpp), np.uint8
                )
        y = end
    return img


def _stride(width: int, nch: int, depth: int) -> int:
    """Bytes of one scanline without its filter byte."""
    return (width * nch * depth + 7) // 8


def _samples(rows: np.ndarray, width: int, nch: int,
             depth: int) -> np.ndarray:
    """Unfiltered scanlines (H, stride) -> (H, W, C) samples: uint16 at 16
    bits (big-endian in the file), else uint8; sub-byte samples unpacked
    most significant bits first, each row's padding bits dropped."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, nch)
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1)[:, :width * nch]
    return rows.reshape(h, width, nch)


def _passes(width: int, height: int):
    """(x0, y0, dx, dy, pass width, pass height) of every non-empty Adam7
    pass."""
    for x0, y0, dx, dy in _ADAM7:
        pw = -(-(width - x0) // dx) if width > x0 else 0
        ph = -(-(height - y0) // dy) if height > y0 else 0
        if pw and ph:
            yield x0, y0, dx, dy, pw, ph


def decode(path: str, unfilter=None
           ) -> Tuple[np.ndarray, int, int, np.ndarray]:
    """Decode to the file's own channels and samples: ``(H, W, C)`` uint8
    (uint16 at bit depth 16; gray and palette samples at 1, 2 and 4 bits as
    they are, not scaled), the colour type, the bit depth, and the
    ``(entries, 3)`` palette (empty unless colour type 3).

    ``unfilter(raw, height, stride, bpp)`` undoes the scanline filters of
    one image or Adam7 pass (``raw``: uint8, ``height * (stride + 1)``
    bytes) into a ``(height, stride)`` uint8 array; ``_unfilter`` (numpy)
    by default, ``native_loader``'s C function on the main path."""
    unfilter = unfilter or _unfilter
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat, plte = _read_chunks(data)
    ct, depth = ihdr["color_type"], ihdr["bit_depth"]
    h, w = ihdr["height"], ihdr["width"]
    if (depth not in _DEPTHS.get(ct, ()) or ihdr["interlace"] not in (0, 1)
            or ihdr["compression"] or ihdr["filter"] or not h or not w):
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ct}, "
            f"interlace {ihdr['interlace']}, {w}x{h})"
        )
    nch = _CHANNELS[ct]
    palette = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)
    if ct == 3 and palette.size == 0:
        raise ValueError("palette PNG without PLTE")
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    bpp = max(1, nch * depth // 8)
    if ihdr["interlace"] == 0:
        stride = _stride(w, nch, depth)
        if raw.size != h * (stride + 1):
            raise ValueError(f"PNG image data is {raw.size} bytes, expected "
                             f"{h * (stride + 1)}")
        img = unfilter(raw, h, stride, bpp)
        if depth == 8:
            return img.reshape(h, w, nch), ct, depth, palette
        return _samples(img, w, nch, depth), ct, depth, palette
    passes = list(_passes(w, h))
    sizes = [ph * (_stride(pw, nch, depth) + 1) for *_, pw, ph in passes]
    if raw.size != sum(sizes):
        raise ValueError(f"PNG image data is {raw.size} bytes, expected "
                         f"{sum(sizes)}")
    img = np.empty((h, w, nch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
        rows = unfilter(raw[pos:pos + size], ph, _stride(pw, nch, depth),
                        bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, nch, depth)
        pos += size
    return img, ct, depth, palette


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _palette_lookup(idx: np.ndarray, palette: np.ndarray) -> np.ndarray:
    if idx.size and int(idx.max()) >= palette.shape[0]:
        raise ValueError("palette index out of range")
    return palette[idx]


def _to_8bit(img: np.ndarray, ct: int, depth: int) -> np.ndarray:
    """Samples as PIL opens them, in 8 bits: 16-bit gray clipped, other
    16-bit samples' high byte, sub-byte gray scaled; palette indices and
    8-bit samples unchanged."""
    if depth == 16:
        if ct == 0:
            return np.minimum(img, 255).astype(np.uint8)
        return (img >> 8).astype(np.uint8)
    if depth < 8 and ct == 0:
        return img * np.uint8(255 // ((1 << depth) - 1))
    return img


def to_rgb(img: np.ndarray, ct: int, depth: int,
           palette: np.ndarray) -> np.ndarray:
    """``decode``'s result as ``(H, W, 3)`` uint8, as PIL's
    ``convert("RGB")``."""
    if depth != 8:
        img = _to_8bit(img, ct, depth)
    if ct == 2:
        return img
    if ct == 6:
        return np.ascontiguousarray(img[..., :3])
    if ct == 3:
        return _palette_lookup(img[..., 0], palette)
    return np.repeat(img[..., :1], 3, axis=2)  # gray, gray + alpha


def to_gray(img: np.ndarray, ct: int, depth: int,
            palette: np.ndarray) -> np.ndarray:
    """``decode``'s result as ``(H, W)`` uint8, as PIL's
    ``convert("L")``."""
    if depth != 8:
        img = _to_8bit(img, ct, depth)
    if ct in (0, 4):
        return np.ascontiguousarray(img[..., 0])
    if ct == 3:
        return _luma(_palette_lookup(img[..., 0], palette))
    return _luma(img)


def decode_rgb(path: str) -> np.ndarray:
    """``(H, W, 3)`` uint8, as PIL's ``convert("RGB")``."""
    return to_rgb(*decode(path))


def decode_gray(path: str) -> np.ndarray:
    """``(H, W)`` uint8, as PIL's ``convert("L")``."""
    return to_gray(*decode(path))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PIL's filter choice for each scanline: every candidate is computed
    from the raw rows at once, then each row keeps the first of None, Up,
    Sub, Paeth with the least sum of min(v, 256 - v) over its bytes.
    Returns (H, 1 + stride) uint8, the filter byte first."""
    r = rows.astype(np.int16)
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    left = np.zeros_like(r)
    left[:, bpp:] = r[:, :-bpp]
    upleft = np.zeros_like(r)
    upleft[1:, bpp:] = r[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    best = rows
    ftype = np.zeros(rows.shape[0], np.uint8)
    score = np.minimum(rows, 256 - rows.astype(np.int32)).sum(axis=1)
    for code, pred in ((2, up), (1, left), (4, paeth)):
        cand = ((r - pred) & 0xFF).astype(np.uint8)
        s = np.minimum(cand, 256 - cand.astype(np.int32)).sum(axis=1)
        better = s < score
        best = np.where(better[:, None], cand, best)
        ftype = np.where(better, np.uint8(code), ftype)
        score = np.where(better, s, score)
    return np.concatenate([ftype[:, None], best], axis=1)


def encode_png(arr: np.ndarray) -> bytes:
    """The PNG file of an 8-bit gray (H, W) or RGB (H, W, 3) array."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    if not h or not w:
        raise ValueError(f"empty image {arr.shape}")
    bpp = 1 if arr.ndim == 2 else 3
    raw = _filter_rows(arr.reshape(h, w * bpp), bpp)
    comp = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = comp.compress(raw.tobytes()) + comp.flush()
    block = max(65536, 4 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return b"".join([_SIGNATURE, _chunk(b"IHDR", ihdr),
                     *(_chunk(b"IDAT", data[i:i + block])
                       for i in range(0, len(data), block)),
                     _chunk(b"IEND", b"")])


def write_png(path: str, arr: np.ndarray) -> None:
    """Write ``encode_png(arr)`` to ``path``."""
    data = encode_png(arr)
    with open(path, "wb") as f:
        f.write(data)


class PngWriterPool:
    """``write_png`` on a pool of ``workers`` threads (zlib's deflate and
    the file write release the GIL), with at most ``max_pending`` writes
    queued or running: ``write`` waits for the oldest one beyond that, so
    host memory does not grow with the corpus.  Used as a context manager:
    leaving it waits for every write and raises the first write error
    (``future.result()``); on an error inside the block it still waits for
    the writes in flight, and the block's error propagates.  The files are
    ``write_png``'s, byte for byte."""

    def __init__(self, workers: int = 8, max_pending: int = 64):
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers))
        self._pending = collections.deque()
        self._max = max(1, max_pending)

    def write(self, path: str, arr: np.ndarray) -> None:
        """Queue ``write_png(path, arr)``; ``arr`` must not change
        afterwards."""
        while len(self._pending) >= self._max:
            self._pending.popleft().result()
        self._pending.append(self._pool.submit(write_png, path, arr))

    def __enter__(self) -> "PngWriterPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                while self._pending:
                    self._pending.popleft().result()
        finally:
            self._pool.shutdown(wait=True)
