"""PNG decoder on the standard library's ``zlib`` and numpy.

Decodes the files that evaluation reads without PIL.  Supported: bit depth
8, colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and
6 (RGBA), non-interlaced, all five scanline filters.  Anything else raises
``ValueError``.  Conversions give the same bytes as PIL's
``convert("RGB")`` and ``convert("L")``: alpha is dropped, and gray from
colour uses PIL's ITU-R 601-2 integer luma
``(r*19595 + g*38470 + b*7471 + 0x8000) >> 16``.  CRCs are not checked.

Unfiltering works on runs of rows with the same filter: None and Sub runs
in one numpy step each, Up runs as a cumulative sum down the run, and
Average/Paeth rows one by one (each byte depends on its left neighbour
after decoding).
"""

from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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


def decode(path: str) -> Tuple[np.ndarray, int, np.ndarray]:
    """Decode to the file's own channels: ``(H, W, C)`` uint8, the colour
    type, and the ``(entries, 3)`` palette (empty unless colour type 3)."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat, plte = _read_chunks(data)
    ct = ihdr["color_type"]
    if ihdr["bit_depth"] != 8 or ihdr["interlace"] != 0 or ct not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {ihdr['bit_depth']}, colour type "
            f"{ct}, interlace {ihdr['interlace']})"
        )
    h, w, nch = ihdr["height"], ihdr["width"], _CHANNELS[ct]
    palette = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)
    if ct == 3 and palette.size == 0:
        raise ValueError("palette PNG without PLTE")
    stride = w * nch
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    if raw.size != h * (stride + 1):
        raise ValueError(
            f"PNG image data is {raw.size} bytes, expected {h * (stride + 1)}"
        )
    img = _unfilter(raw, h, stride, nch).reshape(h, w, nch)
    return img, ct, palette


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _palette_lookup(idx: np.ndarray, palette: np.ndarray) -> np.ndarray:
    if idx.size and int(idx.max()) >= palette.shape[0]:
        raise ValueError("palette index out of range")
    return palette[idx]


def decode_rgb(path: str) -> np.ndarray:
    """``(H, W, 3)`` uint8, as PIL's ``convert("RGB")``."""
    img, ct, palette = decode(path)
    if ct == 2:
        return img
    if ct == 6:
        return np.ascontiguousarray(img[..., :3])
    if ct == 3:
        return _palette_lookup(img[..., 0], palette)
    return np.repeat(img[..., :1], 3, axis=2)  # gray, gray + alpha


def decode_gray(path: str) -> np.ndarray:
    """``(H, W)`` uint8, as PIL's ``convert("L")``."""
    img, ct, palette = decode(path)
    if ct in (0, 4):
        return np.ascontiguousarray(img[..., 0])
    if ct == 3:
        return _luma(_palette_lookup(img[..., 0], palette))
    return _luma(img)
