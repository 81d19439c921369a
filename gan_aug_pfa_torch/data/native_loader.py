"""The PNG decoder of the caches and the stream: ``data/png.py``'s chunk
parse, checks and PIL conversions, with the scanline unfilter in C (the
port's counterpart of the JAX package's ``data/native_loader.py``).

``csrc/png_decode.c`` is built with the host C compiler into
``gan_aug_pfa_torch/_build/`` at the first decode (``ops/kernels/build``),
never at import, and bound with ``ctypes.CDLL``.  A failed build or load
raises, naming the compiler's output: there is no quiet fall-back to the
numpy unfilter, which stays in ``data/png.py`` as the plain version.

Python reads the file, parses the chunks and inflates the image data with
the standard library's ``zlib``; C undoes the five scanline filters, one
call an image (one an Adam7 pass), at every bit depth.  Both ``inflate``
and a ``CDLL`` call release the GIL, so ``decode_rgb_batch`` decodes files
in parallel on a thread pool.  The output is ``data/png.py``'s, byte for
byte, and so PIL's ``convert("RGB")`` and ``convert("L")``
(tests/test_torch_native_loader.py).  A file the decoder refuses (not a
PNG, truncated, a filter byte above 4, ...) raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from . import png

NAME = "png_decode"
ABI_VERSION = 1
# Error codes of csrc/png_decode.c.
ERR_ARGS = -1
ERR_FILTER = -2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded decoder library, built on first use.  Raises if the
    build or the load fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from ..ops.kernels import build

            lib = build.load(NAME)
            lib.png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_decode_abi_version.restype = ctypes.c_int
            version = lib.png_decode_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"{NAME}: ABI version {version}, "
                                   f"expected {ABI_VERSION}")
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the decoder builds and loads here (it raises where it is
    used if not)."""
    try:
        get_lib()
    except (OSError, RuntimeError):
        return False
    return True


def unfilter(raw: np.ndarray, height: int, stride: int,
             bpp: int) -> np.ndarray:
    """``png._unfilter`` in C: ``height`` filtered scanlines of ``stride``
    bytes, each after its filter byte, into a ``(height, stride)`` uint8
    array."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data is {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    rc = get_lib().png_unfilter(raw.ctypes.data, out.ctypes.data, height,
                                stride, bpp)
    if rc == ERR_FILTER:
        ftypes = raw.reshape(height, stride + 1)[:, 0]
        raise ValueError(f"bad PNG filter type {int(ftypes.max())}")
    if rc != 0:
        raise ValueError(f"png_unfilter refused height {height}, stride "
                         f"{stride}, bpp {bpp} (error {rc})")
    return out


def decode(path: str) -> Tuple[np.ndarray, int, int, np.ndarray]:
    """``png.decode`` with the C unfilter."""
    return png.decode(path, unfilter=unfilter)


def decode_rgb(path: str) -> np.ndarray:
    """``(H, W, 3)`` uint8, as PIL's ``convert("RGB")``."""
    return png.to_rgb(*decode(path))


def decode_gray(path: str) -> np.ndarray:
    """``(H, W)`` uint8, as PIL's ``convert("L")``."""
    return png.to_gray(*decode(path))


def decode_rgb_batch(paths: List[str], workers: int = 8
                     ) -> List[np.ndarray]:
    """``decode_rgb`` of each path, in order, on ``workers`` threads."""
    get_lib()  # build once, before the threads
    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        return list(ex.map(decode_rgb, paths))


def probe(path: str) -> Optional[Tuple[int, int, int]]:
    """(height, width, channels) from the signature and the IHDR chunk
    alone, channels as the file stores them but 3 for a palette (the JAX
    package's ``probe``); None when the file does not start as a PNG."""
    with open(path, "rb") as f:
        head = f.read(33)
    if (len(head) < 33 or head[:8] != png._SIGNATURE
            or head[12:16] != b"IHDR"):
        return None
    width = int.from_bytes(head[16:20], "big")
    height = int.from_bytes(head[20:24], "big")
    ct = head[25]
    if ct not in png._CHANNELS:
        return None
    return height, width, 3 if ct == 3 else png._CHANNELS[ct]
