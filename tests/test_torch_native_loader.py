"""The port's C PNG decoder (``gan_aug_pfa_torch/data/native_loader.py``,
``csrc/png_decode.c``) against the plain numpy version (``data/png.py``)
and PIL, and the pooled PNG writer against the serial one.  The C
library builds with the host compiler at the first decode."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from gan_aug_pfa_torch.data import loader as tl
from gan_aug_pfa_torch.data import native_loader as nl
from gan_aug_pfa_torch.data import png
from gan_aug_pfa_torch.data import scanner as ts
from gan_aug_pfa_torch.ops.kernels import build
from test_torch_data import PNG_FLAVOURS, PNG_SIZES, _write_png
from torch_tmp import drop_tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBDIR = "Onera Satellite Change Detection Dataset"
BPPS = (1, 2, 3, 4, 6, 8)


def _filtered(rng, ftypes, stride):
    """Random filtered scanlines: each row its filter byte, then
    ``stride`` random bytes."""
    rows = rng.randint(0, 256, (len(ftypes), stride + 1)).astype(np.uint8)
    rows[:, 0] = ftypes
    return rows.reshape(-1)


@pytest.mark.parametrize("bpp", BPPS)
@pytest.mark.parametrize("ftype", range(5))
def test_c_unfilter_equals_plain(ftype, bpp):
    """Every row one filter type, at each byte distance the specification
    gives (1 for sub-byte and 8-bit gray, up to 8 for 16-bit RGBA), with
    rows of one to a few pixels (a scanline is whole pixels, or bytes of
    sub-byte samples, so its stride is a multiple of bpp)."""
    rng = np.random.RandomState(10 * ftype + bpp)
    for height, stride in ((7, 5 * bpp), (3, bpp), (1, 2 * bpp)):
        raw = _filtered(rng, [ftype] * height, stride)
        np.testing.assert_array_equal(
            nl.unfilter(raw, height, stride, bpp),
            png._unfilter(raw, height, stride, bpp),
            err_msg=f"{height}x{stride}")


def test_c_unfilter_mixed_filters():
    """Rows of random filter types, so each filter meets every other as the
    row above it."""
    rng = np.random.RandomState(5)
    for bpp in BPPS:
        height, stride = 40, 13 * bpp
        raw = _filtered(rng, rng.randint(0, 5, height), stride)
        np.testing.assert_array_equal(
            nl.unfilter(raw, height, stride, bpp),
            png._unfilter(raw, height, stride, bpp), err_msg=f"bpp {bpp}")


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("flavour", PNG_FLAVOURS,
                         ids=[f"ct{c}-{d}bit" for c, d, _ in PNG_FLAVOURS])
def test_decode_matches_pil(tmp_path, flavour, interlace):
    """decode_rgb and decode_gray give PIL's convert("RGB") and
    convert("L") bytes on every bit depth and colour type, non-interlaced
    and Adam7 (the cases of tests/test_torch_data.py)."""
    ct, depth, trns = flavour
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ct]
    rng = np.random.RandomState(ct * 100 + depth + interlace)
    palette = None
    top = 1 << depth
    if ct == 3:
        palette = rng.randint(0, 256, (min(top, 200), 3))
        top = palette.shape[0]
    for h, w in PNG_SIZES:
        samples = rng.randint(0, top, (h, w, nch))
        path = str(tmp_path / f"{h}x{w}.png")
        _write_png(path, samples, depth, ct, interlace, palette, trns)
        with Image.open(path) as im:
            want_rgb = np.asarray(im.convert("RGB"))
            want_gray = np.asarray(im.convert("L"))
        got_rgb, got_gray = nl.decode_rgb(path), nl.decode_gray(path)
        assert got_rgb.dtype == got_gray.dtype == np.uint8
        np.testing.assert_array_equal(got_rgb, want_rgb, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(got_gray, want_gray,
                                      err_msg=f"{h}x{w}")


def _chunk(kind, data):
    import struct

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


@pytest.mark.parametrize("kind", ["filter_5", "truncated_idat", "not_png"])
def test_decoder_rejects(tmp_path, kind):
    """A filter byte of 5, image data cut short and a file that is not a
    PNG each raise ValueError, as the plain decoder does."""
    import struct

    path = str(tmp_path / "bad.png")
    if kind == "not_png":
        with open(path, "wb") as f:
            f.write(b"GIF89a, not a png")
    else:
        rows = np.zeros((4, 1 + 5 * 3), np.uint8)
        rows[2, 0] = 5 if kind == "filter_5" else 1
        data = zlib.compress(rows.tobytes())
        if kind == "truncated_idat":  # the zlib stream cut short
            data = data[:-6]
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n"
                    + _chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2, 0,
                                                  0, 0))
                    + _chunk(b"IDAT", data) + _chunk(b"IEND", b""))
    for decode in (nl.decode_rgb, png.decode_rgb):
        with pytest.raises(ValueError):
            decode(path)


def test_decode_rgb_batch_equals_serial(tmp_path):
    """Eight threads decode what one does, in order; probe reads the
    header alone."""
    rng = np.random.RandomState(3)
    paths = []
    for i in range(12):
        path = str(tmp_path / f"{i}.png")
        chip_smoke.write_png(path, rng.randint(0, 256, (20 + i, 31, 3)))
        paths.append(path)
    got = nl.decode_rgb_batch(paths, workers=8)
    assert len(got) == len(paths)
    for path, arr in zip(paths, got):
        np.testing.assert_array_equal(arr, png.decode_rgb(path))
    assert nl.probe(paths[3]) == (23, 31, 3)
    with open(tmp_path / "x.png", "wb") as f:
        f.write(b"not a png")
    assert nl.probe(str(tmp_path / "x.png")) is None


def test_pooled_writer_gives_the_serial_bytes(tmp_path):
    """PngWriterPool writes write_png's bytes, file for file (and so PIL's,
    tests/test_torch_synthesis.py); a write error surfaces when the pool
    is left."""
    rng = np.random.RandomState(4)
    arrays = [rng.randint(0, 256, (37, 29, 3)).astype(np.uint8),
              (rng.rand(33, 41) > 0.7).astype(np.uint8) * 255,
              np.kron(rng.randint(0, 256, (8, 8, 3)),
                      np.ones((5, 5, 1), np.int64)).astype(np.uint8)]
    (tmp_path / "serial").mkdir()
    (tmp_path / "pool").mkdir()
    with png.PngWriterPool(workers=8, max_pending=2) as writer:
        for i in range(30):
            arr = arrays[i % 3]
            png.write_png(str(tmp_path / "serial" / f"{i}.png"), arr)
            writer.write(str(tmp_path / "pool" / f"{i}.png"), arr)
    for i in range(30):
        assert ((tmp_path / "pool" / f"{i}.png").read_bytes()
                == (tmp_path / "serial" / f"{i}.png").read_bytes())
    with pytest.raises(FileNotFoundError):
        with png.PngWriterPool() as writer:
            writer.write(str(tmp_path / "missing" / "a.png"), arrays[0])


def test_import_builds_nothing_and_a_failed_build_raises(tmp_path,
                                                         monkeypatch):
    """Importing the decoder (and every module that decodes) builds and
    loads nothing; a compiler that fails makes the first decode raise with
    the compiler's output, with no fall-back to the numpy unfilter."""
    probe = ("import sys\n"
             "import gan_aug_pfa_torch.pipelines\n"
             "from gan_aug_pfa_torch.data import native_loader as nl\n"
             "from gan_aug_pfa_torch.ops.kernels import build\n"
             "print(nl._lib is None, sorted(build._loaded))\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CC": "/nonexistent/cc"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True []"

    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\necho 'png_decode.c:1: error: broken' >&2\n"
                  "exit 1\n")
    cc.chmod(0o755)
    monkeypatch.setenv("CC", str(cc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(nl, "_lib", None)
    img = tmp_path / "a.png"
    chip_smoke.write_png(str(img), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="error: broken"):
        nl.decode_rgb(str(img))
    assert not nl.available()


def test_every_setup_path_decodes_through_c(oscd_tree, tmp_path,
                                            monkeypatch):
    """With the numpy unfilter made to fail, the scan, both cache builders
    and the stream still decode, and decode what the plain decoder gives:
    none of them goes through png._unfilter."""
    root = str(oscd_tree)
    samples = ts.create_sample_lists(root, SUBDIR, mode="train",
                                     verbose=False)
    arr = png.decode_rgb(samples[0].img1)

    def refuse(*args):
        raise AssertionError("the numpy unfilter ran")

    monkeypatch.setattr(png, "_unfilter", refuse)
    again = ts.create_sample_lists(root, SUBDIR, mode="train",
                                   verbose=False)
    assert again == samples
    np.testing.assert_array_equal(nl.decode_rgb(samples[0].img1), arr)
    ds = tl.build_cached_dataset(samples, (32, 32), verbose=False)
    assert len(ds) == len(samples)
    native = tl.build_padded_native_dataset(samples, verbose=False)
    assert len(native) == len(samples)
    from gan_aug_pfa_torch.data.stream import StreamingSource

    src = StreamingSource(samples, (32, 32), cache="decode", verbose=False)
    try:
        img1, _, _ = src.batch(np.array([0]))
    finally:
        src.close()
    np.testing.assert_array_equal(img1[0], ds.img1[0])
    with pytest.raises(AssertionError, match="numpy unfilter"):
        png.decode_rgb(samples[0].img1)
