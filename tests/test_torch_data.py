"""The port's data layer against the JAX package and PIL: the PNG decoder
byte for byte, the OSCD scan, and the decode-once cache bit for bit."""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from gan_aug_pfa_torch.data import loader as tl
from gan_aug_pfa_torch.data import png
from gan_aug_pfa_torch.data import scanner as ts
from gan_aug_pfa_tpu.data import loader as jl
from gan_aug_pfa_tpu.data import scanner as js
from torch_tmp import drop_tmp_path  # noqa: F401

SUBDIR = "Onera Satellite Change Detection Dataset"


def _pil_image(mode, rng):
    if mode == "P":
        arr = rng.randint(0, 256, (29, 41, 3), dtype=np.uint8)
        return Image.fromarray(arr, "RGB").quantize(colors=48)
    shape = {"RGB": (29, 41, 3), "L": (29, 41), "LA": (29, 41, 2),
             "RGBA": (29, 41, 4)}[mode]
    return Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8), mode)


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "LA", "RGBA"])
def test_png_decoder_matches_pil(tmp_path, mode):
    path = str(tmp_path / f"{mode}.png")
    _pil_image(mode, np.random.RandomState(len(mode))).save(path)
    with Image.open(path) as im:
        assert im.mode == mode
        want_rgb = np.asarray(im.convert("RGB"))
        want_gray = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(png.decode_rgb(path), want_rgb)
    np.testing.assert_array_equal(png.decode_gray(path), want_gray)


@pytest.mark.parametrize("channels", [1, 3])
def test_png_decoder_all_filter_types(tmp_path, channels):
    """chip_smoke.write_png cycles the five scanline filters row by row;
    PIL and the port read the same pixels back."""
    rng = np.random.RandomState(channels)
    shape = (23, 31) if channels == 1 else (23, 31, 3)
    arr = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "filters.png")
    chip_smoke.write_png(path, arr)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), arr)
        want_gray = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(
        png.decode_rgb(path), arr if channels == 3
        else np.repeat(arr[..., None], 3, axis=2))
    np.testing.assert_array_equal(png.decode_gray(path), want_gray)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack_rows(samples, depth):
    """(h, w, c) sample values -> (h, stride) packed scanline bytes: 16-bit
    samples big-endian, sub-byte ones most significant bits first, each
    row padded to a whole byte."""
    h, w, c = samples.shape
    flat = samples.reshape(h, w * c).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    shifts = np.arange(depth - 1, -1, -1, dtype=np.uint32)
    bits = ((flat[..., None] >> shifts) & 1).reshape(h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def _filter_rows(rows, bpp, first):
    """Filtered scanlines, row y with filter type (first + y) % 5."""
    h, stride = rows.shape
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:stride]
        upleft = np.concatenate([np.zeros(bpp, np.int32),
                                 prev[:-bpp]])[:stride]
        ft = (first + y) % 5
        pred = [0, left, prev, (left + prev) >> 1, None][ft]
        if ft == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(ft)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def _write_png(path, samples, depth, color_type, interlace=0, palette=None,
               trns=None):
    """A PNG of any bit depth and colour type, non-interlaced or Adam7,
    written with zlib and struct (PIL writes neither Adam7 nor every
    depth).  Each Adam7 pass starts its filter cycle at its own index, so
    all five filter types appear inside the passes; the image data is split
    over two IDAT chunks."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(
            _filter_rows(_pack_rows(samples[y0::dy, x0::dx], depth), bpp, i)
            for i, (x0, y0, dx, dy) in enumerate(_ADAM7)
            if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, 0)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    data = zlib.compress(raw, 6)
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                      0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns)
    half = len(data) // 2
    body += chunk(b"IDAT", data[:half]) + chunk(b"IDAT", data[half:])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b""))


# (colour type, bit depth, tRNS): gray, palette, RGB, gray + alpha, RGBA.
PNG_FLAVOURS = [(0, 1, None), (0, 2, b"\x00\x01"), (0, 4, None),
                (0, 8, b"\x00\x07"), (0, 16, None), (3, 1, None),
                (3, 2, b"\x80"), (3, 4, None), (3, 8, b"\x00\xff\x10"),
                (2, 8, None), (2, 16, None), (4, 8, None), (4, 16, None),
                (6, 8, None), (6, 16, None)]
# Odd widths (sub-byte rows end in padding bits) and sizes under 8 px (some
# Adam7 passes are empty).
PNG_SIZES = [(11, 13), (3, 5), (1, 1), (2, 9), (8, 8)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("flavour", PNG_FLAVOURS,
                         ids=[f"ct{c}-{d}bit" for c, d, _ in PNG_FLAVOURS])
def test_png_decoder_flavours_match_pil(tmp_path, flavour, interlace):
    """decode_rgb and decode_gray equal PIL's convert("RGB") and
    convert("L") byte for byte on every bit depth and colour type the PNG
    specification allows, non-interlaced and Adam7.  16-bit gray holds
    0, 255, 256 and 65535 (PIL clips), other 16-bit samples 0x8000 and 300
    (PIL keeps the high byte)."""
    ct, depth, trns = flavour
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ct]
    rng = np.random.RandomState(ct * 100 + depth + interlace)
    palette = None
    top = 1 << depth
    if ct == 3:  # fewer entries than indices where the depth allows it
        n = min(top, 200)
        palette = rng.randint(0, 256, (n, 3))
        top = n
    for h, w in PNG_SIZES:
        samples = rng.randint(0, top, (h, w, nch))
        if depth == 16:
            edges = [0, 255, 256, 65535] if ct == 0 else [0x8000, 300]
            samples.reshape(-1)[:len(edges)] = edges[:samples.size]
        path = str(tmp_path / f"{h}x{w}.png")
        _write_png(path, samples, depth, ct, interlace, palette, trns)
        with Image.open(path) as im:
            want_rgb = np.asarray(im.convert("RGB"))
            want_gray = np.asarray(im.convert("L"))
        got_rgb, got_gray = png.decode_rgb(path), png.decode_gray(path)
        assert got_rgb.dtype == got_gray.dtype == np.uint8
        np.testing.assert_array_equal(got_rgb, want_rgb, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(got_gray, want_gray,
                                      err_msg=f"{h}x{w}")


@pytest.mark.parametrize("kind", ["not_png", "truncated", "16bit_palette"])
def test_png_decoder_rejects_unsupported(tmp_path, kind):
    path = str(tmp_path / "bad.png")
    if kind == "not_png":
        with open(path, "wb") as f:
            f.write(b"not a png at all")
    elif kind == "16bit_palette":  # the specification forbids it
        _write_png(path, np.zeros((4, 5), np.uint16), 16, 3,
                   palette=np.zeros((4, 3)))
    else:
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:40])
    with pytest.raises(ValueError):
        png.decode_rgb(path)


def test_scan_matches_jax(oscd_tree):
    got = ts.create_sample_lists(str(oscd_tree), SUBDIR, mode="all",
                                 verbose=False)
    want = js.create_sample_lists(str(oscd_tree), SUBDIR, "synthetic_data",
                                  mode="all", verbose=False)
    assert [(s.img1, s.img2, s.label, s.city) for s in got] == [
        (s.img1, s.img2, s.label, s.city) for s in want]
    assert len(got) == 5


def test_scan_skips_unreadable_pair(tmp_path):
    root = tmp_path / "root"
    img_base = root / SUBDIR / "images" / (
        "Onera Satellite Change Detection dataset - Images")
    lbl_base = root / SUBDIR / "train_labels" / (
        "Onera Satellite Change Detection dataset - Train Labels")
    for city, broken in (("paris", False), ("pisa", True)):
        (img_base / city / "pair").mkdir(parents=True)
        (lbl_base / city / "cm").mkdir(parents=True)
        for name in ("img1.png", "img2.png"):
            chip_smoke.write_png(str(img_base / city / "pair" / name),
                                 np.zeros((8, 8, 3), np.uint8))
        chip_smoke.write_png(str(lbl_base / city / "cm" / "cm.png"),
                             np.zeros((8, 8), np.uint8))
        if broken:
            with open(img_base / city / "pair" / "img2.png", "wb") as f:
                f.write(b"garbage")
    got = ts.create_sample_lists(str(root), SUBDIR, mode="all",
                                 verbose=False)
    assert [s.city for s in got] == ["paris"]


@pytest.mark.parametrize("size", [(32, 32), (24, 40)])
def test_cache_matches_jax_bit_for_bit(oscd_tree, size):
    samples = ts.create_sample_lists(str(oscd_tree), SUBDIR, mode="all",
                                 verbose=False)
    got = tl.build_cached_dataset(samples, size, verbose=False)
    want = jl.build_cached_dataset(
        js.create_sample_lists(str(oscd_tree), SUBDIR, "synthetic_data",
                               mode="all", verbose=False),
        size, verbose=False)
    assert got.cities == want.cities
    for name in ("img1", "img2", "labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name


def test_cache_skips_failed_sample(oscd_tree, tmp_path, capsys):
    samples = ts.create_sample_lists(str(oscd_tree), SUBDIR, mode="all",
                                 verbose=False)
    missing = ts.Sample(str(tmp_path / "nope.png"), samples[0].img2,
                        samples[0].label, "ghost")
    ds = tl.build_cached_dataset(samples[:2] + [missing], (16, 16),
                                 verbose=False)
    assert len(ds) == 2 and "ghost" not in ds.cities
    assert "Failed to load sample for city ghost" in capsys.readouterr().out
    assert os.path.exists(samples[0].img1)


def _triplets(samples):
    return [(s.img1, s.img2, s.label, s.city) for s in samples]


@pytest.mark.parametrize("use_synthetic", [False, True])
@pytest.mark.parametrize("mode", ["train", "val", "test", "all"])
def test_splits_match_jax(oscd_tree, mode, use_synthetic):
    """Every mode of create_sample_lists, with and without the synthetic
    corpus (which only the train split takes)."""
    got = ts.create_sample_lists(str(oscd_tree), SUBDIR, "synthetic_data",
                                 mode=mode, use_synthetic=use_synthetic,
                                 verbose=False)
    want = js.create_sample_lists(str(oscd_tree), SUBDIR, "synthetic_data",
                                  mode=mode, use_synthetic=use_synthetic,
                                  verbose=False)
    assert _triplets(got) == _triplets(want)
    n_synth = sum(s.is_synthetic for s in got)
    assert n_synth == (4 if mode == "train" and use_synthetic else 0)
    if mode == "test":
        assert all(s.label is None for s in got)


def test_synthetic_scan_pairs_by_basename_and_skips(oscd_tree, tmp_path,
                                                    capsys):
    """A synthetic img1 without its img2 or label is skipped; a missing
    synthetic directory leaves the real train split with a warning."""
    synth = tmp_path / "synth"
    for city in ("paris", "pisa"):
        (synth / "images" / city).mkdir(parents=True)
        (synth / "labels" / city).mkdir(parents=True)
    img = np.zeros((8, 8, 3), np.uint8)
    for i in range(3):
        chip_smoke.write_png(str(synth / "images" / "paris" /
                                 f"img1_synth_{i}.png"), img)
        if i != 1:  # no img2 for sample 1
            chip_smoke.write_png(str(synth / "images" / "paris" /
                                     f"img2_synth_{i}.png"), img)
        if i != 2:  # no label for sample 2
            chip_smoke.write_png(str(synth / "labels" / "paris" /
                                     f"cm_synth_{i}.png"), img[..., 0])
    for name in ("img1_synth_0.png", "img2_synth_0.png"):
        chip_smoke.write_png(str(synth / "images" / "pisa" / name), img)
    chip_smoke.write_png(str(synth / "labels" / "pisa" / "cm_synth_0.png"),
                         img[..., 0])
    images, labels = str(synth / "images"), str(synth / "labels")
    got = ts.scan_dataset(images, labels, is_synthetic=True, verbose=False)
    want = js.scan_dataset(images, labels, is_synthetic=True, verbose=False)
    assert _triplets(got) == _triplets(want)
    assert [s.city for s in got] == ["paris_synth", "pisa_synth"]

    got = ts.create_sample_lists(str(oscd_tree), SUBDIR, "nowhere",
                                 mode="train", use_synthetic=True)
    assert "Synthetic image directory not found" in capsys.readouterr().out
    assert _triplets(got) == _triplets(js.create_sample_lists(
        str(oscd_tree), SUBDIR, "synthetic_data", mode="train",
        verbose=False))
