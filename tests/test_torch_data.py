"""The port's data layer against the JAX package and PIL: the PNG decoder
byte for byte, the OSCD scan, and the decode-once cache bit for bit."""

import os

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from gan_aug_pfa_torch.data import loader as tl
from gan_aug_pfa_torch.data import png
from gan_aug_pfa_torch.data import scanner as ts
from gan_aug_pfa_tpu.data import loader as jl
from gan_aug_pfa_tpu.data import scanner as js

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


@pytest.mark.parametrize("kind", ["not_png", "truncated", "16bit"])
def test_png_decoder_rejects_unsupported(tmp_path, kind):
    path = str(tmp_path / "bad.png")
    if kind == "not_png":
        with open(path, "wb") as f:
            f.write(b"not a png at all")
    elif kind == "16bit":
        Image.fromarray(np.zeros((4, 5), np.uint16)).save(path)
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
