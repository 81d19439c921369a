"""Single-pair evaluation and its Pillow-exact resize, on the CPU.

* ``data/pil_resize``: byte-equal to Pillow's ``Image.resize`` (BICUBIC on
  RGB, NEAREST on L) over many (in -> out) sizes: up, down, non-integer
  ratios, 1-pixel sides, non-square.
* ``pipelines.evaluate_single_pair`` against the JAX package's on the
  same PNGs and weights at fp32 and 32x32: the prediction and the metrics
  within 1e-6, for a {0, 255} label (through the confusion-counts kernel's
  plain version) and a gray-valued one (float sums of products, as JAX);
  and the panel file decoding to JAX's pixels.  The JAX side runs in a
  child process: it applies the model op by op, and every op compiles,
  which this file keeps out of the test process's jaxlib.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import evaluate as tev
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch.config import DataConfig, EvalConfig
from gan_aug_pfa_torch.data.pil_resize import (
    resize_bicubic_rgb,
    resize_nearest,
)
from gan_aug_pfa_torch.models import SiameseUNet
from torch_port_helpers import jax_siamese_variables
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (32, 32)

# (in (w, h), out (w, h)): up, down, non-integer ratios both ways, 1-pixel
# sides in and out, non-square, the OSCD-like native sizes to 128x128.
RESIZE_CASES = [
    ((1, 1), (1, 1)), ((1, 1), (5, 3)), ((1, 7), (4, 1)), ((7, 1), (1, 9)),
    ((2, 2), (3, 3)), ((3, 3), (2, 2)), ((4, 4), (16, 16)),
    ((16, 16), (4, 4)), ((5, 7), (13, 11)), ((13, 11), (5, 7)),
    ((10, 10), (10, 3)), ((10, 10), (3, 10)), ((9, 6), (9, 6)),
    ((33, 17), (32, 32)), ((32, 32), (33, 17)), ((64, 48), (32, 32)),
    ((100, 100), (33, 33)), ((100, 100), (67, 67)), ((37, 53), (128, 128)),
    ((127, 129), (128, 128)), ((129, 127), (128, 128)),
    ((255, 256), (128, 128)), ((399, 200), (128, 128)),
    ((200, 399), (128, 128)), ((389, 391), (128, 128)),
    ((300, 250), (7, 5)), ((45, 37), (32, 32)), ((48, 40), (32, 32)),
    ((3, 200), (2, 128)), ((200, 3), (128, 2)), ((17, 19), (1, 1)),
    ((19, 17), (57, 51)), ((128, 128), (256, 256)), ((128, 128), (129, 127)),
    ((31, 29), (30, 31)), ((400, 1), (128, 1)), ((1, 400), (1, 128)),
]


@pytest.mark.parametrize("mode", ["bicubic_rgb", "nearest_l"])
@pytest.mark.parametrize("case", range(len(RESIZE_CASES)))
def test_resize_matches_pillow_bytes(mode, case):
    (iw, ih), (ow, oh) = RESIZE_CASES[case]
    rng = np.random.RandomState(case)
    if mode == "bicubic_rgb":
        img = rng.randint(0, 256, (ih, iw, 3)).astype(np.uint8)
        if case % 3 == 0:  # hard edges: the cubic's overshoot is clipped
            img = (img > 127).astype(np.uint8) * 255
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BICUBIC))
        got = resize_bicubic_rgb(img, (ow, oh))
    else:
        img = rng.randint(0, 256, (ih, iw)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img, mode="L").resize(
            (ow, oh), Image.NEAREST))
        got = resize_nearest(img, (ow, oh))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# The model's seed.  HEAD_SCALE spreads the logits of the test models over
# a few units, which multiplies the two frameworks' fp32 rounding of the
# features by the same factor; a head scaled by 30 keeps the
# probabilities' difference well inside 1e-6 while no probability lies
# within twice that difference of 0.5 (checked below).
WEIGHT_SEED = 2
HEAD_SCALE = 30.0
# Each case: (label kind, post_process).
CASES = {"binary": ("binary", False), "gray": ("gray", False),
         "no_label": (None, True)}

_JAX_CHILD = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from gan_aug_pfa_tpu import config as jcfg, pipelines as jp
work, pth, img1, img2 = sys.argv[1:5]
cases = json.loads(sys.argv[5])
for case, (label, post) in cases.items():
    out = os.path.join(work, "jax_" + case)
    r = jp.evaluate_single_pair(
        jcfg.DataConfig(root_dir=work),
        jcfg.EvalConfig(target_size=(32, 32), checkpoint_path=pth,
                        output_dir=out, compute_dtype="float32",
                        post_process=post),
        img1, img2, "paris", label_path=label, verbose=False)
    np.save(os.path.join(out, "pred.npy"), np.asarray(r["pred"]))
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(r.get("metrics"), f)
"""


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Non-square PNGs (45x37: the bicubic downscale runs), a {0, 255}
    label and a gray one, a .pth, and the JAX results of each case."""
    work = tmp_path_factory.mktemp("single_pair")
    rng = np.random.RandomState(0)
    paths = {}
    for name in ("img1", "img2"):
        paths[name] = str(work / f"{name}.png")
        Image.fromarray(rng.randint(0, 256, (37, 45, 3)).astype(
            np.uint8)).save(paths[name])
    paths["binary"] = str(work / "cm.png")
    Image.fromarray((rng.rand(37, 45) > 0.7).astype(np.uint8) * 255,
                    mode="L").save(paths["binary"])
    paths["gray"] = str(work / "gray.png")
    Image.fromarray(rng.randint(0, 256, (37, 45)).astype(np.uint8),
                    mode="L").save(paths["gray"])
    model = SiameseUNet()
    model.load_state_dict(ti.siamese_state_dict_from_jax(
        jax_siamese_variables(seed=WEIGHT_SEED, size=SIZE[0],
                              head_scale=HEAD_SCALE)), strict=True)
    paths["pth"] = str(work / "best_model.pth")
    tck.save_model(paths["pth"], model)
    cases = {case: (paths[label] if label else None, post)
             for case, (label, post) in CASES.items()}
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD, str(work), paths["pth"],
         paths["img1"], paths["img2"], json.dumps(cases)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with dropped(work):
        yield work, paths, cases


def _port(work, paths, case, cases, **kw):
    label, post = cases[case]
    return tp.evaluate_single_pair(
        DataConfig(root_dir=str(work)),
        EvalConfig(target_size=SIZE, checkpoint_path=paths["pth"],
                   output_dir=str(work / f"port_{case}"),
                   compute_dtype="float32", post_process=post),
        paths["img1"], paths["img2"], "paris", label_path=label,
        verbose=False, device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_pair_matches_jax(pair, case):
    work, paths, cases = pair
    got = _port(work, paths, case, cases)
    jdir = work / f"jax_{case}"
    want = np.load(jdir / "pred.npy")
    assert got["pred"].shape == want.shape == (1, *SIZE)
    if case == "no_label":  # post-processed: {0, 1} masks
        np.testing.assert_array_equal(got["pred"], want)
        assert "metrics" not in got
    else:
        dprob = float(np.abs(got["pred"] - want).max())
        assert dprob <= 1e-6
        # Pixels this close to 0.5 could flip between frameworks.
        assert float(np.abs(got["pred"] - 0.5).min()) > 2 * dprob
        assert 0.2 < float((got["pred"] > 0.5).mean()) < 0.8
        with open(jdir / "metrics.json") as f:
            jmetrics = json.load(f)
        assert list(got["metrics"]) == list(jmetrics)
        assert got["metrics"] == pytest.approx(jmetrics, rel=0, abs=1e-6)
    name = "validation_sample_paris_single_eval.png"
    np.testing.assert_array_equal(
        np.asarray(Image.open(work / f"port_{case}" / name)),
        np.asarray(Image.open(jdir / name)))


def test_gray_label_is_not_binarised(pair):
    """A gray label's metrics are JAX's float sums of products: not those
    of the label binarised at 0.5."""
    work, paths, cases = pair
    gray = _port(work, paths, "gray", cases)["metrics"]
    img = np.asarray(Image.open(paths["gray"]).resize((32, 32),
                                                      Image.NEAREST))
    binarised = str(work / "binarised.png")
    Image.fromarray((img > 127).astype(np.uint8) * 255,
                    mode="L").save(binarised)
    cases = {**cases, "binarised": (binarised, False)}
    binary = _port(work, paths, "binarised", cases)["metrics"]
    assert abs(gray["f1"] - binary["f1"]) > 1e-3


def test_single_pair_messages(pair, tmp_path, capsys):
    work, paths, cases = pair
    cfg = EvalConfig(target_size=SIZE, checkpoint_path=paths["pth"],
                     output_dir=str(tmp_path / "out"), num_visualizations=0,
                     compute_dtype="float32")
    data = DataConfig(root_dir=str(tmp_path))
    missing = str(tmp_path / "nope.png")
    assert tp.evaluate_single_pair(data, cfg, missing, paths["img2"], "x",
                                   device="cpu") is None
    assert "Error: One or both image paths not found" in (
        capsys.readouterr().out)
    r = tp.evaluate_single_pair(data, cfg, paths["img1"], paths["img2"], "x",
                                label_path=missing, device="cpu")
    out = capsys.readouterr().out
    assert f"Warning: Label path not found: {missing}" in out
    assert "metrics" not in r and r["pred"].shape == (1, *SIZE)
    r = tp.evaluate_single_pair(data, cfg, paths["img1"], paths["img2"], "x",
                                device="cpu")
    assert "No label path provided, skipping metrics calculation." in (
        capsys.readouterr().out)
    bad = EvalConfig(target_size=SIZE, checkpoint_path=missing,
                     output_dir=str(tmp_path / "out"))
    assert tp.evaluate_single_pair(data, bad, paths["img1"], paths["img2"],
                                   "x", device="cpu") is None
    assert (f"Error: Checkpoint not found at {missing}. Cannot evaluate "
            f"single pair.") in capsys.readouterr().out


def test_single_pair_reads_png_only(pair, tmp_path):
    """PIL would read a JPEG here; the port's decoder says it is not a
    PNG (ROADMAP C5)."""
    _, paths, _ = pair
    jpeg = str(tmp_path / "img1.jpg")
    Image.open(paths["img1"]).save(jpeg, format="JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        tp.evaluate_single_pair(
            DataConfig(root_dir=str(tmp_path)),
            EvalConfig(target_size=SIZE, checkpoint_path=paths["pth"]),
            jpeg, paths["img2"], "x", device="cpu")


def test_single_pair_cli(pair, tmp_path, capsys):
    """``--image1-path --image2-path --city-name [--label-path]`` runs
    single-pair evaluation with the CLI's threshold ignored (metrics at
    0.5), through the confusion counts for a {0, 255} label."""
    work, paths, cases = pair
    out = tmp_path / "cli"
    result = tev.main([
        "--root-dir", str(tmp_path), "--output-dir", str(out),
        "--checkpoint-path", paths["pth"], "--target-size", "32x32",
        "--image1-path", paths["img1"], "--image2-path", paths["img2"],
        "--city-name", "paris", "--label-path", paths["binary"],
        "--threshold", "0.3", "--compute-dtype", "float32",
        "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Evaluating single image pair for city: paris" in text
    assert "--- Metrics for paris ---" in text
    direct = _port(work, paths, "binary", cases)
    assert result["metrics"] == direct["metrics"]
    np.testing.assert_array_equal(result["pred"], direct["pred"])
    assert os.path.exists(out / "validation_sample_paris_single_eval.png")
    labels = torch.from_numpy(np.asarray(Image.open(paths["binary"]).resize(
        (32, 32), Image.NEAREST)) / 255.0).float()
    tp_ = float(((torch.from_numpy(result["pred"][0]) > 0.5).float()
                 * labels).sum())
    assert result["metrics"]["recall"] == pytest.approx(
        (tp_ + 1e-6) / (float(labels.sum()) + 1e-6), rel=1e-6)
