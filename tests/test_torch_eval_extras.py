"""The port's evaluation extras against the JAX package's, on the CPU at
fp32 and 32x32 on the ``oscd_tree`` fixture: the threshold sweep (with
and without post-processing, where every threshold ties), the ensemble of
a ``.pth`` and a JAX ``.msgpack``, the morphology, the sweep's float32
threshold comparison at its boundaries, and the evaluation panels.

Reports, ``threshold_sweep.json`` and per-city metrics agree within 1e-6
with the same best threshold; masks and counts exactly; panel files
decode to JAX's pixels."""

import ctypes
import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import evaluate as tev
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import metrics as tm
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch.config import DataConfig, EvalConfig
from gan_aug_pfa_torch.data.loader import build_cached_dataset
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.ops import morphology as tmorph
from gan_aug_pfa_torch.ops.kernels.confusion_counts import (
    confusion_counts_batch_reference,
)
from gan_aug_pfa_tpu import checkpoint as jck
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import metrics as jm
from gan_aug_pfa_tpu import pipelines as jp
from gan_aug_pfa_tpu.ops import morphology as jmorph
from torch_port_helpers import jax_siamese_logits, jax_siamese_variables
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

SIZE = (32, 32)
SUBDIR = "Onera Satellite Change Detection Dataset"
# The .pth model's seed and the .msgpack model's.  At 32x32 the two
# frameworks' fp32 probabilities differ by up to about 5e-6; with these
# weights no probability of the first model, or of the pair's mean, lies
# within twice that difference of a threshold of the cases on oscd_tree
# (checked below), so no pixel can flip between frameworks.
PTH_SEED, MSGPACK_SEED = 5, 10

# Each case: the EvalConfig fields of both sides' runs.
CASES = {
    "sweep": dict(threshold_sweep=True, num_visualizations=2),
    "post_process": dict(threshold_sweep=True, post_process=True,
                         post_process_kernel=4),
    "ensemble": dict(threshold_sweep=True, threshold=0.35),
}


@pytest.fixture(scope="module")
def setup(oscd_tree, tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_eval_extras")
    pth_vars = jax_siamese_variables(seed=PTH_SEED, size=SIZE[0])
    model = SiameseUNet()
    model.load_state_dict(ti.siamese_state_dict_from_jax(pth_vars),
                          strict=True)
    pth = str(work / "a.pth")
    tck.save_model(pth, model)
    variables = jax_siamese_variables(seed=MSGPACK_SEED, size=SIZE[0])
    msgpack = str(work / "b.msgpack")
    jax_vars = {pth: pth_vars, msgpack: variables}
    jck.save_checkpoint(
        msgpack, SimpleNamespace(params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 opt_state=(), step=0),
        extra={"epoch": 1}, model_only=True)
    with dropped(work):
        yield str(oscd_tree), pth, msgpack, work, jax_vars


def _ensemble(case, pth, msgpack):
    return (pth, msgpack) if case == "ensemble" else None


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Each case's JAX run: its report, its threshold_sweep.json and its
    output directory."""
    root, pth, msgpack, work, _ = setup
    runs = {}
    for case, kw in CASES.items():
        out = work / f"jax_{case}"
        jp.run_evaluation(
            jcfg.DataConfig(root_dir=root),
            jcfg.EvalConfig(**{"num_visualizations": 0, **kw},
                            target_size=SIZE, checkpoint_path=pth,
                            ensemble_paths=_ensemble(case, pth, msgpack),
                            output_dir=str(out), compute_dtype="float32",
                            json_out=str(out / "report.json")),
            verbose=False)
        runs[case] = out
    return runs


def _load(path):
    with open(path) as f:
        return json.load(f)


def _probs(root, paths, jax_vars):
    """The port's and JAX's (ensemble) probabilities of every oscd_tree
    sample, and the samples' labels."""
    ds = build_cached_dataset(
        create_sample_lists(root, SUBDIR, mode="all", verbose=False),
        SIZE, verbose=False)
    models = [tck.restore_model_only(p, SiameseUNet(batched_encoder=True))
              for p in paths]
    port = tp.ensemble_probs(models, torch.from_numpy(ds.img1),
                             torch.from_numpy(ds.img2), "float32")
    jax_probs = [jax.nn.sigmoid(jax_siamese_logits(
        jax_vars[p], ds.img1 * 2.0 - 1.0, ds.img2 * 2.0 - 1.0,
        batched_encoder=True))[..., 0] for p in paths]
    return port, np.asarray(sum(jax_probs) / len(paths)), torch.from_numpy(
        ds.labels).float()


def _assert_sweep_close(got, want):
    assert got["thresholds"] == want["thresholds"]
    assert got["best_threshold"] == want["best_threshold"]
    for key in ("f1", "iou"):
        assert got[key] == pytest.approx(want[key], rel=0, abs=1e-6), key
    assert got["best_f1"] == pytest.approx(want["best_f1"], rel=0, abs=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_and_sweep_match_jax(setup, jax_runs, case):
    root, pth, msgpack, work, jax_vars = setup
    probs, jax_probs, labels = _probs(
        root, [pth, msgpack] if case == "ensemble" else [pth], jax_vars)
    dprob = float(np.abs(probs.numpy() - jax_probs).max())
    assert dprob < 1e-5
    grid = tm.sweep_thresholds()
    for t in [0.5, CASES[case].get("threshold", 0.5), *grid]:
        # Pixels this close to a threshold could flip between frameworks.
        gap = float((probs - float(np.float32(t))).abs().min())
        assert gap > 2 * dprob, (t, gap, dprob)
    out = work / f"port_{case}"
    kw = CASES[case]
    if case == "ensemble":  # through the CLI, as a user runs it
        got = tev.main([
            "--root-dir", root, "--ensemble", pth, msgpack,
            "--output-dir", str(out), "--target-size", "32x32",
            "--threshold", str(kw["threshold"]), "--threshold-sweep",
            "--num-visualizations", "0", "--compute-dtype", "float32",
            "--json-out", str(out / "report.json"), "--device", "cpu"])
    else:
        got = tp.run_evaluation(
            DataConfig(root_dir=root),
            EvalConfig(**{"num_visualizations": 0, **kw}, target_size=SIZE,
                       checkpoint_path=pth, output_dir=str(out),
                       compute_dtype="float32",
                       json_out=str(out / "report.json")),
            verbose=False, device="cpu")
    jrep = _load(jax_runs[case] / "report.json")
    prep = _load(out / "report.json")
    assert set(prep) == set(jrep)
    for key in ("n_samples", "threshold", "checkpoints", "post_process",
                "per_city_counts"):
        assert prep[key] == jrep[key], key
    assert prep["overall"] == pytest.approx(jrep["overall"], rel=0, abs=1e-6)
    assert list(prep["per_city"]) == list(jrep["per_city"])
    for city, m in jrep["per_city"].items():
        assert prep["per_city"][city] == pytest.approx(m, rel=0, abs=1e-6)
    _assert_sweep_close(prep["sweep"], jrep["sweep"])
    jsweep = _load(jax_runs[case] / "threshold_sweep.json")
    psweep = _load(out / "threshold_sweep.json")
    assert list(psweep) == list(jsweep)
    _assert_sweep_close(psweep, jsweep)
    assert got["sweep"] == psweep
    # The sweep's counts are the plain version's at each grid threshold.
    if CASES[case].get("post_process"):
        probs = tmorph.postprocess_prediction(probs, kernel_size=4)
    want = np.stack([confusion_counts_batch_reference(
        probs.contiguous(), labels, float(t)).numpy() for t in grid])
    np.testing.assert_array_equal(got["sweep_counts"], want)
    if case == "post_process":
        # {0, 1} masks: every threshold ties, and the first is the best.
        assert psweep["best_threshold"] == 0.05
        assert len(set(psweep["f1"])) == 1
    else:
        assert len(set(psweep["f1"])) > 1


@pytest.mark.parametrize("k", [2, 3, 4, 5, 7])
def test_morphology_matches_jax_exactly(k):
    rng = np.random.RandomState(k)
    probs = rng.rand(3, 19, 26).astype(np.float32)
    mask = (probs > 0.5).astype(np.float32)
    for name in ("dilate", "erode"):
        want = np.asarray(getattr(jmorph, name)(mask, kernel_size=k))
        got = getattr(tmorph, name)(torch.from_numpy(mask), k).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    want = np.asarray(jmorph.postprocess_prediction(probs, kernel_size=k))
    got = tmorph.postprocess_prediction(torch.from_numpy(probs),
                                        kernel_size=k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and set(np.unique(got)) <= {0.0, 1.0}
    # opening and closing on their own: the compositions above.
    opened = tmorph.opening(torch.from_numpy(mask), k)
    assert torch.equal(tmorph.closing(opened, k), torch.from_numpy(
        np.array(jmorph.postprocess_prediction(mask, kernel_size=k))))


def test_postprocess_thresholds_at_its_own_default():
    """``--post-process`` thresholds at 0.5 whatever ``--threshold`` is
    (pipelines.py:886-893)."""
    probs = torch.full((1, 8, 8), 0.4)
    assert float(tmorph.postprocess_prediction(probs).sum()) == 0.0
    assert float(tmorph.postprocess_prediction(probs, 0.3).sum()) == 64.0


@pytest.mark.parametrize("t", [0.35, 0.55])
def test_sweep_compares_in_float32_at_the_boundary(t):
    """Probabilities at float32(t) and its neighbours: the port's counts
    equal JAX's float32 comparison, not a float64 one (at 0.55,
    float32(0.55) > 0.55 in float64)."""
    f = np.float32(t)
    values = np.array([np.nextafter(f, np.float32(0)), f,
                       np.nextafter(f, np.float32(1))], np.float32)
    rng = np.random.RandomState(int(t * 100))
    probs = rng.rand(2, 6, 7).astype(np.float32)
    probs[0, 0, :3] = values
    probs[1, 5, 4:] = values
    targets = (rng.rand(2, 6, 7) > 0.5).astype(np.float32)
    grid = tm.sweep_thresholds()
    counts = tm.confusion_counts_sweep(torch.from_numpy(probs),
                                       torch.from_numpy(targets), grid)
    for i, th in enumerate(grid):
        above = probs > np.float32(th)
        tp_ = (above & (targets > 0.5)).sum(axis=(1, 2))
        np.testing.assert_array_equal(counts[i, :, 0].numpy(), tp_)
        np.testing.assert_array_equal(counts[i, :, 1].numpy(),
                                      above.sum(axis=(1, 2)) - tp_)
    i = int(np.argmin(np.abs(grid - t)))
    assert int(counts[i].sum(0)[0] + counts[i].sum(0)[1]) == int(
        (probs > f).sum())
    assert (values > f).tolist() == [False, False, True]
    # The kernel's threshold argument is a C float: float32(t) itself.
    assert ctypes.c_float(float(grid[i])).value == float(f)
    got = tm.per_sample_metrics_sweep(torch.from_numpy(probs),
                                      torch.from_numpy(targets), grid)
    want = jm.per_sample_metrics_sweep(probs, targets,
                                       np.asarray(grid, np.float32))
    for key in tm.METRIC_KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_calculate_metrics_matches_jax():
    """Whole-input metrics: binary targets through the counts (exact),
    fractional ones through float sums of products."""
    rng = np.random.RandomState(5)
    probs = rng.rand(1, 24, 20).astype(np.float32)
    binary = (rng.rand(1, 24, 20) > 0.7).astype(np.float32)
    gray = (rng.randint(0, 256, (1, 24, 20)) / 255.0).astype(np.float32)
    for targets, exact in ((binary, True), (gray, False)):
        got = tm.calculate_metrics(torch.from_numpy(probs),
                                   torch.from_numpy(targets))
        want = jm.calculate_metrics(probs, targets)
        for key in tm.METRIC_KEYS:
            if exact:
                assert float(got[key]) == float(want[key]), key
            else:
                assert float(got[key]) == pytest.approx(
                    float(want[key]), rel=0, abs=1e-6), key


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def test_panels_decode_to_jax_pixels(setup, jax_runs):
    """The sweep case drew 2 panels on both sides: the first 2 samples in
    sample order, pixel for pixel JAX's."""
    root, pth, _, work, _ = setup
    out = work / "port_panels"
    tp.run_evaluation(
        DataConfig(root_dir=root),
        EvalConfig(target_size=SIZE, checkpoint_path=pth,
                   num_visualizations=2, output_dir=str(out),
                   compute_dtype="float32"),
        verbose=False, device="cpu")
    names = sorted(n for n in os.listdir(jax_runs["sweep"])
                   if n.startswith("validation_sample_"))
    assert len(names) == 2 and names == sorted(
        n for n in os.listdir(out) if n.startswith("validation_sample_"))
    for name in names:
        np.testing.assert_array_equal(_pixels(out / name),
                                      _pixels(jax_runs["sweep"] / name))


def test_panels_skipped_without_matplotlib(setup, monkeypatch, capsys):
    root, pth, _, work, _ = setup
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = work / "port_no_mpl"
    got = tp.run_evaluation(
        DataConfig(root_dir=root),
        EvalConfig(target_size=SIZE, checkpoint_path=pth,
                   num_visualizations=3, output_dir=str(out),
                   compute_dtype="float32"),
        verbose=False, device="cpu")
    assert got is not None
    assert ("Skipping 3 visualizations: matplotlib is not installed"
            in capsys.readouterr().out)
    assert not [n for n in os.listdir(out)
                if n.startswith("validation_sample_")]


def test_ensemble_missing_checkpoint(setup, capsys):
    root, pth, _, work, _ = setup
    missing = str(work / "nope.pth")
    assert tp.run_evaluation(
        DataConfig(root_dir=root),
        EvalConfig(target_size=SIZE, ensemble_paths=(pth, missing),
                   output_dir=str(work / "port_missing"),
                   num_visualizations=0, compute_dtype="float32"),
        verbose=False, device="cpu") is None
    assert f"Error: Checkpoint file not found at {missing}" in (
        capsys.readouterr().out)
