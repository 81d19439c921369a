"""The port's evaluation slice end to end against the JAX package's
``run_evaluation`` on the ``oscd_tree`` fixture, from one ``.pth``, at
fp32 on the CPU.  Overall and per-city metrics agree within 1e-6."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import evaluate as tev
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch.config import DataConfig, EvalConfig
from gan_aug_pfa_torch.data.loader import build_cached_dataset
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.ops.kernels.confusion_counts import (
    confusion_counts_batch_reference,
)
from gan_aug_pfa_torch.train.siamese import predict
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import pipelines as jp
from torch_port_helpers import jax_siamese_variables
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

SIZE = (32, 32)
# With these weights no probability on oscd_tree lies within 1e-4 of 0.5
# (the nearest is 1.5e-4 away), so no pixel can flip between frameworks.
WEIGHT_SEED = 1
SUBDIR = "Onera Satellite Change Detection Dataset"


@pytest.fixture(scope="module")
def slice_setup(oscd_tree, tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_eval")
    model = SiameseUNet()
    model.load_state_dict(ti.siamese_state_dict_from_jax(
        jax_siamese_variables(seed=WEIGHT_SEED, size=SIZE[0])), strict=True)
    pth = str(work / "siamese_checkpoints" / "best_model.pth")
    with dropped(work):
        tck.save_model(pth, model)
        yield str(oscd_tree), pth, work


def _port_eval_cfg(pth, work, **kw):
    return EvalConfig(target_size=SIZE, checkpoint_path=pth,
                      output_dir=str(work / "port_results"),
                      compute_dtype="float32", **kw)


def _port_probs(root, pth):
    ds = build_cached_dataset(
        create_sample_lists(root, SUBDIR, mode="all", verbose=False),
        SIZE, verbose=False)
    model = tck.restore_model_only(pth, SiameseUNet(batched_encoder=True))
    probs = predict(model, torch.from_numpy(ds.img1),
                    torch.from_numpy(ds.img2), "float32")[..., 0]
    return probs, torch.from_numpy(ds.labels).float()


def test_evaluation_matches_jax(slice_setup):
    root, pth, work = slice_setup
    probs, _ = _port_probs(root, pth)
    # Pixels this close to the threshold could flip between frameworks.
    assert float((probs - 0.5).abs().min()) > 1e-4
    assert 0.2 < float((probs > 0.5).float().mean()) < 0.8

    jax_json = str(work / "jax.json")
    want = jp.run_evaluation(
        jcfg.DataConfig(root_dir=root),
        jcfg.EvalConfig(target_size=SIZE, checkpoint_path=pth,
                        output_dir=str(work / "jax_results"),
                        num_visualizations=0, compute_dtype="float32",
                        json_out=jax_json),
        verbose=False,
    )
    port_json = str(work / "port.json")
    got = tp.run_evaluation(DataConfig(root_dir=root),
                            _port_eval_cfg(pth, work, json_out=port_json),
                            verbose=False, device="cpu")
    with open(jax_json) as f:
        jrep = json.load(f)
    with open(port_json) as f:
        prep = json.load(f)
    assert set(prep) == set(jrep)
    for key in ("n_samples", "threshold", "checkpoints", "post_process",
                "per_city_counts", "sweep"):
        assert prep[key] == jrep[key], key
    assert prep["n_samples"] == 5
    assert prep["overall"] == pytest.approx(jrep["overall"], rel=0, abs=1e-6)
    assert list(prep["per_city"]) == list(jrep["per_city"])
    for city, m in jrep["per_city"].items():
        assert prep["per_city"][city] == pytest.approx(m, rel=0, abs=1e-6)
    for city, m in want["per_city"].items():
        assert got["per_city"][city] == pytest.approx(m, rel=0, abs=1e-6)
    assert got["per_city_counts"] == want["per_city_counts"]
    assert got["sweep"] is None and want["sweep"] is None


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_cli_matches_run_evaluation_and_reference_counts(slice_setup,
                                                         threshold):
    root, pth, work = slice_setup
    cli_json = str(work / f"cli_{threshold}.json")
    result = tev.main([
        "--root-dir", root, "--checkpoint-path", pth,
        "--output-dir", str(work / "cli_results"), "--target-size", "32x32",
        "--batch-size", "2", "--threshold", str(threshold),
        "--compute-dtype", "float32", "--json-out", cli_json,
        "--device", "cpu",
    ])
    direct = tp.run_evaluation(
        DataConfig(root_dir=root),
        _port_eval_cfg(pth, work, threshold=threshold), verbose=False,
        device="cpu")
    assert result["overall"] == direct["overall"]
    probs, labels = _port_probs(root, pth)
    np.testing.assert_array_equal(
        result["counts"],
        confusion_counts_batch_reference(probs, labels, threshold).numpy())
    with open(cli_json) as f:
        report = json.load(f)
    assert report["threshold"] == threshold
    for v in report["overall"].values():
        assert math.isfinite(v) and 0.0 <= v <= 1.0


@pytest.mark.parametrize("batch_size", [1, 3, 16])
def test_batch_size_does_not_change_metrics(slice_setup, batch_size):
    """Contiguous batches, a partial last batch, and one batch larger
    than the dataset all give the batch-2 result."""
    root, pth, work = slice_setup
    ref = tp.run_evaluation(DataConfig(root_dir=root),
                            _port_eval_cfg(pth, work), verbose=False,
                            device="cpu")
    got = tp.run_evaluation(
        DataConfig(root_dir=root),
        _port_eval_cfg(pth, work, batch_size=batch_size), verbose=False,
        device="cpu")
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    assert got["overall"] == pytest.approx(ref["overall"], rel=0, abs=1e-12)


def test_missing_checkpoint_or_samples(slice_setup, tmp_path, capsys):
    root, pth, work = slice_setup
    missing = str(tmp_path / "nope.pth")
    assert tp.run_evaluation(
        DataConfig(root_dir=root), _port_eval_cfg(missing, work),
        verbose=False, device="cpu") is None
    assert "Checkpoint file not found" in capsys.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", "gan_aug_pfa_torch.evaluate", "--root-dir",
         str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 1
    assert "No validation samples found" in proc.stdout


def test_default_device_is_cuda_and_never_falls_back(slice_setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    root, pth, _ = slice_setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.main(["--root-dir", root, "--checkpoint-path", pth])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.run_evaluation(DataConfig(root_dir=root),
                          EvalConfig(checkpoint_path=pth), verbose=False)


# The root evaluate.py's flags, by group: (command lines that parse and
# run, each with the line an empty root prints; command lines that exit
# 2, each with its message).  Every group is ported: single-pair
# evaluation, the panels, post-processing, the ensemble, the sweep,
# serving artifacts and --stream.
NO_SAMPLES = "No validation samples found"
NOT_PORTED = "not ported yet"
NOT_PORTED_GROUPS = {
    "single_pair": ([(["--image1-path", "a.png", "--image2-path", "b.png",
                       "--city-name", "paris"],
                      "One or both image paths not found"),
                     (["--label-path", "cm.png"], NO_SAMPLES)], []),
    "visualizations": ([(["--num-visualizations", "0"], NO_SAMPLES),
                        (["--num-visualizations", "5"], NO_SAMPLES)], []),
    "post_process": ([(["--post-process-kernel", "3"], NO_SAMPLES),
                      (["--post-process"], NO_SAMPLES),
                      (["--post-process-kernel", "5"], NO_SAMPLES)], []),
    "ensemble": ([(["--ensemble", "a.pth", "b.pth"], NO_SAMPLES)],
                 [(["--ensemble", "a.pth"], "needs two or more")]),
    "threshold_sweep": ([(["--threshold-sweep"], NO_SAMPLES)], []),
    "stream": ([(["--stream", "hbm"], NO_SAMPLES),
                (["--stream", "host"], NO_SAMPLES),
                (["--stream", "decode"], NO_SAMPLES)],
               [(["--stream", "sometimes"], "invalid choice")]),
    "serving": ([(["--serving-aot", "auto"], NO_SAMPLES),
                 (["--serving-artifact", "m.pt2"], NO_SAMPLES),
                 (["--serving-aot", "never"], NO_SAMPLES)],
                [(["--serving-aot", "sometimes"], "invalid choice")]),
    "compile_cache": ([(["--no-compile-cache"], NO_SAMPLES)], []),
}


@pytest.mark.parametrize("group", sorted(NOT_PORTED_GROUPS))
def test_cli_flags_not_ported_yet(group, tmp_path, capsys):
    """Each flag of the root CLI is known.  A ported path runs with any
    value (an empty root: no samples, or no images, and None); a path not
    ported yet runs with the value that leaves it off and exits 2 with
    "not ported yet" on any other, not argparse's "unrecognized
    arguments"."""
    accepted, rejected = NOT_PORTED_GROUPS[group]
    base = ["--root-dir", str(tmp_path), "--device", "cpu"]
    for flags, message in accepted:
        assert tev.main(base + flags) is None
        out = capsys.readouterr()
        assert NOT_PORTED not in out.err
        assert message in out.out
    for flags, message in rejected:
        with pytest.raises(SystemExit) as exc:
            tev.main(base + flags)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert message in err and "unrecognized" not in err
