"""The port's CLIs on checkpoints the JAX package wrote (``.msgpack``), on
the CPU against the JAX package's own pipelines from the same files:

  * ``python -m gan_aug_pfa_torch.evaluate --checkpoint-path
    best_model.msgpack`` gives JAX's evaluation JSON within 1e-6, as
    tests/test_torch_eval.py holds it for a ``.pth``;
  * ``python -m gan_aug_pfa_torch.generate_synthetic
    --generator-checkpoint-name generator_epoch_1.msgpack`` writes JAX's
    files: img1 and labels pixel-exact, img2 within 1 LSB on at most 0.5%
    of pixels, as tests/test_torch_synthesis.py holds it.
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import evaluate as eval_cli
from gan_aug_pfa_torch import generate_synthetic as synth_cli
from gan_aug_pfa_torch.data import png
from gan_aug_pfa_tpu import checkpoint as jck
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import pipelines as jp
from torch_port_helpers import jax_pix2pix_variables, jax_siamese_variables
from torch_tmp import drop_tmp_path  # noqa: F401

SIZE = 32
# As in tests/test_torch_eval.py: with these weights no probability on
# oscd_tree lies within 1e-4 of 0.5, so no pixel can flip between
# frameworks.
WEIGHT_SEED = 1


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs six test processes on the host's cores at once; two
    threads for this file's full-width CPU work keep them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _save_jax(path, variables, extra):
    jck.save_checkpoint(
        path, SimpleNamespace(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=(), step=0),
        extra=extra, model_only=True)


@pytest.fixture(scope="module")
def best_model_msgpack(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_eval")
    path = str(d / "best_model.msgpack")
    _save_jax(path, jax_siamese_variables(seed=WEIGHT_SEED, size=SIZE),
              {"epoch": 7, "val_loss": 0.3})
    yield path
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_evaluate_cli_on_jax_msgpack_matches_jax(oscd_tree, tmp_path,
                                                 best_model_msgpack,
                                                 threshold):
    root = str(oscd_tree)
    path = best_model_msgpack
    jax_json, port_json = (str(tmp_path / f"{s}.json")
                           for s in ("jax", "port"))
    jp.run_evaluation(
        jcfg.DataConfig(root_dir=root),
        jcfg.EvalConfig(target_size=(SIZE, SIZE), checkpoint_path=path,
                        output_dir=str(tmp_path / "jax_results"),
                        num_visualizations=0, compute_dtype="float32",
                        threshold=threshold, json_out=jax_json),
        verbose=False)
    result = eval_cli.main([
        "--root-dir", root, "--checkpoint-path", path, "--output-dir",
        str(tmp_path / "port_results"), "--target-size", f"{SIZE}x{SIZE}",
        "--threshold", str(threshold), "--compute-dtype", "float32",
        "--json-out", port_json, "--device", "cpu"])
    assert result is not None
    with open(jax_json) as f:
        jrep = json.load(f)
    with open(port_json) as f:
        prep = json.load(f)
    assert set(prep) == set(jrep)
    for key in ("n_samples", "threshold", "checkpoints", "post_process",
                "per_city_counts", "sweep"):
        assert prep[key] == jrep[key], key
    assert prep["checkpoints"] == [path] and prep["n_samples"] == 5
    assert prep["overall"] == pytest.approx(jrep["overall"], rel=0, abs=1e-6)
    assert list(prep["per_city"]) == list(jrep["per_city"])
    for city, m in jrep["per_city"].items():
        assert prep["per_city"][city] == pytest.approx(m, rel=0, abs=1e-6)


@pytest.fixture(scope="module")
def synthesis(oscd_tree, tmp_path_factory):
    """JAX's and the port's synthesis from one JAX-written
    ``generator_epoch_1.msgpack``."""
    root = str(oscd_tree)
    tmp = tmp_path_factory.mktemp("msgpack_synth")
    gan_dir = str(tmp / "gan")
    gv, _ = jax_pix2pix_variables(seed=6, size=SIZE, num_downs=5, ngf=8,
                                  ndf=8)
    _save_jax(os.path.join(gan_dir, "generator_epoch_1.msgpack"), gv,
              {"epoch": 1})
    out = {side: str(tmp / side) for side in ("jax", "port")}
    n_jax = jp.run_generate_synthetic(
        jcfg.DataConfig(root_dir=root, synthetic_data_dir=out["jax"]),
        jcfg.GenerateConfig(
            target_size=(SIZE, SIZE), num_downs=5, ngf=8,
            generator_checkpoint_name="generator_epoch_1.msgpack",
            gan_checkpoint_dir=gan_dir, synthetic_data_dir=out["jax"],
            compute_dtype="float32"),
        verbose=False)
    n_port = synth_cli.main([
        "--root-dir", root, "--device", "cpu", "--target-size",
        f"{SIZE}x{SIZE}", "--num-downs", "5", "--ngf", "8",
        "--gan-checkpoint-dir", gan_dir, "--generator-checkpoint-name",
        "generator_epoch_1.msgpack", "--synthetic-data-dir", out["port"]])
    files = {side: sorted(os.path.relpath(os.path.join(d, f), base)
                          for d, _, fs in os.walk(base) for f in fs)
             for side, base in out.items()}
    return {"out": out, "n": (n_jax, n_port), "files": files}


def test_synthesis_from_jax_msgpack_writes_jax_files(synthesis):
    assert synthesis["n"] == (5, 5)
    assert synthesis["files"]["port"] == synthesis["files"]["jax"]
    assert len(synthesis["files"]["port"]) == 15


def test_synthesis_from_jax_msgpack_pixels(synthesis):
    diffs = []
    for f in synthesis["files"]["port"]:
        decode = png.decode_gray if f.startswith("labels") else png.decode_rgb
        got, want = (decode(os.path.join(synthesis["out"][s], f))
                     for s in ("port", "jax"))
        if "img2_" in f:
            diffs.append(np.abs(got.astype(int) - want).ravel())
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 1
    assert (diffs > 0).mean() <= 0.005
