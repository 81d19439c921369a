"""Synthetic-pair generation in the port against the JAX package's on the
CPU: the PNG writer (read back by the port's decoder and by PIL, and
byte-identical to PIL's files), ``float_to_uint8``, the GAN sample strip,
``run_generate_synthetic`` from one generator ``.pth`` at 32x32 (img1 and
labels pixel-exact, img2 within 1 LSB on at most 0.5% of pixels: the two
frameworks' float32 generators round differently, and the truncating byte
cast turns a difference across an integer boundary into one LSB), the
synthesis CLI, and the whole loop on the CPU: a GAN epoch, synthesis,
``train --use-synthetic`` on the port's own corpus and evaluation.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import evaluate as eval_cli
from gan_aug_pfa_torch import generate_synthetic as synth_cli
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch import train_gan as gan_cli
from gan_aug_pfa_torch.config import DataConfig, GenerateConfig
from gan_aug_pfa_torch.data import png
from gan_aug_pfa_torch.data.loader import build_cached_dataset, float_to_uint8
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.utils.viz import save_gan_sample_strip
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import pipelines as jp
from gan_aug_pfa_tpu.data.loader import float_to_uint8 as jax_float_to_uint8
from gan_aug_pfa_tpu.utils.viz import save_gan_sample_strip as jax_strip
from torch_port_helpers import jax_pix2pix_variables

SUBDIR = "Onera Satellite Change Detection Dataset"
SIZE = 32
SMALL_G = ["--target-size", "32x32", "--num-downs", "5", "--ngf", "8"]


def _png_cases():
    rng = np.random.RandomState(0)
    smooth = np.add.outer(np.arange(48), np.arange(40))
    return {
        "gray_random": rng.randint(0, 256, (33, 41), dtype=np.uint8),
        "gray_label": (rng.rand(64, 70) > 0.8).astype(np.uint8) * 255,
        "rgb_random": rng.randint(0, 256, (40, 37, 3), dtype=np.uint8),
        "rgb_smooth": np.stack([smooth, smooth * 2, 255 - smooth],
                               axis=-1).astype(np.uint8),
        "rgb_blocks": np.repeat(np.repeat(rng.randint(
            0, 256, (10, 10, 3), dtype=np.uint8), 4, 0), 3, 1),
        "gray_1x1": np.array([[200]], np.uint8),
        "rgb_1x1": np.array([[[1, 2, 3]]], np.uint8),
        # 4 * width > 65536: PIL's IDAT chunks grow with the row.
        "rgb_wide": rng.randint(0, 256, (2, 17000, 3), dtype=np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_png_cases()))
def test_png_writer_reads_back_and_matches_pil_bytes(name, tmp_path):
    arr = _png_cases()[name]
    path = str(tmp_path / "x.png")
    png.write_png(path, arr)
    decode = png.decode_gray if arr.ndim == 2 else png.decode_rgb
    np.testing.assert_array_equal(decode(path), arr)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), arr)
    pil = io.BytesIO()
    Image.fromarray(arr).save(pil, format="PNG")
    with open(path, "rb") as f:
        assert f.read() == pil.getvalue()


@pytest.mark.parametrize("arr", [
    np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
    np.zeros((0, 4), np.uint8), np.zeros((4,), np.uint8)])
def test_png_writer_refuses_other_arrays(arr):
    with pytest.raises(ValueError):
        png.encode_png(arr)


def test_float_to_uint8_matches_jax():
    x = np.concatenate([np.linspace(-0.5, 1.5, 4001, dtype=np.float32),
                        np.arange(256, dtype=np.float32) / 255,
                        np.nextafter(np.arange(256, dtype=np.float32) / 255,
                                     np.float32(0))])
    np.testing.assert_array_equal(float_to_uint8(x), jax_float_to_uint8(x))


def test_sample_strip_matches_jax(tmp_path):
    """Same name, and the same file: the writer's bytes are PIL's."""
    rng = np.random.RandomState(1)
    a, f, b = (rng.rand(SIZE, SIZE, 3).astype(np.float32) for _ in range(3))
    got = save_gan_sample_strip(a, f * 1.2 - 0.1, b, "paris", 7,
                                str(tmp_path / "port"))
    want = jax_strip(a, f * 1.2 - 0.1, b, "paris", 7, str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == \
        "sample_paris_epoch_007.png"
    np.testing.assert_array_equal(png.decode_rgb(got), png.decode_rgb(want))
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()


# -- run_generate_synthetic against JAX's -------------------------------


@pytest.fixture(scope="module")
def synthesis(oscd_tree, tmp_path_factory):
    """Both pipelines from one seeded generator .pth (num_downs 5, ngf 8,
    random BN statistics) at 32x32, batch 4, float32, into separate
    corpora outside the shared tree."""
    root = str(oscd_tree)
    tmp = tmp_path_factory.mktemp("synthesis")
    gan_dir = str(tmp / "gan")
    vg, _ = jax_pix2pix_variables(seed=4, size=SIZE)
    tck.save_state_dict(os.path.join(gan_dir, "generator_epoch_1.pth"),
                        ti.generator_state_dict_from_jax(vg))
    out = {side: str(tmp / side) for side in ("jax", "port")}
    common = dict(target_size=(SIZE, SIZE), num_downs=5, ngf=8,
                  generator_checkpoint_name="generator_epoch_1.pth",
                  gan_checkpoint_dir=gan_dir)
    n_jax = jp.run_generate_synthetic(
        jcfg.DataConfig(root_dir=root, synthetic_data_dir=out["jax"]),
        jcfg.GenerateConfig(synthetic_data_dir=out["jax"],
                            compute_dtype="float32", **common),
        verbose=False)
    n_port = tp.run_generate_synthetic(
        DataConfig(root_dir=root, synthetic_data_dir=out["port"]),
        GenerateConfig(synthetic_data_dir=out["port"], **common),
        verbose=False, device="cpu")
    files = {side: sorted(os.path.relpath(os.path.join(d, f), base)
                          for d, _, fs in os.walk(base) for f in fs)
             for side, base in out.items()}
    return {"root": root, "out": out, "n": (n_jax, n_port), "files": files}


def test_synthesis_writes_the_jax_file_set(synthesis):
    n_jax, n_port = synthesis["n"]
    assert n_jax == n_port == 5
    assert synthesis["files"]["port"] == synthesis["files"]["jax"]
    assert len(synthesis["files"]["port"]) == 15
    assert "images/paris/img2_synth_3.png" in synthesis["files"]["port"]
    assert "labels/paris/cm_synth_3.png" in synthesis["files"]["port"]


def test_synthesis_img1_and_labels_pixel_exact(synthesis):
    """img1 and the labels equal JAX's; img1 is the cache through the
    float32 normalize -> denormalize replay, the label the real one x255."""
    ds = build_cached_dataset(
        create_sample_lists(synthesis["root"], SUBDIR, mode="all",
                            verbose=False), (SIZE, SIZE), verbose=False)
    for f in synthesis["files"]["port"]:
        if "img2_" in f:
            continue
        decode = png.decode_gray if f.startswith("labels") else png.decode_rgb
        got, want = (decode(os.path.join(synthesis["out"][s], f))
                     for s in ("port", "jax"))
        np.testing.assert_array_equal(got, want, err_msg=f)
        i = int(f.rsplit("_", 1)[1][:-4])
        if f.startswith("labels"):
            np.testing.assert_array_equal(got, ds.labels[i] * 255)
        else:
            replay = (ds.img1[i] * np.float32(2) - np.float32(1)) * np.float32(
                0.5) + np.float32(0.5)
            np.testing.assert_array_equal(got, float_to_uint8(replay))
            # Without the replay some pixels would be one LSB higher.
            assert (float_to_uint8(ds.img1[i]) >= got).all()


def test_synthesis_img2_within_one_lsb_of_jax(synthesis):
    diffs = []
    for f in synthesis["files"]["port"]:
        if "img2_" in f:
            got, want = (png.decode_rgb(os.path.join(synthesis["out"][s], f))
                         for s in ("port", "jax"))
            diffs.append(np.abs(got.astype(int) - want).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 1
    assert (diffs > 0).mean() <= 0.005


# -- the synthesis CLI and the loop --------------------------------------


EMPTY = "Original training dataset is empty"


# The cases keep the ids they had while --stream exited 2 "not ported
# yet"; no flag of the root CLI is left unported.
@pytest.mark.parametrize("flags, message", [
    pytest.param(["--stream", "host"], EMPTY, id="flags0-not ported yet"),
    pytest.param(["--stream", "decode"], EMPTY, id="flags1-not ported yet"),
    (["--serving-aot", "sometimes"], "invalid choice")])
def test_cli_rejects_flags_not_ported(flags, message, tmp_path, capsys):
    """--stream host|decode runs (an empty root: the JAX package's message,
    0 samples); the serving flags are ported (their CLI runs are in
    tests/test_torch_serve.py), and --serving-aot takes the JAX package's
    three policies, exiting 2 on any other."""
    argv = ["--root-dir", str(tmp_path), "--device", "cpu", *flags]
    if message == EMPTY:
        assert synth_cli.main(argv) == 0
        out = capsys.readouterr()
        assert message in out.out and "not ported yet" not in out.err
        return
    with pytest.raises(SystemExit) as exc:
        synth_cli.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_missing_or_msgpack_checkpoint(oscd_tree, tmp_path, capsys):
    """No checkpoint: 0 samples and the JAX package's message.  A
    ``.msgpack`` file is read as a JAX package checkpoint: one without
    ``params`` is refused by name."""
    common = ["--root-dir", str(oscd_tree), "--device", "cpu", *SMALL_G,
              "--gan-checkpoint-dir", str(tmp_path), "--synthetic-data-dir",
              str(tmp_path / "synth"), "--no-compile-cache"]
    assert synth_cli.main(common) == 0
    assert "Generator checkpoint not found" in capsys.readouterr().out
    (tmp_path / "g.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="g.msgpack: not a JAX model"):
        synth_cli.main([*common, "--generator-checkpoint-name", "g.msgpack"])


def test_cli_default_device_is_cuda_and_never_falls_back(oscd_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth_cli.main(["--root-dir", str(oscd_tree), *SMALL_G])


def test_loop_gan_synthesis_training_evaluation_on_cpu(oscd_tree, tmp_path):
    """The paper's pipeline through the port's CLIs on the CPU: one GAN
    epoch, synthesis with its generator, Siamese training on the real and
    the port's synthetic train pairs, evaluation of the trained model."""
    root, synth = str(oscd_tree), str(tmp_path / "synth")
    gan_dir = str(tmp_path / "gan")
    hist = gan_cli.main(["--root-dir", root, "--device", "cpu",
                         "--num-epochs", "1", *SMALL_G, "--ndf", "8",
                         "--checkpoint-dir", gan_dir, "--output-dir",
                         str(tmp_path / "samples")])
    assert np.isfinite(hist["loss_d"] + hist["loss_g"]).all()
    assert synth_cli.main(["--root-dir", root, "--device", "cpu", *SMALL_G,
                           "--gan-checkpoint-dir", gan_dir,
                           "--generator-checkpoint-name",
                           "generator_epoch_1.pth",
                           "--synthetic-data-dir", synth]) == 5
    train = create_sample_lists(root, SUBDIR, synth, mode="train",
                                use_synthetic=True, verbose=False)
    # The 4 train cities, real and synthetic (pisa is a val city).
    assert sorted(s.city for s in train if s.is_synthetic) == [
        "abudhabi_synth", "beirut_synth", "nantes_synth", "paris_synth"]
    assert all(s.img1.startswith(synth) for s in train if s.is_synthetic)
    ckpt_dir = str(tmp_path / "siamese")
    history = train_cli.main(["--root-dir", root, "--device", "cpu",
                              "--num-epochs", "1", "--target-size", "32x32",
                              "--batch-size", "4", "--use-synthetic",
                              "--synthetic-data-dir", synth,
                              "--checkpoint-dir", ckpt_dir])
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()
    result = eval_cli.main(["--root-dir", root, "--device", "cpu",
                            "--target-size", "32x32", "--checkpoint-path",
                            os.path.join(ckpt_dir, "best_model.pth"),
                            "--output-dir", str(tmp_path / "eval")])
    assert sum(result["per_city_counts"].values()) == 5
    assert (result["counts"].sum(axis=1) == SIZE * SIZE).all()
    assert all(0.0 <= v <= 1.0 for v in result["overall"].values())
