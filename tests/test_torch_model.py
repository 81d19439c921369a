"""The port's SiameseUNet, weight converter, checkpoints and predict
against the JAX package, at full width and 32x32, fp32 on both sides.

Tolerances: eval logits agree within LOGIT_ATOL, probabilities within
PROB_ATOL.  Measured on the CPU over 2x32x32, two-pass and batched encoder
alike: max |d logit| 2.3e-5 on logits of std 1.6 (the head scaled by
torch_port_helpers.HEAD_SCALE; 8.9e-8 with the unscaled init head), max
|d prob| 5.7e-6.  The bounds leave about 4x headroom for other CPUs'
summation orders."""

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.ops.resize import upsample2x_align_corners
from gan_aug_pfa_torch.train.siamese import predict
from gan_aug_pfa_tpu import interop as ji
from gan_aug_pfa_tpu.ops.resize import (
    upsample2x_align_corners as jax_upsample,
)
from torch_port_helpers import jax_siamese_logits, jax_siamese_variables
from torch_tmp import drop_tmp_path  # noqa: F401

LOGIT_ATOL = 1e-4
PROB_ATOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    variables = jax_siamese_variables(seed=0, size=32)
    rng = np.random.RandomState(1)
    x1 = rng.rand(2, 32, 32, 3).astype(np.float32)
    x2 = rng.rand(2, 32, 32, 3).astype(np.float32)
    logits = jax_siamese_logits(variables, 2 * x1 - 1, 2 * x2 - 1)
    return variables, x1, x2, logits


def _port_model(variables, batched_encoder=False):
    model = SiameseUNet(batched_encoder=batched_encoder)
    model.load_state_dict(ti.siamese_state_dict_from_jax(variables),
                          strict=True)
    return model.eval()


def test_param_count_and_reference_key_names(weights):
    model = SiameseUNet()
    assert sum(p.numel() for p in model.parameters()) == 41_160_525
    assert set(model.state_dict()) == set(
        ji.siamese_to_torch(weights[0]))


def test_converter_matches_jax_interop_key_for_key(weights):
    got = ti.siamese_state_dict_from_jax(weights[0])
    want = ji.siamese_to_torch(weights[0])
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.int64 if k.endswith(
            "num_batches_tracked") else torch.float32), k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("batched_encoder", [False, True])
def test_eval_logits_match_jax(weights, batched_encoder):
    variables, x1, x2, want = weights
    model = _port_model(variables, batched_encoder)
    a = torch.from_numpy(2 * x1 - 1).permute(0, 3, 1, 2)
    b = torch.from_numpy(2 * x2 - 1).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(a, b).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_predict_matches_jax_sigmoid(weights):
    variables, x1, x2, logits = weights
    model = _port_model(variables, batched_encoder=True)
    got = predict(model, torch.from_numpy(x1), torch.from_numpy(x2),
                  "float32")
    assert got.shape == (2, 32, 32, 1) and got.dtype == torch.float32
    want = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_ATOL)
    bf16 = predict(model, torch.from_numpy(x1), torch.from_numpy(x2),
                   "bfloat16")
    assert bf16.dtype == torch.float32 and bool(torch.isfinite(bf16).all())
    with pytest.raises(ValueError):
        predict(model, torch.from_numpy(x1), torch.from_numpy(x2), "fp16")


def test_upsample_matches_jax():
    x = np.random.RandomState(2).randn(2, 5, 7, 3).astype(np.float32)
    got = upsample2x_align_corners(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_upsample(x)),
                               rtol=0, atol=1e-6)


def test_checkpoint_roundtrip_and_jax_written_pth(weights, tmp_path):
    variables = weights[0]
    # A .pth written by the JAX package's interop loads strictly.
    jax_pth = str(tmp_path / "from_jax.pth")
    ji.save_torch_state_dict(jax_pth, ji.siamese_to_torch(variables))
    model = tck.restore_model_only(jax_pth, SiameseUNet())
    ref = _port_model(variables)
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    # The port's own save/find/restore under the reference stem.
    ckdir = tmp_path / "siamese_checkpoints"
    assert tck.find_checkpoint(str(ckdir), "best_model") is None
    tck.save_model(str(ckdir / tck.checkpoint_name("best_model")), model)
    path = tck.find_checkpoint(str(ckdir), "best_model")
    assert path == str(ckdir / "best_model.pth")
    again = tck.restore_model_only(path, SiameseUNet())
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert ji.detect_arch(ji.load_torch_state_dict(path)) == "siamese"
    # A .msgpack path is read as a JAX package checkpoint, not the .pth.
    with pytest.raises(FileNotFoundError, match="best_model.msgpack"):
        tck.restore_model_only(str(ckdir / "best_model.msgpack"),
                               SiameseUNet())
