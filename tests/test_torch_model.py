"""The port's SiameseUNet, weight converter, checkpoints and predict
against the JAX package, at full width and 32x32, fp32 on both sides.

Tolerances: eval logits agree within LOGIT_ATOL, probabilities within
PROB_ATOL.  Measured on the CPU over 2x32x32, two-pass and batched encoder
alike: max |d logit| 2.3e-5 on logits of std 1.6 (the head scaled by
torch_port_helpers.HEAD_SCALE; 8.9e-8 with the unscaled init head), max
|d prob| 5.7e-6.  The bounds leave about 4x headroom for other CPUs'
summation orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.ops.resize import (
    _upsample_matrix,
    upsample2x_align_corners,
    upsample_matrix,
)
from gan_aug_pfa_torch.train.siamese import predict
from gan_aug_pfa_tpu import interop as ji
from gan_aug_pfa_tpu.ops.resize import _upsample_matrix as jax_upsample_matrix
from gan_aug_pfa_tpu.ops.resize import (
    upsample2x_align_corners as jax_upsample,
)
from torch_port_helpers import jax_siamese_logits, jax_siamese_variables
from torch_tmp import drop_tmp_path  # noqa: F401

LOGIT_ATOL = 1e-4
PROB_ATOL = 2e-5
UPSAMPLE_ULPS = 2  # port vs JAX upsample, float32 and float64


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


@pytest.mark.parametrize("h", [1, 2, 8, 16, 64])
def test_upsample_matrix_equals_jax_bits(h):
    """The port's (2h, h) align-corners matrix is the JAX package's
    ``_upsample_matrix(h, 2h)``: float32, equal bits."""
    got, want = _upsample_matrix(h, 2 * h), jax_upsample_matrix(h, 2 * h)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    mat = upsample_matrix(h, torch.float64, torch.device("cpu"))
    assert mat.dtype == torch.float64
    assert np.array_equal(mat.numpy(), want.astype(np.float64))


def _term_scale(x):
    """|Mh| |x| |Mw|^T over NHWC ``x``: the size of the terms that each
    output of the upsample sums, in float64."""
    h, w = x.shape[1:3]
    mh = np.abs(jax_upsample_matrix(h, 2 * h)).astype(np.float64)
    mw = np.abs(jax_upsample_matrix(w, 2 * w)).astype(np.float64)
    y = np.einsum("oh,nhwc->nowc", mh, np.abs(x.astype(np.float64)))
    return np.einsum("pw,nowc->nopc", mw, y)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_upsample_matches_jax(dtype):
    """The port's two matrix products against the JAX package's two
    einsums on the same NHWC input.  float32 and float64: within
    UPSAMPLE_ULPS units of rounding of the terms each output sums (the
    port's BLAS fuses a product's multiply and add, XLA rounds the two
    apart: one unit a product), measured up to 1.99 of them over 2x5x8x6
    to 4x8x8x64, and equal at 2x32x32x16 float32; and within 1e-6
    absolute.  bfloat16: CPU autocast
    against JAX's bf16 einsum, bf16 out, within one bf16 rounding step of
    the largest value; measured equal."""
    x = np.random.RandomState(2).randn(2, 5, 8, 6)
    if dtype == "bfloat16":
        x = x.astype(np.float32)
        want = np.asarray(jax_upsample(
            jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = upsample2x_align_corners(
                torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2))
        assert y.dtype == torch.bfloat16
        got = y.float().permute(0, 2, 3, 1).numpy()
        step = np.spacing(np.abs(want).max().astype(np.float32)) * 2 ** 16
        np.testing.assert_allclose(got, want, rtol=0, atol=step)
        return
    x = x.astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax_upsample(jnp.asarray(x)))
    y = upsample2x_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert y.dtype == getattr(torch, dtype)
    got = y.permute(0, 2, 3, 1).numpy()
    assert want.dtype == got.dtype and got.shape == (2, 10, 16, 6)
    bound = UPSAMPLE_ULPS * np.finfo(dtype).eps * _term_scale(x)
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_upsample_gradient_matches_jax_vjp():
    """The upsample's backward (the two transposed products) against
    ``jax.vjp`` of the JAX upsample at float64: within 1e-12 of the
    largest gradient."""
    rng = np.random.RandomState(3)
    x, g = rng.randn(2, 6, 10, 4), rng.randn(2, 12, 20, 4)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(jax_upsample, jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = upsample2x_align_corners(xt)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    got = xt.grad.permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


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
