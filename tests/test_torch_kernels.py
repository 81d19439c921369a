"""The confusion-counts kernel's plain version and the port's metrics,
against the JAX package: the Pallas kernel in interpret mode and the jnp
path.  Counts are exact; metrics agree within 1e-6.  The kernel itself
runs only on the card: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import metrics as tm
from gan_aug_pfa_torch.ops.kernels import build
from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
from gan_aug_pfa_tpu import metrics as jm
from gan_aug_pfa_tpu.ops.pallas_kernels import confusion_counts_batch
from torch_tmp import drop_tmp_path  # noqa: F401

SHAPES = [(5, 33, 47), (1, 37, 53), (3, 1, 1)]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    p = rng.rand(*shape).astype(np.float32)
    # Probabilities exactly at the threshold count as negative (strict >).
    p.reshape(-1)[::7] = 0.5
    t = (rng.rand(*shape) > 0.6).astype(np.float32)
    t[0] = 1.0  # an all-positive sample
    if shape[0] > 1:
        t[-1] = 0.0  # an all-negative sample
    return p, t


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_kernel_and_jnp(shape):
    p, t = _inputs(shape, seed=sum(shape))
    got = cc.confusion_counts_batch_reference(
        torch.from_numpy(p), torch.from_numpy(t)).numpy()
    pallas = np.asarray(confusion_counts_batch(
        jnp.asarray(p), jnp.asarray(t), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    for i in range(shape[0]):
        ref = [float(v) for v in jm.confusion_counts(p[i], t[i])]
        np.testing.assert_array_equal(got[i], ref)
    np.testing.assert_array_equal(got.sum(axis=1), shape[1] * shape[2])


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.9])
def test_reference_threshold_matches_jnp(threshold):
    p, t = _inputs((4, 19, 23), seed=11)
    p.reshape(-1)[::5] = np.float32(threshold)
    got = cc.confusion_counts_batch_reference(
        torch.from_numpy(p), torch.from_numpy(t), threshold).numpy()
    for i in range(4):
        ref = [float(v) for v in jm.confusion_counts(p[i], t[i], threshold)]
        np.testing.assert_array_equal(got[i], ref)


def test_wrapper_on_cpu_uses_reference_without_launch():
    p, t = _inputs((2, 16, 16), seed=3)
    before = cc.confusion_counts_batch.launches
    got = cc.confusion_counts_batch(torch.from_numpy(p), torch.from_numpy(t))
    ref = cc.confusion_counts_batch_reference(
        torch.from_numpy(p), torch.from_numpy(t))
    assert torch.equal(got, ref) and got.dtype == torch.float32
    assert cc.confusion_counts_batch.launches == before


@pytest.mark.parametrize("bad", ["dtype", "rank", "shape", "contiguity"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p = torch.rand(2, 8, 8)
    t = torch.zeros(2, 8, 8)
    if bad == "dtype":
        p = p.double()
    elif bad == "rank":
        p, t = p.reshape(2, 64), t.reshape(2, 64)
    elif bad == "shape":
        t = torch.zeros(2, 8, 9)
    else:
        p = p.transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        cc.confusion_counts_batch(p, t)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["confusion_counts"])


def test_metrics_from_counts_matches_jax():
    rng = np.random.RandomState(5)
    c = rng.randint(0, 500, size=(4, 64)).astype(np.float32)
    c[:, 0] = 0.0  # all-zero counts exercise the smoothing
    got = tm.metrics_from_counts(*torch.from_numpy(c))
    ref = jm.metrics_from_counts(*jnp.asarray(c))
    for k in tm.METRIC_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_per_sample_metrics_matches_jax(threshold):
    p, t = _inputs((6, 24, 20), seed=21)
    got = tm.per_sample_metrics(torch.from_numpy(p), torch.from_numpy(t),
                                threshold)
    ref = jm.per_sample_metrics(jnp.asarray(p), jnp.asarray(t), threshold)
    for k in tm.METRIC_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6)
    whole = tm.confusion_counts(torch.from_numpy(p), torch.from_numpy(t),
                                threshold)
    jwhole = jm.confusion_counts(jnp.asarray(p), jnp.asarray(t), threshold)
    np.testing.assert_array_equal([float(v) for v in whole],
                                  [float(v) for v in jwhole])
