"""The port's int8 weight-only quantization (``gan_aug_pfa_torch/
quantize.py``) against the JAX package's (``gan_aug_pfa_tpu/quantize.py``)
on the CPU, inputs from ``np.random.default_rng``.

The int8 tensors and scales must equal JAX's exactly, once JAX's HWIO
kernels are carried to the port's layouts by the port's own weight
converter (a transpose, and a spatial flip for the generator's
conv-transposes, whose output channels are on axis 1); the reports must be
equal too.  The reconstruction bound |w - dequant(q)| <= scale/2 holds up
to float32 rounding: 1e-7 absolute on an element; in units of the scale
(``max_reconstruction_error``) 127 * 2**-22, the rounding of w/scale and
of the dequantize at |w|/scale <= 127."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import quantize as qz
from gan_aug_pfa_torch.models import (
    NLayerDiscriminator,
    SiameseUNet,
    UNetGenerator,
)
from gan_aug_pfa_tpu import quantize as jqz
from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxSiameseUNet
from torch_port_helpers import jax_pix2pix_variables

SMALL_GAN = {"num_downs": 5, "ngf": 8, "ndf": 8}
BOUND = 0.5 + 127 * 2.0 ** -22  # max_reconstruction_error's


def test_quantize_array_error_bound():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(
        (rng.standard_normal((128, 64, 3, 3)) * 5 * rng.random())
        .astype(np.float32))
    node = qz.quantize_array(w)
    assert node[qz.QKEY].dtype == torch.int8
    assert node[qz.SKEY].shape == (128, 1, 1, 1)
    back = qz.dequantize_array(node)
    assert bool(((back - w).abs() <= node[qz.SKEY] * 0.5 + 1e-7).all())
    # Relative RMS error of per-channel int8 on gaussian weights: a step
    # of max|w|/127, about 3.2 sigma/127, gives an RMS of step/sqrt(12),
    # about 0.73% of sigma.
    assert float((back - w).norm() / w.norm()) < 0.01


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_array_equals_jax_on_the_output_axis(axis):
    """A conv weight (out on axis 0) and a conv-transpose weight (out on
    axis 1) against JAX's quantize_array of the same tensor with its
    output channels moved last, as in a Flax kernel."""
    rng = np.random.default_rng(1 + axis)
    w = rng.standard_normal((24, 16, 4, 4)).astype(np.float32)
    w[3 if axis == 0 else slice(None), 3 if axis == 1 else slice(None)] = 0
    node = qz.quantize_array(torch.from_numpy(w), axis)
    want = jqz.quantize_array(np.moveaxis(w, axis, -1))
    np.testing.assert_array_equal(
        np.moveaxis(node[qz.QKEY].numpy(), axis, -1), want[jqz.QKEY])
    np.testing.assert_array_equal(node[qz.SKEY].flatten().numpy(),
                                  want[jqz.SKEY])


def test_dequantize_bf16_rounds_once():
    """bfloat16 dequantize equals the float32 one rounded once to bf16 (the
    multiply in float32, the scales never rounded), and JAX's bits."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 16, 3, 3)).astype(np.float32)
    node = qz.quantize_array(torch.from_numpy(w))
    bf16 = qz.dequantize_array(node, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, qz.dequantize_array(node).to(torch.bfloat16))
    jnode = jqz.quantize_array(np.moveaxis(w, 0, -1))
    want = jqz.dequantize_array(jax.tree.map(jnp.asarray, jnode),
                                jnp.bfloat16)
    want_bits = np.asarray(want).view(np.uint16)
    np.testing.assert_array_equal(
        np.moveaxis(bf16.view(torch.int16).numpy().view(np.uint16), 0, -1),
        want_bits)


def test_quantize_array_zero_channel():
    w = torch.zeros((4, 8, 3, 3))
    w[1] = 1.0
    node = qz.quantize_array(w)
    assert bool(torch.isfinite(node[qz.SKEY]).all())
    assert float(node[qz.SKEY][0]) == 1.0
    assert torch.equal(qz.dequantize_array(node), w)


def test_quantize_tree_leaf_selection():
    sd = {
        "conv.weight": torch.ones((64, 32, 3, 3)),
        "conv.bias": torch.ones((64,)),
        "tiny.weight": torch.ones((4, 4, 1, 1)),
        "up.weight": torch.ones((32, 64, 4, 4)),
        "bn.running_mean": torch.zeros((64,)),
        "bn.num_batches_tracked": torch.tensor(0),
    }
    qtree, report = qz.quantize_tree(sd, min_elems=4096,
                                     out_axes={"up.weight": 1})
    assert qz.is_qleaf(qtree["conv.weight"])
    assert qtree["up.weight"][qz.SKEY].shape == (1, 64, 1, 1)
    # The bias (1-D), the tiny weight (< min_elems) and the running mean
    # stay float; the integer counter passes through, uncounted.
    for key in ("conv.bias", "tiny.weight", "bn.running_mean",
                "bn.num_batches_tracked"):
        assert qtree[key] is sd[key]
    assert report == {
        "quantized": 2, "kept_fp": 3,
        "bytes_fp": 4 * (64 * 32 * 9 + 64 + 16 + 32 * 64 * 16 + 64),
        "bytes_q": 64 * 32 * 9 + 4 * 64 + 32 * 64 * 16 + 4 * 64
                   + 4 * (64 + 16 + 64)}
    assert qz.max_reconstruction_error(sd, qtree) <= BOUND
    back = qz.dequantize_tree(qtree)
    assert list(back) == list(sd)
    assert torch.equal(back["up.weight"], sd["up.weight"])


def test_out_channel_axes_are_the_conv_transposes():
    gen = UNetGenerator(3, 3, num_downs=5, ngf=8)
    axes = qz.out_channel_axes(gen)
    assert len(axes) == 5 and set(axes.values()) == {1}
    for key in axes:
        owner = gen.get_submodule(key.rpartition(".")[0])
        assert isinstance(owner, torch.nn.ConvTranspose2d)
    assert qz.out_channel_axes(NLayerDiscriminator(6, ndf=8)) == {}


def _jax_siamese_variables():
    model = JaxSiameseUNet(3, 1, dtype=jnp.float32)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = jax.jit(lambda k: model.init(k, x, x, train=False))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def pix2pix_variables():
    return jax_pix2pix_variables(seed=0, size=32, **SMALL_GAN)


def _jax_case(arch, pix2pix_variables):
    if arch == "siamese":
        return SiameseUNet(), _jax_siamese_variables()
    vg, vd = pix2pix_variables
    if arch == "generator":
        return UNetGenerator(3, 3, num_downs=5, ngf=8), vg
    return NLayerDiscriminator(6, ndf=8), vd


def _replace_qleaves(variables, qtree, pick):
    """``variables`` with each quantized leaf w replaced by pick(w, node)
    and every other leaf by zeros."""
    if jqz.is_qleaf(qtree):
        return pick(variables, qtree)
    if isinstance(qtree, dict):
        return {k: _replace_qleaves(variables[k], qtree[k], pick)
                for k in qtree}
    return np.zeros_like(variables)


@pytest.mark.parametrize("arch", ["siamese", "generator", "discriminator"])
def test_quantize_tree_equals_jax(arch, pix2pix_variables):
    """Every quantized tensor of the port's state_dict (the conv-transposes
    on their axis 1) holds JAX quantize_tree's int8 values and scales for
    the same weights, exactly, and the same tensors are quantized."""
    model, variables = _jax_case(arch, pix2pix_variables)
    model.load_state_dict(ti.state_dict_from_jax(model, variables),
                          strict=True)
    sd = model.state_dict()
    qtree, report = qz.quantize_tree(sd, out_axes=qz.out_channel_axes(model))
    jqtree, jreport = jqz.quantize_tree(variables)
    assert report == jreport

    def as_port(pick):
        return ti.state_dict_from_jax(
            model, _replace_qleaves(variables, jqtree, pick))

    mask = as_port(lambda w, node: np.ones_like(w))
    q8 = as_port(lambda w, node: node[jqz.QKEY].astype(np.float32))
    scale = as_port(lambda w, node: np.broadcast_to(
        node[jqz.SKEY], w.shape).astype(np.float32))
    n_quantized = 0
    for key, value in sd.items():
        if not value.is_floating_point():
            continue
        assert qz.is_qleaf(qtree[key]) == bool(mask[key].all()), key
        if qz.is_qleaf(qtree[key]):
            n_quantized += 1
            node = qtree[key]
            assert torch.equal(node[qz.QKEY].float(), q8[key]), key
            assert torch.equal(node[qz.SKEY].expand_as(value), scale[key]), key
    assert n_quantized == report["quantized"] > 0
    worst = qz.max_reconstruction_error(sd, qtree)
    assert worst == jqz.max_reconstruction_error(variables, jqtree)
    assert worst <= BOUND
