"""The port's reader of flax ``.msgpack`` checkpoints
(``gan_aug_pfa_torch/utils/msgpack.py``) against the ``msgpack`` and
``flax`` packages, and the JAX package's checkpoint files loaded into the
port's models on the CPU:

  * the MessagePack decoder equals ``msgpack.unpackb`` on generated nested
    data (a hypothesis property) and at every length-class and int-class
    boundary;
  * ``flax.serialization.to_bytes`` trees of every dtype the JAX package
    writes (bfloat16 included, as ``torch.bfloat16``), 0-d scalars,
    complex values, and chunked arrays decode equal to flax's own
    ``msgpack_restore``;
  * files of ``gan_aug_pfa_tpu.checkpoint.save_checkpoint``, model-only and
    full (bf16 optimizer moments), for the full-width SiameseUNet, a
    ``num_downs`` 5 generator with an EMA, and the discriminator, decode
    whole and strict-load through ``checkpoint.restore_model_only`` with
    weights equal to the JAX package's own converter's; the loaded
    models' fp32 forwards equal JAX's within 1e-5 (of the Siamese logits'
    largest magnitude);
  * the committed card fixtures (``tools/make_msgpack_fixture.py``,
    ``tools/make_gan_resume_fixture.py``) equal a rebuild.
"""

import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch.models import (
    NLayerDiscriminator,
    SiameseUNet,
    UNetGenerator,
)
from gan_aug_pfa_torch.train import optim as topt
from gan_aug_pfa_torch.utils import msgpack as tm
from gan_aug_pfa_tpu import checkpoint as jck
from gan_aug_pfa_tpu import interop as ji
from gan_aug_pfa_tpu.train.gan import GANState
from gan_aug_pfa_tpu.train.optim import make_optimizer
from gan_aug_pfa_tpu.train.siamese import TrainState
from torch_port_helpers import (
    jax_pix2pix_models,
    jax_pix2pix_variables,
    jax_siamese_logits,
    jax_siamese_variables,
)
from torch_tmp import drop_tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
ARCH = {"num_downs": 5, "ngf": 8, "ndf": 8, "n_layers": 3}
FORWARD_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs six test processes on the host's cores at once; two
    threads for this file's full-width CPU work keep them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    """``got`` (the port's decode) equals ``want`` (msgpack's or flax's):
    the same containers, numpy leaves of the same dtype and values, and
    bfloat16 leaves as ``torch.bfloat16`` tensors of the same values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif getattr(want, "dtype", None) == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert type(got) is type(want) and got == want


# -- the MessagePack decoder ------------------------------------------------

_SCALARS = (st.none() | st.booleans()
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=True) | st.text() | st.binary())
_TREES = st.recursive(
    _SCALARS,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text(max_size=8), kids, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(tree=_TREES, single_float=st.booleans())
def test_decoder_equals_msgpack_on_nested_data(tree, single_float):
    data = msgpack.packb(tree, use_bin_type=True,
                         use_single_float=single_float)
    _same(tm.unpackb(data), msgpack.unpackb(data))


_BOUNDARIES = [
    ("str", n) for n in (0, 31, 32, 255, 256, 65535, 65536)] + [
    ("bin", n) for n in (0, 255, 256, 65535, 65536)] + [
    ("array", n) for n in (0, 15, 16, 65535, 65536)] + [
    ("map", n) for n in (0, 15, 16, 65535, 65536)] + [
    ("ext", n) for n in (1, 2, 4, 8, 16, 0, 3, 17, 255, 256, 65535, 65536)]


@pytest.mark.parametrize("kind,n", _BOUNDARIES,
                         ids=[f"{k}{n}" for k, n in _BOUNDARIES])
def test_decoder_length_class_boundaries(kind, n):
    """fixstr/str8/16/32, bin8/16/32, fixarray/array16/32, fixmap/map16/32
    and fixext 1-16/ext8/16/32 at each side of each boundary."""
    value = {"str": lambda: "é" * (n // 2) + "x" * (n % 2),
             "bin": lambda: bytes(range(256)) * (n // 256) + bytes(n % 256),
             "array": lambda: list(range(n)),
             "map": lambda: {str(i): i for i in range(n)},
             "ext": lambda: msgpack.ExtType(5, bytes(n))}[kind]()
    data = msgpack.packb(value, use_bin_type=True)
    got, want = tm.unpackb(data), msgpack.unpackb(data)
    assert got == want and type(got) is type(want) or (
        kind == "ext" and tuple(got) == tuple(want))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    None, True, False, 1.5, -0.0, float("inf")])
def test_decoder_scalar_classes(value):
    for single in (False, True):
        data = msgpack.packb(value, use_single_float=single)
        _same(tm.unpackb(data), msgpack.unpackb(data))


def test_decoder_rejects_truncated_and_trailing_bytes():
    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        tm.unpackb(data[:-1])
    with pytest.raises(ValueError, match="extra bytes"):
        tm.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="invalid type byte 0xc1"):
        tm.unpackb(b"\xc1")


# -- flax's format -------------------------------------------------------------


def _flax_tree():
    rng = np.random.RandomState(0)
    return {
        "float32": rng.randn(3, 4).astype(np.float32),
        "float16": rng.randn(5).astype(np.float16),
        "bfloat16": jnp.asarray(rng.randn(2, 3), jnp.bfloat16),
        "int32": rng.randint(-9, 9, (2, 2)).astype(np.int32),
        "uint8": rng.randint(0, 256, (7,)).astype(np.uint8),
        "bool": rng.rand(4) > 0.5,
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"f32": np.float32(1.25), "i64": np.int64(-7),
                    "bf16": jnp.bfloat16(2.5), "py_int": 3, "py_float": 0.5,
                    "py_bool": True, "none": None},
        "complex": {"native": 1.5 - 2j,
                    "c64": np.asarray([1 + 2j, 3 - 4j], np.complex64)},
        "tuple": (np.arange(3, dtype=np.int32), "name", [1, 2]),
        "jax_f32": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
    }


def test_flax_tree_of_every_dtype_decodes_equal():
    data = serialization.to_bytes(_flax_tree())
    got = tm.restore(data)
    _same(got, serialization.msgpack_restore(data))
    assert got["bfloat16"].dtype == torch.bfloat16
    assert got["scalars"]["bf16"].shape == ()
    assert isinstance(got["scalars"]["f32"], np.float32)
    assert got["complex"]["native"] == 1.5 - 2j
    assert list(got["tuple"]) == ["0", "1", "2"]  # flax writes tuples so


def test_chunked_arrays_reassemble(monkeypatch):
    """flax splits arrays above MAX_CHUNK_SIZE bytes; forced small here."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(100, dtype=np.float32).reshape(4, 25),
            "nested": {"b": jnp.ones((40,), jnp.bfloat16) * 3,
                       "small": np.arange(4, dtype=np.int32)}}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = tm.restore(data)
    _same(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["nested"]["b"].shape == (40,)


def test_unknown_ext_code_stays_an_ext():
    data = msgpack.packb({"x": msgpack.ExtType(42, b"abc")})
    assert tm.restore(data) == {"x": tm.ExtType(42, b"abc")}


# -- the JAX package's checkpoint files ----------------------------------------


def _bumped(tree, scale):
    return jax.tree.map(lambda a: np.asarray(a * scale, a.dtype), tree)


def _state(cls, variables, name, **kw):
    """A JAX train state of ``variables`` with Adam(W) moments in bfloat16,
    moved off zero by one update."""
    tx = make_optimizer(name, 1e-3, mu_dtype="bfloat16")
    state = cls.create(apply_fn=None, params=variables["params"], tx=tx,
                       batch_stats=variables["batch_stats"], **kw)
    state = state.apply_gradients(grads=_bumped(variables["params"], 0.01))
    return state.replace(params=variables["params"])


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Every kind of file the JAX package writes, with the variables each
    holds."""
    d = tmp_path_factory.mktemp("jax_msgpack")
    sv = jax_siamese_variables(seed=2, size=SIZE)
    gv, dv = jax_pix2pix_variables(seed=4, size=SIZE, **ARCH)
    ema = _bumped(gv["params"], 0.5)
    ss = _state(TrainState, sv, "adamw")
    sg = _state(GANState, gv, "adam", ema_params=ema)
    sd = _state(GANState, dv, "adam")
    files = {
        "best_model": (ss, True, sv, {"epoch": 3, "val_loss": 0.25}),
        "last_state": (ss, False, sv, {
            "epoch": 3, "best_val_loss": 0.25,
            "scheduler": {"lr": 1e-4, "best": 0.25, "num_bad": 0},
            "early_stop": {"best": 0.25, "num_bad_epochs": 0}}),
        "generator_epoch_1": (sg, True, gv, {"epoch": 1}),
        "generator_ema_epoch_1": (
            sg.replace(params=ema, ema_params=None), True,
            {"params": ema, "batch_stats": gv["batch_stats"]},
            {"epoch": 1, "ema_decay": 0.9}),
        "last_generator": (sg, False, gv, {"epoch": 1}),
        "discriminator_epoch_1": (sd, True, dv, {"epoch": 1}),
        "last_discriminator": (sd, False, dv, {"epoch": 1}),
    }
    out = {}
    for stem, (state, model_only, variables, extra) in files.items():
        path = str(d / f"{stem}.msgpack")
        jck.save_checkpoint(path, state, extra=extra, model_only=model_only)
        out[stem] = (path, variables)
    yield out
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("stem", [
    "best_model", "last_state", "generator_epoch_1", "generator_ema_epoch_1",
    "last_generator", "discriminator_epoch_1", "last_discriminator"])
def test_jax_checkpoint_decodes_whole(jax_files, stem):
    """The whole file, optax state and bf16 moments included, decodes
    equal to flax's own reader."""
    path, _ = jax_files[stem]
    with open(path, "rb") as f:
        data = f.read()
    got = ti.variables_from_msgpack(path)
    _same(got, serialization.msgpack_restore(data))
    full = stem.startswith("last_")
    assert ("opt_state" in got) == full and ("step" in got) == full
    if full:
        dtypes = {leaf.dtype for leaf in jax.tree.leaves(
            got["opt_state"], is_leaf=lambda x: isinstance(x, torch.Tensor))}
        assert torch.bfloat16 in dtypes and np.dtype(np.int32) in dtypes


def _inputs(channels, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, SIZE, SIZE, channels) * 2 - 1).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _assert_weights_as_jax_interop(model, want):
    """Every tensor of ``model`` equals the JAX package's own converter's
    (``interop.*_to_torch``) exactly."""
    sd = model.state_dict()
    assert set(want) <= set(sd)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("stem", ["best_model", "last_state"])
def test_siamese_files_load_and_forward_as_jax(jax_files, stem):
    """The weights exactly; the logits within 1e-5 of their largest
    magnitude (the helper scales the head so that logits spread over a few
    units, as a trained model's do: about 5 here, where float32 rounding
    over the full-width model leaves about 1e-5 absolute)."""
    path, variables = jax_files[stem]
    model = tck.restore_model_only(path, SiameseUNet()).eval()
    _assert_weights_as_jax_interop(model, ji.siamese_to_torch(variables))
    x1, x2 = _inputs(3, 0), _inputs(3, 1)
    want = jax_siamese_logits(variables, x1, x2)
    with torch.no_grad():
        got = model(_nchw(x1), _nchw(x2)).permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(want).max())
    assert scale > 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=FORWARD_ATOL)


@pytest.mark.parametrize("stem", [
    "generator_epoch_1", "generator_ema_epoch_1", "last_generator",
    "discriminator_epoch_1", "last_discriminator"])
def test_pix2pix_files_load_and_forward_as_jax(jax_files, stem):
    """Each generator file loads its own weights (the EMA file its EMA, a
    full file its params), each discriminator file its own."""
    path, variables = jax_files[stem]
    i = 1 if "discriminator" in stem else 0
    model = (UNetGenerator(num_downs=ARCH["num_downs"], ngf=ARCH["ngf"]),
             NLayerDiscriminator(ndf=ARCH["ndf"],
                                 n_layers=ARCH["n_layers"]))[i]
    tck.restore_model_only(path, model)
    _assert_weights_as_jax_interop(
        model, (ji.generator_to_torch, ji.discriminator_to_torch)[i](
            variables))
    x = _inputs(3 * (i + 1), 2)
    jmodel = jax_pix2pix_models(**ARCH)[i]
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, x))
    with torch.no_grad():
        got = model.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)


def test_ema_file_differs_from_the_params(jax_files):
    """The EMA and the params differ, so the test above tells them apart."""
    g = [tck.restore_model_only(jax_files[s][0], UNetGenerator(
        num_downs=ARCH["num_downs"], ngf=ARCH["ngf"])).state_dict()
        for s in ("generator_epoch_1", "generator_ema_epoch_1")]
    key = "model.model.0.weight"
    assert torch.equal(g[1][key], g[0][key] * 0.5)
    assert torch.equal(g[1]["model.model.1.model.2.running_mean"],
                       g[0]["model.model.1.model.2.running_mean"])


def test_loading_stays_strict(jax_files):
    """A generator file into a discriminator, or a generator of another
    depth, fails: the converters' keys must match the model's."""
    path = jax_files["generator_epoch_1"][0]
    with pytest.raises(Exception):
        tck.restore_model_only(path, NLayerDiscriminator(ndf=8))
    with pytest.raises(RuntimeError):
        tck.restore_model_only(path, UNetGenerator(num_downs=6, ngf=8))
    with pytest.raises(TypeError, match="no JAX converter"):
        ti.state_dict_from_jax(torch.nn.Linear(1, 1),
                               jax_files["generator_epoch_1"][1])


def test_find_checkpoint_prefers_pth_then_msgpack(tmp_path, jax_files):
    assert tck.find_checkpoint(str(tmp_path), "best_model") is None
    (tmp_path / "best_model.msgpack").write_bytes(b"\x80")
    assert tck.find_checkpoint(str(tmp_path), "best_model") == str(
        tmp_path / "best_model.msgpack")
    tck.save_model(str(tmp_path / "best_model.pth"), torch.nn.Linear(1, 1))
    assert tck.find_checkpoint(str(tmp_path), "best_model") == str(
        tmp_path / "best_model.pth")
    # A resume finds the JAX state; an empty map is no train state.  The
    # bf16 moments of these files restore into an optimizer with bf16
    # moments (--momentum-dtype bfloat16); into one without, they raise
    # naming both layouts (the CLIs exit 2).
    (tmp_path / "only_jax.msgpack").write_bytes(b"\x80")
    path = tck.find_checkpoint(str(tmp_path), "only_jax")
    assert path.endswith(".msgpack")
    model = SiameseUNet()
    opt = torch.optim.AdamW(model.parameters())
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(opt)
    with pytest.raises(tck.ResumeStateError, match="not a JAX train state"):
        tck.restore_train_state_from_jax(path, model, opt, sched, None)
    bf16 = "bfloat16 first moments .--momentum-dtype bfloat16."
    with pytest.raises(tck.ResumeLayoutError,
                       match=f"state is {bf16}; this run's flags give "
                             "per-parameter float32 moments"):
        tck.restore_train_state_from_jax(jax_files["last_state"][0], model,
                                         opt, sched, None)
    gen = UNetGenerator(num_downs=ARCH["num_downs"], ngf=ARCH["ngf"])
    with pytest.raises(tck.ResumeLayoutError, match=bf16):
        tck.restore_gan_state_from_jax(jax_files["last_generator"][0], gen,
                                       torch.optim.Adam(gen.parameters()))
    opt = topt.make_optimizer("adam", gen.parameters(), 1e-3,
                              mu_dtype="bfloat16")
    assert tck.restore_gan_state_from_jax(
        jax_files["last_generator"][0], gen, opt) == 1
    assert any(float(m.float().abs().max()) > 0 for m in opt.exp_avg)
    assert tck.find_checkpoint(str(tmp_path), "absent") is None


# -- the card's fixture ----------------------------------------------------------


def test_committed_card_fixture_equals_a_rebuild(tmp_path):
    """tools/make_msgpack_fixture.py run again: the same checkpoint tree
    and the same input (exactly), the same output (within 1e-6: XLA's CPU
    convolutions may split their sums by the host's threads)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import make_msgpack_fixture as fixture
    finally:
        sys.path.pop(0)
    ckpt, npz = fixture.make(str(tmp_path))
    committed = os.path.join(REPO, "tests", "data")
    name = fixture.NAME
    _same(ti.variables_from_msgpack(os.path.join(committed,
                                                 name + ".msgpack")),
          ti.variables_from_msgpack(ckpt))
    want, got = (np.load(p) for p in (
        npz, os.path.join(committed, name + "_expected.npz")))
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=1e-6)
    assert got["x"].shape == (2, 32, 32, 3)
    total = sum(os.path.getsize(os.path.join(committed, n + ext))
                for n, ext in ((name, ".msgpack"),
                               (name, "_expected.npz")))
    assert total < 512 * 1024
    # The port's generator reproduces the output on the CPU too.
    model = tck.restore_model_only(
        os.path.join(committed, name + ".msgpack"),
        UNetGenerator(num_downs=fixture.NUM_DOWNS, ngf=fixture.NGF)).eval()
    with torch.no_grad():
        y = model(_nchw(got["x"])).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, got["y"], rtol=0, atol=FORWARD_ATOL)


def test_committed_gan_resume_fixture_equals_a_rebuild(tmp_path):
    """tools/make_gan_resume_fixture.py run again (one JAX GAN epoch and
    one D+G step on the CPU): the same step batch and epoch (exactly), the
    same resume pair, trees of the same keys, shapes and dtypes with equal
    values (within 1e-5 relative: XLA's CPU convolutions may split their
    sums by the host's threads), and the same losses."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import make_gan_resume_fixture as fixture
    finally:
        sys.path.pop(0)
    pair_dir, npz = fixture.make(str(tmp_path))
    committed = os.path.join(REPO, "tests", "data")
    total = 0
    for stem in fixture.STEMS:
        path = os.path.join(committed, fixture.NAME, stem + ".msgpack")
        total += os.path.getsize(path)
        want = serialization.msgpack_restore(open(path, "rb").read())
        got = serialization.msgpack_restore(open(
            os.path.join(pair_dir, stem + ".msgpack"), "rb").read())
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
        assert "ema_params" in want or stem == "last_discriminator"
        assert want["extra"] == {"epoch": 1}
    assert total < 2 * 1024 * 1024
    got, want = np.load(npz), np.load(os.path.join(
        committed, fixture.NAME + "_expected.npz"))
    for key in ("a", "b", "epoch"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("loss_d", "loss_g"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
