"""The port's train steps use no op that lacks a deterministic CUDA
algorithm, so ``torch.use_deterministic_algorithms(True)`` (with cuDNN's
deterministic algorithms) runs them on the card and two runs of a step
from one state give equal bits (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  On the CPU, at 32x32:

  * one Siamese train step at full width for each form (plain, each
    Siamese knob, the native and the fixed-size ``--augment`` chains; the
    streamed step runs the same ``train_batch``) and one GAN D+G step for
    each GAN form, each under a recorder of the step's autograd graphs
    (every ``backward`` call's, walked from its root) and of every ATen op
    that the step dispatches, its backward and optimizer included;
  * no graph node is one of the backward nodes that torch's
    ``use_deterministic_algorithms`` lists as raising on CUDA
    (``UpsampleBilinear2DBackward*``, ``ReflectionPad*Backward``,
    ``AdaptiveAvgPool*Backward`` ...) or a scatter/index add, and no op is
    one that raises there or adds by scatter or index;
  * the recorder finds them where they are: ``F.interpolate``'s bilinear
    backward, a reflect pad's backward and an indexed gradient.

No JAX here: this file holds the port against torch's own list.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from gan_aug_pfa_torch.config import GANTrainConfig, SiameseTrainConfig
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from torch_tmp import drop_tmp_path  # noqa: F401

SIZE = 32
BS = 2
# Backward nodes of ops that raise under deterministic mode on CUDA
# (torch.use_deterministic_algorithms' list), and the scatter and index
# adds, whose deterministic forms on CUDA sort.
FORBIDDEN_NODES = re.compile(
    r"(Upsample\w*|ReflectionPad\w*|AdaptiveAvgPool\w*|AdaptiveMaxPool\w*"
    r"|AvgPool3D|FractionalMaxPool\w*|MaxUnpool\w*|GridSampler\w*"
    r"|NllLoss\w*|CtcLoss|EmbeddingBag|Embedding|Cumsum|Put|Index"
    r"|IndexPut|IndexAdd|IndexSelect|IndexCopy|Gather|Scatter\w*"
    r"|RepeatInterleave\w*)Backward\d*")
FORBIDDEN_OPS = re.compile(
    r"_?upsample_\w+_backward|reflection_pad\dd_backward"
    r"|_?adaptive_(avg|max)_pool\dd_backward|avg_pool3d_backward"
    r"|fractional_max_pool\dd_backward|max_unpool\dd"
    r"|grid_sampler_\dd_backward|nll_loss\w*|_ctc_loss_backward"
    r"|_embedding_bag\w*|embedding_dense_backward|put_?|histc|bincount"
    r"|median|cumsum_?|scatter_reduce_?|scatter_add_?|index_add_?"
    r"|index_put\(accumulate\)")
SIAMESE_FORMS = {
    "plain": ({}, {}),
    "batched_encoder": (dict(batched_encoder=True), {}),
    "concat_free": (dict(concat_free=True), {}),
    "remat": (dict(remat=True), {}),
    "grad_accum": (dict(grad_accum=2), {}),
    "momentum_bf16": (dict(opt_momentum_dtype="bfloat16"), {}),
    "flat_opt_state": (dict(opt_flat_state=True), {}),
    "all_knobs": (dict(batched_encoder=True, concat_free=True, remat=True,
                       grad_accum=2, opt_momentum_dtype="bfloat16",
                       opt_flat_state=True), {}),
    "augment_native": ({}, dict(augment=True, native_out_size=(SIZE, SIZE))),
    "augment_fixed": ({}, dict(augment=True)),
}
GAN_FORMS = {
    "plain": {},
    "knobs": dict(batched_disc=True, concat_free_disc=True,
                  shared_gen_fwd=True, ema_decay=0.9),
    "optimizer_knobs": dict(opt_momentum_dtype="bfloat16",
                            opt_flat_state=True),
}
GAN_ARCH = dict(num_downs=5, ngf=16, ndf=16, n_layers=3)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class Recorder(TorchDispatchMode):
    """Within: the names of the ATen ops dispatched (``ops``) and of the
    autograd nodes of every graph that ``Tensor.backward`` is called on
    (``nodes``), walked from its root."""

    def __init__(self, monkeypatch):
        super().__init__()
        self.ops, self.nodes = set(), set()
        backward = torch.Tensor.backward

        def walked(tensor, *args, **kwargs):
            self._walk(tensor.grad_fn)
            return backward(tensor, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, "backward", walked)

    def _walk(self, root):
        todo, seen = [root], set()
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            self.nodes.add(type(node).__name__)
            todo.extend(fn for fn, _ in node.next_functions)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ("index_put", "index_put_", "_index_put_impl_") and (
                kwargs.get("accumulate") or args[3:4] == (True,)):
            name = "index_put(accumulate)"
        self.ops.add(name)
        return func(*args, **kwargs)

    def forbidden(self):
        return (sorted(n for n in self.nodes if FORBIDDEN_NODES.fullmatch(n)),
                sorted(o for o in self.ops if FORBIDDEN_OPS.fullmatch(o)))


def _images(b, c, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(b, c, h, w, generator=gen)


def test_recorder_finds_ops_without_a_deterministic_cuda_algorithm(
        monkeypatch):
    """The checks below are not vacuous: ``F.interpolate``'s bilinear
    backward, a reflect pad's backward and an indexed gradient are each
    caught as a node and as an op."""
    x = _images(1, 2, 4, 4, 0).requires_grad_()
    rec = Recorder(monkeypatch)
    with rec:
        y = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        y = F.pad(y, (1, 1, 1, 1), mode="reflect")
        y[:, :, torch.tensor([0, 2, 2])].sum().backward()
    nodes, ops = rec.forbidden()
    assert {"UpsampleBilinear2DBackward0", "ReflectionPad2DBackward0",
            "IndexBackward0"} <= set(nodes), rec.nodes
    assert {"upsample_bilinear2d_backward", "reflection_pad2d_backward",
            "index_put(accumulate)"} <= set(ops), rec.ops


@pytest.mark.parametrize("form", SIAMESE_FORMS)
def test_siamese_train_step_has_deterministic_cuda_algorithms(monkeypatch,
                                                              form):
    """One full-width Siamese train step (bf16 autocast, the CLI's
    default) of each form: no forbidden node or op; the decoder's
    upsample is the matrix products."""
    knobs, kw = SIAMESE_FORMS[form]
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=BS, **knobs),
                             "cpu", **kw)
    sizes = None
    h, w = SIZE, SIZE
    if kw.get("native_out_size"):
        h, w = 48, 40  # a padded native batch, each image its own extent
        sizes = torch.tensor([[48, 40], [37, 33]])
    img1, img2 = _images(BS, 3, h, w, 1), _images(BS, 3, h, w, 2)
    labels = (_images(BS, 1, h, w, 3)[:, 0] > 0.5).float()
    rec = Recorder(monkeypatch)
    with rec:
        loss = trainer.train_batch(img1, img2, labels, sizes=sizes)
    assert bool(torch.isfinite(loss))
    assert rec.forbidden() == ([], []), (rec.forbidden(), form)
    assert {"BmmBackward0", "MmBackward0"} <= rec.nodes


@pytest.mark.parametrize("form", GAN_FORMS)
def test_gan_train_step_has_deterministic_cuda_algorithms(monkeypatch,
                                                          form):
    """One GAN D+G step (bf16, batch 2) of each form, both backward
    passes walked: no forbidden node or op."""
    trainer = GANTrainer(GANTrainConfig(batch_size=BS, target_size=(
        SIZE, SIZE), **GAN_ARCH, **GAN_FORMS[form]), "cpu")
    a, b = _images(BS, 3, SIZE, SIZE, 4), _images(BS, 3, SIZE, SIZE, 5)
    rec = Recorder(monkeypatch)
    with rec:
        losses = trainer.train_batch(a, b)
    assert all(np.isfinite(float(v)) for v in
               (losses.values() if isinstance(losses, dict) else losses))
    assert rec.forbidden() == ([], []), (rec.forbidden(), form)
    assert "ConvolutionBackward0" in rec.nodes
