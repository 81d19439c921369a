"""The 'spatial' mesh axis of the port (``parallel/spatial.py``;
``parallel.mesh.make_mesh(n, ("data", "spatial"[, "model"]), (d, s[,
m]))``) on the CPU, against the whole maps, the meshes without the axis
and the JAX package's ("data", "spatial") mesh.

One spawn of eight gloo ranks (``_rank_main``) runs every case at 32x32
while this process runs the JAX (data 2, spatial 2) epoch.  Each case
runs once, at the least depth that crosses its transitions.  The cases on
four ranks run on both halves of the world at once, each half its own,
then the eight-rank case:

  * each height-split operation (``halo``, ``gather_rows``,
    ``split_rows``, the block-local upsample, a 4x4 stride-2 conv, a 4x4
    stride-2 conv-transpose, a 3x3 conv, and a 4x4 stride-1 conv that the
    rule runs whole) against the whole op, forward and backward, at
    float64 on s = 4 and s = 2 ranks, within 1e-12;
  * a (data 2, spatial 2) Siamese epoch of 5 pairs at batch 4 (a sharded
    step and a replicated one) against a (data 2) epoch on the same ranks:
    losses, validation, weights, BatchNorm buffers and Adam moments within
    REL64 of each tensor's largest value at float64, plain and with the
    native ``--augment`` chain; at float32 the first step's loss within
    LOSS32 (both chains);
  * (data 1, spatial 4) with ``--batched-encoder``, which runs the 2-row
    bottleneck whole on every rank, against one process, and a step on
    the fixed-size ``--augment`` chain at (2, 2), each one step of 2 pairs
    at float64, held the same way; at float32 a (2, 2) epoch streamed from
    host arrays equal to the resident one in bits;
  * a GAN epoch (``num_downs`` 5, 32 filters, batch 2, the EMA on) at
    (data 1, spatial 2), whose innermost 1-row level and the
    discriminator's two stride-1 convs run whole, against one process;
  * (data 2, spatial 2, model 2) on eight ranks against (data 2, model 2),
    one step of 2 pairs;
  * the float64 (2, 2) epoch against the JAX package's own (2, 2) epoch
    from the same init, within ROADMAP §C15's bounds;
  * a (2, 2, 2) Siamese train state and GAN resume state restored bit for
    bit in one process and under (data 4);
  * the knobs that change a conv's form and are not ported under the
    axis raise, naming themselves.
"""

import concurrent.futures
import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gan_aug_pfa_torch import checkpoint as ckpt
from gan_aug_pfa_torch.config import GANTrainConfig, SiameseTrainConfig
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.parallel import batchnorm as pbn
from gan_aug_pfa_torch.parallel import mesh as pm
from gan_aug_pfa_torch.parallel import spatial as sp
from gan_aug_pfa_torch.parallel import tensor as tp
from gan_aug_pfa_torch.pipelines import DeviceCache, NativeDeviceCache
from gan_aug_pfa_torch.train import plateau
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.train.optim import make_optimizer
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

WORLD = 8
SIZE = 32
N_PAIRS, BS = 5, 4  # a sharded step of 4, then a replicated one of 1
N_STEP = 4  # the JAX comparison's epoch: one step of 4, JAX's one compile
EPOCH_SEED = 7
GAN_ARCH = dict(num_downs=5, ngf=32, ndf=32, n_layers=3)
REL64 = 1e-10  # float64, of each tensor's largest value
LOSS32 = 1e-5  # float32, the first step's loss, relative
OPS_TOL = 1e-12  # float64, each op against the whole op
CASES = ("22", "22_augment", "22_fixed", "14", "222", "gan12")


# -- inputs, the same in every process ------------------------------------


def _cache(native=False, dtype=np.float32, n=N_PAIRS):
    """``n`` seeded pairs at SIZE (or, ``native``, at seeded native sizes
    in a padded 40x40 buffer) with about 20% change pixels."""
    rng = np.random.RandomState(0)
    side = 40 if native else SIZE
    img1, img2 = (torch.from_numpy(rng.rand(n, 3, side, side).astype(dtype))
                  for _ in range(2))
    labels = torch.from_numpy((rng.rand(n, side, side) > 0.8).astype(dtype))
    if not native:
        return DeviceCache(img1, img2, labels)
    sizes = torch.from_numpy(rng.randint(24, side + 1, (n, 2)))
    for i, (h, w) in enumerate(sizes.tolist()):
        for a in (img1[i], img2[i]):
            a[:, h:] = 0
            a[:, :, w:] = 0
        labels[i, h:] = 0
        labels[i, :, w:] = 0
    return NativeDeviceCache(img1, img2, labels, sizes)


def _siamese(mesh, dtype=torch.float32, chain=None, batch=BS, **knobs):
    """A Siamese trainer on ``mesh`` at ``dtype`` and ``batch``,
    augmenting on the ``chain`` "native" or "fixed" (None: no
    augmentation), with the config's ``knobs``."""
    cfg = SiameseTrainConfig(batch_size=batch, compute_dtype="float32",
                             **knobs)
    trainer = SiameseTrainer(
        cfg, "cpu", augment=chain is not None, mesh=mesh,
        native_out_size=(SIZE, SIZE) if chain == "native" else None)
    if dtype != torch.float32:
        trainer.model.to(dtype)
        trainer.optimizer = make_optimizer(
            cfg.optimizer, trainer.model.parameters(), cfg.learning_rate,
            cfg.weight_decay)
    return trainer


def _gan(mesh, dtype=torch.float32):
    cfg = GANTrainConfig(batch_size=2, target_size=(SIZE, SIZE),
                         compute_dtype="float32", ema_decay=0.9, **GAN_ARCH)
    trainer = GANTrainer(cfg, "cpu", mesh=mesh)
    if dtype != torch.float32:  # the parameters change in place
        trainer.generator.to(dtype)
        trainer.discriminator.to(dtype)
        trainer.reset_ema()
    return trainer


def _rel(a, b):
    """The largest difference of the floating tensors of the nested dicts
    and lists ``a`` and ``b``, each relative to the largest magnitude of
    ``b``'s tensor."""
    if torch.is_tensor(b):
        if not b.is_floating_point():
            return 0.0 if torch.equal(a, b) else float("inf")
        scale = float(b.abs().max()) or 1.0
        return float((a.double() - b.double()).abs().max()) / scale
    if isinstance(b, dict):
        if a.keys() != b.keys():
            return float("inf")
        return max([_rel(a[k], b[k]) for k in b], default=0.0)
    if isinstance(b, (list, tuple)):
        return max([_rel(x, y) for x, y in zip(a, b)], default=0.0)
    return 0.0 if a == b else abs(a - b) / (abs(b) or 1.0)


def _equal(a, b):
    """Whether the nested dicts/lists of tensors ``a`` and ``b`` are equal
    in keys, dtypes, shapes and bits."""
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(
                    a.view(torch.uint8) if a.dim() else a.reshape(1).view(
                        torch.uint8),
                    b.view(torch.uint8) if b.dim() else b.reshape(1).view(
                        torch.uint8)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _track_flax_running_var(model, world):
    """Forward hooks that follow, beside each train-mode BatchNorm's
    running variance, the one that flax's biased update would hold: each
    update's batch variance read back from torch's unbiased update with
    that update's global N (a split map's over its statistics group, a
    whole one's over the data group in a sharded step).  Returns the dict
    they fill, by ``state_dict`` key."""
    flax, names = {}, {}

    def pre(m, inputs):
        m._rv_before = m.running_var.clone()

    def post(m, inputs, out):
        if not m.training:
            return
        x = inputs[0]
        split = sp.here()
        ranks = (dist.get_world_size(split.stats_group) if split is not None
                 else world if pbn.reducing() else 1)
        n = x.numel() // x.shape[1] * ranks
        keep = 1.0 - m.momentum
        var = (m.running_var - keep * m._rv_before) / (
            m.momentum * n / (n - 1))
        key = names[m] + ".running_var"
        flax[key] = keep * flax.get(key, m._rv_before) + m.momentum * var

    for name, m in model.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)
            names[m] = name
    return flax


# -- meshes on blocks of ranks ------------------------------------------------


def _block_mesh(shape):
    """The (data, spatial, model) mesh of ``shape`` over the block of
    prod(shape) consecutive ranks that holds this rank (row-major, as
    ``make_mesh``): every rank makes every block's groups, in one order."""
    n = int(np.prod(shape))
    rank = dist.get_rank()
    coords = np.stack(np.unravel_index(np.arange(n), shape), axis=1)
    mine = {}
    for base in range(0, dist.get_world_size(), n):
        for name, varying in (("data", (0,)), ("spatial", (1,)),
                              ("model", (2,)), ("ds", (0, 1))):
            fixed = [i for i in range(3) if i not in varying]
            for key in sorted({tuple(c[fixed]) for c in coords}):
                ranks = [base + r for r in range(n)
                         if tuple(coords[r][fixed]) == key]
                group = dist.new_group(ranks)
                if rank in ranks:
                    mine[name] = (group, ranks.index(rank))
    d, s, m = shape
    return pm.DataMesh(
        d, mine["data"][1], torch.device("cpu"), "gloo",
        group=mine["data"][0], model_size=m, model_rank=mine["model"][1],
        model_group=mine["model"][0], spatial_size=s,
        spatial_rank=mine["spatial"][1], spatial_group=mine["spatial"][0],
        data_spatial_group=mine["ds"][0])


def _without_spatial(mesh):
    """The mesh of the ranks that share this rank's spatial index: its
    data and model axes (the reference a spatial mesh is held against)."""
    return dataclasses.replace(mesh, spatial_size=1, spatial_rank=0,
                               spatial_group=None, data_spatial_group=None)


# -- the cases on the ranks ------------------------------------------------


def _ops(split):
    """Each height-split op against the whole op at float64: the largest
    difference of outputs and of input and weight gradients (weight
    gradients summed over the spatial group: each rank's is its part)."""
    gen = torch.Generator().manual_seed(0)
    h = 16
    x = torch.randn(2, 3, h, 8, dtype=torch.float64, generator=gen)
    torch.manual_seed(1)
    mods = {"conv3x3": nn.Conv2d(3, 5, 3, padding=1),
            "conv1x1": nn.Conv2d(3, 5, 1),
            "conv4x4s2": nn.Conv2d(3, 5, 4, stride=2, padding=1),
            "convT4x4s2": nn.ConvTranspose2d(3, 5, 4, stride=2, padding=1),
            "conv4x4s1": nn.Conv2d(3, 5, 4, stride=1, padding=1)}
    ops = {name: (lambda m: lambda t: m(t))(m.double())
           for name, m in mods.items()}
    ops.update(upsample=lambda t: F.interpolate(
        t, scale_factor=2, mode="bilinear", align_corners=True),
        pool=lambda t: F.max_pool2d(t, 2, 2))
    diffs = {}
    with sp.splitting(split):
        for name, op in ops.items():
            module = mods.get(name)
            xw = x.clone().requires_grad_()
            yw = op(xw)
            g = torch.randn(yw.shape, dtype=torch.float64, generator=gen)
            (yw * g).sum().backward()
            wgrads = ([p.grad.clone() for p in module.parameters()]
                      if module is not None else [])
            if module is not None:
                module.zero_grad()
            xb = split.block(x, 2).clone().requires_grad_()
            if module is not None:
                y, h_out = sp.conv(module, xb, h)
            elif name == "upsample":
                y, h_out = sp.upsample2x(xb, h), 2 * h
            else:
                y, h_out = sp.max_pool2x(xb, h), h // 2
            if sp.splits(h_out):
                want, gb = split.block(yw, 2), split.block(g, 2)
            else:  # whole on every rank: each takes 1/s of the seed
                want, gb = yw, g / split.size
            (y * gb).sum().backward()
            grads = [p.grad.clone() for p in module.parameters()] \
                if module is not None else []
            for t in grads:
                dist.all_reduce(t, group=split.group)
            diffs[name] = max(
                [float((y - want).abs().max()),
                 float((xb.grad - split.block(xw.grad, 2)).abs().max())]
                + [float((a - b).abs().max()) for a, b in zip(grads,
                                                              wgrads)])
        xb = split.block(x, 2).clone().requires_grad_()
        halo = sp.halo(xb, 1, 2)
        k, n = split.rank, h // split.size
        padded = F.pad(x, (0, 0, 1, 2))
        want = padded[:, :, k * n:k * n + n + 3]
        g = torch.randn(halo.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(k))
        (halo * g).sum().backward()
        # The adjoint: <halo(x), g> summed over the ranks = <x, halo*(g)>.
        lhs = torch.tensor([float((halo * g).sum())], dtype=torch.float64)
        rhs = torch.tensor([float((xb * xb.grad).sum())], dtype=torch.float64)
        dist.all_reduce(lhs, group=split.group)
        dist.all_reduce(rhs, group=split.group)
        diffs["halo"] = max(float((halo - want).abs().max()),
                            float((lhs - rhs).abs()) / float(lhs.abs()))
        xb = split.block(x, 2).clone().requires_grad_()
        whole = sp.gather_rows(xb)
        g = torch.randn(whole.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(k))
        (whole * g).sum().backward()
        gsum = g.clone()
        dist.all_reduce(gsum, group=split.group)
        cut = sp.split_rows(x.clone().requires_grad_())
        diffs["gather_split"] = max(
            float((whole - x).abs().max()),
            float((xb.grad - split.block(gsum, 2)).abs().max()),
            float((cut - split.block(x, 2)).abs().max()))
    return diffs


def _siamese_run(mesh, dtype=torch.float64, chain=None, val=False,
                 n=N_PAIRS, world=1, batch=BS, **knobs):
    """An epoch of ``n`` pairs at ``batch``: its loss, validation
    (``val``), whole state (model, optimizer; a collective under a 'model'
    axis) and flax's running variances."""
    trainer = _siamese(mesh, dtype, chain, batch, **knobs)
    flax = _track_flax_running_var(trainer.model, world)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    loss = trainer.train_epoch(_cache(chain == "native", np_dtype, n),
                               np.random.RandomState(EPOCH_SEED))
    out = {"loss": loss,
           "val": trainer.validate(_cache(dtype=np_dtype)) if val else None,
           "model": tp.whole_state_dict(trainer.model),
           "optimizer": tp.whole_optimizer_state(trainer.model,
                                                 trainer.optimizer),
           "flax_var": flax}
    return trainer, out


def _noise_biases(model):
    """Names of the conv biases that feed a train-mode BatchNorm (the
    attention gates' ``W_g.0``, ``W_x.0`` and ``psi.0``): their gradient
    is 0 in exact arithmetic, and what a step computes is rounding noise
    (about 1e-17 at float64) that differs with the order of the
    BatchNorm's sums, so their Adam moments have no digits to compare
    relative to themselves."""
    return {f"{name}.0.bias" for name, m in model.named_modules()
            if isinstance(m, nn.Sequential) and len(m) > 1
            and isinstance(m[0], nn.Conv2d) and m[0].bias is not None
            and isinstance(m[1], nn.BatchNorm2d)}


def _moments_rel(got, want, names, noise):
    """``_rel`` of two optimizers' per-parameter states (``names`` in
    their order), but the moments of the ``noise`` parameters relative to
    the largest of that moment over every parameter."""
    top = {}
    for st in want.values():
        for k, v in st.items():
            if v.dim():
                top[k] = max(top.get(k, 0.0), float(v.abs().max()))
    worst = 0.0
    for i, st in want.items():
        for k, v in st.items():
            if names[i] in noise and v.dim():
                worst = max(worst, float((got[i][k] - v).abs().max())
                            / top[k])
            else:
                worst = max(worst, _rel(got[i][k], v))
    return worst


def _compare(got, want, model):
    """(loss and validation relative differences, the state's: the model's
    and the Adam moments' ``_rel``, the rounding-noise biases' moments
    against the largest moment)."""
    scal = max(_rel(got[k], want[k]) for k in ("loss", "val")
               if want[k] is not None)
    names = [k for k, _ in model.named_parameters()]
    return {"scalars": scal, "state": max(
        _rel(got["model"], want["model"]),
        _moments_rel(got["optimizer"]["state"], want["optimizer"]["state"],
                     names, _noise_biases(model)))}


def _against(mesh, reference, n=N_PAIRS, val=False, f32=True, **kw):
    """A float64 epoch of ``n`` pairs on ``mesh`` against ``reference``
    and (``f32``) the float32 first step's loss (``kw``:
    ``_siamese_run``'s chain and knobs), on the ranks of spatial index 0
    (the others run ``mesh``'s collectives alone): ``_compare``'s figures
    and ``loss32``; None on the others."""
    trainer, got = _siamese_run(mesh, n=n, val=val, **kw)
    if f32:
        _, got32 = _siamese_run(mesh, torch.float32, n=BS, **kw)
    if mesh.spatial_rank:
        return None
    _, want = _siamese_run(reference, n=n, val=val, **kw)
    out = _compare(got, want, trainer.model)
    if f32:
        _, want32 = _siamese_run(reference, torch.float32, n=BS, **kw)
        out["loss32"] = _rel(got32["loss"], want32["loss"])
    return out


class _ArraySource:
    """A streaming source (``data.stream.StreamingSource``'s interface)
    over a cache's rows as host arrays: NHWC float32 images, int32
    labels."""

    def __init__(self, cache):
        self.img1, self.img2 = (a.permute(0, 2, 3, 1).numpy()
                                for a in (cache.img1, cache.img2))
        self.labels = cache.labels.numpy().astype(np.int32)

    def __len__(self):
        return len(self.img1)

    def batch(self, idx):
        return self.img1[idx], self.img2[idx], self.labels[idx]

    def submit(self, idx, then=None):
        batch = self.batch(idx)
        done = concurrent.futures.Future()
        done.set_result(batch if then is None else then(batch))
        return done


def _streamed_against_resident(mesh):
    """Whether a float32 epoch of N_PAIRS (a sharded step, a replicated
    one) streamed from host arrays equals the resident epoch on ``mesh``
    in bits: (loss, weights and moments)."""
    runs = []
    for streamed in (False, True):
        trainer = _siamese(mesh)
        cache = _cache()
        rng = np.random.RandomState(EPOCH_SEED)
        loss = (trainer.train_epoch_streaming(_ArraySource(cache), rng)
                if streamed else trainer.train_epoch(cache, rng))
        runs.append((loss, trainer.model.state_dict(),
                     trainer.optimizer.state_dict()["state"]))
    (la, ma, oa), (lb, mb, ob) = runs
    return {"loss": la == lb, "state": _equal([ma, oa], [mb, ob])}


def _gan_run(mesh, dtype=torch.float64, n=4):
    trainer = _gan(mesh, dtype)
    losses = trainer.train_epoch(_cache(dtype=np.float64 if dtype ==
                                        torch.float64 else np.float32, n=n),
                                 np.random.RandomState(EPOCH_SEED))
    g, d = trainer.generator, trainer.discriminator
    return trainer, {
        "loss": losses, "G": tp.whole_state_dict(g),
        "D": tp.whole_state_dict(d),
        "EMA": tp.whole_state_dict(g, dict(trainer.ema)),
        "opt_G": tp.whole_optimizer_state(g, trainer.opt_g)["state"],
        "opt_D": tp.whole_optimizer_state(d, trainer.opt_d)["state"]}


def _gan_compare(got, want):
    return {"scalars": _rel(list(got["loss"]), list(want["loss"])),
            "state": _rel({k: v for k, v in got.items() if k != "loss"},
                          {k: v for k, v in want.items() if k != "loss"})}


def _restore_under(mesh, tmp):
    """Whether the (2, 2, 2) Siamese train state and G's resume state,
    restored under ``mesh`` (float64 trainers), give back what was saved
    in bits."""
    trainer = _siamese(mesh, torch.float64)
    restored = _state(trainer)
    path = os.path.join(tmp, "state222.pth")
    info = ckpt.restore_train_state(path, trainer.model, trainer.optimizer,
                                    *restored)
    same = _equal(ckpt.train_state(trainer.model, trainer.optimizer,
                                   *restored, info["epoch"],
                                   info["best_val_loss"]),
                  torch.load(path, weights_only=True))
    del trainer, restored
    gan = _gan(mesh, torch.float64)
    path = os.path.join(tmp, "gan222.pth")
    epoch = ckpt.restore_gan_state(path, gan.generator, gan.opt_g, gan.ema)
    return same and _equal(ckpt.gan_state(gan.generator, gan.opt_g, epoch,
                                          gan.ema),
                           torch.load(path, weights_only=True))


def _state(trainer):
    sched = plateau.make_plateau_scheduler(trainer.optimizer)
    return sched, plateau.EarlyStopping(3)


def _rank_main(rank, tmp):
    """One rank of WORLD; its results into ``tmp/rank<R>.pt``, and the
    files the test process checks."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=WORLD, rank=rank)
    half = rank // 4  # which four ranks' cases this rank runs
    # Every rank of a spatial group holds the same whole state after a
    # step: the ranks of spatial index 0 alone run the references.
    out = {"seconds": {}}
    t0 = time.time()

    def lap(name):
        nonlocal t0
        out["seconds"][name] = time.time() - t0
        t0 = time.time()

    try:
        mesh222 = pm.make_mesh(WORLD, ("data", "spatial", "model"),
                               (2, 2, 2), device="cpu")
        mesh22 = _block_mesh((2, 2, 1))
        mesh14 = _block_mesh((1, 4, 1))
        mesh12 = _block_mesh((1, 2, 1))
        mesh41 = _block_mesh((4, 1, 1))
        out["mesh222"] = (mesh222.world_size, mesh222.rank,
                          mesh222.spatial_size, mesh222.spatial_rank,
                          mesh222.model_size, mesh222.model_rank,
                          mesh222.is_main, mesh222.size)
        out["agree"] = [mesh222.agree(rank == r) for r in range(WORLD)]
        out["values"] = mesh222.broadcast_values(rank + 0.5)[0]
        lap("meshes")
        # 1. The ops: s = 4 on the first half, s = 2 on the second.
        out["ops"] = _ops((mesh14 if half == 0 else mesh12).split(True))
        lap("ops")
        if half == 0:
            # 2. (2, 2) against (data 2): float64 with validation, and
            # float32's first step, then a float64 step on the fixed-size
            # chain (a pair a data rank); 6. the JAX comparison's one-step
            # epoch; 4. the GAN at
            # (1, 2) against one process.
            out["22"] = _against(mesh22, _without_spatial(mesh22), val=True)
            lap("22")
            out["22_fixed"] = _against(mesh22, _without_spatial(mesh22),
                                       n=2, f32=False, chain="fixed")
            lap("22_fixed")
            _, got = _siamese_run(mesh22, n=N_STEP, world=2, batch=N_STEP)
            if rank == 0:
                torch.save({k: got[k] for k in ("loss", "model", "flax_var")},
                           os.path.join(tmp, "jax_case.pt"))
            lap("jax_case")
            _, got = _gan_run(mesh12)
            _, got32 = _gan_run(mesh12, torch.float32, n=2)
            if mesh12.spatial_rank == 0:
                out["gan12"] = _gan_compare(got, _gan_run(None)[1])
                out["gan12"]["loss32"] = _rel(
                    list(got32["loss"]),
                    list(_gan_run(None, torch.float32, n=2)[1]["loss"]))
            lap("gan12")
        else:
            # 2. with the native --augment chain; the streamed epoch; 3.
            # (1, 4) against one process.
            out["22_augment"] = _against(mesh22, _without_spatial(mesh22),
                                         chain="native")
            lap("22_augment")
            out["stream"] = _streamed_against_resident(mesh22)
            lap("stream")
            out["14"] = _against(mesh14, None, n=2, f32=False,
                                 batched_encoder=True)
            lap("14")
        # 5. (2, 2, 2) against (data 2, model 2) at float64, one sharded
        # step of a pair a data rank, on all eight ranks after this
        # process's JAX epoch has (most likely) ended; its state and a
        # GAN's are the checkpoints (7), restored under (data 4).
        trainer, got = _siamese_run(mesh222, n=2)
        if mesh222.spatial_rank == 0:
            out["222"] = _compare(got, _siamese_run(
                _without_spatial(mesh222), n=2)[1], trainer.model)
        saved = ckpt.train_state(trainer.model, trainer.optimizer,
                                 *_state(trainer), 1, got["loss"])
        gan, _ = _gan_run(mesh222, n=2)
        gan_saved = ckpt.gan_state(gan.generator, gan.opt_g, 1, gan.ema)
        if rank == 0:
            ckpt.save(os.path.join(tmp, "state222.pth"), saved)
            ckpt.save(os.path.join(tmp, "gan222.pth"), gan_saved)
        dist.barrier()
        del trainer, got, saved, gan, gan_saved
        lap("222")
        if half == 0:
            out["restore41"] = _restore_under(mesh41, tmp)
            lap("restore41")
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the JAX side ---------------------------------------------------------


def _jax_mesh_epoch(init_state, axes, shape):
    """The JAX package's Siamese epoch on its mesh of ``axes`` and
    ``shape`` (the conftest's virtual CPU devices) at float64 from the
    port's init, on the same pairs in the same order: (epoch loss, final
    variables in the port's layout)."""
    import jax
    import jax.numpy as jnp

    from gan_aug_pfa_tpu import config as jcfg
    from gan_aug_pfa_tpu import interop as ji
    from gan_aug_pfa_tpu import losses as jlosses
    from gan_aug_pfa_tpu.data.loader import CachedDataset
    from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxModel
    from gan_aug_pfa_tpu.parallel.mesh import make_mesh, replicate_sharding
    from gan_aug_pfa_tpu.train.siamese import SiameseTrainer as JaxTrainer
    from gan_aug_pfa_tpu.train.siamese import TrainState

    class Float32Is64:  # the JAX FocalDice at float64
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    cache = _cache(dtype=np.float64, n=N_STEP)
    nhwc = [a.permute(0, 2, 3, 1).numpy() for a in (cache.img1, cache.img2)]
    ds = CachedDataset(*nhwc, cache.labels.numpy().astype(np.int32),
                       ["city"] * N_STEP)
    init = ji.siamese_from_torch(
        {k: v.numpy() for k, v in init_state.items()})
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jlosses, "jnp", Float32Is64())
        mesh = make_mesh(int(np.prod(shape)), axes, shape)
        trainer = JaxTrainer(jcfg.SiameseTrainConfig(
            batch_size=N_STEP, compute_dtype="float32"), mesh=mesh)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, np.float64), init)
        state = jax.device_put(TrainState.create(
            apply_fn=JaxModel(3, 1, dtype=np.float64).apply,
            params=v64["params"], tx=trainer.tx,
            batch_stats=v64["batch_stats"]), replicate_sharding(mesh))
        state, loss = trainer.train_epoch(
            state, trainer._device_arrays(ds), N_STEP,
            jax.random.PRNGKey(0), np.random.RandomState(EPOCH_SEED))
        final = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return loss, {k: torch.from_numpy(np.array(v, np.float64))
                  for k, v in ji.siamese_to_torch(final).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's report, the (2, 2) float64 epoch, the JAX epoch, and
    the files the ranks wrote (deleted at the module's end)."""
    import torch.multiprocessing as mp

    with dropped(str(tmp_path_factory.mktemp("spatial_axis"))) as tmp:
        t0 = time.time()
        ctx = mp.start_processes(_rank_main, args=(tmp,), nprocs=WORLD,
                                 join=False, start_method="spawn")
        init = {k: v.clone().double() for k, v in
                _siamese(None).model.state_dict().items()}
        try:
            jax_run = _jax_mesh_epoch(init, ("data", "spatial"), (2, 2))
        finally:
            while not ctx.join():
                pass
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
        print(f"spawn {time.time() - t0:.1f} s; phases "
              f"{[ranks[r]['seconds'] for r in (0, 4)]}")
        out = {"ranks": ranks,
               "jax_case": torch.load(os.path.join(tmp, "jax_case.pt")),
               "jax": jax_run, "init": init, "tmp": tmp}
        print("worst figures:", {case: _worst(out, case) for case in CASES})
        yield out


def _worst(runs, case):
    """The largest of each of ``case``'s figures over the ranks that ran
    it."""
    reports = [r[case] for r in runs["ranks"] if r.get(case) is not None]
    return {k: max(r[k] for r in reports) for k in reports[0]}


# -- the meshes and the ops --------------------------------------------------


def test_mesh_with_three_axes_is_row_major(runs):
    """Rank r of (2, 2, 2) is data r // 4, spatial (r // 2) % 2, model
    r % 2; rank 0 is the main rank; a flag any one rank raises, and rank
    0's values, reach all eight."""
    for r, rep in enumerate(runs["ranks"]):
        assert rep["mesh222"] == (2, r // 4, 2, (r // 2) % 2, 2, r % 2,
                                  r == 0, WORLD)
        assert rep["agree"] == [True] * WORLD
        assert rep["values"] == 0.5


@pytest.mark.parametrize("op", ["conv3x3", "conv1x1", "conv4x4s2",
                                "convT4x4s2", "conv4x4s1", "upsample",
                                "pool", "halo", "gather_split"])
def test_each_split_op_equals_the_whole_op(runs, op):
    """On s = 4 and s = 2 ranks at float64: outputs, input gradients and
    the weight gradients summed over the spatial group within 1e-12 (the
    halo also as the adjoint of its backward).  Measured: equal, or a few
    units of float64 rounding."""
    for rep in runs["ranks"]:
        assert rep["ops"][op] <= OPS_TOL, (op, rep["ops"][op])


def test_mesh_errors_without_a_group():
    with pytest.raises(ValueError, match="needs 4 devices but 1 are "
                                         "selected"):
        pm.make_mesh(None, ("data", "spatial"), (2, 2), device="cpu")
    with pytest.raises(ValueError, match="wanted 8 devices but this "
                                         "process group has 1 rank"):
        pm.make_mesh(8, ("data", "spatial", "model"), (2, 2, 2),
                     device="cpu")
    mesh = pm.make_mesh(None, ("data", "spatial", "model"), (1, 1, 1),
                        device="cpu")
    assert (mesh.size, mesh.spatial_size, mesh.is_main) == (1, 1, True)
    assert mesh.split(True) is None and mesh.sum_group(False) is None


def test_split_block_refuses_a_height_that_does_not_divide():
    split = sp.Split(None, 4, 1, None)
    x = torch.arange(2 * 8.0).view(1, 1, 8, 2)
    assert torch.equal(split.block(x, 2), x[:, :, 2:4])
    with pytest.raises(ValueError, match="a height of 6 does not divide"):
        split.block(torch.zeros(1, 1, 6, 2), 2)


def test_upsample_rows_hold_all_weight_within_one_halo_row():
    """The block's rows of the align-corners matrix over its input rows
    with one halo row each side: each row's weights sum to 1 (nothing lies
    beyond the halo), for every rank of s = 2, 4, 8 at h = 8, 16, 64."""
    for h in (8, 16, 64):
        for size in (2, 4, 8):
            for rank in range(size):
                rows = sp._upsample_rows(h, rank, size, torch.float64,
                                         torch.device("cpu"))
                assert rows.shape == (2 * h // size, h // size + 2)
                assert torch.allclose(rows.sum(1), torch.ones(
                    rows.shape[0], dtype=torch.float64), atol=1e-15)


# -- the trainers against the meshes without the axis --------------------


@pytest.mark.parametrize("case", CASES)
def test_epoch_under_the_spatial_axis_equals_the_mesh_without_it(runs,
                                                                 case):
    """(2, 2), its native ``--augment`` epoch and a step on the fixed-size
    chain against (data 2); (1, 4) with ``--batched-encoder`` against one
    process (its bottleneck whole, the convs at 2B); (2, 2, 2) against
    (data 2, model 2); the GAN at (1, 2) against one process (its
    innermost level and D's tail whole).  At float64 the losses,
    validation, weights, BatchNorm buffers and Adam moments (the GAN's G,
    D, EMA and both optimizers) within REL64 of each tensor's largest
    value (the rounding-noise biases' moments of the largest moment:
    ``_noise_biases``), measured up to 2.3e-11 (the Siamese cases) and
    5.2e-11 (the GAN); at float32 the first step's losses within LOSS32,
    measured equal or within 1.2e-7."""
    worst = _worst(runs, case)
    assert worst["scalars"] <= REL64, worst
    assert worst["state"] <= REL64, worst
    assert worst.get("loss32", 0.0) <= LOSS32, worst


# The bottleneck's BatchNorms: at 32x32 its maps have 2 rows, one a
# device on JAX's (data 2, spatial 2) mesh, where JAX's own running
# statistics depart from its (data 2) epoch's (ROADMAP §C18).
BOTTLENECK_STATS = tuple(f"bottleneck.{i}.{k}" for i in (1, 4)
                         for k in ("running_mean", "running_var"))


def _within_c15(got, want, start):
    """The bounds of the data-only test against JAX's data mesh (ROADMAP
    §C15), on ``want``'s keys: the loss within 1e-6, each weight within 2
    lr a step, the median difference under 1% of the median movement, the
    running means and flax's running variances within 1e-3 of their
    largest value.  Returns the failures."""
    loss, want = want
    state = got["model"]
    failures = []
    if abs(got["loss"] - loss) > 1e-6 * abs(loss):
        failures.append(("loss", got["loss"], loss))
    params = [k for k in want
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))]
    diffs = torch.cat([(state[k] - want[k]).abs().flatten()
                       for k in params])
    moved = torch.cat([(want[k] - start[k]).abs().flatten()
                       for k in params])
    steps = 1
    if float(diffs.max()) > 2 * SiameseTrainConfig().learning_rate * steps:
        failures.append(("weights max", float(diffs.max())))
    if float(diffs.median()) >= 0.01 * float(moved.median()):
        failures.append(("weights median", float(diffs.median())))
    for k, v in want.items():
        if k.endswith("running_mean"):
            mine = state[k]
        elif k.endswith("running_var"):
            mine = got["flax_var"][k]
        else:
            continue
        if _rel(mine, v) > 1e-3:
            failures.append((k, _rel(mine, v)))
    return failures


def test_streamed_epoch_under_the_spatial_axis_equals_resident(runs):
    """At float32 on (2, 2), an epoch streamed from host arrays (each rank
    staging its rows of a sharded batch and all of a replicated one, then
    cutting its height block in ``train_batch``) equals the resident epoch
    in bits: loss, weights and moments."""
    reports = [r["stream"] for r in runs["ranks"] if "stream" in r]
    assert len(reports) == 4
    assert all(r == {"loss": True, "state": True} for r in reports), reports


def test_siamese_float64_epoch_on_data2_spatial2_matches_jax(runs):
    """The port's float64 (2, 2) epoch within §C15's bounds of the JAX
    package's (data 2, spatial 2) epoch on every leaf but the bottleneck's
    running statistics, which JAX's spatial mesh alone moves: they depart
    from the port's by more than 0.1 of their largest value (measured
    against JAX's own (data 2) epoch: running means 1.0000 and variances
    0.36 relative; ROADMAP §C18).  The port's (2, 2) epoch equals its
    (data 2) epoch within REL64 (above), and that one is held within
    §C15's bounds of JAX's (data 2) epoch on every leaf by
    ``tests/test_torch_parallel.py``."""
    got, start = runs["jax_case"], runs["init"]
    loss, want = runs["jax"]
    assert _within_c15(got, (loss, {k: v for k, v in want.items()
                                    if k not in BOTTLENECK_STATS}),
                       start) == []
    mine = {k: got["flax_var" if k.endswith("running_var") else "model"][k]
            for k in BOTTLENECK_STATS}
    departs = [_rel(want[k], mine[k]) for k in BOTTLENECK_STATS]
    assert min(departs) > 0.1, departs  # JAX's departure, as recorded


# -- checkpoints across topologies -------------------------------------------


def test_state_saved_under_2_2_2_restores_in_one_process(runs):
    """The (2, 2, 2) train state is the one-process file (keys, shapes,
    dtypes) and restores bit for bit; so does G's resume file."""
    path = os.path.join(runs["tmp"], "state222.pth")
    saved = torch.load(path, weights_only=True)
    trainer = _siamese(None, torch.float64)
    sched, stopper = _state(trainer)
    info = ckpt.restore_train_state(path, trainer.model, trainer.optimizer,
                                    sched, stopper)
    again = ckpt.train_state(trainer.model, trainer.optimizer, sched,
                             stopper, info["epoch"], info["best_val_loss"])
    assert {k: (v.shape, v.dtype) for k, v in saved["model"].items()} == {
        k: (v.shape, v.dtype) for k, v in
        SiameseUNet(3, 1).double().state_dict().items()}
    assert _equal(ckpt._map(again, lambda t: t.detach().cpu()), saved)
    gan_path = os.path.join(runs["tmp"], "gan222.pth")
    gan_saved = torch.load(gan_path, weights_only=True)
    gan = _gan(None, torch.float64)
    epoch = ckpt.restore_gan_state(gan_path, gan.generator, gan.opt_g,
                                   gan.ema)
    assert _equal(ckpt.gan_state(gan.generator, gan.opt_g, epoch, gan.ema),
                  gan_saved)


def test_state_saved_under_2_2_2_restores_under_data4(runs):
    assert [r["restore41"] for r in runs["ranks"][:4]] == [True] * 4


# -- the knobs that raise ----------------------------------------------------


_SPATIAL2 = pm.DataMesh(1, 0, torch.device("cpu"), spatial_size=2)


@pytest.mark.parametrize("knob,flag", [("concat_free", "--concat-free"),
                                       ("remat", "--remat")])
def test_siamese_knob_not_ported_under_the_axis_raises(knob, flag):
    cfg = SiameseTrainConfig(**{knob: True})
    with pytest.raises(ValueError, match=f"{flag} not ported under the "
                                         "'spatial' axis yet .ROADMAP A5"):
        SiameseTrainer(cfg, "cpu", mesh=_SPATIAL2)


def test_gan_concat_free_disc_under_the_axis_raises():
    cfg = GANTrainConfig(concat_free_disc=True, **GAN_ARCH)
    with pytest.raises(ValueError, match="--concat-free-disc not ported "
                                         "under the 'spatial' axis"):
        GANTrainer(cfg, "cpu", mesh=_SPATIAL2)


@pytest.mark.parametrize("knob", ["--concat-free", "--remat"])
def test_model_knob_refuses_split_maps(knob):
    """A model built with the knob and run under a split by hand raises
    too: nothing runs a conv on a block without its halo."""
    model = SiameseUNet(3, 1, concat_free=knob == "--concat-free",
                        remat=knob == "--remat").train()
    x = torch.zeros(1, 3, 16, 16)
    with sp.splitting(sp.Split(None, 2, 0, None)), \
            pytest.raises(ValueError, match=f"{knob}.*'spatial' axis"):
        model(x, x)
