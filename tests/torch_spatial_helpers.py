"""Helpers of the port's tests of the 'spatial' mesh axis
(``tests/test_torch_spatial_axis.py``, ``tests/test_torch_spatial_knobs.py``):
seeded 32x32 inputs, float64 trainers, meshes over blocks of gloo ranks,
the comparisons of two runs' losses and whole states, and the JAX
package's epoch on its own mesh with the bounds it is held to (ROADMAP
§C15, §C18)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from gan_aug_pfa_torch.config import GANTrainConfig, SiameseTrainConfig
from gan_aug_pfa_torch.parallel import batchnorm as pbn
from gan_aug_pfa_torch.parallel import mesh as pm
from gan_aug_pfa_torch.parallel import spatial as sp
from gan_aug_pfa_torch.parallel import tensor as tp
from gan_aug_pfa_torch.pipelines import DeviceCache, NativeDeviceCache
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.train.optim import make_optimizer
from gan_aug_pfa_torch.train.siamese import SiameseTrainer

SIZE = 32
N_PAIRS, BS = 5, 4  # a sharded step of 4, then a replicated one of 1
N_STEP = 4  # the JAX comparison's epoch: one step of 4, JAX's one compile
EPOCH_SEED = 7
GAN_ARCH = dict(num_downs=5, ngf=32, ndf=32, n_layers=3)
REL64 = 1e-10  # float64, of each tensor's largest value
LOSS32 = 1e-5  # float32, the first step's loss, relative
OPS_TOL = 1e-12  # float64, each op against the whole op


def make_cache(native=False, dtype=np.float32, n=N_PAIRS):
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


def siamese_trainer(mesh, dtype=torch.float32, chain=None, batch=BS,
                    **knobs):
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


def gan_trainer(mesh, dtype=torch.float32, **knobs):
    """A GAN trainer (GAN_ARCH, batch 2, the EMA on) on ``mesh`` at
    ``dtype``, with the config's ``knobs``."""
    cfg = GANTrainConfig(batch_size=2, target_size=(SIZE, SIZE),
                         compute_dtype="float32", ema_decay=0.9, **GAN_ARCH,
                         **knobs)
    trainer = GANTrainer(cfg, "cpu", mesh=mesh)
    if dtype != torch.float32:  # the parameters change in place
        trainer.generator.to(dtype)
        trainer.discriminator.to(dtype)
        trainer.reset_ema()
    return trainer


def rel(a, b):
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
        return max([rel(a[k], b[k]) for k in b], default=0.0)
    if isinstance(b, (list, tuple)):
        return max([rel(x, y) for x, y in zip(a, b)], default=0.0)
    return 0.0 if a == b else abs(a - b) / (abs(b) or 1.0)



def track_flax_running_var(model, world):
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


def block_mesh(shape):
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


def without_spatial(mesh):
    """The mesh of the ranks that share this rank's spatial index: its
    data and model axes (the reference a spatial mesh is held against)."""
    return dataclasses.replace(mesh, spatial_size=1, spatial_rank=0,
                               spatial_group=None, data_spatial_group=None)



def siamese_run(mesh, dtype=torch.float64, chain=None, val=False,
                 n=N_PAIRS, world=1, batch=BS, **knobs):
    """An epoch of ``n`` pairs at ``batch``: its loss, validation
    (``val``), whole state (model, optimizer; a collective under a 'model'
    axis) and flax's running variances."""
    trainer = siamese_trainer(mesh, dtype, chain, batch, **knobs)
    flax = track_flax_running_var(trainer.model, world)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    loss = trainer.train_epoch(make_cache(chain == "native", np_dtype, n),
                               np.random.RandomState(EPOCH_SEED))
    out = {"loss": loss,
           "val": (trainer.validate(make_cache(dtype=np_dtype)) if val
                   else None),
           "model": tp.whole_state_dict(trainer.model),
           "optimizer": tp.whole_optimizer_state(trainer.model,
                                                 trainer.optimizer),
           "flax_var": flax}
    return trainer, out


def noise_biases(model):
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


def moments_rel(got, want, names, noise):
    """``rel`` of two optimizers' per-parameter states (``names`` in
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
                worst = max(worst, rel(got[i][k], v))
    return worst


def compare(got, want, model):
    """(loss and validation relative differences, the state's: the model's
    and the Adam moments' ``rel``, the rounding-noise biases' moments
    against the largest moment)."""
    scal = max(rel(got[k], want[k]) for k in ("loss", "val")
               if want[k] is not None)
    names = [k for k, _ in model.named_parameters()]
    return {"scalars": scal, "state": max(
        rel(got["model"], want["model"]),
        moments_rel(got["optimizer"]["state"], want["optimizer"]["state"],
                     names, noise_biases(model)))}


def against(mesh, reference, n=N_PAIRS, val=False, f32=True, **kw):
    """A float64 epoch of ``n`` pairs on ``mesh`` against ``reference``
    and (``f32``) the float32 first step's loss (``kw``:
    ``siamese_run``'s chain and knobs), on the ranks of spatial index 0
    (the others run ``mesh``'s collectives alone): ``compare``'s figures
    and ``loss32``; None on the others."""
    trainer, got = siamese_run(mesh, n=n, val=val, **kw)
    if f32:
        _, got32 = siamese_run(mesh, torch.float32, n=BS, **kw)
    if mesh.spatial_rank:
        return None
    _, want = siamese_run(reference, n=n, val=val, **kw)
    out = compare(got, want, trainer.model)
    if f32:
        _, want32 = siamese_run(reference, torch.float32, n=BS, **kw)
        out["loss32"] = rel(got32["loss"], want32["loss"])
    return out



def gan_run(mesh, dtype=torch.float64, n=4, **knobs):
    """An epoch of ``n`` pairs: the trainer and its losses and whole
    states (a collective under a 'model' axis)."""
    trainer = gan_trainer(mesh, dtype, **knobs)
    losses = trainer.train_epoch(make_cache(dtype=np.float64 if dtype ==
                                        torch.float64 else np.float32, n=n),
                                 np.random.RandomState(EPOCH_SEED))
    g, d = trainer.generator, trainer.discriminator
    return trainer, {
        "loss": losses, "G": tp.whole_state_dict(g),
        "D": tp.whole_state_dict(d),
        "EMA": tp.whole_state_dict(g, dict(trainer.ema)),
        "opt_G": tp.whole_optimizer_state(g, trainer.opt_g)["state"],
        "opt_D": tp.whole_optimizer_state(d, trainer.opt_d)["state"]}


def gan_compare(got, want):
    return {"scalars": rel(list(got["loss"]), list(want["loss"])),
            "state": rel({k: v for k, v in got.items() if k != "loss"},
                          {k: v for k, v in want.items() if k != "loss"})}



# The bottleneck's BatchNorms: at 32x32 its maps have 2 rows, one a
# device on JAX's (data 2, spatial 2) mesh, where JAX's own running
# statistics depart from its (data 2) epoch's (ROADMAP §C18).
BOTTLENECK_STATS = tuple(f"bottleneck.{i}.{k}" for i in (1, 4)
                         for k in ("running_mean", "running_var"))


def within_c15(got, want, start):
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
        if rel(mine, v) > 1e-3:
            failures.append((k, rel(mine, v)))
    return failures


def jax_mesh_epoch(init_state, axes, shape, **knobs):
    """The JAX package's Siamese epoch on its mesh of ``axes`` and
    ``shape`` (the conftest's virtual CPU devices) at float64 from the
    port's init, on the same pairs in the same order, with the config's
    ``knobs`` (its model's too): (epoch loss, final variables in the
    port's layout)."""
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

    cache = make_cache(dtype=np.float64, n=N_STEP)
    nhwc = [a.permute(0, 2, 3, 1).numpy() for a in (cache.img1, cache.img2)]
    ds = CachedDataset(*nhwc, cache.labels.numpy().astype(np.int32),
                       ["city"] * N_STEP)
    init = ji.siamese_from_torch(
        {k: v.numpy() for k, v in init_state.items()})
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jlosses, "jnp", Float32Is64())
        mesh = make_mesh(int(np.prod(shape)), axes, shape)
        trainer = JaxTrainer(jcfg.SiameseTrainConfig(
            batch_size=N_STEP, compute_dtype="float32", **knobs), mesh=mesh)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, np.float64), init)
        state = jax.device_put(TrainState.create(
            apply_fn=JaxModel(3, 1, dtype=np.float64, **knobs).apply,
            params=v64["params"], tx=trainer.tx,
            batch_stats=v64["batch_stats"]), replicate_sharding(mesh))
        state, loss = trainer.train_epoch(
            state, trainer._device_arrays(ds), N_STEP,
            jax.random.PRNGKey(0), np.random.RandomState(EPOCH_SEED))
        final = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return loss, {k: torch.from_numpy(np.array(v, np.float64))
                  for k, v in ji.siamese_to_torch(final).items()}


