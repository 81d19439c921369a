"""The tensor-parallel 'model' axis of the port (``parallel/tensor.py``;
``parallel.mesh.make_mesh(n, ("data", "model"), (d, m))``) on the CPU,
against the JAX package's ``param_shardings`` (its
``parallel/mesh.py:84-119``) and against the data-only mesh.

The rule, in this process: at full width, for the Siamese net, the
generator and the discriminator at model extents 2 and 4 and on the JAX
(data 2, model 2) mesh, the leaves that JAX shards (its trees from
``jax.eval_shape`` of ``init``, nothing compiled) are the port's sharded
leaves, along the output-channel dim (dim 1 of a ``ConvTranspose2d``),
and no other: 74 of 164, 41 of 59 and 10 of 19.

One spawn of four gloo ranks (``_rank_main``) runs every other case at
32x32 while this process runs the JAX (data 2, model 2) epoch:

  * a (data 2, model 2) Siamese epoch (7 pairs at batch 4: a sharded step
    and a replicated one) equals a (data 2) epoch on two of the same
    ranks at float32 bit for bit (losses, validation, weights, BatchNorm
    buffers, Adam moments): plain, ``--augment`` on the native chain, and
    ``--momentum-dtype bfloat16 --flat-opt-state``; at float64 within
    1e-12 of each tensor's largest value (measured: equal); a GAN epoch of
    two steps at batch 2 with the EMA on (a generator and discriminator of
    32 and 32 filters, so that convs, a conv-transpose and BatchNorms
    shard) likewise bit for bit;
  * the float64 (2, 2) epoch against the JAX package's own (2, 2) epoch
    from the same init, within the bounds that
    ``test_torch_parallel.py::test_siamese_epoch_on_two_ranks_matches_
    jax_mesh_epoch`` states (ROADMAP §C15);
  * each rank's parameter and Adam-moment elements equal the rule's
    prediction exactly;
  * a train state saved under (2, 2) is the one-process file (keys,
    shapes, dtypes, a strict load) and restores bit for bit in one
    process and under (1, 4); a JAX train state (the JAX (2, 2) epoch's,
    saved by its ``save_checkpoint``) resumes into (2, 2) as into one
    process;
  * the mesh's errors: a shape that does not fit the axes or the ranks;
    a 'spatial' extent above 1 is no error since the axis is ported
    (``tests/test_torch_spatial_axis.py``).
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from gan_aug_pfa_torch import checkpoint as ckpt
from gan_aug_pfa_torch.config import GANTrainConfig, SiameseTrainConfig
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.models.pix2pix import NLayerDiscriminator, UNetGenerator
from gan_aug_pfa_torch.parallel import mesh as pm
from gan_aug_pfa_torch.parallel import tensor as tp
from gan_aug_pfa_torch.parallel.batchnorm import reducing
from gan_aug_pfa_torch.pipelines import DeviceCache, NativeDeviceCache
from gan_aug_pfa_torch.train import plateau
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.train.optim import make_optimizer
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

WORLD = 4
SHAPE = (2, 2)  # (data, model)
SIZE = 32
N_PAIRS, BS = 7, 4  # a sharded step of 4, then a replicated one of 3
N_STEP = 4  # one sharded step: the other cases, and JAX's compile
EPOCH_SEED = 7
GAN_ARCH = dict(num_downs=5, ngf=32, ndf=32, n_layers=3)
JAX_WAIT_S = 600.0


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


def _siamese(mesh, dtype=torch.float32, native=False, **knobs):
    cfg = SiameseTrainConfig(batch_size=BS, compute_dtype="float32",
                             **knobs)
    trainer = SiameseTrainer(cfg, "cpu", augment=native,
                             native_out_size=(SIZE, SIZE) if native else None,
                             mesh=mesh)
    if dtype != torch.float32:
        trainer.model.to(dtype)
        trainer.optimizer = make_optimizer(
            cfg.optimizer, trainer.model.parameters(), cfg.learning_rate,
            cfg.weight_decay, mu_dtype=cfg.opt_momentum_dtype,
            flat_state=cfg.opt_flat_state, grad_accum=cfg.grad_accum)
    return trainer


def _track_flax_running_var(model, world):
    """Forward hooks that follow, beside each train-mode BatchNorm's
    running variance (its block, when sharded), the one that flax's
    biased update would hold: each update's batch variance read back from
    torch's unbiased update with that update's N (the data group's global
    batch in a sharded step).  Returns a callable that gives them whole
    by ``state_dict`` key (a collective)."""
    flax = {}

    def pre(m, inputs):
        m._rv_before = m.running_var.clone()

    def post(m, inputs, out):
        if not m.training:
            return
        x = inputs[0]
        n = x.numel() // x.shape[1] * (world if reducing() else 1)
        keep = 1.0 - m.momentum
        var = (m.running_var - keep * m._rv_before) / (
            m.momentum * n / (n - 1))
        flax[m] = keep * flax.get(m, m._rv_before) + m.momentum * var

    names = {}
    for name, m in model.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)
            names[m] = name

    def whole():
        out = {}
        for m, v in flax.items():
            shard = tp.shard_of(m)
            if shard is not None and "running_var" in shard.dims:
                v = tp.gather_value(v, 0, shard)
            out[names[m] + ".running_var"] = v
        return out

    return whole


def _equal(a, b):
    """0.0 when the nested dicts/lists of tensors ``a`` and ``b`` are bit
    for bit equal (keys, dtypes, shapes, bits), else the largest
    difference (inf for a structural one)."""
    if torch.is_tensor(a):
        if (not torch.is_tensor(b) or a.dtype != b.dtype
                or a.shape != b.shape):
            return float("inf")
        if a.is_floating_point():
            same = torch.equal(a.view(torch.int16 if a.element_size() == 2
                                      else torch.int32 if a.element_size()
                                      == 4 else torch.int64),
                               b.view(torch.int16 if b.element_size() == 2
                                      else torch.int32 if b.element_size()
                                      == 4 else torch.int64))
            return 0.0 if same else float((a.double() - b.double()).abs()
                                          .max())
        return 0.0 if torch.equal(a, b) else float("inf")
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return float("inf")
        return max([_equal(a[k], b[k]) for k in a], default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return float("inf")
        return max([_equal(x, y) for x, y in zip(a, b)], default=0.0)
    return 0.0 if a == b else float("inf")


def _worst(x: float) -> float:
    """The largest of ``x`` over the ranks."""
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _rel(a, b):
    """The largest difference of the floating tensors of the nested dicts
    and lists ``a`` and ``b``, each relative to the largest magnitude of
    ``b``'s tensor."""
    if torch.is_tensor(b):
        if not b.is_floating_point():
            return 0.0
        scale = float(b.abs().max()) or 1.0
        return float((a.double() - b.double()).abs().max()) / scale
    if isinstance(b, dict):
        return max([_rel(a[k], b[k]) for k in b], default=0.0)
    if isinstance(b, (list, tuple)):
        return max([_rel(x, y) for x, y in zip(a, b)], default=0.0)
    return 0.0


# -- the cases on the ranks --------------------------------------------------


def _siamese_run(mesh, dtype=torch.float32, native=False, val=False,
                 n=N_STEP, whole=True, **knobs):
    """An epoch of ``n`` pairs: its loss, validation (``val``), state (the
    whole one a checkpoint holds, gathered once; this rank's own when not
    ``whole``) and flax's running variances."""
    trainer = _siamese(mesh, dtype, native, **knobs)
    flax = _track_flax_running_var(trainer.model, mesh.world_size)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    loss = trainer.train_epoch(_cache(native, np_dtype, n),
                               np.random.RandomState(EPOCH_SEED))
    val = trainer.validate(_cache(dtype=np_dtype)) if val else None
    if whole:
        out = ckpt.train_state(trainer.model, trainer.optimizer,
                               *_state(trainer), 1, val or 0.0)
    else:
        out = {"model": trainer.model.state_dict(),
               "optimizer": trainer.optimizer.state_dict()}
    out.update(loss=loss, val=val, flax_var=flax())
    return trainer, out


def _gan_run(mesh):
    cfg = GANTrainConfig(batch_size=2, target_size=(SIZE, SIZE),
                         compute_dtype="float32", ema_decay=0.9, **GAN_ARCH)
    trainer = GANTrainer(cfg, "cpu", mesh=mesh)
    cache = _cache(n=4)
    losses = trainer.train_epoch(cache, np.random.RandomState(EPOCH_SEED))
    g, d = trainer.generator, trainer.discriminator
    return trainer, {
        "loss": losses,
        "G": tp.whole_state_dict(g), "D": tp.whole_state_dict(d),
        "EMA": tp.whole_state_dict(g, dict(trainer.ema)),
        "opt_G": tp.whole_optimizer_state(g, trainer.opt_g),
        "opt_D": tp.whole_optimizer_state(d, trainer.opt_d)}


def _gan_checkpoints(trainer, mesh14, rank, tmp):
    """G's resume file (with its EMA) and bare model file saved under
    (2, 2), restored under (1, 4) through ``restore_gan_state``,
    ``restore_model_only`` and ``load_state_dicts``: the largest
    difference of what each gives back, gathered, from what was saved."""
    g = trainer.generator
    payload = ckpt.gan_state(g, trainer.opt_g, 1, trainer.ema)
    d = tp.whole_state_dict(trainer.discriminator)
    paths = [os.path.join(tmp, f) for f in ("gan22.pth", "g22.pth")]
    if rank == 0:
        ckpt.save(paths[0], payload)
        ckpt.save_state_dict(paths[1], payload["model"])
    dist.barrier()
    t14 = GANTrainer(trainer.config, "cpu", mesh=mesh14)
    g14 = t14.generator
    epoch = ckpt.restore_gan_state(paths[0], g14, t14.opt_g, t14.ema)
    diffs = [_equal(ckpt.gan_state(g14, t14.opt_g, epoch, t14.ema),
                    payload)]
    ckpt.restore_model_only(paths[1], g14)
    diffs.append(_equal(tp.whole_state_dict(g14), payload["model"]))
    t14.load_state_dicts(payload["model"], d)
    diffs += [_equal(tp.whole_state_dict(g14), payload["model"]),
              _equal(tp.whole_state_dict(t14.discriminator), d),
              _equal(tp.whole_state_dict(g14, dict(t14.ema)),
                     {k: payload["model"][k] for k in t14.ema})]
    return diffs


def _state(trainer):
    sched = plateau.make_plateau_scheduler(trainer.optimizer)
    return sched, plateau.EarlyStopping(3)


def _counts(trainer):
    """This rank's parameter and Adam-moment elements."""
    opt = trainer.optimizer.state_dict()["state"]
    return {"params": sum(p.numel() for p in trainer.model.parameters()),
            "moments": sum(st[k].numel() for st in opt.values()
                           for k in ("exp_avg", "exp_avg_sq"))}


def _mesh_errors():
    """The messages of ``make_mesh``'s errors on a group of WORLD ranks
    (raised before any group is made, so every rank takes them alike);
    for the (data 2, spatial 2) mesh, which it makes, its spatial extent
    and this rank's place on it."""
    got = {}
    for name, args in (("spatial", (WORLD, ("data", "spatial"), (2, 2))),
                       ("shape", (WORLD, ("data", "model"), (2, 3))),
                       ("dims", (WORLD, ("data", "model"), (4,))),
                       ("count", (2, ("data", "model"), (1, 2)))):
        try:
            mesh = pm.make_mesh(*args, device="cpu")
        except ValueError as e:
            got[name] = str(e)
        else:
            got[name] = (mesh.spatial_size, mesh.spatial_rank, mesh.size)
    return got


def _wait_for(path):
    deadline = time.time() + JAX_WAIT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path} after {JAX_WAIT_S} s")
        time.sleep(0.5)


def _rank_main(rank, tmp):
    """One rank of WORLD: every case on the (2, 2) mesh and on the (data
    2) mesh of its pair of ranks ({0, 1} or {2, 3}); rank 0 writes what
    this process checks to ``tmp``."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=WORLD, rank=rank)
    try:
        out = {"errors": _mesh_errors()}
        mesh = pm.make_mesh(WORLD, ("data", "model"), SHAPE, device="cpu")
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        data = pm.DataMesh(2, rank % 2, torch.device("cpu"), "gloo",
                           group=pairs[rank // 2])
        mesh14 = pm.make_mesh(WORLD, ("data", "model"), (1, 4),
                              device="cpu")
        out["mesh"] = (mesh.world_size, mesh.rank, mesh.model_size,
                       mesh.model_rank, mesh.is_main, mesh.size)
        # Decisions reach every rank of the mesh, over both axes.
        out["agree"] = [_worst(float(mesh.agree(rank == r)))
                        for r in range(WORLD)]
        out["values"] = _worst(abs(mesh.broadcast_values(rank + 0.5)[0]
                                   - 0.5))
        diffs = {}
        # Whole states (gathered) where the checkpoint and the flat
        # moments' layout are held; elsewhere each rank's own blocks
        # against its cut of the (data 2) state, on every rank.
        for case, kw in (("plain", dict(val=True, n=N_PAIRS)),
                         ("augment", dict(native=True, whole=False)),
                         ("knobs", dict(opt_momentum_dtype="bfloat16",
                                        opt_flat_state=True)),
                         ("plain64", dict(dtype=torch.float64,
                                          whole=False))):
            trainer, got = _siamese_run(mesh, **kw)
            _, want = _siamese_run(data, **kw)
            if not kw.get("whole", True):
                want["model"] = tp.cut_state_dict(trainer.model,
                                                  want["model"])
                want["optimizer"] = tp.cut_optimizer_state(
                    trainer.model, trainer.optimizer, want["optimizer"])
            diffs[case] = {k: _worst(_equal(got[k], want[k]))
                           for k in ("loss", "val", "model", "optimizer")}
            diffs[case]["rel"] = (_worst(_rel(
                [got["model"], got["optimizer"]],
                [want["model"], want["optimizer"]]))
                if case == "plain64" else None)
            if case == "plain":
                out["shapes"] = {k: tuple(v.shape) for k, v in
                                 trainer.model.state_dict().items()}
                out["counts"] = _counts(trainer)
                path = os.path.join(tmp, "state22.pth")
                saved = {k: v for k, v in got.items()
                         if k not in ("loss", "val", "flax_var")}
                if rank == 0:
                    ckpt.save(path, saved)
                dist.barrier()
                out["own_blocks"] = _equal(
                    tp.cut_state_dict(trainer.model, saved["model"]),
                    trainer.model.state_dict())
                t14 = _siamese(mesh14)
                restored = _state(t14)
                info = ckpt.restore_train_state(path, t14.model,
                                                t14.optimizer, *restored)
                again = ckpt.train_state(t14.model, t14.optimizer,
                                         *restored, info["epoch"],
                                         info["best_val_loss"])
                out["restore14"] = _equal(again, saved)
                out["shapes14"] = {k: tuple(v.shape) for k, v in
                                   t14.model.state_dict().items()}
                del t14, again, saved
            if case == "plain64":
                model = tp.whole_state_dict(trainer.model)
                if rank == 0:
                    torch.save({"loss": got["loss"], "model": model,
                                "flax_var": got["flax_var"]},
                               os.path.join(tmp, "plain64.pt"))
            del trainer, got, want
        gan, got = _gan_run(mesh)
        _, want = _gan_run(data)
        diffs["gan"] = {k: _equal(got[k], want[k]) for k in got}
        out["gan_shapes"] = {k: tuple(v.shape) for k, v in got["G"].items()}
        out["gan_restore14"] = _gan_checkpoints(gan, mesh14, rank, tmp)
        out["diffs"] = diffs
        # The JAX (2, 2) epoch's state, written by this test's process.
        path = os.path.join(tmp, "jax", "last_state.msgpack")
        _wait_for(path)
        trainer = _siamese(mesh)
        restored = _state(trainer)
        info = ckpt.restore_train_state(path, trainer.model,
                                        trainer.optimizer, *restored)
        resumed = ckpt.train_state(trainer.model, trainer.optimizer,
                                   *restored, info["epoch"],
                                   info["best_val_loss"])
        if rank == 0:
            ckpt.save(os.path.join(tmp, "jax_resume22.pth"), resumed)
            torch.save(out, os.path.join(tmp, "rank0.pt"))
    finally:
        dist.destroy_process_group()


# -- the JAX side ---------------------------------------------------------


def _jax_model_axis_epoch(init_state, path):
    """The JAX package's Siamese epoch on its (data 2, model 2) mesh (the
    conftest's virtual CPU devices, ``param_shardings`` over the train
    state) at float64 from the port's init, on the same pairs in the
    same order: (epoch loss, final variables in the port's layout, the
    count of leaves it sharded).  Its final state, at float32, is saved
    to ``path`` by its ``save_checkpoint``."""
    import jax
    import jax.numpy as jnp

    from gan_aug_pfa_tpu import checkpoint as jck
    from gan_aug_pfa_tpu import config as jcfg
    from gan_aug_pfa_tpu import interop as ji
    from gan_aug_pfa_tpu import losses as jlosses
    from gan_aug_pfa_tpu.data.loader import CachedDataset
    from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxModel
    from gan_aug_pfa_tpu.parallel.mesh import make_mesh, param_shardings
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
        mesh = make_mesh(WORLD, ("data", "model"), SHAPE)
        trainer = JaxTrainer(jcfg.SiameseTrainConfig(
            batch_size=BS, compute_dtype="float32"), mesh=mesh)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, np.float64), init)
        state = TrainState.create(
            apply_fn=JaxModel(3, 1, dtype=np.float64).apply,
            params=v64["params"], tx=trainer.tx,
            batch_stats=v64["batch_stats"])
        state = jax.device_put(state, param_shardings(mesh, state))
        n_sharded = sum(not x.sharding.is_fully_replicated
                        for x in jax.tree_util.tree_leaves(state.params))
        state, loss = trainer.train_epoch(
            state, trainer._device_arrays(ds), N_STEP,
            jax.random.PRNGKey(0), np.random.RandomState(EPOCH_SEED))
        final = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
        as32 = jax.tree.map(lambda a: np.asarray(a).astype(np.float32)
                            if np.issubdtype(np.asarray(a).dtype,
                                             np.floating) else np.asarray(a),
                            {"params": state.params,
                             "batch_stats": state.batch_stats,
                             "opt_state": state.opt_state})
    from types import SimpleNamespace

    jck.save_checkpoint(path, SimpleNamespace(step=int(state.step), **as32),
                        extra={"epoch": 1, "best_val_loss": float(loss)})
    return loss, {k: torch.from_numpy(np.array(v, np.float64))
                  for k, v in ji.siamese_to_torch(final).items()}, n_sharded


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """What rank 0 reported, the (2, 2) float64 epoch, the JAX epoch, and
    the files the ranks wrote (deleted at the module's end).  The rule's
    JAX trees (``trees``) are built while the ranks run."""
    import torch.multiprocessing as mp

    with dropped(str(tmp_path_factory.mktemp("model_axis"))) as tmp:
        os.makedirs(os.path.join(tmp, "jax"))
        ctx = mp.start_processes(_rank_main, args=(tmp,), nprocs=WORLD,
                                 join=False, start_method="spawn")
        init = {k: v.clone().double() for k, v in
                _siamese(None).model.state_dict().items()}
        try:
            jax_run = _jax_model_axis_epoch(
                init, os.path.join(tmp, "jax", "last_state.msgpack"))
            request.getfixturevalue("trees")
        finally:
            while not ctx.join():
                pass
        yield {"rank0": torch.load(os.path.join(tmp, "rank0.pt"),
                                   weights_only=False),
               "plain64": torch.load(os.path.join(tmp, "plain64.pt")),
               "jax": jax_run, "init": init, "tmp": tmp}


# -- the ranks against the data-only mesh -----------------------------------


def test_mesh_on_four_ranks_is_row_major(runs):
    """Rank 0 of (data 2, model 2) is data 0, model 0, the main rank; a
    flag any one rank raises, and rank 0's values, reach all four."""
    assert runs["rank0"]["mesh"] == (2, 0, 2, 0, True, WORLD)
    assert runs["rank0"]["agree"] == [1.0] * WORLD
    assert runs["rank0"]["values"] == 0.0


def test_mesh_errors_on_four_ranks(runs):
    errors = runs["rank0"]["errors"]
    assert errors["spatial"] == (2, 0, WORLD)  # made: the axis is ported
    assert "shape (2, 3) needs 6 devices but 4 are selected" in \
        errors["shape"]
    assert "shape (4,) has 1 dims but axis_names ('data', 'model') has 2" \
        in errors["dims"]
    assert "wanted 2 of the group's 4 ranks" in errors["count"]


def test_mesh_errors_without_a_group():
    with pytest.raises(ValueError, match="needs 4 devices but 1 are "
                                         "selected"):
        pm.make_mesh(None, ("data", "model"), (2, 2), device="cpu")
    with pytest.raises(ValueError, match="wanted 4 devices but this "
                                         "process group has 1 rank"):
        pm.make_mesh(4, ("data", "model"), (2, 2), device="cpu")
    with pytest.raises(ValueError, match="shape .1, 2. needs 2 devices"):
        pm.make_mesh(None, ("data", "spatial"), (1, 2), device="cpu")
    with pytest.raises(ValueError, match="at most once"):
        pm.make_mesh(None, ("data", "data"), (1, 1), device="cpu")
    mesh = pm.make_mesh(None, ("data", "spatial", "model"), (1, 1, 1),
                        device="cpu")
    assert (mesh.size, mesh.model_size, mesh.is_main) == (1, 1, True)


@pytest.mark.parametrize("case", ["plain", "augment", "knobs"])
def test_siamese_epoch_on_data2_model2_equals_data2_bit_for_bit(runs, case):
    """Losses, validation, whole weights, BatchNorm buffers and moments
    (the flat bf16 ones re-laid as one process's vector) are equal in
    bits."""
    assert runs["rank0"]["diffs"][case] == {
        "loss": 0.0, "val": 0.0, "model": 0.0, "optimizer": 0.0,
        "rel": None}


def test_siamese_float64_epoch_on_data2_model2_equals_data2(runs):
    """Within 1e-12 of each tensor's largest value; measured equal: the
    same convolutions on the same gathered weights, the same sums over
    the data group."""
    got = runs["rank0"]["diffs"]["plain64"]
    assert got["rel"] <= 1e-12
    assert got["loss"] == 0.0 and got["model"] == 0.0


def test_gan_epoch_on_data2_model2_equals_data2_bit_for_bit(runs):
    """Two D+G steps at batch 2 with the EMA: losses, G, D, the EMA and
    both optimizers' moments.  The generator's innermost up-convolution
    (256 -> 256) is sharded on its dim 1."""
    assert set(runs["rank0"]["diffs"]["gan"].values()) == {0.0}
    g = UNetGenerator(3, 3, num_downs=GAN_ARCH["num_downs"],
                      ngf=GAN_ARCH["ngf"])
    assert runs["rank0"]["gan_shapes"] == {  # whole in the gathered state
        k: tuple(v.shape) for k, v in g.state_dict().items()}
    up = [k for k, dim in tp.shard_plan(g, 2).items() if dim == 1]
    assert len(up) == 1 and g.state_dict()[up[0]].shape == (256, 256, 4, 4)


def test_each_rank_holds_the_rules_share(runs):
    """Parameters and Adam moments (default layout) of a (2, 2) rank: the
    rule's prediction exactly; the state's shapes: the plan's blocks."""
    model = SiameseUNet(3, 1)
    plan = tp.shard_plan(model, 2)
    want = sum(p.numel() // (2 if k in plan else 1)
               for k, p in model.named_parameters())
    assert runs["rank0"]["counts"] == {"params": want, "moments": 2 * want}
    # The share of the train state's elements the rule shards (JAX's
    # tree measured the same: 39,906,816 of 41,176,149).
    floats = {k: v for k, v in model.state_dict().items()
              if v.is_floating_point()}
    assert sum(floats[k].numel() for k in plan) == 39_906_816
    assert sum(v.numel() for v in floats.values()) == 41_176_149
    plan4 = tp.shard_plan(model, 4)
    for k, v in model.state_dict().items():
        for m, p, shapes in ((2, plan, "shapes"), (4, plan4, "shapes14")):
            block = list(v.shape)
            if k in p:
                block[p[k]] //= m
            assert runs["rank0"][shapes][k] == tuple(block), (m, k)


def test_siamese_float64_epoch_on_data2_model2_matches_jax_model_axis(runs):
    """The bounds of the data-only test against JAX's data mesh (ROADMAP
    §C15): the loss within 1e-6, each weight within 2 lr a step, the
    median difference under 1% of the median movement, the running means
    and flax's running variances within 1e-3 of their largest value."""
    got = runs["plain64"]
    loss, want, n_sharded = runs["jax"]
    params = dict(SiameseUNet(3, 1).named_parameters())
    assert n_sharded == sum(k in params for k in tp.shard_plan(
        SiameseUNet(3, 1), 2))  # JAX's sharded parameters
    assert got["loss"] == pytest.approx(loss, rel=1e-6)
    state, start = got["model"], runs["init"]
    params = [k for k in want
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))]
    diffs = torch.cat([(state[k] - want[k]).abs().flatten()
                       for k in params])
    moved = torch.cat([(want[k] - start[k]).abs().flatten()
                       for k in params])
    steps = -(-N_STEP // BS)
    assert float(diffs.max()) <= 2 * SiameseTrainConfig().learning_rate * steps
    assert float(diffs.median()) < 0.01 * float(moved.median())
    means = {k: v for k, v in want.items() if k.endswith("running_mean")}
    assert _rel(state, means) <= 1e-3
    variances = {k: v for k, v in want.items() if k.endswith("running_var")}
    assert variances.keys() == got["flax_var"].keys()
    assert _rel(got["flax_var"], variances) <= 1e-3


# -- checkpoints across topologies -------------------------------------------


def _one_process_state(path):
    trainer = _siamese(None)
    sched, stopper = _state(trainer)
    info = ckpt.restore_train_state(path, trainer.model, trainer.optimizer,
                                    sched, stopper)
    return trainer, ckpt.train_state(trainer.model, trainer.optimizer,
                                     sched, stopper, info["epoch"],
                                     info["best_val_loss"])


def test_state_saved_under_data2_model2_restores_in_one_process(runs):
    """The file is the one-process layout (keys, shapes, dtypes, a strict
    load) and restores bit for bit; each rank's blocks are its own."""
    path = os.path.join(runs["tmp"], "state22.pth")
    saved = torch.load(path, weights_only=True)
    trainer, restored = _one_process_state(path)
    layout = ckpt.train_state(trainer.model, trainer.optimizer,
                              *_state(trainer), 0, 0.0)
    assert {k: (v.shape, v.dtype) for k, v in saved["model"].items()} == {
        k: (v.shape, v.dtype) for k, v in layout["model"].items()}
    assert saved["optimizer"]["state"].keys() == \
        layout["optimizer"]["state"].keys()
    assert _equal(ckpt._map(
        restored, lambda t: t.detach().cpu()), saved) == 0.0
    assert runs["rank0"]["own_blocks"] == 0.0


def test_state_saved_under_data2_model2_restores_under_data1_model4(runs):
    assert runs["rank0"]["restore14"] == 0.0


def test_gan_files_saved_under_data2_model2_restore_under_data1_model4(runs):
    """G's resume file (model, moments, EMA, epoch) through
    ``restore_gan_state``, its bare model file through
    ``restore_model_only``, and whole state dicts through
    ``GANTrainer.load_state_dicts`` (the EMA restarting from the weights):
    what (1, 4) gives back gathered equals what was saved, in bits."""
    assert runs["rank0"]["gan_restore14"] == [0.0] * 5


def test_jax_state_resumes_into_data2_model2_as_into_one_process(runs):
    """The JAX (2, 2) epoch's train state (its ``save_checkpoint``):
    model, moments, count, learning rate, epoch; bit for bit."""
    _, one = _one_process_state(os.path.join(runs["tmp"], "jax",
                                             "last_state.msgpack"))
    got = torch.load(os.path.join(runs["tmp"], "jax_resume22.pth"),
                     weights_only=True)
    one = ckpt._map(one, lambda t: t.detach().cpu())
    assert got["epoch"] == 1 and _equal(got, one) == 0.0


# -- the rule against JAX ----------------------------------------------------


def _jax_trees():
    """{name: (JAX variables of shapes from ``jax.eval_shape``, the port's
    full-width model)} for the Siamese net, G and D."""
    import jax
    import jax.numpy as jnp

    from gan_aug_pfa_tpu.models.pix2pix import (
        NLayerDiscriminator as JaxD,
        UNetGenerator as JaxG,
    )
    from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxS

    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 256, 256, 3), jnp.float32)
    return {
        "siamese": (jax.eval_shape(lambda: JaxS(3, 1).init(
            key, x[:, :32, :32], x[:, :32, :32], train=False)),
            SiameseUNet(3, 1)),
        "G": (jax.eval_shape(lambda: JaxG(3, 3).init(key, x, train=False)),
              UNetGenerator(3, 3)),
        "D": (jax.eval_shape(lambda: JaxD(6).init(
            key, jnp.zeros((1, 256, 256, 6)), train=False)),
            NLayerDiscriminator(6)),
    }


def _leaf_ids(variables, model):
    """{port ``state_dict`` key: index of its JAX leaf} (through the
    port's converter, each JAX leaf a constant array of its index), and
    the JAX leaves with their paths in ``tree_leaves`` order."""
    import jax

    from gan_aug_pfa_torch import interop

    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        {k: variables[k] for k in ("params", "batch_stats")})
    filled = jax.tree_util.tree_unflatten(treedef, [
        np.broadcast_to(np.float32(i), leaf.shape)
        for i, (_, leaf) in enumerate(leaves)])
    sd = interop.state_dict_from_jax(model, filled)
    ids = {}
    for k, v in sd.items():
        if v.is_floating_point():
            vals = torch.unique(v)
            assert len(vals) == 1, k
            ids[k] = int(vals[0])
    return ids, leaves


@pytest.fixture(scope="module")
def trees():
    return {name: (*_leaf_ids(v, model), model)
            for name, (v, model) in _jax_trees().items()}


def _jax_sharded(leaves, mesh_shape):
    """Indices of the JAX leaves that ``param_shardings`` shards on a
    (data, model) mesh of ``mesh_shape``."""
    import jax

    from gan_aug_pfa_tpu.parallel.mesh import make_mesh, param_shardings

    mesh = make_mesh(int(np.prod(mesh_shape)), ("data", "model"),
                     mesh_shape)
    specs = param_shardings(mesh, [leaf for _, leaf in leaves])
    return {i for i, s in enumerate(jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: hasattr(x, "spec")))
        if any(a is not None for a in s.spec)}


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (2, 2)])
@pytest.mark.parametrize("name,counts", [("siamese", (74, 164)),
                                         ("G", (41, 59)), ("D", (10, 19))])
def test_rule_shards_what_jax_shards(trees, name, counts, mesh_shape):
    ids, leaves, model = trees[name]
    sharded = _jax_sharded(leaves, mesh_shape)
    assert (len(sharded), len(leaves)) == counts
    assert sorted(ids.values()) == list(range(len(leaves)))  # one-to-one
    plan = tp.shard_plan(model, mesh_shape[1])
    assert {ids[k] for k in plan} == sharded
    sd = model.state_dict()
    modules = dict(model.named_modules())
    for k, dim in plan.items():
        jax_shape = leaves[ids[k]][1].shape
        assert sd[k].shape[dim] == jax_shape[-1]  # the output channels
        owner = modules[k.rpartition(".")[0]]
        if sd[k].dim() == 4:
            assert dim == (1 if isinstance(owner, nn.ConvTranspose2d)
                           else 0)
    if name == "G":  # the up-convolutions: (I, O, 4, 4), sharded on O
        up = [k for k, d in plan.items() if d == 1]
        assert len(up) == 4 and all(sd[k].shape[1] in (256, 512)
                                    for k in up)


def test_rule_replicates_everything_at_model_extent_one():
    assert tp.shard_plan(SiameseUNet(3, 1), 1) == {}
    tree = {"odd": nn.Conv2d(3, 257, 1), "wide": nn.ConvTranspose2d(8, 512,
                                                                    2)}
    plan = tp.shard_plan(nn.ModuleDict(tree), 2)
    assert plan == {"wide.weight": 1, "wide.bias": 0}
