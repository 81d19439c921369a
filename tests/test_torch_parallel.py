"""Data-parallel training of the port (``gan_aug_pfa_torch/parallel/``) on
the CPU: two ranks over gloo, started with ``torch.multiprocessing`` and a
``file://`` rendezvous, against one process and against the JAX package's
2-device mesh.

One spawn runs every case on both ranks (``_rank_main``), while this
process runs the JAX epoch; then this process runs each case without a
mesh.  At float64:

  * ``GlobalBatchNorm2d`` on two shards equals ``nn.BatchNorm2d`` on the
    whole batch (output, input and weight gradients, running statistics)
    within 1e-12 relative;
  * the plain FocalDice's global form on two shards equals the whole
    batch's loss and dx within 1e-12;
  * a Siamese epoch of 11 pairs at batch 4 (two sharded steps, then a
    replicated tail of 3) equals the single-process epoch within 1e-8
    (losses, parameters, BatchNorm statistics) and the JAX package's
    2-device mesh epoch as closely as the single-process epoch does: the
    loss within 1e-6, and the weights and running statistics (the
    variances with torch's N/(N-1) taken out update by update, ROADMAP
    §C1) as the JAX test states;
  * the native ``--augment`` chain and ``--batched-encoder --grad-accum 2
    --flat-opt-state`` epochs, and GAN epochs at batch 2 (sharded; also
    with ``--batched-disc --concat-free-disc --shared-gen-fwd``) and 1
    (replicated), equal their single-process epochs within 1e-8;
  * at float32, an augmented epoch streamed from a host source (``--stream
    host``), each rank staging only its rows of a sharded batch and all of
    a replicated one, equals the resident epoch on the same ranks bit for
    bit;
  * both ranks end every case with equal weights.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from gan_aug_pfa_torch.config import (
    DATASET_SUBDIR_DEFAULT,
    SYNTHETIC_DATA_DIR_DEFAULT,
    GANTrainConfig,
    SiameseTrainConfig,
)
from gan_aug_pfa_torch.data.loader import build_cached_dataset
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.data.stream import StreamingSource
from gan_aug_pfa_torch.ops.kernels.fused_loss import focal_dice_loss_fused
from gan_aug_pfa_torch.parallel import mesh as pm
from gan_aug_pfa_torch.parallel.batchnorm import (
    GlobalBatchNorm2d,
    convert_batchnorm,
    global_statistics,
    reducing,
)
from gan_aug_pfa_torch.pipelines import DeviceCache, NativeDeviceCache
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.train.optim import make_optimizer
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from torch_tmp import drop_tmp_path  # noqa: F401

WORLD = 2
SIZE = 32
N_PAIRS, BS = 11, 4  # steps of 4 and 4 (sharded), then 3 (replicated)
EPOCH_SEED = 7
SMALL_GAN = dict(num_downs=5, ngf=8, ndf=8, n_layers=2)
LOSS_KW = dict(beta=0.67, focal_gamma=1.79, focal_alpha=0.6,
               dice_smooth=1e-3)


# -- inputs, the same in every process ------------------------------------


def _cache(native=False):
    """N_PAIRS float64 pairs at SIZE (or, ``native``, at seeded native
    sizes in a padded 40x40 buffer) with about 20% change pixels."""
    rng = np.random.RandomState(0)
    side = 40 if native else SIZE
    img1, img2 = (torch.from_numpy(rng.rand(N_PAIRS, 3, side, side))
                  for _ in range(2))
    labels = torch.from_numpy(
        (rng.rand(N_PAIRS, side, side) > 0.8).astype(np.float64))
    if not native:
        return DeviceCache(img1, img2, labels)
    sizes = torch.from_numpy(rng.randint(24, side + 1, (N_PAIRS, 2)))
    for i, (h, w) in enumerate(sizes.tolist()):
        for a in (img1[i], img2[i]):
            a[:, h:] = 0
            a[:, :, w:] = 0
        labels[i, h:] = 0
        labels[i, :, w:] = 0
    return NativeDeviceCache(img1, img2, labels, sizes)


def _doubled(trainer, models, optimizers):
    """The trainer's models at float64, each optimizer rebuilt over them
    (``--flat-opt-state`` makes the parameters views of the optimizer's
    buffer, which must be built after the dtype is set)."""
    for model, (attr, args) in zip(models, optimizers):
        model.double()
        setattr(trainer, attr, make_optimizer(*args(model)))
    return trainer


def _siamese(mesh, **kw):
    cfg = SiameseTrainConfig(batch_size=BS, compute_dtype="float32",
                             **{k: v for k, v in kw.items()
                                if k != "native"})
    trainer = SiameseTrainer(cfg, "cpu", augment=kw.get("native", False),
                             native_out_size=(SIZE, SIZE)
                             if kw.get("native") else None, mesh=mesh)
    return _doubled(trainer, [trainer.model], [("optimizer", lambda m: (
        cfg.optimizer, m.parameters(), cfg.learning_rate, cfg.weight_decay,
        0.9, 0.999, 1e-8, cfg.opt_momentum_dtype, cfg.opt_flat_state,
        cfg.grad_accum))])


def _track_flax_running_var(model):
    """Forward hooks that follow, beside each train-mode BatchNorm's
    running variance, the one that flax's biased update would hold: each
    update's batch variance is read back from torch's unbiased update with
    the N of that update (the global batch's in a sharded step)."""
    flax, world = {}, [1]

    def pre(m, inputs):
        m._rv_before = m.running_var.clone()

    def post(m, inputs, out):
        if not m.training:
            return
        x = inputs[0]
        n = x.numel() // x.shape[1] * (world[0] if reducing() else 1)
        keep = 1.0 - m.momentum
        var = (m.running_var - keep * m._rv_before) / (
            m.momentum * n / (n - 1))
        flax[m] = keep * flax.get(m, m._rv_before) + m.momentum * var

    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)
    names = {m: name for name, m in model.named_modules()}
    return flax, world, names


# -- the cases: each returns what this process's run gives ----------------


def case_bn(mesh):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 5, 6, 6) * 2 + 0.5)
    w = torch.from_numpy(rng.randn(4, 5, 6, 6))
    bn = nn.BatchNorm2d(5).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.rand(5) + 0.5))
        bn.bias.copy_(torch.from_numpy(rng.randn(5)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(5)))
        bn.running_var.copy_(torch.from_numpy(rng.rand(5) + 0.5))
    ctx = contextlib.nullcontext()
    if mesh is not None:
        convert_batchnorm(bn)
        rows = mesh.rows(len(x))
        x, w = x[rows], w[rows]
        ctx = global_statistics()
    x = x.clone().requires_grad_()
    with ctx:
        y = bn(x)
        (y * w).sum().backward()
    if mesh is not None:
        assert type(bn) is GlobalBatchNorm2d
        mesh.reduce_gradients(bn.parameters(), sharded=True)
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "rm": bn.running_mean.clone(),
            "rv": bn.running_var.clone(),
            "nbt": int(bn.num_batches_tracked)}


def case_loss(mesh):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4, 1, 8, 8) * 3)
    t = torch.from_numpy((rng.rand(4, 8, 8) > 0.7).astype(np.float64))
    kw = {}
    if mesh is not None:
        rows = mesh.rows(len(x))
        kw = dict(group=mesh.group, n_total=x.numel())
        x, t = x[rows], t[rows]
    x = x.clone().requires_grad_()
    loss = focal_dice_loss_fused(x, t, **LOSS_KW, **kw)
    (0.7 * loss).backward()
    return {"loss": loss.detach(), "dx": x.grad}


def _siamese_case(mesh, **kw):
    trainer = _siamese(mesh, **kw)
    flax, world, names = _track_flax_running_var(trainer.model)
    world[0] = WORLD if mesh is not None else 1
    cache = _cache(native=kw.get("native", False))
    loss = trainer.train_epoch(cache, np.random.RandomState(EPOCH_SEED))
    val = trainer.validate(_cache()) if not kw else None
    return {"loss": loss, "val": val,
            "state": dict(trainer.model.state_dict()),
            "flax_var": {names[m] + ".running_var": v
                         for m, v in flax.items()}}


def _gan_case(mesh, bs, **knobs):
    cfg = GANTrainConfig(batch_size=bs, target_size=(SIZE, SIZE),
                         compute_dtype="float32", ema_decay=0.9,
                         **SMALL_GAN, **knobs)
    trainer = GANTrainer(cfg, "cpu", mesh=mesh)

    def adam(lr):
        return lambda m: ("adam", m.parameters(), lr, 0.0, cfg.beta1)

    _doubled(trainer, [trainer.generator, trainer.discriminator],
             [("opt_g", adam(cfg.learning_rate_g)),
              ("opt_d", adam(cfg.learning_rate_d))])
    trainer.reset_ema()
    cache = _cache()
    cache = DeviceCache(cache.img1[:6], cache.img2[:6], cache.labels[:6])
    losses = trainer.train_epoch(cache, np.random.RandomState(EPOCH_SEED))
    return {"loss": losses,
            "state": {**{"G." + k: v for k, v in
                         trainer.generator.state_dict().items()},
                      **{"D." + k: v for k, v in
                         trainer.discriminator.state_dict().items()},
                      **{"EMA." + k: v for k, v in trainer.ema.items()}}}


def case_stream(mesh, tree):
    """Augmented Siamese epochs at float32 over the 8 train pairs (real
    and synthetic) at batch 3 (steps of 3 and 3, replicated, then 2,
    sharded on two ranks): resident, then streamed from a host source from
    the same init; the streamed rows each rank staged."""
    samples = create_sample_lists(tree, DATASET_SUBDIR_DEFAULT,
                                  SYNTHETIC_DATA_DIR_DEFAULT, mode="train",
                                  use_synthetic=True, verbose=False)
    cfg = SiameseTrainConfig(batch_size=3, compute_dtype="float32")
    runs, staged = [], []
    for streamed in (False, True):
        trainer = SiameseTrainer(cfg, "cpu", augment=True, mesh=mesh)
        rng = np.random.RandomState(EPOCH_SEED)
        if not streamed:
            cache = DeviceCache.from_dataset(build_cached_dataset(
                samples, (SIZE, SIZE), verbose=False), "cpu")
            loss = trainer.train_epoch(cache, rng)
        else:
            src = StreamingSource(samples, (SIZE, SIZE), cache="host",
                                  verbose=False)
            submit = src.submit
            src.submit = lambda idx, pin: (staged.append(len(idx)),
                                           submit(idx, pin))[1]
            try:
                loss = trainer.train_epoch_streaming(src, rng)
            finally:
                src.close()
        runs.append((loss, list(trainer.model.state_dict().values())))
    (a, sa), (b, sb) = runs
    return {"loss": (a, b), "staged": staged,
            "equal": all(torch.equal(x, y) for x, y in zip(sa, sb))}


CASES = {
    "bn": case_bn,
    "loss": case_loss,
    "siamese": _siamese_case,
    "augment": lambda mesh: _siamese_case(mesh, native=True),
    "knobs": lambda mesh: _siamese_case(mesh, batched_encoder=True,
                                        grad_accum=2, opt_flat_state=True),
    "gan2": lambda mesh: _gan_case(mesh, 2),
    "gan2_knobs": lambda mesh: _gan_case(
        mesh, 2, batched_disc=True, concat_free_disc=True,
        shared_gen_fwd=True),
    "gan1": lambda mesh: _gan_case(mesh, 1),
}
TREE_CASES = {"stream": case_stream}  # cases that read the oscd tree
BIG = ("siamese", "augment", "knobs")  # full-width model states


def _rank_main(rank, tmp, tree):
    """One rank: every case on the gloo group, rank 0's results to
    ``tmp``; rank 1 keeps only how far each of its states lies from rank
    0's (the ranks must stay equal), and what it staged."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=WORLD, rank=rank)
    try:
        mesh = pm.make_mesh(n_devices=WORLD, device="cpu")
        assert (mesh.world_size, mesh.rank, mesh.backend) == (
            WORLD, rank, "gloo")
        spread = {}
        cases = dict(CASES, **{name: lambda mesh, case=case: case(mesh, tree)
                               for name, case in TREE_CASES.items()})
        for name, case in cases.items():
            out = case(mesh)
            if "state" in out:
                spread[name] = max(
                    float((mesh.broadcast(v.clone()) - v).abs().max())
                    for v in out["state"].values() if v.is_floating_point())
            if rank == 0:
                torch.save(out, os.path.join(tmp, f"{name}.pt"))
            elif "staged" in out:
                spread[name] = out
        if rank == 1:
            torch.save(spread, os.path.join(tmp, "spread.pt"))
    finally:
        dist.destroy_process_group()


def _jax_mesh_epoch(init_state):
    """The JAX package's Siamese epoch on a 2-device mesh (the conftest's
    virtual CPU devices) at float64 from the port's init, on the same
    pairs in the same order: (epoch loss, final variables in the port's
    layout)."""
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

    cache = _cache()
    nhwc = [a.permute(0, 2, 3, 1).numpy() for a in (cache.img1, cache.img2)]
    ds = CachedDataset(*nhwc, cache.labels.numpy().astype(np.int32),
                       ["city"] * N_PAIRS)
    init = ji.siamese_from_torch(
        {k: v.numpy() for k, v in init_state.items()})
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jlosses, "jnp", Float32Is64())
        mesh = make_mesh(n_devices=WORLD)
        trainer = JaxTrainer(jcfg.SiameseTrainConfig(
            batch_size=BS, compute_dtype="float32"), mesh=mesh)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, np.float64), init)
        state = jax.device_put(TrainState.create(
            apply_fn=JaxModel(3, 1, dtype=np.float64).apply,
            params=v64["params"], tx=trainer.tx,
            batch_stats=v64["batch_stats"]), replicate_sharding(mesh))
        state, loss = trainer.train_epoch(
            state, trainer._device_arrays(ds), N_PAIRS,
            jax.random.PRNGKey(0), np.random.RandomState(EPOCH_SEED))
        final = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return loss, {k: torch.from_numpy(np.array(v, np.float64))
                  for k, v in ji.siamese_to_torch(final).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, oscd_tree):
    """{case: (2-rank result of rank 0, single-process result)}, the JAX
    epoch, and rank 1's distance from rank 0 in each case."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("parallel"))
    ctx = mp.start_processes(_rank_main, args=(tmp, str(oscd_tree)),
                             nprocs=WORLD, join=False, start_method="spawn")
    init = {k: v.clone() for k, v in _siamese(None).model.state_dict().items()}
    try:
        jax_run = _jax_mesh_epoch(init)
    finally:
        while not ctx.join():
            pass
    single = {name: case(None) for name, case in CASES.items()}
    ranks = {}
    for name in list(CASES) + list(TREE_CASES):
        path = os.path.join(tmp, f"{name}.pt")
        ranks[name] = torch.load(path, weights_only=False)
        os.remove(path)  # full-width float64 states: not kept on disk
    spread = torch.load(os.path.join(tmp, "spread.pt"))
    return {"mesh": ranks, "single": single, "jax": jax_run,
            "spread": spread, "init": init}


def _close(got, want, rtol, what="", atol=0.0):
    """Each tensor of ``got`` within ``rtol`` of ``want``'s, relative to
    the largest magnitude of ``want``'s tensor, plus ``atol``."""
    for k, w in want.items():
        g = got[k]
        if not torch.is_tensor(w) or not w.is_floating_point():
            assert torch.equal(torch.as_tensor(g), torch.as_tensor(w)), k
            continue
        scale = float(w.abs().max()) or 1.0
        err = float((g.double() - w.double()).abs().max())
        assert err <= rtol * scale + atol, (
            f"{what}{k}: {err} > {rtol} * {scale} + {atol}")


# -- the mesh and the row rule ---------------------------------------------


def test_shard_rows_splits_divisible_batches_and_replicates_others():
    assert [pm.shard_rows(4, 2, r) for r in (0, 1)] == [slice(0, 2),
                                                         slice(2, 4)]
    assert [pm.shard_rows(8, 4, r) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert pm.shard_rows(3, 2, 0) is None and pm.shard_rows(1, 2, 1) is None
    assert pm.shard_rows(5, 1, 0) == slice(0, 5)
    with pytest.raises(ValueError):
        pm.shard_rows(4, 2, 2)


def test_make_mesh_without_a_group_and_its_errors():
    mesh = pm.make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.is_main) == (1, 0, True)
    assert pm.make_mesh(n_devices=1, device="cpu").world_size == 1
    assert pm.default_mesh(True, "cpu") is None
    with pytest.raises(ValueError, match="wanted 2 devices but this "
                                         "process group has 1 rank"):
        pm.make_mesh(n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="wanted 0"):
        pm.make_mesh(n_devices=0, device="cpu")


def test_backend_and_device_rules(monkeypatch):
    assert pm.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pm.backend_for("cuda", 2) == "gloo"  # two ranks on one card
    assert pm.backend_for("cuda", 1) == "nccl"
    assert pm.rank_device("cpu") == torch.device("cpu")
    for var in pm.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert not pm.torchrun_env() and pm.maybe_distributed_init("cpu") is False


# -- two ranks against one process ------------------------------------------


def test_global_batchnorm_equals_whole_batch_batchnorm(runs):
    got, want = runs["mesh"]["bn"], runs["single"]["bn"]
    rows = pm.shard_rows(4, WORLD, 0)
    for k in ("y", "dx"):
        _close({k: got[k]}, {k: want[k][rows]}, 1e-12)
    _close(got, {k: want[k] for k in ("dw", "db", "rm", "rv", "nbt")}, 1e-12)


def test_plain_focal_dice_global_form_equals_whole_batch(runs):
    got, want = runs["mesh"]["loss"], runs["single"]["loss"]
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=1e-12)
    _close({"dx": got["dx"]}, {"dx": want["dx"][:2]}, 1e-12)


@pytest.mark.parametrize("case", ["siamese", "augment", "knobs"])
def test_siamese_epoch_on_two_ranks_equals_one_process(runs, case):
    got, want = runs["mesh"][case], runs["single"][case]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-8)
    if want["val"] is not None:
        assert got["val"] == pytest.approx(want["val"], rel=1e-8)
    _close(got["state"], want["state"], 1e-8, f"{case}: ")
    assert runs["spread"][case] == 0.0  # both ranks hold the same weights


def test_siamese_epoch_on_two_ranks_matches_jax_mesh_epoch(runs):
    """The epoch loss within 1e-6 (measured 1.9e-7).  The weights and
    running statistics lie as far from JAX's as the single-process
    port's do (the JAX mesh epoch equals its single-device epoch within
    4e-11; ROADMAP §C15): Adam turns the frameworks' 1e-7 forward
    difference into parameter steps that differ by up to 81% of their
    3 lr of movement on a few elements, 0.4% at the median; the
    running means within 5.1e-4 and the variances, torch's N/(N-1)
    taken out update by update, within 1.5e-4 of their largest value."""
    got = runs["mesh"]["siamese"]
    loss, want = runs["jax"]
    assert got["loss"] == pytest.approx(loss, rel=1e-6)
    state, start = got["state"], runs["init"]
    params = [k for k in want
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))]
    diffs = torch.cat([(state[k] - want[k]).abs().flatten()
                       for k in params])
    moved = torch.cat([(want[k] - start[k]).abs().flatten()
                       for k in params])
    steps = -(-N_PAIRS // BS)
    assert float(diffs.max()) <= 2 * SiameseTrainConfig().learning_rate * steps
    assert float(diffs.median()) < 0.01 * float(moved.median())
    means = {k: v for k, v in want.items() if k.endswith("running_mean")}
    _close(state, means, 1e-3, "BatchNorm ")
    variances = {k: v for k, v in want.items() if k.endswith("running_var")}
    assert variances.keys() == got["flax_var"].keys()
    _close(got["flax_var"], variances, 1e-3, "BatchNorm ")


def test_streamed_epoch_on_two_ranks_stages_their_rows(runs):
    """Batches of 3, 3 and 2: each rank stages all of a replicated batch
    and its row of a sharded one, and its streamed augmented epoch gives
    the resident epoch's loss and weights bit for bit."""
    for got in (runs["mesh"]["stream"], runs["spread"]["stream"]):
        assert got["staged"] == [3, 3, 1]
        assert got["loss"][0] == got["loss"][1] and got["equal"]


@pytest.mark.parametrize("case", ["gan2", "gan2_knobs", "gan1"])
def test_gan_epoch_on_two_ranks_equals_one_process(runs, case):
    """Weights within 1e-8; the BatchNorm shifts, which start at 0 and
    hold only Adam's few steps of lr from a sum that nearly cancels,
    within 1e-6 of one step (measured 1.5e-11 at batch 2).  The losses
    within 1e-6: the GAN losses run in float32 at any model dtype
    (``losses.py``), and a shard's sum over the global count rounds
    otherwise than the whole batch's mean (measured 6.8e-8)."""
    got, want = runs["mesh"][case], runs["single"][case]
    for g, w in zip(got["loss"], want["loss"]):
        assert g == pytest.approx(w, rel=1e-6)
    step = GANTrainConfig().learning_rate_d
    _close(got["state"], want["state"], 1e-8, f"{case}: ", atol=1e-6 * step)
    assert runs["spread"][case] == 0.0
