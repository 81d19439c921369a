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
    ``split_rows``, the block upsample, a 4x4 stride-2 conv, a 4x4
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
    bit in one process and under (data 4).

The knobs that change a conv's form (``--concat-free``, ``--remat``,
``--concat-free-disc``) are held under the axis by
``tests/test_torch_spatial_knobs.py``; the helpers both files use are
``tests/torch_spatial_helpers.py``'s.
"""

import concurrent.futures
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gan_aug_pfa_torch import checkpoint as ckpt
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.ops.resize import (
    _upsample_matrix,
    upsample2x_align_corners,
)
from gan_aug_pfa_torch.parallel import mesh as pm
from gan_aug_pfa_torch.parallel import spatial as sp
from gan_aug_pfa_torch.train import plateau
from torch_spatial_helpers import (
    BOTTLENECK_STATS,
    EPOCH_SEED,
    LOSS32,
    N_STEP,
    OPS_TOL,
    REL64,
    against,
    block_mesh,
    compare,
    gan_compare,
    gan_run,
    gan_trainer,
    jax_mesh_epoch,
    make_cache,
    rel,
    siamese_run,
    siamese_trainer,
    within_c15,
    without_spatial,
)
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

WORLD = 8
CASES = ("22", "22_augment", "22_fixed", "14", "222", "gan12")


# -- states, bit for bit ---------------------------------------------------


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
    ops.update(upsample=upsample2x_align_corners,
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
        trainer = siamese_trainer(mesh)
        cache = make_cache()
        rng = np.random.RandomState(EPOCH_SEED)
        loss = (trainer.train_epoch_streaming(_ArraySource(cache), rng)
                if streamed else trainer.train_epoch(cache, rng))
        runs.append((loss, trainer.model.state_dict(),
                     trainer.optimizer.state_dict()["state"]))
    (la, ma, oa), (lb, mb, ob) = runs
    return {"loss": la == lb, "state": _equal([ma, oa], [mb, ob])}


def _restore_under(mesh, tmp):
    """Whether the (2, 2, 2) Siamese train state and G's resume state,
    restored under ``mesh`` (float64 trainers), give back what was saved
    in bits."""
    trainer = siamese_trainer(mesh, torch.float64)
    restored = _state(trainer)
    path = os.path.join(tmp, "state222.pth")
    info = ckpt.restore_train_state(path, trainer.model, trainer.optimizer,
                                    *restored)
    same = _equal(ckpt.train_state(trainer.model, trainer.optimizer,
                                   *restored, info["epoch"],
                                   info["best_val_loss"]),
                  torch.load(path, weights_only=True))
    del trainer, restored
    gan = gan_trainer(mesh, torch.float64)
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
        mesh22 = block_mesh((2, 2, 1))
        mesh14 = block_mesh((1, 4, 1))
        mesh12 = block_mesh((1, 2, 1))
        mesh41 = block_mesh((4, 1, 1))
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
            out["22"] = against(mesh22, without_spatial(mesh22), val=True)
            lap("22")
            out["22_fixed"] = against(mesh22, without_spatial(mesh22),
                                       n=2, f32=False, chain="fixed")
            lap("22_fixed")
            _, got = siamese_run(mesh22, n=N_STEP, world=2, batch=N_STEP)
            if rank == 0:
                torch.save({k: got[k] for k in ("loss", "model", "flax_var")},
                           os.path.join(tmp, "jax_case.pt"))
            lap("jax_case")
            _, got = gan_run(mesh12)
            _, got32 = gan_run(mesh12, torch.float32, n=2)
            if mesh12.spatial_rank == 0:
                out["gan12"] = gan_compare(got, gan_run(None)[1])
                out["gan12"]["loss32"] = rel(
                    list(got32["loss"]),
                    list(gan_run(None, torch.float32, n=2)[1]["loss"]))
            lap("gan12")
        else:
            # 2. with the native --augment chain; the streamed epoch; 3.
            # (1, 4) against one process.
            out["22_augment"] = against(mesh22, without_spatial(mesh22),
                                         chain="native")
            lap("22_augment")
            out["stream"] = _streamed_against_resident(mesh22)
            lap("stream")
            out["14"] = against(mesh14, None, n=2, f32=False,
                                 batched_encoder=True)
            lap("14")
        # 5. (2, 2, 2) against (data 2, model 2) at float64, one sharded
        # step of a pair a data rank, on all eight ranks after this
        # process's JAX epoch has (most likely) ended; its state and a
        # GAN's are the checkpoints (7), restored under (data 4).
        trainer, got = siamese_run(mesh222, n=2)
        if mesh222.spatial_rank == 0:
            out["222"] = compare(got, siamese_run(
                without_spatial(mesh222), n=2)[1], trainer.model)
        saved = ckpt.train_state(trainer.model, trainer.optimizer,
                                 *_state(trainer), 1, got["loss"])
        gan, _ = gan_run(mesh222, n=2)
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
                siamese_trainer(None).model.state_dict().items()}
        try:
            jax_run = jax_mesh_epoch(init, ("data", "spatial"), (2, 2))
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
    """The rows of the align-corners matrix that a rank's block outputs
    weigh only its input rows with one halo row each side (every other
    weight of theirs is 0), for every rank of s = 2, 4, 8 at h = 8, 16,
    64: the block upsample reads nothing beyond its halo."""
    for h in (8, 16, 64):
        m = _upsample_matrix(h, 2 * h)
        for size in (2, 4, 8):
            n = h // size
            for rank in range(size):
                rows = m[2 * rank * n:2 * (rank + 1) * n]
                lo, hi = max(rank * n - 1, 0), min(rank * n + n + 1, h)
                assert rows[:, lo:hi].any(axis=1).all()
                assert not rows[:, :lo].any() and not rows[:, hi:].any()


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("size", [2, 4])
def test_split_upsample_equals_the_unsplit_one_in_bits(monkeypatch, dtype,
                                                       size):
    """``spatial.upsample2x`` of each rank's block equals that rank's rows
    of ``upsample2x_align_corners`` of the whole map bit for bit on s = 2
    and 4, at float32, float64 and bf16 under CPU autocast, for every
    decoder height of a 32x32 or 128x128 input that the rule splits (the
    halo stood in by the whole map's rows, in this one process)."""
    for h in (4, 8, 16, 32, 64):
        if h % size:
            continue
        x = torch.randn(2, 5, h, 2 * h, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(h))
        x = x.to(getattr(torch, dtype))
        padded, n = F.pad(x, (0, 0, 1, 1)), h // size
        with torch.autocast("cpu", dtype=torch.bfloat16,
                            enabled=dtype == "bfloat16"):
            whole = upsample2x_align_corners(x)
            for k in range(size):
                monkeypatch.setattr(
                    sp, "halo", lambda t, top, bottom, split=None,
                    k=k: padded[:, :, k * n:k * n + n + 2])
                with sp.splitting(sp.Split(None, size, k, None)):
                    y = sp.upsample2x(x[:, :, k * n:(k + 1) * n], h)
                want = whole[:, :, 2 * k * n:2 * (k + 1) * n]
                assert y.dtype == want.dtype, (h, k)
                assert torch.equal(y, want), (h, k)


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
    ``noise_biases``), measured up to 2.3e-11 (the Siamese cases) and
    5.2e-11 (the GAN); at float32 the first step's losses within LOSS32,
    measured equal or within 1.2e-7."""
    worst = _worst(runs, case)
    assert worst["scalars"] <= REL64, worst
    assert worst["state"] <= REL64, worst
    assert worst.get("loss32", 0.0) <= LOSS32, worst


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
    assert within_c15(got, (loss, {k: v for k, v in want.items()
                                    if k not in BOTTLENECK_STATS}),
                       start) == []
    mine = {k: got["flax_var" if k.endswith("running_var") else "model"][k]
            for k in BOTTLENECK_STATS}
    departs = [rel(want[k], mine[k]) for k in BOTTLENECK_STATS]
    assert min(departs) > 0.1, departs  # JAX's departure, as recorded


# -- checkpoints across topologies -------------------------------------------


def test_state_saved_under_2_2_2_restores_in_one_process(runs):
    """The (2, 2, 2) train state is the one-process file (keys, shapes,
    dtypes) and restores bit for bit; so does G's resume file."""
    path = os.path.join(runs["tmp"], "state222.pth")
    saved = torch.load(path, weights_only=True)
    trainer = siamese_trainer(None, torch.float64)
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
    gan = gan_trainer(None, torch.float64)
    epoch = ckpt.restore_gan_state(gan_path, gan.generator, gan.opt_g,
                                   gan.ema)
    assert _equal(ckpt.gan_state(gan.generator, gan.opt_g, epoch, gan.ema),
                  gan_saved)


def test_state_saved_under_2_2_2_restores_under_data4(runs):
    assert [r["restore41"] for r in runs["ranks"][:4]] == [True] * 4
