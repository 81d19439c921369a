"""The knobs that change a convolution's form, under the port's 'spatial'
mesh axis (``parallel/spatial.py``): ``--concat-free`` (the decoder's
sliced convs), ``--remat`` (each DoubleConv recomputed in the backward,
its exchanges and BatchNorm reductions inside the recomputation) and the
GAN's ``--concat-free-disc`` (D's first conv on the pair), on the CPU at
32x32 against the meshes without the axis and the JAX package's
("data", "spatial") mesh.

One spawn of four gloo ranks (``_rank_main``) runs every case while this
process runs the JAX (data 2, spatial 2) step with ``--concat-free
--remat``.  The spawn's join has a time limit (``SPAWN_LIMIT``) and the
ranks' collectives one of their own (``COLLECTIVE_LIMIT``): a
recomputation whose collectives ran in another order on another rank
fails the test instead of holding its worker.  The cases:

  * each sliced conv (two channel slices, the bias added after their sum)
    against the conv of their concatenation whole, on s = 4 and s = 2
    ranks at float64: a 3x3 conv, the gates' 1x1, D's 4x4 stride-2
    ``conv0`` and a 3x3 conv at a level that runs whole; outputs, input
    gradients and the weight gradients summed over the group within
    OPS_TOL;
  * a ``remat`` DoubleConv on split blocks, its backward called outside
    ``spatial.splitting``, against the same block without remat and the
    whole block, and one on a sample a rank, its backward called outside
    ``batchnorm.global_statistics``, against the block without remat;
  * one float64 step of 2 pairs at batch 2 for ``concat_free``, ``remat``
    and both on (data 2, spatial 2) against (data 2), ``remat`` with
    ``batched_encoder`` on (data 1, spatial 4) against one process (its
    2-row bottleneck whole on every rank), and the GAN with
    ``concat_free_disc``, with and without ``batched_disc``, on (data 1,
    spatial 2) against one process: losses, weights, BatchNorm buffers
    and Adam moments within REL64 of each tensor's largest value (ROADMAP
    §C19's rule for the rounding-noise biases; the GAN's float32 losses
    within GAN_LOSS_ULPS), the float32 first step's loss within LOSS32 of
    the reference's float64 one;
  * the float64 (2, 2) step of 4 pairs with ``--concat-free --remat``
    against the JAX package's, within §C15's bounds but for the four
    bottleneck statistics of §C18;
  * both trainers build on a spatial mesh with each knob.

The ranks that hold the reference of a (2, 2) case are those of one
spatial index (a (data 2) mesh): the two indices run two references at
once, and the ranks a one-process reference needs are the ones free then.
"""

import contextlib
import copy
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from gan_aug_pfa_torch.config import GANTrainConfig, SiameseTrainConfig
from gan_aug_pfa_torch.models.blocks import DoubleConv, sliced_conv2d
from gan_aug_pfa_torch.parallel import mesh as pm
from gan_aug_pfa_torch.parallel import spatial as sp
from gan_aug_pfa_torch.parallel.batchnorm import (
    convert_batchnorm,
    global_statistics,
)
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from torch_spatial_helpers import (
    BOTTLENECK_STATS,
    GAN_ARCH,
    LOSS32,
    N_STEP,
    OPS_TOL,
    REL64,
    block_mesh,
    compare,
    gan_compare,
    gan_run,
    jax_mesh_epoch,
    rel,
    siamese_run,
    siamese_trainer,
    within_c15,
    without_spatial,
)
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

WORLD = 4
SPAWN_LIMIT = 600  # seconds; alone the spawn takes 90-130 s on 8 cores
COLLECTIVE_LIMIT = 300  # seconds a rank waits in one collective
N_KNOB = 2  # a trainer case's pairs: one step of one pair a data rank
KNOBS = {"concat_free": dict(concat_free=True), "remat": dict(remat=True),
         "both": dict(concat_free=True, remat=True)}
# The GAN's losses are float32 at every dtype (``losses.gan_bce_loss`` and
# ``l1_loss`` cast to it): at float64 the sliced conv0's other order of
# sums moves D's logits by float64 rounding, which may cross a float32
# rounding boundary.  Its losses are held in float32 units in the last
# place; its states, float64, at REL64.
GAN_LOSS_ULPS = 4
# name: (conv, global input height, the slices' channels); at height 5
# the level runs whole on s = 2 and s = 4 ranks.
SLICED = {"conv3x3": (lambda: nn.Conv2d(5, 4, 3, padding=1, bias=False),
                      16, (2, 3)),
          "conv1x1": (lambda: nn.Conv2d(5, 4, 1), 16, (2, 3)),
          "conv4x4s2": (lambda: nn.Conv2d(6, 4, 4, stride=2, padding=1),
                        16, (3, 3)),
          "conv3x3_whole": (lambda: nn.Conv2d(5, 4, 3, padding=1), 5,
                            (2, 3))}


# -- the cases on the ranks ------------------------------------------------


def _sliced_ops(split):
    """Each SLICED conv of channel slices against the conv of their
    concatenation whole, at float64: the largest difference of outputs,
    input gradients and weight gradients (those, and a whole input's,
    summed over the spatial group: each rank's is its part)."""
    gen = torch.Generator().manual_seed(0)
    diffs = {}
    for name, (make, h, chans) in SLICED.items():
        torch.manual_seed(1)
        conv = make().double()
        xs = [torch.randn(2, c, h, 8, dtype=torch.float64, generator=gen)
              for c in chans]
        xw = torch.cat(xs, dim=1).requires_grad_()
        yw = conv(xw)
        g = torch.randn(yw.shape, dtype=torch.float64, generator=gen)
        (yw * g).sum().backward()
        yw = yw.detach()
        wgrads = [p.grad.clone() for p in conv.parameters()]
        conv.zero_grad()
        split_in = h % split.size == 0
        xbs = [(split.block(x, 2) if split_in else x).clone()
               .requires_grad_() for x in xs]
        with sp.splitting(split):
            y = sliced_conv2d(xbs, conv, h)
            split_out = sp.splits(sp.conv_height(conv, h))
        if split_out:
            want, gb = split.block(yw, 2), split.block(g, 2)
        else:  # whole on every rank: each takes 1/s of the seed
            want, gb = yw, g / split.size
        (y * gb).sum().backward()
        gx = torch.cat([x.grad for x in xbs], dim=1)
        grads = [p.grad.clone() for p in conv.parameters()]
        for t in grads + ([] if split_in else [gx]):
            dist.all_reduce(t, group=split.group)
        want_gx = split.block(xw.grad, 2) if split_in else xw.grad
        y = y.detach()
        diffs[name] = max(
            [float((y - want).abs().max()),
             float((gx - want_gx).abs().max())]
            + [float((a - b).abs().max()) for a, b in zip(grads, wgrads)])
    return diffs


def _remat_block(split):
    """A ``remat`` DoubleConv (global BatchNorms) whose backward is called
    after the state of its forward has been left, at float64: on split
    blocks of a 16-row map (``spatial.splitting``), against the same
    block without remat and the whole block in one process; and on one
    sample a rank under ``batchnorm.global_statistics`` over the same
    ranks, against the same block without remat.  The largest
    differences of outputs, input gradients, weight gradients (summed
    over the group) and running statistics."""
    gen = torch.Generator().manual_seed(2)
    torch.manual_seed(3)
    base = convert_batchnorm(DoubleConv(3, 4).double().train())
    n, k = split.size, split.rank
    x = torch.randn(n, 3, 16, 8, dtype=torch.float64, generator=gen)
    g = torch.randn(n, 4, 16, 8, dtype=torch.float64, generator=gen)
    cases = {  # name: (the block's input, its seed, the state it runs in)
        "whole": (x, g, contextlib.nullcontext),
        "split": (split.block(x, 2), split.block(g, 2),
                  lambda: _split_level(split, 16)),
        "data": (x[k:k + 1], g[k:k + 1],
                 lambda: global_statistics(split.group))}
    runs = {}
    for name, (xi, gi, state) in cases.items():
        for remat in (False, True) if name != "whole" else (False,):
            block = copy.deepcopy(base)
            block.remat = remat
            xb = xi.clone().requires_grad_()
            with state():
                y = block(xb)
            (y * gi).sum().backward()
            grads = [p.grad.clone() for p in block.parameters()]
            if name != "whole":
                for t in grads:
                    dist.all_reduce(t, group=split.group)
            stats = [t.clone() for t in block.buffers()
                     if t.is_floating_point()]
            runs[name, remat] = [y.detach(), xb.grad] + grads + stats
    whole = runs["whole", False]
    whole = [split.block(t, 2) for t in whole[:2]] + whole[2:]

    def worst(a, b):
        return max(float((u - v).abs().max()) for u, v in zip(a, b))

    return {"split": worst(runs["split", True], runs["split", False]),
            "split_vs_whole": worst(runs["split", True], whole),
            "data": worst(runs["data", True], runs["data", False])}


@contextlib.contextmanager
def _split_level(split, h):
    with sp.splitting(split), sp.level(h):
        yield


# Each case: its knobs, its pairs (one step at a batch of that many) and
# its mesh without the axis ("data2": the ranks of this rank's spatial
# index on (2, 2); None: one process).  The both step is the JAX
# comparison's, of 4 pairs.
SIAMESE = {"22_concat_free": (KNOBS["concat_free"], N_KNOB, "data2"),
           "22_remat": (KNOBS["remat"], N_KNOB, "data2"),
           "22_both": (KNOBS["both"], N_STEP, "data2"),
           "14_remat_batched": (dict(remat=True, batched_encoder=True),
                                N_KNOB, None)}
GAN = {"gan12_cfd": dict(concat_free_disc=True),
       "gan12_cfd_batched": dict(concat_free_disc=True, batched_disc=True)}
# Which rank holds which case's steps against its reference, in this
# order, keeping the float64 step's state until then: the two spatial
# indices run their (data 2) references at once, then the free ranks the
# one-process ones.  The float32 first step's loss is held against the
# reference's float64 step's: the same pairs, at the dtype the loss is
# exact in.
HOLD = {0: ("22_concat_free", "22_remat", "gan12_cfd"),
        1: ("22_both", "14_remat_batched"),
        2: ("22_concat_free", "22_remat", "gan12_cfd_batched"),
        3: ("22_both",)}


def _siamese_step(mesh, case, dtype=torch.float64, world=1):
    """The trainer and the figures of ``case``'s step on ``mesh``
    (``siamese_run``'s)."""
    knobs, n, _ = SIAMESE[case]
    return siamese_run(mesh, dtype, n=n, world=world, batch=n, **knobs)


def _gan_step(mesh, case, dtype=torch.float64):
    return gan_run(mesh, dtype, n=2, **GAN[case])[1]


def _ulps(got, want):
    """The largest distance of two float32 losses' lists, in units in
    the last place of the second."""
    return max(abs(a - b) / float(np.spacing(np.float32(b)))
               for a, b in zip(got, want))


def _rank_main(rank, tmp):
    """One rank of WORLD; its figures into ``tmp/rank<R>.pt``, the (2, 2)
    state of the JAX comparison into ``tmp/jax_case.pt`` (rank 0)."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", world_size=WORLD,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_LIMIT))
    out = {"seconds": {}}
    t0 = time.time()

    def lap(name):
        nonlocal t0
        out["seconds"][name] = time.time() - t0
        t0 = time.time()

    try:
        mesh22 = block_mesh((2, 2, 1))
        mesh14 = block_mesh((1, 4, 1))
        mesh12 = block_mesh((1, 2, 1))  # ranks 0-1 and 2-3
        meshes = {"22": mesh22, "14": mesh14}
        lap("meshes")
        # 1. The sliced convs and the recomputed block, s = 4 and s = 2.
        for s, mesh in ((4, mesh14), (2, mesh12)):
            out[f"ops{s}"] = _sliced_ops(mesh.split(True))
            out[f"remat{s}"] = _remat_block(mesh.split(True))
        lap("ops")
        # 2. The steps under the axis: HOLD's ranks keep them.
        keep = {}
        for case in SIAMESE:
            mesh = meshes[case[:2]]
            trainer, got = _siamese_step(mesh, case, world=2)
            if case == "22_both" and rank == 0:
                torch.save({k: got[k] for k in ("loss", "model",
                                                "flax_var")},
                           os.path.join(tmp, "jax_case.pt"))
            loss32 = _siamese_step(mesh, case, torch.float32)[1]["loss"]
            if case in HOLD[rank]:
                keep[case] = (got, loss32, trainer.model)
            del trainer, got
            lap(case)
        # Ranks 0-1 run the one GAN case, ranks 2-3 the other.
        case = "gan12_cfd" if rank < 2 else "gan12_cfd_batched"
        got = _gan_step(mesh12, case)
        loss32 = _gan_step(mesh12, case, torch.float32)["loss"]
        if case in HOLD[rank]:
            keep[case] = (got, loss32)
        del got
        lap("gan12")
        # 3. The references.
        data2 = without_spatial(mesh22)
        for case in HOLD[rank]:
            if case in GAN:
                (got, loss32), want = keep.pop(case), _gan_step(None, case)
                out[case] = {"state": gan_compare(got, want)["state"],
                             "loss_ulps": _ulps(got["loss"], want["loss"]),
                             "loss32": rel(loss32, want["loss"])}
                continue
            got, loss32, model = keep.pop(case)
            want = _siamese_step(data2 if SIAMESE[case][2] else None,
                                 case)[1]
            out[case] = compare(got, want, model)
            out[case]["loss32"] = rel(loss32, want["loss"])
            del got, model, want
        lap("references")
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's report, the JAX step, the (2, 2) state it is held
    against and the init they start from (files deleted at the module's
    end)."""
    import torch.multiprocessing as mp

    with dropped(str(tmp_path_factory.mktemp("spatial_knobs"))) as tmp:
        t0 = time.time()
        ctx = mp.start_processes(_rank_main, args=(tmp,), nprocs=WORLD,
                                 join=False, start_method="spawn")
        try:
            init = {k: v.clone().double() for k, v in
                    siamese_trainer(None).model.state_dict().items()}
            jax_run = jax_mesh_epoch(init, ("data", "spatial"), (2, 2),
                                     **KNOBS["both"])
            jax_seconds = time.time() - t0
        finally:
            _join(ctx, t0 + SPAWN_LIMIT)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
        print(f"spawn {time.time() - t0:.1f} s, JAX {jax_seconds:.1f} s; "
              f"phases {[r['seconds'] for r in ranks]}")
        out = {"ranks": ranks, "init": init, "jax": jax_run,
               "jax_case": torch.load(os.path.join(tmp, "jax_case.pt"))}
        print("worst figures:", {case: _worst(out, case)
                                 for case in list(SIAMESE) + list(GAN)})
        yield out


def _join(ctx, deadline):
    """Wait for the spawned ranks until ``deadline``; past it, kill them
    and fail (a hang, not a slow rank: alone they take a fifth of
    SPAWN_LIMIT)."""
    while not ctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() >= deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            pytest.fail(f"the ranks did not end within {SPAWN_LIMIT} s")


def _worst(runs, case):
    """The largest of each of ``case``'s figures over the ranks that
    report it."""
    reports = [r[case] for r in runs["ranks"] if case in r]
    return {k: max(r[k] for r in reports if k in r)
            for k in set().union(*reports)}


# -- the ops ---------------------------------------------------------------


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("op", list(SLICED))
def test_sliced_conv_under_the_split_equals_the_whole_conv(runs, op, s):
    """On s ranks at float64: the sum of the slices' convs on height
    blocks (with their halo rows; whole where the level's height does not
    divide), the bias added once, against the conv of the concatenation
    whole: outputs, input gradients and the weight gradients summed over
    the spatial group within 1e-12."""
    for rep in runs["ranks"]:
        assert rep[f"ops{s}"][op] <= OPS_TOL, (op, s, rep[f"ops{s}"])


def test_remat_block_with_its_backward_outside_the_split(runs):
    """A recomputing DoubleConv whose backward runs after
    ``spatial.splitting`` has exited (as the trainers call it) computes
    what the block without remat computes on the same blocks, and the
    whole block's values, within 1e-12 on s = 4 and s = 2: the
    recomputation re-enters the split, its halo exchanges and its
    BatchNorms' reductions.  The same after ``global_statistics`` has
    exited, over a sample a rank."""
    for rep in runs["ranks"]:
        for s in (2, 4):
            figures = rep[f"remat{s}"]
            assert max(figures.values()) <= OPS_TOL, (s, figures)


# -- the trainers against the meshes without the axis --------------------


@pytest.mark.parametrize("case", list(SIAMESE))
def test_knob_step_under_the_spatial_axis_equals_the_mesh_without_it(
        runs, case):
    """(2, 2) against (data 2) with ``--concat-free``, ``--remat`` and
    both; (1, 4) with ``--remat --batched-encoder`` against one process.
    At float64 the loss, weights, BatchNorm buffers and Adam moments
    within REL64 of each tensor's largest value (the rounding-noise
    biases' moments of the largest moment); at float32 the first step's
    loss within LOSS32 of the reference's float64 loss."""
    worst = _worst(runs, case)
    assert worst["scalars"] <= REL64, worst
    assert worst["state"] <= REL64, worst
    assert worst["loss32"] <= LOSS32, worst


@pytest.mark.parametrize("case", list(GAN))
def test_gan_knob_step_under_the_spatial_axis_equals_one_process(runs,
                                                                 case):
    """The GAN at (1, 2) with ``--concat-free-disc``, with and without
    ``--batched-disc``, against one process: at float64 G, D, the EMA and
    both optimizers' moments within REL64 of each tensor's largest value
    and the (float32) losses within GAN_LOSS_ULPS; at float32 the first
    step's losses within LOSS32 of the reference's float64 step's."""
    worst = _worst(runs, case)
    assert worst["state"] <= REL64, worst
    assert worst["loss_ulps"] <= GAN_LOSS_ULPS, worst
    assert worst["loss32"] <= LOSS32, worst


def test_concat_free_remat_step_on_data2_spatial2_matches_jax(runs):
    """The port's float64 (2, 2) step of 4 pairs with ``--concat-free
    --remat`` within §C15's bounds of the JAX package's (data 2, spatial
    2) step with the same flags from the same init, on every leaf but the
    bottleneck's running statistics, which JAX's spatial mesh alone moves
    (ROADMAP §C18): they depart from the port's by more than 0.1 of their
    largest value, as without the knobs."""
    got, start = runs["jax_case"], runs["init"]
    loss, want = runs["jax"]
    assert within_c15(got, (loss, {k: v for k, v in want.items()
                                   if k not in BOTTLENECK_STATS}),
                      start) == []
    mine = {k: got["flax_var" if k.endswith("running_var") else "model"][k]
            for k in BOTTLENECK_STATS}
    departs = [rel(want[k], mine[k]) for k in BOTTLENECK_STATS]
    assert min(departs) > 0.1, departs


# -- construction ------------------------------------------------------------


_SPATIAL2 = pm.DataMesh(1, 0, torch.device("cpu"), spatial_size=2)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_siamese_trainer_builds_on_a_spatial_mesh_with_the_knob(knob):
    trainer = SiameseTrainer(SiameseTrainConfig(**KNOBS[knob]), "cpu",
                             mesh=_SPATIAL2)
    model = trainer.model
    assert trainer.mesh is _SPATIAL2
    assert model.concat_free == KNOBS[knob].get("concat_free", False)
    assert {m.remat for m in model.modules() if isinstance(m, DoubleConv)
            } == {KNOBS[knob].get("remat", False)}


def test_gan_trainer_builds_on_a_spatial_mesh_with_concat_free_disc():
    trainer = GANTrainer(GANTrainConfig(concat_free_disc=True, **GAN_ARCH),
                         "cpu", mesh=_SPATIAL2)
    assert trainer.mesh is _SPATIAL2 and trainer.config.concat_free_disc
