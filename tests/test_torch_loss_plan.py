"""The fused FocalDice kernels' launch plan (``plan_launch``) and the plain
version's bf16 path, on the CPU.

Both CUDA kernels take their grid from this plan: blocks of threads in a
grid-stride loop, a scalar head until logits and targets are both 16-byte
aligned, then groups of 8 elements read 16 bytes at a time, then a scalar
tail.  These tests hold the plan to what the kernels and the card need;
the kernels themselves are checked on the card
(tests/test_torch_cuda.py)."""

import os
import re

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch.ops.kernels import build
from gan_aug_pfa_torch.ops.kernels import fused_loss as fl

SIZES = [1, 7, 8, 63, 5883, 65_536, 1 << 20, 16 << 20]


@pytest.mark.parametrize("x_bytes", [4, 2])
def test_plan_takes_a_group_a_thread_at_the_train_shape(x_bytes):
    """4x1x128x128 = 65,536 aligned elements: 8,192 groups, one a thread,
    in 64 blocks of MIN_THREADS on the 132 SMs."""
    assert fl.plan_launch(65_536, 0, 0, x_bytes) == fl.LossPlan(
        threads=fl.MIN_THREADS, blocks=64, head=0, groups=8192)


@pytest.mark.parametrize("x_bytes", [4, 2])
def test_plan_keeps_several_blocks_an_sm_resident_at_16m(x_bytes):
    """16x1x1024x1024: BLOCKS_PER_SM blocks of THREADS on each SM, every
    thread walking about 16 groups."""
    plan = fl.plan_launch(16 << 20, 0, 0, x_bytes)
    assert plan == fl.LossPlan(threads=256, blocks=528, head=0,
                               groups=2 << 20)
    assert plan.blocks == fl.SMS * fl.BLOCKS_PER_SM == fl.MAX_BLOCKS


@pytest.mark.parametrize("n,x_off,t_off,x_bytes,head,groups", [
    (5883, 4, 4, 4, 3, 735),     # float32 views one element in
    (5883, 2, 4, 2, 7, 734),     # bf16 logits one element in, 2 bytes
    (63, 0, 0, 4, 0, 7),         # a tail of 7
    (7, 0, 0, 4, 0, 0),          # no whole group
    (100, 4, 0, 4, 100, 0),      # logits and targets never both aligned
    (100, 2, 8, 2, 100, 0),
])
def test_plan_heads_and_groups(n, x_off, t_off, x_bytes, head, groups):
    plan = fl.plan_launch(n, x_off, t_off, x_bytes)
    assert (plan.head, plan.groups) == (head, groups)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("x_bytes", [4, 2])
def test_plan_covers_every_element_once_and_fits_the_kernels(n, x_bytes):
    """At every offset of logits and targets: head, groups and tail cover
    [0, n) once; every group starts 16-byte aligned in both inputs; the
    head is the shortest that aligns both, or all n where none does; the
    grid stays inside the kernels' limits and has a thread for each work
    item up to the cap."""
    for x_off in range(0, 16, x_bytes):
        for t_off in (0, 4, 8, 12):
            _check_plan(n, x_off, t_off, x_bytes)


def _check_plan(n, x_off, t_off, x_bytes):
    plan = fl.plan_launch(n, x_off, t_off, x_bytes)
    assert 0 <= plan.head <= n and plan.groups >= 0
    assert plan.head + fl.VEC * plan.groups <= n
    assert n - plan.head - fl.VEC * plan.groups < fl.VEC or plan.head == n
    aligned = [h for h in range(fl.VEC) if (x_off + h * x_bytes) % 16 == 0
               and (t_off + 4 * h) % 16 == 0]
    assert plan.head == (min(min(aligned), n) if aligned else n)
    if plan.groups:
        assert (x_off + plan.head * x_bytes) % 16 == 0
        assert (t_off + 4 * plan.head) % 16 == 0
    assert plan.threads % 32 == 0
    assert fl.MIN_THREADS <= plan.threads <= fl.THREADS
    assert 1 <= plan.blocks <= fl.MAX_BLOCKS
    work = plan.groups or n
    assert plan.blocks * plan.threads >= min(work,
                                             fl.MAX_BLOCKS * plan.threads)


@pytest.mark.parametrize("args", [(0, 0, 0, 4), (8, 2, 0, 4), (8, 0, 2, 4),
                                  (8, 0, 0, 8), (8, 16, 0, 4), (8, 1, 0, 2)])
def test_plan_refuses_what_the_kernels_do_not_take(args):
    with pytest.raises(ValueError, match="no plan"):
        fl.plan_launch(*args)


def test_plan_for_reads_the_tensors_alignment():
    """A view one element into its storage: 4 bytes past the boundary for
    float32, 2 for bf16, as the plan's offsets."""
    base = torch.zeros(64)
    base_b = torch.zeros(64, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0 and base_b.data_ptr() % 16 == 0
    assert fl.plan_for(base[1:], base[1:]).head == 3
    assert fl.plan_for(base_b[1:], base[1:]).head == 7
    assert fl.plan_for(base[1:], base[:-1]).groups == 0


def test_plan_limits_match_the_kernel_source():
    """The plan's limits are the constants csrc/focal_dice_loss.cu
    checks."""
    with open(build.source_path(fl.NAME)) as f:
        src = f.read()

    def constant(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert fl.THREADS == int(constant("kMaxThreads"))
    assert fl.BLOCKS_PER_SM == int(constant("kBlocksPerSM"))
    assert constant("kMaxBlocks") == f"{fl.SMS} * kBlocksPerSM"
    assert fl.VEC == int(constant("kVec"))
    assert constant("kWorkspaceFloats") == "4 + 4 * kMaxBlocks"
    assert fl.WORKSPACE_FLOATS == 4 + 4 * fl.MAX_BLOCKS
    assert os.path.basename(build.source_path(fl.NAME)) == (
        "focal_dice_loss.cu")


def test_one_launch_a_call():
    """Each forward and each backward call is one launch."""
    assert fl._LAUNCHES_PER_CALL == 1


def test_plain_version_widens_bf16_logits_and_returns_bf16_dx():
    """The CPU path on bf16 logits: the sums of the widened values, and dx
    computed in float32 and rounded to bf16 as ``.to(torch.bfloat16)``
    rounds."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.randn(999) * 3).astype(np.float32)).to(
        torch.bfloat16)
    t = torch.from_numpy((rng.rand(999) > 0.7).astype(np.float32))
    hyper = (0.6, 1.79, 0.6, 1e-6)
    sums = fl.focal_dice_sums_reference(x, t, hyper[1], hyper[2])
    assert sums.dtype == torch.float32
    assert torch.equal(sums, fl.focal_dice_sums_reference(
        x.float(), t, hyper[1], hyper[2]))
    g = torch.tensor(0.5)
    dx = fl.focal_dice_grad_reference(x, t, sums, g, *hyper)
    dx32 = fl.focal_dice_grad_reference(x.float(), t, sums, g, *hyper)
    assert dx.dtype == torch.bfloat16 and dx32.dtype == torch.float32
    assert torch.equal(dx, dx32.to(torch.bfloat16))
