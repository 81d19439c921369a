"""The confusion-counts kernel's launch plan (``plan_launch``) and its
workspace, on the CPU.

The CUDA kernel takes its grid from this plan: (blocks a sample, B) blocks
of threads, each sample's elements in a scalar head until probabilities
and targets are both 16-byte aligned, then groups of 4 read 16 bytes at a
time (UNROLL of them a thread before it counts), then a scalar tail.
These tests hold the plan to what the kernel and the card need; the kernel
itself is checked on the card (tests/test_torch_cuda.py)."""

import os
import re

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch.ops.kernels import build
from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
from gan_aug_pfa_torch.ops.kernels.workspace import Workspaces


@pytest.mark.parametrize("b,threads,blocks", [(2, 32, 64), (16, 256, 8)])
def test_plan_fills_the_sms_at_the_evaluation_shapes(b, threads, blocks):
    """bs 2 and bs 16 at 128x128 (8,192 and 65,536 float4 pairs): 128
    blocks each, every thread two groups."""
    plan = cc.plan_launch(b, 128 * 128, 0, 0)
    assert plan == cc.CountsPlan(threads=threads, blocks=blocks, head=0,
                                 groups=4096, field_bits=15,
                                 workspace_ints=4 * b)
    assert b * plan.blocks == 128 <= cc.SMS
    assert plan.threads * plan.blocks * cc.UNROLL == plan.groups


def test_plan_keeps_four_blocks_an_sm_at_16x1024x1024():
    plan = cc.plan_launch(16, 1 << 20, 0, 0)
    assert plan == cc.CountsPlan(threads=256, blocks=33, head=0,
                                 groups=1 << 18, field_bits=0,
                                 workspace_ints=64)
    assert 16 * plan.blocks == cc.MAX_BLOCKS


@pytest.mark.parametrize("b,hw,blocks,field_bits", [
    (2, 128 * 128, 64, 15),     # 45 + 7 bits
    (1, 1, 1, 1),
    (4000, 16 * 16, 1, 9),
    (2, 256 * 256, 64, 17),     # 51 + 7 bits
    (1, 400 * 400, 125, 18),    # 54 + 7 bits
    (4, 512 * 512, 128, 0),     # 57 + 8 bits: three counts and a ticket
    (16, 1 << 20, 33, 0),       # 63 + 6 bits
])
def test_plan_packs_counts_and_ticket_where_they_fit(b, hw, blocks,
                                                     field_bits):
    """One 64-bit word a sample holds three counts of ``field_bits`` bits
    (each up to hw) and the ticket (up to the sample's blocks) above
    them, where 3 * bits(hw) + bits(blocks) <= 64; else field_bits is 0."""
    plan = cc.plan_launch(b, hw, 0, 0)
    assert (plan.blocks, plan.field_bits) == (blocks, field_bits)
    if plan.field_bits:
        assert hw < 1 << plan.field_bits
        assert 3 * plan.field_bits + plan.blocks.bit_length() <= 64


@pytest.mark.parametrize("b,hw,p_off,t_off,head,groups", [
    (1, 37 * 53, 0, 0, 0, 490),      # B = 1: a tail of 1
    (1, 37 * 53, 4, 4, 3, 489),      # one element into 16-byte storage
    (1, 37 * 53, 8, 8, 2, 489),
    (1, 37 * 53, 4, 8, 1961, 0),     # p and t never both aligned
    (3, 37 * 53, 0, 0, 1961, 0),     # samples of different alignment
    (3, 1, 0, 0, 1, 0),
    (16, 128 * 128, 12, 12, 1, 4095),
    (1, 3, 4, 4, 3, 0),              # the head is the whole sample
])
def test_plan_heads_and_groups(b, hw, p_off, t_off, head, groups):
    plan = cc.plan_launch(b, hw, p_off, t_off)
    assert (plan.head, plan.groups) == (head, groups)


def _coverage(plan, hw):
    """How often the kernel's loops, as csrc/confusion_counts.cu walks
    them, visit each element of one sample."""
    seen = np.zeros(hw, np.int64)
    stride = plan.blocks * plan.threads
    for gid in range(stride):
        seen[gid:plan.head:stride] += 1
        for j in range(gid, plan.groups, cc.UNROLL * stride):
            for u in range(cc.UNROLL):
                k = j + u * stride
                if k < plan.groups:
                    seen[plan.head + cc.VEC * k:
                         plan.head + cc.VEC * (k + 1)] += 1
        seen[plan.head + cc.VEC * plan.groups + gid::stride] += 1
    return seen


@pytest.mark.parametrize("b,hw", [(1, 1), (2, 7), (1, 37 * 53), (5, 33 * 47),
                                  (2, 128 * 128), (16, 128 * 128),
                                  (40, 64)])
def test_plan_covers_every_element_once_and_fits_the_kernel(b, hw):
    """At every offset of probabilities and targets: the loops visit each
    element of a sample exactly once; every group starts 16-byte aligned
    in both (and in every sample); the grid stays inside the kernel's
    limits; the workspace holds a slot a sample."""
    for p_off in (0, 4, 8, 12):
        for t_off in (0, 4, 8, 12):
            plan = cc.plan_launch(b, hw, p_off, t_off)
            assert (_coverage(plan, hw) == 1).all(), plan
            if plan.groups:
                assert (p_off + 4 * plan.head) % 16 == 0
                assert (t_off + 4 * plan.head) % 16 == 0
                assert b == 1 or hw % cc.VEC == 0
            # The scalar tail is shorter than a group, or nothing aligns.
            assert (hw - plan.head - cc.VEC * plan.groups < cc.VEC
                    or plan.head == hw)
            assert plan.threads % 32 == 0
            assert cc.MIN_THREADS <= plan.threads <= cc.THREADS
            assert 1 <= plan.blocks <= cc.MAX_BLOCKS
            assert plan.workspace_ints == cc.SLOT_INTS * b


@pytest.mark.parametrize("b,hw", [(2, 128 * 128), (16, 128 * 128),
                                  (16, 1 << 20), (1, 1 << 20)])
def test_plan_at_large_shapes_covers_every_group(b, hw):
    """Where walking the loops would be slow: every group lies inside the
    sample, and the grid has a thread for each UNROLL groups up to its
    cap."""
    plan = cc.plan_launch(b, hw, 0, 0)
    assert plan.head + cc.VEC * plan.groups == hw
    work = plan.groups / cc.UNROLL
    assert plan.threads * plan.blocks >= min(
        work, -(-cc.MAX_BLOCKS // b) * plan.threads)


@pytest.mark.parametrize("args", [(0, 16, 0, 0), (2, 0, 0, 0),
                                  (65536, 16, 0, 0), (2, 16, 2, 0),
                                  (2, 16, 0, 16), (2, 16, -4, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError, match="no plan"):
        cc.plan_launch(*args)


def test_plan_for_reads_the_tensors_alignment():
    """A batch slice one pixel into its storage: 4 bytes past the
    boundary."""
    base = torch.zeros(2 * 4 * 4 + 1)
    assert base.data_ptr() % 16 == 0
    p = base[1:].view(2, 4, 4)
    assert cc.plan_for(p, p).head == 3
    assert cc.plan_for(p, base[:-1].view(2, 4, 4)).groups == 0


def test_workspace_follows_the_plan_and_grows():
    """One zeroed workspace a (device, stream), as large as the largest
    plan that used it: a larger batch makes a new zeroed one."""
    ws = Workspaces(torch.int32)
    cpu = torch.device("cpu")
    small = ws.persistent(cpu, 7, cc.plan_launch(2, 64, 0, 0).workspace_ints)
    assert small.numel() == 8 and not small.any()
    assert ws.persistent(cpu, 7, cc.plan_launch(1, 64, 0, 0).workspace_ints
                         ) is small
    big = ws.persistent(cpu, 7, cc.plan_launch(700, 64, 0, 0).workspace_ints)
    assert big.numel() == 2800 and big.dtype == torch.int32
    assert not big.any()
    other = ws.persistent(cpu, 8, 8)
    assert other is not big and set(ws) == {(None, 7), (None, 8)}


def test_plan_limits_match_the_kernel_source():
    """The plan's limits are the constants csrc/confusion_counts.cu
    checks."""
    with open(build.source_path(cc.NAME)) as f:
        src = f.read()

    def constant(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert cc.THREADS == int(constant("kMaxThreads"))
    assert cc.BLOCKS_PER_SM == int(constant("kBlocksPerSM"))
    assert constant("kMaxBlocks") == f"{cc.SMS} * kBlocksPerSM"
    assert cc.VEC == int(constant("kVec"))
    assert cc.UNROLL == int(constant("kUnroll"))
    assert cc.SLOT_INTS == int(constant("kSlotInts"))
    assert cc.MAX_BATCH == int(constant("kMaxBatch"))
    assert os.path.basename(build.source_path(cc.NAME)) == (
        "confusion_counts.cu")
