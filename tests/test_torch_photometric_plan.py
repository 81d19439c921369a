"""The photometric kernels' launch plan (``plan_launch``), on the CPU.

The CUDA kernel takes its geometry from this plan: one thread-block cluster
an image, one block a band of rows, the band held in shared memory where it
fits (resident) or passed through a ring of rows there (streamed).  These
tests hold the plan to what the kernel and the card need; the kernel itself
is checked on the card (tests/test_torch_cuda.py)."""

import os
import re

import pytest

from gan_aug_pfa_torch.ops.kernels import build
from gan_aug_pfa_torch.ops.kernels import photometric as ph

SHAPES = [(4, 392, 400), (3, 392, 400), (4, 128, 128), (3, 128, 128),
          (16, 1024, 1024), (2, 1024, 1024), (3, 37, 53), (4, 8, 8),
          (2, 2, 2), (1, 1, 1), (1, 1, 5), (2, 17, 4000), (1, 5000, 64),
          (2, 64, 4000), (2, 700, 1023)]


def _row_bytes(wp):
    """Bytes of a shared row: three float32 channels, 16-byte aligned."""
    return 3 * 4 * (-(-wp // 4) * 4)


@pytest.mark.parametrize("shape,cluster,split,band,smem", [
    ((4, 392, 400), 16, 1, 25, 27 * 3 * 4 * 400),
    ((4, 128, 128), 16, 1, 8, 10 * 3 * 4 * 128),
    ((3, 392, 400), 16, 2, 25, 15 * 3 * 4 * 400),
    ((3, 37, 53), 16, 2, 3, 4 * 3 * 4 * 56),
])
def test_plan_is_resident_where_the_band_fits(shape, cluster, split, band,
                                              smem):
    """The training path's padded native batch and the fixed-size batch:
    a cluster of 16 blocks an image, the band and two halo rows of all
    three channels (16-byte rows) in shared memory; a batch of 3 splits
    each image over 2 clusters, a block holding half its band."""
    plan = ph.plan_launch(*shape)
    assert (plan.mode, plan.cluster, plan.split, plan.band_rows,
            plan.slots, plan.smem_bytes) == (
        "resident", cluster, split, band, -(-band // split) + 2, smem)


@pytest.mark.parametrize("b,split", [(1, 4), (2, 3), (3, 2), (4, 1),
                                     (7, 1), (16, 1)])
def test_plan_splits_small_batches_over_the_clusters_the_card_holds(b, split):
    """Up to MAX_SPLIT clusters an image while all b * split fit the card
    at once (CLUSTERS_AT_ONCE): no cluster waits for another wave."""
    plan = ph.plan_launch(b, 392, 400)
    assert plan.split == split
    assert b * plan.split <= max(b, ph.CLUSTERS_AT_ONCE)
    assert plan.grid == b * split * plan.cluster


@pytest.mark.parametrize("shape", [(1, 392, 400), (2, 392, 400),
                                   (3, 37, 53), (2, 64, 64), (1, 40, 8)])
def test_plan_parts_cover_every_band_row_once(shape):
    """The clusters of an image store every row of each band exactly once,
    at every extent, and no part is longer than the shared rows allow."""
    plan = ph.plan_launch(*shape)
    assert plan.split > 1
    for h in sorted({shape[1], max(1, shape[1] // 3), 1}):
        for y0, y1 in plan.bands(h):
            parts = plan.parts(y0, y1)
            assert len(parts) == plan.split
            assert [y for a, z in parts for y in range(a, z)] == list(
                range(y0, y1))
            assert max(z - a for a, z in parts) + 2 <= plan.slots


@pytest.mark.parametrize("shape,threads", [((16, 1024, 1024), 256),
                                           ((2, 1024, 1024), 256),
                                           ((2, 700, 1023), 256),
                                           ((2, 64, 4000), 512),
                                           ((1, 5000, 64), 64)])
def test_plan_is_streamed_where_the_band_does_not_fit(shape, threads):
    """At 1024 x 1024 a band of 64 + 2 rows takes 811,008 bytes: the band
    passes through a ring of MIN_SLOTS..MAX_SLOTS rows, a thread a float4
    group of a row."""
    plan = ph.plan_launch(*shape)
    row = _row_bytes(shape[2])
    assert plan.mode == "streamed" and plan.threads == threads
    assert (plan.band_rows + 2) * row > ph.BAND_LIMIT
    assert ph.MIN_SLOTS <= plan.slots <= ph.MAX_SLOTS
    assert plan.smem_bytes == plan.slots * row <= ph.BAND_LIMIT


def test_plan_streams_1024_wide_rows_through_four_slots():
    """The 16x3x1024x1024 plan: 256 blocks in clusters of 16, a ring of 4
    rows (49,152 bytes), so that several blocks share an SM; one cluster an
    image, even for a single image."""
    plan = ph.plan_launch(16, 1024, 1024)
    assert (plan.cluster, plan.split, plan.band_rows, plan.slots,
            plan.smem_bytes, plan.grid) == (16, 1, 64, 4, 49_152, 256)
    assert ph.plan_launch(1, 1024, 1024).split == 1


@pytest.mark.parametrize("shape", [(1, 64, 6000), (2, 17, 6000)])
def test_plan_refuses_rows_too_wide_for_the_ring(shape):
    """Four 6000-px rows take 288,000 bytes: no plan, no fallback."""
    with pytest.raises(ValueError, match="no plan"):
        ph.plan_launch(*shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_stays_inside_what_a_block_and_a_cluster_may_take(shape):
    plan = ph.plan_launch(*shape)
    assert 0 < plan.smem_bytes <= ph.BAND_LIMIT < ph.MAX_SHARED_BYTES
    assert ph.MAX_SHARED_BYTES == 232_448
    assert plan.smem_bytes == plan.slots * _row_bytes(shape[2])
    assert 1 <= plan.cluster <= ph.MAX_CLUSTER == 16
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.grid == shape[0] * plan.split * plan.cluster
    assert plan.grid % plan.cluster == 0
    assert 1 <= plan.split <= ph.MAX_SPLIT
    assert plan.split == 1 or plan.mode == "resident"


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_bands_cover_every_row_once(shape):
    """At the full height and at smaller native extents: every row of the
    extent in exactly one block's band, no band longer than band_rows (the
    rows the shared memory was sized for)."""
    plan = ph.plan_launch(*shape)
    hp = shape[1]
    for h in sorted({hp, max(1, hp - 1), max(1, hp // 2), max(1, hp // 3),
                     1}):
        bands = plan.bands(h)
        assert len(bands) == plan.cluster
        rows = [y for y0, y1 in bands for y in range(y0, y1)]
        assert rows == list(range(h))
        assert max(y1 - y0 for y0, y1 in bands) <= plan.band_rows


def test_plan_c_args_are_the_entry_points_plan_arguments():
    plan = ph.plan_launch(4, 392, 400)
    assert plan.c_args() == (plan.threads, 16, 1, 25, 1, 129_600)
    assert ph.plan_launch(16, 1024, 1024).c_args() == (256, 16, 1, 64, 0,
                                                       49_152)


@pytest.mark.parametrize("shape", [(0, 8, 8), (2, 0, 8), (2, 8, 0)])
def test_plan_refuses_empty_images(shape):
    with pytest.raises(ValueError):
        ph.plan_launch(*shape)


def test_plan_limits_match_the_kernel_source():
    """The plan's limits are the constants csrc/photometric.cu checks."""
    with open(build.source_path(ph.NAME)) as f:
        src = f.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert ph.THREADS == constant("kMaxThreads")
    assert ph.MAX_CLUSTER == constant("kMaxCluster")
    assert ph.MAX_SPLIT == constant("kMaxSplit")
    assert ph.MAX_SHARED_BYTES == constant("kMaxSharedBytes")
    assert (ph.MIN_SLOTS, ph.MAX_SLOTS) == (constant("kMinSlots"),
                                            constant("kMaxSlots"))
    assert os.path.basename(build.source_path(ph.NAME)) == "photometric.cu"


def test_one_launch_a_call():
    """Each photometric call is one launch of the cluster kernel."""
    assert ph._LAUNCHES_PER_CALL == 1
