"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor PIL, so that it runs on a machine
with a card and PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (the kernels have no CPU mode)."""

import dataclasses

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
from gan_aug_pfa_torch.ops.kernels import fused_loss as fl

SHAPES = [(2, 128, 128), (16, 128, 128), (5, 33, 47), (1, 37, 53),
          (3, 1, 1), (4, 512, 512), (16, 1024, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _inputs(shape, threshold, seed):
    rng = np.random.RandomState(seed)
    p = rng.rand(*shape).astype(np.float32)
    p.reshape(-1)[::7] = threshold  # at the threshold: negative
    t = (rng.rand(*shape) > 0.6).astype(np.float32)
    t[0] = 1.0
    if shape[0] > 1:
        t[-1] = 0.0
    return torch.from_numpy(p).cuda(), torch.from_numpy(t).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_confusion_counts_kernel_matches_reference(cuda, shape, threshold):
    p, t = _inputs(shape, threshold, seed=sum(shape))
    fn = cc.confusion_counts_batch
    before = (fn.calls, fn.launches)
    got = cc.confusion_counts_batch(p, t, threshold)
    again = cc.confusion_counts_batch(p, t, threshold)
    torch.cuda.synchronize()
    assert (fn.calls, fn.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, cc.confusion_counts_batch_reference(p, t,
                                                                threshold))
    assert torch.equal(got, again)  # the slots went back to 0
    assert bool((got.sum(dim=1) == shape[1] * shape[2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 2])
def test_confusion_counts_kernel_misaligned_view(cuda, b):
    """A batch slice whose data pointer is not 16-byte aligned: one sample
    (a scalar head of 3, then 16-byte groups) or two (37x53 samples do not
    share one alignment: every element scalar).  The same counts."""
    p, t = _inputs((b, 37, 53), 0.5, seed=1)
    p, t = p[1:], t[1:]
    assert p.data_ptr() % 16 != 0
    plan = cc.plan_for(p, t)
    assert (plan.groups > 0) == (b == 2)
    got = cc.confusion_counts_batch(p, t)
    assert torch.equal(got, cc.confusion_counts_batch_reference(p, t))


@pytest.mark.cuda
def test_confusion_counts_workspace_grows_with_the_batch(cuda):
    """Calls at B = 2, then at a B whose slots do not fit the stream's
    workspace (a new zeroed one), then at B = 2 again: every result equals
    the plain version."""
    stream = torch.cuda.current_stream().cuda_stream
    for b in (2, 4000, 2):
        p, t = _inputs((b, 16, 16), 0.5, seed=b)
        got = cc.confusion_counts_batch(p, t)
        assert torch.equal(got, cc.confusion_counts_batch_reference(p, t))
        ws = cc._workspaces.persistent(p.device, stream, 0)
        assert ws.numel() >= cc.SLOT_INTS * b
    torch.cuda.synchronize()
    assert not bool(ws.any())


@pytest.mark.cuda
def test_confusion_counts_two_streams_in_turn(cuda):
    """Calls on two streams in turn, each stream with its own workspace:
    every result equals the plain version's."""
    inputs = [_inputs((2, 128, 128), 0.5, seed=s) for s in (31, 32)]
    want = [cc.confusion_counts_batch_reference(p, t) for p, t in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(cc.confusion_counts_batch(*inputs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(v, want[i]) for v in got[i])
    assert {(0, s.cuda_stream) for s in streams} <= set(cc._workspaces)


def _capture(fn):
    """``fn`` warmed up on a side stream, then captured in a CUDA graph:
    (graph, what the capture returned)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.cuda
def test_confusion_counts_graph_replays_equal_eager(cuda):
    """Two graphs, each with its own zeroed workspace, replayed in turn
    with eager calls on the default stream between them: every replay
    gives the eager bits."""
    inputs = [_inputs((2, 128, 128), 0.5, seed=41),
              _inputs((16, 128, 128), 0.3, seed=42)]
    thresholds = (0.5, 0.3)
    eager = [cc.confusion_counts_batch(p, t, thr)
             for (p, t), thr in zip(inputs, thresholds)]
    graphs = [_capture(lambda p=p, t=t, thr=thr:
                       cc.confusion_counts_batch(p, t, thr))
              for (p, t), thr in zip(inputs, thresholds)]
    for _ in range(3):
        for i, (graph, out) in enumerate(graphs):
            graph.replay()
            between = cc.confusion_counts_batch(*inputs[1 - i],
                                                thresholds[1 - i])
            torch.cuda.synchronize()
            assert torch.equal(out, eager[i])
            assert torch.equal(between, eager[1 - i])


@pytest.mark.cuda
def test_confusion_counts_call_is_one_kernel_launch(cuda):
    """At the evaluation shape a call runs the kernel once and no other
    device op: no fill, no derive, no cast."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p, t = _inputs((2, 128, 128), 0.5, seed=51)
    cc.confusion_counts_batch(p, t)  # build, warm up, make the workspace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cc.confusion_counts_batch(p, t)
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA}
    assert len(ops) == 1 and all(
        "confusion_counts" in k and c == 1 for k, c in ops.items()), ops


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 128), (16, 128, 128), (1, 1, 6)])
def test_confusion_counts_sweep_matches_reference(cuda, shape):
    """The threshold sweep's (T, B, 4) counts, one kernel launch a
    threshold, equal the plain version's at every grid threshold, with
    probabilities at float32(0.35), float32(0.55) and their neighbours."""
    from gan_aug_pfa_torch.metrics import (
        confusion_counts_sweep,
        sweep_thresholds,
    )

    grid = sweep_thresholds()
    p, t = _inputs(shape, 0.5, seed=61 + shape[0])
    edges = []
    for th in (0.35, 0.55):
        f = np.float32(th)
        edges += [np.nextafter(f, np.float32(0)), f,
                  np.nextafter(f, np.float32(1))]
    p.view(-1)[:6] = torch.tensor(edges, dtype=torch.float32)
    fn = cc.confusion_counts_batch
    before = (fn.calls, fn.launches)
    got = confusion_counts_sweep(p, t, grid)
    torch.cuda.synchronize()
    assert (fn.calls, fn.launches) == (before[0] + len(grid),
                                       before[1] + len(grid))
    want = torch.stack([cc.confusion_counts_batch_reference(p, t, float(th))
                        for th in grid])
    assert got.shape == (len(grid), shape[0], 4)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_confusion_counts_kernel_refuses_a_plan_it_does_not_take(cuda):
    """The C entry point checks the plan and the workspace: threads that
    are not a multiple of 32 or above 256, no blocks or too many, groups
    past the end or not 16-byte aligned, count fields too narrow for H*W
    or too wide for one word, a workspace short of a slot a sample.  An
    error, not a fallback.  The plans it takes, with either way of
    meeting, give the plain version's counts."""
    fn = cc._kernel()
    p, t = _inputs((2, 128, 128), 0.5, seed=61)
    out = torch.empty((2, 4), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ws = cc._workspaces.persistent(p.device, stream, 8)
    plan = cc.plan_for(p, t)

    def run(pl, ws_ints=8):
        return fn(p.data_ptr(), t.data_ptr(), 0.5, 2, 128 * 128,
                  *pl.c_args(), out.data_ptr(), ws.data_ptr(), ws_ints,
                  stream)

    for bad in (dataclasses.replace(plan, threads=48),
                dataclasses.replace(plan, threads=512),
                dataclasses.replace(plan, blocks=0),
                dataclasses.replace(plan, blocks=cc.MAX_BLOCKS + 1),
                dataclasses.replace(plan, groups=plan.groups + 1),
                dataclasses.replace(plan, head=1, groups=plan.groups - 1),
                dataclasses.replace(plan, field_bits=14),
                dataclasses.replace(plan, field_bits=22),
                dataclasses.replace(plan, field_bits=-1)):
        assert run(bad) != 0, bad
    assert run(plan, ws_ints=7) != 0
    ref = cc.confusion_counts_batch_reference(p, t)
    # Both ways of meeting: one 64-bit word a sample (the plan's at this
    # shape), and three int32 counts and a ticket.
    assert plan.field_bits == 15
    for good in (plan, dataclasses.replace(plan, field_bits=0), plan):
        out.zero_()
        assert run(good) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, ref), good
    assert not bool(ws.any())


# The fused FocalDice kernels: the shapes chip_smoke.py checks, with the
# tuned gamma and the u^0 edge at gamma = 1.
LOSS_SHAPES = [(1, 1, 7, 9), (4, 1, 128, 128), (3, 1, 37, 53),
               (4, 1, 512, 512)]
GAMMAS = [1.7930869982898021, 1.0]
LOSS_KW = dict(beta=0.6699803915247974, focal_alpha=0.6030489822904476,
               dice_smooth=1.956571276926647e-06)


def _loss_inputs(shape, seed, extra=0):
    """Logits (B, 1, H, W) with saturated +-1e4 entries and binary targets
    (B, H, W); ``extra`` leading elements make views 4 bytes past a 16-byte
    boundary."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    x = (rng.randn(n + extra) * 4).astype(np.float32)
    x[::101] = 1e4
    x[50::101] = -1e4
    t = (rng.rand(n + extra) > 0.7).astype(np.float32)
    x = torch.from_numpy(x).cuda()[extra:]
    t = torch.from_numpy(t).cuda()[extra:]
    b, _, h, w = shape
    return x.view(shape), t.view(b, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LOSS_SHAPES)
@pytest.mark.parametrize("gamma", GAMMAS)
def test_fused_loss_kernels_match_plain_version(cuda, shape, gamma):
    """Forward within 1e-6 relative, dx within 1e-5 of max|dx| (1e-3 from
    2^20 elements on), launch counts, and the same bits on a rerun."""
    x, t = _loss_inputs(shape, seed=sum(shape),
                        extra=1 if shape == (3, 1, 37, 53) else 0)
    xf, tf = x.reshape(-1), t.reshape(-1)
    hyper = (LOSS_KW["beta"], gamma, LOSS_KW["focal_alpha"],
             LOSS_KW["dice_smooth"])
    g = torch.tensor(0.73, device="cuda")
    loss, sums = fl.launch_forward(xf, tf, *hyper)
    dx = fl.launch_backward(xf, tf, sums, g, *hyper)
    again, _ = fl.launch_forward(xf, tf, *hyper)
    torch.cuda.synchronize()
    ref_sums = fl.focal_dice_sums_reference(xf, tf, gamma, hyper[2])
    ref = float(fl._finalize(ref_sums, xf.numel(), hyper[0], hyper[3]))
    ref_dx = fl.focal_dice_grad_reference(xf, tf, ref_sums, g, *hyper)
    assert abs(float(loss) - ref) < 1e-6 * max(1.0, abs(ref))
    tol = 1e-3 if xf.numel() >= 1 << 20 else 1e-5
    assert bool(dx.isfinite().all())
    assert float((dx - ref_dx).abs().max()) <= tol * float(
        ref_dx.abs().max())
    assert torch.equal(loss, again)

    before = (fl.FocalDiceLossFn.fwd_launches,
              fl.FocalDiceLossFn.bwd_launches)
    xg = x.detach().clone().requires_grad_()
    fl.focal_dice_loss_fused(xg, t, focal_gamma=gamma, **LOSS_KW).backward()
    assert (fl.FocalDiceLossFn.fwd_launches,
            fl.FocalDiceLossFn.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert float((xg.grad.reshape(-1) - ref_dx / 0.73).abs().max()) <= (
        tol * float(ref_dx.abs().max()) / 0.73)


def _loss_hyper(gamma):
    return (LOSS_KW["beta"], gamma, LOSS_KW["focal_alpha"],
            LOSS_KW["dice_smooth"])


def _assert_kernels_match_plain(xf, tf, gamma):
    """Kernel forward and backward on flat CUDA tensors against the plain
    version on the same values: the loss within 1e-6 relative, dx within
    1e-5 of max|dx| (1e-3 from 2^20 elements on) and, for bf16 dx, one
    bf16 rounding step of each value more.  Returns (loss, sums, dx)."""
    hyper = _loss_hyper(gamma)
    g = torch.tensor(0.73, device="cuda")
    loss, sums = fl.launch_forward(xf, tf, *hyper)
    dx = fl.launch_backward(xf, tf, sums, g, *hyper)
    torch.cuda.synchronize()
    ref_sums = fl.focal_dice_sums_reference(xf, tf, gamma, hyper[2])
    ref = float(fl._finalize(ref_sums, xf.numel(), hyper[0], hyper[3]))
    ref_dx = fl.focal_dice_grad_reference(xf, tf, ref_sums, g, *hyper)
    assert abs(float(loss) - ref) < 1e-6 * max(1.0, abs(ref)), (
        float(loss), ref)
    assert dx.dtype == xf.dtype and bool(dx.isfinite().all())
    got, want = dx.float(), ref_dx.float()
    tol = (1e-3 if xf.numel() >= 1 << 20 else 1e-5) * float(
        want.abs().max())
    step = 2 ** -7 * want.abs() if xf.dtype == torch.bfloat16 else 0.0
    assert bool(((got - want).abs() <= step + tol).all()), float(
        (got - want).abs().max())
    return loss, sums, dx


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LOSS_SHAPES)
@pytest.mark.parametrize("gamma", GAMMAS)
def test_fused_loss_kernels_take_bf16_logits(cuda, shape, gamma):
    """bf16 logits read in place (the (3, 1, 37, 53) view starts 2 bytes
    past a 16-byte boundary, its targets 4): the same checks against the
    plain version on the same values, dx in bf16, equal bits on a rerun."""
    extra = 1 if shape == (3, 1, 37, 53) else 0
    x, t = _loss_inputs(shape, seed=sum(shape) + 1)
    xb = torch.cat([x.reshape(-1)[:extra], x.reshape(-1)]).to(
        torch.bfloat16)[extra:]
    tf = torch.cat([t.reshape(-1)[:extra], t.reshape(-1)])[extra:]
    if extra:
        assert xb.data_ptr() % 16 == 2 and tf.data_ptr() % 16 == 4
    loss, sums, dx = _assert_kernels_match_plain(xb, tf, gamma)
    again, sums2 = fl.launch_forward(xb, tf, *_loss_hyper(gamma))
    assert torch.equal(loss, again) and torch.equal(sums, sums2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 63, 1001, 8003, 65_539])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_loss_kernels_ragged_sizes_and_offsets(cuda, n, offset, dtype):
    """Element counts that are not a multiple of 8 and views that start
    1 or 3 elements into their storage: the scalar head and tail inside the
    kernels.  Logits offset by one element more than the targets: where no
    head aligns both (every case here), every element takes the scalar
    path."""
    rng = np.random.RandomState(n + offset)
    x = torch.from_numpy((rng.randn(n + 4) * 4).astype(np.float32)).cuda()
    t = torch.from_numpy((rng.rand(n + 4) > 0.7).astype(np.float32)).cuda()
    x = x.to(dtype)
    for dx_off in (0, 1):
        xf, tf = x[offset + dx_off:offset + dx_off + n], t[offset:offset + n]
        plan = fl.plan_for(xf, tf)
        assert plan.head + fl.VEC * plan.groups <= n
        _assert_kernels_match_plain(xf, tf, GAMMAS[0])


@pytest.mark.cuda
def test_fused_loss_forward_reruns_give_equal_bits(cuda):
    """1,000 forwards back to back on one stream: the ticket goes back to 0
    after each, and every loss and sum has the same bits."""
    x, t = _loss_inputs((4, 1, 128, 128), seed=11)
    xb, tf = x.reshape(-1).to(torch.bfloat16), t.reshape(-1)
    hyper = _loss_hyper(GAMMAS[0])
    outs = [torch.cat([a.view(1), b]) for a, b in (
        fl.launch_forward(xb, tf, *hyper) for _ in range(1000))]
    outs = torch.stack(outs)
    assert bool((outs == outs[0]).all())
    ws = fl.workspace(xb.device, torch.cuda.current_stream().cuda_stream)
    assert int(ws[:1].view(torch.int32)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_loss_graph_replay_equals_eager(cuda, dtype):
    """The forward and backward captured in one CUDA graph and replayed
    give the eager bits, replay after replay."""
    x, t = _loss_inputs((4, 1, 128, 128), seed=12)
    xf, tf = x.reshape(-1).to(dtype), t.reshape(-1)
    hyper = _loss_hyper(GAMMAS[0])
    g = torch.tensor(0.73, device="cuda")
    loss, sums = fl.launch_forward(xf, tf, *hyper)
    dx = fl.launch_backward(xf, tf, sums, g, *hyper)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fl.launch_forward(xf, tf, *hyper)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gl, gs = fl.launch_forward(xf, tf, *hyper)
        gdx = fl.launch_backward(xf, tf, gs, g, *hyper)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(gl, loss) and torch.equal(gs, sums)
        assert torch.equal(gdx, dx)
    # Eager calls after the capture still start from a ticket of 0.
    again, _ = fl.launch_forward(xf, tf, *hyper)
    assert torch.equal(again, loss)


@pytest.mark.cuda
def test_fused_loss_two_streams_in_turn(cuda):
    """Forwards on two streams in turn, each stream with its own
    workspace: every result equals the same call on the default stream."""
    hyper = _loss_hyper(GAMMAS[0])
    inputs = [(x.reshape(-1), t.reshape(-1)) for x, t in (
        _loss_inputs((4, 1, 128, 128), seed=s) for s in (21, 22))]
    want = [fl.launch_forward(x, t, *hyper)[0] for x, t in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(fl.launch_forward(*inputs[i], *hyper)[0])
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(v, want[i]) for v in got[i])
    keys = {(0, s.cuda_stream) for s in streams}
    assert keys <= set(fl._workspaces)


@pytest.mark.cuda
def test_fused_loss_counts_calls_and_launches(cuda):
    """One forward and one backward through the wrapper: one call and one
    launch each way."""
    x, t = _loss_inputs((4, 1, 128, 128), seed=13)
    xb = x.to(torch.bfloat16).requires_grad_()
    fn = fl.FocalDiceLossFn
    before = (fn.fwd_calls, fn.fwd_launches, fn.bwd_calls, fn.bwd_launches)
    fl.focal_dice_loss_fused(xb, t, **LOSS_KW).backward()
    assert (fn.fwd_calls, fn.fwd_launches, fn.bwd_calls,
            fn.bwd_launches) == tuple(v + 1 for v in before)


@pytest.mark.cuda
def test_bf16_loss_runs_no_cast_kernel(cuda):
    """Under bf16 autocast the loss forward and backward of bf16 logits are
    the two kernels and nothing else: no cast of the logits before, none of
    dx after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, t = _loss_inputs((4, 1, 128, 128), seed=14)
    xb = x.to(torch.bfloat16).requires_grad_()
    g = torch.ones((), device="cuda")
    fl.focal_dice_loss_fused(xb, t, **LOSS_KW).backward(g)  # build, warm up
    xb.grad = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = fl.focal_dice_loss_fused(xb, t, **LOSS_KW)
        loss.backward(g)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    assert len(kernels) == 2 and all(
        "focal_dice" in k and c == 1 for k, c in kernels.items()), kernels
    assert xb.grad.dtype == torch.bfloat16


@pytest.mark.cuda
def test_fused_loss_kernel_refuses_a_plan_it_does_not_take(cuda):
    """The C entry points check the plan: threads that are not a multiple
    of 32 or above 256, no blocks or more than the workspace holds, groups
    past the end, groups that are not 16-byte aligned; and a focal-mean
    divisor n_total below the element count.  An error, not a
    fallback."""
    fwd, bwd = fl._kernels()
    x, t = _loss_inputs((4, 1, 128, 128), seed=15)
    xf, tf = x.reshape(-1), t.reshape(-1)
    n = xf.numel()
    out = torch.empty(5, device="cuda")
    dx = torch.empty_like(xf)
    g = torch.ones((), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ws = fl.workspace(xf.device, stream)
    plan = fl.plan_for(xf, tf)
    hyper = _loss_hyper(GAMMAS[0])

    def run(p, n_total=n):
        a = fwd(xf.data_ptr(), 0, tf.data_ptr(), n, n_total, *p.c_args(),
                *hyper, out.data_ptr(), ws.data_ptr(), stream)
        b = bwd(xf.data_ptr(), 0, tf.data_ptr(), out[1:].data_ptr(),
                g.data_ptr(), n, n_total, *p.c_args(), *hyper, dx.data_ptr(),
                stream)
        return a, b

    for bad in (dataclasses.replace(plan, threads=48),
                dataclasses.replace(plan, threads=512),
                dataclasses.replace(plan, blocks=0),
                dataclasses.replace(plan, blocks=fl.MAX_BLOCKS + 1),
                dataclasses.replace(plan, groups=plan.groups + 1),
                dataclasses.replace(plan, head=1)):
        assert all(e != 0 for e in run(bad)), bad
    assert all(e != 0 for e in run(plan, n - 1))
    assert run(plan) == (0, 0)
    assert run(plan, 2 * n) == (0, 0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fused_loss_backward_under_bf16_autocast(cuda):
    """Under bf16 autocast, bf16 logits reach the kernels as they are and
    dx comes back as bf16: equal to the plain version's dx at the same
    (widened) logits, cast to bf16 the same way."""
    x, t = _loss_inputs((4, 1, 128, 128), seed=3)
    xb = x.to(torch.bfloat16).detach().requires_grad_()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = fl.focal_dice_loss_fused(xb, t, **LOSS_KW)
    loss.backward()
    assert loss.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16
    x32 = xb.detach().float().requires_grad_()
    ref = fl.FocalDiceLossReferenceFn.apply(
        x32.reshape(-1), t.reshape(-1), LOSS_KW["beta"], 2.0,
        LOSS_KW["focal_alpha"], LOSS_KW["dice_smooth"])
    ref.backward()
    loss, ref = float(loss.detach()), float(ref.detach())
    assert abs(loss - ref) < 1e-6 * max(1.0, abs(ref))
    want = x32.grad.to(torch.bfloat16).float()
    got = xb.grad.float()
    # Equal up to one bf16 rounding step of values that agree in fp32.
    assert float((got - want).abs().max()) <= 2 ** -8 * float(
        want.abs().max())


# The photometric kernels: every jitter order, both sigma edges, factors
# that engage the clips.  Native extents ragged against the bands, of 1 and
# 2 rows or columns, and at the training path's padded shape (extents of
# 200-399 px); 1024x1024 and 700x1023 images take the streamed plan (the
# latter with rows that are not 16-byte aligned, as 37x53 in the resident
# plan), the rest the resident one, batches of 1 to 3 split over 2 to 4
# clusters an image.
NATIVE_CASES = [
    (4, 32, 32, [[32, 32], [25, 29], [16, 31], [31, 16]]),
    (4, 400, 400, [[201, 397], [400, 400], [256, 130], [399, 200]]),
    (4, 392, 400, [[392, 400], [200, 399], [317, 262], [255, 203]]),
    (3, 392, 400, [[392, 400], [1, 2], [255, 203]]),
    (2, 392, 400, [[392, 400], [17, 399]]),
    (1, 392, 400, [[392, 400]]),
    (4, 8, 8, [[1, 1], [2, 2], [1, 8], [8, 2]]),
    (2, 2, 2, [[1, 2], [2, 1]]),
    (1, 1, 1, [[1, 1]]),
    (2, 1024, 1024, [[1024, 1024], [777, 1001]]),
    (4, 1024, 1024, [[1, 1], [2, 1024], [40, 1000], [100, 3]]),
    (2, 700, 1023, [[700, 1023], [699, 517]]),
]
FLIP_SHAPES = [(4, 3, 128, 128), (3, 3, 128, 128), (1, 3, 128, 128),
               (3, 3, 37, 53), (2, 3, 2, 2), (1, 3, 1, 5), (2, 3, 1024, 1024),
               (2, 3, 700, 1023), (4, 3, 70, 1024)]


def _photometric_rows(b, order, sizes=None, seed=0):
    """(B, 8) rows: factors 0.7 / 1.3 alternating, sigma 0.1 / 1.0, the
    given order; native extents from ``sizes``, else both flips mixed."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((b, 8), np.float32)
    rows[:, :3] = np.where(rng.rand(b, 3) > 0.5, 1.3, 0.7)
    rows[:, 3] = order
    rows[:, 4] = np.resize([0.1, 1.0], b)
    if sizes is None:
        rows[:, 5] = np.resize([1, 0, 1, 0], b)
        rows[:, 6] = np.resize([1, 1, 0, 0], b)
    else:
        sizes = np.asarray(sizes, np.float32)
        rows[:, 5:7] = sizes
        rows[:, 7] = sizes[:, 0] * sizes[:, 1]
    return torch.from_numpy(rows).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(NATIVE_CASES)))
@pytest.mark.parametrize("order", range(6))
def test_photometric_native_kernel_matches_plain_version(cuda, case, order):
    """Within 2e-6 inside each native extent and the same bits on a rerun;
    one call, one launch."""
    from gan_aug_pfa_torch.ops.kernels import photometric as ph

    b, hp, wp, sizes = NATIVE_CASES[case]
    x = torch.from_numpy(np.random.RandomState(order).rand(
        b, 3, hp, wp).astype(np.float32)).cuda()
    rows = _photometric_rows(b, order, sizes, seed=order)
    calls, launches = (ph.photometric_native_chw.calls,
                       ph.photometric_native_chw.launches)
    got = ph.photometric_native_chw(x, rows)
    torch.cuda.synchronize()
    assert (ph.photometric_native_chw.calls,
            ph.photometric_native_chw.launches) == (calls + 1, launches + 1)
    want = ph.photometric_native_reference(x, rows)
    again = ph.photometric_native_chw(x, rows)
    for i, (h, w) in enumerate(sizes):
        err = float((got[i, :, :h, :w] - want[i, :, :h, :w]).abs().max())
        assert err <= 2e-6, (i, err)
        assert torch.equal(got[i, :, :h, :w], again[i, :, :h, :w])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLIP_SHAPES)
@pytest.mark.parametrize("order", range(6))
def test_photometric_flip_kernel_matches_plain_version(cuda, shape, order):
    """Within 2e-6 everywhere, flips included, and the same bits on a
    rerun; one call, one launch."""
    from gan_aug_pfa_torch.ops.kernels import photometric as ph

    x = torch.from_numpy(np.random.RandomState(order).rand(
        *shape).astype(np.float32)).cuda()
    rows = _photometric_rows(shape[0], order, seed=order + 6)
    calls, launches = (ph.photometric_flip_chw.calls,
                       ph.photometric_flip_chw.launches)
    got = ph.photometric_flip_chw(x, rows)
    torch.cuda.synchronize()
    assert (ph.photometric_flip_chw.calls,
            ph.photometric_flip_chw.launches) == (calls + 1, launches + 1)
    want = ph.photometric_flip_reference(x, rows)
    assert float((got - want).abs().max()) <= 2e-6
    assert torch.equal(got, ph.photometric_flip_chw(x, rows))


@pytest.mark.cuda
def test_photometric_plans_schedule_on_the_card(cuda):
    """The main paths' plans and the streamed one fit the card: each holds
    at least one cluster at once (a cluster of 16 is non-portable)."""
    from gan_aug_pfa_torch.ops.kernels import photometric as ph

    for native, (b, hp, wp) in ((True, (4, 392, 400)),
                                (False, (4, 128, 128)),
                                (True, (16, 1024, 1024))):
        plan = ph.plan_launch(b, hp, wp)
        assert ph.active_clusters(native, b, hp, wp, plan) >= 1, plan


@pytest.mark.cuda
def test_photometric_kernel_refuses_a_plan_that_does_not_fit(cuda):
    """The C entry point checks the plan: too little shared memory for the
    band or the ring, too few rows to cover the image, too many threads, or
    a split the mode does not take is an error, not a fallback."""
    from gan_aug_pfa_torch.ops.kernels import photometric as ph

    native_fn, _, _ = ph._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    for hp, wp in ((64, 64), (1024, 1024)):
        x = torch.rand(2, 3, hp, wp, device="cuda")
        rows = _photometric_rows(2, 0, [[hp, wp], [hp - 4, wp // 2]])
        out = torch.empty_like(x)
        plan = ph.plan_launch(2, hp, wp)
        row_bytes = 3 * 4 * wp
        short = plan.smem_bytes - (16 if plan.mode == "resident"
                                   else row_bytes)
        split = 5 if plan.mode == "resident" else 2
        for bad in (dataclasses.replace(plan, smem_bytes=short),
                    dataclasses.replace(plan, band_rows=plan.band_rows - 1),
                    dataclasses.replace(plan, threads=1024),
                    dataclasses.replace(plan, split=split)):
            assert native_fn(x.data_ptr(), rows.data_ptr(), 2, hp, wp,
                             *bad.c_args(), out.data_ptr(), stream) != 0
        assert native_fn(x.data_ptr(), rows.data_ptr(), 2, hp, wp,
                         *plan.c_args(), out.data_ptr(), stream) == 0


@pytest.mark.cuda
def test_photometric_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from gan_aug_pfa_torch.ops.kernels import photometric as ph

    x = torch.rand(2, 3, 8, 8, device="cuda")
    rows = _photometric_rows(2, 0, [[8, 8], [8, 8]])
    for bad_x, bad_rows in ((x.double(), rows), (x.transpose(2, 3), rows),
                            (x, rows[:1]), (x, rows.cpu())):
        with pytest.raises((TypeError, ValueError)):
            ph.photometric_native_chw(bad_x, bad_rows)


@pytest.mark.cuda
def test_jax_written_generator_runs_on_the_card(cuda):
    """tests/data/jax_generator_nd5_ngf4.msgpack (tools/
    make_msgpack_fixture.py), read by the port's own decoder, runs on the
    card at fp32 with TF32 off within 1e-5 of the JAX output saved beside
    it."""
    import os

    from gan_aug_pfa_torch import checkpoint
    from gan_aug_pfa_torch.models import UNetGenerator
    from gan_aug_pfa_torch.train.siamese import tf32_off

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    model = checkpoint.restore_model_only(
        os.path.join(data, "jax_generator_nd5_ngf4.msgpack"),
        UNetGenerator(num_downs=5, ngf=4)).cuda().eval()
    expected = np.load(os.path.join(data,
                                    "jax_generator_nd5_ngf4_expected.npz"))
    x = torch.from_numpy(expected["x"]).cuda().permute(0, 3, 1, 2)
    with torch.no_grad(), tf32_off():
        y = model(x).permute(0, 2, 3, 1).cpu().numpy()
    np.testing.assert_allclose(y, expected["y"], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_jax_written_gan_state_resumes_on_the_card(cuda):
    """tests/data/jax_gan_state_nd5_ngf4/ (tools/make_gan_resume_fixture.py),
    the JAX resume pair, loaded on the card with its Adam state: one fp32
    D+G step (TF32 off) gives the JAX losses saved beside it within 1e-5
    relative."""
    import os

    from gan_aug_pfa_torch import checkpoint
    from gan_aug_pfa_torch.config import GANTrainConfig
    from gan_aug_pfa_torch.train.gan import GANTrainer

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    pair = os.path.join(data, "jax_gan_state_nd5_ngf4")
    trainer = GANTrainer(GANTrainConfig(
        num_downs=5, ngf=4, ndf=8, n_layers=2, target_size=(32, 32),
        compute_dtype="float32", ema_decay=0.9), "cuda")
    assert checkpoint.restore_gan_state_from_jax(
        os.path.join(pair, "last_generator.msgpack"), trainer.generator,
        trainer.opt_g, trainer.ema) == 1
    checkpoint.restore_gan_state_from_jax(
        os.path.join(pair, "last_discriminator.msgpack"),
        trainer.discriminator, trainer.opt_d)
    expected = np.load(pair + "_expected.npz")
    a, b = (torch.from_numpy(expected[k]).cuda().permute(0, 3, 1, 2)
            for k in ("a", "b"))
    loss_d, loss_g = trainer.train_batch(a, b)
    assert float(loss_d) == pytest.approx(float(expected["loss_d"]),
                                          rel=1e-5)
    assert float(loss_g) == pytest.approx(float(expected["loss_g"]),
                                          rel=1e-5)


@pytest.mark.cuda
def test_batch_put_stages_rows_on_a_copy_stream(cuda):
    """``data.stream.BatchPut`` on the card: pinned host memory, a copy
    stream of its own, the consumer's stream made to wait: the rows equal
    the host arrays laid out as the device cache's, also when the consumer
    is a side stream and the next batches are put before it reads."""
    from gan_aug_pfa_torch.data.stream import BatchPut

    rng = np.random.RandomState(0)
    put = BatchPut("cuda")
    hosts = [(rng.rand(4, 64, 48, 3).astype(np.float32),
              rng.rand(4, 64, 48, 3).astype(np.float32),
              (rng.rand(4, 64, 48) > 0.5).astype(np.int32))
             for _ in range(3)]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        staged = [put(h) for h in hosts]
        got = [[t.clone() for t in s.get()] for s in staged]
    torch.cuda.synchronize()
    for (img1, img2, labels), (g1, g2, gl) in zip(hosts, got):
        assert g1.is_contiguous() and gl.dtype == torch.float32
        assert torch.equal(g1.cpu(), torch.from_numpy(img1).permute(
            0, 3, 1, 2))
        assert torch.equal(g2.cpu(), torch.from_numpy(img2).permute(
            0, 3, 1, 2))
        assert torch.equal(gl.cpu(), torch.from_numpy(labels).float())
    pinned = put.pin(hosts[0])
    assert all(t.is_pinned() for t in pinned.tensors)
    assert BatchPut("cuda", labels=False)(hosts[0]).get()[2] is None


def _model_axis_rank(out_dir):
    """One of two gloo ranks sharing the card, a (data 1, model 2) mesh:
    a wide conv and conv-transpose sharded by the rule against the same
    modules whole, forward and backward at float32 and under bf16
    autocast (cuDNN deterministic: the same algorithm on the same
    inputs); the largest differences into ``out_dir/rank<R>.pt``."""
    import copy
    import os

    from gan_aug_pfa_torch.parallel import mesh as pm
    from gan_aug_pfa_torch.parallel import tensor as tp

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = pm.make_mesh(2, ("data", "model"), (1, 2), device="cuda")
    torch.manual_seed(0)
    whole = torch.nn.Sequential(
        torch.nn.Conv2d(64, 512, 3, padding=1),
        torch.nn.ConvTranspose2d(512, 256, 4, stride=2, padding=1)).cuda()
    sharded = tp.shard_model(copy.deepcopy(whole), mesh)
    assert [type(m).__name__ for m in sharded] == [
        "ShardedConv2d", "ShardedConvTranspose2d"]
    assert sharded[1].weight.shape == (512, 128, 4, 4)
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.randn(2, 64, 16, 16, device="cuda", generator=gen)
    g = torch.randn(2, 256, 32, 32, device="cuda", generator=gen)
    diffs = {}
    for mode in ("float32", "bfloat16"):
        runs = []
        for model in (whole, sharded):
            model.zero_grad(set_to_none=True)
            xi = x.clone().requires_grad_()
            with torch.autocast("cuda", torch.bfloat16,
                                enabled=mode == "bfloat16"):
                y = model(xi)
            (y.float() * g).sum().backward()
            runs.append((y.detach(), xi.grad,
                         [p.grad for p in model.parameters()]))
        (yw, gxw, gw), (ys, gxs, gs) = runs
        blocks = [tp.own_block(m, n, p) for (m, n), p in zip(
            [(m, n) for m in sharded for n, _ in m.named_parameters()], gw)]
        diffs[mode] = [float((ys.float() - yw.float()).abs().max()),
                       float((gxs - gxw).abs().max())] + [
            float((a - b).abs().max()) for a, b in zip(gs, blocks)]
    torch.save(diffs, os.path.join(out_dir, f"rank{mesh.model_rank}.pt"))
    return 0


def _spatial_axis_rank(out_dir):
    """One of two gloo ranks sharing the card, a (data 1, spatial 2) mesh:
    ``halo``, ``gather_rows`` and ``split_rows`` on CUDA tensors, and a
    3x3 conv, a 4x4 stride-2 conv, a conv-transpose and the upsample on
    height blocks against the whole ops, forward and backward at float64
    (cuDNN deterministic); the largest differences, each relative to the
    whole op's largest value, into ``out_dir/rank<R>.pt``."""
    import os

    import torch.nn.functional as F

    from gan_aug_pfa_torch.parallel import mesh as pm
    from gan_aug_pfa_torch.parallel import spatial as sp

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = pm.make_mesh(2, ("data", "spatial"), (1, 2), device="cuda")
    split = mesh.split(True)
    k = split.rank

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.randn(2, 8, 16, 12, device="cuda", dtype=torch.float64,
                    generator=gen)
    diffs = {}
    with sp.splitting(split):
        xb = split.block(x, 2).clone().requires_grad_()
        halo = sp.halo(xb, 1, 1)
        want = F.pad(x, (0, 0, 1, 1))[:, :, 8 * k:8 * k + 10]
        halo.sum().backward()
        rows = torch.ones_like(xb)  # each row read once, edges twice
        rows[:, :, 0] += k > 0
        rows[:, :, -1] += k < 1
        diffs["halo"] = [rel(halo, want), rel(xb.grad, rows)]
        xb = split.block(x, 2).clone().requires_grad_()
        whole = sp.gather_rows(xb)
        (whole * (k + 1)).sum().backward()  # the ranks' seeds sum to 3
        cut = sp.split_rows(x)
        diffs["gather_split"] = [rel(whole, x),
                                 rel(xb.grad, torch.full_like(xb, 3.0)),
                                 rel(cut, split.block(x, 2))]
        torch.manual_seed(0)
        for name, module in (
                ("conv3x3", torch.nn.Conv2d(8, 16, 3, padding=1)),
                ("conv4x4s2", torch.nn.Conv2d(8, 16, 4, stride=2, padding=1)),
                ("convT4x4s2", torch.nn.ConvTranspose2d(8, 16, 4, stride=2,
                                                        padding=1)),
                ("upsample", None)):
            xw = x.clone().requires_grad_()
            if module is None:
                yw = F.interpolate(xw, scale_factor=2, mode="bilinear",
                                   align_corners=True)
            else:
                module = module.to("cuda", torch.float64)
                yw = module(xw)
            g = torch.randn(yw.shape, device="cuda", dtype=torch.float64,
                            generator=gen)
            (yw * g).sum().backward()
            wgrads = ([] if module is None
                      else [p.grad.clone() for p in module.parameters()])
            if module is not None:
                module.zero_grad()
            xb = split.block(x, 2).clone().requires_grad_()
            y = (sp.upsample2x(xb, 16) if module is None
                 else sp.conv(module, xb, 16)[0])
            (y * split.block(g, 2)).sum().backward()
            grads = ([] if module is None
                     else [p.grad.clone() for p in module.parameters()])
            for t in grads:
                torch.distributed.all_reduce(t, group=split.group)
            diffs[name] = [rel(y, split.block(yw, 2)),
                           rel(xb.grad, split.block(xw.grad, 2))] + [
                rel(a, b) for a, b in zip(grads, wgrads)]
    torch.save(diffs, os.path.join(out_dir, f"rank{k}.pt"))
    return 0


@pytest.mark.cuda
def test_spatial_axis_exchanges_on_two_ranks(cuda, tmp_path):
    """``parallel/spatial.py`` on the card: two gloo ranks exchange halo
    rows and gather and split height blocks with all-reduces of CUDA
    tensors; the block convs and the block-local upsample equal the whole
    ops within 1e-12 of their largest values at float64 (each rank's
    weight gradients summed)."""
    from gan_aug_pfa_torch.parallel import mesh as pm

    pm.spawn(_spatial_axis_rank, (str(tmp_path),), 2, device="cuda")
    for rank in range(2):
        diffs = torch.load(tmp_path / f"rank{rank}.pt")
        for name, d in diffs.items():
            assert max(d) <= 1e-12, (rank, name, d)


@pytest.mark.cuda
def test_model_axis_gather_equals_the_whole_conv_on_two_ranks(cuda,
                                                              tmp_path):
    """``parallel/tensor.py`` on the card: two gloo ranks (NCCL refuses two
    ranks on one card) gather a conv's and a conv-transpose's shards with
    an all-reduce of CUDA tensors; outputs, input gradients and each
    rank's weight and bias gradient blocks equal the whole modules'."""
    from gan_aug_pfa_torch.parallel import mesh as pm

    pm.spawn(_model_axis_rank, (str(tmp_path),), 2, device="cuda")
    for rank in range(2):
        diffs = torch.load(tmp_path / f"rank{rank}.pt")
        for mode, d in diffs.items():
            assert d == [0.0] * len(d), (rank, mode, d)
