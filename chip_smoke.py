#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``gan_aug_pfa_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. print the card (``nvidia-smi`` name and power limit);
2. build every CUDA kernel of the evaluation and training paths from
   ``csrc/`` with nvcc, one process per source, all at once;
3. hold each kernel against its plain PyTorch version on the card (exact
   integer equality for the confusion counts; the fused FocalDice loss
   within the JAX package's fused-loss tolerances, forward and backward,
   float32 and bf16 logits, aligned and misaligned views, equal bits on a
   rerun and in a CUDA graph's replay, no cast kernel around a bf16 loss)
   and time kernel (back to back and inside a CUDA graph), wrapper, plain
   version and one PyTorch call with CUDA events;
4. run the full-width SiameseUNet forward (fp32, TF32 off) on the card and
   on the CPU and compare the probabilities;
5. drive the evaluation path, ``python -m gan_aug_pfa_torch.evaluate`` at
   its defaults (128x128, batch 2, bf16), in this process over a generated
   14-city OSCD tree and a seeded checkpoint, with the kernel launch counts
   set to 0 just before and read just after; check the report; compare the
   slice's counts at fp32 on the card with the CPU's; time evaluation
   throughput at batch 2 and 16;
6. drive the training path, ``python -m gan_aug_pfa_torch.train`` at its
   defaults (128x128, batch 4, bf16) for 4 epochs over a generated tree,
   with the fused-loss (calls, launches) set to 0 just before and read just
   after (one launch a call); check the losses and checkpoints, resume for
   one epoch, evaluate
   the trained ``best_model.pth``; compare 3 fp32 train steps on the card
   with the CPU's; time training throughput at batch 4 and 16 and profile
   one epoch;
7. drive the augmented training path, ``python -m gan_aug_pfa_torch.train
   --augment`` (native resolution, padded to the train split's largest
   extent, resized to 128x128) for 4 epochs, then one epoch of ``--augment
   --no-native-aug``, with the photometric and fused-loss counts set to 0
   just before each and read just after (one launch a photometric call);
   compare the augmented batch of each chain and its first fp32 train step
   on the card with the CPU's; time augmented training at batch 4 and
   profile one epoch;
8. hold both photometric kernels against their plain versions on the card
   (six jitter orders, both sigma edges, ragged native extents, extents of
   1 and 2, unaligned rows, every plan: resident, resident split over
   several clusters an image, streamed) and time them at the main
   paths' shapes and at 16x3x1024x1024, back to back and inside a CUDA
   graph (device time alone), beside a ``torch.mul`` of the same bytes.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero.
"""

import dataclasses
import functools
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

SEED = 0
CITIES = [
    "abudhabi", "aguasclaras", "beihai", "beirut", "bercy", "bordeaux",
    "cupertino", "hongkong", "mumbai", "nantes", "paris", "pisa", "rennes",
    "saclay_e",
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
# Special-function results (exp2, log2, reciprocal): 16 per clock per SM
# for compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the 1,980 MHz boost clock.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
MODEL_PROB_TOL = 1e-4  # fp32 probabilities, card (cuDNN) vs CPU
PASSES = 5  # timed evaluation and training passes per batch size

# The tuned FocalDice constants (SiameseTrainConfig) and both gammas the
# JAX package's tests cover: the tuned one and the u^0 edge at 1.0.
LOSS_KW = {"beta": 0.6699803915247974, "focal_alpha": 0.6030489822904476,
           "dice_smooth": 1.956571276926647e-06}
GAMMAS = (1.7930869982898021, 1.0)
TRAIN_SHAPE = (4, 1, 128, 128)  # the train step's logits at the defaults
LOSS_CASES = [((1, 1, 7, 9), False), (TRAIN_SHAPE, False),
              ((3, 1, 37, 53), True), ((4, 1, 512, 512), False),
              ((16, 1, 1024, 1024), False)]
BIG_LOSS_SHAPE = (16, 1, 1024, 1024)
LOSS_DTYPES = ("float32", "bfloat16")  # the logits'; targets are float32
# Special-function results an element the function needs: exp(-|x|), one
# reciprocal (sigmoid, and 1 - sigmoid), log2(1 + exp(-|x|)) (softplus),
# exp(-bce) (pt), log2(u) and exp2 for u^gamma; the backward one exp2 more
# for u^(gamma-1) from the same log2(u).
FWD_SFU_OPS, BWD_SFU_OPS = 6, 7
# Card vs CPU, 3 fp32 train steps from one init: the first step's loss
# differs only by the forward's rounding; later ones also by Adam's
# updates of parameters whose gradient is rounding noise (up to lr each).
TRAIN_STEP1_RTOL, TRAIN_STEP_RTOL = 1e-5, 1e-3
# The photometric kernels vs their plain versions: the contrast mean is
# summed in another order and nvcc fuses multiply-adds.
PHOTOMETRIC_ATOL = 2e-6
# The augmented batch, card vs CPU: the geometric stages compute the same
# coordinates on both (separate IEEE operations, trig in float64), so the
# images differ by the photometric kernels' rounding, and labels by a
# nearest sample that a coordinate rounding moves, at most 0.1%.
CHAIN_ATOL, LABEL_MISMATCH_SHARE = 1e-4, 1e-3


def write_png(path, arr):
    """Write an 8-bit gray (H, W) or RGB (H, W, 3) PNG with the standard
    library's zlib.  Row y uses filter y % 5, so every filter type
    appears."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * bpp).astype(np.int16)
    prev = np.zeros_like(rows)
    prev[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    p = left + prev - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, prev, upleft))
    preds = [np.zeros_like(rows), left, prev, (left + prev) >> 1, paeth]
    ftype = np.arange(h) % 5
    pred = np.choose(ftype[:, None], preds)
    body = ((rows - pred) & 0xFF).astype(np.uint8)
    raw = np.concatenate([ftype[:, None].astype(np.uint8), body], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    color_type = 0 if bpp == 1 else 2
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_oscd_tree(root, seed=SEED):
    """The 14 OSCD cities: seeded RGB pairs of a few hundred pixels a side
    and binary change maps, in the OSCD directory layout."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "Onera Satellite Change Detection Dataset")
    images = os.path.join(
        base, "images", "Onera Satellite Change Detection dataset - Images")
    labels = os.path.join(
        base, "train_labels",
        "Onera Satellite Change Detection dataset - Train Labels")
    for city in CITIES:
        h, w = rng.randint(200, 400, size=2)
        pair = os.path.join(images, city, "pair")
        cm = os.path.join(labels, city, "cm")
        os.makedirs(pair)
        os.makedirs(cm)
        for name in ("img1.png", "img2.png"):
            write_png(os.path.join(pair, name),
                      rng.randint(0, 256, (h, w, 3)))
        write_png(os.path.join(cm, "cm.png"),
                  (rng.rand(h, w) > 0.8).astype(np.uint8) * 255)


def seeded_model(torch, SiameseUNet, seed=SEED):
    """The full-width SiameseUNet from a seed, with random BatchNorm
    running statistics.  At init every probability lies within about 0.003
    of 0.5; the head's weight is scaled by 300 to spread the logits over a
    few units, as a trained model's are, and its bias centres them on
    seeded random images."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed)
    model = SiameseUNet().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        model.conv_last.weight.mul_(300.0)
        calib = torch.rand((2, 2, 3, 128, 128), generator=gen) * 2 - 1
        model.conv_last.bias.sub_(model(calib[0], calib[1]).median())
    return model


def time_ms(torch, fn, iters=200, warmup=20):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def confusion_inputs(torch, shape, threshold, gen, misaligned=False):
    b = shape[0] + (1 if misaligned else 0)
    p = torch.rand((b, *shape[1:]), generator=gen, device="cuda")
    p.view(-1)[::7] = threshold  # at the threshold: negative (strict >)
    t = (torch.rand((b, *shape[1:]), generator=gen, device="cuda")
         > 0.6).float()
    t[0] = 1.0
    if b > 1:
        t[-1] = 0.0
    if misaligned:  # a view whose data pointer is not 16-byte aligned
        p, t = p[1:], t[1:]
    return p, t


def phase_kernel(torch, cc):
    """Kernel vs plain version on the card, exact; timings at the eval
    shape and at a large shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [((2, 128, 128), False), ((1, 37, 53), False),
             ((1, 37, 53), True), ((3, 1, 1), False),
             ((16, 1024, 1024), False)]
    max_err = 0.0
    for shape, misaligned in cases:
        for thr in (0.5, 0.3):
            p, t = confusion_inputs(torch, shape, thr, gen, misaligned)
            if misaligned and p.data_ptr() % 16 == 0:
                raise AssertionError("misaligned case is 16-byte aligned")
            got = cc.confusion_counts_batch(p, t, thr)
            torch.cuda.synchronize()
            ref = cc.confusion_counts_batch_reference(p, t, thr)
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            hw = shape[1] * shape[2]
            ok = torch.equal(got, ref) and bool(
                (got.sum(dim=1) == hw).all())
            print(f"kernel {shape} thr={thr} misaligned={misaligned}: "
                  f"max_abs_err={err} {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(
                    f"confusion_counts kernel != plain version at {shape}, "
                    f"thr={thr}:\n{got}\n{ref}")

    timings = {}
    for shape in ((2, 128, 128), (16, 1024, 1024)):
        p, t = confusion_inputs(torch, shape, 0.5, gen)
        b, hw = shape[0], shape[1] * shape[2]
        fn = cc._kernel()
        counts = torch.zeros((b, 3), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def kernel_only():
            fn(p.data_ptr(), t.data_ptr(), 0.5, b, hw, counts.data_ptr(),
               stream)

        codes = ((p > 0.5).float() * 2 + (t > 0.5).float()
                 + 4 * torch.arange(b, device="cuda").view(-1, 1, 1)
                 ).view(-1)
        lib = torch.histc(codes, bins=4 * b, min=0, max=4 * b).view(b, 4)
        ref = cc.confusion_counts_batch_reference(p, t, 0.5)
        # histc bins: code 0 = tn, 1 = fn, 2 = fp, 3 = tp.
        if not torch.equal(lib[:, [3, 2, 1, 0]], ref):
            raise AssertionError("library call disagrees with the counts")
        read, written = 8 * b * hw, 12 * b
        bytes_ms = (read + written) / HBM_BYTES_PER_S * 1e3
        ops_ms = 6 * b * hw / FP32_OPS_PER_S * 1e3
        timings[shape] = {
            "ms": time_ms(torch, kernel_only),
            "graph_ms": graph_ms(torch, lambda: fn(
                p.data_ptr(), t.data_ptr(), 0.5, b, hw, counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)),
            "wrapper_ms": time_ms(
                torch, lambda: cc.confusion_counts_batch(p, t, 0.5)),
            "plain_ms": time_ms(
                torch, lambda: cc.confusion_counts_batch_reference(p, t, 0.5)),
            "library_ms": time_ms(
                torch, lambda: torch.histc(codes, bins=4 * b, min=0,
                                           max=4 * b)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": read + written,
        }
        print(f"kernel timing {shape}: {json.dumps(timings[shape])}")
    return max_err, timings


def loss_inputs(torch, shape, gen, misaligned=False, dtype="float32"):
    """Logits (B, 1, H, W) of ``dtype`` with saturated entries of +-1e4 and
    float32 binary targets (B, H, W), as the train step passes them;
    ``misaligned`` gives views one element past a 16-byte boundary (4 bytes
    for float32 logits and the targets, 2 for bfloat16 logits)."""
    n = int(np.prod(shape))
    extra = 1 if misaligned else 0
    x = torch.randn(n + extra, generator=gen, device="cuda") * 4
    x[::101] = 1e4
    x[50::101] = -1e4
    x = x.to(getattr(torch, dtype))
    t = (torch.rand(n + extra, generator=gen, device="cuda") > 0.7).float()
    if misaligned:
        x, t = x[1:], t[1:]
    b, _, h, w = shape
    return x.view(shape), t.view(b, h, w)


def loss_errors(torch, fl, xf, tf, gamma, loss, dx, g):
    """Kernel results against the plain version on the same values, at the
    tolerances of tests/test_pallas.py: the loss within 1e-6 relative, dx
    within 1e-5 of max|dx| (1e-3 from 2^20 elements on, where dx is
    O(1e-7) and the sums' rounding shows), plus one bf16 rounding step of
    each value where dx is bf16 (both sides round their float32 dx to
    nearest even).  Returns |dloss|, max|ddx|, the part of |ddx| above the
    rounding step, the dx tolerance, the plain loss and whether all
    hold."""
    beta, alpha, smooth = (LOSS_KW["beta"], LOSS_KW["focal_alpha"],
                           LOSS_KW["dice_smooth"])
    n = xf.numel()
    ref_sums = fl.focal_dice_sums_reference(xf, tf, gamma, alpha)
    ref_loss = float(fl._finalize(ref_sums, n, beta, smooth))
    want = fl.focal_dice_grad_reference(xf, tf, ref_sums, g, beta, gamma,
                                        alpha, smooth).float()
    diff = (dx.float() - want).abs()
    step = 2 ** -7 * want.abs() if xf.dtype == torch.bfloat16 else 0.0
    excess = float((diff - step).max())
    tol = (1e-3 if n >= 1 << 20 else 1e-5) * float(want.abs().max())
    dloss = abs(float(loss) - ref_loss)
    ok = (np.isfinite(float(loss)) and bool(dx.isfinite().all())
          and dx.dtype == xf.dtype and dloss < 1e-6 * max(1.0, abs(ref_loss))
          and excess <= tol)
    return dloss, float(diff.max()), excess, tol, ref_loss, ok


def phase_loss_kernel(torch, fl):
    """Fused FocalDice kernels vs the plain version on the card, forward
    and backward (``loss_errors``), at every LOSS_CASES shape, both gammas,
    float32 and bfloat16 logits, aligned and misaligned views; each
    forward and backward run twice must give the same bits, and so must a
    CUDA graph's replays.  Then the wrapper under autograd, the launches of
    a bf16 loss under autocast (the two kernels and no cast), and the
    timings."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    beta, alpha, smooth = (LOSS_KW["beta"], LOSS_KW["focal_alpha"],
                           LOSS_KW["dice_smooth"])
    g = torch.tensor(0.73, device="cuda")
    errs = {(k, d): 0.0 for k in ("fwd", "bwd") for d in LOSS_DTYPES}
    for shape, misaligned in LOSS_CASES:
        for dtype in LOSS_DTYPES:
            for gamma in GAMMAS:
                x, t = loss_inputs(torch, shape, gen, misaligned, dtype)
                xf, tf = x.reshape(-1), t.reshape(-1)
                if misaligned and xf.data_ptr() % 16 == 0:
                    raise AssertionError("misaligned case is 16-byte aligned")
                hyper = (beta, gamma, alpha, smooth)
                loss, sums = fl.launch_forward(xf, tf, *hyper)
                dx = fl.launch_backward(xf, tf, sums, g, *hyper)
                loss2, sums2 = fl.launch_forward(xf, tf, *hyper)
                dx2 = fl.launch_backward(xf, tf, sums2, g, *hyper)
                torch.cuda.synchronize()
                dloss, ddx, excess, tol, ref_loss, ok = loss_errors(
                    torch, fl, xf, tf, gamma, loss, dx, g)
                errs["fwd", dtype] = max(errs["fwd", dtype], dloss)
                errs["bwd", dtype] = max(errs["bwd", dtype], ddx)
                ok = (ok and torch.equal(loss, loss2)
                      and torch.equal(sums, sums2) and torch.equal(dx, dx2))
                print(f"loss kernel {shape} {dtype} gamma={gamma:.4f} "
                      f"misaligned={misaligned} plan {fl.plan_for(xf, tf)}: "
                      f"loss {float(loss):.7f} vs {ref_loss:.7f} (|d| "
                      f"{dloss:.2e}), max|ddx| {ddx:.2e}, beyond a bf16 "
                      f"step {excess:.2e} (tol {tol:.2e}) "
                      f"{'OK' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(
                        f"fused loss kernels != plain version at {shape}, "
                        f"{dtype}, gamma={gamma}")

    # Forward and backward captured in one CUDA graph: each replay gives
    # the eager bits.
    for dtype in LOSS_DTYPES:
        x, t = loss_inputs(torch, TRAIN_SHAPE, gen, dtype=dtype)
        xf, tf = x.reshape(-1), t.reshape(-1)
        hyper = (beta, GAMMAS[0], alpha, smooth)
        loss, sums = fl.launch_forward(xf, tf, *hyper)
        dx = fl.launch_backward(xf, tf, sums, g, *hyper)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gl, gs = fl.launch_forward(xf, tf, *hyper)
            gdx = fl.launch_backward(xf, tf, gs, g, *hyper)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            if not (torch.equal(gl, loss) and torch.equal(gs, sums)
                    and torch.equal(gdx, dx)):
                raise AssertionError(f"graph replay != eager ({dtype})")
        print(f"loss kernels in a CUDA graph ({dtype}): replays equal eager")

    # The wrapper under autograd, at the train shape: dx through
    # FocalDiceLossFn equals the plain Function's.
    x, t = loss_inputs(torch, TRAIN_SHAPE, gen)
    xk = x.detach().clone().requires_grad_()
    fl.focal_dice_loss_fused(xk, t, focal_gamma=GAMMAS[0], **LOSS_KW
                             ).backward()
    xp = x.detach().reshape(-1).clone().requires_grad_()
    fl.FocalDiceLossReferenceFn.apply(xp, t.reshape(-1), beta, GAMMAS[0],
                                      alpha, smooth).backward()
    d = float((xk.grad.reshape(-1) - xp.grad).abs().max())
    if not d <= 1e-5 * float(xp.grad.abs().max()):
        raise AssertionError(f"wrapper gradient differs from plain: {d}")
    print(f"loss wrapper under autograd vs plain: max|ddx| = {d:.2e}")
    check_no_cast(torch, fl, gen)

    timings = {(shape, dtype): loss_timings(torch, fl, shape, dtype, gen)
               for shape in (TRAIN_SHAPE, BIG_LOSS_SHAPE)
               for dtype in LOSS_DTYPES}
    return errs, timings


def check_no_cast(torch, fl, gen):
    """bf16 logits under bf16 autocast, as the train step passes them: the
    loss forward and backward are the two kernels, one launch each, and no
    other kernel (no cast of the logits before, none of dx after)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, t = loss_inputs(torch, TRAIN_SHAPE, gen, dtype="bfloat16")
    xb = x.detach().requires_grad_()
    g = torch.ones((), device="cuda")
    fl.focal_dice_loss_fused(xb, t, **LOSS_KW).backward(g)
    xb.grad = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = fl.focal_dice_loss_fused(xb, t, **LOSS_KW)
        loss.backward(g)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    print(f"bf16 loss forward + backward under autocast: {kernels}")
    if len(kernels) != 2 or not all("focal_dice" in k and c == 1
                                    for k, c in kernels.items()):
        raise AssertionError(f"bf16 loss launched {kernels}")
    if xb.grad.dtype != torch.bfloat16:
        raise AssertionError(f"dx came back as {xb.grad.dtype}")


def loss_bound(n, x_bytes, backward):
    """Least time (ms) of one kernel call over n elements: logits of
    ``x_bytes`` and float32 targets read once, bf16 or float32 dx written
    once (backward), the 5 floats out (forward) or the sums and gradient
    in; against FWD_SFU_OPS / BWD_SFU_OPS special-function results an
    element at SFU_OPS_PER_S."""
    nbytes = n * (x_bytes + 4 + (x_bytes if backward else 0)) + 20
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    sfu = BWD_SFU_OPS if backward else FWD_SFU_OPS
    ops_ms = sfu * n / SFU_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "sfu_ms": ops_ms}


def loss_calls(torch, fl, xf, tf, kernels=None, plan=None):
    """The bare C forward and backward of csrc/focal_dice_loss.cu
    (``kernels`` = (fwd, bwd), this tree's by default) on flat CUDA inputs
    and fixed buffers, with ``plan`` (the wrapper's by default) and the
    tuned gamma: (fwd(stream), bwd(stream), the 5-float output, dx, the
    upstream gradient)."""
    hyper = (LOSS_KW["beta"], GAMMAS[0], LOSS_KW["focal_alpha"],
             LOSS_KW["dice_smooth"])
    fwd, bwd = kernels or fl._kernels()
    n = xf.numel()
    plan = (plan or fl.plan_for(xf, tf)).c_args()
    args = (xf.data_ptr(), int(xf.dtype == torch.bfloat16), tf.data_ptr())
    out = torch.empty(5, device="cuda")
    ws = torch.zeros(fl.WORKSPACE_FLOATS, device="cuda")
    dx = torch.empty_like(xf)
    g = torch.full((), 0.73, device="cuda")

    def fwd_on(stream):
        return fwd(*args, n, *plan, *hyper, out.data_ptr(), ws.data_ptr(),
                   stream)

    def bwd_on(stream):
        return bwd(*args, out.data_ptr() + 4, g.data_ptr(), n, *plan,
                   *hyper, dx.data_ptr(), stream)

    return fwd_on, bwd_on, out, dx, g


def loss_timings(torch, fl, shape, dtype, gen):
    """Kernel alone (the bare C calls, back to back and in a CUDA graph),
    wrapper, plain version and one PyTorch call reading about the same
    bytes (a yardstick: no single PyTorch call computes this function),
    forward and backward."""
    import torch.nn.functional as F

    x, t = loss_inputs(torch, shape, gen, dtype=dtype)
    xf, tf = x.reshape(-1), t.reshape(-1)
    n = xf.numel()
    hyper = (LOSS_KW["beta"], GAMMAS[0], LOSS_KW["focal_alpha"],
             LOSS_KW["dice_smooth"])
    fwd_on, bwd_on, out, _, g = loss_calls(torch, fl, xf, tf)
    t_same = tf.to(xf.dtype)
    lib_out = torch.empty(n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if fwd_on(stream) != 0 or bwd_on(stream) != 0:
        raise AssertionError("fused loss kernel launch failed")
    sums = out[1:]
    kw = dict(focal_gamma=GAMMAS[0], **LOSS_KW)
    result = {}
    for name, c_fn, wrapper, plain, library in (
        ("fwd", fwd_on,
         lambda: fl.focal_dice_loss_fused(x, t, **kw),
         lambda: fl.FocalDiceLossReferenceFn.apply(xf, tf, *hyper),
         lambda: F.binary_cross_entropy_with_logits(xf, t_same,
                                                    reduction="sum")),
        ("bwd", bwd_on,
         lambda: fl.launch_backward(xf, tf, sums, g, *hyper),
         lambda: fl.focal_dice_grad_reference(xf, tf, sums, g, *hyper),
         lambda: torch.mul(xf, tf, out=lib_out)),
    ):
        r = loss_bound(n, xf.element_size(), name == "bwd")
        r.update({
            "ms": time_ms(torch, functools.partial(c_fn, stream)),
            "graph_ms": graph_ms(torch, lambda c_fn=c_fn: c_fn(
                torch.cuda.current_stream().cuda_stream)),
            "wrapper_ms": time_ms(torch, wrapper),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            "library_graph_ms": graph_ms(torch, library),
            "plan": list(fl.plan_for(xf, tf).c_args()),
        })
        result[name] = r
        print(f"loss kernel timing {name} {shape} {dtype}: {json.dumps(r)}")
    return result


def photometric_bound(extents, native):
    """Least time (ms) of one photometric call on images whose work covers
    ``extents`` (h, w) each: three float32 channels read and written once
    in each extent (the native kernel leaves the padded tail alone), plus
    one (8,) float32 parameter row an image.  fp32 operations a pixel and
    channel: brightness 3, contrast 6 and saturation 6 (gray, blend,
    clip), the separable blur 10; the native kernel's mask and dynamic
    edge 5 more."""
    pixels = sum(h * w for h, w in extents)
    nbytes = 24 * pixels + 32 * len(extents)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (30 if native else 25) * 3 * pixels / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops_ms": ops_ms}


def photometric_rows(torch, b, order, extents=None, sigma_first=0.1,
                     seed=SEED):
    """(B, 8) rows: factors of 0.7 or 1.3 (the clips engage), the given
    order, sigma alternating 0.1 / 1.0 from ``sigma_first``; native
    extents, else the four flip combinations in turn."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((b, 8), np.float32)
    rows[:, :3] = np.where(rng.rand(b, 3) > 0.5, 1.3, 0.7)
    rows[:, 3] = order
    rows[:, 4] = np.resize([sigma_first, 1.1 - sigma_first], b)
    if extents is None:
        rows[:, 5] = np.resize([1, 0, 1, 0], b)
        rows[:, 6] = np.resize([1, 1, 0, 0], b)
    else:
        ext = np.asarray(extents, np.float32)
        rows[:, 5:7] = ext
        rows[:, 7] = ext[:, 0] * ext[:, 1]
    return torch.from_numpy(rows).cuda()


def graph_ms(torch, fn, calls=20, replays=10):
    """Mean device time of ``fn`` with no host time between calls: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


# The photometric correctness cases: the main paths' shapes, ragged native
# extents, extents of 1 and 2 rows or columns, rows that are not 16-byte
# aligned, batches of 1 and 3, whose images the resident plan splits over
# several clusters, and 1024x1024 and 700x1023 images, which take the
# streamed plan (bands of a few rows among them, which fit the ring whole).
PHOTOMETRIC_CASES = [
    ("native", (4, 3, 400, 400), [[201, 397], [400, 400], [256, 130],
                                  [399, 200]]),
    ("native", (3, 3, 392, 400), [[392, 400], [1, 2], [255, 203]]),
    ("native", (1, 3, 392, 400), [[392, 400]]),
    ("native", (4, 3, 8, 8), [[1, 1], [2, 2], [1, 8], [8, 2]]),
    ("native", (2, 3, 1024, 1024), [[1024, 1024], [777, 1001]]),
    ("native", (4, 3, 1024, 1024), [[1, 1], [2, 1024], [40, 1000],
                                    [100, 3]]),
    ("native", (2, 3, 700, 1023), [[700, 1023], [699, 517]]),
    ("flip", (4, 3, 128, 128), None),
    ("flip", (3, 3, 37, 53), None),
    ("flip", (3, 3, 128, 128), None),
    ("flip", (2, 3, 1024, 1024), None),
    ("flip", (2, 3, 700, 1023), None),
]


def phase_photometric(torch, ph, native_shape, native_extents):
    """Both photometric kernels vs their plain versions on the card,
    within PHOTOMETRIC_ATOL inside each native extent, over the six jitter
    orders and both sigma edges, in every plan (resident, split, streamed);
    equal bits on a rerun.  Then timings of kernel, wrapper, plain version
    and a yardstick at the main paths' shapes and at 16x3x1024x1024, each
    with its launch plan."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    errs = {"native": 0.0, "flip": 0.0}
    modes = set()
    for kind, shape, extents in [("native", native_shape, native_extents),
                                 *PHOTOMETRIC_CASES]:
        extents = ([[min(h, shape[2]), min(w, shape[3])] for h, w in extents]
                   if extents else [[shape[2], shape[3]]] * shape[0])
        fn, ref = ((ph.photometric_native_chw, ph.photometric_native_reference)
                   if kind == "native" else
                   (ph.photometric_flip_chw, ph.photometric_flip_reference))
        plan = ph.plan_launch(shape[0], *shape[2:])
        modes.add(plan.mode + (" split" if plan.split > 1 else ""))
        x = torch.rand(shape, generator=gen, device="cuda")
        worst = 0.0
        for order in range(6):
            for sigma_first in (0.1, 1.0):
                rows = photometric_rows(
                    torch, shape[0], order,
                    extents if kind == "native" else None, sigma_first,
                    seed=order)
                got, again = fn(x, rows), fn(x, rows)
                torch.cuda.synchronize()
                want = ref(x, rows)
                for i, (h, w) in enumerate(extents):
                    worst = max(worst, float(
                        (got[i, :, :h, :w] - want[i, :, :h, :w]).abs().max()))
                    if not torch.equal(got[i, :, :h, :w],
                                       again[i, :, :h, :w]):
                        raise AssertionError(f"{kind} {shape}: rerun differs")
        errs[kind] = max(errs[kind], worst)
        print(f"photometric {kind} kernel {shape} ({plan.mode}) extents "
              f"{extents}: max_abs_err={worst} over 6 orders x 2 sigma edges "
              f"{'OK' if worst <= PHOTOMETRIC_ATOL else 'MISMATCH'}")
        if worst > PHOTOMETRIC_ATOL:
            raise AssertionError(f"photometric {kind} kernel != plain "
                                 f"version at {shape}: {worst}")
    if modes != {"resident", "resident split", "streamed"}:
        raise AssertionError(f"photometric cases ran plans {modes}")

    timings = {}
    big = (16, 3, 1024, 1024)
    native_fn, flip_fn, _ = ph._kernels()
    for kind, shape, extents in (
            ("native", native_shape, native_extents),
            ("native", big, [[1024, 1024]] * 16),
            ("flip", (4, 3, 128, 128), None), ("flip", big, None)):
        native = kind == "native"
        if extents:
            extents = [[min(h, shape[2]), min(w, shape[3])]
                       for h, w in extents]
        b, _, hp, wp = shape
        x = torch.rand(shape, generator=gen, device="cuda")
        rows = photometric_rows(torch, b, 3, extents)
        plan = ph.plan_launch(b, hp, wp)
        c_fn = native_fn if native else flip_fn
        out = torch.empty_like(x)
        yard = torch.empty_like(x)

        def kernel_on(stream):
            return c_fn(x.data_ptr(), rows.data_ptr(), b, hp, wp,
                        *plan.c_args(), out.data_ptr(), stream)

        # Back to back on the current stream, read once; in the graph, on
        # the capturing stream.
        stream = torch.cuda.current_stream().cuda_stream
        kernel_only = functools.partial(kernel_on, stream)
        if kernel_only() != 0:
            raise AssertionError(f"photometric {kind} launch failed")
        wrapper, plain = ((ph.photometric_native_chw,
                           ph.photometric_native_reference) if native else
                          (ph.photometric_flip_chw,
                           ph.photometric_flip_reference))
        t = photometric_bound(extents or [shape[2:]] * b, native)
        t.update({
            "ms": time_ms(torch, kernel_only),
            "graph_ms": graph_ms(torch, lambda: kernel_on(
                torch.cuda.current_stream().cuda_stream)),
            "wrapper_ms": time_ms(torch, lambda: wrapper(x, rows)),
            "plain_ms": time_ms(torch, lambda: plain(x, rows), iters=20,
                                warmup=3),
            "library_ms": time_ms(torch, lambda: torch.mul(x, 1.5, out=yard)),
            "library_graph_ms": graph_ms(
                torch, lambda: torch.mul(x, 1.5, out=yard)),
            "plan": dataclasses.asdict(plan),
            "active_clusters": ph.active_clusters(native, b, hp, wp, plan),
        })
        timings[(kind, shape)] = t
        print(f"photometric {kind} timing {shape}: {json.dumps(t)}")
    return errs, timings


def phase_model(torch, SiameseUNet, predict):
    """fp32 forward on the card vs the CPU, TF32 off on the card."""
    import copy

    model = seeded_model(torch, SiameseUNet)
    rng = np.random.RandomState(SEED)
    x1 = torch.from_numpy(rng.rand(2, 128, 128, 3).astype(np.float32))
    x2 = torch.from_numpy(rng.rand(2, 128, 128, 3).astype(np.float32))
    cpu = predict(model, x1, x2, "float32")
    gpu_model = copy.deepcopy(model).cuda()
    gpu = predict(gpu_model, x1.cuda(), x2.cuda(), "float32").cpu()
    diff = float((gpu - cpu).abs().max())
    print(f"model fp32 card vs CPU: max |dprob| = {diff} "
          f"(tolerance {MODEL_PROB_TOL}), prob range "
          f"[{float(cpu.min())}, {float(cpu.max())}]")
    if not diff <= MODEL_PROB_TOL:
        raise AssertionError(f"model card vs CPU: {diff} > {MODEL_PROB_TOL}")
    return diff


def check_report(result, report_path):
    """The evaluation of the 14 cities at 128x128: counts that cover each
    map, the JAX package's report keys, every metric finite in [0, 1]."""
    from gan_aug_pfa_torch.metrics import METRIC_KEYS

    counts = result["counts"]
    if counts.shape[0] != len(CITIES) or not (
            counts.sum(axis=1) == 128 * 128).all():
        raise AssertionError(f"counts do not cover 14 128x128 maps: {counts}")
    with open(report_path) as f:
        report = json.load(f)
    want_keys = {"n_samples", "threshold", "checkpoints", "post_process",
                 "overall", "per_city", "per_city_counts", "sweep"}
    if set(report) != want_keys or set(report["per_city"]) != set(CITIES):
        raise AssertionError(f"report keys {sorted(report)}")
    values = [report["overall"][k] for k in METRIC_KEYS] + [
        m[k] for m in report["per_city"].values() for k in METRIC_KEYS]
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
        raise AssertionError(f"metric out of [0, 1]: {report}")
    print("evaluation report: " + json.dumps(report["overall"]))


def phase_main_path(torch, root):
    from gan_aug_pfa_torch import checkpoint, evaluate, pipelines
    from gan_aug_pfa_torch.config import EvalConfig
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.train.siamese import predict

    t0 = time.time()
    write_oscd_tree(root)
    model = seeded_model(torch, SiameseUNet)
    checkpoint.save_model(
        os.path.join(root, "siamese_checkpoints", "best_model.pth"), model)
    print(f"tree + checkpoint written in {time.time() - t0:.1f} s")

    report_path = os.path.join(root, "report.json")
    cc.confusion_counts_batch.launches = 0
    t0 = time.time()
    result = evaluate.main(["--root-dir", root, "--json-out", report_path])
    wall = time.time() - t0
    launches = {"confusion_counts": cc.confusion_counts_batch.launches}
    print(f"main path: evaluate.main wall {wall:.2f} s, launches {launches}")

    n = sum(result["per_city_counts"].values())
    batches = -(-n // EvalConfig().batch_size)
    if n != len(CITIES) or launches["confusion_counts"] != batches:
        raise AssertionError(
            f"{n} samples, {launches['confusion_counts']} kernel launches; "
            f"expected {len(CITIES)} samples, {batches} launches")
    check_report(result, report_path)

    # The slice at fp32 on the card vs the CPU: per sample, kernel counts
    # may differ from the CPU's only by pixels whose probability lies
    # within the two devices' largest probability difference of the
    # threshold.
    ds = build_cached_dataset(
        create_sample_lists(root, "Onera Satellite Change Detection Dataset",
                            mode="all", verbose=False),
        (128, 128), verbose=False)
    gpu_model = SiameseUNet(batched_encoder=True)
    checkpoint.restore_model_only(
        os.path.join(root, "siamese_checkpoints", "best_model.pth"),
        gpu_model)
    gpu_model.cuda()
    cpu_probs = predict(model, torch.from_numpy(ds.img1),
                        torch.from_numpy(ds.img2), "float32")[..., 0]
    cache = pipelines.DeviceCache.from_dataset(ds, "cuda")
    cfg32 = EvalConfig(compute_dtype="float32")
    gpu32 = pipelines.evaluate_cached(gpu_model, cache, ds.cities, cfg32)
    gpu_probs = predict(gpu_model, cache.img1.permute(0, 2, 3, 1),
                        cache.img2.permute(0, 2, 3, 1), "float32")[..., 0]
    dprob = float((gpu_probs.cpu() - cpu_probs).abs().max())
    cpu_counts = cc.confusion_counts_batch_reference(
        cpu_probs.contiguous(), torch.from_numpy(ds.labels).float()).numpy()
    near = ((cpu_probs - 0.5).abs() <= dprob).sum(dim=(1, 2)).numpy()
    dcounts = np.abs(gpu32["counts"] - cpu_counts).max(axis=1)
    print(f"slice fp32 card vs CPU: max |dprob| = {dprob}, max |dcount| "
          f"per sample = {dcounts.tolist()}, near-threshold pixels = "
          f"{near.tolist()}")
    if dprob > MODEL_PROB_TOL or (dcounts > near).any():
        raise AssertionError("slice on the card disagrees with the CPU")

    # Throughput of the evaluation loop over a device cache of 16 copies
    # of the 14 pairs (224 pairs), at the default bf16: one warm-up pass,
    # then PASSES timed passes per batch size.
    reps = 16
    big = pipelines.DeviceCache(cache.img1.repeat(reps, 1, 1, 1),
                                cache.img2.repeat(reps, 1, 1, 1),
                                cache.labels.repeat(reps, 1, 1))
    for bs in (2, 16):
        cfg = EvalConfig(batch_size=bs)
        pipelines.evaluate_cached(gpu_model, big, ds.cities * reps, cfg)
        rates = []
        for _ in range(PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipelines.evaluate_cached(gpu_model, big, ds.cities * reps, cfg)
            torch.cuda.synchronize()
            rates.append(len(big) / (time.perf_counter() - t0))
        print(f"eval throughput (bf16, 128x128, {len(big)} pairs, bs {bs}): "
              f"median {float(np.median(rates)):.1f} pairs/s over {PASSES} "
              f"passes, range [{min(rates):.1f}, {max(rates):.1f}]")
    device_breakdown(
        torch, lambda: pipelines.evaluate_cached(gpu_model, cache, ds.cities,
                                                 EvalConfig()),
        "one bs-2 evaluation pass (14 pairs, bf16)", ("confusion_counts",))
    return launches


def phase_training(torch, root):
    """The training path at its defaults through its CLI, in this process:
    4 epochs over the 11 train and 3 val cities (3 train steps of 4+4+3
    pairs and 1 val batch per epoch), then a resume for one more epoch and
    an evaluation of the trained best_model.pth."""
    from gan_aug_pfa_torch import evaluate
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli

    write_oscd_tree(root)
    reset_loss_counts(FocalDiceLossFn)
    t0 = time.time()
    history = train_cli.main(["--root-dir", root, "--num-epochs", "4",
                              "--save-every", "2"])
    wall = time.time() - t0
    counts = loss_counts(FocalDiceLossFn)
    print(f"training path: train main wall {wall:.2f} s, fused-loss "
          f"(calls, launches) {counts}, train loss {history['train_loss']}, "
          f"val loss {history['val_loss']}")
    if counts != {"fwd": (16, 16), "bwd": (12, 12)}:
        raise AssertionError(f"fused-loss counts {counts}; expected 16 "
                             "forward calls (12 train + 4 val) and 12 "
                             "backward, one launch each")
    losses = history["train_loss"] + history["val_loss"]
    if len(losses) != 8 or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    ckpt_dir = os.path.join(root, "siamese_checkpoints")
    for name in ("best_model", "model_epoch_2", "model_epoch_4",
                 "last_state"):
        if not os.path.exists(os.path.join(ckpt_dir, name + ".pth")):
            raise AssertionError(f"{name}.pth not written")

    resumed = train_cli.main(["--root-dir", root, "--num-epochs", "5",
                              "--save-every", "2", "--resume"])
    if len(resumed["train_loss"]) != 1 or loss_counts(FocalDiceLossFn) != {
            "fwd": (20, 20), "bwd": (15, 15)}:
        raise AssertionError(f"resume ran {resumed['train_loss']}, fused-"
                             f"loss counts {loss_counts(FocalDiceLossFn)}")
    print(f"resume: one epoch, train loss {resumed['train_loss']}, val "
          f"loss {resumed['val_loss']}")

    report_path = os.path.join(root, "trained_report.json")
    check_report(evaluate.main(["--root-dir", root, "--json-out",
                                report_path]), report_path)
    return counts


def phase_train_card_vs_cpu(torch, ds):
    """3 fp32 train steps from one seeded init, on the card (kernels, TF32
    off) and on the CPU (plain version): the per-step losses agree."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    cfg = SiameseTrainConfig(compute_dtype="float32")
    rel = []
    runs = []
    for device in ("cuda", "cpu"):
        trainer = SiameseTrainer(cfg, device)
        cache = DeviceCache.from_dataset(ds, device)
        runs.append([float(trainer.train_step(
            cache, torch.arange(start, min(start + 4, len(ds)),
                                device=device)))
            for start in range(0, len(ds), 4)])
    rel = [abs(a - b) / abs(b) for a, b in zip(*runs)]
    print(f"train steps fp32 card vs CPU: losses {runs[0]} vs {runs[1]}, "
          f"relative differences {rel} (tolerances {TRAIN_STEP1_RTOL} for "
          f"step 1, {TRAIN_STEP_RTOL} after)")
    if not (rel[0] <= TRAIN_STEP1_RTOL
            and all(r <= TRAIN_STEP_RTOL for r in rel)):
        raise AssertionError("train steps on the card disagree with the CPU")
    return rel


def train_throughput(torch, ds):
    """Train steps/s and pairs/s at bs 4 and 16, bf16, over a device cache
    of 16 copies of the train pairs: one warm-up pass, then PASSES timed
    passes; then a profile of one epoch of the plain train split."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    cache = DeviceCache.from_dataset(ds, "cuda")
    reps = 16
    big = DeviceCache(cache.img1.repeat(reps, 1, 1, 1),
                      cache.img2.repeat(reps, 1, 1, 1),
                      cache.labels.repeat(reps, 1, 1))
    result = {}
    for bs in (4, 16):
        trainer = SiameseTrainer(SiameseTrainConfig(batch_size=bs), "cuda")
        rng = np.random.RandomState(SEED)
        trainer.train_epoch(big, rng)
        walls = []
        for _ in range(PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_epoch(big, rng)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        steps = -(-len(big) // bs)
        steps_s = [steps / w for w in walls]
        pairs_s = [len(big) / w for w in walls]
        result[bs] = float(np.median(pairs_s))
        print(f"train throughput (bf16, 128x128, {len(big)} pairs, bs {bs}): "
              f"median {float(np.median(steps_s)):.2f} steps/s, "
              f"{result[bs]:.1f} pairs/s over {PASSES} passes, range "
              f"[{min(pairs_s):.1f}, {max(pairs_s):.1f}] pairs/s")
    trainer = SiameseTrainer(SiameseTrainConfig(), "cuda")
    rng = np.random.RandomState(SEED)
    trainer.train_epoch(cache, rng)
    device_breakdown(
        torch, lambda: trainer.train_epoch(cache, rng),
        f"one bs-4 train epoch ({len(cache)} pairs, 3 steps, bf16)",
        ("focal_dice",))
    return result


def reset_loss_counts(fn):
    fn.fwd_calls = fn.fwd_launches = fn.bwd_calls = fn.bwd_launches = 0


def loss_counts(fn):
    return {"fwd": (fn.fwd_calls, fn.fwd_launches),
            "bwd": (fn.bwd_calls, fn.bwd_launches)}


def reset_photometric_counts(ph):
    for fn in (ph.photometric_native_chw, ph.photometric_flip_chw):
        fn.calls = fn.launches = 0


def photometric_counts(ph):
    return {name: (fn.calls, fn.launches) for name, fn in (
        ("native", ph.photometric_native_chw),
        ("flip", ph.photometric_flip_chw))}


def phase_aug_training(torch, root):
    """The augmented training path through its CLI, in this process: 4
    epochs of ``--augment`` (native resolution, the default) over the 11
    train and 3 val cities, then one epoch of ``--augment
    --no-native-aug``.  Every count is set to 0 just before each run and
    read just after it."""
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli

    write_oscd_tree(root)
    runs = {}
    for name, flags, epochs in (
            ("native", [], 4),
            ("fixed_size", ["--no-native-aug", "--checkpoint-dir",
                            "fixed_checkpoints"], 1)):
        reset_photometric_counts(ph)
        reset_loss_counts(FocalDiceLossFn)
        t0 = time.time()
        history = train_cli.main(["--root-dir", root, "--augment",
                                  "--num-epochs", str(epochs),
                                  "--save-every", "2", *flags])
        wall = time.time() - t0
        counts = photometric_counts(ph)
        loss = loss_counts(FocalDiceLossFn)
        print(f"augmented training ({name}): train main wall {wall:.2f} s, "
              f"photometric (calls, launches) {counts}, fused-loss "
              f"(calls, launches) {loss}, train loss "
              f"{history['train_loss']}, val loss {history['val_loss']}")
        # 11 train pairs at batch 4: 3 steps an epoch, 2 images a step, one
        # launch a call.
        steps = 3 * epochs
        want = {"native": (2 * steps, 2 * steps), "flip": (0, 0)}
        if name == "fixed_size":
            want = {"native": (0, 0), "flip": (2 * steps, 2 * steps)}
        if counts != want or loss != {"fwd": (4 * epochs, 4 * epochs),
                                      "bwd": (steps, steps)}:
            raise AssertionError(f"{name}: photometric {counts}, expected "
                                 f"{want}; fused loss {loss}")
        losses = history["train_loss"] + history["val_loss"]
        if len(losses) != 2 * epochs or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: losses {losses}")
        runs[name] = {"counts": counts, "loss_launches": loss, "wall": wall}
    for name in ("best_model", "model_epoch_2", "model_epoch_4",
                 "last_state"):
        if not os.path.exists(os.path.join(root, "siamese_checkpoints",
                                           name + ".pth")):
            raise AssertionError(f"{name}.pth not written")
    if not os.path.exists(os.path.join(root, "fixed_checkpoints",
                                       "best_model.pth")):
        raise AssertionError("fixed-size run wrote no best_model.pth")
    return runs


def aug_batches(torch, native_ds, fixed_ds, device):
    """Bs-4 augmented batches of the native and the fixed-size chain on
    ``device`` from one CPU draw each, and the caches they came from."""
    from gan_aug_pfa_torch.data import transforms as T
    from gan_aug_pfa_torch.pipelines import DeviceCache, NativeDeviceCache

    out = {}
    for name, cache_cls, ds in (("native", NativeDeviceCache, native_ds),
                                ("fixed_size", DeviceCache, fixed_ds)):
        cache = cache_cls.from_dataset(ds, device)
        idx = torch.arange(4, device=device)
        if name == "native":
            sizes = torch.from_numpy(ds.sizes[:4]).long()
        else:
            sizes = torch.tensor([list(ds.img1.shape[1:3])] * 4)
        params = T.sample_augment_params(
            torch.Generator().manual_seed(SEED), sizes)
        params = {k: v.to(device) for k, v in params.items()}
        nhwc = (cache.img1[:4].permute(0, 2, 3, 1),
                cache.img2[:4].permute(0, 2, 3, 1), cache.labels[:4])
        if name == "native":
            batch = T.augment_batch_native(*nhwc, sizes.to(device),
                                           (128, 128), params)
        else:
            batch = T.augment_batch(*nhwc, params)
        out[name] = (cache, idx, params, batch)
    return out


def phase_aug_card_vs_cpu(torch, native_ds, fixed_ds):
    """One drawn parameter dict per chain: the augmented batch on the card
    (kernels) vs the CPU (plain versions), then the first fp32 augmented
    train step's loss on each from one seeded init."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    card = aug_batches(torch, native_ds, fixed_ds, "cuda")
    cpu = aug_batches(torch, native_ds, fixed_ds, "cpu")
    result = {}
    for name in card:
        g, c = card[name][3], cpu[name][3]
        img_err = max(float((a.cpu() - b).abs().max())
                      for a, b in zip(g[:2], c[:2]))
        mismatch = float((g[2].cpu() != c[2]).float().mean())
        losses = []
        for batches, device in ((card, "cuda"), (cpu, "cpu")):
            cache, idx, params, _ = batches[name]
            trainer = SiameseTrainer(
                SiameseTrainConfig(compute_dtype="float32"), device,
                augment=True,
                native_out_size=(128, 128) if name == "native" else None)
            losses.append(float(trainer.train_step(cache, idx, params)))
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"augmented {name} batch card vs CPU: max |dimg| {img_err} "
              f"(tolerance {CHAIN_ATOL}), label mismatch share {mismatch}; "
              f"first fp32 step loss {losses[0]} vs {losses[1]}, relative "
              f"{rel} (tolerance {TRAIN_STEP1_RTOL})")
        if (img_err > CHAIN_ATOL or mismatch > LABEL_MISMATCH_SHARE
                or rel > TRAIN_STEP1_RTOL):
            raise AssertionError(f"augmented {name} chain on the card "
                                 "disagrees with the CPU")
        result[name] = {"img_err": img_err, "label_mismatch": mismatch,
                        "step1_rel": rel}
    return result


def aug_throughput(torch, native_ds):
    """Augmented (native) train steps/s and pairs/s at bs 4, bf16, over a
    device cache of 16 copies of the train pairs: one warm-up pass, then
    PASSES timed passes; then a profile of one epoch of the plain train
    split with the photometric kernels' and the gathers' device shares."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import NativeDeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    cache = NativeDeviceCache.from_dataset(native_ds, "cuda")
    reps = 16
    big = NativeDeviceCache(cache.img1.repeat(reps, 1, 1, 1),
                            cache.img2.repeat(reps, 1, 1, 1),
                            cache.labels.repeat(reps, 1, 1),
                            cache.sizes.repeat(reps, 1))
    trainer = SiameseTrainer(SiameseTrainConfig(), "cuda", augment=True,
                             native_out_size=(128, 128))
    rng = np.random.RandomState(SEED)
    trainer.train_epoch(big, rng)
    walls = []
    for _ in range(PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(big, rng)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    steps = -(-len(big) // 4)
    steps_s = [steps / w for w in walls]
    pairs_s = [len(big) / w for w in walls]
    print(f"augmented train throughput (native {tuple(cache.img1.shape[2:])} "
          f"-> 128x128, bf16, {len(big)} pairs, bs 4): median "
          f"{float(np.median(steps_s)):.2f} steps/s, "
          f"{float(np.median(pairs_s)):.1f} pairs/s over {PASSES} passes, "
          f"range [{min(pairs_s):.1f}, {max(pairs_s):.1f}] pairs/s")
    trainer.train_epoch(cache, rng)
    busy_us, kernels = device_breakdown(
        torch, lambda: trainer.train_epoch(cache, rng),
        f"one bs-4 augmented train epoch ({len(cache)} pairs, 3 steps, "
        "bf16)", ("photometric",))
    for label, names in (("photometric kernels", ("photometric",)),
                         ("gathers (geometric stages)", ("gather",))):
        us = sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in names))
        print(f"  share of device time in {label}: {us:.1f} us, "
              f"{100 * us / busy_us:.2f}%")
    return float(np.median(steps_s))


def device_breakdown(torch, fn, label, ours, top=8):
    """Trace ``fn`` with torch.profiler: wall time, summed device kernel
    time (busy share) and the kernels that take the most device time, with
    the port's kernels (names containing one of ``ours``) always shown.
    Returns the device kernel time (us) and the profiler's kernel rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side copies of user annotations (Optimizer.step) are ranges,
    # not kernels.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile of {label}: wall {wall_us:.0f} us, device kernels "
          f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}% busy), "
          f"{sum(e.count for e in kernels)} kernel launches")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    mine = [e for e in ranked if any(name in e.key for name in ours)]
    for e in ranked[:top] + [e for e in mine if e not in ranked[:top]]:
        print(f"  {e.self_device_time_total:9.1f} us  {e.count:4d}x  "
              f"{e.key[:100]}")
    return busy_us, kernels


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    from gan_aug_pfa_torch.data.loader import (
        build_cached_dataset,
        build_padded_native_dataset,
    )
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.ops.kernels import build
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.ops.kernels import fused_loss as fl
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.train.siamese import predict

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    logs = build.build([cc.NAME, fl.NAME, ph.NAME])
    print(f"kernel build: {time.time() - t0:.1f} s "
          f"({', '.join(logs) or 'already built'})")
    for name, log in logs.items():
        if log.strip():
            print(f"nvcc {name}:\n{log.strip()}")

    max_err, timings = phase_kernel(torch, cc)
    loss_errs, loss_t = phase_loss_kernel(torch, fl)
    phase_model(torch, SiameseUNet, predict)
    with tempfile.TemporaryDirectory() as root:
        launches = phase_main_path(torch, root)
    with tempfile.TemporaryDirectory() as root:
        train_counts = phase_training(torch, root)
        train_ds = build_cached_dataset(
            create_sample_lists(root, "Onera Satellite Change Detection "
                                "Dataset", mode="train", verbose=False),
            (128, 128), verbose=False)
    phase_train_card_vs_cpu(torch, train_ds)
    train_throughput(torch, train_ds)
    with tempfile.TemporaryDirectory() as root:
        aug_runs = phase_aug_training(torch, root)
        native_ds = build_padded_native_dataset(
            create_sample_lists(root, "Onera Satellite Change Detection "
                                "Dataset", mode="train", verbose=False),
            verbose=False)
    phase_aug_card_vs_cpu(torch, native_ds, train_ds)
    aug_throughput(torch, native_ds)
    native_shape = (4, 3, *native_ds.img1.shape[1:3])
    photo_errs, photo_t = phase_photometric(
        torch, ph, native_shape, native_ds.sizes[:4].tolist())

    eval_t = timings[(2, 128, 128)]
    kernels = [{
        "name": cc.NAME,
        "route": "cuda",
        "source": "gan_aug_pfa_torch/csrc/confusion_counts.cu",
        "replaces": "gan_aug_pfa_tpu/ops/pallas_kernels/metrics.py:37",
        "launches": launches[cc.NAME],
        "max_abs_err": max_err,
        "ms": eval_t["ms"],
        "kernel_ms": eval_t["ms"],
        "graph_ms": eval_t["graph_ms"],
        "wrapper_ms": eval_t["wrapper_ms"],
        "plain_ms": eval_t["plain_ms"],
        "bound_ms": eval_t["bound_ms"],
        "bound_by": eval_t["bound_by"],
        "library_ms": eval_t["library_ms"],
        "shape": [2, 128, 128],
    }]
    # The loss kernels' main numbers are the train step's: bf16 logits at
    # the train shape; float32 and 16x1x1024x1024 beside them.
    keys = ("ms", "graph_ms", "wrapper_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_graph_ms")
    for name, line, library in (
            ("fwd", 120, "F.binary_cross_entropy_with_logits(sum)"),
            ("bwd", 131, "torch.mul(x, t)")):
        t = loss_t[(TRAIN_SHAPE, "bfloat16")][name]
        calls, n_launches = train_counts[name]
        kernels.append({
            "name": f"{fl.NAME}_{name}",
            "route": "cuda",
            "source": "gan_aug_pfa_torch/csrc/focal_dice_loss.cu",
            "replaces":
                f"gan_aug_pfa_tpu/ops/pallas_kernels/fused_loss.py:{line}",
            "launches": n_launches,
            "calls": calls,
            "max_abs_err": loss_errs[name, "float32"],
            "max_abs_err_bf16": loss_errs[name, "bfloat16"],
            **{k: t[k] for k in keys},
            "kernel_ms": t["ms"],
            "library_call": library + " (a yardstick of about the same "
                                      "bytes)",
            "shape": list(TRAIN_SHAPE),
            "logits": "bfloat16",
            "plan": t["plan"],
            "other": {f"{'x'.join(map(str, shape))} {dtype}": {
                k: loss_t[(shape, dtype)][name][k] for k in keys}
                for shape in (TRAIN_SHAPE, BIG_LOSS_SHAPE)
                for dtype in LOSS_DTYPES
                if (shape, dtype) != (TRAIN_SHAPE, "bfloat16")},
        })
    for kind, fn, line, shape, run in (
            ("native", ph.photometric_native_chw, 237, native_shape,
             "native"),
            ("flip", ph.photometric_flip_chw, 99, (4, 3, 128, 128),
             "fixed_size")):
        t = photo_t[(kind, shape)]
        calls, launches = aug_runs[run]["counts"][kind]
        kernels.append({
            "name": fn.__name__,
            "route": "cuda",
            "source": "gan_aug_pfa_torch/csrc/photometric.cu",
            "replaces":
                f"gan_aug_pfa_tpu/ops/pallas_kernels/photometric.py:{line}",
            "launches": launches,
            "calls": calls,
            "max_abs_err": photo_errs[kind],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "graph_ms": t["graph_ms"],
            "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_graph_ms": t["library_graph_ms"],
            "library_call": "torch.mul (a yardstick of the same bytes)",
            "shape": list(shape),
            "plan": t["plan"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
