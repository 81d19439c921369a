#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``gan_aug_pfa_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. print the card (``nvidia-smi`` name and power limit);
2. build every CUDA kernel of the evaluation and training paths from
   ``csrc/`` with nvcc, one process per source, all at once;
3. hold each kernel against its plain PyTorch version on the card (exact
   integer equality for the confusion counts; the fused FocalDice loss
   within the JAX package's fused-loss tolerances, forward and backward)
   and time kernel, wrapper, plain version and one PyTorch call with CUDA
   events;
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
   with the fused-loss launch counts set to 0 just before and read just
   after; check the losses and checkpoints, resume for one epoch, evaluate
   the trained ``best_model.pth``; compare 3 fp32 train steps on the card
   with the CPU's; time training throughput at batch 4 and 16 and profile
   one epoch.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero.
"""

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
# Special-function operations an element: sigmoid (exp, reciprocal),
# softplus (exp, log), pt (exp) and u^gamma (log, exp); the backward adds
# u^(gamma-1) (log, exp) and two divisions (reciprocals).
FWD_SFU_OPS, BWD_SFU_OPS = 7, 11
# Card vs CPU, 3 fp32 train steps from one init: the first step's loss
# differs only by the forward's rounding; later ones also by Adam's
# updates of parameters whose gradient is rounding noise (up to lr each).
TRAIN_STEP1_RTOL, TRAIN_STEP_RTOL = 1e-5, 1e-3


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


def loss_inputs(torch, shape, gen, misaligned=False):
    """Logits (B, 1, H, W) with saturated entries of +-1e4 and binary
    targets (B, H, W), as the train step passes them; ``misaligned``
    gives views 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    extra = 1 if misaligned else 0
    x = torch.randn(n + extra, generator=gen, device="cuda") * 4
    x[::101] = 1e4
    x[50::101] = -1e4
    t = (torch.rand(n + extra, generator=gen, device="cuda") > 0.7).float()
    if misaligned:
        x, t = x[1:], t[1:]
    b, _, h, w = shape
    return x.view(shape), t.view(b, h, w)


def phase_loss_kernel(torch, fl):
    """Fused FocalDice kernels vs the plain version on the card, forward
    and backward, at the tolerances of tests/test_pallas.py: the loss
    within 1e-6 relative, dx within 1e-5 of max|dx| (1e-3 from 2^20
    elements on, where dx is O(1e-7) and the sums' rounding shows).  Each
    forward is also run twice and must give the same bits."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    beta, alpha, smooth = (LOSS_KW["beta"], LOSS_KW["focal_alpha"],
                           LOSS_KW["dice_smooth"])
    errs = {"fwd": 0.0, "bwd": 0.0}
    for shape, misaligned in LOSS_CASES:
        for gamma in GAMMAS:
            x, t = loss_inputs(torch, shape, gen, misaligned)
            xf, tf = x.reshape(-1), t.reshape(-1)
            if misaligned and xf.data_ptr() % 16 == 0:
                raise AssertionError("misaligned case is 16-byte aligned")
            n = xf.numel()
            hyper = (beta, gamma, alpha, smooth)
            g = torch.tensor(0.73, device="cuda")
            loss, sums = fl.launch_forward(xf, tf, *hyper)
            dx = fl.launch_backward(xf, tf, sums, g, *hyper)
            loss2, sums2 = fl.launch_forward(xf, tf, *hyper)
            torch.cuda.synchronize()
            ref_sums = fl.focal_dice_sums_reference(xf, tf, gamma, alpha)
            ref_loss = float(fl._finalize(ref_sums, n, beta, smooth))
            ref_dx = fl.focal_dice_grad_reference(xf, tf, ref_sums, g,
                                                  *hyper)
            dloss = abs(float(loss) - ref_loss)
            ddx = float((dx - ref_dx).abs().max())
            scale = float(ref_dx.abs().max())
            dx_tol = (1e-3 if n >= 1 << 20 else 1e-5) * scale
            errs["fwd"] = max(errs["fwd"], dloss)
            errs["bwd"] = max(errs["bwd"], ddx)
            ok = (np.isfinite(float(loss)) and bool(dx.isfinite().all())
                  and dloss < 1e-6 * max(1.0, abs(ref_loss))
                  and ddx <= dx_tol and torch.equal(loss, loss2)
                  and torch.equal(sums, sums2))
            print(f"loss kernel {shape} gamma={gamma:.4f} misaligned="
                  f"{misaligned}: loss {float(loss):.7f} vs {ref_loss:.7f} "
                  f"(|d| {dloss:.2e}), max|ddx| {ddx:.2e} (tol "
                  f"{dx_tol:.2e}) {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(
                    f"fused loss kernels != plain version at {shape}, "
                    f"gamma={gamma}")

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

    timings = {shape: loss_timings(torch, fl, shape, gen)
               for shape in (TRAIN_SHAPE, (16, 1, 1024, 1024))}
    return errs, timings


def loss_timings(torch, fl, shape, gen):
    """Kernel alone (the bare C calls), wrapper, plain version and one
    PyTorch call reading the same bytes (a yardstick: no single PyTorch
    call computes this function), forward and backward."""
    import torch.nn.functional as F

    x, t = loss_inputs(torch, shape, gen)
    xf, tf = x.reshape(-1), t.reshape(-1)
    n = xf.numel()
    hyper = (LOSS_KW["beta"], GAMMAS[0], LOSS_KW["focal_alpha"],
             LOSS_KW["dice_smooth"])
    scratch, fwd, bwd = fl._kernels()
    loss = torch.empty((), device="cuda")
    buf = torch.empty(4 + scratch(n), device="cuda")
    dx = torch.empty_like(xf)
    g = torch.ones((), device="cuda")
    lib_out = torch.empty_like(xf)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (xf.data_ptr(), tf.data_ptr())
    part = buf[4:].data_ptr()

    def fwd_only():
        return fwd(*ptrs, n, *hyper, loss.data_ptr(), buf.data_ptr(), part,
                   stream)

    def bwd_only():
        return bwd(*ptrs, buf.data_ptr(), g.data_ptr(), n, *hyper,
                   dx.data_ptr(), stream)

    if fwd_only() != 0 or bwd_only() != 0:
        raise AssertionError("fused loss kernel launch failed")
    sums = buf[:4]
    kw = dict(focal_gamma=GAMMAS[0], **LOSS_KW)
    out = {}
    for name, nbytes, sfu, kernel, wrapper, plain, library in (
        ("fwd", 8 * n + 20, FWD_SFU_OPS, fwd_only,
         lambda: fl.focal_dice_loss_fused(x, t, **kw),
         lambda: fl.FocalDiceLossReferenceFn.apply(xf, tf, *hyper),
         lambda: F.binary_cross_entropy_with_logits(xf, tf,
                                                    reduction="sum")),
        ("bwd", 12 * n + 20, BWD_SFU_OPS, bwd_only,
         lambda: fl.launch_backward(xf, tf, sums, g, *hyper),
         lambda: fl.focal_dice_grad_reference(xf, tf, sums, g, *hyper),
         lambda: torch.mul(xf, tf, out=lib_out)),
    ):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = sfu * n / SFU_OPS_PER_S * 1e3
        out[name] = {
            "ms": time_ms(torch, kernel),
            "wrapper_ms": time_ms(torch, wrapper),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes,
            "sfu_ms": ops_ms,
        }
        print(f"loss kernel timing {name} {shape}: {json.dumps(out[name])}")
    return out


def photometric_bounds(batch=4):
    """Bounds of the two photometric TPU kernels not ported yet
    (gan_aug_pfa_tpu/ops/pallas_kernels/photometric.py), per call on
    ``batch`` images at 128x128 and 256x256: (B, 3, H, W) float32 read and
    written once plus (B, 8) float32 parameters.  fp32 operations an
    element: brightness 3 (multiply, clip), contrast 6 and saturation 6
    (the gray value, a blend, a clip), the separable 3x3 blur 10 (two
    passes of a multiply and two multiply-adds); the native-extent kernel
    adds 5 for its mask and dynamic reflect-101 edge."""
    out = {}
    for name, ops in (("photometric_flip_chw", 25),
                      ("photometric_native_chw", 30)):
        for side in (128, 256):
            n = batch * 3 * side * side
            nbytes = 8 * n + 32 * batch
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops * n / FP32_OPS_PER_S * 1e3
            out[f"{name} {batch}x3x{side}x{side}"] = {
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "ops_ms": ops_ms}
    return out


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
    FocalDiceLossFn.fwd_launches = FocalDiceLossFn.bwd_launches = 0
    t0 = time.time()
    history = train_cli.main(["--root-dir", root, "--num-epochs", "4",
                              "--save-every", "2"])
    wall = time.time() - t0
    launches = {"fwd": FocalDiceLossFn.fwd_launches,
                "bwd": FocalDiceLossFn.bwd_launches}
    print(f"training path: train main wall {wall:.2f} s, launches "
          f"{launches}, train loss {history['train_loss']}, val loss "
          f"{history['val_loss']}")
    if launches != {"fwd": 16, "bwd": 12}:
        raise AssertionError(f"fused-loss launches {launches}; expected "
                             "16 forward (12 train + 4 val), 12 backward")
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
    if len(resumed["train_loss"]) != 1 or (
            FocalDiceLossFn.fwd_launches, FocalDiceLossFn.bwd_launches) != (
            20, 15):
        raise AssertionError(f"resume ran {resumed['train_loss']}")
    print(f"resume: one epoch, train loss {resumed['train_loss']}, val "
          f"loss {resumed['val_loss']}")

    report_path = os.path.join(root, "trained_report.json")
    check_report(evaluate.main(["--root-dir", root, "--json-out",
                                report_path]), report_path)
    return launches


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


def device_breakdown(torch, fn, label, ours, top=8):
    """Trace ``fn`` with torch.profiler: wall time, summed device kernel
    time (busy share) and the kernels that take the most device time, with
    the port's kernels (names containing one of ``ours``) always shown."""
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.ops.kernels import build
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.ops.kernels import fused_loss as fl
    from gan_aug_pfa_torch.train.siamese import predict

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    logs = build.build([cc.NAME, fl.NAME])
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
        train_launches = phase_training(torch, root)
        train_ds = build_cached_dataset(
            create_sample_lists(root, "Onera Satellite Change Detection "
                                "Dataset", mode="train", verbose=False),
            (128, 128), verbose=False)
    phase_train_card_vs_cpu(torch, train_ds)
    train_throughput(torch, train_ds)
    print("bounds of the TPU kernels not ported yet: "
          + json.dumps(photometric_bounds()))

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
        "wrapper_ms": eval_t["wrapper_ms"],
        "plain_ms": eval_t["plain_ms"],
        "bound_ms": eval_t["bound_ms"],
        "bound_by": eval_t["bound_by"],
        "library_ms": eval_t["library_ms"],
        "shape": [2, 128, 128],
    }]
    for name, line, library in (
            ("fwd", 120, "F.binary_cross_entropy_with_logits(sum)"),
            ("bwd", 131, "torch.mul")):
        t = loss_t[TRAIN_SHAPE][name]
        kernels.append({
            "name": f"{fl.NAME}_{name}",
            "route": "cuda",
            "source": "gan_aug_pfa_torch/csrc/focal_dice_loss.cu",
            "replaces":
                f"gan_aug_pfa_tpu/ops/pallas_kernels/fused_loss.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": loss_errs[name],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": library + " (a yardstick of the same bytes)",
            "shape": list(TRAIN_SHAPE),
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
