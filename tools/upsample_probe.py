"""The decoder's 2x upsample on the card: the two matrix products
(``ops/resize.py``) against the gather-lerp form they replaced
(``F.interpolate(..., mode="bilinear", align_corners=True)``), and what
deterministic mode and cuBLAS's workspace setting cost the Siamese net.

    python3 tools/upsample_probe.py

Needs a CUDA card; builds the FocalDice and confusion-counts kernels.  At
the defaults (128x128, bf16 autocast, full width, a seeded model):

  1. each decoder level's upsample alone: the output dtype and the ms of
     a forward and backward of each form (CUDA events, median of 50);
  2. the profile of 3 train steps (batch 4) and of 7 evaluation batches
     (batch 2) with each form: the upsample's device time (the kernels
     launched under it), its share of all device time, and its launches
     a step or a batch;
  3. a bf16 evaluation forward of 4 seeded pairs: the probabilities' and
     the FocalDice loss's shift, matrix form against gather-lerp form; 4
     bf16 train steps from one init on those pairs: each step's loss with
     each form;
  4. in fresh processes, train steps/s (batch 4) and evaluation pairs/s
     (batch 2) with ``CUBLAS_WORKSPACE_CONFIG`` unset, set to :4096:8, and
     set under ``torch.use_deterministic_algorithms(True)`` with cuDNN's
     deterministic algorithms (median of 3 timed passes each).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEPS, BATCHES, PASSES = 3, 7, 3
RATE_CHILD = r"""
import json, os, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from gan_aug_pfa_torch.config import SiameseTrainConfig
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.train.siamese import SiameseTrainer, predict

rng = np.random.RandomState(0)
imgs = [torch.from_numpy(rng.rand(4, 3, 128, 128).astype(np.float32)).cuda()
        for _ in range(2)]
labels = torch.from_numpy((rng.rand(4, 128, 128) > 0.8).astype(
    np.float32)).cuda()
ctx = (chip_smoke.deterministic(torch) if sys.argv[2] == "deterministic"
       else chip_smoke.contextlib.nullcontext())
out = {"train": [], "eval": []}
with ctx:
    trainer = SiameseTrainer(SiameseTrainConfig(), "cuda")
    model = SiameseUNet().cuda().eval()
    for _ in range(10):
        trainer.train_batch(*imgs, labels)
        predict(model, imgs[0][:2].permute(0, 2, 3, 1),
                imgs[1][:2].permute(0, 2, 3, 1), "bfloat16")
    for _ in range(int(sys.argv[3])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            trainer.train_batch(*imgs, labels)
        torch.cuda.synchronize()
        out["train"].append(30 / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for _ in range(50):
            predict(model, imgs[0][:2].permute(0, 2, 3, 1),
                    imgs[1][:2].permute(0, 2, 3, 1), "bfloat16")
        torch.cuda.synchronize()
        out["eval"].append(100 / (time.perf_counter() - t0))
print(json.dumps(out))
"""


def lerp_upsample(x):
    import torch.nn.functional as F

    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def using(form):
    """Make the model's decoder call ``form`` for its upsample."""
    from gan_aug_pfa_torch.parallel import spatial

    spatial.upsample2x_align_corners = form


def annotated(torch, form):
    def up(x):
        with torch.profiler.record_function("decoder_upsample"):
            return form(x)
    return up


def upsample_alone(torch, matrix):
    """Each level's upsample alone, forward and backward, both forms."""
    from chip_smoke import deterministic

    print("1. the upsample alone (bf16 autocast, batch 4, forward + "
          "backward, median of 50, CUDA events):")
    for c, h in ((2048, 8), (512, 16), (256, 32), (128, 64)):
        x = torch.randn(4, c, h, h, device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
        g = torch.randn(4, c, 2 * h, 2 * h, device="cuda",
                        dtype=torch.bfloat16)
        row = []
        for name, form in (("matrix", matrix), ("gather-lerp", lerp_upsample)):
            def run():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    y = form(x)
                y.backward(g.to(y.dtype))
                return y.dtype
            dtype = run()
            times = []
            for _ in range(50):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            row.append(f"{name} {float(np.median(times)):.4f} ms ({dtype})")
        print(f"  4x{c}x{h}x{h}: {'; '.join(row)}")
        for dtype in (torch.float32, torch.bfloat16):
            grads, raises = [], "does not raise"
            for _ in range(2):
                xd = x.detach().to(dtype).requires_grad_()
                try:
                    with deterministic(torch):
                        y = lerp_upsample(xd)
                        y.backward(g.to(y.dtype))
                except RuntimeError as e:
                    raises = f"raises ({str(e).splitlines()[0][:70]}...)"
                    break
                grads.append(xd.grad)
            same = (torch.equal(*grads) if len(grads) == 2 else None)
            print(f"    gather-lerp backward of a {dtype} input under "
                  f"deterministic mode {raises}; two runs equal bits: {same}")


def profiles(torch, matrix, trainer_for, model, data):
    """Device time of the upsample under train steps and evaluation."""
    from torch.profiler import ProfilerActivity, profile

    from gan_aug_pfa_torch.train.siamese import predict

    imgs, labels = data
    print(f"2. profiles: {STEPS} train steps at batch 4 and {BATCHES} "
          "evaluation batches at batch 2 (bf16)")
    for name, form in (("matrix", matrix), ("gather-lerp", lerp_upsample)):
        using(annotated(torch, form))
        trainer = trainer_for()
        runs = {
            "train step": (STEPS, lambda: [trainer.train_batch(
                *imgs, labels) for _ in range(STEPS)]),
            "eval batch": (BATCHES, lambda: [predict(
                model, imgs[0][:2].permute(0, 2, 3, 1),
                imgs[1][:2].permute(0, 2, 3, 1), "bfloat16")
                for _ in range(BATCHES)])}
        for label, (n, fn) in runs.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = prof.events()
            all_us = sum(k.duration for e in events for k in e.kernels)
            up_us, up_n = 0.0, 0
            for e in events:
                if e.name != "decoder_upsample":
                    continue
                todo = list(e.cpu_children)
                while todo:
                    child = todo.pop()
                    up_us += sum(k.duration for k in child.kernels)
                    up_n += len(child.kernels)
                    todo.extend(child.cpu_children)
            # The backward's kernels run on autograd's thread, outside the
            # annotation: counted from the ops that the upsample's backward
            # names (bmm/mm for the matrix form, upsample_* for the other).
            back = [e for e in events if e.name in (
                "BmmBackward0", "MmBackward0",
                "UpsampleBilinear2DBackward0")]
            if label == "train step" and not back:
                raise SystemExit("no upsample backward in the profile")
            back_us, back_n = 0.0, 0
            for e in back:
                todo = [e]
                while todo:
                    child = todo.pop()
                    back_us += sum(k.duration for k in child.kernels)
                    back_n += len(child.kernels)
                    todo.extend(child.cpu_children)
            total = up_us + (back_us if label == "train step" else 0.0)
            launches = up_n + (back_n if label == "train step" else 0)
            print(f"  {name} {label}: upsample {total / n:.1f} us a "
                  f"{label.split()[1]} ({100 * total / all_us:.1f}% of "
                  f"{all_us / n:.1f} us of device kernels), {launches / n:.1f}"
                  f" launches a {label.split()[1]} (forward {up_n / n:.1f})")
    using(matrix)


def shifts(torch, matrix, trainer_for, model, data):
    """The bf16 evaluation and training losses with each form."""
    from gan_aug_pfa_torch.data.transforms import normalize
    from gan_aug_pfa_torch.train.siamese import compute_precision

    imgs, labels = data
    x1, x2 = normalize(imgs[0]), normalize(imgs[1])
    out = {}
    for name, form in (("matrix", matrix), ("gather-lerp", lerp_upsample)):
        using(form)
        trainer = trainer_for()
        with torch.no_grad(), compute_precision("bfloat16", "cuda"):
            logits = model(x1, x2)
        out[name] = {
            "probs": torch.sigmoid(logits.float()),
            "eval_loss": float(trainer.loss(logits, labels)),
            "train": [float(trainer.train_batch(*imgs, labels))
                      for _ in range(4)]}
    using(matrix)
    a, b = out["matrix"], out["gather-lerp"]
    print("3. bf16 shifts, matrix form against gather-lerp form: max "
          f"|dprob| {float((a['probs'] - b['probs']).abs().max())!r}; eval "
          f"loss {a['eval_loss']!r} vs {b['eval_loss']!r} (relative "
          f"{abs(a['eval_loss'] / b['eval_loss'] - 1)!r}); train losses "
          f"{a['train']} vs {b['train']} (relative "
          f"{[abs(x / y - 1) for x, y in zip(a['train'], b['train'])]})")


def rates():
    print(f"4. fresh processes, median of {PASSES} passes (30 train steps "
          "at batch 4, 50 evaluation batches at batch 2):")
    for name, env, mode in (
            ("CUBLAS_WORKSPACE_CONFIG unset", None, "default"),
            ("CUBLAS_WORKSPACE_CONFIG=:4096:8", ":4096:8", "default"),
            ("CUBLAS_WORKSPACE_CONFIG=:4096:8, deterministic mode",
             ":4096:8", "deterministic")):
        child_env = {k: v for k, v in os.environ.items()
                     if k != "CUBLAS_WORKSPACE_CONFIG"}
        if env:
            child_env["CUBLAS_WORKSPACE_CONFIG"] = env
        proc = subprocess.run(
            [sys.executable, "-c", RATE_CHILD, REPO, mode, str(PASSES)],
            env=child_env, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stderr[-3000:])
            raise SystemExit(f"{name}: the child exited {proc.returncode}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"  {name}: train {float(np.median(r['train'])):.2f} steps/s "
              f"{[round(v, 2) for v in r['train']]}, eval "
              f"{float(np.median(r['eval'])):.1f} pairs/s "
              f"{[round(v, 1) for v in r['eval']]}")


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("upsample_probe needs a CUDA card")
    import chip_smoke
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.ops.kernels import build
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.ops.kernels import fused_loss as fl
    from gan_aug_pfa_torch.ops.resize import upsample2x_align_corners
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    print(chip_smoke.card_name())
    build.build([cc.NAME, fl.NAME])
    t0 = time.time()
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.rand(4, 3, 128, 128).astype(
        np.float32)).cuda() for _ in range(2)]
    labels = torch.from_numpy((rng.rand(4, 128, 128) > 0.8).astype(
        np.float32)).cuda()
    model = chip_smoke.seeded_model(torch, SiameseUNet).cuda().eval()

    def trainer_for():
        return SiameseTrainer(SiameseTrainConfig(), "cuda")

    upsample_alone(torch, upsample2x_align_corners)
    profiles(torch, upsample2x_align_corners, trainer_for, model,
             (imgs, labels))
    shifts(torch, upsample2x_align_corners, trainer_for, model,
           (imgs, labels))
    rates()
    print(f"upsample_probe took {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
