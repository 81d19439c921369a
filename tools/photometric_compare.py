#!/usr/bin/env python3
"""Device times of the photometric kernels on one CUDA card, each launch
plan beside another version of ``csrc/photometric.cu`` built from a given
source, in one process, so that the two compare on one card.

    python3 tools/photometric_compare.py [--other OTHER.cu] [--sweep]

``--other`` names a source of the two-launch design with the C interface
``photometric_scratch_floats(b, hp, wp)``, ``photometric_{native,flip}_f32(x,
params, b, hp, wp, partials, out, stream)`` (for instance an older commit's
``gan_aug_pfa_torch/csrc/photometric.cu`` written out with ``git show``);
without it only this tree's kernels are timed.  Times are CUDA-graph
replays (``chip_smoke.graph_ms``), the default plan beside the plan split
over 1, 2 and 4 clusters an image, each checked against the plain version
first.  ``--sweep`` adds back-to-back times of streamed plans (ring slots,
threads, cluster size) at 16x3x1024x1024.  Run from the repository root.
"""

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import build  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import photometric as ph  # noqa: E402

CASES = [
    ("native", (4, 3, 392, 400), [[392, 400], [200, 399], [317, 262],
                                  [255, 203]]),
    ("native", (3, 3, 392, 400), [[392, 400], [200, 399], [317, 262]]),
    ("native", (2, 3, 392, 400), [[392, 400], [200, 399]]),
    ("native", (1, 3, 392, 400), [[392, 400]]),
    ("flip", (4, 3, 128, 128), None),
    ("flip", (3, 3, 128, 128), None),
    ("flip", (1, 3, 128, 128), None),
]


def load_other(src, out_dir):
    """The other version's library, built with this tree's nvcc flags."""
    so = os.path.join(out_dir, "libphotometric_other.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(so)
    lib.photometric_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.photometric_scratch_floats.restype = ctypes.c_int
    for name in ("photometric_native_f32", "photometric_flip_f32"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return lib


def with_split(plan, split, wp):
    """The resident plan with ``split`` clusters an image."""
    row = 3 * 4 * 4 * (-(-wp // 4))
    slots = -(-plan.band_rows // split) + 2
    return dataclasses.replace(plan, split=split, slots=slots,
                               smem_bytes=slots * row,
                               grid=plan.grid // plan.split * split)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="source of the other version")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    tmp = tempfile.mkdtemp()
    other = load_other(args.other, tmp) if args.other else None
    native_fn, flip_fn, _ = ph._kernels()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for kind, shape, ext in CASES:
        native = kind == "native"
        b, _, hp, wp = shape
        x = torch.rand(shape, generator=gen, device="cuda")
        rows = cs.photometric_rows(torch, b, 3, ext)
        out, yard = torch.empty_like(x), torch.empty_like(x)
        ref = (ph.photometric_native_reference if native
               else ph.photometric_flip_reference)(x, rows)
        extents = ext or [[hp, wp]] * b
        plan = ph.plan_launch(b, hp, wp)
        plans = {f"plan(split {plan.split})": plan}
        for split in (1, 2, 4):
            if split != plan.split and split <= plan.band_rows:
                plans[f"split {split}"] = with_split(plan, split, wp)
        fn = native_fn if native else flip_fn
        res = []
        for _ in range(2):
            if other is not None:
                old = (other.photometric_native_f32 if native
                       else other.photometric_flip_f32)
                partials = torch.empty(
                    other.photometric_scratch_floats(b, hp, wp),
                    device="cuda")
                t = cs.graph_ms(torch, lambda: old(
                    x.data_ptr(), rows.data_ptr(), b, hp, wp,
                    partials.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream))
                res.append(f"other {t * 1e3:.2f}")
            for name, pl in plans.items():
                def call(pl=pl):
                    return fn(x.data_ptr(), rows.data_ptr(), b, hp, wp,
                              *pl.c_args(), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
                if call() != 0:
                    raise RuntimeError(f"launch failed: {pl}")
                torch.cuda.synchronize()
                err = max(float((out[i, :, :h, :w]
                                 - ref[i, :, :h, :w]).abs().max())
                          for i, (h, w) in enumerate(extents))
                if err > cs.PHOTOMETRIC_ATOL:
                    raise AssertionError(f"{name}: error {err}")
                res.append(f"{name} {cs.graph_ms(torch, call) * 1e3:.2f}")
        res.append("torch.mul "
                   f"{cs.graph_ms(torch, lambda: torch.mul(x, 1.5, out=yard)) * 1e3:.2f}")
        print(f"== {kind} {shape} us (graph): " + ", ".join(res), flush=True)
    if args.sweep:
        sweep(native_fn, flip_fn, gen)


def sweep(native_fn, flip_fn, gen):
    """Back-to-back times of streamed plans at 16x3x1024x1024."""
    b, hp, wp = 16, 1024, 1024
    row = 3 * 4 * wp
    bound = cs.photometric_bound([[hp, wp]] * b, True)["bound_ms"] * 1e3
    x = torch.rand((b, 3, hp, wp), generator=gen, device="cuda")
    rows = cs.photometric_rows(torch, b, 3, [[hp, wp]] * b)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    for kind, fn in (("native", native_fn), ("flip", flip_fn)):
        for cluster in (8, 16):
            band = -(-hp // cluster)
            for threads in (128, 256, 512):
                for slots in (4, 5, 6, 8):
                    plan = ph.LaunchPlan("streamed", threads, cluster, 1,
                                         band, slots, slots * row,
                                         b * cluster)
                    act = ph.active_clusters(kind == "native", b, hp, wp,
                                             plan)
                    t = cs.time_ms(torch, lambda: fn(
                        x.data_ptr(), rows.data_ptr(), b, hp, wp,
                        *plan.c_args(), out.data_ptr(), stream),
                        iters=50) * 1e3
                    print(f"   {kind} streamed C={cluster:2d} T={threads:3d} "
                          f"slots={slots} clusters at once={act:3d}: "
                          f"{t:8.2f} us ({100 * bound / t:.1f}% of bound)",
                          flush=True)


if __name__ == "__main__":
    main()
