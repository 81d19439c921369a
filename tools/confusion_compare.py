#!/usr/bin/env python3
"""Device and call times of the confusion-counts kernel on one CUDA card,
beside another version of ``csrc/confusion_counts.cu``, in one process, so
that they compare on one card; and the new kernel under other launch
plans.

    python3 tools/confusion_compare.py --other OTHER.cu

``--other`` names a source of the earlier design with the C interface
``confusion_counts_f32(probs, targets, thr, B, HW, counts, stream)``, which
adds (B, 3) int32 [tp, P, T] into zeroed counts (for instance an older
commit's ``gan_aug_pfa_torch/csrc/confusion_counts.cu`` written out with
``git show``).  Its call path is what that commit's wrapper ran:
``torch.zeros`` of the counts, the kernel, and the derivation of
[tp, fp, fn, tn] in float32 (its ``_derive``, which the plain version
still uses).  This tree's call
path is ``confusion_counts_batch``.  At each shape of
``chip_smoke.CONFUSION_SHAPES`` both versions are first checked against
the plain version, then timed in turns (other, new, new, other): each bare
kernel and each call path back to back (``chip_smoke.time_ms``, CUDA
events over 200 calls) and inside a CUDA graph (``chip_smoke.graph_ms``,
20 calls a graph), beside the byte bound and ``torch.histc``.  Then the
plan sweep: graph times of this tree's kernel under other grids (threads a
block, blocks a sample), and with the counts in three int32 and a ticket
where the plan packs them into one 64-bit word, at each shape;
``--variants 4x4,2x8`` sweeps builds of this tree's source with other
constants beside it (groups a thread loads before it counts x resident
blocks an SM).  Run from the repository root.
"""

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import chip_smoke as cs  # noqa: E402
from focal_dice_compare import build_all, on_current  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import build  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc  # noqa: E402


def bind_other(so):
    fn = ctypes.CDLL(so).confusion_counts_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def other_calls(fn, p, t):
    """The other version's bare kernel (call(stream), adding into fixed
    counts) and its call path (a function returning the (B, 4) counts)."""
    b = p.shape[0]
    hw = p[0].numel()
    counts = torch.zeros((b, 3), dtype=torch.int32, device="cuda")

    def bare(stream):
        return fn(p.data_ptr(), t.data_ptr(), 0.5, b, hw, counts.data_ptr(),
                  stream)

    def path():
        c = torch.zeros((b, 3), dtype=torch.int32, device="cuda")
        err = fn(p.data_ptr(), t.data_ptr(), 0.5, b, hw, c.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"other kernel launch failed: {err}")
        return cc._derive(c, hw)

    return bare, path


def variant_source(src, unroll, blocks_per_sm):
    """This tree's source with other constants: groups a thread loads
    before it counts, and resident blocks an SM (the launch bounds and the
    cap on a sample's blocks)."""
    for old, new in (("constexpr int kUnroll = 2;",
                      f"constexpr int kUnroll = {unroll};"),
                     ("constexpr int kBlocksPerSM = 4;",
                      f"constexpr int kBlocksPerSM = {blocks_per_sm};")):
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def sweep(gen, kernels):
    """Graph times (us) of each built kernel ({name: (fn, blocks an SM)})
    under grids of 32 to 256 threads and about 66 to 132 x blocks-an-SM
    blocks in all, at each shape; and the plan's grid with the counts in
    three int32 and a ticket (``field_bits`` 0) where the plan packs them
    into one word."""
    for shape in cs.CONFUSION_SHAPES:
        p, t = cs.confusion_inputs(torch, shape, 0.5, gen)
        base = cc.plan_for(p, t)
        b = shape[0]
        ref = cc.confusion_counts_batch_reference(p, t)
        for name, (fn, per_sm) in kernels.items():
            plans = [base] if name == "new" else []
            if name == "new" and base.field_bits:
                plans.append(dataclasses.replace(base, field_bits=0))
            for threads in (32, 64, 128, 256):
                for total in (66, 132, 264, 528, 1056):
                    if total > cc.SMS * per_sm:
                        continue
                    blocks = max(1, round(total / b))
                    bits = (shape[1] * shape[2]).bit_length()
                    if 3 * bits + blocks.bit_length() > 64:
                        bits = 0
                    plan = cc.CountsPlan(threads, blocks, base.head,
                                         base.groups, bits,
                                         base.workspace_ints)
                    if plan not in plans:
                        plans.append(plan)
            for plan in plans:
                call, out = cs.confusion_call(torch, cc, p, t, fn=fn,
                                              plan=plan)
                if call(torch.cuda.current_stream().cuda_stream) != 0:
                    raise RuntimeError(f"launch failed: {name} {plan}")
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} {plan} != plain version")
                print(f"   sweep {shape} {name} threads {plan.threads:3d} "
                      f"blocks {plan.blocks:3d} a sample "
                      f"({b * plan.blocks:4d} in all) field_bits "
                      f"{plan.field_bits:2d}"
                      f"{' (plan)' if plan == base else ''}: "
                      f"{cs.graph_ms(torch, on_current(call)) * 1e3:.2f} us",
                      flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="source of the other version")
    ap.add_argument("--variants", default="",
                    help="comma-separated UNROLLxBLOCKS_PER_SM variants of "
                         "this tree's source to sweep beside it, e.g. 4x4,2x8")
    args = ap.parse_args()
    variants = [tuple(map(int, v.split("x")))
                for v in args.variants.split(",") if v]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with open(build.source_path(cc.NAME)) as f:
        srcs = {"new": f.read()}
    with open(args.other) as f:
        srcs["other"] = f.read()
    for unroll, per_sm in variants:
        srcs[f"{unroll}x{per_sm}"] = variant_source(srcs["new"], unroll,
                                                    per_sm)
    libs = build_all(srcs, tempfile.mkdtemp())
    new_fn = cc.bind(ctypes.CDLL(libs["new"]))
    other_fn = bind_other(libs["other"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in cs.CONFUSION_SHAPES:
        p, t = cs.confusion_inputs(torch, shape, 0.5, gen)
        b, hw = shape[0], shape[1] * shape[2]
        ref = cc.confusion_counts_batch_reference(p, t)
        new_bare, new_out = cs.confusion_call(torch, cc, p, t, fn=new_fn)
        other_bare, other_path = other_calls(other_fn, p, t)
        if new_bare(stream) != 0:
            raise RuntimeError("new kernel launch failed")
        for name, got in (("new", new_out), ("new path",
                                              cc.confusion_counts_batch(p, t)),
                          ("other path", other_path())):
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} != plain version at {shape}")
        codes = ((p > 0.5).float() * 2 + (t > 0.5).float()
                 + 4 * torch.arange(b, device="cuda").view(-1, 1, 1)
                 ).view(-1)

        def histc():
            return torch.histc(codes, bins=4 * b, min=0, max=4 * b)

        bound = cs.confusion_bound(b, hw)["bound_ms"]
        print(f"{shape}: both versions equal the plain version; bound "
              f"{bound * 1e3:.3f} us (bytes); plan {cc.plan_for(p, t)}")
        versions = {
            "other kernel": other_bare, "new kernel": new_bare,
            "other path": lambda s: other_path(),
            "new path": lambda s: cc.confusion_counts_batch(p, t),
        }
        for kind in ("kernel", "path"):
            for name in (f"other {kind}", f"new {kind}", f"new {kind}",
                         f"other {kind}"):
                fn = versions[name]
                graph = cs.graph_ms(torch, on_current(fn))
                b2b = cs.time_ms(torch, lambda fn=fn: fn(stream))
                print(f"== {shape} {name}: graph {graph * 1e3:.2f} us, "
                      f"back to back {b2b * 1e3:.2f} us", flush=True)
        print(f"== {shape} torch.histc: graph "
              f"{cs.graph_ms(torch, histc) * 1e3:.2f} us, back to back "
              f"{cs.time_ms(torch, histc) * 1e3:.2f} us", flush=True)
    kernels = {"new": (new_fn, cc.BLOCKS_PER_SM)}
    for unroll, per_sm in variants:
        name = f"{unroll}x{per_sm}"
        kernels[name] = (cc.bind(ctypes.CDLL(libs[name])), per_sm)
    sweep(gen, kernels)


if __name__ == "__main__":
    main()
