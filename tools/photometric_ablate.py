#!/usr/bin/env python3
"""Where the resident photometric kernel spends its time: device times
(CUDA graph) of variants of ``csrc/photometric.cu`` that each leave one
part out, at the training path's shapes, on one CUDA card.

    python3 tools/photometric_ablate.py

Each variant is the source with one text substitution, built with the
tree's nvcc flags into a temporary directory; a left-out part is guarded
by a condition the card never meets (``p.count < 0``), so the compiler
keeps the rest.  The variants compute wrong images and are timed only:
  base      the source as it is
  no_store  step 3 computes but stores nothing
  no_jitter step 3 blurs the unjittered rows (no in-place jitter pass)
  no_walk   step 3 jitters but does not blur or store
  no_sum    step 1 loads but does not sum
  no_step3  neither jitter nor blur nor store: launch, load, sum, barriers
  regs64    the resident kernel held to 64 registers (two blocks an SM)
Run from the repository root.
"""

import ctypes
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

STORE = ("        if (live) blur_store<kNative>(g, p, v, x0, out + c * "
         "bd.plane);")
JITTER = ("      jitter_slots(bd, g, p, mean, 0, bd.y1 - bd.y0 + 2);\n"
          "      __syncthreads();\n")
WALK = "      walk_band<kNative>(bd, g, p);\n"
SUM = ("  if (kResident && bd.s1 > bd.s0) acc = resident_sum(bd, g, p, "
       "n_pre);")
BOUNDS = "__launch_bounds__(kMaxThreads, kResident ? 1 : 2)"


def variants(src):
    def sub(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old!r}")
        return text.replace(old, new)

    guarded_walk = "      if (p.count < 0.0f) walk_band<kNative>(bd, g, p);\n"
    no_walk = sub(src, WALK, guarded_walk)
    return {
        "base": src,
        "no_store": sub(src, STORE, STORE.replace(
            "if (live)", "if (live && p.count < 0.0f)")),
        "no_jitter": sub(src, JITTER, ""),
        "no_walk": no_walk,
        "no_sum": sub(src, SUM, SUM.replace(
            "bd.s1 > bd.s0", "bd.s1 > bd.s0 && p.count < 0.0f")),
        "no_step3": sub(no_walk, JITTER, ""),
        "regs64": sub(src, BOUNDS, "__launch_bounds__(kMaxThreads, 2)"),
    }


def build_all(srcs, out_dir):
    """Every variant built at once; {name: (library, ptxas lines)}."""
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for fn_name in ("photometric_native_f32", "photometric_flip_f32"):
            fn = getattr(lib, fn_name)
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p] * 2)
            fn.restype = ctypes.c_int
        libs[name] = (lib, [line.strip() for line in log.splitlines()
                            if "registers" in line or "spill" in line])
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with open(build.source_path(ph.NAME)) as f:
        libs = build_all(variants(f.read()), tempfile.mkdtemp())
    for name, (_, lines) in libs.items():
        print(name, lines)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for kind, shape, ext in (
            ("native", (4, 3, 392, 400),
             [[392, 400], [200, 399], [317, 262], [255, 203]]),
            ("native", (4, 3, 392, 400), [[392, 400]] * 4),
            ("flip", (4, 3, 128, 128), None)):
        b, _, hp, wp = shape
        x = torch.rand(shape, generator=gen, device="cuda")
        rows = cs.photometric_rows(torch, b, 3, ext)
        out = torch.empty_like(x)
        plan = ph.plan_launch(b, hp, wp)
        res = []
        for _ in range(2):
            for name, (lib, _) in libs.items():
                fn = (lib.photometric_native_f32 if kind == "native"
                      else lib.photometric_flip_f32)

                def call(fn=fn):
                    return fn(x.data_ptr(), rows.data_ptr(), b, hp, wp,
                              *plan.c_args(), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
                if call() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                res.append(f"{name} {cs.graph_ms(torch, call) * 1e3:.2f}")
        print(f"== {kind} {shape} extents {ext and ext[:2]} us (graph): "
              + ", ".join(res), flush=True)


if __name__ == "__main__":
    main()
