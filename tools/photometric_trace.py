#!/usr/bin/env python3
"""Per-phase device timestamps of the photometric kernel on one CUDA card:
an instrumented copy of ``csrc/photometric.cu`` in which thread 0 of each
block reads ``%globaltimer`` at the end of each phase, launched at the
timing shapes of ``chip_smoke.py`` (the fifth launch is read).

    python3 tools/photometric_trace.py

Prints, for each shape and plan, the span of the launch, the spread of the
blocks' starts and ends, and the mean and largest time of each phase over
the blocks: step 1 (load and sum), the block reduction, the first cluster
barrier, the mean through distributed shared memory, step 3 (jitter, blur,
store) and the last cluster barrier.  Run from the repository root.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import build  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import photometric as ph  # noqa: E402

STAMPS = 8
PHASES = [(0, 1, "step 1 (load, sum)"), (1, 2, "block reduce"),
          (2, 3, "cluster barrier"), (3, 4, "mean (DSMEM)"),
          (4, 5, "step 3 (jitter, blur, store)"), (5, 6, "cluster wait"),
          (0, 6, "block total")]
CASES = [("native", (4, 3, 392, 400),
          [[392, 400], [200, 399], [317, 262], [255, 203]]),
         ("native", (1, 3, 392, 400), [[392, 400]]),
         ("flip", (4, 3, 128, 128), None),
         ("native", (16, 3, 1024, 1024), [[1024, 1024]] * 16)]


def instrument(src):
    """The source with a stamp at each phase end and a setter for the
    stamp buffer."""
    def stamp(k):
        return ("  if (threadIdx.x == 0 && g_trace) { unsigned long long t; "
                "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
                f"g_trace[blockIdx.x * {STAMPS} + {k}] = t; }}\n")

    def at(text, anchor, code, before=True):
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        return text.replace(anchor, code + anchor if before
                            else anchor + "\n" + code)

    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned "
                      "long long* g_trace;\n", 1)
    src = at(src, "  cg::cluster_group cluster = cg::this_cluster();",
             stamp(0))
    src = at(src, "  // Fixed shuffle trees: warps", stamp(1))
    src = at(src, "  // 2. The image's mean", stamp(2))
    src = at(src, "  cluster.sync();", stamp(3), before=False)
    src = at(src, "  // 3. The jitter, the blur and the store.", stamp(4))
    src = at(src, "  cluster_wait();  // no peer reads", stamp(5))
    src = at(src, "  cluster_wait();  // no peer reads this block's slot any "
             "more", stamp(6), before=False)
    return src + ('\nextern "C" int photometric_set_trace(void* p) { return '
                  'cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }\n')


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out_dir = tempfile.mkdtemp()
    cu, so = (os.path.join(out_dir, n) for n in ("trace.cu", "libtrace.so"))
    with open(build.source_path(ph.NAME)) as f, open(cu, "w") as g:
        g.write(instrument(f.read()))
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(so)
    lib.photometric_set_trace.argtypes = [ctypes.c_void_p]
    for name in ("photometric_native_f32", "photometric_flip_f32"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for kind, shape, ext in CASES:
        b, _, hp, wp = shape
        x = torch.rand(shape, generator=gen, device="cuda")
        rows = cs.photometric_rows(torch, b, 3, ext)
        out = torch.empty_like(x)
        fn = (lib.photometric_native_f32 if kind == "native"
              else lib.photometric_flip_f32)
        plan = ph.plan_launch(b, hp, wp)
        trace = torch.zeros(plan.grid * STAMPS, dtype=torch.int64,
                            device="cuda")
        lib.photometric_set_trace(trace.data_ptr())
        for _ in range(5):
            trace.zero_()
            torch.cuda.synchronize()
            if fn(x.data_ptr(), rows.data_ptr(), b, hp, wp, *plan.c_args(),
                  out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream) != 0:
                raise RuntimeError(f"launch failed: {plan}")
            torch.cuda.synchronize()
        t = trace.view(plan.grid, STAMPS).cpu().numpy().astype(np.float64)
        t0 = t[:, 0].min()
        ends = (t[:, 6] - t0) / 1e3
        print(f"== {kind} {shape} {plan}: span {ends.max():.2f} us, block "
              f"starts spread {(t[:, 0].max() - t0) / 1e3:.2f} us, ends "
              f"min {ends.min():.2f} median {np.median(ends):.2f} max "
              f"{ends.max():.2f} us", flush=True)
        for k1, k2, name in PHASES:
            d = (t[:, k2] - t[:, k1]) / 1e3
            print(f"   {name:30s} mean {d.mean():8.2f} max {d.max():8.2f} us")
        lib.photometric_set_trace(None)


if __name__ == "__main__":
    main()
