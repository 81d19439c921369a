#!/usr/bin/env python3
"""Device times of the fused FocalDice kernels on one CUDA card, beside
another version of ``csrc/focal_dice_loss.cu`` and beside a variant of this
tree's source without special functions, in one process, so that they
compare on one card; and the SASS instructions of each kernel's inner loop
per element.

    python3 tools/focal_dice_compare.py [--other OTHER.cu] [--sweep]

``--other`` names a source of the two-launch design with the C interface
``focal_dice_fwd_scratch_floats(n)``, ``focal_dice_fwd_f32(x, t, n, beta,
gamma, alpha, smooth, loss, sums, partials, stream)`` and
``focal_dice_bwd_f32(x, t, sums, grad, n, beta, gamma, alpha, smooth, dx,
stream)`` (for instance an older commit's
``gan_aug_pfa_torch/csrc/focal_dice_loss.cu`` written out with ``git
show``); it takes float32 logits only.  The variant ``no_sfu`` is this
tree's source with the approximate exp2, log2 and reciprocal replaced by a
copy of their argument: it keeps the loads, the arithmetic around them, the
sums and the stores, computes wrong values and is timed only; it shows the
memory floor.  At 4x1x128x128, 4x1x512x512 and 16x1x1024x1024 each version
is first checked against the plain version (except ``no_sfu``), then timed
in two rounds: back to back (``chip_smoke.time_ms``) and in a CUDA graph
(``chip_smoke.graph_ms``).  The SASS counts come from ``cuobjdump -sass``
of each built library: for each kernel the loop that reads the inputs, its
instructions (NOPs left out) and special-function instructions (MUFU),
divided by the elements an iteration takes.  ``--sweep`` adds graph
times of this tree's kernels under other grids (threads a block, blocks
in all) at 4x1x128x128 and 16x1x1024x1024.  Run from the repository
root.
"""

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import build  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import fused_loss as fl  # noqa: E402

SHAPES = [(4, 1, 128, 128), (4, 1, 512, 512), (16, 1, 1024, 1024)]
# Thread instructions the card starts a second: 4 schedulers of 32 lanes
# on each of 132 SMs at the 1,980 MHz boost clock.
INSTRUCTIONS_PER_S = 4 * 32 * 132 * 1.98e9
SFU_ASM = {
    'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));': "y = x;",
    'asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));': "y = x;",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));': "y = x;",
}


def no_sfu_source(src):
    for old, new in SFU_ASM.items():
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build_all(srcs, out_dir):
    """Every source built at once with this tree's nvcc flags; {name:
    library path}."""
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}:\n{log}")
        print(f"{name}: " + "; ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line))
        libs[name] = so
    return libs


def bind_other(so):
    lib = ctypes.CDLL(so)
    lib.focal_dice_fwd_scratch_floats.argtypes = [ctypes.c_longlong]
    lib.focal_dice_fwd_scratch_floats.restype = ctypes.c_int
    lib.focal_dice_fwd_f32.argtypes = ([ctypes.c_void_p] * 2
                                       + [ctypes.c_longlong]
                                       + [ctypes.c_float] * 4
                                       + [ctypes.c_void_p] * 4)
    lib.focal_dice_bwd_f32.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_longlong]
                                       + [ctypes.c_float] * 4
                                       + [ctypes.c_void_p] * 2)
    lib.focal_dice_fwd_f32.restype = ctypes.c_int
    lib.focal_dice_bwd_f32.restype = ctypes.c_int
    return lib


def other_calls(lib, xf, tf):
    """The other version's bare C calls, as ``chip_smoke.loss_calls``
    gives this tree's: (fwd(stream), bwd(stream), loss, dx, g)."""
    hyper = (cs.LOSS_KW["beta"], cs.GAMMAS[0], cs.LOSS_KW["focal_alpha"],
             cs.LOSS_KW["dice_smooth"])
    n = xf.numel()
    loss = torch.empty((), device="cuda")
    buf = torch.empty(4 + lib.focal_dice_fwd_scratch_floats(n),
                      device="cuda")
    dx = torch.empty_like(xf)
    g = torch.full((), 0.73, device="cuda")

    def fwd(stream):
        return lib.focal_dice_fwd_f32(xf.data_ptr(), tf.data_ptr(), n,
                                      *hyper, loss.data_ptr(), buf.data_ptr(),
                                      buf[4:].data_ptr(), stream)

    def bwd(stream):
        return lib.focal_dice_bwd_f32(xf.data_ptr(), tf.data_ptr(),
                                      buf.data_ptr(), g.data_ptr(), n, *hyper,
                                      dx.data_ptr(), stream)

    return fwd, bwd, loss, dx, g


def on_current(fn):
    """``fn`` launched on the stream current at each call (in a graph's
    capture, the capturing one)."""
    return lambda: fn(torch.cuda.current_stream().cuda_stream)


# -- SASS ------------------------------------------------------------------

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_PRED = re.compile(r"^@!?U?P\w+\s+")


def _opcode(insn):
    return _PRED.sub("", insn).split()[0]


def _width(op):
    parts = op.split(".")
    for bits, size in (("128", 16), ("64", 8), ("U16", 2), ("S16", 2),
                       ("U8", 1), ("S8", 1)):
        if bits in parts:
            return size
    return 4


def sass_functions(text):
    """{function name: [(address, instruction), ...]} of cuobjdump -sass
    output."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _INSN.search(line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def input_loop(insns, elem_bytes):
    """The loop (a backward branch's span) that loads the most input
    bytes: its instructions, MUFU, elements an iteration, and branches
    inside it other than its own."""
    best = None
    for addr, insn in insns:
        if _opcode(insn) != "BRA":
            continue
        targets = re.findall(r"0x([0-9a-f]+)", insn)
        if not targets or int(targets[-1], 16) > addr:
            continue
        lo = int(targets[-1], 16)
        body = [i for a, i in insns if lo <= a <= addr
                and _opcode(i) != "NOP"]
        ops = [_opcode(i) for i in body]
        loaded = sum(_width(op) for op in ops if op.startswith("LDG"))
        stored = sum(_width(op) for op in ops if op.startswith("STG"))
        stat = {"instructions": len(body),
                "mufu": sum(op.startswith("MUFU") for op in ops),
                "load_bytes": loaded, "store_bytes": stored,
                "elements": loaded / elem_bytes,
                "inner_branches": sum(op == "BRA" for op in ops) - 1}
        if best is None or (loaded, -len(body)) > (best["load_bytes"],
                                                    -best["instructions"]):
            best = stat
    return best


def print_sass(name, so):
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    for fn, insns in sorted(sass_functions(text).items()):
        if "finalize" in fn:
            continue
        bf16 = "bfloat16" in fn
        backward = "bwd" in fn
        elem_bytes = 6 if bf16 else 8
        loop = input_loop(insns, elem_bytes)
        if not loop or not loop["elements"]:
            print(f"SASS {name} {fn}: no input loop found")
            continue
        per = loop["instructions"] / loop["elements"]
        budget = INSTRUCTIONS_PER_S * (elem_bytes + (elem_bytes - 4 if backward
                                              else 0)) / cs.HBM_BYTES_PER_S
        kind = ("bwd" if backward else "fwd") + (" bf16" if bf16 else " f32")
        print(f"SASS {name} {kind}: loop of {loop['instructions']} "
              f"instructions, {loop['mufu']} MUFU, {loop['elements']:g} "
              f"elements an iteration ({loop['load_bytes']} B loaded, "
              f"{loop['store_bytes']} B stored, {loop['inner_branches']} "
              f"branches inside): {per:.1f} instructions and "
              f"{loop['mufu'] / loop['elements']:.2f} MUFU an element; "
              f"budget at the byte bound {budget:.0f} ({fn[-60:]})")


# -- timing ----------------------------------------------------------------


def sweep(kernels, gen):
    """Graph times (us) of forward and backward under other grids: at the
    train shape every block size with a group a thread, at 16M elements
    128 and 256 threads with 1 to 4 blocks an SM."""
    for shape, grids in (
            ((4, 1, 128, 128), [(th, None) for th in (32, 64, 128, 256)]),
            ((16, 1, 1024, 1024), [(th, k * fl.SMS) for th in (128, 256)
                                   for k in (1, 2, 3, 4)])):
        for dtype in cs.LOSS_DTYPES:
            x, t = cs.loss_inputs(torch, shape, gen, dtype=dtype)
            xf, tf = x.reshape(-1), t.reshape(-1)
            base = fl.plan_for(xf, tf)
            for threads, blocks in grids:
                blocks = min(blocks or fl.MAX_BLOCKS,
                             -(-base.groups // threads))
                plan = fl.LossPlan(threads, blocks, base.head, base.groups)
                fwd, bwd, _, _, _ = cs.loss_calls(torch, fl, xf, tf,
                                                  kernels, plan)
                fwd, bwd = on_current(fwd), on_current(bwd)
                if fwd() != 0 or bwd() != 0:
                    raise RuntimeError(f"launch failed: {plan}")
                print(f"   sweep {shape} {dtype} threads {threads:3d} blocks "
                      f"{blocks:4d}{' (plan)' if plan == base else ''}: fwd "
                      f"{cs.graph_ms(torch, fwd) * 1e3:.2f} us, bwd "
                      f"{cs.graph_ms(torch, bwd) * 1e3:.2f} us", flush=True)


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
    with open(build.source_path(fl.NAME)) as f:
        src = f.read()
    srcs = {"new": src, "no_sfu": no_sfu_source(src)}
    if args.other:
        with open(args.other) as f:
            srcs["other"] = f.read()
    libs = build_all(srcs, tempfile.mkdtemp())
    for name, so in libs.items():
        print_sass(name, so)

    kernels = {name: fl.bind(ctypes.CDLL(libs[name]))
               for name in ("new", "no_sfu")}
    other = bind_other(libs["other"]) if args.other else None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        versions = {}
        for dtype in cs.LOSS_DTYPES:
            x, t = cs.loss_inputs(torch, shape, gen, dtype=dtype)
            xf, tf = x.reshape(-1), t.reshape(-1)
            for name, pair in kernels.items():
                fwd, bwd, out, dx, g = cs.loss_calls(torch, fl, xf, tf, pair)
                versions[f"{name} {dtype}"] = (fwd, bwd, out[0], dx, g,
                                               xf, tf)
            if other is not None and dtype == "float32":
                versions["other float32"] = (*other_calls(other, xf, tf),
                                             xf, tf)
        for name, (fwd, bwd, loss, dx, g, xf, tf) in versions.items():
            if fwd(stream) != 0 or bwd(stream) != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            if name.startswith("no_sfu"):
                continue
            dloss, ddx, excess, tol, _, ok = cs.loss_errors(
                torch, fl, xf, tf, cs.GAMMAS[0], loss, dx, g)
            print(f"{name} {shape}: |dloss| {dloss:.2e}, max|ddx| "
                  f"{ddx:.2e} (beyond a bf16 step {excess:.2e}, tol "
                  f"{tol:.2e}) {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"{name} != plain version at {shape}")
        n = versions["new float32"][5].numel()
        for dtype, x_bytes in (("float32", 4), ("bfloat16", 2)):
            print(f"bound {shape} {dtype}: fwd "
                  f"{cs.loss_bound(n, x_bytes, False)['bound_ms'] * 1e3:.2f}"
                  f" us, bwd "
                  f"{cs.loss_bound(n, x_bytes, True)['bound_ms'] * 1e3:.2f}"
                  f" us")
        for rnd in range(2):
            for name, (fwd, bwd, *_) in versions.items():
                res = []
                for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                    graph = cs.graph_ms(torch, on_current(fn))
                    b2b = cs.time_ms(torch, lambda fn=fn: fn(stream),
                                     iters=100)
                    res.append(f"{kind} graph {graph * 1e3:.2f} back to "
                               f"back {b2b * 1e3:.2f}")
                print(f"== round {rnd} {shape} {name} us: "
                      + ", ".join(res), flush=True)
    if args.sweep:
        sweep(kernels["new"], gen)


if __name__ == "__main__":
    main()
