"""Build the port's native sources and load them with ctypes.

Each ``gan_aug_pfa_torch/csrc/<name>.cu`` (a CUDA kernel) or
``csrc/<name>.c`` (host code: the PNG unfilter) exposes a plain C
interface and builds into its own shared library under
``gan_aug_pfa_torch/_build/``, at first use, from the sources in the
checkout alone:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so \\
         csrc/<name>.cu
    cc -O3 -std=c11 -shared -fPIC -o _build/lib<name>-<hash>.so \\
         csrc/<name>.c

``-Xptxas -v`` makes the compiler's output name each kernel's registers,
shared memory and spills; ``build`` returns that output.  The host
compiler is ``$CC``, else ``cc`` on the ``PATH``.

The library name carries a hash of the source and the flags, so an edited
source builds anew.  ``build`` starts one compiler process for each source
at once; each writes a file of its own and renames it into place, so
processes that build the same library at once do not clash.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-O3", "-std=c11", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    """``csrc/<name>.cu``, or ``csrc/<name>.c`` for host code."""
    cuda = os.path.join(CSRC_DIR, name + ".cu")
    return cuda if os.path.exists(cuda) else os.path.join(CSRC_DIR,
                                                          name + ".c")


def _flags(name: str):
    return NVCC_FLAGS if source_path(name).endswith(".cu") else CC_FLAGS


def _library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def _cc() -> str:
    found = shutil.which(os.environ.get("CC") or "cc")
    if not found:
        raise RuntimeError("no host C compiler found (set CC or put cc on "
                           "the PATH)")
    return found


def _compiler(name: str) -> str:
    return _nvcc() if _flags(name) is NVCC_FLAGS else _cc()


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, all compiler
    processes at once.  Returns {name: compiler output}; raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if not os.path.exists(_library_path(n))]
    if not todo:
        return {}
    compilers = {name: _compiler(name) for name in todo}
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    try:
        for name in todo:
            lib = _library_path(name)
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[name] = (tmp, lib, subprocess.Popen(
                [compilers[name], *_flags(name), "-o", tmp,
                 source_path(name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs, failed = {}, []
        for name, (tmp, lib, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}: {compilers[name]} exited "
                              f"{proc.returncode}\n{logs[name]}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return logs
    finally:
        for tmp, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.c``, built on first
    use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(_library_path(name))
        return lib
