"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``gan_aug_pfa_torch/csrc/<name>.cu`` exposes a plain C interface and
builds into its own shared library under ``gan_aug_pfa_torch/_build/``, at
first use, from the sources in the checkout alone:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so \\
         csrc/<name>.cu

``-Xptxas -v`` makes the compiler's output name each kernel's registers,
shared memory and spills; ``build`` returns that output.

The library name carries a hash of the source and the flags, so an edited
source builds anew.  ``build`` starts one ``nvcc`` for each source at once.  Nothing here
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

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes at once.  Returns {name: compiler output}; raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if not os.path.exists(_library_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    try:
        for name in todo:
            lib = _library_path(name)
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[name] = (tmp, lib, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs, failed = {}, []
        for name, (tmp, lib, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{logs[name]}")
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
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(_library_path(name))
        return lib
