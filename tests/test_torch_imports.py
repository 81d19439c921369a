"""Import hygiene of the port: no module of ``gan_aug_pfa_torch`` and not
``chip_smoke.py`` brings in JAX, Flax, the JAX package, PIL, the
``msgpack`` package or matplotlib (the card's machine has none of them;
the port reads ``.msgpack`` files with its own decoder, and imports
matplotlib only inside ``utils/viz.visualize_sample``), and the entry
points never fall back to the CPU on their own."""

import os
import subprocess
import sys

import pytest
import torch

from gan_aug_pfa_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import gan_aug_pfa_torch
names = [m.name for m in pkgutil.walk_packages(
    gan_aug_pfa_torch.__path__, "gan_aug_pfa_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "gan_aug_pfa_tpu", "PIL", "msgpack",
              "matplotlib"))
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax_flax_jax_package_or_pil():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, _, bad = proc.stdout.strip().splitlines()[-1].partition(" ")
    assert int(count) >= 15  # every module of the package was imported
    assert bad == "", f"forbidden modules imported: {bad}"


def test_resolve_device_never_falls_back_to_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for name in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(name)
