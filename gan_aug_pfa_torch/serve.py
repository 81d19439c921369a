"""Serving artifacts: a trained model as one self-contained file (the JAX
package's ``serve.py``, exported with ``torch.export`` in place of
``jax.export``).

  * The weights are in the artifact, so one file is the whole deployable.
    Loading needs torch and this module, not the package's model code.
  * The batch dimension is a ``torch.export.Dim`` (unless ``batch_size``
    fixes it), so one artifact serves any batch size from 1 to
    ``MAX_BATCH``.  An exported program runs op by op, with no per-shape
    compile.
  * The platforms (``cuda``, ``cpu``) are recorded and checked at load.
    The weights are saved on the CPU, and the loader moves them to the
    device.

Exported callables, the JAX package's boundary contract: NHWC float32 in
and out.  The NHWC<->NCHW permutes are inside the program.

  arch ``siamese``        (img1, img2) in [-1, 1] -> sigmoid probabilities
                          (B, H, W, 1), the evaluation path's output.
  arch ``generator``      img1 in [0, 1] -> fake img2 in [0, 1]: the
                          normalize -> G -> x*0.5+0.5 of
                          ``train/gan.generate``.
  arch ``discriminator``  (a, b) in [-1, 1] -> patch logits (B, h', w', 1)
                          through a channel concat.

The compute dtype is recorded in the header.  A bfloat16 program is
exported under autocast and decomposed to core ATen ops, so its casts are
explicit ops of the graph and run the same on either device.  A float32
program runs with TF32 off (``device.tf32_off``): the flag is process
wide and not part of the graph.  ``export_model_quantized`` keeps the
int8 weights and their float32 scales as buffers of the program, and its
forward dequantizes them (``quantize.dequantize_array``) and runs the
model through ``torch.func.functional_call``, so device memory holds the
weights as int8.

File format: a ``torch.export.save`` archive (``.pt2``) with the JSON
header as its extra file ``header.json``.  A JAX package artifact (magic
``GAPTPUX1``) is refused with a message that says so.  The JAX package's
executable sidecar (``--aot-batch-sizes``, ``aot="require"``) has no
counterpart yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import zipfile
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from . import quantize as qz
from .data.transforms import normalize
from .device import resolve_device, tf32_off

MAGIC = b"GAPTORX1"
JAX_MAGIC = b"GAPTPUX1"
FORMAT_VERSION = 1
HEADER_FILE = "header.json"

ARCHS = ("siamese", "generator", "discriminator")
PLATFORMS = ("cuda", "cpu")
AOT_POLICIES = ("auto", "never", "require")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The dynamic batch's upper end.  CUDA kernels guard their grid's y and z
# extents (at most 65535), and the Siamese encoder runs 2B images, so the
# export on the card must bound the batch below 32768.
MAX_BATCH = 16384

# Checkpoint stem -> arch, per the reference's file naming (train.py:
# 307-321, train_gan.py:149-154).
_STEM_HINTS = (
    ("generator", "generator"),
    ("discriminator", "discriminator"),
    ("best_model", "siamese"),
    ("model_epoch", "siamese"),
)


def arch_from_stem(path: str) -> Optional[str]:
    stem = os.path.basename(path)
    for hint, arch in _STEM_HINTS:
        if hint in stem:
            return arch
    return None


# ---------------------------------------------------------------------------
# the exported modules


def _build_model(arch: str, n_channels: int,
                 arch_kwargs: Optional[Dict[str, Any]] = None) -> nn.Module:
    """The eval-mode model of ``arch``; ``arch_kwargs`` are the GAN's
    architecture knobs (num_downs/ngf, ndf/n_layers).  The Siamese net runs
    its batched encoder, which computes the two-pass form's eval-mode
    function in one pass over 2B images."""
    from .models import NLayerDiscriminator, SiameseUNet, UNetGenerator

    kw = dict(arch_kwargs or {})
    if arch == "siamese":
        model = SiameseUNet(n_channels=n_channels, batched_encoder=True, **kw)
    elif arch == "generator":
        model = UNetGenerator(n_channels, n_channels, **kw)
    elif arch == "discriminator":
        model = NLayerDiscriminator(input_nc=2 * n_channels, **kw)
    else:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    return model.eval()


class ServingModule(nn.Module):
    """``model`` behind the boundary contract of ``arch``, computing in
    ``compute_dtype`` (bfloat16: autocast on ``device_type``)."""

    def __init__(self, arch: str, model: nn.Module, compute_dtype: str,
                 device_type: str):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{tuple(COMPUTE_DTYPES)}, got {compute_dtype!r}")
        self.arch, self.model = arch, model
        self.compute_dtype, self.device_type = compute_dtype, device_type

    def _autocast(self):
        if self.compute_dtype == "bfloat16":
            return torch.autocast(self.device_type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        if self.arch == "siamese":
            x1, x2 = (x.permute(0, 3, 1, 2) for x in inputs)
            with self._autocast():
                logits = self.model(x1, x2)
            return torch.sigmoid(logits.float()).permute(0, 2, 3, 1)
        if self.arch == "generator":
            x = normalize(inputs[0].permute(0, 3, 1, 2))
            with self._autocast():
                fake = self.model(x)
            return (fake.float() * 0.5 + 0.5).permute(0, 2, 3, 1)
        x = torch.cat(inputs, dim=-1).permute(0, 3, 1, 2)
        with self._autocast():
            logits = self.model(x)
        return logits.float().permute(0, 2, 3, 1)


class DequantizingModule(nn.Module):
    """``inner`` with its quantized parameters replaced by int8 buffers and
    float32 scales (``qtree``'s, keyed by ``inner.state_dict()`` names).
    The forward dequantizes each to ``dtype`` and calls ``inner`` with
    them."""

    def __init__(self, inner: nn.Module, qtree: Mapping[str, Any],
                 dtype: torch.dtype):
        super().__init__()
        self.inner, self.dtype = inner, dtype
        self.keys = [k for k, node in qtree.items() if qz.is_qleaf(node)]
        for i, key in enumerate(self.keys):
            owner, _, name = key.rpartition(".")
            # Gone from ``inner``, so the program holds no float copy.
            del inner.get_submodule(owner)._parameters[name]
            self.register_buffer(f"q8_{i}", qtree[key][qz.QKEY])
            self.register_buffer(f"q8_scale_{i}", qtree[key][qz.SKEY])

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        weights = {key: qz.dequantize_array(
            {qz.QKEY: getattr(self, f"q8_{i}"),
             qz.SKEY: getattr(self, f"q8_scale_{i}")}, self.dtype)
            for i, key in enumerate(self.keys)}
        return torch.func.functional_call(self.inner, weights, inputs)


@dataclasses.dataclass
class Exported:
    """An exported program (its weights on the CPU), the platforms it may
    be loaded on and the dtype it computes in."""

    program: torch.export.ExportedProgram
    platforms: Tuple[str, ...]
    compute_dtype: str


def _check_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r} is not one of {PLATFORMS}; the "
                             "JAX package's serve.py exports for tpu")
    return tuple(platforms)


def _export(module: ServingModule, height: int, width: int,
            n_channels: int, batch_size: Optional[int],
            platforms: Optional[Sequence[str]], dev: torch.device,
            outer: Optional[nn.Module] = None) -> Exported:
    """Export ``outer`` (default ``module``, the ServingModule inside it)
    on ``dev``."""
    platforms = _check_platforms(platforms or (dev.type,))
    top = (outer or module).to(dev).eval().requires_grad_(False)
    n_inputs = 1 if module.arch == "generator" else 2
    # Distinct sample tensors, batch >= 2: export traces one tensor passed
    # twice as one input, and specializes a batch of 1.
    gen = torch.Generator().manual_seed(0)
    sample = tuple(
        torch.rand((batch_size or 2, height, width, n_channels),
                   generator=gen).to(dev) for _ in range(n_inputs))
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
        # One entry, for the forward's ``*inputs``.
        dynamic = (tuple({0: batch} for _ in range(n_inputs)),)
    program = torch.export.export(top, sample, dynamic_shapes=dynamic,
                                  strict=False).run_decompositions()
    from torch.export.passes import move_to_device_pass

    return Exported(move_to_device_pass(program, "cpu"), platforms,
                    module.compute_dtype)


def export_model(
    arch: str,
    state_dict: Mapping[str, torch.Tensor],
    height: int,
    width: int,
    *,
    n_channels: int = 3,
    batch_size: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    compute_dtype: str = "float32",
    arch_kwargs: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> Exported:
    """Export ``arch`` with the weights of ``state_dict`` (strict) on
    ``device``.  batch_size=None exports a dynamic batch; platforms=None
    records ``device``'s type alone."""
    dev = resolve_device(device)
    model = _build_model(arch, n_channels, arch_kwargs)
    model.load_state_dict(state_dict, strict=True)
    module = ServingModule(arch, model, compute_dtype, dev.type)
    return _export(module, height, width, n_channels, batch_size, platforms,
                   dev)


def export_model_quantized(
    arch: str,
    state_dict: Mapping[str, torch.Tensor],
    height: int,
    width: int,
    *,
    n_channels: int = 3,
    batch_size: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    compute_dtype: str = "float32",
    min_elems: Optional[int] = None,
    arch_kwargs: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> Tuple[Exported, Dict[str, Any], Dict[str, int]]:
    """Export with weight-only int8 quantization (``quantize.py``).

    Returns (exported, qtree, report): qtree is ``quantize_tree``'s output
    over the model's ``state_dict`` (its int8 tensors and scales are the
    program's buffers), report its tensor and byte counts (the CLI records
    it in the header).  Quantized weights are dequantized straight to the
    compute dtype, the multiply in float32 (``dequantize_array``)."""
    dev = resolve_device(device)
    model = _build_model(arch, n_channels, arch_kwargs)
    model.load_state_dict(state_dict, strict=True)
    kwargs = {} if min_elems is None else {"min_elems": min_elems}
    qtree, report = qz.quantize_tree(model.state_dict(),
                                     out_axes=qz.out_channel_axes(model),
                                     **kwargs)
    module = ServingModule(arch, model, compute_dtype, dev.type)
    outer = DequantizingModule(
        module, {f"model.{k}": v for k, v in qtree.items()},
        COMPUTE_DTYPES[compute_dtype])
    exported = _export(module, height, width, n_channels, batch_size,
                       platforms, dev, outer)
    return exported, qtree, report


# ---------------------------------------------------------------------------
# save / load


def save_artifact(path: str, exported: Exported,
                  meta: Dict[str, Any]) -> None:
    """Write ``exported`` with ``meta`` as its JSON header, atomically."""
    header = dict(meta)
    header["magic"] = MAGIC.decode()
    header.setdefault("format_version", FORMAT_VERSION)
    header["platforms"] = list(exported.platforms)
    header["compute_dtype"] = exported.compute_dtype
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            torch.export.save(exported.program, f, extra_files={
                HEADER_FILE: json.dumps(header, sort_keys=True)})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def read_header(path: str) -> Dict[str, Any]:
    """The JSON header of the artifact at ``path``, without loading its
    program.  Raises ``ValueError`` for a JAX package artifact and for any
    file that is not an artifact of this package."""
    with open(path, "rb") as f:
        head = f.read(len(JAX_MAGIC))
    if head == JAX_MAGIC:
        raise ValueError(
            f"{path} is a JAX package serving artifact (magic "
            f"{JAX_MAGIC.decode()}), loadable only by gan_aug_pfa_tpu.serve; "
            "re-export the checkpoint for this package with python -m "
            "gan_aug_pfa_torch.export_model --checkpoint-path <checkpoint>")
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not a serving artifact (not a "
                         "torch.export archive)")
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist()
                 if n.endswith("/extra/" + HEADER_FILE)]
        header = json.loads(z.read(names[0])) if len(names) == 1 else {}
    if header.get("magic") != MAGIC.decode():
        raise ValueError(f"{path} is not a serving artifact (a torch.export "
                         f"archive without this package's {HEADER_FILE})")
    return header


def load_artifact(path: str, device="cuda", check_platform: bool = True
                  ) -> Tuple[Dict[str, Any], torch.export.ExportedProgram]:
    """(header, the exported program with its weights on ``device``).
    ``check_platform`` refuses a device type the artifact was not exported
    for."""
    header = read_header(path)
    dev = resolve_device(device)
    if check_platform and dev.type not in header["platforms"]:
        raise ValueError(
            f"artifact {path} was exported for platforms "
            f"{tuple(header['platforms'])} but the device is {dev.type!r}; "
            f"re-export with --platform {dev.type} (or pass "
            "check_platform=False)")
    try:
        program = torch.export.load(path)
    except Exception as e:  # a damaged archive: any error of the reader
        raise ValueError(f"{path}: cannot load the exported program "
                         f"({type(e).__name__}: {e})") from e
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    return header, program


def load_serving_fn(path: str, aot: str = "auto", device="cuda"):
    """Load an artifact and return (header, fn); fn(*inputs) runs it on
    ``device``: probs = fn(img1, img2) for a Siamese artifact.  Inputs
    are NHWC arrays or tensors, taken as float32 on ``device``.

    aot: "auto" and "never" run the exported program; "require" raises,
    as the JAX package does without a usable sidecar: this package writes
    no executable sidecar yet."""
    if aot not in AOT_POLICIES:
        raise ValueError(f"aot must be one of {AOT_POLICIES}, got {aot!r}")
    if aot == "require":
        read_header(path)  # a file that is no artifact says so first
        raise ValueError(
            f"aot='require' but no usable executable sidecar for {path}: "
            "the PyTorch port writes no executable sidecar yet (its exported "
            "program runs without a per-shape compile)")
    header, program = load_artifact(path, device)
    dev = resolve_device(device)
    module = program.module()
    precision = (tf32_off if header["compute_dtype"] == "float32"
                 else contextlib.nullcontext)

    def fn(*inputs):
        xs = [torch.as_tensor(x, dtype=torch.float32, device=dev)
              for x in inputs]
        with torch.no_grad(), precision():
            return module(*xs)

    return header, fn
