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
``GAPTPUX1``) is refused with a message that says so.

Executable sidecar (the JAX package's ``compile_artifact``, format 2):
``compile_artifact`` re-exports the program at each chosen batch size and
compiles it ahead of time with AOTInductor into one package a batch size,
``<artifact>.aotc.bs<k>.pt2``, indexed by ``<artifact>.aotc`` (magic
``GAPTORA1`` and a JSON meta: the artifact's sha256, the environment it
was compiled in, each package's file, bytes, sha256 and compile seconds).
``load_serving_fn`` serves those batch sizes through the packages, each
loaded at its first call, and any other batch size through the exported
program; ``python -m gan_aug_pfa_torch.serve ARTIFACT BS1,BS2`` writes the
sidecar.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import hashlib
import json
import os
import time
import zipfile
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def _check_platform(path: str, header: Mapping[str, Any],
                    dev: torch.device) -> None:
    if dev.type not in header["platforms"]:
        raise ValueError(
            f"artifact {path} was exported for platforms "
            f"{tuple(header['platforms'])} but the device is {dev.type!r}; "
            f"re-export with --platform {dev.type} (or pass "
            "check_platform=False)")


def load_artifact(path: str, device="cuda", check_platform: bool = True
                  ) -> Tuple[Dict[str, Any], torch.export.ExportedProgram]:
    """(header, the exported program with its weights on ``device``).
    ``check_platform`` refuses a device type the artifact was not exported
    for."""
    header = read_header(path)
    dev = resolve_device(device)
    if check_platform:
        _check_platform(path, header, dev)
    try:
        program = torch.export.load(path)
    except Exception as e:  # a damaged archive: any error of the reader
        raise ValueError(f"{path}: cannot load the exported program "
                         f"({type(e).__name__}: {e})") from e
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    return header, program


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _replace_atomically(path: str, write) -> None:
    """``write(tmp)`` to a temporary path beside ``path`` (ending as
    ``path`` does), then rename it to ``path``."""
    stem, ext = os.path.splitext(path)
    tmp = f"{stem}.tmp{ext}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _precision(header: Mapping[str, Any]):
    """A float32 program computes with TF32 off: Inductor reads the
    matmul flag when it compiles, the convolutions read cuDNN's at each
    call."""
    return (tf32_off if header["compute_dtype"] == "float32"
            else contextlib.nullcontext)


def _user_input_shapes(program: torch.export.ExportedProgram, bs: int
                       ) -> List[Tuple[int, ...]]:
    """The program's image inputs' shapes with the batch set to ``bs``;
    raises for a fixed-batch program of another batch."""
    names = set(program.graph_signature.user_inputs)
    shapes = []
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name in names:
            batch, *rest = node.meta["val"].shape
            if isinstance(batch, int) and batch != bs:
                raise ValueError(f"the artifact's batch is fixed at {batch}; "
                                 f"cannot compile it at batch {bs}")
            shapes.append((bs, *map(int, rest)))
    return shapes


# ---------------------------------------------------------------------------
# the executable sidecar (AOTInductor packages)

AOT_MAGIC = b"GAPTORA1"
AOT_FORMAT = 2


def aot_sidecar_path(artifact_path: str) -> str:
    return artifact_path + ".aotc"


def parse_batch_sizes(text: str) -> List[int]:
    """``"B1,B2"`` -> [B1, B2]; raises ``ValueError`` for anything but
    positive integers."""
    try:
        sizes = [int(b) for b in text.split(",")]
    except ValueError:
        sizes = []
    if not sizes or min(sizes) < 1:
        raise ValueError(f"batch sizes must be positive integers, got "
                         f"{text!r}")
    return sizes


def _aot_env(dev: torch.device) -> Dict[str, Any]:
    """What a package is bound to: the platform, torch and CUDA versions,
    and the device (its name and compute capability; on the CPU, the
    vector ISA Inductor compiled for)."""
    env = {"platform": dev.type, "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda}
    if dev.type == "cuda":
        env["device_name"] = torch.cuda.get_device_name(dev)
        env["capability"] = ".".join(
            map(str, torch.cuda.get_device_capability(dev)))
    else:
        env["device_name"] = "cpu"
        env["capability"] = torch.backends.cpu.get_cpu_capability()
    return env


def openmp_cxx() -> Optional[str]:
    """The C++ compiler for AOTInductor, which builds and links a package
    with ``-fopenmp``: ``$CXX`` (Inductor's own choice) when it links an
    OpenMP program, else the first of ``g++`` and ``c++`` that does (a GCC
    wrapper may lack ``libgomp.spec``); None when none does."""
    import shutil
    import subprocess

    from .ops.kernels.build import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, "openmp_probe.cpp")
    with open(src, "w") as f:
        f.write("#include <omp.h>\nint main() { return omp_get_max_threads()"
                " > 0 ? 0 : 1; }\n")
    for cxx in (os.environ.get("CXX"), "g++", "c++"):
        if cxx and shutil.which(cxx) and subprocess.run(
                [cxx, "-fopenmp", src, "-o", src[:-4]],
                capture_output=True).returncode == 0:
            return cxx
    return None


def _aoti_compile(program: torch.export.ExportedProgram, package: str) -> None:
    import torch._inductor

    cxx = openmp_cxx()
    with torch._inductor.config.patch({"cpp.cxx": (cxx,)} if cxx else {}):
        torch._inductor.aoti_compile_and_package(program,
                                                 package_path=package)


def _aoti_load(package: str, dev: torch.device):
    import torch._inductor

    return torch._inductor.aoti_load_package(
        package, device_index=-1 if dev.index is None else dev.index)


def compile_artifact(path: str, batch_sizes: Sequence[int],
                     out_path: Optional[str] = None, device="cuda",
                     verbose: bool = True) -> Dict[str, Any]:
    """Compile the artifact at ``path`` ahead of time on ``device`` at each
    of ``batch_sizes`` and write the sidecar (``out_path``, default
    ``<path>.aotc``); returns its meta.

    Each batch size: the program's module re-exported at that concrete
    batch from distinct seeded NHWC inputs, then compiled by AOTInductor
    into ``<out>.bs<k>.pt2``.  Every file is written atomically; package
    files of an earlier compile that the new index does not list are
    deleted.  A package is bound to this device, torch and CUDA: compile
    on the deployment host."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # The re-export's fake tensors carry an index, and the program's
        # device assertions must name the same device.
        dev = torch.device("cuda", torch.cuda.current_device())
    header, program = load_artifact(path, dev)
    module = program.module()
    out = out_path or aot_sidecar_path(path)
    meta: Dict[str, Any] = {"format": AOT_FORMAT,
                            "artifact_sha256": _sha256(path),
                            **_aot_env(dev), "shapes": {}}
    gen = torch.Generator().manual_seed(0)
    for bs in sorted({int(b) for b in batch_sizes}):
        sample = tuple(torch.rand(shape, generator=gen).to(dev)
                       for shape in _user_input_shapes(program, bs))
        shape_file = f"{out}.bs{bs}.pt2"
        t0 = time.perf_counter()
        with torch.no_grad(), _precision(header)():
            concrete = torch.export.export(module, sample, strict=False)
            _replace_atomically(
                shape_file, lambda tmp: _aoti_compile(concrete, tmp))
        info = {"file": os.path.basename(shape_file),
                "bytes": os.path.getsize(shape_file),
                "sha256": _sha256(shape_file),
                "compile_s": round(time.perf_counter() - t0, 2)}
        meta["shapes"][str(bs)] = info
        if verbose:
            print(f"  AOT bs={bs}: compiled in {info['compile_s']:.1f}s, "
                  f"{info['bytes'] / 1e6:.1f} MB at {shape_file}")

    def write_index(tmp):
        with open(tmp, "wb") as f:
            f.write(AOT_MAGIC)
            f.write(json.dumps(meta, sort_keys=True).encode())

    _replace_atomically(out, write_index)
    listed = {info["file"] for info in meta["shapes"].values()}
    for stale in glob.glob(glob.escape(out) + ".bs*.pt2"):
        if os.path.basename(stale) not in listed:
            os.remove(stale)
    if verbose:
        print(f"Saved AOT sidecar index to {out} "
              f"({os.path.getsize(out)} B + per-shape packages, "
              f"{meta['device_name']}/{meta['platform']})")
    return meta


class SidecarError(ValueError):
    """A package file of the sidecar fails its check at first use."""


class _Lazy:
    """``load()``'s callable, made at the first call."""

    def __init__(self, load):
        self.load, self.fn = load, None

    def __call__(self, *inputs):
        if self.fn is None:
            self.fn = self.load()
        return self.fn(*inputs)


def _load_aot_sidecar(path: str, device="cuda"):
    """({batch size: the package's callable, loaded at its first call},
    "ok"), or (None, why) when there is no usable sidecar for the artifact
    at ``path`` on ``device``.  A package file must have the size the
    index gives; its sha256 is checked before its first use, which raises
    ``SidecarError`` on a mismatch."""
    dev = resolve_device(device)
    side = aot_sidecar_path(path)
    if not os.path.exists(side):
        return None, "no sidecar file"
    with open(side, "rb") as f:
        raw = f.read()
    if raw[:len(AOT_MAGIC)] != AOT_MAGIC:
        return None, "bad sidecar magic"
    try:
        meta = json.loads(raw[len(AOT_MAGIC):])
        shapes = {int(bs): info for bs, info in meta["shapes"].items()}
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        return None, f"unreadable sidecar ({e})"
    if meta.get("format") != AOT_FORMAT:
        return None, (f"sidecar format {meta.get('format')!r} != "
                      f"{AOT_FORMAT}")
    for k, v in _aot_env(dev).items():
        if meta.get(k) != v:
            return None, f"sidecar {k}={meta.get(k)!r} != current {v!r}"
    if meta.get("artifact_sha256") != _sha256(path):
        return None, "artifact changed since the sidecar was compiled"
    folder = os.path.dirname(side) or "."
    files = {}
    for bs, info in shapes.items():
        shape_file = os.path.join(folder, info["file"])
        if not os.path.exists(shape_file):
            return None, f"missing sidecar shape file {shape_file}"
        size = os.path.getsize(shape_file)
        if size != info["bytes"]:
            return None, (f"damaged sidecar shape file {shape_file} "
                          f"({size} bytes, the index says {info['bytes']})")
        files[bs] = (shape_file, info["sha256"])

    def loader(shape_file, sha256):
        def load():
            if _sha256(shape_file) != sha256:
                raise SidecarError(f"damaged sidecar shape file "
                                   f"{shape_file} (its sha256 is not the "
                                   "index's)")
            return _aoti_load(shape_file, dev)
        return load

    return {bs: _Lazy(loader(*f)) for bs, f in files.items()}, "ok"


def load_serving_fn(path: str, aot: str = "auto", device="cuda"):
    """Load an artifact and return (header, fn); fn(*inputs) runs it on
    ``device``: probs = fn(img1, img2) for a Siamese artifact.  Inputs
    are NHWC arrays or tensors, taken as float32 on ``device``.

    aot: "auto" serves the batch sizes of a usable executable sidecar
    (``compile_artifact``'s ``<path>.aotc``) through their packages and
    every other batch size through the exported program; a sidecar that
    does not match this artifact, device or torch is ignored.  "require"
    raises ``ValueError`` when there is no usable sidecar, and when a
    package fails its check at first use (where "auto" prints why and
    serves through the program).  "never" ignores any sidecar.
    ``header["aot_batch_sizes"]`` lists the sidecar's batch sizes.  Each
    package, and with a sidecar the program too, loads at its first
    call."""
    if aot not in AOT_POLICIES:
        raise ValueError(f"aot must be one of {AOT_POLICIES}, got {aot!r}")
    dev = resolve_device(device)
    header = read_header(path)
    _check_platform(path, header, dev)
    entries = None
    if aot != "never":
        entries, why = _load_aot_sidecar(path, dev)
        if aot == "require" and entries is None:
            raise ValueError(f"aot='require' but no usable executable "
                             f"sidecar for {path}: {why}")
        if entries:
            header["aot_batch_sizes"] = sorted(entries)

    def load_program():
        return load_artifact(path, dev)[1].module()

    # With a sidecar, the program loads only if a batch size needs it.
    program = _Lazy(load_program) if entries else load_program()
    precision = _precision(header)

    def fn(*inputs):
        xs = [torch.as_tensor(x, dtype=torch.float32, device=dev)
              for x in inputs]
        package = entries.get(xs[0].shape[0]) if entries else None
        with torch.no_grad(), precision():
            if package is not None:
                try:
                    return package(*(x.contiguous() for x in xs))
                except SidecarError as e:
                    if aot == "require":
                        raise ValueError(f"aot='require' but the executable "
                                         f"sidecar for {path} is not "
                                         f"usable: {e}") from e
                    print(f"{e}; serving batch {xs[0].shape[0]} through the "
                          "exported program")
                    del entries[xs[0].shape[0]]
            return program(*xs)

    return header, fn


def _main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """python -m gan_aug_pfa_torch.serve ARTIFACT BS1,BS2 [--device D]:
    write the artifact's executable sidecar on the deployment host."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m gan_aug_pfa_torch.serve",
        description="Compile a serving artifact's executable sidecar")
    p.add_argument("artifact")
    p.add_argument("batch_sizes", metavar="BS1,BS2,...")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    try:
        sizes = parse_batch_sizes(args.batch_sizes)
    except ValueError as e:
        p.error(str(e))
    return compile_artifact(args.artifact, sizes, device=args.device)


if __name__ == "__main__":
    _main()
