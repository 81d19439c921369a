"""The port's executable sidecar (``serve.compile_artifact``,
``load_serving_fn``'s ``aot`` policies, ``export_model --aot-batch-sizes``
and ``python -m gan_aug_pfa_torch.serve``) on the CPU.

AOTInductor compiles a model for minutes at full width, so these tests
put a stub compile-and-load pair in its place: the stub package is a small
JSON file naming its batch size, and the stub loader serves through the
artifact's own program, refusing any other batch.  What is held is the
sidecar around the compiler: the index and its fingerprint, every reason
``require`` refuses and ``auto`` falls back, the size check at load, the
hash check at first use and the removal of stale packages.  One narrow
model serves: the discriminator at ndf=8, 32x32 (the Siamese net, which
has no width knob, only for the evaluation CLI).  The test marked
``slow`` compiles the discriminator for real and holds its package
against the artifact within 1e-5 (float32 rounding of another kernel
choice)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import evaluate as eval_cli
from gan_aug_pfa_torch import export_model as export_cli
from gan_aug_pfa_torch import generate_synthetic as synth_cli
from gan_aug_pfa_torch import serve
from gan_aug_pfa_torch.models import (
    NLayerDiscriminator,
    SiameseUNet,
    UNetGenerator,
)
from torch_tmp import drop_tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
DISC_KW = {"ndf": 8, "n_layers": 3}
TOL = 1e-6  # a concrete-batch program against the dynamic one, same ops


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


class StubAoti:
    """``serve._aoti_compile``/``_aoti_load`` without AOTInductor: the
    package records the concrete program's input shapes, the loaded
    package serves through the artifact's program and counts its calls by
    batch size."""

    def __init__(self):
        self.compiled, self.calls = [], {}

    def compile(self, program, package):
        names = set(program.graph_signature.user_inputs)
        shapes = [list(n.meta["val"].shape) for n in program.graph.nodes
                  if n.op == "placeholder" and n.name in names]
        # Every dimension concrete: no batch Dim (nor MAX_BATCH's guard).
        assert all(type(d) is int for shape in shapes for d in shape)
        assert package.endswith(".pt2")
        with open(package, "w") as f:
            json.dump({"shapes": shapes}, f)
        self.compiled.append(shapes[0][0])

    def load(self, package, dev):
        with open(package) as f:
            shapes = json.load(f)["shapes"]
        artifact = package.split(".aotc.bs")[0]
        module = serve.load_artifact(artifact, dev)[1].module()

        def run(*xs):
            assert [list(x.shape) for x in xs] == shapes
            assert all(x.is_contiguous() for x in xs)
            bs = xs[0].shape[0]
            self.calls[bs] = self.calls.get(bs, 0) + 1
            return module(*xs)

        return run


@pytest.fixture
def stub(monkeypatch):
    s = StubAoti()
    monkeypatch.setattr(serve, "_aoti_compile", s.compile)
    monkeypatch.setattr(serve, "_aoti_load", s.load)
    return s


@pytest.fixture(scope="module")
def disc_artifact(tmp_path_factory):
    """A float32 discriminator artifact (dynamic batch) and its weights."""
    torch.manual_seed(0)
    model = NLayerDiscriminator(6, **DISC_KW).eval()
    path = str(tmp_path_factory.mktemp("aot") / "disc.pt2")
    serve.save_artifact(path, serve.export_model(
        "discriminator", model.state_dict(), SIZE, SIZE, arch_kwargs=DISC_KW,
        device="cpu"), {"arch": "discriminator"})
    return path, model


@pytest.fixture(scope="module")
def sidecar(disc_artifact, tmp_path_factory):
    """The artifact with a stub sidecar at 2 and 1, compiled once: (its
    folder, the meta, the batches compiled in order)."""
    folder = tmp_path_factory.mktemp("sidecar")
    path = str(folder / "disc.pt2")
    shutil.copy(disc_artifact[0], path)
    s = StubAoti()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(serve, "_aoti_compile", s.compile)
        meta = serve.compile_artifact(path, [2, 1], device="cpu",
                                      verbose=False)
    return folder, meta, s.compiled


@pytest.fixture
def compiled(sidecar, stub, tmp_path):
    """A copy of the artifact and its sidecar in ``tmp_path``."""
    folder, meta, _ = sidecar
    for name in os.listdir(folder):
        shutil.copy(folder / name, tmp_path / name)
    return str(tmp_path / "disc.pt2"), meta


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((batch, SIZE, SIZE, 3)) * 2 - 1).astype(np.float32)
            for _ in range(2)]


def _index(path):
    with open(serve.aot_sidecar_path(path), "rb") as f:
        raw = f.read()
    assert raw[:8] == serve.AOT_MAGIC == b"GAPTORA1"
    return json.loads(raw[8:])


def _write_index(path, meta):
    with open(serve.aot_sidecar_path(path), "wb") as f:
        f.write(serve.AOT_MAGIC + json.dumps(meta).encode())


def _sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_index_lists_each_package_and_the_environment(compiled, sidecar):
    path, meta = compiled
    assert sidecar[2] == [1, 2]
    assert _index(path) == meta
    assert meta["format"] == 2
    assert meta["artifact_sha256"] == _sha256(path)
    assert {k: meta[k] for k in ("platform", "torch_version", "cuda_version",
                                 "device_name", "capability")} == {
        "platform": "cpu", "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda, "device_name": "cpu",
        "capability": torch.backends.cpu.get_cpu_capability()}
    assert sorted(meta["shapes"]) == ["1", "2"]
    for bs, info in meta["shapes"].items():
        package = f"{path}.aotc.bs{bs}.pt2"
        assert info["file"] == os.path.basename(package)
        assert info["bytes"] == os.path.getsize(package)
        assert info["sha256"] == _sha256(package)
        assert info["compile_s"] >= 0
    assert sorted(os.listdir(os.path.dirname(path))) == [
        "disc.pt2", "disc.pt2.aotc", "disc.pt2.aotc.bs1.pt2",
        "disc.pt2.aotc.bs2.pt2"]


def test_require_serves_its_batch_sizes_through_the_packages(compiled,
                                                             stub):
    """Batches 1 and 2 run their packages (on a non-contiguous input too),
    batch 3 the exported program; each equals aot='never'."""
    path, _ = compiled
    header, fn = serve.load_serving_fn(path, aot="require", device="cpu")
    assert header["aot_batch_sizes"] == [1, 2]
    assert stub.calls == {}  # nothing loaded before its first call
    _, plain = serve.load_serving_fn(path, aot="never", device="cpu")
    for bs in (2, 1, 3):
        a, b = _inputs(bs, seed=bs)
        np.testing.assert_allclose(fn(a, b).numpy(), plain(a, b).numpy(),
                                   rtol=0, atol=TOL)
    a, b = (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
            .permute(0, 2, 3, 1) for x in _inputs(2))
    np.testing.assert_allclose(fn(a, b).numpy(), plain(a, b).numpy(),
                               rtol=0, atol=TOL)
    assert stub.calls == {2: 2, 1: 1}
    header, _ = serve.load_serving_fn(path, aot="never", device="cpu")
    assert "aot_batch_sizes" not in header


def _no_file(path):
    os.remove(serve.aot_sidecar_path(path))


def _bad_magic(path):
    with open(serve.aot_sidecar_path(path), "r+b") as f:
        f.write(b"GAPTPUA1")


def _unreadable(path):
    with open(serve.aot_sidecar_path(path), "wb") as f:
        f.write(serve.AOT_MAGIC + b"{not json")


def _env(key, value):
    def change(path):
        meta = _index(path)
        meta[key] = value
        _write_index(path, meta)
    return change


def _other_format(path):
    _env("format", 1)(path)


def _artifact_changed(path):
    header, program = serve.load_artifact(path, device="cpu")
    from gan_aug_pfa_torch.serve import Exported

    serve.save_artifact(path, Exported(program, ("cpu",), "float32"),
                        {"arch": "discriminator", "note": "re-saved"})


def _missing_package(path):
    os.remove(f"{path}.aotc.bs1.pt2")


def _truncated_package(path):
    package = f"{path}.aotc.bs2.pt2"
    with open(package, "rb") as f:
        raw = f.read()
    with open(package, "wb") as f:
        f.write(raw[:-1])


REFUSALS = {
    "no_file": (_no_file, "no sidecar file"),
    "bad_magic": (_bad_magic, "bad sidecar magic"),
    "unreadable": (_unreadable, "unreadable sidecar"),
    "format": (_other_format, "sidecar format 1 != 2"),
    "torch_version": (_env("torch_version", "0.0"),
                      "sidecar torch_version='0.0' != current"),
    "platform": (_env("platform", "cuda"),
                 "sidecar platform='cuda' != current 'cpu'"),
    "device": (_env("capability", "other ISA"),
               "sidecar capability='other ISA' != current"),
    "artifact_changed": (_artifact_changed,
                         "artifact changed since the sidecar was compiled"),
    "missing_package": (_missing_package,
                        "missing sidecar shape file .*disc.pt2.aotc.bs1.pt2"),
    "truncated_package": (_truncated_package,
                          "damaged sidecar shape file .*disc.pt2.aotc.bs2.pt2"
                          r" \(\d+ bytes, the index says \d+\)"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_require_refuses_and_auto_falls_back(compiled, stub, case, capsys):
    """Each mismatch: 'require' raises naming it; 'auto' serves every
    batch through the exported program, as 'never' does."""
    path, _ = compiled
    damage, why = REFUSALS[case]
    damage(path)
    with pytest.raises(ValueError, match="aot='require' but no usable "
                       f"executable sidecar for .*disc.pt2: {why}"):
        serve.load_serving_fn(path, aot="require", device="cpu")
    header, fn = serve.load_serving_fn(path, aot="auto", device="cpu")
    assert "aot_batch_sizes" not in header
    _, plain = serve.load_serving_fn(path, aot="never", device="cpu")
    a, b = _inputs(2)
    assert torch.equal(fn(a, b), plain(a, b))
    assert stub.calls == {}


def test_package_hash_is_checked_at_first_use(compiled, stub, capsys):
    """A package of the right size whose bytes changed loads, then fails
    its sha256 at its first call: 'require' raises naming the file,
    'auto' prints why once and serves through the program from then on."""
    path, _ = compiled
    package = f"{path}.aotc.bs2.pt2"
    with open(package, "r+b") as f:
        f.write(b"[")
    header, fn = serve.load_serving_fn(path, aot="require", device="cpu")
    assert header["aot_batch_sizes"] == [1, 2]
    a, b = _inputs(2)
    with pytest.raises(ValueError, match="aot='require' but the executable "
                       "sidecar for .*disc.pt2 is not usable: damaged "
                       "sidecar shape file .*disc.pt2.aotc.bs2.pt2"):
        fn(a, b)
    _, plain = serve.load_serving_fn(path, aot="never", device="cpu")
    _, auto = serve.load_serving_fn(path, aot="auto", device="cpu")
    capsys.readouterr()
    for _ in range(2):
        assert torch.equal(auto(a, b), plain(a, b))
    out = capsys.readouterr().out
    assert out.count("damaged sidecar shape file") == 1
    assert "serving batch 2 through the exported program" in out
    a1, b1 = _inputs(1)
    auto(a1, b1)  # batch 1's package is intact
    assert stub.calls == {1: 1}


def test_recompile_removes_stale_packages(compiled, stub):
    """A recompile at batch 4 leaves only its package, and removes a
    stray package of an earlier index too; no temporary file stays."""
    path, _ = compiled
    stray = f"{path}.aotc.bs9.pt2"
    with open(stray, "w") as f:
        f.write("{}")
    meta = serve.compile_artifact(path, [4], device="cpu", verbose=False)
    assert sorted(meta["shapes"]) == ["4"]
    assert sorted(os.listdir(os.path.dirname(path))) == [
        "disc.pt2", "disc.pt2.aotc", "disc.pt2.aotc.bs4.pt2"]
    header, fn = serve.load_serving_fn(path, aot="require", device="cpu")
    assert header["aot_batch_sizes"] == [4]
    fn(*_inputs(4))
    assert stub.calls == {4: 1}


def test_compile_refuses_other_batches_of_a_fixed_batch_artifact(
        disc_artifact, stub, tmp_path):
    _, model = disc_artifact
    path = str(tmp_path / "fixed.pt2")
    serve.save_artifact(path, serve.export_model(
        "discriminator", model.state_dict(), SIZE, SIZE, arch_kwargs=DISC_KW,
        device="cpu", batch_size=3), {"arch": "discriminator"})
    with pytest.raises(ValueError, match="batch is fixed at 3; cannot "
                                         "compile it at batch 2"):
        serve.compile_artifact(path, [2], device="cpu")
    assert serve.compile_artifact(path, [3], device="cpu",
                                  verbose=False)["shapes"].keys() == {"3"}


def test_export_cli_aot_batch_sizes(disc_artifact, stub, tmp_path, capsys):
    """export_model --aot-batch-sizes 2,1 writes the artifact, the index
    and two packages, and prints each package's compile line."""
    pth = str(tmp_path / "discriminator_epoch_1.pth")
    tck.save_model(pth, disc_artifact[1])
    out = export_cli.main(["--backend", "cpu", "--checkpoint-path", pth,
                           "--target-size", "32x32", "--ndf", "8",
                           "--aot-batch-sizes", "2,1"])
    assert out == str(tmp_path / "discriminator_epoch_1.pt2")
    printed = capsys.readouterr().out
    assert "AOT-compiling for batch sizes [2, 1] on cpu ..." in printed
    for bs in (1, 2):
        assert f"  AOT bs={bs}: compiled in " in printed
        assert os.path.exists(f"{out}.aotc.bs{bs}.pt2")
    assert f"Saved AOT sidecar index to {out}.aotc (" in printed
    assert sorted(_index(out)["shapes"]) == ["1", "2"]
    header, fn = serve.load_serving_fn(out, aot="require", device="cpu")
    assert header["aot_batch_sizes"] == [1, 2]
    fn(*_inputs(1))
    assert stub.calls == {1: 1}


def test_serve_main_usage_errors(disc_artifact, stub, tmp_path, capsys):
    for argv, message in (([], "the following arguments are required: "
                               "artifact, BS1,BS2,..."),
                          ([disc_artifact[0], "2,x", "--device", "cpu"],
                           "batch sizes must be positive integers, got '2,x'"),
                          ([disc_artifact[0], "0,2", "--device", "cpu"],
                           "batch sizes must be positive integers, got '0,2'")):
        with pytest.raises(SystemExit) as exc:
            serve._main(argv)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert err.startswith("usage: python -m gan_aug_pfa_torch.serve ")
        assert message in err
    path = str(tmp_path / "disc.pt2")
    shutil.copy(disc_artifact[0], path)
    meta = serve._main([path, "3", "--device", "cpu"])
    assert sorted(meta["shapes"]) == ["3"] and stub.compiled == [3]


def test_evaluate_require_gives_the_never_report(stub, oscd_tree, tmp_path):
    """evaluate --serving-aot require over a sidecar at batch 2 (the 5
    pairs run as 2, 2 and a tail of 1, which the program serves) writes
    the metrics JSON of --serving-aot never."""
    torch.manual_seed(0)
    model = SiameseUNet(batched_encoder=True).eval()
    path = str(tmp_path / "siamese.pt2")
    serve.save_artifact(path, serve.export_model(
        "siamese", model.state_dict(), SIZE, SIZE, device="cpu"),
        {"arch": "siamese"})
    serve.compile_artifact(path, [2], device="cpu", verbose=False)
    reports = {}
    for aot in ("require", "never"):
        out = str(tmp_path / f"{aot}.json")
        assert eval_cli.main([
            "--root-dir", str(oscd_tree), "--device", "cpu", "--target-size",
            "32x32", "--output-dir", str(tmp_path / aot),
            "--num-visualizations", "0", "--serving-artifact", path,
            "--serving-aot", aot, "--json-out", out]) is not None
        with open(out) as f:
            reports[aot] = json.load(f)
    assert stub.calls == {2: 2}
    assert reports["require"] == reports["never"]
    assert reports["never"]["n_samples"] == 5


def test_generate_synthetic_require_writes_the_never_pngs(stub, oscd_tree,
                                                          tmp_path, capsys):
    """generate_synthetic --serving-aot require over a generator sidecar
    at batch 4 (the 5 samples run as 4 and a tail of 1) names the
    sidecar's batch sizes and writes --serving-aot never's PNG bytes."""
    torch.manual_seed(0)
    model = UNetGenerator(3, 3, num_downs=5, ngf=8).eval()
    path = str(tmp_path / "generator.pt2")
    serve.save_artifact(path, serve.export_model(
        "generator", model.state_dict(), SIZE, SIZE,
        arch_kwargs={"num_downs": 5, "ngf": 8}, device="cpu"),
        {"arch": "generator"})
    serve.compile_artifact(path, [4], device="cpu", verbose=False)
    out = {}
    for aot in ("require", "never"):
        out[aot] = str(tmp_path / aot)
        assert synth_cli.main([
            "--root-dir", str(oscd_tree), "--device", "cpu", "--target-size",
            "32x32", "--num-downs", "5", "--ngf", "8",
            "--synthetic-data-dir", out[aot], "--serving-artifact", path,
            "--serving-aot", aot]) == 5
        printed = capsys.readouterr().out
        assert ("AOT sidecar batch sizes: [4]" in printed) == (
            aot == "require")
    assert stub.calls == {4: 1}
    files = sorted(os.path.relpath(os.path.join(d, f), out["never"])
                   for d, _, fs in os.walk(out["never"]) for f in fs)
    assert len(files) == 15
    for rel in files:
        with open(os.path.join(out["require"], rel), "rb") as f1, \
                open(os.path.join(out["never"], rel), "rb") as f2:
            assert f1.read() == f2.read(), rel


def test_openmp_cxx_passes_over_a_compiler_that_cannot_link_openmp(
        monkeypatch):
    """AOTInductor links with -fopenmp: $CXX when it can, else g++."""
    monkeypatch.setenv("CXX", "g++")
    assert serve.openmp_cxx() == "g++"
    monkeypatch.setenv("CXX", os.path.join(REPO, "no-such-compiler"))
    assert serve.openmp_cxx() == "g++"


@pytest.mark.slow
def test_real_aoti_package_matches_the_artifact(disc_artifact, tmp_path):
    """AOTInductor on the CPU (about 20-45 s): the package at batch 2
    computes the artifact's output within 1e-5."""
    path = str(tmp_path / "disc.pt2")
    shutil.copy(disc_artifact[0], path)
    meta = serve.compile_artifact(path, [2], device="cpu", verbose=False)
    assert meta["shapes"]["2"]["bytes"] > 0
    header, fn = serve.load_serving_fn(path, aot="require", device="cpu")
    _, plain = serve.load_serving_fn(path, aot="never", device="cpu")
    a, b = _inputs(2)
    got = fn(a, b)
    assert got.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(got.numpy(), plain(a, b).numpy(), rtol=0,
                               atol=1e-5)
