"""The port's serving artifacts (``gan_aug_pfa_torch/serve.py``,
``python -m gan_aug_pfa_torch.export_model`` and ``--serving-artifact``)
against the eager port models and the JAX package, on the CPU.

Weights are the seeded JAX inits of ``torch_port_helpers`` carried across
with the port's converter; inputs come from ``np.random.default_rng``.
Tolerances: a float32 artifact within 1e-6 of the eager port model (the
same ATen ops; equal on the CPU) and within 1e-5 of the JAX package
(JAX's ``serve.export_model`` for the GAN models, ``sigmoid(apply)`` for
the Siamese net, whose head is scaled by 300: the frameworks' float32
convolutions round apart by up to ~5e-6 there); an int8 artifact within
1e-5 of the JAX model applied to ``dequantize_tree`` of JAX's own
quantized tree.  The Siamese net has no width knob, so it runs at full
width at 32x32; the GAN models at num_downs=5, ngf=8 and ndf=8."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import evaluate as eval_cli
from gan_aug_pfa_torch import export_model as export_cli
from gan_aug_pfa_torch import generate_synthetic as synth_cli
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import serve
from gan_aug_pfa_torch.models import (
    NLayerDiscriminator,
    SiameseUNet,
    UNetGenerator,
)
from gan_aug_pfa_torch.train.gan import generate
from gan_aug_pfa_torch.train.siamese import predict_normalized
from gan_aug_pfa_tpu import quantize as jqz
from gan_aug_pfa_tpu import serve as jserve
from torch_port_helpers import (
    jax_pix2pix_models,
    jax_pix2pix_variables,
    jax_siamese_logits,
    jax_siamese_variables,
)
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
GEN_KW = {"num_downs": 5, "ngf": 8}
DISC_KW = {"ndf": 8, "n_layers": 3}
EAGER_TOL, JAX_TOL = 1e-6, 1e-5
# As in tests/test_torch_eval.py: with these weights no probability on
# oscd_tree lies near 0.5, so no pixel can flip between the two paths.
WEIGHT_SEED = 1
FIXTURE = os.path.join(REPO, "tests", "data", "jax_generator_nd5_ngf4")


def _jax_siamese_probs(variables, a, b):
    """JAX's eval-mode probabilities; at batch 2 the helper's jitted apply
    reuses the compile of jax_siamese_variables' calibration."""
    logits = jax_siamese_logits(variables, a, b).astype(np.float64)
    return 1.0 / (1.0 + np.exp(-logits))


def _images(seed, batch, lo=-1.0):
    rng = np.random.default_rng(seed)
    return [(rng.random((batch, SIZE, SIZE, 3)) * (1.0 - lo) + lo)
            .astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def pix2pix(tmp_path_factory):
    """Per GAN arch: the JAX variables, the eager port model with their
    weights, and a float32 and an int8 artifact of it."""
    work = tmp_path_factory.mktemp("serve_pix2pix")
    vg, vd = jax_pix2pix_variables(seed=0, size=SIZE, **GEN_KW, ndf=8)
    out = {}
    for arch, variables, model, kw in (
            ("generator", vg, UNetGenerator(3, 3, **GEN_KW), GEN_KW),
            ("discriminator", vd, NLayerDiscriminator(6, ndf=8), DISC_KW)):
        model.load_state_dict(ti.state_dict_from_jax(model, variables),
                              strict=True)
        model.eval()
        paths = {}
        for kind in ("fp32", "int8"):
            export = (serve.export_model_quantized if kind == "int8"
                      else serve.export_model)
            exported = export(arch, model.state_dict(), SIZE, SIZE,
                              arch_kwargs=kw, device="cpu")
            if kind == "int8":
                exported = exported[0]
            paths[kind] = str(work / f"{arch}_{kind}.pt2")
            serve.save_artifact(paths[kind], exported, {"arch": arch})
        out[arch] = {"variables": variables, "model": model, "paths": paths,
                     "kw": kw}
    return out


@pytest.fixture(scope="module")
def siamese(tmp_path_factory):
    """The JAX variables, the eager port model, its ``.pth`` and a float32
    and an int8 artifact of it."""
    work = tmp_path_factory.mktemp("serve_siamese")
    variables = jax_siamese_variables(seed=WEIGHT_SEED, size=SIZE)
    model = SiameseUNet(batched_encoder=True)
    model.load_state_dict(ti.siamese_state_dict_from_jax(variables),
                          strict=True)
    model.eval()
    pth = str(work / "best_model.pth")
    tck.save_model(pth, model)
    paths = {"fp32": str(work / "siamese_fp32.pt2"),
             "int8": str(work / "siamese_int8.pt2")}
    serve.save_artifact(paths["fp32"], serve.export_model(
        "siamese", model.state_dict(), SIZE, SIZE, device="cpu"),
        {"arch": "siamese"})
    exported, _, report = serve.export_model_quantized(
        "siamese", model.state_dict(), SIZE, SIZE, device="cpu")
    serve.save_artifact(paths["int8"], exported,
                        {"arch": "siamese", "quantize": "int8",
                         "quantize_report": report})
    with dropped(work):
        yield {"variables": variables, "model": model, "pth": pth,
               "paths": paths, "work": work}


def _pix2pix_eager(arch, model, a, b):
    with torch.no_grad():
        if arch == "generator":
            return generate(model, torch.from_numpy(a), "float32").numpy()
        x = torch.cat([torch.from_numpy(a), torch.from_numpy(b)], dim=-1)
        return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def test_arch_from_stem():
    cases = {"x/best_model.msgpack": "siamese",
             "model_epoch_50.pth": "siamese",
             "c/generator_epoch_200.pth": "generator",
             "generator_ema_epoch_3.pth": "generator",
             "discriminator_epoch_10.msgpack": "discriminator",
             "weights.bin": None}
    for path, arch in cases.items():
        assert serve.arch_from_stem(path) == arch
        assert jserve.arch_from_stem(path) == arch


@pytest.mark.parametrize("arch", ["generator", "discriminator"])
def test_artifact_serves_any_batch_like_eager_and_jax(pix2pix, arch):
    """One file serves batches 1 and 3: within 1e-6 of the eager port
    model and within 1e-5 of JAX's own artifact of the same weights."""
    case = pix2pix[arch]
    header, fn = serve.load_serving_fn(case["paths"]["fp32"], device="cpu")
    assert header["arch"] == arch and header["platforms"] == ["cpu"]
    assert header["compute_dtype"] == "float32"
    jexported = jserve.export_model(arch, case["variables"], SIZE, SIZE,
                                    arch_kwargs=case["kw"])
    for batch in (1, 3):
        a, b = _images(batch, batch, lo=0.0 if arch == "generator" else -1.0)
        inputs = (a,) if arch == "generator" else (a, b)
        got = fn(*inputs).numpy()
        want = _pix2pix_eager(arch, case["model"], a, b)
        assert got.shape == want.shape
        assert got.shape[0] == batch
        np.testing.assert_allclose(got, want, rtol=0, atol=EAGER_TOL)
        np.testing.assert_allclose(
            got, np.asarray(jexported.call(*inputs)), rtol=0, atol=JAX_TOL)


def test_siamese_artifact_matches_eager_and_jax(siamese):
    header, fn = serve.load_serving_fn(siamese["paths"]["fp32"],
                                       device="cpu")
    a, b = _images(7, 2)
    got = fn(a, b).numpy()
    assert got.shape == (2, SIZE, SIZE, 1)
    eager = predict_normalized(
        siamese["model"], torch.from_numpy(a).permute(0, 3, 1, 2),
        torch.from_numpy(b).permute(0, 3, 1, 2), "float32")
    np.testing.assert_allclose(got, eager.permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=EAGER_TOL)
    want = np.asarray(_jax_siamese_probs(siamese["variables"], a, b))
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    assert 0.0 < got.min() and got.max() < 1.0


@pytest.mark.parametrize("arch", ["siamese", "generator", "discriminator"])
def test_int8_artifact_matches_jax_dequantized(pix2pix, siamese, arch):
    """The int8 artifact computes what JAX computes with its own
    dequantized weights (one batch: the dynamic batch is held above)."""
    case = siamese if arch == "siamese" else pix2pix[arch]
    header, fn = serve.load_serving_fn(case["paths"]["int8"], device="cpu")
    deq = jqz.dequantize_tree(jqz.quantize_tree(case["variables"])[0])
    a, b = _images(11, 2, lo=0.0 if arch == "generator" else -1.0)
    if arch == "siamese":
        got, want = fn(a, b), _jax_siamese_probs(deq, a, b)
    else:
        gen, disc = jax_pix2pix_models(**GEN_KW, ndf=8)
        if arch == "generator":
            got = fn(a)
            want = jax.jit(lambda v, x: gen.apply(v, x, train=False))(
                deq, a * 2.0 - 1.0) * 0.5 + 0.5
        else:
            got = fn(a, b)
            want = jax.jit(lambda v, x: disc.apply(v, x, train=False))(
                deq, np.concatenate([a, b], axis=-1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=JAX_TOL)


def test_int8_siamese_artifact_is_small_and_holds_int8(siamese):
    """Under 0.45x the float32 file (tests/test_quantize.py:166); the
    program's weights are int8 buffers, no float copy of them."""
    paths = siamese["paths"]
    assert os.path.getsize(paths["int8"]) < 0.45 * os.path.getsize(
        paths["fp32"])
    header, program = serve.load_artifact(paths["int8"], device="cpu")
    assert header["quantize"] == "int8"
    n_int8 = sum(v.numel() for v in program.state_dict.values()
                 if v.dtype == torch.int8)
    n_float = sum(v.numel() for v in program.state_dict.values()
                  if v.is_floating_point())
    assert n_int8 > 40e6 and n_float < 1e6


def _conv_dtypes(program):
    return [n.meta["val"].dtype for n in program.graph.nodes
            if n.target == torch.ops.aten.convolution.default]


def test_bf16_artifact_computes_in_bf16(pix2pix, tmp_path):
    """A bfloat16 artifact's 10 convolutions run in bfloat16, as explicit
    casts of the graph, and it computes what eager bf16 autocast does
    (the same ops: within 1e-6); the float32 artifact's run in float32."""
    model = pix2pix["generator"]["model"]
    _, fp32 = serve.load_artifact(pix2pix["generator"]["paths"]["fp32"],
                                  device="cpu")
    assert _conv_dtypes(fp32) == [torch.float32] * 10
    exported = serve.export_model("generator", model.state_dict(), SIZE,
                                  SIZE, arch_kwargs=GEN_KW, device="cpu",
                                  compute_dtype="bfloat16")
    path = str(tmp_path / "g.pt2")
    serve.save_artifact(path, exported, {"arch": "generator"})
    header, program = serve.load_artifact(path, device="cpu")
    assert _conv_dtypes(program) == [torch.bfloat16] * 10
    assert header["compute_dtype"] == "bfloat16"
    _, fn = serve.load_serving_fn(path, device="cpu")
    a, _ = _images(5, 2, lo=0.0)
    eager = generate(model, torch.from_numpy(a), "bfloat16")
    np.testing.assert_allclose(fn(a).numpy(), eager.numpy(), rtol=0,
                               atol=EAGER_TOL)


@pytest.fixture(scope="module")
def jax_artifact(pix2pix, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_art") / "disc.ghlo")
    case = pix2pix["discriminator"]
    jserve.save_artifact(path, jserve.export_model(
        "discriminator", case["variables"], SIZE, SIZE,
        arch_kwargs=case["kw"]), {"arch": "discriminator"})
    return path


def test_load_errors(pix2pix, jax_artifact, tmp_path):
    """A JAX package artifact, files that are not artifacts, a device type
    not among the artifact's platforms and aot='require' without a
    sidecar (``tests/test_torch_serve_aot.py`` holds the sidecar) each
    raise a ValueError that says what is wrong, never a zip or pickle
    error."""
    with pytest.raises(ValueError, match="JAX package serving artifact "
                       r"\(magic GAPTPUX1\).*gan_aug_pfa_tpu.serve.*"
                       "python -m gan_aug_pfa_torch.export_model"):
        serve.load_serving_fn(jax_artifact, device="cpu")
    junk = tmp_path / "junk.pt2"
    junk.write_bytes(b"\x80\x04junk" * 10)
    with pytest.raises(ValueError, match="junk.pt2 is not a serving "):
        serve.load_artifact(str(junk), device="cpu")
    plain = tmp_path / "plain.pt2"
    torch.export.save(torch.export.export(torch.nn.ReLU(),
                                          (torch.ones(2),)), str(plain))
    with pytest.raises(ValueError, match="plain.pt2 is not a serving "):
        serve.load_artifact(str(plain), device="cpu")
    model = pix2pix["discriminator"]["model"]
    cuda_only = str(tmp_path / "cuda_only.pt2")
    serve.save_artifact(cuda_only, serve.export_model(
        "discriminator", model.state_dict(), SIZE, SIZE, arch_kwargs=DISC_KW,
        device="cpu", platforms=["cuda"]), {"arch": "discriminator"})
    with pytest.raises(ValueError, match="exported for platforms"):
        serve.load_artifact(cuda_only, device="cpu")
    header, _ = serve.load_artifact(cuda_only, device="cpu",
                                    check_platform=False)
    assert header["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="platform 'tpu'"):
        serve.export_model("discriminator", model.state_dict(), SIZE, SIZE,
                           arch_kwargs=DISC_KW, device="cpu",
                           platforms=["tpu"])
    path = pix2pix["discriminator"]["paths"]["fp32"]
    with pytest.raises(ValueError, match="aot='require' but no usable "
                       "executable sidecar for .*: no sidecar file"):
        serve.load_serving_fn(path, aot="require", device="cpu")
    for aot in ("auto", "never"):
        assert serve.load_serving_fn(path, aot=aot, device="cpu")[0][
            "arch"] == "discriminator"


_BLOCKED = r"""
import sys
sys.modules["gan_aug_pfa_torch.models"] = None  # the model code is gone
import numpy as np
from gan_aug_pfa_torch import serve
header, fn = serve.load_serving_fn(sys.argv[1], device="cpu")
d = np.load(sys.argv[2])
np.save(sys.argv[3], fn(d["a"], d["b"]).numpy())
print(header["arch"], sorted(m for m, v in sys.modules.items()
                              if v is not None and ".models" in m))
"""


def test_artifact_serves_without_the_model_code(siamese, tmp_path):
    """A fresh process that cannot import gan_aug_pfa_torch.models loads
    the Siamese artifact and serves a batch, equal to this process's."""
    a, b = _images(3, 2)
    np.savez(tmp_path / "in.npz", a=a, b=b)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, siamese["paths"]["fp32"],
         str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["siamese", "[]"]
    _, fn = serve.load_serving_fn(siamese["paths"]["fp32"], device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  fn(a, b).numpy())


def _run_export_cli(args, cwd):
    proc = subprocess.run(
        [sys.executable, "-m", "gan_aug_pfa_torch.export_model",
         "--backend", "cpu", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_export_cli_from_pth_int8(pix2pix, tmp_path, capsys):
    """A port .pth through the CLI's main, int8: JAX's lines, the header,
    and the artifact equal to the one exported in the fixture."""
    model = pix2pix["discriminator"]["model"]
    pth = str(tmp_path / "discriminator_epoch_1.pth")
    tck.save_model(pth, model)
    path = str(tmp_path / "discriminator_epoch_1.pt2")
    assert export_cli.main(["--backend", "cpu", "--checkpoint-path", pth,
                            "--target-size", "32x32", "--ndf", "8",
                            "--quantize", "int8"]) == path
    out = capsys.readouterr().out
    assert "Exporting discriminator at 32x32 (batch=dynamic, platforms=" \
           "['cpu'], compute=float32, quantize=int8)" in out
    assert "int8 weight-only: 2 tensors quantized" in out
    assert f"Saved serving artifact to {path} (" in out
    header, fn = serve.load_serving_fn(path, device="cpu")
    _, _, report = serve.export_model_quantized(
        "discriminator", model.state_dict(), SIZE, SIZE, arch_kwargs=DISC_KW,
        device="cpu")
    assert header["quantize_report"] == report
    assert header["arch_kwargs"] == DISC_KW
    assert header["source_checkpoint"] == os.path.abspath(pth)
    _, want = serve.load_serving_fn(pix2pix["discriminator"]["paths"]["int8"],
                                    device="cpu")
    a, b = _images(4, 2)
    assert torch.equal(fn(a, b), want(a, b))


def test_export_cli_from_jax_msgpack(tmp_path):
    """The JAX-written generator fixture (tools/make_msgpack_fixture.py)
    through the CLI: the artifact computes the JAX model's output saved
    beside it, within 1e-5."""
    out_path = str(tmp_path / "g.pt2")
    out = _run_export_cli(["--checkpoint-path", FIXTURE + ".msgpack",
                           "--output", out_path, "--target-size", "32x32",
                           "--num-downs", "5", "--ngf", "4"], REPO)
    assert "Exporting generator at 32x32" in out
    header, fn = serve.load_serving_fn(out_path, device="cpu")
    assert header["arch"] == "generator"
    assert header["arch_kwargs"] == {"num_downs": 5, "ngf": 4}
    expected = np.load(FIXTURE + "_expected.npz")
    got = fn((expected["x"] + 1.0) / 2.0).numpy()
    np.testing.assert_allclose(got, expected["y"] * 0.5 + 0.5, rtol=0,
                               atol=JAX_TOL)


@pytest.mark.parametrize("flags, message", [
    (["--platform", "tpu"], "invalid choice: 'tpu'"),
    # The id of the case this replaced, when the flag was not ported.
    pytest.param(["--aot-batch-sizes", "2,x"],
                 "batch sizes must be positive integers",
                 id="flags1-not ported yet"),
    (["--backend", "tpu"], "invalid choice: 'tpu'")])
def test_export_cli_refuses(flags, message, capsys):
    with pytest.raises(SystemExit) as exc:
        export_cli.main(["--checkpoint-path", "best_model.pth", *flags])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_export_cli_needs_an_arch():
    with pytest.raises(SystemExit, match="cannot infer --arch"):
        export_cli.main(["--checkpoint-path", "weights.bin"])


def _eval(root, work, name, *flags):
    path = str(work / f"{name}.json")
    result = eval_cli.main(["--root-dir", root, "--device", "cpu",
                            "--target-size", "32x32", "--output-dir",
                            str(work / name), "--num-visualizations", "0",
                            "--json-out", path, *flags])
    with open(path) as f:
        return result, json.load(f)


def test_evaluate_serving_artifact_matches_checkpoint(siamese, oscd_tree):
    """evaluate --serving-artifact gives the checkpoint path's report at
    float32 within 1e-6, with the artifact as its checkpoint."""
    root, work = str(oscd_tree), siamese["work"]
    artifact = siamese["paths"]["fp32"]
    got, art = _eval(root, work, "artifact", "--serving-artifact", artifact)
    want, ckp = _eval(root, work, "checkpoint", "--checkpoint-path",
                      siamese["pth"], "--compute-dtype", "float32")
    assert art["checkpoints"] == [artifact]
    assert ckp["checkpoints"] == [siamese["pth"]]
    assert art["n_samples"] == ckp["n_samples"] == 5
    assert art["per_city_counts"] == ckp["per_city_counts"]
    assert art["overall"] == pytest.approx(ckp["overall"], rel=0, abs=1e-6)
    for city, m in ckp["per_city"].items():
        assert art["per_city"][city] == pytest.approx(m, rel=0, abs=1e-6)
    np.testing.assert_array_equal(got["counts"], want["counts"])


def test_evaluate_serving_artifact_errors(siamese, oscd_tree, tmp_path,
                                          capsys):
    """With --ensemble: JAX's "mutually exclusive" error and None; a
    missing artifact: JAX's message and exit code 1."""
    root = str(oscd_tree)
    assert eval_cli.main([
        "--root-dir", root, "--device", "cpu", "--target-size", "32x32",
        "--serving-artifact", siamese["paths"]["fp32"], "--ensemble",
        siamese["pth"], siamese["pth"]]) is None
    assert "--serving-artifact and --ensemble are mutually exclusive" in \
        capsys.readouterr().out
    missing = str(tmp_path / "missing.pt2")
    proc = subprocess.run(
        [sys.executable, "-m", "gan_aug_pfa_torch.evaluate", "--root-dir",
         root, "--device", "cpu", "--target-size", "32x32",
         "--serving-artifact", missing, "--output-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert f"Error: Serving artifact not found at {missing}" in proc.stdout


def test_generate_synthetic_serving_artifact_writes_same_pngs(
        pix2pix, oscd_tree, tmp_path, capsys):
    """generate_synthetic --serving-artifact writes the checkpoint path's
    PNG bytes at float32; a missing artifact writes nothing."""
    tck.save_model(str(tmp_path / "generator_epoch_1.pth"),
                   pix2pix["generator"]["model"])
    common = ["--root-dir", str(oscd_tree), "--device", "cpu",
              "--target-size", "32x32", "--num-downs", "5", "--ngf", "8",
              "--gan-checkpoint-dir", str(tmp_path),
              "--generator-checkpoint-name", "generator_epoch_1.pth"]
    out = {k: str(tmp_path / k) for k in ("artifact", "checkpoint")}
    assert synth_cli.main([*common, "--synthetic-data-dir", out["artifact"],
                           "--serving-artifact",
                           pix2pix["generator"]["paths"]["fp32"]]) == 5
    assert synth_cli.main([*common, "--synthetic-data-dir",
                           out["checkpoint"]]) == 5
    files = sorted(os.path.relpath(os.path.join(d, f), out["checkpoint"])
                   for d, _, fs in os.walk(out["checkpoint"]) for f in fs)
    assert len(files) == 15
    for rel in files:
        with open(os.path.join(out["artifact"], rel), "rb") as f1, \
                open(os.path.join(out["checkpoint"], rel), "rb") as f2:
            assert f1.read() == f2.read(), rel
    capsys.readouterr()
    assert synth_cli.main([*common, "--synthetic-data-dir",
                           str(tmp_path / "none"), "--serving-artifact",
                           str(tmp_path / "missing.pt2")]) == 0
    assert "Error: Serving artifact not found" in capsys.readouterr().out
