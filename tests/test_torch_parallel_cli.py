"""The training CLI data-parallel on the CPU: two ``python -m
gan_aug_pfa_torch.train --device cpu`` processes under ``torchrun``'s
variables (gloo), and the launcher's spawned workers
(``parallel.mesh.spawn``).

  * only rank 0 prints and writes (one ``run_start`` in the run log);
    its ``best_model.pth`` loads ``strict=True`` into the single-device
    model and into the JAX package's reader, and matches the
    single-process CLI's (float32: losses and running statistics within
    1e-5, parameters as the test states);
  * SIGTERM to rank 1 alone stops both ranks after the same epoch with
    exit 0 and the resume state at it; ``--resume`` on two ranks goes on;
  * ``--no-data-parallel`` in one process is the plain run, bit for bit;
    under ``torchrun`` with several ranks it exits 2;
  * ``spawn`` runs a function on two ranks of one group and raises a
    worker's error.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from gan_aug_pfa_torch.config import SiameseTrainConfig
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.parallel import mesh as pm
from gan_aug_pfa_torch.train import __main__ as train_cli
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2

# Rank 1 under SIGTERM from itself as soon as its shutdown guard is set
# (before the first epoch), then the CLI as ``python -m`` runs it.
_SIGTERM_AT_GUARD = """
import os, runpy, signal
from gan_aug_pfa_torch.utils import signals
enter = signals.GracefulShutdown.__enter__
def enter_then_signal(self):
    out = enter(self)
    os.kill(os.getpid(), signal.SIGTERM)
    return out
signals.GracefulShutdown.__enter__ = enter_then_signal
runpy.run_module("gan_aug_pfa_torch.train", run_name="__main__")
"""


def _common(root, ckpt_dir, *extra):
    return ["--root-dir", str(root), "--device", "cpu", "--target-size",
            "32x32", "--compute-dtype", "float32", "--checkpoint-dir",
            str(ckpt_dir), *extra]


def _ranks(args, sigterm_rank1=False, timeout=900):
    """``python -m gan_aug_pfa_torch.train *args`` as ranks 0 and 1 of one
    gloo group on ``localhost``: [(returncode, stdout, stderr)] by rank.
    Alone a run takes seconds; the timeout leaves room for Tier-1's six
    workers sharing the host's cores."""
    port = str(pm.free_port())
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, WORLD_SIZE=str(WORLD), RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="2",
                   PYTHONPATH=os.pathsep.join(
                       [REPO, os.environ.get("PYTHONPATH", "")]))
        head = ([sys.executable, "-c", _SIGTERM_AT_GUARD]
                if sigterm_rank1 and rank == 1
                else [sys.executable, "-m", "gan_aug_pfa_torch.train"])
        procs.append(subprocess.Popen(head + list(args), cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
        return [(p.returncode, *out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _events(path):
    with open(path) as f:
        return [json.loads(line)["event"] for line in f]


@pytest.fixture(scope="module")
def two_ranks(oscd_tree, tmp_path_factory):
    """One epoch on two ranks and the same run in one process."""
    with dropped(tmp_path_factory.mktemp("parallel_cli")) as tmp:
        log = tmp / "run.jsonl"
        ranks = _ranks(_common(oscd_tree, tmp / "ranks", "--num-epochs",
                               "1", "--log-jsonl", str(log)))
        one = train_cli.main(_common(oscd_tree, tmp / "one", "--num-epochs",
                                     "1"))
        yield {"ranks": ranks, "tmp": tmp, "log": log, "one": one}


def test_only_rank_0_prints_and_writes(two_ranks):
    (rc0, out0, err0), (rc1, out1, err1) = two_ranks["ranks"]
    assert rc0 == 0 and rc1 == 0, err0 + err1
    assert "Epoch 1/1" in out0 and "Best model saved" in out0
    assert out1 == ""
    assert _events(two_ranks["log"]) == ["run_start", "epoch", "checkpoint",
                                         "checkpoint", "run_end"]
    assert sorted(os.listdir(two_ranks["tmp"] / "ranks")) == [
        "best_model.pth", "last_state.pth"]


def test_two_rank_checkpoint_loads_strict_and_matches_one_process(two_ranks):
    """The 2-rank ``best_model.pth`` loads strict, key for key, into the
    single-device model and through the JAX package's ``.pth`` reader.
    Against the single-process run (one Adam step at float32): the
    losses within 1e-5, the running statistics within 1e-5, and the
    parameters within 1e-6 (a few ulps of the weights) on 99% of the
    elements, each within 2 lr: the first Adam step moves an element by
    lr times the sign of its gradient, and where a gradient lies within
    float32 rounding of 0, the ranks' other order of sums can flip it
    (measured: 0.34% of the elements beyond 1e-6, the median 0)."""
    from gan_aug_pfa_tpu import interop as ji

    path = two_ranks["tmp"] / "ranks" / "best_model.pth"
    got = torch.load(path, weights_only=True)
    model = SiameseUNet()
    model.load_state_dict(got, strict=True)
    assert list(got) == list(model.state_dict())
    ji.variables_from_torch_file(str(path))  # the JAX CLIs' reader
    want = torch.load(two_ranks["tmp"] / "one" / "best_model.pth",
                      weights_only=True)
    lr = SiameseTrainConfig().learning_rate
    close = total = 0
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
            continue
        err = (got[k] - w).abs()
        tol = 1e-5 * float(w.abs().max())
        if "running" in k:
            assert float(err.max()) <= tol, k
        else:
            assert float(err.max()) <= 2 * lr, k
            close += int((err <= 1e-6).sum())
            total += err.numel()
    assert close >= 0.99 * total
    last = torch.load(two_ranks["tmp"] / "ranks" / "last_state.pth",
                      weights_only=True)
    one = two_ranks["one"]
    assert last["best_val_loss"] == pytest.approx(one["val_loss"][0],
                                                  rel=1e-5)
    (_, out0, _), _ = two_ranks["ranks"]
    train_loss = float(out0.split("Train Loss: ")[1].split(",")[0])
    assert train_loss == pytest.approx(one["train_loss"][0], abs=1e-4)


def test_sigterm_on_one_rank_stops_both_and_resume_continues(oscd_tree,
                                                             tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    (rc0, out0, err0), (rc1, out1, err1) = _ranks(
        _common(oscd_tree, ckpt_dir, "--num-epochs", "3"),
        sigterm_rank1=True)
    assert rc0 == 0 and rc1 == 0, err0 + err1
    assert "Received signal SIGTERM" in out1
    assert "Epoch 1/3" in out0 and "Epoch 2/3" not in out0
    assert "resume state saved at epoch 1" in out0
    state = torch.load(ckpt_dir / "last_state.pth", weights_only=True)
    assert state["epoch"] == 1

    (rc0, out0, err0), (rc1, _, err1) = _ranks(
        _common(oscd_tree, ckpt_dir, "--num-epochs", "2", "--resume"))
    assert rc0 == 0 and rc1 == 0, err0 + err1
    assert "at epoch 2" in out0 and "Epoch 2/2" in out0
    assert "Epoch 1/2" not in out0
    state = torch.load(ckpt_dir / "last_state.pth", weights_only=True)
    assert state["epoch"] == 2


def test_no_data_parallel_is_the_plain_run_bit_for_bit(oscd_tree, tmp_path,
                                                       monkeypatch):
    runs = {}
    for name, flag in (("plain", []), ("flag", ["--no-data-parallel"])):
        hist = train_cli.main(_common(oscd_tree, tmp_path / name,
                                      "--num-epochs", "1", *flag))
        runs[name] = (hist, torch.load(tmp_path / name / "best_model.pth",
                                       weights_only=True))
    assert runs["plain"][0]["train_loss"] == runs["flag"][0]["train_loss"]
    for k, v in runs["plain"][1].items():
        assert torch.equal(v, runs["flag"][1][k]), k
    assert runs["plain"][0]["trainer"].mesh is None

    for var, value in (("WORLD_SIZE", "2"), ("RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(var, value)
    with pytest.raises(SystemExit) as exc:
        train_cli.main(_common(oscd_tree, tmp_path / "x", "--num-epochs",
                               "1", "--no-data-parallel"))
    assert exc.value.code == 2


def _spawned(out_dir, fail_rank):
    """A worker of ``spawn``: the rank's mesh, one agreement and one
    broadcast, written to ``out_dir``; ``fail_rank`` raises."""
    mesh = pm.default_mesh(True, "cpu")
    seen = mesh.agree(mesh.rank == 1)
    value = mesh.broadcast_values(float(mesh.rank + 10))
    if mesh.rank == fail_rank:
        raise RuntimeError(f"rank {mesh.rank} failed")
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump([mesh.world_size, mesh.backend, seen, value], f)
    return mesh.rank


def test_spawn_runs_two_ranks_and_raises_a_worker_error(tmp_path):
    assert pm.spawn(_spawned, (str(tmp_path), -1), WORLD, "cpu") == {
        "world_size": WORLD}
    for rank in range(WORLD):
        with open(tmp_path / f"rank{rank}.json") as f:
            assert json.load(f) == [WORLD, "gloo", True, [10.0]]
    with pytest.raises(Exception, match="rank 1 failed"):
        pm.spawn(_spawned, (str(tmp_path), 1), WORLD, "cpu")
