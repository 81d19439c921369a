"""The data mesh: data-parallel training over every visible card (the JAX
package's ``parallel/mesh.py``, its 'data' axis).

JAX runs one program over a device mesh and lets XLA insert the
reductions.  Here each card runs its own process, and a
``torch.distributed`` group joins them:

  * a global batch whose size divides by the world size is split into
    contiguous row blocks, one a rank in rank order; any other batch is
    replicated, every rank running all of it (``shard_rows``; JAX
    ``train/siamese.py:333-340``, ``train/gan.py:393-398``);
  * parameters, optimizer state and the dataset are whole on every rank;
  * a sharded step's BatchNorm statistics (``batchnorm.py``) and losses
    are those of the global batch, and its gradients are summed over the
    ranks (``reduce_gradients``); a replicated step takes rank 0's
    gradients, so that no rank counts the batch twice and the ranks stay
    equal;
  * only ``all_reduce`` and ``broadcast`` are used (and the
    differentiable all-reduce of ``torch.distributed.nn``), which gloo
    also runs on CUDA tensors: one code path serves gloo on the CPU, NCCL
    with one rank a card and gloo with several ranks sharing one card.

The backend is not a flag: NCCL where every rank has a card of its own,
gloo otherwise (CPU runs too).  A rank's card is
``cuda:{LOCAL_RANK % device_count}``.

Two ways to start ranks, both ending in ``maybe_distributed_init``:
``torchrun`` (or any launcher that sets ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, the counterpart of
JAX's coordinator variables), or ``launch``, which the training CLIs call:
on a host with several cards it starts one worker a card with
``torch.multiprocessing`` and a rendezvous on ``localhost``.  A failed
worker or group ends the run with its error; nothing falls back to one
card.

A ``DataMesh`` may span a sub-group of the world (``group``): tuning
with ``--parallel-trials k`` partitions the ranks into k data meshes, one
trial each (``tune.partition_devices``, ``tune.tune_on_ranks``).  Every
collective of a mesh names its group, and ``broadcast`` maps the mesh's
rank 0 to its global rank.

``make_mesh(n, ("data", "model"), (d, m))`` adds the tensor-parallel
'model' axis (JAX ``param_shardings``, reached only through the API, as
in JAX): d x m ranks laid out row-major, as JAX's
``np.asarray(devs).reshape(shape)``, so rank r is data index r // m and
model index r % m.  The mesh's ``world_size``, ``rank`` and ``group`` are
then its data axis (the ranks with its model index), which the trainers'
rows, global BatchNorm, losses and gradient sums read as before, and
``model_size``, ``model_rank`` and ``model_group`` its model axis (the
ranks with its data index, which run the same rows).  ``tensor.py``
shards the wide leaves over the model group.

``make_mesh(n, ("data", "spatial"[, "model"]), (d, s[, m]))`` adds the
'spatial' axis (``spatial.py``; JAX puts the input batches' height on it,
reached only through the API, as in JAX): rank r of (d, s, m) is data
index r // (s m), spatial index (r // m) % s and model index r % m.  The
mesh's ``spatial_size``, ``spatial_rank`` and ``spatial_group`` are its
spatial axis (the ranks with its data and model index, which hold the
height blocks of the same rows), and ``data_spatial_group`` the ranks
with its model index: what a sharded step's split statistics, losses and
gradients sum over (``sum_group``, ``split``).  A batch that does not
divide by d is replicated over 'data' and still split over 'spatial', as
in JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .spatial import Split

TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


class LaunchError(ValueError):
    """A launch that cannot train as asked (the CLIs exit 2 with it)."""


def shard_rows(n: int, world_size: int, rank: int) -> Optional[slice]:
    """The rows of a global batch of ``n`` that ``rank`` runs: the
    rank's contiguous block of n / world_size rows when the world size
    divides n, else None (the batch is replicated: every rank runs all
    n rows)."""
    if world_size < 1 or not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of a world of {world_size}")
    if n % world_size:
        return None
    per = n // world_size
    return slice(rank * per, (rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis over the ranks of a process group: this process's
    ``rank`` of ``world_size`` (its rank in ``group``), its ``device``
    and the group's ``backend``; ``group`` None is the default group.
    Under a 'model' axis (``model_size`` > 1) this process is also
    ``model_rank`` of the ``model_group`` that shares its rows; under a
    'spatial' axis (``spatial_size`` > 1) ``spatial_rank`` of the
    ``spatial_group`` that splits the height of its rows, and one of the
    ``data_spatial_group`` that shares its model index."""

    world_size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None
    model_size: int = 1
    model_rank: int = 0
    model_group: Any = None
    spatial_size: int = 1
    spatial_rank: int = 0
    spatial_group: Any = None
    data_spatial_group: Any = None

    @property
    def size(self) -> int:
        """The mesh's ranks: the product of its three extents."""
        return self.world_size * self.spatial_size * self.model_size

    @property
    def is_main(self) -> bool:
        """Rank 0 of the mesh, the one that prints and writes files."""
        return self.rank == 0 and self.spatial_rank == 0 and \
            self.model_rank == 0

    def sum_group(self, sharded: bool):
        """(group, ranks) that a step's losses and split BatchNorm
        statistics sum over: the data group after a sharded step
        (data x spatial under a 'spatial' axis), the spatial group after a
        replicated one; None for a replicated step without the axis."""
        if self.spatial_size == 1:
            return (self.group, self.world_size) if sharded else None
        if sharded:
            return (self.data_spatial_group,
                    self.world_size * self.spatial_size)
        return self.spatial_group, self.spatial_size

    def split(self, sharded: bool):
        """The ``spatial.Split`` of a sharded or replicated step, None
        without a 'spatial' axis."""
        if self.spatial_size == 1:
            return None
        return Split(self.spatial_group, self.spatial_size,
                     self.spatial_rank, self.sum_group(sharded)[0])

    def rows(self, n: int) -> Optional[slice]:
        """``shard_rows`` of this rank: its block of a batch of ``n``, or
        None when the batch is replicated."""
        return shard_rows(n, self.world_size, self.rank)

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place; returns it."""
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s (of this mesh) ``tensor`` on every rank, in
        place; returns it.  ``torch.distributed.broadcast`` names its
        source by its rank in the world, which a sub-group's rank 0 is
        not."""
        root = (src if self.group is None
                else dist.get_global_rank(self.group, src))
        dist.broadcast(tensor, root, group=self.group)
        return tensor

    def agree(self, flag: bool) -> bool:
        """True on every rank of the mesh when ``flag`` is true on any (one
        host sync): a shutdown one rank saw stops them all after the same
        epoch."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        self.all_reduce_sum(t)
        for size, group in ((self.spatial_size, self.spatial_group),
                            (self.model_size, self.model_group)):
            if size > 1:
                dist.all_reduce(t, group=group)
        return bool(t.item())

    def broadcast_values(self, *values: float) -> list:
        """Rank 0's ``values`` (floats) on every rank of the mesh: the one
        value a decision acts on (one host sync)."""
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        self.broadcast(t)
        for size, group in ((self.spatial_size, self.spatial_group),
                            (self.model_size, self.model_group)):
            if size > 1:
                dist.broadcast(t, dist.get_global_rank(group, 0),
                               group=group)
        return t.tolist()

    def reduce_gradients(self, params, sharded: bool) -> None:
        """Make the gradients of ``params`` (those that have one) the
        update's on every rank, in one collective over one flat buffer:
        the sum over the ranks after a sharded step (each rank's
        backward gives its rows' part of the global loss's gradient),
        rank 0's after a replicated one (every rank holds the whole
        gradient).  Under a 'spatial' axis each rank's gradient is its
        height blocks' part (``spatial.py``): a sharded step sums over
        data x spatial, a replicated one over the spatial group before
        it takes data rank 0's.  Under a 'model' axis the ranks of a
        model group computed the same gradient of each replicated leaf, up
        to the card's atomics; they take model rank 0's, so that their
        copies stay equal (a sharded leaf's block has one owner)."""
        params = list(params)
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = _flatten_dense_tensors(grads)
        if sharded:
            dist.all_reduce(flat, group=self.sum_group(True)[0])
        else:
            if self.spatial_size > 1:
                dist.all_reduce(flat, group=self.spatial_group)
            if self.world_size > 1:
                self.broadcast(flat)
        torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))
        if self.model_size > 1:
            grads = [p.grad for p in params if p.grad is not None
                     and not getattr(p, "model_sharded", False)]
            if grads:
                flat = _flatten_dense_tensors(grads)
                dist.broadcast(flat, dist.get_global_rank(
                    self.model_group, 0), group=self.model_group)
                torch._foreach_copy_(grads,
                                     _unflatten_dense_tensors(flat, grads))


def torchrun_env() -> bool:
    """Whether this process was started as a rank of a group
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` set)."""
    return all(os.environ.get(v) for v in TORCHRUN_VARS)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    run (whatever index ``device`` names), ``device`` otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def backend_for(device, local_world_size: int) -> str:
    """NCCL when every rank of the host has a card of its own, gloo
    otherwise (a CPU run, or ranks sharing a card: NCCL refuses two ranks
    on one device)."""
    if (torch.device(device).type == "cuda"
            and local_world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def maybe_distributed_init(device="cuda",
                           timeout: Optional[datetime.timedelta] = None
                           ) -> bool:
    """Join the process group that the environment describes (``torchrun``'s
    variables; ``env://`` rendezvous) on this rank's device and backend,
    its collectives waiting up to ``timeout`` (None: torch's default).
    A no-op that returns False without those variables, or when the group
    exists already.  A failed init raises."""
    if not torchrun_env() or dist.is_initialized():
        return False
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device)
    backend = backend_for(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # CPU ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]), timeout=timeout)
    return True


AXES = ("data", "spatial", "model")


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device="cuda") -> DataMesh:
    """The mesh over every rank of the process group (JAX ``make_mesh``,
    mesh.py:28-67), on ``device``'s kind: axes any of "data", "spatial"
    and "model"; ``shape`` by default every rank on the first axis.
    Without a group it is one rank on ``device``.  With a 'spatial' or
    'model' extent above 1 every rank creates the data groups, the groups
    of each other axis whose extent is above 1 and (with 'spatial') the
    data x spatial groups
    (``torch.distributed.new_group``, in one order on every rank).  Raises
    ValueError, with what to do, when ``n_devices`` is not what the group
    holds, or the shape does not fit the axes or the ranks (JAX's
    errors)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"make_mesh wanted {n_devices} devices")
        if n_devices > world:
            raise ValueError(
                f"make_mesh wanted {n_devices} devices but this process "
                f"group has {world} rank(s). Hint: start one process a card "
                f"(torchrun --nproc-per-node {n_devices} -m "
                "gan_aug_pfa_torch.train ..., or the bare CLI on a host "
                f"with {n_devices} cards); on the CPU, start "
                f"{n_devices} gloo ranks with --device cpu.")
        if n_devices < world:
            raise ValueError(
                f"make_mesh wanted {n_devices} of the group's {world} "
                "ranks: the data axis spans every rank (only tuning "
                "partitions the ranks into sub-meshes, tune.tune_on_ranks)."
                " Start as many ranks as the mesh needs.")
    axis_names = tuple(axis_names)
    shape = ((world,) + (1,) * (len(axis_names) - 1) if shape is None
             else tuple(int(s) for s in shape))
    if len(shape) != len(axis_names):
        raise ValueError(
            f"make_mesh shape {shape} has {len(shape)} dims but "
            f"axis_names {axis_names} has {len(axis_names)}.")
    if (not set(axis_names) <= set(AXES)
            or len(set(axis_names)) != len(axis_names)):
        raise ValueError(f"make_mesh axis_names {axis_names}: each of "
                         f"{AXES}, at most once")
    if int(np.prod(shape)) != world:
        raise ValueError(
            f"make_mesh shape {shape} needs {int(np.prod(shape))} devices "
            f"but {world} are selected (of {world} visible). Pass a shape "
            "whose product matches, or adjust n_devices.")
    extent = dict(zip(axis_names, shape))
    data, spatial, model = (extent.get(a, 1) for a in AXES)
    if world == 1:
        dev = torch.device(device)
        return DataMesh(1, 0, dev, dist.get_backend() if
                        dist.is_initialized() else None)
    if model == 1 and spatial == 1:
        return DataMesh(world, dist.get_rank(), rank_device(device),
                        dist.get_backend())
    # Row-major ranks, as JAX reshapes its device list; a rank's group on
    # an axis shares every index but that axis's.
    coords = np.stack(np.unravel_index(np.arange(world), shape), axis=1)
    rank = dist.get_rank()

    def groups_varying(varying):
        """The group of this rank among those that share every index but
        the axes ``varying`` (one group a value of the others, each made
        on every rank, in one order), and its rank there."""
        fixed = [i for i, a in enumerate(axis_names) if a not in varying]
        keys = sorted({tuple(c[fixed]) for c in coords})
        mine = None
        for key in keys:
            ranks = [r for r in range(world)
                     if tuple(coords[r][fixed]) == key]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group, ranks.index(rank)
        return mine

    dgroup, drank = groups_varying({"data"})
    mgroup, mrank = groups_varying({"model"}) if model > 1 else (None, 0)
    kw = {}
    if spatial > 1:
        sgroup, srank = groups_varying({"spatial"})
        kw = dict(spatial_size=spatial, spatial_rank=srank,
                  spatial_group=sgroup,
                  data_spatial_group=groups_varying({"data", "spatial"})[0])
    return DataMesh(data, drank, rank_device(device), dist.get_backend(),
                    group=dgroup, model_size=model, model_rank=mrank,
                    model_group=mgroup, **kw)


def default_mesh(enabled: bool, device="cuda") -> Optional[DataMesh]:
    """The trainers' mesh (JAX pipelines.py:55-58 ``_default_mesh``):
    every rank of the process group when ``enabled`` (``data_parallel``)
    and the group holds more than one rank, else None (one device)."""
    if (enabled and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return make_mesh(device=device)
    return None


def free_port() -> int:
    """A TCP port on ``localhost`` that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, fn: Callable, args: Sequence, nprocs: int,
            port: int, device, results, timeout=None) -> None:
    """One spawned rank: ``torchrun``'s variables, the group, ``fn``; rank
    0 reports whether ``fn`` returned a result, a rank that raises when
    and what."""
    os.environ.update(WORLD_SIZE=str(nprocs), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    maybe_distributed_init(device, timeout)
    try:
        result = fn(*args)
    except Exception:
        results.put((time.monotonic(), rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()
    if rank == 0:
        results.put(result is not None)


def spawn(fn: Callable, args: Sequence, nprocs: int, device="cuda",
          timeout: Optional[datetime.timedelta] = None) -> Optional[dict]:
    """Run ``fn(*args)`` on ``nprocs`` ranks of one group, one process
    each (``torch.multiprocessing.spawn``; ``fn`` and ``args`` must
    pickle), the group's collectives waiting up to ``timeout``.  Returns
    ``{"world_size": nprocs}`` when rank 0's ``fn`` returned a result,
    None when it returned None.  A worker that raises stops the others and
    raises here: the first error raised, with its rank and traceback, not
    the closed connections it causes on the other ranks.  One that exits
    with a code (an argument error, say) exits this process with it."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    try:
        mp.spawn(_worker, args=(fn, tuple(args), nprocs, free_port(), device,
                                results, timeout), nprocs=nprocs, join=True)
    except mp.ProcessRaisedException as e:
        errors = []
        while not results.empty():
            item = results.get()
            if isinstance(item, tuple):
                errors.append(item)
        if not errors:
            raise
        _, rank, trace = min(errors)
        raise RuntimeError(f"rank {rank} of {nprocs} failed first:\n"
                           f"{trace}") from e
    except mp.ProcessExitedException as e:
        if e.exit_code and e.exit_code > 0:
            raise SystemExit(e.exit_code) from e
        raise
    return {"world_size": nprocs} if results.get() else None


def launch(fn: Callable, args: Sequence, data_parallel: bool = True,
           device="cuda"):
    """Run a training entry point ``fn(*args)`` as the JAX CLIs do, data
    parallel over every visible card by default:

    * under ``torchrun``'s variables: this process is one rank; the group
      is joined, ``fn`` runs, the group is left;
    * with ``data_parallel``, ``device`` "cuda" (no index) and more than
      one card: one worker a card (``spawn``);
    * otherwise ``fn(*args)`` in this process, on one device.

    ``data_parallel`` False under ``torchrun`` with more than one rank is
    an error: each rank would train the whole model alone and write the
    same files (``LaunchError``)."""
    if torchrun_env() and int(os.environ["WORLD_SIZE"]) > 1:
        if not data_parallel:
            raise LaunchError(
                "--no-data-parallel trains on one device: start one "
                f"process, not {os.environ['WORLD_SIZE']} ranks")
        joined = maybe_distributed_init(device)
        try:
            return fn(*args)
        finally:
            if joined:
                dist.destroy_process_group()
    if (data_parallel and str(device) == "cuda"
            and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        return spawn(fn, args, torch.cuda.device_count(), device)
    return fn(*args)
