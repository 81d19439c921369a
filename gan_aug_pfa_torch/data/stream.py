"""Streaming data path: train, synthesize and evaluate on corpora larger
than device memory (the JAX package's ``data/stream.py``).

The default path decodes the whole corpus once and keeps it on the device
(``pipelines.DeviceCache``): right for OSCD's tens of samples, impossible
once a synthetic corpus outgrows the card.  ``--stream`` keeps the corpus
off the device:

* ``StreamingSource`` holds the decoded corpus in host memory
  (``cache="host"``: each file decoded once, as the device cache does, one
  level down) or nothing at all (``cache="decode"``: each batch decoded on
  demand on a thread pool; the PNG decoder, ``data/native_loader.py``,
  releases the GIL in zlib and in its C unfilter).
* ``prefetch_batches`` stays ``depth`` batches ahead: batch assembly runs
  on worker threads, and ``put_fn`` (``BatchPut``) starts each batch's
  copy to the device as soon as it is assembled, on a copy stream of its
  own, so that the copy overlaps the previous step.  At most ``depth``
  batches are staged on the device at a time, so device memory holds
  O(depth) batches, never the corpus.
* The trainers consume the batches with the same batch-level step as the
  resident path (``SiameseTrainer.train_batch``,
  ``GANTrainer.train_batch``), so both paths compute the same numbers
  (tests/test_torch_stream.py).

Use ``--stream host`` when the corpus fits host memory but not the card;
``--stream decode`` when it fits neither.  The resident default stays the
fastest for small corpora (no per-step host work).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import native_loader
from .loader import build_cached_dataset, load_sample_arrays
from .scanner import Sample

Batch = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


class StreamingSource:
    """Batch source over a sample list at a fixed target size.

    cache="host"  : decode every sample once into host arrays.
    cache="decode": hold only file paths; decode batches on demand.

    Samples should come from the scanner (data/scanner.py), which has
    already decoded every file once and dropped the unreadable ones.  There
    is no second skip-at-build pass here: in decode mode an unreadable file
    raises a RuntimeError naming it when its batch is assembled (a skipped
    sample would shift batch shapes mid-epoch).
    """

    def __init__(
        self,
        samples: List[Sample],
        target_size: Tuple[int, int],
        cache: str = "host",
        workers: int = 8,
        verbose: bool = True,
    ):
        if cache not in ("host", "decode"):
            raise ValueError(
                f"StreamingSource cache must be 'host' or 'decode', "
                f"got {cache!r}"
            )
        self.cache = cache
        self.target_size = tuple(target_size)
        native_loader.get_lib()  # a decoder that does not build raises here
        # Two pools: batch-level staging tasks (submit) must never share
        # a pool with the per-sample decodes they fan out to, or staging
        # tasks occupy every worker and deadlock waiting for decodes.
        self._decode_pool = ThreadPoolExecutor(max_workers=max(1, workers))
        self._staging_pool = ThreadPoolExecutor(max_workers=4)
        if cache == "host":
            ds = build_cached_dataset(samples, self.target_size,
                                      verbose=False)
            self._host = ds
            self._samples = []
            self.cities = ds.cities
            self._n = len(ds)
            self._has_labels = ds.labels is not None
            if verbose:
                print(
                    f"Streaming source: {self._n} samples cached in host "
                    f"memory ({ds.img1.nbytes * 2 / 1e6:.1f} MB of image "
                    "data), batches copied to the device per step."
                )
        else:
            self._samples = list(samples)
            self._host = None
            self.cities = [s.city for s in self._samples]
            self._n = len(self._samples)
            self._has_labels = all(
                s.label is not None for s in self._samples
            )
            if verbose:
                print(
                    f"Streaming source: {self._n} samples decoded on "
                    f"demand ({max(1, workers)} decode threads), batches "
                    "copied to the device per step."
                )

    def __len__(self) -> int:
        return self._n

    @property
    def has_labels(self) -> bool:
        return self._has_labels

    def _decode_one(self, i: int):
        s = self._samples[i]
        try:
            return load_sample_arrays(s, self.target_size)
        except Exception as e:
            raise RuntimeError(
                f"Streaming decode failed for city {s.city} "
                f"({s.img1}): {e!r}. Streaming cannot skip samples "
                "mid-epoch; remove or fix the file (the scanner's "
                "readability pass normally catches this)."
            ) from e

    def batch(self, idx: np.ndarray) -> Batch:
        """One (img1, img2, labels) host batch for ``idx``: NHWC float32
        images in [0, 1] and (B, H, W) int32 labels (None without
        labels), the rows of ``data.loader.build_cached_dataset``."""
        if self._host is not None:
            ds = self._host
            lbl = ds.labels[idx] if ds.labels is not None else None
            return ds.img1[idx], ds.img2[idx], lbl
        triplets = list(
            self._decode_pool.map(self._decode_one, [int(i) for i in idx])
        )
        img1 = np.stack([t[0] for t in triplets])
        img2 = np.stack([t[1] for t in triplets])
        labels = (
            np.stack([t[2] for t in triplets]) if self._has_labels else None
        )
        return img1, img2, labels

    def submit(self, idx: np.ndarray, then=None):
        """Assemble a batch on a staging thread, and pass it through
        ``then`` there when given; returns a Future."""
        if then is None:
            return self._staging_pool.submit(self.batch, idx)
        return self._staging_pool.submit(lambda: then(self.batch(idx)))

    def close(self) -> None:
        self._staging_pool.shutdown(wait=False)
        self._decode_pool.shutdown(wait=False)


def prefetch_batches(
    source: StreamingSource,
    batch_indices: Sequence[np.ndarray],
    put_fn,
    depth: int = 2,
) -> Iterator[Tuple[np.ndarray, object]]:
    """Yield (idx, put_fn(host batch)) staying at most ``depth`` batches
    ahead.

    Batch assembly runs on the source's staging threads (for a
    ``BatchPut``, its host half too: the layout and the copy into pinned
    memory); ``put_fn`` is called as soon as a batch is ready, so its copy
    to the device is under way before the consumer asks for it.

    ``depth`` bounds BOTH queues: at most ``depth`` host batches are being
    assembled and at most ``depth`` device batches are staged.  The
    consumer's pace therefore limits device memory to O(depth) batches,
    never the corpus.
    """
    depth = max(1, depth)
    pin = put_fn.pin if isinstance(put_fn, BatchPut) else None
    pending = []  # (idx, future): assembly in flight, first in first out
    staged = []   # (idx, device batch): copy started
    it = iter(batch_indices)

    def fill():
        while len(pending) + len(staged) < depth:
            try:
                idx = next(it)
            except StopIteration:
                return
            pending.append((idx, source.submit(idx, pin)))

    fill()
    while pending or staged:
        # Stage the assembled batches (start their copies now), up to the
        # depth bound; always stage at least one so the loop progresses.
        while pending and (
            len(staged) == 0
            or (len(staged) < depth and pending[0][1].done())
        ):
            idx, fut = pending.pop(0)
            staged.append((idx, put_fn(fut.result())))
        yield staged.pop(0)
        fill()


class StagedBatch:
    """A batch on its way to the device: NCHW float32 images and (B, H, W)
    float32 labels (or None), with the event that ends its copy."""

    def __init__(self, tensors, event=None, device=None):
        self._tensors = tuple(tensors)
        self._event = event
        self._device = device

    def get(self):
        """The tensors, ready for work on the current stream: the stream
        waits for the copy's event, and each tensor is recorded on the
        stream, so that the caching allocator does not hand its memory to
        the copy stream again before the stream's work on it is done."""
        if self._event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._event)
            for t in self._tensors:
                if t is not None:
                    t.record_stream(stream)
            self._event = None
        return self._tensors


def _host_views(batch: Batch, labels: bool):
    """NCHW views of a host batch's images and its labels as float32; None
    where an array is absent, or for labels not wanted."""
    img1, img2, lbl = batch
    out = [None if a is None else
           torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)
           for a in (img1, img2)]
    out.append(torch.from_numpy(np.ascontiguousarray(lbl)).float()
               if labels and lbl is not None else None)
    return out


class PinnedBatch:
    """``BatchPut.pin``'s result: the host half of a put."""

    def __init__(self, tensors):
        self.tensors = tuple(tensors)


class BatchPut:
    """``prefetch_batches``' ``put_fn`` for ``device``: a host batch as
    the rows of ``pipelines.DeviceCache`` (NCHW images, float32 labels),
    array for array (an absent one stays None).

    On a CUDA device ``pin`` copies each host array (laid out NCHW, labels
    as float32) into pinned host memory, and the call copies that to the
    device with ``non_blocking=True`` on a copy stream of its own; the
    returned ``StagedBatch`` carries the copy's event, which ``get()``
    makes the consuming stream wait on.  ``prefetch_batches`` runs ``pin``
    on the source's staging threads (``copy_`` releases the GIL), so the
    consuming thread only starts the copies.  On the CPU the arrays become
    tensors in the same layout.  ``labels=False`` leaves the labels behind
    (the GAN step reads none)."""

    def __init__(self, device, labels: bool = True):
        self.device = torch.device(device)
        self.labels = labels
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def pin(self, batch: Batch) -> PinnedBatch:
        """The host half of a put; safe on any thread."""
        out = []
        for t in _host_views(batch, self.labels):
            if t is not None and self._stream is None:
                t = t.contiguous()
            elif t is not None:
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned.copy_(t)
                t = pinned
            out.append(t)
        return PinnedBatch(out)

    def __call__(self, batch) -> StagedBatch:
        """Put a host batch, or a ``PinnedBatch`` of this put's ``pin``."""
        if not isinstance(batch, PinnedBatch):
            batch = self.pin(batch)
        if self._stream is None:
            return StagedBatch(batch.tensors)
        with torch.cuda.stream(self._stream):
            out = [None if t is None else
                   t.to(self.device, non_blocking=True)
                   for t in batch.tensors]
            event = torch.cuda.Event()
            event.record(self._stream)
        return StagedBatch(out, event, self.device)
