"""Device memory a streamed Siamese epoch holds between steps (the bound
``chip_smoke.py`` phase 16 holds it to: (depth + 2) batches): the phase's
1,001-pair corpus at batch 4, three turns of a ``host`` and a ``decode``
epoch, each step's peak since the last step ended and the bytes held as it
starts, in batches, with steps/s.  Card only, about 3 minutes:

    python3 tools/stream_memory_probe.py
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gan_aug_pfa_torch.config import SiameseTrainConfig  # noqa: E402
from gan_aug_pfa_torch.data import native_loader as nl  # noqa: E402
from gan_aug_pfa_torch.data.loader import build_cached_dataset  # noqa: E402
from gan_aug_pfa_torch.data.scanner import create_sample_lists  # noqa: E402
from gan_aug_pfa_torch.data.stream import StreamingSource  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import build  # noqa: E402
from gan_aug_pfa_torch.ops.kernels import fused_loss as fl  # noqa: E402
from gan_aug_pfa_torch.pipelines import DeviceCache  # noqa: E402
from gan_aug_pfa_torch.train.siamese import SiameseTrainer  # noqa: E402


def main():
    build.build([fl.NAME, nl.NAME])
    root = tempfile.mkdtemp()
    cs.write_oscd_tree(root)
    cs.write_stream_corpus(root, 90)
    samples = create_sample_lists(root, cs.SUBDIR, mode="train",
                                  use_synthetic=True, verbose=False)
    ds = build_cached_dataset(samples, (128, 128), verbose=False)
    sources = {m: StreamingSource(samples, (128, 128), cache=m,
                                  verbose=False) for m in ("host", "decode")}
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=4), "cuda")
    cache = DeviceCache.from_dataset(ds, "cuda")
    trainer.train_epoch(cache, np.random.RandomState(0))
    del cache
    batch = cs.batch_bytes(4)
    step = SiameseTrainer.train_batch
    try:
        for turn in range(3):
            for mode, src in sources.items():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                gaps, starts = [], []

                def probed(*args, **kw):
                    gaps.append(torch.cuda.max_memory_allocated() - base)
                    starts.append(torch.cuda.memory_allocated() - base)
                    torch.cuda.reset_peak_memory_stats()
                    out = step(trainer, *args, **kw)
                    torch.cuda.reset_peak_memory_stats()
                    return out

                trainer.train_batch = probed
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer.train_epoch_streaming(src, np.random.RandomState(0),
                                              depth=2)
                torch.cuda.synchronize()
                rate = len(gaps) / (time.perf_counter() - t0)
                del trainer.train_batch
                g, s = np.array(gaps) / batch, np.array(starts) / batch
                print(f"turn {turn} {mode}: {rate:.2f} steps/s (probed); "
                      f"between steps max {g.max():.3f} batches, p99 "
                      f"{np.percentile(g, 99):.3f}, median "
                      f"{np.median(g):.3f} (over 4: {(g > 4).sum()} of "
                      f"{len(g)}); held as a step starts max {s.max():.3f}"
                      f", median {np.median(s):.3f}", flush=True)
    finally:
        for src in sources.values():
            src.close()


if __name__ == "__main__":
    main()
