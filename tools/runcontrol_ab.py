#!/usr/bin/env python3
"""Default-path throughput of this tree against another tree of the port,
in turns on one card: does run control cost the default paths anything?

    python3 tools/runcontrol_ab.py --other DIR [--order other,this,this,other]

``DIR`` holds another checkout of the repository (for instance the parent
commit unpacked with ``git archive``).  For each entry of ``--order`` a
fresh process, started in that tree, builds the tree's kernels, writes
``chip_smoke``'s seeded 14-city OSCD tree and runs that tree's own
``chip_smoke.train_throughput`` (train steps/s and pairs/s at batch 4 and
16, bf16, 128x128, then a profile of one epoch: busy share and launches)
and ``chip_smoke.gan_throughput`` (GAN steps/s at batch 1, bf16, 256x256,
a profiled epoch, launches a step), then ``train_throughput`` once more:
that second pass runs after two profiler sessions in the same process.
Each child's output is printed with its tree's label.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from gan_aug_pfa_torch.data.loader import build_cached_dataset
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.ops.kernels import build
from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
from gan_aug_pfa_torch.ops.kernels import fused_loss as fl
from gan_aug_pfa_torch.ops.kernels import photometric as ph

build.build([cc.NAME, fl.NAME, ph.NAME])
with tempfile.TemporaryDirectory() as root:
    cs.write_oscd_tree(root)
    train = build_cached_dataset(create_sample_lists(
        root, cs.SUBDIR, mode="train", verbose=False), (128, 128),
        verbose=False)
    every = build_cached_dataset(create_sample_lists(
        root, cs.SUBDIR, mode="all", verbose=False), (256, 256),
        verbose=False)
cs.train_throughput(torch, train)
cs.gan_throughput(torch, every)
print("-- train throughput again, after two profiler sessions --")
cs.train_throughput(torch, train)
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True)
    p.add_argument("--order", default="other,this,this,other")
    args = p.parse_args(argv)
    trees = {"this": REPO, "other": os.path.abspath(args.other)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    failed = 0
    for i, label in enumerate(args.order.split(",")):
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", CHILD],
                              cwd=trees[label], capture_output=True,
                              text=True, timeout=900)
        print(f"=== run {i + 1}: {label} ({trees[label]}), exit "
              f"{proc.returncode}, {time.time() - t0:.1f} s")
        for line in proc.stdout.splitlines():
            if not line.startswith("  "):  # the profiles' kernel rows
                print(line)
        if proc.returncode:
            print(proc.stderr[-4000:])
            failed += 1
    print(smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
