"""Dataset scanning: the OSCD directory-tree contract (own copy of the JAX
package's ``data/scanner.py``, evaluation's ``mode="all"`` only).

  real sample:  <data_dir>/<city>/pair/img1.png + img2.png
  real label:   <label_dir>/<city>/cm/cm.png

Every file is decoded once at scan time (reference dataset.py:285-295
verifies and loads each image), so unreadable files are skipped here.
Decoding goes through the port's own PNG decoder (``data/png.py``); a file
that is not a PNG it supports counts as unreadable.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional

from ..config import IMAGES_SUBTREE, LABELS_SUBTREE
from . import png


@dataclasses.dataclass(frozen=True)
class Sample:
    img1: str
    img2: str
    label: Optional[str]
    city: str


def _image_readable(path: Optional[str]) -> bool:
    if path is None:
        return True
    try:
        png.decode_rgb(path)
        return True
    except (OSError, ValueError):
        return False


def scan_dataset(
    data_dir: str,
    label_dir: Optional[str] = None,
    verbose: bool = True,
) -> List[Sample]:
    """Walk city folders and collect valid (img1, img2, label) triplets
    (reference dataset.py:240-283 for real, non-synthetic samples)."""
    samples: List[Sample] = []
    skipped = 0
    for city_folder in sorted(glob.glob(os.path.join(data_dir, "*"))):
        if not os.path.isdir(city_folder):
            continue
        city = os.path.basename(city_folder)
        img1_file = os.path.join(city_folder, "pair", "img1.png")
        img2_file = os.path.join(city_folder, "pair", "img2.png")
        label_file = (
            os.path.join(label_dir, city, "cm", "cm.png") if label_dir
            else None
        )
        if not (os.path.exists(img1_file) and os.path.exists(img2_file)):
            skipped += 1
            continue
        if label_dir and not os.path.exists(label_file):
            skipped += 1
            continue
        if (
            _image_readable(img1_file)
            and _image_readable(img2_file)
            and _image_readable(label_file)
        ):
            samples.append(Sample(img1_file, img2_file, label_file, city))
        else:
            skipped += 1
    if verbose:
        print(
            f"Scanned {data_dir}. Found {len(samples)} valid samples. "
            f"Skipped {skipped}."
        )
    return samples


def dataset_paths(root_dir: str, dataset_subdir: str):
    """Resolve the nested OSCD image and label paths (reference
    dataset.py:302-307)."""
    base = os.path.join(root_dir, dataset_subdir)
    return (os.path.join(base, *IMAGES_SUBTREE),
            os.path.join(base, *LABELS_SUBTREE))


def create_sample_lists(
    root_dir: str, dataset_subdir: str, verbose: bool = True
) -> List[Sample]:
    """Every city with its label: the JAX package's ``mode="all"``, which
    evaluation scans (reference evaluate.py:315).  The train/val/test
    splits and the synthetic corpus come with the training slice."""
    real_image_base, real_label_base = dataset_paths(root_dir, dataset_subdir)
    return scan_dataset(real_image_base, real_label_base, verbose=verbose)
