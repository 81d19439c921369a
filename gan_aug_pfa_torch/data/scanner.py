"""Dataset scanning: the OSCD directory-tree contract and the synthetic
corpus's pairing (own copy of the JAX package's ``data/scanner.py``).

  real sample:       <data_dir>/<city>/pair/img1.png + img2.png
  real label:        <label_dir>/<city>/cm/cm.png
  synthetic sample:  <data_dir>/<city>/img1_synth_N.png + img2_synth_N.png
  synthetic label:   <label_dir>/<city>/cm_synth_N.png
  synthetic city:    "<city>_synth"

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

from ..config import (
    IMAGES_SUBTREE,
    LABELS_SUBTREE,
    SYNTHETIC_DATA_DIR_DEFAULT,
    TRAIN_CITIES,
    VAL_CITIES,
)
from . import png


@dataclasses.dataclass(frozen=True)
class Sample:
    img1: str
    img2: str
    label: Optional[str]
    city: str

    @property
    def is_synthetic(self) -> bool:
        return self.city.endswith("_synth")


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
    is_synthetic: bool = False,
    verbose: bool = True,
) -> List[Sample]:
    """Walk city folders and collect valid (img1, img2, label) triplets
    (reference dataset.py:240-283): the same globbing, the same pairing of
    synthetic files by basename, the same skip counting."""
    samples: List[Sample] = []
    skipped = 0
    for city_folder in sorted(glob.glob(os.path.join(data_dir, "*"))):
        if not os.path.isdir(city_folder):
            continue
        city = os.path.basename(city_folder)
        if is_synthetic:
            for img1_file in sorted(
                glob.glob(os.path.join(city_folder, "img1_synth_*.png"))
            ):
                base = os.path.basename(img1_file).replace("img1_", "")
                img2_file = os.path.join(city_folder, f"img2_{base}")
                label_file = (
                    os.path.join(label_dir, city, f"cm_{base}") if label_dir
                    else None
                )
                if not os.path.exists(img2_file):
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
                    samples.append(Sample(img1_file, img2_file, label_file,
                                          f"{city}_synth"))
                else:
                    skipped += 1
            continue
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


def dataset_paths(root_dir: str, dataset_subdir: str,
                  synthetic_data_dir: str = SYNTHETIC_DATA_DIR_DEFAULT):
    """Resolve the nested OSCD image and label paths and the synthetic
    corpus's (reference dataset.py:302-307)."""
    base = os.path.join(root_dir, dataset_subdir)
    synth_base = os.path.join(root_dir, synthetic_data_dir)
    return (os.path.join(base, *IMAGES_SUBTREE),
            os.path.join(base, *LABELS_SUBTREE),
            os.path.join(synth_base, "images"),
            os.path.join(synth_base, "labels"))


def create_sample_lists(
    root_dir: str,
    dataset_subdir: str,
    synthetic_data_dir: str = SYNTHETIC_DATA_DIR_DEFAULT,
    mode: str = "train",
    use_synthetic: bool = False,
    verbose: bool = True,
) -> List[Sample]:
    """The split sample list (reference dataset.py:298-352).

    mode="train": TRAIN_CITIES with labels, plus, with ``use_synthetic``,
        the synthetic corpus of the train cities (the ``_synth`` suffix
        stripped for the filter, as in dataset.py:342).
    mode="val":   VAL_CITIES with labels.
    mode="test":  every city folder present, no labels.
    mode="all":   every city with its label (evaluation, reference
        evaluate.py:315).
    """
    real_image_base, real_label_base, synth_image_base, synth_label_base = (
        dataset_paths(root_dir, dataset_subdir, synthetic_data_dir)
    )
    if mode == "train":
        target_cities, has_labels = TRAIN_CITIES, True
    elif mode == "val":
        target_cities, has_labels = VAL_CITIES, True
    elif mode == "test":
        try:
            target_cities = [
                d for d in os.listdir(real_image_base)
                if os.path.isdir(os.path.join(real_image_base, d))
            ]
        except FileNotFoundError:
            target_cities = []
        has_labels = False
    elif mode == "all":
        target_cities, has_labels = None, True
    else:
        raise ValueError(f"Invalid mode: {mode}")

    real = scan_dataset(real_image_base,
                        real_label_base if has_labels else None,
                        verbose=verbose)
    if mode in ("train", "val"):
        real = [s for s in real if s.city in target_cities]

    if mode == "train" and use_synthetic:
        if not os.path.isdir(synth_image_base):
            if verbose:
                print(f"Warning: Synthetic image directory not found at "
                      f"{synth_image_base}. Cannot use synthetic data.")
            return real
        synth = scan_dataset(synth_image_base, synth_label_base,
                             is_synthetic=True, verbose=verbose)
        synth = [s for s in synth
                 if s.city.replace("_synth", "") in target_cities]
        if verbose:
            print(f"Combining {len(real)} real and {len(synth)} synthetic "
                  f"samples for training.")
        return real + synth
    return real
