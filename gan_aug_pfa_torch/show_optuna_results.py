"""Print the hyperparameter study report (the root
``show_optuna_results.py``; reference show_optuna_results.py).

    python -m gan_aug_pfa_torch.show_optuna_results [--storage URL]
        [--study-name NAME]

Reads the study file that ``python -m gan_aug_pfa_torch.train --tune``
writes (``optuna_study.db`` in the working directory), the JAX package's,
or one written by real Optuna."""

from __future__ import annotations

import argparse
from typing import List, Optional

from .tune import STORAGE, STUDY_NAME, display_study_results


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Show tuning study results")
    p.add_argument("--storage", type=str, default=STORAGE)
    p.add_argument("--study-name", type=str, default=STUDY_NAME)
    args = p.parse_args(argv)
    display_study_results(storage=args.storage, study_name=args.study_name)


if __name__ == "__main__":
    main()
