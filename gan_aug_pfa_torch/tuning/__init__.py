"""Hyperparameter tuning (the JAX package's ``tuning/``).

The reference uses Optuna with SQLite storage and a MedianPruner
(reference train.py:167-255, 338-374).  Optuna is not installed on the
card's machine, so this package carries an Optuna-API-compatible study
implementation (``ministudy``, a copy of the JAX package's) with:

  * sqlite:/// persistent storage (its own schema, the JAX package's),
  * suggest_loguniform / suggest_float / suggest_categorical / suggest_int,
  * trial.report + MedianPruner-compatible should_prune,
  * random sampling with a TPE-style guided mode after startup trials,
  * create_study(load_if_exists=...), study.best_trial, study.trials.

When the real optuna IS importable it is used directly (same call sites).
"""

try:  # pragma: no cover - depends on environment
    import optuna as _optuna  # type: ignore

    create_study = _optuna.create_study
    load_study = _optuna.load_study
    TrialPruned = _optuna.exceptions.TrialPruned
    MedianPruner = _optuna.pruners.MedianPruner
    TrialState = _optuna.trial.TrialState
    USING_OPTUNA = True
except ImportError:
    from .ministudy import (  # noqa: F401
        MedianPruner,
        TrialPruned,
        TrialState,
        create_study,
        load_study,
    )

    USING_OPTUNA = False
