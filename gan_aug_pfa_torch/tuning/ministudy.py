"""ministudy — a small Optuna-API-compatible HPO engine with SQLite storage.

The port's own copy of the JAX package's ``tuning/ministudy.py`` (the port
imports nothing of that package): the same SQLite schema, sampler, pruner
and real-Optuna-schema reader, so that a study file written by either
package is read by the other, and one seed gives both the same draws.

Implements exactly the API surface the pipeline uses (reference
train.py:167-255, 338-374 and show_optuna_results.py):

  create_study(study_name=..., storage="sqlite:///...", direction=...,
               load_if_exists=..., pruner=MedianPruner(...))
  study.optimize(objective, n_trials=..., n_jobs=1)
  study.best_trial / study.trials  (.number/.state/.value/.params/
                                    .datetime_start/.datetime_complete)
  trial.suggest_loguniform / suggest_float / suggest_categorical /
  trial.suggest_int / trial.report(value, step) / trial.should_prune()
  TrialPruned / TrialState.{COMPLETE, PRUNED, FAIL, RUNNING}
  MedianPruner(n_startup_trials, n_warmup_steps, interval_steps)

Sampling: independent random search for the first ``n_startup_trials``
trials, then a TPE-style guided sampler — split completed trials into a
good/bad quantile by objective and sample floats from a Gaussian mixture
around good-trial values (categoricals from the good-trial histogram).

This is NOT a copy of Optuna: the storage schema, sampler, and code are
original; only the call signature is mirrored so the same training code runs
with either backend.

Several processes may write one study file at once (parallel trials over
sub-meshes, ``tune.tune_on_ranks``): each write is one ``BEGIN IMMEDIATE``
transaction, which takes the file's write lock before it reads, so a new
trial's number (``MAX(number) + 1``) and its row go in together; and a
writer or reader that finds the file locked waits for it (the connection's
busy timeout, ``BUSY_TIMEOUT_S``) rather than fail.  A thread lock still
serializes the threads that share one connection.
"""

from __future__ import annotations

import contextlib
import datetime
import enum
import json
import math
import random
import sqlite3
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

# Seconds a statement waits for another process's lock on the study file.
BUSY_TIMEOUT_S = 600.0


class TrialPruned(Exception):
    pass


class TrialState(enum.Enum):
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    PRUNED = "PRUNED"
    FAIL = "FAIL"


class MedianPruner:
    """Prune if the trial's best intermediate result so far is worse than
    the median of other trials' reported values at the same step
    (real-Optuna MedianPruner semantics, reference train.py:345):

      * history considered = COMPLETE trials ONLY — exactly optuna's
        PercentilePruner pool (pruned trials' intermediates do NOT count).
        Round-3 fix: the previous COMPLETE+PRUNED pool diverged from a
        real recorded Optuna decision (reference optuna_study.db trial 19:
        optuna pruned at step 5, the inclusive pool's higher median kept
        it) — caught by a golden-trace replay of that study;
      * the startup gate counts COMPLETE trials (optuna's n_trials gate);
      * the current trial competes with its BEST intermediate over all
        steps so far, not just the latest report;
      * the median is the interpolated (numpy-percentile-50) median.
    """

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0,
                 interval_steps: int = 1):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self.interval_steps = interval_steps

    @staticmethod
    def _median(values: List[float]) -> float:
        s = sorted(values)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0

    def should_prune(self, study: "Study", trial: "Trial") -> bool:
        if not trial._intermediate:
            return False
        step = max(trial._intermediate)
        if step < self.n_warmup_steps:
            return False
        if (step - self.n_warmup_steps) % self.interval_steps != 0:
            return False
        completed = [
            t for t in study.trials if t.state == TrialState.COMPLETE
        ]
        if len(completed) < self.n_startup_trials:
            return False
        others = [
            t.intermediate_values[step]
            for t in completed
            if step in t.intermediate_values
        ]
        if not others:
            return False
        median = self._median(others)
        if study.direction == "minimize":
            return min(trial._intermediate.values()) > median
        return max(trial._intermediate.values()) < median


class FrozenTrial:
    def __init__(self, number: int, state: TrialState,
                 value: Optional[float], params: Dict[str, Any],
                 intermediate_values: Dict[int, float],
                 datetime_start: Optional[str],
                 datetime_complete: Optional[str]):
        self.number = number
        self.state = state
        self.value = value
        self.params = params
        self.intermediate_values = intermediate_values
        self.datetime_start = datetime_start
        self.datetime_complete = datetime_complete


class Trial:
    def __init__(self, study: "Study", number: int, trial_id: int):
        self.study = study
        self.number = number
        self._trial_id = trial_id
        self.params: Dict[str, Any] = {}
        self._intermediate: Dict[int, float] = {}

    # -- suggest API ----------------------------------------------------

    def _record(self, name: str, value):
        self.params[name] = value
        self.study._store_param(self._trial_id, name, value)
        return value

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False, step: Optional[float] = None):
        v = self.study._sample_float(name, low, high, log)
        if step is not None:
            v = low + round((v - low) / step) * step
        return self._record(name, v)

    def suggest_loguniform(self, name: str, low: float, high: float):
        return self.suggest_float(name, low, high, log=True)

    def suggest_uniform(self, name: str, low: float, high: float):
        return self.suggest_float(name, low, high)

    def suggest_int(self, name: str, low: int, high: int, log: bool = False):
        v = self.study._sample_float(name, low, high + 1, log)
        return self._record(name, int(min(math.floor(v), high)))

    def suggest_categorical(self, name: str, choices: Sequence[Any]):
        return self._record(name, self.study._sample_categorical(
            name, list(choices)
        ))

    # -- pruning API ------------------------------------------------------

    def report(self, value: float, step: int) -> None:
        self._intermediate[step] = float(value)
        self.study._store_intermediate(self._trial_id, step, float(value))

    def should_prune(self) -> bool:
        if self.study.pruner is None:
            return False
        return self.study.pruner.should_prune(self.study, self)


class Study:
    def __init__(self, study_name: str, storage: Optional[str],
                 direction: str = "minimize",
                 pruner: Optional[MedianPruner] = None,
                 sampler_seed: Optional[int] = None):
        self.study_name = study_name
        self.direction = direction
        self.pruner = pruner
        self._rng = random.Random(sampler_seed)
        self._lock = threading.Lock()
        if storage and storage.startswith("sqlite:///"):
            self._db_path = storage[len("sqlite:///"):]
        elif storage in (None, ""):
            self._db_path = ":memory:"
        else:
            raise ValueError(f"Unsupported storage: {storage}")
        self._conn = sqlite3.connect(
            self._db_path, timeout=BUSY_TIMEOUT_S, check_same_thread=False
        )
        self._init_schema()
        self._study_id = self._get_or_create_study()

    # -- storage ---------------------------------------------------------

    def _init_schema(self):
        c = self._conn
        c.executescript(
            """
            CREATE TABLE IF NOT EXISTS studies (
              study_id INTEGER PRIMARY KEY AUTOINCREMENT,
              name TEXT UNIQUE, direction TEXT);
            CREATE TABLE IF NOT EXISTS trials (
              trial_id INTEGER PRIMARY KEY AUTOINCREMENT,
              study_id INTEGER, number INTEGER, state TEXT, value REAL,
              datetime_start TEXT, datetime_complete TEXT);
            CREATE TABLE IF NOT EXISTS trial_params (
              trial_id INTEGER, name TEXT, value_json TEXT);
            CREATE TABLE IF NOT EXISTS intermediate_values (
              trial_id INTEGER, step INTEGER, value REAL);
            """
        )
        c.commit()

    @contextlib.contextmanager
    def _write(self):
        """One write transaction: this connection's thread lock, then the
        file's write lock (``BEGIN IMMEDIATE``, waiting up to the busy
        timeout), committed at the end, rolled back on an error."""
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                yield self._conn
            except BaseException:
                self._conn.rollback()
                raise
            self._conn.commit()

    def _get_or_create_study(self) -> int:
        def find(c):
            return c.execute(
                "SELECT study_id, direction FROM studies WHERE name=?",
                (self.study_name,),
            ).fetchone()

        row = find(self._conn)  # a read: a read-only file opens too
        if row:
            return row[0]
        with self._write() as c:
            row = find(c)  # another process may have made it meanwhile
            if row:
                return row[0]
            return c.execute(
                "INSERT INTO studies (name, direction) VALUES (?, ?)",
                (self.study_name, self.direction),
            ).lastrowid

    def _store_param(self, trial_id: int, name: str, value):
        with self._write() as c:
            c.execute(
                "INSERT INTO trial_params VALUES (?, ?, ?)",
                (trial_id, name, json.dumps(value)),
            )

    def _store_intermediate(self, trial_id: int, step: int, value: float):
        with self._write() as c:
            c.execute(
                "INSERT INTO intermediate_values VALUES (?, ?, ?)",
                (trial_id, step, value),
            )

    def _new_trial(self) -> Trial:
        # The number is read and its row inserted under one write lock:
        # another process cannot take the same number in between.
        with self._write() as c:
            number = c.execute(
                "SELECT COALESCE(MAX(number), -1) + 1 FROM trials WHERE "
                "study_id=?",
                (self._study_id,),
            ).fetchone()[0]
            cur = c.execute(
                "INSERT INTO trials (study_id, number, state, value, "
                "datetime_start) VALUES (?, ?, ?, NULL, ?)",
                (
                    self._study_id, number, TrialState.RUNNING.value,
                    datetime.datetime.now().isoformat(),
                ),
            )
        return Trial(self, number, cur.lastrowid)

    def _finish_trial(self, trial: Trial, state: TrialState,
                      value: Optional[float]):
        with self._write() as c:
            c.execute(
                "UPDATE trials SET state=?, value=?, datetime_complete=? "
                "WHERE trial_id=?",
                (
                    state.value, value,
                    datetime.datetime.now().isoformat(), trial._trial_id,
                ),
            )

    # -- trials view -------------------------------------------------------

    @property
    def trials(self) -> List[FrozenTrial]:
        with self._lock:
            return self._trials_locked()

    def _trials_locked(self) -> List[FrozenTrial]:
        cur = self._conn.execute(
            "SELECT trial_id, number, state, value, datetime_start, "
            "datetime_complete FROM trials WHERE study_id=? ORDER BY number",
            (self._study_id,),
        )
        out = []
        for trial_id, number, state, value, dts, dtc in cur.fetchall():
            pcur = self._conn.execute(
                "SELECT name, value_json FROM trial_params WHERE trial_id=?",
                (trial_id,),
            )
            params = {n: json.loads(v) for n, v in pcur.fetchall()}
            icur = self._conn.execute(
                "SELECT step, value FROM intermediate_values WHERE "
                "trial_id=?",
                (trial_id,),
            )
            inter = {s: v for s, v in icur.fetchall()}
            out.append(
                FrozenTrial(number, TrialState(state), value, params, inter,
                            dts, dtc)
            )
        return out

    @property
    def best_trial(self) -> FrozenTrial:
        completed = [
            t for t in self.trials if t.state == TrialState.COMPLETE
        ]
        if not completed:
            raise ValueError("No completed trials.")
        key = (lambda t: t.value) if self.direction == "minimize" else (
            lambda t: -t.value
        )
        return min(completed, key=key)

    @property
    def best_params(self) -> Dict[str, Any]:
        return self.best_trial.params

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    # -- sampling ---------------------------------------------------------

    def _good_trials(self) -> List[FrozenTrial]:
        completed = sorted(
            (t for t in self.trials if t.state == TrialState.COMPLETE
             and t.value is not None),
            key=(lambda t: t.value) if self.direction == "minimize"
            else (lambda t: -t.value),
        )
        if len(completed) < 8:
            return []
        n_good = max(2, len(completed) // 4)
        return completed[:n_good]

    def _sample_float(self, name: str, low: float, high: float, log: bool
                      ) -> float:
        good = self._good_trials()
        values = [
            t.params[name] for t in good
            if name in t.params and isinstance(t.params[name], (int, float))
        ]
        # TPE-style guided sampling 75% of the time once enough history.
        if values and self._rng.random() < 0.75:
            center = self._rng.choice(values)
            if log:
                lc, ll, lh = math.log(center), math.log(low), math.log(high)
                width = (lh - ll) / 6.0
                v = self._rng.gauss(lc, width)
                return float(
                    min(max(math.exp(v), low), high)
                )
            width = (high - low) / 6.0
            return float(min(max(self._rng.gauss(center, width), low), high))
        if log:
            return float(
                math.exp(self._rng.uniform(math.log(low), math.log(high)))
            )
        return float(self._rng.uniform(low, high))

    def _sample_categorical(self, name: str, choices: List[Any]):
        good = self._good_trials()
        values = [
            t.params[name] for t in good
            if name in t.params and t.params[name] in choices
        ]
        if values and self._rng.random() < 0.75:
            return self._rng.choice(values)
        return self._rng.choice(choices)

    # -- optimize -----------------------------------------------------------

    def _run_one_trial(self, objective, catch) -> None:
        trial = self._new_trial()
        try:
            value = objective(trial)
            self._finish_trial(trial, TrialState.COMPLETE, float(value))
        except TrialPruned:
            last = (
                trial._intermediate[max(trial._intermediate)]
                if trial._intermediate else None
            )
            self._finish_trial(trial, TrialState.PRUNED, last)
        except Exception as e:  # noqa: BLE001 — parity with optuna
            self._finish_trial(trial, TrialState.FAIL, None)
            if catch and isinstance(e, tuple(catch)):
                return
            raise

    def optimize(self, objective: Callable[[Trial], float],
                 n_trials: int = 1, n_jobs: int = 1,
                 timeout: Optional[float] = None,
                 catch=()) -> None:
        """Run trials; n_jobs>1 runs them on a thread pool (same model as
        real optuna — useful when the objective releases the GIL, e.g.
        while a device train step executes). n_jobs=-1 uses all CPUs."""
        import time as _time

        t_start = _time.time()

        def timed_out() -> bool:
            return timeout is not None and _time.time() - t_start > timeout

        if n_jobs == 1:
            for _ in range(n_trials):
                if timed_out():
                    break
                self._run_one_trial(objective, catch)
            return

        import os
        from concurrent.futures import ThreadPoolExecutor

        if n_jobs == -1:
            n_jobs = os.cpu_count() or 1
        if n_jobs < 1:
            raise ValueError(f"n_jobs must be >= 1 or -1, got {n_jobs}")
        from concurrent.futures import FIRST_COMPLETED, wait

        # Keep at most n_jobs trials in flight and re-check the timeout
        # before every submission (real-optuna semantics: on timeout stop
        # LAUNCHING trials; in-flight ones run to completion).  Submitting
        # all n_trials up front would enqueue the full study in
        # microseconds and make the timeout unenforceable.
        with ThreadPoolExecutor(max_workers=n_jobs) as pool:
            pending = set()
            submitted = 0
            while True:
                while (len(pending) < n_jobs and submitted < n_trials
                       and not timed_out()):
                    pending.add(
                        pool.submit(self._run_one_trial, objective, catch)
                    )
                    submitted += 1
                if not pending:
                    break
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for f in done:
                    f.result()  # surface uncaught objective exceptions


def _optuna_schema(db_path: str) -> bool:
    """True when the SQLite file carries real Optuna's schema (its
    ``studies`` table has a ``study_name`` column; ours has ``name``)."""
    import os

    if db_path == ":memory:" or not os.path.exists(db_path):
        return False
    conn = sqlite3.connect(db_path)
    try:
        cols = [r[1] for r in conn.execute("PRAGMA table_info(studies)")]
        return "study_name" in cols
    except sqlite3.Error:
        return False
    finally:
        conn.close()


class OptunaSchemaStudy:
    """Read-only view over a study stored by REAL Optuna (its RDB schema),
    so study artifacts like the reference's shipped optuna_study.db can be
    inspected with show_optuna_results.py without optuna installed.

    Decoding notes (validated against the reference DB): float/int params
    store the value in ``trial_params.param_value``; categorical params
    store the CHOICE INDEX, with the choices list in ``distribution_json``.
    """

    def __init__(self, study_name: str, storage: str):
        if not storage.startswith("sqlite:///"):
            raise ValueError(f"Unsupported storage: {storage}")
        self.study_name = study_name
        self._conn = sqlite3.connect(storage[len("sqlite:///"):])
        row = self._conn.execute(
            "SELECT study_id FROM studies WHERE study_name=?",
            (study_name,),
        ).fetchone()
        if row is None:
            raise KeyError(f"No study named {study_name!r} in {storage}")
        self._study_id = row[0]
        drow = self._conn.execute(
            "SELECT direction FROM study_directions WHERE study_id=? AND "
            "objective=0",
            (self._study_id,),
        ).fetchone()
        self.direction = (
            "minimize" if (drow is None or drow[0] == "MINIMIZE")
            else "maximize"
        )

    @staticmethod
    def _decode_param(value: float, dist_json: str):
        try:
            dist = json.loads(dist_json)
        except (TypeError, json.JSONDecodeError):
            return value
        name = dist.get("name", "")
        attrs = dist.get("attributes", {})
        if name == "CategoricalDistribution":
            choices = attrs.get("choices", [])
            i = int(value)
            return choices[i] if 0 <= i < len(choices) else value
        if name == "IntDistribution" or "Int" in name:
            return int(value)
        return value

    @property
    def trials(self) -> List[FrozenTrial]:
        out = []
        rows = self._conn.execute(
            "SELECT trial_id, number, state, datetime_start, "
            "datetime_complete FROM trials WHERE study_id=? ORDER BY number",
            (self._study_id,),
        ).fetchall()
        for trial_id, number, state, dts, dtc in rows:
            params = {
                n: self._decode_param(v, dj)
                for n, v, dj in self._conn.execute(
                    "SELECT param_name, param_value, distribution_json "
                    "FROM trial_params WHERE trial_id=?",
                    (trial_id,),
                )
            }
            vrow = self._conn.execute(
                "SELECT value FROM trial_values WHERE trial_id=? AND "
                "objective=0",
                (trial_id,),
            ).fetchone()
            inter = {
                s: v
                for s, v in self._conn.execute(
                    "SELECT step, intermediate_value FROM "
                    "trial_intermediate_values WHERE trial_id=?",
                    (trial_id,),
                )
            }
            try:
                st = TrialState(state)
            except ValueError:
                st = TrialState.FAIL
            out.append(
                FrozenTrial(
                    number, st, vrow[0] if vrow else None, params, inter,
                    dts, dtc,
                )
            )
        return out

    best_trial = Study.best_trial
    best_params = Study.best_params
    best_value = Study.best_value

    def optimize(self, *a, **k):
        raise RuntimeError(
            "This study file uses real Optuna's storage schema; ministudy "
            "opens it read-only.  Install optuna to continue tuning into "
            "it, or point --tune at a different storage file."
        )


def create_study(
    study_name: str = "study",
    storage: Optional[str] = None,
    direction: str = "minimize",
    load_if_exists: bool = False,
    pruner: Optional[MedianPruner] = None,
    sampler_seed: Optional[int] = None,
) -> Study:
    if storage and storage.startswith("sqlite:///") and _optuna_schema(
        storage[len("sqlite:///"):]
    ):
        raise ValueError(
            "Storage file was written by real Optuna; ministudy cannot "
            "write its schema.  Use show_optuna_results.py to inspect it, "
            "install optuna, or choose a different storage path."
        )
    if not load_if_exists and storage and storage.startswith("sqlite:///"):
        # Error on existing study (optuna raises DuplicatedStudyError).
        path = storage[len("sqlite:///"):]
        import os

        if os.path.exists(path):
            conn = sqlite3.connect(path)
            try:
                cur = conn.execute(
                    "SELECT 1 FROM studies WHERE name=?", (study_name,)
                )
                if cur.fetchone():
                    raise ValueError(
                        f"Study {study_name} already exists (use "
                        f"load_if_exists=True)."
                    )
            except sqlite3.OperationalError:
                pass
            finally:
                conn.close()
    return Study(study_name, storage, direction, pruner, sampler_seed)


def load_study(study_name: str, storage: str):
    """Load for inspection: transparently reads real-Optuna-schema files
    (e.g. the reference's shipped optuna_study.db) read-only."""
    if storage.startswith("sqlite:///") and _optuna_schema(
        storage[len("sqlite:///"):]
    ):
        return OptunaSchemaStudy(study_name, storage)
    return Study(study_name, storage)
