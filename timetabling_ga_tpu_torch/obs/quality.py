"""The quality telemetry's host side (copy of timetabling_ga_tpu/obs/
quality.py:53-83, 85-176, 180-213, under the same names).

Under `--quality` every dispatch packs a quality block of QUALITY_WIDTH
int32 columns an island after its compressed trace leaf
(parallel/islands.py run_epochs):

    [N_GA operator counters | N_SWEEP sweep accepts | N_MIG migration gain
     | N_DIV diversity (float32 bits)]

The counters (crossover and mutation attempts and wins, Move1/Move2/
Move3 accepts) come from kernel K14's quality_ops entry, the gain from
K7's migrate, the diversity (penalty and scv moments, the coprime-stride
Hamming sample) from K14's div_stats. `decode_rows` and `aggregate`
turn a fetched block into the `quality.*` counters and gauges of
obs/metrics.py's REGISTRY; `StallDetector` reads the most-collapsed
island's Hamming value to drive `engine.stalled`, the stall and kick
`faultEntry` records and `--auto-kick-on-stall`. Numpy only.

Not here yet: the `qualityEntry` record and the `quality` subcommand
(JAX `summarize` / `main_quality`), which come with `--obs`.
"""

from __future__ import annotations

import os

import numpy as np

# crossover attempts / wins, mutation attempts / wins: a win is a child
# whose penalty after its local search beats its base parent's
N_GA = 4
# Move1 / Move2 / Move3 accepts of every sweep pass a dispatch ran
N_SWEEP = 3
N_OPS = N_GA + N_SWEEP
# each island's reported-best gain over the dispatch's ring exchanges
N_MIG = 1
# penalty mean/var/min/max, scv mean/var/min/max, the Hamming sample
N_DIV = 9
QUALITY_WIDTH = N_OPS + N_MIG + N_DIV

OFF_GA = 0
OFF_SWEEP = N_GA
OFF_MIG = N_OPS
OFF_DIV = N_OPS + N_MIG

# at most this many coprime-stride pairs an island a dispatch
HAMMING_PAIRS = int(os.environ.get("TT_QUALITY_HAMMING_PAIRS", "32"))

_OP_NAMES = ("crossover_attempts", "crossover_wins",
             "mutation_attempts", "mutation_wins",
             "move1_accepts", "move2_accepts", "move3_accepts")
_DIV_NAMES = ("penalty_mean", "penalty_var", "penalty_min", "penalty_max",
              "scv_mean", "scv_var", "scv_min", "scv_max", "hamming")


def decode_rows(rows):
    """(n_islands, QUALITY_WIDTH) int32 quality block -> dict of
    per-island arrays (op counts and migration gain as int64, the
    diversity columns as float32)."""
    rows = np.asarray(rows, np.int32)
    if rows.ndim != 2 or rows.shape[1] != QUALITY_WIDTH:
        raise ValueError(f"quality block must be (n, {QUALITY_WIDTH}) "
                         f"int32, got {rows.shape}")
    out = {name: rows[:, OFF_GA + i].astype(np.int64)
           for i, name in enumerate(_OP_NAMES)}
    out["migration_gain"] = rows[:, OFF_MIG].astype(np.int64)
    div = np.ascontiguousarray(rows[:, OFF_DIV:]).view(np.float32)
    for i, name in enumerate(_DIV_NAMES):
        out[name] = div[:, i]
    return out


def aggregate(decoded) -> dict:
    """One dispatch's decoded block across islands: {"counters": ...}
    holds per-dispatch deltas (the registry accumulates them),
    {"gauges": ...} the dispatch's cross-island view; `hamming_min` is
    the most-collapsed island, the stall detector's input."""
    counters = {f"quality.ops.{name}": int(decoded[name].sum())
                for name in _OP_NAMES}
    counters["quality.migration.gain"] = int(
        decoded["migration_gain"].sum())
    gauges = {
        "quality.diversity.penalty_mean":
            float(decoded["penalty_mean"].mean()),
        "quality.diversity.penalty_var":
            float(decoded["penalty_var"].mean()),
        "quality.diversity.scv_mean": float(decoded["scv_mean"].mean()),
        "quality.diversity.scv_var": float(decoded["scv_var"].mean()),
        "quality.diversity.hamming": float(decoded["hamming"].mean()),
        "quality.diversity.hamming_min": float(decoded["hamming"].min()),
    }
    return {"counters": counters, "gauges": gauges}


def entry_payload(agg: dict, **extra) -> dict:
    """Flat payload of an `aggregate` result: counters as ints, gauges
    rounded to 6 places (the qualityEntry body of the JAX CLI)."""
    out = {}
    for kind in ("counters", "gauges"):
        for name, v in agg[kind].items():
            out[name] = round(float(v), 6) if kind == "gauges" else int(v)
    out.update(extra)
    return out


class StallDetector:
    """No-improvement window x diversity-collapse threshold.

    `update(best, hamming)` takes, once a dispatch, the run's best (the
    minimum over islands) and the most-collapsed island's Hamming
    value. The run is stalled when `window` dispatches in a row brought
    no new best and the Hamming value sits at or below `hamming_floor`.
    window <= 0 disables it."""

    def __init__(self, window: int, hamming_floor: float):
        self.window = int(window)
        self.hamming_floor = float(hamming_floor)
        self.streak = 0
        self.stalled = False
        self._best = None

    def update(self, best: int, hamming: float) -> bool:
        if self.window <= 0:
            return False
        if self._best is None or best < self._best:
            self._best = best
            self.streak = 0
        else:
            self.streak += 1
        self.stalled = (self.streak >= self.window
                        and hamming <= self.hamming_floor)
        return self.stalled

    def reset(self) -> None:
        """Re-arm after a kick: the stall evidence is stale, a new
        window must pass before it fires again."""
        self.streak = 0
        self.stalled = False
