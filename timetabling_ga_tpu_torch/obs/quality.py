"""The quality telemetry's host side (copy of timetabling_ga_tpu/obs/
quality.py, under the same names).

Under `--quality` every dispatch packs a quality block of QUALITY_WIDTH
int32 columns an island (a lane on the serve path) after its compressed
trace leaf (parallel/islands.py run_epochs):

    [N_GA operator counters | N_SWEEP sweep accepts | N_MIG migration gain
     | N_DIV diversity (float32 bits)]

The counters (crossover and mutation attempts and wins, Move1/Move2/
Move3 accepts) come from kernel K14's quality_ops entry, the gain from
K7's migrate, the diversity (penalty and scv moments, the coprime-stride
Hamming sample) from K14's div_stats. `decode_rows` and `aggregate`
turn a fetched block into the `quality.*` counters and gauges of
obs/metrics.py's REGISTRY; `entry_payload` (the engine's) and
`lane_payload` (a serve job's) are the `qualityEntry` bodies under
`--obs`; `StallDetector` reads the most-collapsed island's Hamming value
to drive `engine.stalled`, the stall and kick `faultEntry` records and
`--auto-kick-on-stall`. `main_quality` is the `quality` subcommand: a
summary of a log's qualityEntry records and stall events.

numpy is imported inside the decode alone, so the subcommand runs with
the standard library.
"""

from __future__ import annotations

import os

# ---------------------------------------------------------------------------
# Packed-leaf layout. One quality block per island/lane, appended after
# the compressed trace leaf's event/count[/moment] columns — all int32,
# so the fetch stays ONE leaf (islands._compress_trace + the runners
# own the device-side packing; islands.split_quality splits it back).

# operator-efficacy counters (int32 counts, summed over the dispatch):
#   crossover attempts / wins, mutation attempts / wins — a WIN is a
#   child that strictly improved on its base parent's penalty, credited
#   to every operator that touched it (ops/ga.py generation)
N_GA = 4
# sweep-move acceptance counters: Move1 / Move2 / Move3 accepted moves
# across every sweep pass the dispatch ran (ops/sweep.py sweep_pass)
N_SWEEP = 3
N_OPS = N_GA + N_SWEEP
# migration gain: per-island improvement of the reported best across
# the dispatch's ring exchanges (reported-int domain, summed; 0 on the
# serve lane path — lanes never migrate)
N_MIG = 1
# diversity block (bitcast float32): penalty mean/var/min/max,
# scv mean/var/min/max, Hamming sample mean (fraction of differing live
# slot assignments over HAMMING_PAIRS coprime-stride pairs)
N_DIV = 9
QUALITY_WIDTH = N_OPS + N_MIG + N_DIV

# column offsets inside the quality block
OFF_GA = 0
OFF_SWEEP = N_GA
OFF_MIG = N_OPS
OFF_DIV = N_OPS + N_MIG

# bounded Hamming sample: at most this many coprime-stride pairs per
# island per dispatch (parallel/islands.py _div_stats)
HAMMING_PAIRS = int(os.environ.get("TT_QUALITY_HAMMING_PAIRS", "32"))

_OP_NAMES = ("crossover_attempts", "crossover_wins",
             "mutation_attempts", "mutation_wins",
             "move1_accepts", "move2_accepts", "move3_accepts")
_DIV_NAMES = ("penalty_mean", "penalty_var", "penalty_min", "penalty_max",
              "scv_mean", "scv_var", "scv_min", "scv_max", "hamming")


def decode_rows(rows):
    """(n_islands, QUALITY_WIDTH) int32 quality block -> dict of
    per-island numpy arrays (op counts + migration gain as int64,
    diversity columns as float32 via bitcast)."""
    import numpy as np
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
    """Cross-island aggregation of one dispatch's decoded quality block
    into the `quality.*` namespace: {"counters": {...}, "gauges":
    {...}}. Counters are per-dispatch DELTAS (the registry accumulates
    them); gauges are the dispatch's latest cross-island view —
    `hamming_min` is the most-collapsed island, the stall detector's
    input."""
    counters = {
        "quality.ops.crossover_attempts":
            int(decoded["crossover_attempts"].sum()),
        "quality.ops.crossover_wins": int(decoded["crossover_wins"].sum()),
        "quality.ops.mutation_attempts":
            int(decoded["mutation_attempts"].sum()),
        "quality.ops.mutation_wins": int(decoded["mutation_wins"].sum()),
        "quality.ops.move1_accepts": int(decoded["move1_accepts"].sum()),
        "quality.ops.move2_accepts": int(decoded["move2_accepts"].sum()),
        "quality.ops.move3_accepts": int(decoded["move3_accepts"].sum()),
        "quality.migration.gain": int(decoded["migration_gain"].sum()),
    }
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


def lane_payload(decoded, lane: int) -> dict:
    """One lane's (serve job's) flat qualityEntry payload."""
    out = {}
    for name in _OP_NAMES:
        out[name] = int(decoded[name][lane])
    for name in _DIV_NAMES:
        out[name] = round(float(decoded[name][lane]), 6)
    return out


def entry_payload(agg: dict, **extra) -> dict:
    """Flat qualityEntry payload from an `aggregate` result (dots in
    the metric names are kept — `tt trace` renders each key as its own
    Perfetto counter track)."""
    out = {}
    for kind in ("counters", "gauges"):
        for name, v in agg[kind].items():
            out[name] = round(float(v), 6) if kind == "gauges" else int(v)
    out.update(extra)
    return out


def entry_total(entries, key: str) -> int:
    """Run total of one counter field across qualityEntry payloads —
    the entries carry per-dispatch DELTAS (see `aggregate`), so every
    consumer (bench extra.quality, the race rows, `tt quality`) must
    sum, never read the last entry. Owned here with the key names so
    the summers cannot drift."""
    return sum(int(e.get(key, 0)) for e in entries)


def entry_win_rate(entries, wins_key: str, attempts_key: str):
    """wins/attempts across qualityEntry payloads; None when the
    operator never ran (distinct from a true 0% hit rate)."""
    attempts = entry_total(entries, attempts_key)
    if not attempts:
        return None
    return round(entry_total(entries, wins_key) / attempts, 3)


class StallDetector:
    """No-improvement window x diversity-collapse threshold.

    `update(best, hamming)` is fed once per retired dispatch with the
    run's control best (min over islands of best_seen) and the
    most-collapsed island's Hamming diversity. The run is STALLED when
    `window` consecutive dispatches brought no new best AND diversity
    sits at/below `hamming_floor` — a plateau with a collapsed
    population is one more dispatches cannot fix, where a plateau with
    diversity left may still recombine its way off. window <= 0
    disables the detector entirely."""

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
        """Re-arm after an intervention (the auto-kick): the kick
        re-diversified the population, so the stall evidence is
        stale — a new window must accumulate before firing again."""
        self.streak = 0
        self.stalled = False


# ---------------------------------------------------------------------------
# `tt quality` — offline summarizer (stdlib + read_jsonl only).


def summarize(records) -> str:
    """Quality report text for a list of JSONL record dicts: diversity
    trend across the run's qualityEntry snapshots, operator hit rates,
    migration gain, and the stall/kick event log (faultEntry site
    `quality`)."""
    entries: list = []
    stalls: list = []
    for rec in records:
        if "qualityEntry" in rec:
            entries.append(rec["qualityEntry"])
        elif "faultEntry" in rec:
            f = rec["faultEntry"]
            if f.get("site") == "quality":
                stalls.append(f)
    lines = [f"== quality entries: {len(entries)}"]
    if entries:
        # per-job streams (serve logs) are summarized separately from
        # the run-wide engine stream
        run_wide = [e for e in entries if "job" not in e]
        jobs: dict = {}
        for e in entries:
            if "job" in e:
                jobs.setdefault(str(e["job"]), []).append(e)

        def _trend(es, key):
            vals = [e[key] for e in es if isinstance(e.get(key),
                                                     (int, float))]
            if not vals:
                return None
            return vals[0], vals[-1]

        def _rate(es, wins, attempts):
            w = entry_total(es, wins)
            a = entry_total(es, attempts)
            return w, a, (w / a if a else 0.0)

        def _section(name, es):
            out = [f"== {name}"]
            for key, label in (
                    ("quality.diversity.hamming", "hamming"),
                    ("quality.diversity.penalty_var", "penalty var"),
                    ("quality.diversity.scv_var", "scv var")):
                tr = _trend(es, key)
                if tr is not None:
                    out.append(f"  {label}: {tr[0]:.4g} -> {tr[1]:.4g}")
            for wins, attempts, label in (
                    ("quality.ops.crossover_wins",
                     "quality.ops.crossover_attempts", "crossover"),
                    ("quality.ops.mutation_wins",
                     "quality.ops.mutation_attempts", "mutation")):
                w, a, r = _rate(es, wins, attempts)
                out.append(f"  {label}: {w}/{a} wins ({r:.1%})")
            for key, label in (
                    ("quality.ops.move1_accepts", "move1"),
                    ("quality.ops.move2_accepts", "move2"),
                    ("quality.ops.move3_accepts", "move3")):
                out.append(f"  sweep {label} accepts: "
                           f"{entry_total(es, key)}")
            out.append(f"  migration gain: "
                       f"{entry_total(es, 'quality.migration.gain')}")
            return out

        if run_wide:
            lines.extend(_section("run", run_wide))
        for jid, es in sorted(jobs.items()):
            # serve payloads are lane_payload-flat (no quality. prefix)
            out = [f"== job {jid}"]
            tr = _trend(es, "hamming")
            if tr is not None:
                out.append(f"  hamming: {tr[0]:.4g} -> {tr[1]:.4g}")
            for wins, attempts, label in (
                    ("crossover_wins", "crossover_attempts", "crossover"),
                    ("mutation_wins", "mutation_attempts", "mutation")):
                w = sum(int(e.get(wins, 0)) for e in es)
                a = sum(int(e.get(attempts, 0)) for e in es)
                out.append(f"  {label}: {w}/{a} wins "
                           f"({w / a if a else 0.0:.1%})")
            lines.extend(out)
    if stalls:
        lines.append(f"== stalls ({len(stalls)} events)")
        for f in stalls:
            extra = ""
            if f.get("action") == "kick":
                extra = f" moves={f.get('moves')}"
            elif "streak" in f:
                extra = (f" streak={f.get('streak')}"
                         f" hamming={f.get('hamming')}")
            lines.append(f"  {f.get('action')} @ {f.get('time', 0.0):.1f}s"
                         + extra)
    else:
        lines.append("== stalls: none")
    return "\n".join(lines)


def main_quality(argv) -> int:
    """`tt quality <log.jsonl>` entry point (stdlib, device-free)."""
    inp = None
    for a in argv:
        if a in ("-h", "--help"):
            print("usage: tt quality <log.jsonl>\n\n"
                  "summarize a run's search-quality telemetry: diversity "
                  "trend (Hamming sample, penalty/scv variance), operator "
                  "hit rates (crossover/mutation wins, sweep Move1/2/3 "
                  "accepts), migration gain, and stall/kick events")
            return 0
        if inp is None:
            inp = a
        else:
            raise SystemExit(f"unknown argument: {a}")
    if inp is None:
        raise SystemExit("usage: tt quality <log.jsonl>")
    from timetabling_ga_tpu_torch.obs.trace_export import read_jsonl
    print(summarize(read_jsonl(inp)))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main_quality(sys.argv[1:]))
