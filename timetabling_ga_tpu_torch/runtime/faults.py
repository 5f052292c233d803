"""Deterministic fault injection (copy of timetabling_ga_tpu/runtime/
faults.py:1-359).

Named sites call `maybe_fail(site)` once per logical operation; a plan
makes the nth invocation of a site fail in a chosen way, so every
recovery path runs on demand, on the CPU as on the card.

Grammar (`--faults` or `$TT_FAULTS`), JAX's:

    dispatch:3:unavailable,fetch:5:hang,writer:1:die,ckpt:2:truncate

Each entry is `site:nth:action`. A `site@proc` scope parses as JAX's:
under a multi-process run (`set_process`) an entry scoped to another
process is dropped, and an unscoped entry fires on process 0 only.

    unavailable  raise RuntimeError from an inner error whose message
                 carries 'UNAVAILABLE' (retry.is_transient walks the
                 cause chain to classify it)
    hang         sleep HANG_S seconds (`$TT_FAULT_HANG_S`, default 3600);
                 inside the fetch watchdog's thread this becomes a
                 FetchTimeout at the deadline
    die          raise SystemExit; inside the AsyncWriter worker the
                 thread ends without draining its queue
    truncate     cut the just-written file (`path=`) to half its size
    error        raise FaultInjected: a non-transient failure, which the
                 supervisor re-raises

The port's sites: `dispatch` (before every generation, polish, LAHC and
kick dispatch of the engine), `fetch` (every control-fence host read,
dispatch_core.fetch, inside the watchdog thread), `writer` (the
AsyncWriter worker, once per dequeued item), `ckpt` (checkpoint.save,
after the durable rename), `init` (the engine's init before the first
supervisor snapshot), `quantum` (once per serve lane dispatch), `resume`
(a warm-start admission), `edit` (an edit job's transplant), and the
observability threads' own: `obs_listen` (the pull front's accept loop),
`scrape` (each request it answers), `mem_poll` (each memory sample),
`history` (each history-ring sample) and `flight_dump` (each incident
dump); a hang or death there parks or ends that thread alone. SITES is
JAX's closed tuple, so every plan valid for JAX parses here; the sites
of JAX modules the port does not have never fire. Like JAX's, it holds
no `edit`: no parsed plan reaches that site.

`install` resets the per-site counters (engine.run and SolveService
call it), so indices are deterministic within a run; with no plan
`maybe_fail` costs one global read. Stdlib only at import.
"""

from __future__ import annotations

import os
import threading
import time

HANG_S = float(os.environ.get("TT_FAULT_HANG_S", "3600"))

ACTIONS = ("unavailable", "hang", "die", "truncate", "error")

SITES = ("dispatch", "fetch", "writer", "ckpt", "init", "obs_listen",
         "scrape", "mem_poll", "profile", "gateway", "route",
         "gw_writer", "gw_scrape", "quantum", "snapshot_ship",
         "resume", "history", "flight_dump", "usage", "scaler")

# this process's (index, count) in a multi-process run (set_process)
_PROC = 0
_NPROC = 1


def set_process(proc: int, nproc: int) -> None:
    """Declare this process's (index, count) for plan scoping (JAX
    faults.py:192). Parse happens per install, so call this before
    `install` (engine.run orders it right after maybe_init_distributed)."""
    global _PROC, _NPROC
    _PROC = int(proc)
    _NPROC = max(1, int(nproc))


class FaultInjected(Exception):
    """An injected fault (also the inner device error of `unavailable`,
    whose message carries the transient marker)."""


class FaultPlanError(ValueError):
    """A malformed fault plan."""


class FaultPlan:
    """Parsed `site:nth:action` entries and per-site invocation
    counters. Thread-safe: the writer worker and the fetch watchdog
    threads call `maybe_fail` beside the main loop."""

    def __init__(self, entries: dict):
        self._entries = entries          # {site: {nth: action}}
        self._counts: dict = {}
        self._lock = threading.Lock()
        self.injected = 0                # actions triggered

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        entries: dict = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            parts = item.split(":")
            if len(parts) != 3:
                raise FaultPlanError(
                    f"bad TT_FAULTS entry {item!r} (want site:nth:action)")
            site, nth_s, action = (p.strip() for p in parts)
            proc = None
            if "@" in site:
                site, _, proc_s = site.partition("@")
                site = site.strip()
                try:
                    proc = int(proc_s)
                except ValueError:
                    raise FaultPlanError(
                        f"bad TT_FAULTS process scope {proc_s!r} in "
                        f"{item!r} (want site@proc)") from None
                if proc < 0:
                    raise FaultPlanError(
                        f"TT_FAULTS process scope must be >= 0 in "
                        f"{item!r}")
            try:
                nth = int(nth_s)
            except ValueError:
                raise FaultPlanError(
                    f"bad TT_FAULTS index {nth_s!r} in {item!r}") from None
            if nth < 1:
                raise FaultPlanError(
                    f"TT_FAULTS index must be >= 1 in {item!r}")
            if site not in SITES:
                raise FaultPlanError(
                    f"unknown TT_FAULTS site {site!r} in {item!r} "
                    f"(one of {', '.join(SITES)})")
            if action not in ACTIONS:
                raise FaultPlanError(
                    f"unknown TT_FAULTS action {action!r} in {item!r} "
                    f"(one of {', '.join(ACTIONS)})")
            if proc is None:
                # unscoped under a multi-process launch: process 0 only
                if _NPROC > 1 and _PROC != 0:
                    continue
            elif proc != _PROC:
                continue                 # another process's entry
            entries.setdefault(site, {})[nth] = action
        return cls(entries)

    def pop_action(self, site: str):
        """Count one invocation of `site`; return the action due at this
        index, or None."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            act = self._entries.get(site, {}).pop(n, None)
            if act is not None:
                self.injected += 1
                try:
                    from timetabling_ga_tpu_torch.obs import metrics
                    metrics.REGISTRY.counter("faults.injected").inc()
                except Exception:
                    pass             # telemetry never breaks injection
            return act


_PLAN = None                 # the active FaultPlan, or None
_INJECTED_TOTAL = 0          # faults triggered by earlier plans


def install(spec):
    """Install the plan for `spec` (counters reset), or disable
    injection when `spec` is falsy. Returns the plan."""
    global _PLAN, _INJECTED_TOTAL
    if _PLAN is not None:
        _INJECTED_TOTAL += _PLAN.injected
    _PLAN = FaultPlan.parse(spec) if spec else None
    return _PLAN


def active_spec(cfg_spec=None):
    """The spec to install: the config's, else $TT_FAULTS, else None."""
    return cfg_spec if cfg_spec else os.environ.get("TT_FAULTS") or None


def injected_total() -> int:
    """Faults triggered over the process's life (all plans)."""
    return _INJECTED_TOTAL + (_PLAN.injected if _PLAN is not None else 0)


def maybe_fail(site: str, path=None) -> None:
    """One logical operation at `site`: perform the plan's action for
    this invocation index, if any."""
    plan = _PLAN
    if plan is None:
        return
    act = plan.pop_action(site)
    if act is None:
        return
    if act == "unavailable":
        inner = FaultInjected(
            f"UNAVAILABLE: device error — injected fault (site {site})")
        raise RuntimeError(
            f"injected transient failure at {site}") from inner
    if act == "hang":
        time.sleep(HANG_S)
        return
    if act == "die":
        raise SystemExit(f"injected thread death at {site}")
    if act == "truncate":
        if path is not None and os.path.exists(path):
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                fh.truncate(max(1, size // 2))
        return
    if act == "error":
        raise FaultInjected(f"injected non-transient failure at {site}")
