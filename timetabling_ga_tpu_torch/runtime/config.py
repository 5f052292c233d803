"""Run configuration and CLI flag parsing (port of
timetabling_ga_tpu/runtime/config.py:95-434, 601-).

The flag surface is the JAX CLI's, in the reference's `-key value` model
(Control.cpp:3-176). The port implements the single-GPU CLI solve, with
the sweep or the random-candidate local search (`--ls-mode random`, the
untuned default, sized by `-p` / `-m` as the reference's maxSteps), the
parallel room matcher (`--rooms-mode parallel`), NSGA-II selection
(`--nsga2`), the LAHC endgame (`--post-lahc`, `--post-lahc-k`),
checkpoint/resume (`--checkpoint`, `--checkpoint-every`, `--resume`)
and the compressed trace modes (`--trace-mode deltas|stats`). A flag it
does not implement yet (`--quality`, `--metrics-every`, `--faults`, ...:
`NOT_PORTED`) stops the parse with a message naming it as not yet
ported, never silently ignored. `-l` is accepted and retired, as on the
JAX path: the engine warns that the local search is bounded by -m
instead. JAX's checkpoint refusals hold: the tuned `post_pop_size` is
dropped under `--checkpoint`, and an explicit `--post-pop-size` with
`--checkpoint` stops the parse.

`--backend` is `gpu` (the default) or `cpu`; a GPU run that finds no
CUDA device raises instead of falling back to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    threads: int = 1
    input: Optional[str] = None
    output: Optional[str] = None
    tries: int = 1
    time_limit: float = 90.0
    problem_type: int = 1
    max_steps: Optional[int] = None
    ls_time_limit: float = 99999.0
    p1: float = 1.0
    p2: float = 1.0
    p3: float = 0.0
    seed: Optional[int] = None
    backend: str = "gpu"
    pop_size: int = 10
    islands: Optional[int] = None
    generations: int = 2001
    migration_period: int = 100
    ls_candidates: int = 8
    ls_mode: str = "random"
    ls_sweeps: int = 1
    ls_swap_block: int = 8
    ls_block_events: int = 1
    ls_sideways: float = 0.0
    ls_hot_k: int = 0
    post_ls_sweeps: Optional[int] = None
    post_swap_block: Optional[int] = None
    post_hot_k: Optional[int] = None
    post_sideways: Optional[float] = None
    post_pop_size: Optional[int] = None
    post_lahc: int = 0            # > 0: the LAHC endgame's history length
    post_lahc_k: int = 16         # candidates per walker per LAHC step
    ls_converge: bool = False
    init_sweeps: int = 0
    rooms_mode: str = "scan"
    nsga2: bool = False
    kick_stall: int = 2
    ls_full_eval: bool = False
    epochs_per_dispatch: int = 1
    trace: bool = False
    trace_mode: str = "full"
    checkpoint: Optional[str] = None
    checkpoint_every: int = 1
    resume: bool = False
    auto_tune: bool = True
    explicit_fields: frozenset = frozenset()

    def resolved_seed(self) -> int:
        return int(time.time()) if self.seed is None else self.seed

    def resolved_max_steps(self) -> int:
        """LS budget by problem type (ga.cpp:389-397) unless -m given."""
        if self.max_steps is not None:
            return self.max_steps
        return {1: 200, 2: 1000}.get(self.problem_type, 2000)

    def apply_tuned_defaults(self, n_events: int) -> "RunConfig":
        """Size-tuned solver parameters for every field the user left
        untouched — the JAX config's tables (config.py:369-410): small
        instances pop 32 with deep children and 3-cycles; comp scale
        (E > 200) pop 16 with hot-K repair, then a deep wide-partner
        post-feasibility polish on the elite 4 rows."""
        d = RunConfig()
        tuned = (dict(pop_size=32, ls_sweeps=6, init_sweeps=30,
                      ls_swap_block=8, migration_period=10,
                      post_ls_sweeps=12, post_swap_block=64,
                      post_hot_k=0, p3=0.15)
                 if n_events <= 200 else
                 dict(pop_size=16, ls_sweeps=2, init_sweeps=200,
                      ls_swap_block=8, migration_period=2,
                      ls_hot_k=48, post_hot_k=0, post_ls_sweeps=16,
                      post_swap_block=64, epochs_per_dispatch=4,
                      post_pop_size=4))
        tuned.update(ls_mode="sweep", ls_converge=True, ls_sideways=0.25)
        if self.checkpoint:
            # the mid-run shape change cannot round-trip a
            # checkpoint/resume cycle (JAX config.py:411-415)
            tuned.pop("post_pop_size", None)
        for field, value in tuned.items():
            if (field not in self.explicit_fields
                    and getattr(self, field) == getattr(d, field)):
                setattr(self, field, value)
        if (self.post_pop_size is not None
                and self.post_pop_size >= self.pop_size):
            if "post_pop_size" in self.explicit_fields:
                raise SystemExit(
                    f"--post-pop-size {self.post_pop_size} does not "
                    f"shrink the (tuned) population {self.pop_size}; "
                    f"pass --pop-size explicitly or drop the flag")
            self.post_pop_size = None
        return self


_FLAG_MAP = {
    "-c": ("threads", int),
    "-i": ("input", str),
    "-o": ("output", str),
    "-n": ("tries", int),
    "-t": ("time_limit", float),
    "-p": ("problem_type", int),
    "-m": ("max_steps", int),
    "-l": ("ls_time_limit", float),
    "-p1": ("p1", float),
    "-p2": ("p2", float),
    "-p3": ("p3", float),
    "-s": ("seed", int),
    "--backend": ("backend", str),
    "--pop-size": ("pop_size", int),
    "--islands": ("islands", int),
    "--generations": ("generations", int),
    "--migration-period": ("migration_period", int),
    "--ls-candidates": ("ls_candidates", int),
    "--ls-mode": ("ls_mode", str),
    "--ls-sweeps": ("ls_sweeps", int),
    "--ls-swap-block": ("ls_swap_block", int),
    "--ls-block-events": ("ls_block_events", int),
    "--ls-sideways": ("ls_sideways", float),
    "--ls-hot-k": ("ls_hot_k", int),
    "--post-sweeps": ("post_ls_sweeps", int),
    "--post-swap-block": ("post_swap_block", int),
    "--post-hot-k": ("post_hot_k", int),
    "--post-sideways": ("post_sideways", float),
    "--post-pop-size": ("post_pop_size", int),
    "--post-lahc": ("post_lahc", int),
    "--post-lahc-k": ("post_lahc_k", int),
    "--init-sweeps": ("init_sweeps", int),
    "--rooms-mode": ("rooms_mode", str),
    "--epochs-per-dispatch": ("epochs_per_dispatch", int),
    "--kick-stall": ("kick_stall", int),
    "--trace-mode": ("trace_mode", str),
    "--checkpoint": ("checkpoint", str),
    "--checkpoint-every": ("checkpoint_every", int),
}

_BOOL_FLAGS = {"--trace": "trace", "--ls-converge": "ls_converge",
               "--ls-full-eval": "ls_full_eval", "--nsga2": "nsga2",
               "--resume": "resume"}
_NEG_BOOL_FLAGS = {"--no-auto-tune": "auto_tune"}

# Flags of the JAX CLI this slice does not implement yet: True = takes
# a value, False = a switch. Parsing any of them stops the run.
NOT_PORTED = {
    "--trace-profile": True, "--profile-dir": True, "--profile-for": True,
    "--mem-poll-every": True, "--metrics-every": True,
    "--obs-listen": True, "--history-every": True, "--incident-dir": True,
    "--incident-min-interval": True, "--stall-window": True,
    "--stall-hamming": True, "--max-recoveries": True,
    "--fetch-timeout": True, "--peer-timeout": True, "--faults": True,
    "--coordinator": True, "--num-processes": True, "--process-id": True,
    "--obs": False, "--quality": False, "--auto-kick-on-stall": False,
    "--distributed": False, "--no-precompile": False,
    "--no-pipeline": False, "--no-donate": False, "--no-accord": False,
}

_KNOWN_VALUES = {"ls_mode": ("random", "sweep"),
                 "rooms_mode": ("scan", "parallel"),
                 "trace_mode": ("full", "deltas", "stats")}


def not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not yet ported to "
                      f"timetabling_ga_tpu_torch (use timetabling_ga_tpu)")


def _usage() -> str:
    lines = ["usage: python -m timetabling_ga_tpu_torch -i <instance.tim> "
             "[flags]", ""]
    for flag, (field, typ) in _FLAG_MAP.items():
        lines.append(f"  {flag} <{typ.__name__}>".ljust(28) + field)
    for m in (_BOOL_FLAGS, _NEG_BOOL_FLAGS):
        for flag, field in m.items():
            lines.append(f"  {flag}".ljust(28) + field)
    lines.append("  -h, --help".ljust(28) + "show this message and exit")
    return "\n".join(lines)


def parse_args(argv) -> RunConfig:
    """Parse `-key value` pairs; unknown or unported flags raise."""
    cfg = RunConfig()
    seen = set()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(_usage())
            raise SystemExit(0)
        if a in NOT_PORTED:
            raise not_ported(a)
        if a in _BOOL_FLAGS:
            setattr(cfg, _BOOL_FLAGS[a], True)
            seen.add(_BOOL_FLAGS[a])
            i += 1
            continue
        if a in _NEG_BOOL_FLAGS:
            setattr(cfg, _NEG_BOOL_FLAGS[a], False)
            seen.add(_NEG_BOOL_FLAGS[a])
            i += 1
            continue
        if a not in _FLAG_MAP:
            raise SystemExit(f"unknown flag: {a}")
        if i + 1 >= len(argv):
            raise SystemExit(f"flag {a} needs a value")
        field, typ = _FLAG_MAP[a]
        setattr(cfg, field, typ(argv[i + 1]))
        seen.add(field)
        i += 2
    cfg.explicit_fields = frozenset(seen)
    if cfg.input is None:
        raise SystemExit("No instance file specified, use -i <file>")
    if cfg.backend not in ("gpu", "cpu"):
        raise SystemExit(f"unknown backend: {cfg.backend} (gpu or cpu)")
    for field, known in _KNOWN_VALUES.items():
        v = getattr(cfg, field)
        if v not in known:
            raise SystemExit(f"unknown {field.replace('_', '-')}: {v}")
    if cfg.ls_candidates < 1:
        raise SystemExit("--ls-candidates must be >= 1")
    if cfg.post_pop_size is not None and cfg.checkpoint:
        raise SystemExit("--post-pop-size changes the population shape "
                         "mid-run, which a checkpoint/resume cycle "
                         "cannot represent; drop one of the two flags")
    if cfg.post_pop_size is not None and cfg.post_pop_size < 1:
        raise SystemExit("--post-pop-size must be >= 1")
    if cfg.post_lahc < 0:
        raise SystemExit("--post-lahc must be >= 0 (history length; "
                         "0 disables the LAHC endgame)")
    if cfg.post_lahc > 1_000_000:
        raise SystemExit("--post-lahc history length is implausibly "
                         "large (max 1000000)")
    if not 1 <= cfg.post_lahc_k <= 4096:
        raise SystemExit("--post-lahc-k must be in [1, 4096] "
                         "(candidates per walker per step)")
    if (cfg.post_pop_size is not None and "pop_size" in seen
            and cfg.post_pop_size > cfg.pop_size):
        raise SystemExit("--post-pop-size must not exceed --pop-size "
                         "(it truncates to the elite rows)")
    return cfg
