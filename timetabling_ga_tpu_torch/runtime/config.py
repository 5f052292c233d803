"""Run configuration and CLI flag parsing (port of
timetabling_ga_tpu/runtime/config.py:95-434, 601-).

The flag surface is the JAX CLI's, in the reference's `-key value` model
(Control.cpp:3-176). The port implements the single-GPU CLI solve, with
the sweep or the random-candidate local search (`--ls-mode random`, the
untuned default, sized by `-p` / `-m` as the reference's maxSteps), the
parallel room matcher (`--rooms-mode parallel`), NSGA-II selection
(`--nsga2`), the LAHC endgame (`--post-lahc`, `--post-lahc-k`),
checkpoint/resume (`--checkpoint`, `--checkpoint-every`, `--resume`),
the compressed trace modes (`--trace-mode deltas|stats`), the quality
telemetry (`--quality`, `--stall-window`, `--stall-hamming`,
`--auto-kick-on-stall`), the spans and metrics records (`--obs`,
`--metrics-every`), the pull front, history ring, flight recorder and
memory poller (`--obs-listen`, `--history-every`, `--incident-dir`,
`--incident-min-interval`, `--mem-poll-every`; JAX config.py:200-265,
the same defaults and checks), and the dispatch pipeline with in-run
fault recovery (`--no-pipeline`, `--max-recoveries`, `--fetch-timeout`,
`--faults`, `--no-precompile`: skip the sec/gen probe; `--no-donate`: a
no-op, since no dispatch writes into its input state). A flag it does
not implement yet (`--trace-profile`, `--profile-dir`, ...:
`NOT_PORTED`) stops the parse with a message naming it as not yet
ported, never silently ignored. `-l` is accepted and retired, as on the
JAX path: the engine warns that the local search is bounded by -m
instead. JAX's checkpoint refusals hold: the tuned `post_pop_size` is
dropped under `--checkpoint`, and an explicit `--post-pop-size` with
`--checkpoint` stops the parse.

`--backend` is `gpu` (the default) or `cpu`; a GPU run that finds no
CUDA device raises instead of falling back to the CPU.

`ServeConfig` and `parse_serve_args` are the `serve` subcommand's (JAX
config.py:689-936): the same flags, defaults and messages for what the
port serves (`--trace-mode full|deltas|stats`, `--quality`, `--obs`,
`--metrics-every`, `--no-usage` and the five flags above among them,
and the fault plan, the per-job recovery budget and the shedding
marks); the service's other
flags (`SERVE_NOT_PORTED`) and `--mesh-devices` above 1 stop the parse
by name.
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
    obs: bool = False             # spanEntry spans and metricsEntry
    #                               snapshots on the record stream; the
    #                               registry updates regardless, this
    #                               gates only the records
    trace_mode: str = "full"
    metrics_every: int = 10       # dispatches between metricsEntry
    #                               snapshots under --obs (0 = only the
    #                               end-of-try snapshot)
    obs_listen: Optional[str] = None  # HOST:PORT of the pull front
    #                               (obs/http.py: /metrics, /healthz,
    #                               /readyz, /metrics/history); None = off
    history_every: float = 1.0    # seconds between registry samples on
    #                               the history ring (0 disables it)
    incident_dir: Optional[str] = None  # where the flight recorder
    #                               dumps incident bundles; None = off
    incident_min_interval: float = 30.0  # seconds between dumps
    mem_poll_every: float = 1.0   # seconds between device memory
    #                               samples on the poller thread (under
    #                               --obs/--obs-listen; 0 disables it)
    checkpoint: Optional[str] = None
    checkpoint_every: int = 1
    resume: bool = False
    quality: bool = False         # the quality telemetry (K14)
    stall_window: int = 8         # dispatches with no new best before a
    #                               stall (0 disables the detector)
    stall_hamming: float = 0.05   # ... with the most-collapsed island's
    #                               Hamming sample at or below this
    auto_kick_on_stall: bool = False  # a stall fires the kick
    precompile: bool = True       # probe sec/gen before the loop;
    #                               --no-precompile runs serially until
    #                               a measured chunk gives the estimate
    pipeline: bool = True         # the depth-2 dispatch pipeline
    #                               (off with a post config or the
    #                               quality auto-kick; --no-pipeline)
    donate: bool = True           # JAX's buffer donation; no dispatch
    #                               of the port writes into its input
    #                               state, so --no-donate changes nothing
    max_recoveries: int = 3       # in-run recoveries before the run
    #                               aborts with a final checkpoint
    #                               (0 = off)
    fetch_timeout: float = 600.0  # control-fence read deadline in
    #                               seconds (0 = no watchdog)
    faults: Optional[str] = None  # fault plan (runtime/faults.py);
    #                               None reads $TT_FAULTS
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
    "--stall-window": ("stall_window", int),
    "--stall-hamming": ("stall_hamming", float),
    "--max-recoveries": ("max_recoveries", int),
    "--fetch-timeout": ("fetch_timeout", float),
    "--faults": ("faults", str),
    "--metrics-every": ("metrics_every", int),
    "--obs-listen": ("obs_listen", str),
    "--history-every": ("history_every", float),
    "--incident-dir": ("incident_dir", str),
    "--incident-min-interval": ("incident_min_interval", float),
    "--mem-poll-every": ("mem_poll_every", float),
}

_BOOL_FLAGS = {"--trace": "trace", "--ls-converge": "ls_converge",
               "--obs": "obs",
               "--ls-full-eval": "ls_full_eval", "--nsga2": "nsga2",
               "--resume": "resume", "--quality": "quality",
               "--auto-kick-on-stall": "auto_kick_on_stall"}
_NEG_BOOL_FLAGS = {"--no-auto-tune": "auto_tune",
                   "--no-precompile": "precompile",
                   "--no-pipeline": "pipeline",
                   "--no-donate": "donate"}

# Flags of the JAX CLI this slice does not implement yet: True = takes
# a value, False = a switch. Parsing any of them stops the run.
NOT_PORTED = {
    "--trace-profile": True, "--profile-dir": True, "--profile-for": True,
    "--peer-timeout": True,
    "--coordinator": True, "--num-processes": True, "--process-id": True,
    "--distributed": False, "--no-accord": False,
}

_KNOWN_VALUES = {"ls_mode": ("random", "sweep"),
                 "rooms_mode": ("scan", "parallel"),
                 "trace_mode": ("full", "deltas", "stats")}


def not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not yet ported to "
                      f"timetabling_ga_tpu_torch (use timetabling_ga_tpu)")


def _format_usage(header, flag_map, bool_maps) -> str:
    lines = [header, ""]
    for flag, (field, typ) in flag_map.items():
        lines.append(f"  {flag} <{typ.__name__}>".ljust(28) + field)
    for m in bool_maps:
        for flag, field in m.items():
            lines.append(f"  {flag}".ljust(28) + field)
    lines.append("  -h, --help".ljust(28) + "show this message and exit")
    return "\n".join(lines)


def _usage() -> str:
    return _format_usage("usage: python -m timetabling_ga_tpu_torch -i "
                         "<instance.tim> [flags]", _FLAG_MAP,
                         (_BOOL_FLAGS, _NEG_BOOL_FLAGS))


def _parse_flag_stream(argv, cfg, flag_map, usage_fn, bool_flags,
                       neg_bool_flags, unported) -> set:
    """The `-key value` loop of parse_args and parse_serve_args: -h
    prints the usage and exits 0, an `unported` flag stops the parse by
    name, unknown flags and missing values are SystemExit. Returns the
    fields the argv set."""
    seen = set()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(usage_fn())
            raise SystemExit(0)
        if a in unported:
            raise not_ported(a)
        if a in bool_flags:
            setattr(cfg, bool_flags[a], True)
            seen.add(bool_flags[a])
            i += 1
            continue
        if a in neg_bool_flags:
            setattr(cfg, neg_bool_flags[a], False)
            seen.add(neg_bool_flags[a])
            i += 1
            continue
        if a not in flag_map:
            raise SystemExit(f"unknown flag: {a}")
        if i + 1 >= len(argv):
            raise SystemExit(f"flag {a} needs a value")
        field, typ = flag_map[a]
        setattr(cfg, field, typ(argv[i + 1]))
        seen.add(field)
        i += 2
    return seen


def _validate_obs_listen(spec) -> None:
    """Fail the parse, not the run, on a malformed --obs-listen (JAX
    config.py:569-580; the pull front's parse_listen is the one source
    of the grammar)."""
    if spec is None:
        return
    from timetabling_ga_tpu_torch.obs.http import parse_listen
    try:
        parse_listen(spec)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _validate_flight(cfg) -> None:
    """The history and recorder flags' checks (JAX config.py:582-590)."""
    if cfg.history_every < 0:
        raise SystemExit("--history-every must be >= 0 seconds "
                         "(0 disables the metrics history ring)")
    if cfg.incident_min_interval < 0:
        raise SystemExit("--incident-min-interval must be >= 0 "
                         "seconds between incident dumps")


def parse_args(argv) -> RunConfig:
    """Parse `-key value` pairs; unknown or unported flags raise."""
    cfg = RunConfig()
    seen = _parse_flag_stream(argv, cfg, _FLAG_MAP, _usage, _BOOL_FLAGS,
                              _NEG_BOOL_FLAGS, NOT_PORTED)
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
    if cfg.metrics_every < 0:
        raise SystemExit("--metrics-every must be >= 0 dispatches "
                         "(0 = only the end-of-try snapshot)")
    _validate_obs_listen(cfg.obs_listen)
    _validate_flight(cfg)
    if cfg.mem_poll_every < 0:
        raise SystemExit("--mem-poll-every must be >= 0 seconds "
                         "(0 disables the device memory poller)")
    if cfg.max_recoveries < 0:
        raise SystemExit("--max-recoveries must be >= 0 (0 disables "
                         "in-run recovery)")
    if cfg.fetch_timeout < 0:
        raise SystemExit("--fetch-timeout must be >= 0 seconds "
                         "(0 disables the fetch watchdog)")
    if cfg.post_lahc < 0:
        raise SystemExit("--post-lahc must be >= 0 (history length; "
                         "0 disables the LAHC endgame)")
    if cfg.post_lahc > 1_000_000:
        raise SystemExit("--post-lahc history length is implausibly "
                         "large (max 1000000)")
    if not 1 <= cfg.post_lahc_k <= 4096:
        raise SystemExit("--post-lahc-k must be in [1, 4096] "
                         "(candidates per walker per step)")
    # JAX config.py:632-640, the same messages
    if cfg.stall_window < 0:
        raise SystemExit("--stall-window must be >= 0 dispatches "
                         "(0 disables the stall detector)")
    if not 0.0 <= cfg.stall_hamming <= 1.0:
        raise SystemExit("--stall-hamming must be in [0, 1] (a Hamming "
                         "sample mean is a fraction of differing slots)")
    if cfg.auto_kick_on_stall and not cfg.quality:
        raise SystemExit("--auto-kick-on-stall needs --quality (the "
                         "stall detector reads the on-device diversity "
                         "telemetry)")
    if (cfg.post_pop_size is not None and "pop_size" in seen
            and cfg.post_pop_size > cfg.pop_size):
        raise SystemExit("--post-pop-size must not exceed --pop-size "
                         "(it truncates to the elite rows)")
    return cfg


# ---------------------------------------------------------------------------
# The solver service (`serve`; serve/service.py has the request grammar).


@dataclasses.dataclass
class ServeConfig:
    """Configuration of the multi-tenant solver service (JAX
    config.py:689): jobs arrive over the line-JSON protocol, each
    instance is padded to its shape bucket (serve/bucket.py), and up to
    `lanes` same-bucket jobs share a dispatch of `quantum` generations."""

    input: Optional[str] = None   # line-JSON request file; None = stdin
    output: Optional[str] = None  # record stream; None = stdout
    backend: str = "gpu"
    lanes: int = 4                # job lanes per dispatch
    mesh_devices: int = 0         # cards serving (0 and 1: the one card)
    resident: bool = True         # a group whose lanes are unchanged
    #                               between quanta stays on the card;
    #                               --no-resident parks it every quantum
    #                               (the record stream is the same)
    quantum: int = 25             # generations per time slice
    backlog: int = 64             # admission-control bound (active jobs)
    pop_size: int = 16            # per-job island population
    generations: int = 200        # default per-job budget
    seed: int = 0                 # default per-job seed
    bucket_events: int = 32       # geometric bucket floors + ratio
    bucket_rooms: int = 4         #   (serve/bucket.py BucketSpec)
    bucket_features: int = 4
    bucket_students: int = 32
    bucket_ratio: float = 2.0
    max_steps: int = 32           # LS budget per generation (candidate
    #                               evaluations; rounds = this //
    #                               ls_candidates)
    ls_candidates: int = 8
    obs: bool = False             # spanEntry spans (admit/pack/quantum/
    #                               park/resume) and metricsEntry
    #                               snapshots on the record stream
    trace_mode: str = "full"      # the lane runner's telemetry: full
    #                               (every generation's best), deltas or
    #                               stats (the packed leaf, K13)
    quality: bool = False         # the quality block on every quantum's
    #                               leaf (quality.* metrics; K14)
    metrics_every: int = 10       # dispatches between metricsEntry
    #                               snapshots under --obs
    usage: bool = True            # usage metering (obs/usage.py): the
    #                               per-job meter folded at every park
    #                               fence, the usage.tenant.<t>.*
    #                               counters, the wire's usage cursor,
    #                               and usageEntry records under --obs;
    #                               --no-usage turns it off (the record
    #                               streams are the same either way)
    shed_queue_hwm: int = 0       # serve.queue_depth high-water mark:
    #                               at or over it a control fence sheds
    #                               the lowest-priority runnable job
    #                               (0 = never)
    shed_writer_hwm: int = 0      # writer.queue_depth high-water mark
    #                               (0 = never)
    faults: Optional[str] = None  # fault plan (runtime/faults.py);
    #                               None reads $TT_FAULTS
    obs_listen: Optional[str] = None  # the pull front, the history
    history_every: float = 1.0    #   ring, the flight recorder and the
    incident_dir: Optional[str] = None  # memory poller: the same
    incident_min_interval: float = 30.0  # semantics as RunConfig's
    mem_poll_every: float = 1.0
    max_job_recoveries: int = 2   # quantum-fault requeues a job before
    #                               it fails alone


_SERVE_FLAG_MAP = {
    "-i": ("input", str),
    "-o": ("output", str),
    "--backend": ("backend", str),
    "--lanes": ("lanes", int),
    "--mesh-devices": ("mesh_devices", int),
    "--quantum": ("quantum", int),
    "--backlog": ("backlog", int),
    "--pop-size": ("pop_size", int),
    "--generations": ("generations", int),
    "-s": ("seed", int),
    "--bucket-events": ("bucket_events", int),
    "--bucket-rooms": ("bucket_rooms", int),
    "--bucket-features": ("bucket_features", int),
    "--bucket-students": ("bucket_students", int),
    "--bucket-ratio": ("bucket_ratio", float),
    "-m": ("max_steps", int),
    "--ls-candidates": ("ls_candidates", int),
    "--trace-mode": ("trace_mode", str),
    "--shed-queue-hwm": ("shed_queue_hwm", int),
    "--shed-writer-hwm": ("shed_writer_hwm", int),
    "--faults": ("faults", str),
    "--max-job-recoveries": ("max_job_recoveries", int),
    "--metrics-every": ("metrics_every", int),
    "--obs-listen": ("obs_listen", str),
    "--history-every": ("history_every", float),
    "--incident-dir": ("incident_dir", str),
    "--incident-min-interval": ("incident_min_interval", float),
    "--mem-poll-every": ("mem_poll_every", float),
}

_SERVE_BOOL_FLAGS = {"--obs": "obs", "--quality": "quality"}

_SERVE_NEG_BOOL_FLAGS = {"--no-usage": "usage",
                         "--no-resident": "resident"}

# The JAX service's flags this slice does not serve yet: True = takes a
# value, False = a switch. Parsing any of them stops the parse.
SERVE_NOT_PORTED = {
    "--profile-dir": True, "--profile-for": True, "--http": True,
    "--preempt-grace": True, "--preempt-on-term": False,
}


def _serve_usage() -> str:
    return _format_usage(
        "usage: python -m timetabling_ga_tpu_torch serve [flags] "
        "(line-JSON jobs on -i/stdin, job-tagged JSONL records on "
        "-o/stdout)", _SERVE_FLAG_MAP,
        (_SERVE_BOOL_FLAGS, _SERVE_NEG_BOOL_FLAGS))


def parse_serve_args(argv) -> ServeConfig:
    """Parse the `serve` subcommand's flags (JAX config.py:885, the same
    checks and messages for the flags the port serves)."""
    cfg = ServeConfig()
    _parse_flag_stream(argv, cfg, _SERVE_FLAG_MAP, _serve_usage,
                       _SERVE_BOOL_FLAGS, _SERVE_NEG_BOOL_FLAGS,
                       SERVE_NOT_PORTED)
    if cfg.backend not in ("gpu", "cpu"):
        raise SystemExit(f"unknown backend: {cfg.backend} (gpu or cpu)")
    if cfg.trace_mode not in _KNOWN_VALUES["trace_mode"]:
        raise SystemExit(f"unknown trace-mode: {cfg.trace_mode} (one of "
                         f"{', '.join(_KNOWN_VALUES['trace_mode'])})")
    if cfg.metrics_every < 0:
        raise SystemExit("--metrics-every must be >= 0 dispatches")
    _validate_obs_listen(cfg.obs_listen)
    _validate_flight(cfg)
    if cfg.mem_poll_every < 0:
        raise SystemExit("--mem-poll-every must be >= 0 seconds")
    if cfg.shed_queue_hwm < 0 or cfg.shed_writer_hwm < 0:
        raise SystemExit("--shed-queue-hwm / --shed-writer-hwm must be "
                         ">= 0 (0 disables that shed trigger)")
    if cfg.max_job_recoveries < 0:
        raise SystemExit("--max-job-recoveries must be >= 0 requeues "
                         "per job")
    if cfg.lanes < 1:
        raise SystemExit("--lanes must be >= 1")
    if cfg.mesh_devices < 0:
        raise SystemExit("--mesh-devices must be >= 0 "
                         "(0 = every visible device)")
    if cfg.mesh_devices > 1:
        raise not_ported(f"--mesh-devices {cfg.mesh_devices} (serving on "
                         f"more than one card)")
    if cfg.quantum < 1:
        raise SystemExit("--quantum must be >= 1 generation")
    if cfg.backlog < 1:
        raise SystemExit("--backlog must be >= 1")
    if cfg.bucket_ratio <= 1.0:
        raise SystemExit("--bucket-ratio must be > 1.0 (geometric "
                         "bucket growth)")
    return cfg
