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
no-op, since no dispatch writes into its input state), and the
profiler (`--trace-profile`, `--profile-dir`, `--profile-for`). A flag
it does not implement yet (`--peer-timeout`, `--coordinator`, ...:
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
`--metrics-every`, `--no-usage`, `--profile-dir`, `--profile-for` and
the five flags above among them, the fault plan, the per-job recovery
budget, the shedding marks, and the fleet replica's `--http`,
`--preempt-grace` and `--preempt-on-term`); `--mesh-devices` above 1
stops the parse by name. `FleetConfig` and `parse_fleet_args` are the
`fleet` subcommand's (JAX config.py:941-1314): the same flags, defaults,
checks and messages, but for `--backend`, which takes `gpu` (the
default: spawned workers run on the card) or `cpu`.
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
    trace_profile: Optional[str] = None  # capture one warm dispatch a
    #                               try with torch.profiler into this
    #                               directory (serial loop)
    profile_dir: Optional[str] = None  # on-demand captures' directory
    #                               (`profile` / GET /profile on
    #                               --obs-listen / --profile-for);
    #                               default "tt-profile"
    profile_for: int = 0          # > 0: capture the run's first N
    #                               dispatches at launch
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
    "--trace-profile": ("trace_profile", str),
    "--profile-dir": ("profile_dir", str),
    "--profile-for": ("profile_for", int),
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
                       neg_bool_flags, unported=()) -> set:
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
    if cfg.profile_for < 0:
        raise SystemExit("--profile-for must be >= 0 dispatches "
                         "(0 = no launch-time capture)")
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
    profile_dir: Optional[str] = None  # on-demand captures (RunConfig's
    profile_for: int = 0          #   semantics)
    max_job_recoveries: int = 2   # quantum-fault requeues a job before
    #                               it fails alone
    preempt_grace: float = 10.0   # the preempt drain's ship deadline:
    #                               after POST /v1/drain?mode=preempt
    #                               (or SIGTERM under --preempt-on-term)
    #                               the replica parks every active job,
    #                               publishes its snapshot and stays up
    #                               until each is fetched or this many
    #                               seconds pass
    preempt_on_term: bool = False  # SIGTERM is the preempt drain (a spot
    #                               worker: park and ship, do not run the
    #                               queue dry)
    http: Optional[str] = None    # HOST:PORT of the replica's HTTP solve
    #                               front (fleet/replicas.py serve_http):
    #                               JAX's /v1 protocol plus /metrics,
    #                               /healthz and /readyz on one port;
    #                               None = the line-JSON protocol


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
    "--profile-dir": ("profile_dir", str),
    "--profile-for": ("profile_for", int),
    "--http": ("http", str),
    "--preempt-grace": ("preempt_grace", float),
}

_SERVE_BOOL_FLAGS = {"--obs": "obs", "--quality": "quality",
                     "--preempt-on-term": "preempt_on_term"}

_SERVE_NEG_BOOL_FLAGS = {"--no-usage": "usage",
                         "--no-resident": "resident"}


def _serve_usage() -> str:
    return _format_usage(
        "usage: python -m timetabling_ga_tpu_torch serve [flags] "
        "(line-JSON jobs on -i/stdin, job-tagged JSONL records on "
        "-o/stdout; --http HOST:PORT serves the /v1 solve API instead)",
        _SERVE_FLAG_MAP,
        (_SERVE_BOOL_FLAGS, _SERVE_NEG_BOOL_FLAGS))


def parse_serve_args(argv) -> ServeConfig:
    """Parse the `serve` subcommand's flags (JAX config.py:885, the same
    checks and messages for the flags the port serves)."""
    cfg = ServeConfig()
    _parse_flag_stream(argv, cfg, _SERVE_FLAG_MAP, _serve_usage,
                       _SERVE_BOOL_FLAGS, _SERVE_NEG_BOOL_FLAGS)
    if cfg.backend not in ("gpu", "cpu"):
        raise SystemExit(f"unknown backend: {cfg.backend} (gpu or cpu)")
    if cfg.trace_mode not in _KNOWN_VALUES["trace_mode"]:
        raise SystemExit(f"unknown trace-mode: {cfg.trace_mode} (one of "
                         f"{', '.join(_KNOWN_VALUES['trace_mode'])})")
    if cfg.metrics_every < 0:
        raise SystemExit("--metrics-every must be >= 0 dispatches")
    _validate_obs_listen(cfg.obs_listen)
    _validate_obs_listen(cfg.http)   # the same HOST:PORT grammar
    _validate_flight(cfg)
    if cfg.profile_for < 0:
        raise SystemExit("--profile-for must be >= 0 dispatches")
    if cfg.mem_poll_every < 0:
        raise SystemExit("--mem-poll-every must be >= 0 seconds")
    if cfg.shed_queue_hwm < 0 or cfg.shed_writer_hwm < 0:
        raise SystemExit("--shed-queue-hwm / --shed-writer-hwm must be "
                         ">= 0 (0 disables that shed trigger)")
    if cfg.max_job_recoveries < 0:
        raise SystemExit("--max-job-recoveries must be >= 0 requeues "
                         "per job")
    if cfg.preempt_grace < 0:
        raise SystemExit("--preempt-grace must be >= 0 seconds")
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


# ---------------------------------------------------------------------------
# The fleet gateway (`fleet`, timetabling_ga_tpu_torch/fleet).


@dataclasses.dataclass
class FleetConfig:
    """Configuration of the fleet gateway (JAX config.py:941,
    fleet/gateway.py): one HTTP solve API over N replicas, each job
    routed where its bucket is warm (fleet/router.py). Replicas come
    from a static `--replica URL` list, or `--spawn N` local worker
    processes (`serve --http`, fleet/replicas.py). Flags after a
    literal `--` pass through to spawned workers, and the gateway
    parses them as serve flags for its bucket spec, so router and
    workers agree. Spawned workers run on the card (`backend` "gpu",
    where JAX's default is "tpu") unless `--backend cpu`."""

    listen: str = "127.0.0.1:8070"   # gateway HTTP bind
    replicas: list = dataclasses.field(default_factory=list)
    spawn: int = 0                   # local worker processes to spawn
    backend: str = "gpu"             # backend for spawned workers
    probe_every: float = 0.5         # liveness + /readyz + /metrics
    #                                  scrape cadence (the router's
    #                                  inputs refresh at this rate)
    poll_every: float = 0.2          # job-status poll cadence on the
    #                                  dispatcher thread (handlers
    #                                  serve the cached copy)
    probe_timeout: float = 2.0       # control-plane HTTP timeout
    #                                  (/readyz, /metrics, state polls)
    io_timeout: float = 30.0         # data-plane HTTP timeout
    #                                  (submissions, terminal record
    #                                  tails: a problem-JSON payload can
    #                                  be tens of MB)
    max_restarts: int = 3            # restarts a spawned replica may
    #                                  take after deaths
    dead_after: int = 3              # failed probes in a row before a
    #                                  replica is dead and its jobs
    #                                  fail over
    boot_grace: float = 120.0        # seconds a replica that never
    #                                  answered may stay unreachable
    #                                  before failures count (a worker
    #                                  imports torch and binds its port
    #                                  first)
    place_timeout: float = 120.0     # seconds a job may wait in
    #                                  requeue-and-retry placement
    #                                  (e.g. every replica booting),
    #                                  counted from its placement round
    retain_terminal: int = 4096      # settled jobs kept queryable;
    #                                  the oldest beyond are evicted
    #                                  (404)
    route_retries: int = 3           # submission attempts a replica
    #                                  (runtime/retry.py schedule)
    retry_wait_s: float = 0.2        # base wait of that schedule
    backlog: int = 256               # gateway job-table admission bound
    snapshot_timeout: float = 5.0    # HTTP budget of one ?snapshot=1
    #                                  cache refresh: it runs on the
    #                                  one dispatcher thread and is an
    #                                  optimization, so one hung
    #                                  replica's export must not eat
    #                                  the fleet's tick
    snapshot_hwm: int = 256 * 1024 * 1024
    #                                  byte budget of the per-job
    #                                  snapshot cache: the newest
    #                                  fingerprint-valid wire of each
    #                                  job in flight, oldest progress
    #                                  evicted first over the budget;
    #                                  an uncached job fails over by
    #                                  replay. 0 disables the cache
    faults: Optional[str] = None     # fault plan (gateway/route/
    #                                  gw_writer/gw_scrape sites)
    # ---- the gateway's own telemetry and readiness
    output: Optional[str] = None     # -o LOG: the gateway's JSONL stream
    #                                  (dispatcher spans with
    #                                  cross-process flow ids, a
    #                                  routeEntry a placement,
    #                                  metricsEntry snapshots, SLO
    #                                  faultEntry records); None = none
    metrics_every: int = 50          # dispatcher ticks between
    #                                  metricsEntry snapshots (0 = only
    #                                  the final one)
    slo_p99: float = 0.0             # rolling p99 bound (seconds) over
    #                                  submit-to-settled latencies;
    #                                  above it /readyz reports
    #                                  `slo_burn`. 0 = no SLO monitor
    slo_window: int = 100            # settled jobs in that window
    stall_after: float = 60.0        # seconds since the dispatcher's
    #                                  last tick before /readyz reports
    #                                  `dispatcher_stalled` (0 = off)
    # ---- the history ring and the flight recorder (RunConfig's
    # semantics); the gateway also triggers on failover and SLO burn and
    # stitches the involved replicas' bundles into one
    history_every: float = 1.0
    incident_dir: Optional[str] = None
    incident_min_interval: float = 30.0
    # ---- the autoscaler (fleet/autoscaler.py), on when --scale-max > 0;
    # it acts on the --spawn pool, or only logs under --scale-dry-run
    scale_min: int = 1               # never retire below this many
    scale_max: int = 0               # never spawn above this many;
    #                                  0 = autoscaler off
    scale_up_queue: float = 8.0      # spawn: serve.queue_depth >= this
    scale_up_for: float = 30.0       #   for this many seconds (also the
    #                                  fleet.slo_burn window)
    scale_down_queue: float = 1.0    # retire: queue_depth <= this
    scale_down_for: float = 120.0    #   for this many seconds
    scale_idle_window: float = 300.0  # a victim's own mean backlog over
    #                                  this window must be at or below
    #                                  the retire threshold too
    scale_cooldown: float = 60.0     # seconds after an action before
    #                                  the next (the below-min floor
    #                                  heal bypasses it)
    scale_every: float = 1.0         # policy evaluation cadence
    scale_warm_recent: float = 120.0  # a bucket routed within this many
    #                                  seconds is hot: its only warm
    #                                  replica is never retired
    scale_starve_rate: float = 0.0   # spawn when a tenant's
    #                                  usage.tenant.<t>.queue_seconds
    #                                  grows at this rate (s/s); 0 = off
    scale_dry_run: bool = False      # log decisions, actuate nothing
    serve_args: list = dataclasses.field(default_factory=list)
    #                                  verbatim worker flags (after --)


_FLEET_FLAG_MAP = {
    "--listen": ("listen", str),
    "-o": ("output", str),
    "--metrics-every": ("metrics_every", int),
    "--slo-p99": ("slo_p99", float),
    "--slo-window": ("slo_window", int),
    "--stall-after": ("stall_after", float),
    "--history-every": ("history_every", float),
    "--incident-dir": ("incident_dir", str),
    "--incident-min-interval": ("incident_min_interval", float),
    "--spawn": ("spawn", int),
    "--backend": ("backend", str),
    "--probe-every": ("probe_every", float),
    "--poll-every": ("poll_every", float),
    "--probe-timeout": ("probe_timeout", float),
    "--io-timeout": ("io_timeout", float),
    "--max-restarts": ("max_restarts", int),
    "--dead-after": ("dead_after", int),
    "--boot-grace": ("boot_grace", float),
    "--place-timeout": ("place_timeout", float),
    "--retain-terminal": ("retain_terminal", int),
    "--route-retries": ("route_retries", int),
    "--retry-wait": ("retry_wait_s", float),
    "--backlog": ("backlog", int),
    "--snapshot-hwm": ("snapshot_hwm", int),
    "--snapshot-timeout": ("snapshot_timeout", float),
    "--scale-min": ("scale_min", int),
    "--scale-max": ("scale_max", int),
    "--scale-up-queue": ("scale_up_queue", float),
    "--scale-up-for": ("scale_up_for", float),
    "--scale-down-queue": ("scale_down_queue", float),
    "--scale-down-for": ("scale_down_for", float),
    "--scale-idle-window": ("scale_idle_window", float),
    "--scale-cooldown": ("scale_cooldown", float),
    "--scale-every": ("scale_every", float),
    "--scale-warm-recent": ("scale_warm_recent", float),
    "--scale-starve-rate": ("scale_starve_rate", float),
    "--faults": ("faults", str),
}

_FLEET_BOOL_FLAGS = {"--scale-dry-run": "scale_dry_run"}


def _fleet_usage() -> str:
    return _format_usage(
        "usage: python -m timetabling_ga_tpu_torch fleet --listen H:P "
        "(--replica URL ... | --spawn N) [flags] [-- serve flags]\n\n"
        "fleet gateway: HTTP solve front + bucket-affine router over "
        "N replicas (`--replica` may repeat; flags after `--` pass "
        "through to spawned `serve --http` workers):",
        {"--replica": ("replicas (repeatable)", str),
         **_FLEET_FLAG_MAP},
        (_FLEET_BOOL_FLAGS,))


def parse_fleet_args(argv) -> FleetConfig:
    """Parse the `fleet` subcommand's flags (JAX config.py:1215, the
    same checks and messages). `--replica URL` repeats; everything
    after a literal `--` is kept verbatim for spawned workers (and
    parsed as serve flags by the gateway for its bucket spec)."""
    cfg = FleetConfig()
    argv = list(argv)
    if "--" in argv:
        split = argv.index("--")
        cfg.serve_args = argv[split + 1:]
        argv = argv[:split]
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "--replica":
            if i + 1 >= len(argv):
                raise SystemExit("flag --replica needs a value")
            cfg.replicas.append(argv[i + 1])
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    _parse_flag_stream(rest, cfg, _FLEET_FLAG_MAP, _fleet_usage,
                       _FLEET_BOOL_FLAGS, {})
    _validate_obs_listen(cfg.listen)
    if cfg.backend not in ("gpu", "cpu"):
        raise SystemExit(f"unknown backend: {cfg.backend} (gpu or cpu)")
    if cfg.spawn < 0:
        raise SystemExit("--spawn must be >= 0 worker processes")
    if not cfg.replicas and cfg.spawn == 0:
        raise SystemExit("fleet needs replicas: pass --replica URL "
                         "(repeatable) or --spawn N")
    if cfg.replicas and cfg.spawn:
        raise SystemExit("--replica and --spawn are exclusive: either "
                         "the fleet manages its own local workers or "
                         "it fronts externally managed ones")
    if cfg.probe_every <= 0 or cfg.poll_every <= 0:
        raise SystemExit("--probe-every / --poll-every must be > 0 "
                         "seconds")
    if cfg.probe_timeout <= 0 or cfg.io_timeout <= 0:
        raise SystemExit("--probe-timeout / --io-timeout must be > 0 "
                         "seconds")
    if cfg.max_restarts < 0:
        raise SystemExit("--max-restarts must be >= 0")
    if cfg.dead_after < 1:
        raise SystemExit("--dead-after must be >= 1 failed probes")
    if cfg.boot_grace < 0 or cfg.place_timeout < 0:
        raise SystemExit("--boot-grace / --place-timeout must be "
                         ">= 0 seconds")
    if cfg.retain_terminal < 1:
        raise SystemExit("--retain-terminal must be >= 1 settled job")
    if cfg.route_retries < 1:
        raise SystemExit("--route-retries must be >= 1 attempts")
    if cfg.retry_wait_s <= 0:
        raise SystemExit("--retry-wait must be > 0 seconds")
    if cfg.backlog < 1:
        raise SystemExit("--backlog must be >= 1")
    if cfg.snapshot_hwm < 0:
        raise SystemExit("--snapshot-hwm must be >= 0 bytes (0 "
                         "disables the snapshot cache: failover "
                         "replays from generation 0)")
    if cfg.snapshot_timeout <= 0:
        raise SystemExit("--snapshot-timeout must be > 0 seconds")
    if cfg.metrics_every < 0:
        raise SystemExit("--metrics-every must be >= 0 dispatcher "
                         "ticks (0 = only the final snapshot)")
    if cfg.slo_p99 < 0:
        raise SystemExit("--slo-p99 must be >= 0 seconds (0 disables "
                         "the SLO monitor)")
    if cfg.slo_window < 1:
        raise SystemExit("--slo-window must be >= 1 settled jobs")
    if cfg.stall_after < 0:
        raise SystemExit("--stall-after must be >= 0 seconds (0 "
                         "disables the dispatcher watchdog)")
    _validate_flight(cfg)
    if cfg.scale_max < 0:
        raise SystemExit("--scale-max must be >= 0 replicas "
                         "(0 disables the autoscaler)")
    if cfg.scale_max > 0:
        # the autoscaler (fleet/autoscaler.py) needs a worker pool to
        # grow and shrink and a history ring to evaluate
        if cfg.scale_min < 1:
            raise SystemExit("--scale-min must be >= 1 replica (the "
                             "fleet must keep something to route to)")
        if cfg.scale_min > cfg.scale_max:
            raise SystemExit("--scale-min must not exceed --scale-max")
        if not cfg.spawn and not cfg.scale_dry_run:
            raise SystemExit(
                "--scale-max needs the --spawn worker pool (the "
                "actuator spawns/retires local workers; a static "
                "--replica fleet has no pool) — or --scale-dry-run "
                "to evaluate the policy without acting")
        if cfg.history_every <= 0:
            raise SystemExit("--scale-max needs --history-every > 0 "
                             "(the policy evaluates obs/history.py "
                             "sustained()/rate()/mean_over() windows)")
        if cfg.scale_every <= 0:
            raise SystemExit("--scale-every must be > 0 seconds")
        if cfg.scale_up_for <= 0 or cfg.scale_down_for <= 0:
            raise SystemExit("--scale-up-for / --scale-down-for must "
                             "be > 0 seconds (a sustained window)")
        if cfg.scale_up_queue <= cfg.scale_down_queue:
            raise SystemExit(
                "--scale-up-queue must exceed --scale-down-queue "
                "(overlapping trigger bands guarantee flapping)")
        if (cfg.scale_cooldown < 0 or cfg.scale_idle_window < 0
                or cfg.scale_warm_recent < 0
                or cfg.scale_starve_rate < 0):
            raise SystemExit("--scale-cooldown / --scale-idle-window "
                             "/ --scale-warm-recent / "
                             "--scale-starve-rate must be >= 0")
    # the worker flags must themselves parse (a typo would otherwise
    # only surface as N crashed spawns); the parsed copy also gives
    # the gateway its bucket spec, so router and workers agree
    if cfg.serve_args:
        parse_serve_args(cfg.serve_args)
    if cfg.spawn and "-o" in cfg.serve_args:
        # N worker processes appending one record file interleave
        # torn JSONL lines; each spawned worker writes its own
        # tt-fleet-<name>.jsonl instead (fleet/replicas.spawn_one)
        raise SystemExit("-o in the worker passthrough flags would "
                         "make every spawned replica write ONE shared "
                         "record file; drop it — workers write "
                         "./tt-fleet-<name>.jsonl each")
    return cfg
