"""Command-line entry point of the PyTorch port.

    python -m timetabling_ga_tpu_torch.cli -i fixtures/comp01s.tim -s 42
    python -m timetabling_ga_tpu_torch serve -i requests.jsonl

runs the size-tuned solve on the GPU (`--backend cpu` runs it on the
host) and writes the JSONL protocol to stdout or `-o <file>`; `serve`
runs the multi-tenant solver service (serve/service.py) over line-JSON
requests. The offline readers of a record stream,

    python -m timetabling_ga_tpu_torch trace run.jsonl -o trace.json
    python -m timetabling_ga_tpu_torch stats run.jsonl
    python -m timetabling_ga_tpu_torch quality run.jsonl
    python -m timetabling_ga_tpu_torch usage serve.jsonl
    python -m timetabling_ga_tpu_torch incident incidents/
    python -m timetabling_ga_tpu_torch scale gateway.jsonl
    python -m timetabling_ga_tpu_torch hotspots tt-profile/
    python -m timetabling_ga_tpu_torch profile http://HOST:PORT --for 2

(obs/trace_export.py, obs/logstats.py, obs/quality.py, obs/usage.py,
obs/flight.py, fleet/autoscaler.py, obs/prof.py, and obs/cost.py's
stdlib HTTP client of a live run's --obs-listen front) import neither
torch nor the kernels, so they run on any machine a log, a bundle or a
capture was copied to: nothing above their dispatch below imports
torch. The
flags are the JAX CLI's (runtime/config.py); those not ported yet stop
the parse with a message that names them, and so do the JAX CLI's other
subcommands.
"""

from __future__ import annotations

import sys

# the offline readers (timetabling_ga_tpu/cli.py:100-128): subcommand ->
# (module, entry point), imported only when called
READERS = {
    "trace": ("timetabling_ga_tpu_torch.obs.trace_export", "main_trace"),
    "stats": ("timetabling_ga_tpu_torch.obs.logstats", "main_stats"),
    "quality": ("timetabling_ga_tpu_torch.obs.quality", "main_quality"),
    "usage": ("timetabling_ga_tpu_torch.obs.usage", "main_usage"),
    "incident": ("timetabling_ga_tpu_torch.obs.flight", "main_incident"),
    "scale": ("timetabling_ga_tpu_torch.fleet.autoscaler", "main_scale"),
    "hotspots": ("timetabling_ga_tpu_torch.obs.prof", "main_hotspots"),
    "profile": ("timetabling_ga_tpu_torch.obs.cost", "main_profile"),
}

# the JAX CLI's other subcommands (timetabling_ga_tpu/cli.py:95-156), not
# ported yet
NOT_PORTED_SUBCOMMANDS = ("fleet", "submit")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in READERS:
        import importlib
        mod, fn = READERS[argv[0]]
        return getattr(importlib.import_module(mod), fn)(argv[1:])
    from timetabling_ga_tpu_torch.runtime.config import (
        not_ported, parse_args)
    if argv and argv[0] == "serve":
        from timetabling_ga_tpu_torch.serve.service import main_serve
        return main_serve(argv[1:])
    if argv and argv[0] in NOT_PORTED_SUBCOMMANDS:
        raise not_ported(f"the {argv[0]} subcommand")
    cfg = parse_args(argv)
    from timetabling_ga_tpu_torch.runtime.engine import run
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
