"""Command-line entry point of the PyTorch port.

    python -m timetabling_ga_tpu_torch.cli -i fixtures/comp01s.tim -s 42
    python -m timetabling_ga_tpu_torch serve -i requests.jsonl
    python -m timetabling_ga_tpu_torch fleet --listen 127.0.0.1:8070 \
        --spawn 2 -- --lanes 4
    python -m timetabling_ga_tpu_torch submit http://127.0.0.1:8070 x.tim

runs the size-tuned solve on the GPU (`--backend cpu` runs it on the
host) and writes the JSONL protocol to stdout or `-o <file>`; `serve`
runs the multi-tenant solver service (serve/service.py) over line-JSON
requests, or `--http` as a fleet replica; `fleet` runs the gateway
(fleet/gateway.py) over replicas it spawns (`serve --http` processes of
the port, on the card unless `--backend cpu`) or is given (`--replica
URL`); `submit` sends one instance to a gateway or replica and waits
(fleet/client.py). The offline readers of a record stream,

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
torch, and neither do the gateway and the submit client, which route
and poll over HTTP only. The flags are the JAX CLI's
(runtime/config.py). A run split over processes (`--coordinator
host:port --num-processes N --process-id i`, or `--distributed` under
torchrun) exits 70 when a peer process is lost.
"""

from __future__ import annotations

import sys

# the subcommands that load no torch (timetabling_ga_tpu/cli.py:100-151):
# subcommand -> (module, entry point), imported only when called
TORCH_FREE = {
    "trace": ("timetabling_ga_tpu_torch.obs.trace_export", "main_trace"),
    "stats": ("timetabling_ga_tpu_torch.obs.logstats", "main_stats"),
    "quality": ("timetabling_ga_tpu_torch.obs.quality", "main_quality"),
    "usage": ("timetabling_ga_tpu_torch.obs.usage", "main_usage"),
    "incident": ("timetabling_ga_tpu_torch.obs.flight", "main_incident"),
    "scale": ("timetabling_ga_tpu_torch.fleet.autoscaler", "main_scale"),
    "hotspots": ("timetabling_ga_tpu_torch.obs.prof", "main_hotspots"),
    "profile": ("timetabling_ga_tpu_torch.obs.cost", "main_profile"),
    # the fleet gateway and the submit client (timetabling_ga_tpu/
    # cli.py:142-151): HTTP only, no torch in this process
    "fleet": ("timetabling_ga_tpu_torch.fleet.gateway", "main_fleet"),
    "submit": ("timetabling_ga_tpu_torch.fleet.client", "main_submit"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in TORCH_FREE:
        import importlib
        mod, fn = TORCH_FREE[argv[0]]
        return getattr(importlib.import_module(mod), fn)(argv[1:])
    from timetabling_ga_tpu_torch.runtime.config import parse_args
    if argv and argv[0] == "serve":
        from timetabling_ga_tpu_torch.serve.service import main_serve
        return main_serve(argv[1:])
    cfg = parse_args(argv)
    from timetabling_ga_tpu_torch.runtime import control_channel
    from timetabling_ga_tpu_torch.runtime.engine import run
    try:
        run(cfg)
    except control_channel.PeerLost as e:
        # a peer process died mid-run: the abort faultEntry and the
        # final checkpoint are already durable (the engine flushes
        # before re-raising). The dead peer's collective never
        # completes, so no teardown can be clean: a hard exit is the
        # only exit (JAX cli.py:177-190)
        import os
        print(f"tt: aborting run: {e}", file=sys.stderr)
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(70)    # EX_SOFTWARE: abnormal, deliberate
    return 0


if __name__ == "__main__":
    sys.exit(main())
