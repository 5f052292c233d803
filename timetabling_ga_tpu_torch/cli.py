"""Command-line entry point of the PyTorch port.

    python -m timetabling_ga_tpu_torch.cli -i fixtures/comp01s.tim -s 42

runs the size-tuned solve on the GPU (`--backend cpu` runs it on the
host) and writes the JSONL protocol to stdout or `-o <file>`. The flags
are the JAX CLI's (runtime/config.py); those not ported yet stop the
parse with a message that names them.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from timetabling_ga_tpu_torch.runtime.config import parse_args
    cfg = parse_args(argv)
    from timetabling_ga_tpu_torch.runtime.engine import run
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
