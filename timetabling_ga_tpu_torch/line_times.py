"""Where a long script's seconds go: copy stdin to stdout, and write
each line's arrival (seconds since start) with its first 100 characters
to the file named by the first argument; the total goes to stderr.

    PYTHONUNBUFFERED=1 python3 chip_smoke.py \\
        | python3 -m timetabling_ga_tpu_torch.line_times smoke.ts > smoke.txt

Two trees on one card, in one call (the parent unpacked with `git
archive` into a directory that .gitignore lists, as ab_paths.py says):
run chip_smoke.py in each in turn through this filter, then set the
time stamps of the lines both print side by side. A phase's seconds
are the gap between the line before it and its own.
"""

import sys
import time


def main(argv) -> int:
    t0 = time.monotonic()
    with open(argv[0], "w") as ts:
        for line in sys.stdin:
            sys.stdout.write(line)
            sys.stdout.flush()
            ts.write(f"{time.monotonic() - t0:.3f}\t"
                     f"{line[:100].rstrip()}\n")
            ts.flush()
    print(f"{time.monotonic() - t0:.3f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
