"""One leg of an A/B of chip_smoke's end-to-end paths on the card.

    python3 <this file> <label> [path ...]

Run from the root of the tree to measure (the file may belong to another
tree: it imports `chip_smoke` and the port from the current directory).
It builds that tree's kernels, drives each named path of chip_smoke.py's
PATHS (default: all five) through its `run_path`, checks each stream
with its `check_stream`, and prints one JSON line: the label and each
path's generations per second (lahc: steps per second). To compare two
commits on one card, unpack the parent with `git archive` into a
directory that .gitignore lists and run, in one call, parent, change,
change, parent (then the mirrored order in another).
"""

import json
import os
import sys


def main(argv) -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.problem import load_tim_file
    label, names = argv[0], argv[1:] or list(cs.PATHS)
    kernels.build()
    pa_cpu = {tim: load_tim_file(tim).device_arrays("cpu")
              for tim in (cs.TIM, cs.TIM05)}
    out = {}
    for name in names:
        recs, _, _ = cs.run_path(name)
        s = cs.check_stream(recs, pa_cpu[cs.PATH_TIM.get(name, cs.TIM)])
        out[name] = (s["lahc_steps"] / s["lahc_seconds"] if s["lahc_steps"]
                     else s["gens_per_s"])
    print(json.dumps({"leg": label, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
