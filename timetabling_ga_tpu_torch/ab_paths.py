"""One leg of an A/B of chip_smoke's end-to-end paths on the card.

    python3 <this file> <label> [path ...]

Run from the root of the tree to measure (the file may belong to another
tree: it imports `chip_smoke` and the port from the current directory).
It builds that tree's kernels, drives each named path of chip_smoke.py's
PATHS (default: all five) through its `run_path`, checks each stream
with its `check_stream`, and prints one JSON line: the label, each
path's generations per second (lahc: steps per second) and, under
"best", each path's reported best at its budget. The name `k10` times
the LAHC call instead, through the tree's `lahc.lahc_steps_kernel` (every
kernel it launches) at the lahc path's shape on comp01s (4 walkers, K
16, a history of 5,000, from chip_smoke's feasible start): us a step
over 200-step and 2,000-step calls, and over 200-step calls of one
walker (the chain's floor). The name `k5` times one K5 sweep pass the
same way, through the tree's `sweep.sweep_pass_kernel`, at the main
path's repair (16 rows) and post (4 rows) shapes from chip_smoke's
feasible start: ms a pass. The name `ptxas` prints the compiler's
register and spill report (with each entry function's name) of K1, K2,
K5, K6, K8, K9, K10 and K12 from the tree's build. To
compare two commits on one card, unpack
the parent with `git archive` into a directory that .gitignore lists
and run, in one call, parent, change, change, parent (then the mirrored
order in another).
"""

import json
import os
import sys


def k10_us_per_step(cs) -> dict:
    import torch
    from timetabling_ga_tpu_torch.ops import lahc
    from timetabling_ga_tpu_torch.problem import load_tim_file
    from timetabling_ga_tpu_torch.runtime import config, engine
    dev = torch.device("cuda", 0)
    pa = load_tim_file(cs.TIM).device_arrays(dev)
    cfg = config.parse_args(["-i", cs.TIM] + cs.PATHS["lahc"]
                            ).apply_tuned_defaults(pa.n_events)
    post = engine.build_post_config(cfg, engine.build_ga_config(cfg))
    K, Lh = cfg.post_lahc_k, cfg.post_lahc
    out = {}
    for walkers, n in ((post.pop_size, 200), (post.pop_size, 2000),
                       (1, 200)):
        g = torch.Generator(device=dev).manual_seed(9000 + walkers + n)
        w = cs.witness_state(pa, walkers, g)
        draws = lahc.make_lahc_draws([g], walkers, n, K, pa.n_events,
                                     pa.n_slots, post.p1, post.p2, post.p3,
                                     dev)
        state = lahc.init_lahc(pa, w.slots, w.rooms, Lh)
        ms = cs.time_ms(lambda: lahc.lahc_steps_kernel(pa, draws, state),
                        20)
        out[f"us_per_step_{walkers}x{n}"] = ms * 1e3 / n
    return out


def k5_ms(cs) -> dict:
    import torch
    from timetabling_ga_tpu_torch.ops import ga, sweep
    from timetabling_ga_tpu_torch.problem import load_tim_file
    from timetabling_ga_tpu_torch.runtime import config, engine
    dev = torch.device("cuda", 0)
    pa = load_tim_file(cs.TIM).device_arrays(dev)
    cfg = config.parse_args(["-i", cs.TIM] + cs.PATHS["main"]
                            ).apply_tuned_defaults(pa.n_events)
    repair = engine.build_ga_config(cfg)
    post = engine.build_post_config(cfg, repair)
    out = {}
    for phase, gacfg, P in (("repair", repair, 16), ("post", post, 4)):
        g = torch.Generator(device=dev).manual_seed(9100 + P)
        st = cs.witness_state(pa, P, g)
        draws = ga.sweep_draws_fn([g], P, pa, gacfg)(0)
        case = (gacfg.ls_swap_block, gacfg.ls_block_events,
                gacfg.ls_sideways, gacfg.ls_hot_k, gacfg.p3)
        out[f"ms_{phase}_{P}"] = cs.time_ms(
            lambda: sweep.sweep_pass_kernel(pa, draws, st, *case), 20)
    return out


def ptxas_lines() -> dict:
    from timetabling_ga_tpu_torch import kernels
    out = {}
    for name, text in kernels.BUILD_INFO["ptxas"].items():
        if name in ("sweep_pass", "random_ls", "lahc", "full_eval_ls",
                    "breed", "assign_rooms", "parallel_rooms",
                    "batch_penalty"):
            out[name] = [x.strip() for x in text.splitlines()
                         if "registers" in x or "spill" in x
                         or "entry function" in x]
    return out


def main(argv) -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.problem import load_tim_file
    label, names = argv[0], argv[1:] or list(cs.PATHS)
    kernels.build()
    pa_cpu = {tim: load_tim_file(tim).device_arrays("cpu")
              for tim in (cs.TIM, cs.TIM05)}
    out, best = {}, {}
    for name in names:
        if name in ("k10", "k5", "ptxas"):
            out[name] = {"k10": lambda: k10_us_per_step(cs),
                         "k5": lambda: k5_ms(cs),
                         "ptxas": ptxas_lines}[name]()
            continue
        recs, _, _ = cs.run_path(name)
        s = cs.check_stream(recs, pa_cpu[cs.PATH_TIM.get(name, cs.TIM)])
        out[name] = (s["lahc_steps"] / s["lahc_seconds"] if s["lahc_steps"]
                     else s["gens_per_s"])
        best[name] = s["final_best"]
    print(json.dumps({"leg": label, **out, "best": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
