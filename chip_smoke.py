#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi) and builds the
   CUDA kernels from timetabling_ga_tpu_torch/csrc (build time printed);
2. holds every kernel of the main path against its plain PyTorch version
   on the card, at the main path's shapes on fixtures/comp01s.tim
   (P = 16 and P = 256 individuals): exact equality of every output,
   then times both with CUDA events after a warm-up;
3. drives the main path — `timetabling_ga_tpu_torch.cli` on comp01s,
   seed 42, size-tuned defaults, bounded by -t and --generations — with
   the launch counters zeroed just before, and checks a protocol-valid
   stream (per-island best non-increasing, solution and runEntry
   records), that every kernel launched, and that a feasible reported
   timetable re-scores to its reported best;
4. prints one line per kernel, the {"kernels": [...]} summary and, last,
   {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line. Without a CUDA
device, or without the repository beside it, it exits non-zero at once.
Outputs go under build/chip_smoke/.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIM = os.path.join(HERE, "fixtures", "comp01s.tim")
WITNESS = os.path.join(HERE, "fixtures", "comp01s.witness.json")
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")
# the main path's budget: short enough that the whole script stays well
# inside its time limit, long enough to reach the post-feasibility phase
MAIN_ARGS = ["-s", "42", "-t", "90", "--generations", "400", "--trace"]
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and the
# non-tensor-core rate the integer/float32 ALU work of these kernels uses
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
KERNELS = {
    "assign_rooms": ("timetabling_ga_tpu_torch/csrc/assign_rooms.cu",
                     "timetabling_ga_tpu/ops/rooms.py:108"),
    "batch_penalty": ("timetabling_ga_tpu_torch/csrc/batch_penalty.cu",
                      "timetabling_ga_tpu/ops/fitness.py:235"),
    "move1_sweep": ("timetabling_ga_tpu_torch/csrc/move1_sweep.cu",
                    "timetabling_ga_tpu/ops/sweep.py:78"),
    "delta_one": ("timetabling_ga_tpu_torch/csrc/delta_one.cu",
                  "timetabling_ga_tpu/ops/delta.py:90"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_cases(pa, P, dev):
    """For each kernel: (kernel call, plain call, bytes moved, ops) at
    the main path's shapes with P individuals."""
    import torch
    from timetabling_ga_tpu_torch.ops import delta, fitness, rooms, sweep
    g = torch.Generator(device=dev).manual_seed(1000 + P)
    E, R, T, S = pa.n_events, pa.n_rooms, pa.n_slots, pa.n_students
    W = pa.conflict_bits.shape[1]
    nnz = pa.ev_stu.numel()
    slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                          dtype=torch.int32)
    rms = rooms.assign_rooms_plain(pa, slots)
    st = delta.init_state(pa, slots, rms)
    # Move1 pivots: one per individual per step (block_events 1)
    piv = torch.randint(0, E, (P, 1), generator=g, device=dev,
                        dtype=torch.int32)
    # Move2 candidates: the pivot against 8 partners (ls_swap_block 8)
    q = torch.randint(0, E, (P, 8), generator=g, device=dev,
                      dtype=torch.int32)
    e = piv.expand(P, 8)
    pad = sweep._distinct_pad(e, q, E)
    evs = torch.stack([e, q, pad], -1).contiguous()
    ns = torch.stack([slots.gather(1, q.long()), slots.gather(1, e.long()),
                      slots.gather(1, pad.long())], -1).contiguous()
    act = torch.tensor([True, True, False], device=dev).expand(
        P, 8, 3).contiguous()
    C = 8
    prob = nbytes(pa.possible_u8, pa.live, pa.cap_rank, pa.dead)
    rows = nbytes(slots, rms)
    return {
        "assign_rooms": (
            lambda: rooms.assign_rooms(pa, slots),
            lambda: rooms.assign_rooms_plain(pa, slots),
            nbytes(slots, pa.room_order) + prob + nbytes(slots),
            P * E * R * 8),
        "batch_penalty": (
            lambda: fitness.batch_penalty(pa, slots, rms),
            lambda: fitness.batch_penalty_plain(pa, slots, rms),
            rows + prob + nbytes(pa.student_count, pa.conflict_bits,
                                 pa.stu_ptr, pa.stu_ev, pa.anchor_slots,
                                 pa.anchor_w) + 3 * P * 4,
            P * (E * W * 3 + nnz * 2 + S * pa.n_days * 8 + E * 12)),
        "move1_sweep": (
            lambda: sweep.move1_sweep(pa, st.slots, st.rooms, st.att,
                                      st.occ, piv),
            lambda: sweep.move1_sweep_plain(pa, st.slots, st.rooms, st.att,
                                            st.occ, piv),
            rows + nbytes(st.att, st.occ, piv) + prob
            + nbytes(pa.student_count, pa.conflict_bits, pa.ev_ptr,
                     pa.ev_stu) + 3 * P * T * 4,
            P * (T * R * 8 + W * 32 + pa.max_ev_students * T * 14)),
        "delta_one": (
            lambda: delta.delta_one(pa, st.slots, st.rooms, st.att, st.occ,
                                    evs, ns, act),
            lambda: delta.delta_one_plain(pa, st.slots, st.rooms, st.att,
                                          st.occ, evs, ns, act),
            rows + nbytes(st.att, st.occ, evs, ns, act) + prob
            + nbytes(pa.student_count, pa.conflict_bits, pa.attends_u8,
                     pa.ev_ptr, pa.ev_stu) + P * C * 5 * 4,
            P * C * (3 * R * 10 + 3 * W * 32 + 18 * pa.max_ev_students
                     * pa.slots_per_day * 6)),
    }


def compare(pa, dev):
    """Every kernel against its plain version at P = 16 and 256."""
    import torch
    out = {}
    for P in (16, 256):
        for name, (kern, plain, nb, ops) in kernel_cases(pa, P, dev).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = 0
            for gt, wt in zip(got, want):
                check(gt.shape == wt.shape and gt.dtype == wt.dtype,
                      f"{name} P={P}: kernel output {tuple(gt.shape)} "
                      f"{gt.dtype} vs plain {tuple(wt.shape)} {wt.dtype}")
                err = max(err, int((gt.long() - wt.long()).abs().max()))
            check(err == 0, f"{name} P={P}: kernel differs from its plain "
                            f"version (max abs err {err})")
            reps = 50
            ms = time_ms(kern, reps)
            plain_ms = time_ms(plain, 5)
            bytes_ms = nb / PEAK_BYTES_S * 1e3
            ops_ms = ops / PEAK_OPS_S * 1e3
            out[(name, P)] = dict(
                ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return out


def profile_phases(pa, dev):
    """A short torch.profiler window per phase config: one warm repair
    generation (pop 16) and one warm post-phase sweep pass (pop 4). For
    each: wall time, device time summed over CUDA events, the device's
    idle share, device launches per sweep step and the kernels taking
    the most device time. Full tables go to build/chip_smoke/."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.ops import delta, ga, sweep
    from timetabling_ga_tpu_torch.parallel import islands
    from timetabling_ga_tpu_torch.runtime import config, engine
    cfg = config.parse_args(["-i", TIM]).apply_tuned_defaults(pa.n_events)
    repair = engine.build_ga_config(cfg)
    post = engine.build_post_config(cfg, repair)
    out = []
    for name, gacfg in (("repair", repair), ("post", post)):
        gens = engine.island_generators(dev, 7, 0, 1)
        st = islands.init_island_population(pa, gens, gacfg.pop_size)
        if name == "repair":
            def work(st=st, gens=gens, gacfg=gacfg):
                return islands.run_epochs(pa, gens, st, gacfg, 1, 1)
        else:
            ls = delta.init_state(pa, st.slots, st.rooms)
            draws_fn = ga.sweep_draws_fn(gens, gacfg.pop_size, pa, gacfg)

            def work(ls=ls, draws_fn=draws_fn, gacfg=gacfg):
                return sweep.sweep_pass(
                    pa, draws_fn(0), ls, gacfg.ls_swap_block,
                    gacfg.ls_block_events, gacfg.ls_sideways,
                    gacfg.ls_hot_k, gacfg.p3)
        work()                                              # warm-up
        torch.cuda.synchronize()
        steps0 = kernels.LAUNCHES["move1_sweep"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            work()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        steps = kernels.LAUNCHES["move1_sweep"] - steps0
        averages = prof.key_averages()
        rows = []
        for ev in averages:
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            rows.append((dev_us, ev.count, ev.key[:60]))
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows) / 1e3
        launches = sum(r[1] for r in rows)
        with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
            f.write(averages.table(sort_by="self_cpu_time_total",
                                   row_limit=40))
        out.append({"config": name, "pop": gacfg.pop_size,
                    "window": ("one generation" if name == "repair"
                               else "one sweep pass"),
                    "sweep_steps": steps, "wall_ms": wall_ms,
                    "device_ms": device_ms,
                    "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
                    "device_launches": launches,
                    "launches_per_step": launches / max(steps, 1),
                    "wall_ms_per_step": wall_ms / max(steps, 1),
                    "top": [[k, c, us / 1e3] for us, c, k in rows[:8]]})
    return out


def main_path():
    """Run the CLI on comp01s; return (records, seconds)."""
    from timetabling_ga_tpu_torch import cli, kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "comp01s_s42.jsonl")
    kernels.reset_launches()
    t0 = time.monotonic()
    rc = cli.main(["-i", TIM, "-o", path] + MAIN_ARGS)
    seconds = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    check(rc == 0, f"cli exited {rc}")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return records, seconds, launches


def check_stream(records, pa_cpu):
    """Protocol checks; returns the summary numbers."""
    import torch
    from timetabling_ga_tpu_torch.ops import fitness
    kinds = {"logEntry", "solution", "runEntry", "phase"}
    for rec in records:
        check(len(rec) == 1 and next(iter(rec)) in kinds,
              f"unexpected record {rec}")
    logs = [r["logEntry"] for r in records if "logEntry" in r]
    check(logs, "no logEntry records")
    for proc in {x["procID"] for x in logs}:
        b = [x["best"] for x in logs if x["procID"] == proc]
        check(all(x >= y for x, y in zip(b, b[1:])),
              f"island {proc}: best went up {b}")
    sols = [r["solution"] for r in records if "solution" in r]
    runs = [r["runEntry"] for r in records if "runEntry" in r]
    check(sols, "no solution record")
    check(len(runs) == 2 and "procsNum" in runs[1], "runEntry records")
    best = runs[0]["totalBest"]
    check(best == min(s["totalBest"] for s in sols), "runEntry best")
    for s in sols:
        if s["feasible"]:
            sl = torch.tensor([s["timeslots"]], dtype=torch.int32)
            rm = torch.tensor([s["rooms"]], dtype=torch.int32)
            _, hcv, scv = fitness.batch_penalty_plain(pa_cpu, sl, rm)
            check(int(hcv[0]) == 0 and int(scv[0]) == s["totalBest"],
                  "reported timetable does not re-score to its best")
    phases = [r["phase"] for r in records if "phase" in r]
    disp = [p for p in phases if p["name"] == "dispatch"]
    gens = sum(p["gens"] for p in disp)
    secs = sum(p["seconds"] for p in disp)
    feas = [x["time"] for x in logs if x["best"] < 1_000_000]
    return dict(
        generations=gens,
        gens_per_s=(gens / secs) if secs > 0 else None,
        time_to_feasible_s=min(feas) if feas else None,
        best_hcv=None if feas else min(x["best"] for x in logs) // 1_000_000,
        final_best=best, feasible=runs[0]["feasible"])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from timetabling_ga_tpu_torch import kernels
        from timetabling_ga_tpu_torch.ops import fitness
        from timetabling_ga_tpu_torch.problem import load_tim_file
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build_s = kernels.build()
    print(json.dumps({"build_seconds": round(build_s, 3)}))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in kernels.BUILD_INFO["ptxas"].items():
            f.write(f"== {name}\n{text}\n")

    problem = load_tim_file(TIM)
    pa = problem.device_arrays(dev)
    # a small-input reference: the planted witness scores (0, 0) on K2
    with open(WITNESS) as f:
        w = json.load(f)
    pen, hcv, scv = fitness.batch_penalty(
        pa, torch.tensor([w["slots"]], dtype=torch.int32, device=dev),
        torch.tensor([w["rooms"]], dtype=torch.int32, device=dev))
    check((int(pen[0]), int(hcv[0]), int(scv[0])) == (0, 0, 0),
          "witness does not score (0, 0)")

    timings = compare(pa, dev)
    records, seconds, launches = main_path()
    summary = check_stream(records, problem.device_arrays("cpu"))
    summary["wall_s"] = round(seconds, 3)
    print(json.dumps({"main_path": summary}))
    for prof in profile_phases(pa, dev):
        print(json.dumps({"profile": prof}))
    for name in KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the main path")
        for P in (16, 256):
            t = timings[(name, P)]
            print(json.dumps({"kernel": name, "P": P, "ms": t["ms"],
                              "plain_ms": t["plain_ms"],
                              "launches": launches[name]}))
    rows = []
    for name, (src, replaces) in KERNELS.items():
        t = timings[(name, 16)]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
