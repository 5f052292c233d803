"""Where one K5 sweep pass, one K8 local search or its pre-pass, one K12
full-evaluation search, one K10 LAHC launch, one K2 evaluation, one K7
truncation or migration, one K11 ranking or replacement and one parallel
room matching spend their time, on the card.

    python -m timetabling_ga_tpu_torch.k5_phases [k5] [k8] [k8e] [k12] \
        [k10] [k2] [k7] [k11] [k9] [k11big]

(no argument: all but k11big). Builds csrc/sweep_pass.cu, csrc/random_ls.cu,
csrc/full_eval_ls.cu, csrc/lahc.cu, csrc/batch_penalty.cu,
csrc/survivors.cu, csrc/nsga.cu, csrc/parallel_rooms.cu and csrc/breed.cu
once more with
their phase counters compiled in (-DTT_K5_PROF: block 0's
thread 0 reads clock64() at each phase boundary, csrc/common.cuh), under
build/torch_kernels/k5_phases/, and checks that each instrumented kernel
equals the regular one exactly. It prints one JSON line per shape with
each phase's share of that thread's cycles and its cycles per step (K5),
per round (K8, K12) or per launch (K8's pre-pass, K2, K7):

- K5 at the main path's three sweep shapes on fixtures/comp01s.tim —
  the engine's repair pass at P = 16 and 256 individuals, its post pass
  at P = 4 — each at the cluster size K5's wrapper takes there; the
  thread is rank 0 of cluster 0, and "cluster reduction" is its wait at
  the cluster barrier and the read of the other CTAs' records;
- K8 at the reference path's shape (`--no-auto-tune -p 2`: P = 10
  individuals, 125 rounds of 8 candidates) from random starts; the
  thread is warp 0's lane 0, which scores candidate 0 of every round;
- K8's pre-pass (`k8e`) at the same shape (10,000 draw rows of 400
  uniforms), the mean of 20 launches; the thread is warp 0's lane 0,
  which takes the first two rows (load: until the first loaded float
  arrives; local top 3; the warp merge; the store);
- K12 at the full-eval path's shape (`--no-auto-tune -p 1
  --ls-full-eval`: P = 10 individuals, 25 rounds of 8 candidates, a
  cluster of 8 CTAs each) from random starts; the thread is rank 0 of
  cluster 0, which evaluates candidate 0 of every round;
- K10 at the lahc path's shape (`--post-lahc 5000`: 4 walkers, K 16
  candidates, a history of 5,000) and on one walker, 1,000 steps from
  feasible starts (the planted witness with its slots relabelled by a
  random permutation a walker: no hard violation, a few hundred soft
  ones, so the walk accepts sideways and uphill moves as the path's
  does); the thread is block 0's warp 0 lane 0, which scores candidate
  0 of every step; beside the counters, the device time of one launch;
- K2 on random comp01s rows at P = 4, 16 and 256, the mean of 20
  launches, at the cluster size its wrapper takes; the thread is rank
  0 of cluster 0;
- K7's survivors (parents + children of one island, the main path's pop
  16 and the reference path's pop 10; 16 islands of 16) and its migrate
  entry (one island of 16, 16 of 16), the mean of 20 launches; the
  thread is block 0's, which copies output rows 0 and 1;
- K11's nsga_rank (one island of the nsga path's pop 16 and 4 parents,
  and of 64, whose dominator sets take two words) and nsga_survivors
  (those parents and as many children) on comp05s rows from random
  slots, the mean of 20 launches; the thread is block 0's;
- `k11big`, only when named: K11's device time alone (no counters) on
  islands of 512 parents (survivors of 1,024 rows, the dominator words
  still in shared memory), 700 and 1,400 (ranks of 1,400 rows and
  survivors of 1,400 and 2,800, too many for them) and 16;
- the parallel room matcher at the nsga path's shape (comp05s, 16
  children): K9's own launch from best-fit rooms, and K6 breeding
  under --nsga2 --rooms-mode parallel with crossover on for every
  child, the mean of 20 launches; the thread is block 0's thread 0.

The first line is the card's name and power limit. Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import delta, rooms, sweep
from timetabling_ga_tpu_torch.problem import load_tim_file
from timetabling_ga_tpu_torch.runtime import config, engine

COMP01S = Path(__file__).resolve().parent.parent / "fixtures" / "comp01s.tim"
COMP05S = COMP01S.with_name("comp05s.tim")
# counter k of csrc/sweep_pass.cu / sweep_dev.cuh TT_PROF(k)
PHASES = ("move1", "k4 occupancy + room argmins",
          "k4 unsuitable + conflict dots", "k4 day re-score",
          "candidate store", "wait for the other warps",
          "reduction 1 (lex min)", "reduction 2 + choice", "apply",
          "prologue (load + pivots)", "epilogue", "cluster reduction")
# counter k of csrc/random_ls.cu (1-3 are the K4 body's, as in K5)
K8_PHASES = ("events (draw read + top-3 + sample_move)",
             "k4 occupancy + room argmins",
             "k4 unsuitable + conflict dots", "k4 day re-score",
             "candidate store", "wait for the other warps",
             "events chunk load", "choice", "apply",
             "prologue (load + att/occ/bitsets)",
             "epilogue (rows + live-event words)",
             "epilogue evaluation (the full penalty)")


# counter k of csrc/batch_penalty.cu
K2_PHASES = ("prologue (row + CSR slice load, zero)",
             "occupancy + slot bitsets (atomics)",
             "room pairs + events", "correlation words",
             "students (staged CSR)", "wait for the other threads",
             "one block reduction",
             "store into rank 0's inbox (CS 1: epilogue)",
             "cluster barrier", "rank 0's sum + write")
# counter k of csrc/survivors.cu
K7_PHASES = ("prologue (the island's keys)", "rank count + barrier",
             "row copy (penalty terms, slots and rooms)",
             "wait for the other threads")
# counters 12-15 of csrc/random_ls.cu (the pre-pass)
K8E_PHASES = ("load", "local top-3", "warp merge", "store")
# counter k of csrc/full_eval_ls.cu
K12_PHASES = ("prologue (row, conflict bitset + CSR staged, occupancy, "
              "cluster sync)", "draws chunk load", "candidate copy",
              "relocate (warp 0) + barrier", "cells + events",
              "correlation words", "students (staged CSR)",
              "wait for the other threads", "block reduction + record",
              "cluster exchange (record stores + cluster barrier)",
              "choice", "apply", "epilogue")
# counter k of csrc/nsga.cu
K11_PHASES = ("load", "dominator words", "peel", "crowding",
              "crowded order + kept order", "row copy", "store")
# counter k of the parallel matcher (csrc/rooms_dev.cuh), around it in
# csrc/parallel_rooms.cu and csrc/breed.cu
K9_PHASES = ("before the matcher (K9: row load + best-fit rooms; K6: "
             "tournaments + crossover + best-fit rooms)",
             "start (one warp: the incoming owner grid; a warp a slot: "
             "the events bucketed by slot)",
             "owners + augment rounds", "park + result",
             "after (K9: store; K6: occupancy)")
# counter k of csrc/lahc.cu (1-3 are the K4 body's, as in K5)
K10_PHASES = ("events (the top 3 of the uniforms, or the staged chunk's)",
              "k4 occupancy + room argmins",
              "k4 unsuitable + conflict dots", "k4 day re-score",
              "candidate store", "wait for the other warps",
              "draws chunk (wait, barrier, the next chunk's copies)",
              "choice and acceptance", "apply",
              "prologue (load + bitsets)", "epilogue", "history entry",
              "move type and target (+ sample_move)", "best copy",
              "second barrier (the thread-0 choice's)")
K10_STEPS = 1000
REPS = 20
SINGULAR = {"steps": "step", "rounds": "round", "launches": "launch"}


def build_prof(source: str):
    """The library of csrc/<source>.cu with the phase counters compiled
    in, as kernels.load loads the regular one: {entry point: (library,
    function)}."""
    out = kernels.BUILD_DIR / "k5_phases"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{source}-prof.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DTT_K5_PROF", "-o",
         str(path), str(kernels.CSRC / f"{source}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"k5_phases: {source} does not build:\n"
                           f"{proc.stdout}")
    return {n: kernels.load(n, path) for n in kernels.SOURCES[source]}


class _Counters:
    """tt_prof_take of one instrumented library."""

    def __init__(self, lib):
        self.buf = (ctypes.c_ulonglong * 16)()
        self.take_fn = lib.tt_prof_take
        self.take_fn.argtypes = [ctypes.c_void_p]
        self.take_fn.restype = ctypes.c_int

    def take(self, n: int) -> list:
        if self.take_fn(ctypes.addressof(self.buf)) != 0:
            raise RuntimeError("k5_phases: reading the counters failed")
        return [int(self.buf[k]) for k in range(n)]


def _instrumented(source: str, prof: dict, run):
    """(regular result, instrumented result, cycles per counter) of
    `run()` with csrc/<source>.cu's entry points swapped for `prof`."""
    regular = {n: kernels._LIBS[n] for n in prof}
    counters = _Counters(next(iter(prof.values()))[0])
    try:
        want = run()
        counters.take(16)
        kernels._LIBS.update(prof)
        got = run()
        torch.cuda.synchronize()
        return want, got, counters.take(16)
    finally:
        kernels._LIBS.update(regular)


def _line(shape, steps, unit, names, cyc, **extra):
    total = sum(cyc[:len(names)])
    return json.dumps({
        "shape": shape, unit: steps, **extra, "thread_cycles": total,
        "share": {n: c / total for n, c in zip(names, cyc)},
        f"cycles_per_{SINGULAR[unit]}": {n: c / steps
                                         for n, c in zip(names, cyc)}})


def k5_lines(pa, dev):
    cfg = config.parse_args(["-i", str(COMP01S)]).apply_tuned_defaults(
        pa.n_events)
    repair = engine.build_ga_config(cfg)
    post = engine.build_post_config(cfg, repair)
    E, T = pa.n_events, pa.n_slots
    prof = build_prof("sweep_pass")
    for phase, P, gc in (("repair", 16, repair), ("repair", 256, repair),
                         ("post", post.pop_size, post)):
        args = (gc.ls_swap_block, gc.ls_block_events, gc.ls_sideways,
                gc.ls_hot_k, gc.p3)
        sh = sweep.sweep_shape(E, T, gc.ls_swap_block, gc.ls_block_events,
                               gc.ls_hot_k, gc.p3)
        g = torch.Generator(device=dev).manual_seed(3000 + P)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        st = delta.init_state(pa, slots, rooms.assign_rooms_plain(pa, slots))
        draws = sweep.make_sweep_draws([g], P, sh, E, gc.ls_sideways, dev)
        cs = sweep.auto_cluster(pa, sh, P, dev)
        want, got, cyc = _instrumented("sweep_pass", prof, lambda: (
            sweep.sweep_pass_kernel(pa, draws, st, *args, cluster=cs)))
        if not all(torch.equal(w, x) for w, x in zip(
                (*want[0], *want[1:]), (*got[0], *got[1:]))):
            raise RuntimeError(f"k5_phases: the instrumented K5 differs "
                               f"from K5 ({phase}, P={P})")
        yield _line(["K5", phase, P], sh.n_steps, "steps", PHASES, cyc,
                    cluster=cs)


def k8_lines(pa, dev):
    gc, rows, draws = _reference_draws(pa, dev, ["-p", "2"], 5000)
    prof = build_prof("random_ls")
    want, got, cyc = _instrumented("random_ls", prof, lambda: (
        delta.random_local_search_kernel(pa, draws, rows)))
    if not all(torch.equal(w, x) for w, x in zip(want, got)):
        raise RuntimeError("k5_phases: the instrumented K8 differs from K8")
    yield _line(["K8", "reference", gc.pop_size], gc.ls_steps, "rounds",
                K8_PHASES, cyc, candidates=gc.ls_candidates)


def _reference_draws(pa, dev, flags, seed):
    """(GA config, random rows, LSDraws) at the CLI shape of `flags`."""
    gc = engine.build_ga_config(config.parse_args(
        ["-i", str(COMP01S), "--no-auto-tune"] + flags))
    E, T, P = pa.n_events, pa.n_slots, gc.pop_size
    g = torch.Generator(device=dev).manual_seed(seed + P)
    slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                          dtype=torch.int32)
    rows = delta.init_rows(pa, slots, rooms.assign_rooms_plain(pa, slots))
    draws = delta.make_ls_draws([g], P, gc.ls_steps, gc.ls_candidates, E, T,
                                gc.p1, gc.p2, gc.p3, dev)
    return gc, rows, draws


def k8e_lines(pa, dev):
    gc, _, draws = _reference_draws(pa, dev, ["-p", "2"], 5000)
    prof = build_prof("random_ls")
    want, got, cyc = _instrumented("random_ls", prof, _repeated(
        lambda: delta.random_ls_events_kernel(draws)))
    if not torch.equal(want, got):
        raise RuntimeError("k5_phases: the instrumented pre-pass differs "
                           "from K8's pre-pass")
    yield _line(["K8 pre-pass", "reference", gc.pop_size], REPS, "launches",
                K8E_PHASES, cyc[12:16],
                rows=gc.ls_steps * gc.ls_candidates * gc.pop_size)


def k12_lines(pa, dev):
    from timetabling_ga_tpu_torch.ops import local_search
    gc, rows, draws = _reference_draws(pa, dev, ["-p", "1",
                                                 "--ls-full-eval"], 5100)
    prof = build_prof("full_eval_ls")
    want, got, cyc = _instrumented("full_eval_ls", prof, lambda: (
        local_search.batch_local_search_kernel(pa, draws, rows)))
    if not _equal(want, got):
        raise RuntimeError("k5_phases: the instrumented K12 differs from "
                           "K12")
    yield _line(["K12", "full-eval", gc.pop_size], gc.ls_steps, "rounds",
                K12_PHASES, cyc, candidates=gc.ls_candidates,
                cluster=local_search.full_eval_cluster(gc.ls_candidates))


def _feasible_rows(pa, n, g):
    """n feasible comp01s rows: the planted witness with its slots
    relabelled by a random permutation a row (a slot's events and rooms
    move together, so no hard constraint breaks)."""
    with open(COMP01S.with_name("comp01s.witness.json")) as f:
        w = json.load(f)
    dev = pa.conflict.device
    slots = torch.tensor(w["slots"], dtype=torch.int64, device=dev)
    perm = torch.stack([torch.randperm(pa.n_slots, generator=g, device=dev)
                        for _ in range(n)])
    rms = torch.tensor(w["rooms"], dtype=torch.int32, device=dev)
    return (perm[:, slots].to(torch.int32).contiguous(),
            rms.repeat(n, 1))


def k10_lines(pa, dev):
    from timetabling_ga_tpu_torch.ops import lahc
    cfg = config.parse_args(["-i", str(COMP01S), "--post-lahc", "5000"]
                            ).apply_tuned_defaults(pa.n_events)
    post = engine.build_post_config(cfg, engine.build_ga_config(cfg))
    K, Lh = cfg.post_lahc_k, cfg.post_lahc
    prof = build_prof("lahc")
    for walkers in (post.pop_size, 1):
        g = torch.Generator(device=dev).manual_seed(10000 + walkers)
        l0 = lahc.init_lahc(pa, *_feasible_rows(pa, walkers, g), Lh)
        if int(l0.ls.hcv.max()) != 0:
            raise RuntimeError("k5_phases: a relabelled witness is not "
                               "feasible")
        draws = lahc.make_lahc_draws([g], walkers, K10_STEPS, K,
                                     pa.n_events, pa.n_slots, post.p1,
                                     post.p2, post.p3, dev)

        def run():
            return lahc.lahc_steps_kernel(pa, draws, _lahc_copy(l0))
        want, got, cyc = _instrumented("lahc", prof, run)
        if not (_equal(want.ls, got.ls) and _equal(want[1:], got[1:])):
            raise RuntimeError("k5_phases: the instrumented K10 differs "
                               "from K10")
        yield _line(["K10", "lahc", walkers], K10_STEPS, "steps",
                    K10_PHASES, cyc, candidates=K, history=Lh,
                    start_scv=[int(x) for x in l0.ls.scv],
                    end_scv=[int(x) for x in want.ls.scv],
                    device_us=device_us_per_launch(run, "lahc", reps=5))


def _lahc_copy(state):
    """A copy of a LahcState, for K10 to update in place."""
    from timetabling_ga_tpu_torch.ops import lahc
    return lahc.LahcState(lahc.LSState(*(x.clone() for x in state.ls)),
                          *(x.clone() for x in state[1:]))


def device_us_per_launch(fn, kernel, reps=REPS, sessions=3):
    """Device time of one launch of `kernel` (the entry point its CUDA
    kernel's name gives, obs/prof.py kernel_entry: a templated instance
    too) over `reps` calls of `fn`, from torch.profiler; a session
    whose trace lacks the kernel (the profiler drops one now and then) is
    taken again, up to `sessions` times, then None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from timetabling_ga_tpu_torch.obs.prof import kernel_entry
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) == DeviceType.CUDA and \
                    kernel_entry(ev.key) == kernel and ev.count:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                return us / ev.count
    return None


def _repeated(fn):
    def run():
        for _ in range(REPS):
            out = fn()
        return out
    return run


def _equal(want, got):
    return all(torch.equal(w, x) for w, x in zip(want, got))


def k2_lines(pa, dev):
    from timetabling_ga_tpu_torch.ops import fitness
    E, T = pa.n_events, pa.n_slots
    prof = build_prof("batch_penalty")
    for P in (4, 16, 256):
        g = torch.Generator(device=dev).manual_seed(6000 + P)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        rms = rooms.assign_rooms_plain(pa, slots)
        want, got, cyc = _instrumented("batch_penalty", prof, _repeated(
            lambda: fitness.batch_penalty(pa, slots, rms)))
        if not _equal(want, got):
            raise RuntimeError(f"k5_phases: the instrumented K2 differs "
                               f"from K2 (P={P})")
        yield _line(["K2", P], REPS, "launches", K2_PHASES, cyc,
                    cluster=fitness.penalty_cluster(pa, P, dev))


def k7_lines(pa, dev):
    from timetabling_ga_tpu_torch.ops import ga
    from timetabling_ga_tpu_torch.parallel import islands
    E, T = pa.n_events, pa.n_slots
    prof = build_prof("survivors")
    g = torch.Generator(device=dev).manual_seed(7000)

    def state(n):
        slots = torch.randint(0, T, (n, E), generator=g, device=dev,
                              dtype=torch.int32)
        ps = torch.randint(0, 3, (2, n), generator=g, device=dev,
                           dtype=torch.int32)
        return ga.PopState(slots, slots.flip(1), ps[0], ps[0] * 2, ps[1])

    for entry, L, pop in (("survivors", 1, 16), ("survivors", 1, 10),
                          ("survivors", 16, 16), ("migrate", 1, 16),
                          ("migrate", 16, 16)):
        par, ch = state(L * pop), state(L * pop)
        if entry == "survivors":
            fn = _repeated(lambda: ga.survivors(par, ch, L, pop))
        else:
            srt = ga.survivors_plain(par, groups=L)
            fn = _repeated(lambda: islands.migrate(srt, L))
        want, got, cyc = _instrumented("survivors", prof, fn)
        if not _equal(want, got):
            raise RuntimeError(f"k5_phases: the instrumented K7 differs "
                               f"from K7 ({entry}, L={L}, pop={pop})")
        yield _line(["K7", entry, L, pop], REPS, "launches", K7_PHASES, cyc,
                    E=E)


def _comp05s_rows(pa05, n, g):
    """n comp05s rows from random slots and their greedy rooms, scored."""
    from timetabling_ga_tpu_torch.ops import ga
    slots = torch.randint(0, pa05.n_slots, (n, pa05.n_events), generator=g,
                          device=pa05.device, dtype=torch.int32)
    return ga.evaluate(pa05, slots, rooms.assign_rooms_plain(pa05, slots))


def k11_lines(pa, dev):
    from timetabling_ga_tpu_torch.ops import nsga
    pa05 = load_tim_file(str(COMP05S)).device_arrays(dev)
    prof = build_prof("nsga")
    g = torch.Generator(device=dev).manual_seed(11000)
    for pop in (16, 4, 64):
        par, ch = _comp05s_rows(pa05, pop, g), _comp05s_rows(pa05, pop, g)
        for entry, fn in (
                ("nsga_rank", lambda: nsga.rank_crowd(par.hcv, par.scv)),
                ("nsga_survivors", lambda: nsga.survivors(par, ch, 1, pop))):
            want, got, cyc = _instrumented("nsga", prof, _repeated(fn))
            if not _equal(want, got):
                raise RuntimeError(f"k5_phases: the instrumented K11 "
                                   f"differs from K11 ({entry}, pop={pop})")
            fronts = int(nsga.rank_crowd_plain(
                *((par.hcv, par.scv) if entry == "nsga_rank" else
                  (torch.cat([par.hcv, ch.hcv]),
                   torch.cat([par.scv, ch.scv]))))[0].max()) + 1
            yield _line(["K11", entry, pop], REPS, "launches", K11_PHASES,
                        cyc, fronts=fronts, E=pa05.n_events,
                        device_us=device_us_per_launch(fn, entry))


def k11big_lines(pa, dev):
    """K11's two entries on islands of 512 parents (survivors of 1,024
    rows, whose dominator words still fit in shared memory), of 700 and
    1,400 (ranks of 1,400 rows and survivors of 1,400 and 2,800, too many
    for them) and, beside them, of the nsga path's 16: comp05s
    rows from random slots, device time only. No counters are compiled
    in, so a copy of this file laid over an older tree of the port
    times that tree's K11 the same way."""
    from timetabling_ga_tpu_torch.ops import nsga
    pa05 = load_tim_file(str(COMP05S)).device_arrays(dev)
    g = torch.Generator(device=dev).manual_seed(11500)
    for pop in (16, 512, 700, 1400):
        par, ch = _comp05s_rows(pa05, pop, g), _comp05s_rows(pa05, pop, g)
        for entry, fn, n, h, s in (
                ("nsga_rank", lambda: nsga.rank_crowd(par.hcv, par.scv),
                 pop, par.hcv, par.scv),
                ("nsga_survivors", lambda: nsga.survivors(par, ch, 1, pop),
                 2 * pop, torch.cat([par.hcv, ch.hcv]),
                 torch.cat([par.scv, ch.scv]))):
            fronts = int(nsga.rank_crowd_plain(h, s)[0].max()) + 1
            yield json.dumps({"shape": ["K11", entry, pop], "rows": n,
                              "fronts": fronts, "device_us":
                              device_us_per_launch(fn, entry)})


def k9_lines(pa, dev):
    from timetabling_ga_tpu_torch.ops import ga, nsga
    pa05 = load_tim_file(str(COMP05S)).device_arrays(dev)
    cfg = config.parse_args(["-i", str(COMP05S), "--nsga2", "--rooms-mode",
                             "parallel"]).apply_tuned_defaults(
                                 pa05.n_events)
    gc = engine.build_ga_config(cfg)
    pop = gc.pop_size
    g = torch.Generator(device=dev).manual_seed(9000)
    par = _comp05s_rows(pa05, pop, g)
    kids = _comp05s_rows(pa05, pop, g)
    prof = build_prof("parallel_rooms")

    def k9():
        return rooms.parallel_assign_rooms(pa05, kids.slots)
    want, got, cyc = _instrumented("parallel_rooms", prof, _repeated(k9))
    if not torch.equal(want, got):
        raise RuntimeError("k5_phases: the instrumented K9 differs from K9")
    yield _line(["K9", "parallel_assign_rooms", pop], REPS, "launches",
                K9_PHASES, cyc, E=pa05.n_events, rounds=ga.PARALLEL_ROUNDS,
                device_us=device_us_per_launch(k9, "parallel_rooms"))
    mo = nsga.rank_crowd(par.hcv, par.scv)
    bd = ga.make_breed_draws([g], pop, pa05.n_events, pa05.n_slots, gc, dev)
    bd = bd._replace(do_x=torch.ones_like(bd.do_x))
    prof = build_prof("breed")

    def k6():
        return ga.make_children(pa05, bd, par, gc, 1, mo)
    want, got, cyc = _instrumented("breed", prof, _repeated(k6))
    if not _equal(want, got):
        raise RuntimeError("k5_phases: the instrumented K6 differs from K6")
    yield _line(["K6", "nsga2+parallel", pop], REPS, "launches", K9_PHASES,
                cyc, E=pa05.n_events, rounds=ga.PARALLEL_ROUNDS,
                device_us=device_us_per_launch(k6, "breed"))


LINES = {"k5": k5_lines, "k8": k8_lines, "k8e": k8e_lines,
         "k12": k12_lines, "k10": k10_lines, "k2": k2_lines, "k7": k7_lines,
         "k11": k11_lines, "k9": k9_lines}
# run only when named
NAMED_ONLY = {"k11big": k11big_lines}


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build()
    pa = load_tim_file(str(COMP01S)).device_arrays(dev)
    for which in sys.argv[1:] or list(LINES):
        for line in {**LINES, **NAMED_ONLY}[which](pa, dev):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
