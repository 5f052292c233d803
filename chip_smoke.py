#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi) and builds the
   CUDA kernels from timetabling_ga_tpu_torch/csrc (build time printed);
2. holds every kernel against its plain PyTorch version on the card, at
   the paths' shapes on fixtures/comp01s.tim — exact equality of every
   output — then times both with CUDA events after a warm-up:
   K1-K4, K6 (breed, relocate), K7 (survivors, migrate) and K9 (the
   parallel room matcher) at P = 16 and P = 256 individuals (P = 256 as
   16 islands of 16), K2 also at P = 4 and at each of its cluster sizes
   (1, 2, 4, 8 CTAs a row and the wrapper's own choice), K9 also on a
   padded copy of comp01s, K1 and K6
   also on degenerate slot buckets (every event in one slot, two slots,
   half in one; on comp01s, its padded copy and comp01s cut to one
   room), K6 also in
   its crowded-tournament and parallel-matcher modes (the scores K6
   writes for its children and K8 for its rows also held against
   batch_penalty_plain of those rows), K7 also at L = 1, 2, 4 and 16
   islands of 2, 3 and 16 rows of E = 400 and 397 int32, K6's
   relocation entry also on the
   kick's chains (2 and 8 rows, 3 to 16 moves); K5 (the whole sweep
   pass) at the repair pass's P = 16 and 256 and the post pass's P = 4,
   and at the nsga path's repair (P = 16) and post (P = 4) passes on
   comp05s, each at every cluster size (1, 2, 4, 8 CTAs an individual and
   the wrapper's own choice; the cluster size, CTAs, ms a pass and us a
   step printed per shape);
   K8 (the random-candidate local search, -p 2: 125 rounds of 8) at P =
   10 and 256, its pre-pass also on tied uniforms (the chain timed on
   the pre-pass's events, each entry point on its own; the pre-pass also
   against torch.topk and the stable torch.sort, its library times);
   K12 (the full-evaluation search, -p 1: 25 rounds of 8, fed by K8's
   pre-pass) at P = 10 and 256 and at K = 12 > its 8 CTAs, from random
   and feasible starts, its terms also against batch_penalty_plain of
   its rows, and on one individual (its chain's floor); K10 (LAHC, fed
   by K8's pre-pass) at 4 and 64 walkers, K = 1 and 16 candidates,
   history 5 and 5000, also on tied uniforms and with a history of
   30,000 (its ring in global memory), timed as the pre-pass and K10,
   K10 alone and on one walker; K11
   (NSGA-II ranks and survivors) at island sizes 8, 20, 32, 33, 70, 512,
   700 and 1,400 with duplicate objectives (several dominator words, and
   islands too large for them); on fixtures/comp05s.tim
   at the nsga path's own shapes (its repair config, one island of 16,
   and its post config, 4 rows; random and feasible parents): K11 rank
   and survivors, K6 crowded + parallel with crossover on, off and
   mixed, and K9 on the children, also on rows with every event in one
   slot, K6, K9 and K11 timed at both pops; K5, K8
   and K10 from random starts and from feasible ones (the planted
   witness, a few events moved), and on one individual (their chains'
   floor); K13 (the trace compression of --trace-mode deltas|stats):
   compress_trace in both modes at L = 1, 4, 16 islands x T = 1, 8, 33,
   64, 200, 1000 generations x event caps below, equal to and above the
   improvement counts, on traces with planted ties, long runs of equal
   rows and sentinel rows (events and counts exact; moments: min and max
   exact, mean within a relative 1e-6, var within 4 T 2^-24 mean(rep^2)),
   and moment_rows on (L, n) rows the same way; K14 (the quality
   telemetry of --quality): quality_ops and div_stats at L = 1, 4, 16
   islands x pop 2, 3, 4, 10, 16 on comp01s and a padded copy
   (counters, min, max and the Hamming sample exact; moments: min and
   max exact, mean within a relative 1e-6 of the shifted mean plus one
   float32 spacing, var within 4 n 2^-24 mean(c^2), c the min-shifted
   values); K6 (both tournament modes) and K8's chain with a lane table
   (B13, the serve path: each block reads its lane's problem) on four
   mixed lanes of comp01s's bucket (comp01s, the ITC-like 400/10/10/200
   instance, each cut to 360 and 300 events) at pop 16 a lane, exactly,
   timed with the table and without it at the same shapes; and the new
   outputs of K5 (its accepted-move counts at the
   main path's repair and post shapes), K6 (each child's base parent, in
   both tournament modes and the parallel matcher) and K7 (migrate's
   gain at L = 1, 2, 4, 16 x pop 2, 3, 16), exactly, each kernel's other
   outputs unchanged with the new output off; then K2's, K7's, K8's
   pre-pass's, K12's, K10's, K11's and the parallel matcher's phase
   counters
   (k5_phases, each instrumented kernel checked equal to the regular
   one);
3. drives five paths through `timetabling_ga_tpu_torch.cli`, seed 42,
   each with the launch counters zeroed just before and read just after:
   on comp01s the main path (size-tuned defaults, -t 30), the
   reference-faithful path (`--no-auto-tune -p 2`, the random-candidate
   delta LS, -t 20), its full-evaluation twin (`--ls-full-eval -p 1`,
   -t 10) and the LAHC endgame (`--post-lahc 5000`, -t 15); on
   fixtures/comp05s.tim NSGA-II with the parallel matcher (`--nsga2
   --rooms-mode parallel`, -t 20). Each stream is checked (per-island
   best non-increasing, solution and runEntry records, a feasible
   reported timetable re-scores to its reported best), and so is which
   kernels each path launched (PATH_KERNELS; the reference and
   full-eval paths launch K2 only for their initial population and
   their kicks, and K6's relocation entry only for their kicks; none
   launches K13); then the resume path on comp01s (`--no-auto-tune -p 2
   -s 42`): (a) 300 generations checkpointed every epoch in
   `--trace-mode stats`, (b) the same resumed to 600, (c) 600
   uninterrupted in full mode — the final checkpoints equal bit for bit,
   (a)'s logEntry values then (b)'s equal (c)'s, K13 launched on (a) and
   (b) and never on (c) — and the tuned main path, -t 15 with a
   checkpoint in stats mode, resumed for another -t 15 (it starts at the
   saved generation, stays below the saved best floor, keeps the tuned
   16 rows: post_pop_size is dropped under --checkpoint); and the
   reference config for 300 generations in each trace mode (the three
   streams equal under strip_timing, K13 only in deltas and stats); the
   quality run: the reference config for 300 generations with and
   without --quality (the streams equal under strip_timing, K14 launched
   only with it, both rates printed); and the stall fixture, the JAX
   tests' 30-event instance with the sweep and `--quality --stall-window
   2 --stall-hamming 1.0 --auto-kick-on-stall` (a stall record, then a
   kick record, engine.kicks counted, K5 counting its moves); and the
   serve path, `python -m timetabling_ga_tpu_torch serve` at the
   service's defaults on SERVE_JOBS (comp01s x4 with one at priority 5,
   the ITC-like instance inline, comp05s: two buckets), a cancelled job,
   a deadline before the first slice and a malformed line: every
   lifecycle, every feasible solution re-scored on its unpadded
   instance, s1 and s4 alone equal to their packed records and the file
   under --no-resident equal to it resident (strip_timing), K6 and K8's
   lane forms, K8's pre-pass and K7 every dispatch, K1 and K2 once a
   started job and no other kernel; then the fleet replica (the
   fleet-replica phase, one line): SERVE_JOBS through POST /v1/solve on
   an in-process `fleet/replicas.py` Replica at the same defaults, each
   job's records equal to the serve path's line-JSON records of that
   job under strip_timing, the lane kernels launched; the same jobs
   again, the card's allocated memory after the second round is reaped
   no higher than after the first; a long job on the ITC-like instance
   until its group stays resident, then ?snapshot=1 at each fence (no
   resident hit while polled, every wire within one quantum of the
   cursor, the median fetch time); POST /v1/drain?mode=preempt (the job
   `preempted` with its wire, the exit before --preempt-grace), the
   wire resumed on a second replica at its fence (0 generations re-run)
   to the records of an uninterrupted run; and `python -m
   timetabling_ga_tpu_torch serve --http --preempt-on-term -o LOG` in a
   process of its own sent SIGTERM after its job's first park: exit 0
   within the grace, the log ending with the `preempted` jobEntry;
   then the fleet gateway (the fleet-gateway phase, one line): `python
   -m timetabling_ga_tpu_torch fleet --spawn 2 -- --obs`, two `serve
   --http` processes of the port on the card: SERVE_JOBS (s1 through
   the `submit` CLI) with the line-JSON records, `warm` then `hit` each
   bucket, the routeEntry lines equal to /v1/fleet's router stats, the
   workers' lane kernels launched (their `kernels.launches.*` gauges),
   their usageEntry flops above 0 and /v1/usage their sum; a long job's
   owner SIGKILLed at a synced wire (resumed on the other worker, at
   most one quantum re-run, the uninterrupted records); a second long
   job moved by POST /v1/drain?mode=preempt&replica=NAME (0 generations
   re-run, the owner exiting 0); the graceful drain (the fleet and every
   worker exit 0, none left); and an autoscaler's gateway (`--spawn 1
   --scale-max 2`, short windows): a burst scales up, the spawned worker
   serves a bucket of its own, idle scales down through the preempt
   drain; kill-to-resumed, preempt-to-exit, boot and decision-to-ready
   seconds and lane-gens/s through the gateway beside the line-JSON
   leg's printed; then islands across cards and processes (the mesh
   phase, one `mesh` line, after K7's halo form `migrate_halo` is held
   against migrate_plain with the same halo rows at 2-4 shards of the
   card x 1-2 islands x pop 3 and 8 (E = 8) and on comp01s at 2 shards
   x 2 islands x 16 rows, populations and gains exact, and timed beside
   its in-card form): (a) the main path's tuned config on 4 islands at
   MESH_MAIN's generations, on one shard and on a 2-shard mesh of the
   card (the engine in this process over [cuda:0, cuda:0]), the streams
   equal under strip_timing, every migration of the mesh run K7's halo
   form; (b) the reference config on 4 islands in one process and in
   two processes sharing the card (`--coordinator`, 2 islands each;
   gloo, printed as such), process 0's stream equal to one process's,
   process 1's never written; (c) `--faults dispatch@1:2:die
   --peer-timeout 5 --checkpoint`: process 0 exits 70 with the abort
   faultEntry (lostProc 1, agreed false) and the checkpoint, and a fresh
   two-process `--resume` run ends as (b); (d) ms a halo exchange
   through gloo between two processes on the card; (e) SERVE_JOBS on a
   2-shard lane mesh of the card, each job's records equal to the serve
   path's line-JSON leg; the gens/s of each layout, the lane-gens/s at
   1 and 2 shards and the phase's wall printed with the card's name and
   power limit (NCCL and copies between cards are not measured: one
   card);
   then the dispatch pipeline and in-run fault recovery on the
   reference config (comp01s, `--no-auto-tune -p 2 -s 42`, 300
   generations): (a) pipelined (the default) against `--no-pipeline`,
   every dispatch and every retire's event wait under
   torch.cuda.set_sync_debug_mode("error") (a hidden host sync raises),
   the streams equal under strip_timing, `gen-loop` saying pipelined
   true and false, both rates and host gaps a generation printed, then
   the full-eval config (`-p 1 --ls-full-eval`) pipelined once; (b)
   `--faults dispatch:2:unavailable`: one recover record; (c)
   `fetch:3:hang --fetch-timeout 2` with TT_FAULT_HANG_S=30: a fetch
   watchdog recover, the run's wall below the hang; (d)
   `dispatch:1:unavailable,dispatch:2:unavailable --max-recoveries 5`:
   recover, recover, degrade to serial; (e) `--checkpoint
   --checkpoint-every 1` with `dispatch:3:unavailable`: the final npz at
   generation 300 — each fault leg's stream equal to (a)'s, its
   faultEntry sequence JAX's for the plan, its wall beside the clean
   run's; (f) the serve path on SERVE_FAULT_JOBS (two buckets): with
   `--faults quantum:2:unavailable` every job's records equal a clean
   run's; with `--max-job-recoveries 0` only that dispatch's job fails
   and the others' records equal the clean run's; with
   `--shed-queue-hwm 2` the lowest-priority jobs shed with a `shed`
   jobEntry and the highest-priority one finishes as in the clean run;
   then the observability and usage metering (the obs phase): (a) the
   pipeline's reference config with `--obs --metrics-every 1`, in a
   fresh metrics registry and under the sync-debug mode as (a) above:
   its stream equal to the clean leg's under strip_timing, every
   dispatch with its `dispatch`, `fetch` and `process` spans on one flow,
   the last metricsEntry's engine.dispatches the dispatch count and
   engine.gens 300, both rates (with and without --obs) printed, the
   port's `trace` subcommand writing Chrome JSON that json.load reads
   with one `X` event a span, `stats` exiting 0; (b) the fault legs run
   with --obs and read each rehydrate's wall off its `recover` span;
   (c) SERVE_JOBS with tenants through `serve --obs` (metering on)
   against `--no-usage`: the streams equal under strip_timing, every
   dispatch usageEntry's lanes summing exactly to its gens,
   device_seconds, compile_seconds and flops, every finished job's
   result carrying its tenant and a meter of the generations it ran, the
   summed device_seconds beside the quanta spans' summed wall and the
   service's wall, a `{"stats": "prometheus"}` answer parsed as text
   exposition; each number of the phase printed with the card's name
   and power limit; then the pull front, the history ring, the flight
   recorder and the memory poller (the pullfront phase): (a) the
   reference config for 300 generations clean, with `--obs --obs-listen
   127.0.0.1:<a free port> --history-every 0.2 --incident-dir <dir>
   --incident-min-interval 0 --faults dispatch:2:unavailable` (a fresh
   registry; a thread scraping /metrics, /healthz, /readyz and
   /metrics/history?window=10 through the run) and with the same fault
   and --obs but neither the listener nor the recorder: the three
   streams equal under strip_timing, the same launches in both fault
   legs, /metrics OpenMetrics ending in `# EOF` with a `dispatch=`
   exemplar, /healthz 200, /readyz JSON with JAX's keys, the history
   with series, device.mem_bytes_limit the card's total memory and
   device.mem_bytes_in_use above 0, exactly one bundle (trigger
   `fault:dispatch/recover`) with its flight_dump span on the stream,
   `python -m timetabling_ga_tpu_torch incident <dir>` and `trace <log>
   <bundle>` exiting 0; (b) the serve-faults jobs (SERVE_FAULT_JOBS)
   with `--obs --obs-listen --incident-dir --faults
   quantum:2:unavailable`: one `fault:quantum/requeue` bundle, served by
   incident_response, /readyz answered during the run, every job's
   records those of the serve-faults requeue leg; (c) `scale` on a
   small scaleEntry log exiting 0; the legs' rates, the scrape latency,
   the time-to-dump, the ring sizes and the poller's bytes printed with
   the card's name and power limit; then the profiler and the cost
   observatory (the profile phase, one `profile` line): (a) the
   reference config, 300 generations, with `--trace-profile`: one
   `profile` phase record, the capture's unattributed share at most
   10%, `delta`'s top op K8's chain, the attributed total within 2% of
   the kernel, memcpy and memset time summed off the same trace; (b)
   the main path's tuned defaults with `--obs --obs-listen
   --profile-dir --profile-for 2` (`-t 15`) and, from a process of its
   own once that capture has landed, `profile URL --for 1 --attribute`:
   both captures land, two profEntry records, `sweep` the largest phase
   of the second, whether the worker-started capture holds ranges or
   kernels only printed, `hotspots LOG` and `hotspots --diff` rendering;
   (c) (a)'s config with no capture and with `--profile-for 1`: the
   three streams equal under strip_timing; (d) reference gens/s with the
   scopes on and with TT_PROF_SCOPES=0, two processes started together,
   legs interleaved on, off, on, off; (e) the serve jobs through `serve
   --obs`: every dispatch usageEntry's flops the work its quantum's
   launches counted (work.py), its lanes summing to it, and
   cost.flop_utilization_pct in (0, 100];
   then the scale phase (`python3 chip_smoke.py scale` runs it alone,
   after the build): BASELINE's fourth configuration, the port's
   random_instance(7, n_events=2000, n_rooms=80, n_features=10,
   n_students=1000, attend_prob=0.01) written to build/chip_smoke/ as a
   .tim: every kernel that chooses a room at its 80 rooms against its
   plain version at 2-4 rows, exactly (K1, K2, K4, K5 at the repair and
   post shapes at every cluster size, K6 greedy, crowded and parallel
   and its relocation entry, K7, K8's pre-pass and chain, K9, K10 at K
   16 and Lh 5,000, K12), K5, K8 and K10 reading the conflict bitset and
   K12 also its suitable-rooms table from global memory, each line with
   ms a call, its bound, the bytes of a block and that branch; the lane
   forms on two jobs of 40 and 36 rooms in serve's 64-room bucket; K2 at
   pop 32,768 (ms a batch, evaluations a second, peak memory; every row
   against the plain version in chunks); one size-tuned repair
   generation at pop 32,768 (2,048 islands of 16: wall, device ms by
   kernel, peak memory, every row's terms against the plain K2); and the
   main path on the scale .tim (-t 20), its stream and launches checked
   as the main path's; then the university phase (`python3 chip_smoke.py
   university` runs it alone, after the build): the port's
   random_instance(11, n_events=2400, n_rooms=400, n_features=10,
   n_students=10_000, attend_prob=0.003) written as a .tim: every kernel
   with a global-memory branch (K1, K2, K5 at the repair shape and the
   post shape cut to 100 steps, at every cluster size, K6 greedy,
   crowded, parallel and relocation, K8's pre-pass and chain, K9, K10,
   K12) against its plain version at 2-4 rows, exactly, in the branch
   the sizes choose and again with every such region in global memory
   (STAGE_LIMIT 0), each line naming its branch; the lane forms on two
   jobs of one bucket past shared memory; then the five paths on the
   .tim (-t 8-12), streams and launches checked (the lahc path's K10
   only where it reached feasibility), each with its peak memory;
4. profiles one population init (K1, K2, K7 at pop 16), one repair
   generation, one post-phase sweep pass, one reference-path
   generation, one full-eval generation, one kick, one LAHC launch and
   two NSGA-II generations,
   repair and post phase (launches, device idle share, device time per
   launch of each kernel), then K2's, K9's, K13's and K14's own launches
   at their timed shapes (K9's body runs inside K6 on the paths);
5. prints one line per kernel, the {"kernels": [...]} summary and, last,
   {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line. Without a CUDA
device, or without the repository beside it, it exits non-zero at once.
Outputs go under build/chip_smoke/.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

# the fault legs' hang: above their --fetch-timeout, read by the port's
# runtime/faults.py when it is imported
os.environ.setdefault("TT_FAULT_HANG_S", "30")

HERE = os.path.dirname(os.path.abspath(__file__))
# the card's name and power limit (nvidia-smi), set by main() and printed
# beside the obs phase's numbers
CARD = None
TIM = os.path.join(HERE, "fixtures", "comp01s.tim")
WITNESS = os.path.join(HERE, "fixtures", "comp01s.witness.json")
TIM05 = os.path.join(HERE, "fixtures", "comp05s.tim")
WITNESS05 = os.path.join(HERE, "fixtures", "comp05s.witness.json")
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")
# the paths' budgets: short enough that the whole script stays well
# inside its time limit, the main path long enough to reach the
# post-feasibility phase; the time limit, not the generation cap, ends
# each run. The scale phase's cost was paid by cutting main 60 -> 45 and
# lahc 30 -> 20, the university phase's by cutting main 45 -> 30,
# reference 30 -> 20, lahc 20 -> 15 and the scale CLI leg 30 -> 20
# (PERF.md section 4).
PATHS = {
    "main": ["-s", "42", "-t", "30", "--generations", "100000", "--trace"],
    "reference": ["--no-auto-tune", "-p", "2", "-s", "42", "-t", "20",
                  "--generations", "100000", "--trace"],
    "full-eval": ["--no-auto-tune", "-p", "1", "--ls-full-eval", "-s", "42",
                  "-t", "10", "--generations", "100000", "--trace"],
    "lahc": ["-s", "42", "-t", "15", "--post-lahc", "5000", "--generations",
             "100000", "--trace"],
    "nsga": ["-s", "42", "-t", "20", "--nsga2", "--rooms-mode", "parallel",
             "--generations", "100000", "--trace"],
}
# the paths' instance where it is not comp01s
PATH_TIM = {"nsga": TIM05}
# The card's peaks (H100_HBM_BYTES_S, H100_INT32_OPS_S, H100_FP32_OPS_S:
# obs/cost.py, the NVIDIA data sheet's) and the operations each kernel
# does per element it visits (work.py OPS_*, counted by hand from
# csrc/) have one home in the package: `bind_counts` binds them here
# once the package is found (PEAK_BYTES_S, PEAK_INT_OPS_S,
# PEAK_FP32_OPS_S and OPS_*), and the bounds below count with them.
# K5's cluster sizes held against the plain pass (None: the wrapper's
# own choice)
K5_CLUSTERS = (None, 1, 2, 4, 8)
# entry point -> (source, the JAX function it replaces, the path whose
# run its "launches" are read from: K3 and K4 run on no path but inside
# K5 and keep their own launches as unit checks of the shared bodies)
KERNELS = {
    "assign_rooms": ("timetabling_ga_tpu_torch/csrc/assign_rooms.cu",
                     "timetabling_ga_tpu/ops/rooms.py:108", "main"),
    "batch_penalty": ("timetabling_ga_tpu_torch/csrc/batch_penalty.cu",
                      "timetabling_ga_tpu/ops/fitness.py:235", "main"),
    "move1_sweep": ("timetabling_ga_tpu_torch/csrc/move1_sweep.cu",
                    "timetabling_ga_tpu/ops/sweep.py:78", "main"),
    "delta_one": ("timetabling_ga_tpu_torch/csrc/delta_one.cu",
                  "timetabling_ga_tpu/ops/delta.py:90", "main"),
    "sweep_pass": ("timetabling_ga_tpu_torch/csrc/sweep_pass.cu",
                   "timetabling_ga_tpu/ops/sweep.py:230", "main"),
    "breed": ("timetabling_ga_tpu_torch/csrc/breed.cu",
              "timetabling_ga_tpu/ops/ga.py:168", "main"),
    "relocate": ("timetabling_ga_tpu_torch/csrc/breed.cu",
                 "timetabling_ga_tpu/ops/moves.py:174", "main"),
    "survivors": ("timetabling_ga_tpu_torch/csrc/survivors.cu",
                  "timetabling_ga_tpu/ops/ga.py:290", "main"),
    "migrate": ("timetabling_ga_tpu_torch/csrc/survivors.cu",
                "timetabling_ga_tpu/parallel/islands.py:213", "main"),
    # K7's migrate with an island mesh's halo rows (the lax.ppermute
    # edges of _migrate): the main path on a 2-shard mesh of one card
    "migrate_halo": ("timetabling_ga_tpu_torch/csrc/survivors.cu",
                     "timetabling_ga_tpu/parallel/islands.py:262", "mesh"),
    "random_ls_events": ("timetabling_ga_tpu_torch/csrc/random_ls.cu",
                         "timetabling_ga_tpu/ops/moves.py:128", "reference"),
    "random_ls": ("timetabling_ga_tpu_torch/csrc/random_ls.cu",
                  "timetabling_ga_tpu/ops/delta.py:212", "reference"),
    "full_eval_ls": ("timetabling_ga_tpu_torch/csrc/full_eval_ls.cu",
                     "timetabling_ga_tpu/ops/local_search.py:40",
                     "full-eval"),
    "parallel_rooms": ("timetabling_ga_tpu_torch/csrc/parallel_rooms.cu",
                       "timetabling_ga_tpu/ops/rooms.py:304", "nsga"),
    "lahc": ("timetabling_ga_tpu_torch/csrc/lahc.cu",
             "timetabling_ga_tpu/ops/lahc.py:106", "lahc"),
    "nsga_rank": ("timetabling_ga_tpu_torch/csrc/nsga.cu",
                  "timetabling_ga_tpu/ops/nsga.py:40", "nsga"),
    "nsga_survivors": ("timetabling_ga_tpu_torch/csrc/nsga.cu",
                       "timetabling_ga_tpu/ops/nsga.py:97", "nsga"),
    "compress_trace": ("timetabling_ga_tpu_torch/csrc/trace_compress.cu",
                       "timetabling_ga_tpu/parallel/islands.py:595",
                       "resume"),
    "moment_rows": ("timetabling_ga_tpu_torch/csrc/trace_compress.cu",
                    "timetabling_ga_tpu/parallel/islands.py:445",
                    "resume-main"),
    "quality_ops": ("timetabling_ga_tpu_torch/csrc/quality.cu",
                    "timetabling_ga_tpu/ops/ga.py:221", "quality"),
    "div_stats": ("timetabling_ga_tpu_torch/csrc/quality.cu",
                  "timetabling_ga_tpu/parallel/islands.py:495", "quality"),
    # K6 and K8's chain with a lane table: B13, the serve lane runner
    "breed_lanes": ("timetabling_ga_tpu_torch/csrc/breed.cu",
                    "timetabling_ga_tpu/parallel/islands.py:1115", "serve"),
    "random_ls_lanes": ("timetabling_ga_tpu_torch/csrc/random_ls.cu",
                        "timetabling_ga_tpu/parallel/islands.py:1115",
                        "serve"),
    # K13 and K14's lane forms: the rest of B13 (serve --trace-mode
    # deltas|stats, serve --quality)
    "compress_trace_lanes": ("timetabling_ga_tpu_torch/csrc/trace_compress.cu",
                             "timetabling_ga_tpu/parallel/islands.py:1195",
                             "serve-stats"),
    "div_stats_lanes": ("timetabling_ga_tpu_torch/csrc/quality.cu",
                        "timetabling_ga_tpu/parallel/islands.py:1200",
                        "serve-quality"),
}
# entry points whose body runs inside another kernel on the paths and
# whose own launch is the unit check of that body (0 launches on a path)
BODY_RUNS_IN = {"move1_sweep": "sweep_pass",
                "delta_one": "sweep_pass, random_ls, lahc",
                "parallel_rooms": "breed"}
# per path: the kernels it must launch at least once a generation, at
# least once, and never. K6 scores its children, K8 the rows its search
# returns and K12 carries the evaluations it accepts, so the reference
# and full-eval paths launch K2 only for the initial population (and for
# each kick's re-evaluation), and K6's relocation entry only for kicks:
# K2_ONLY_AT_INIT
PER_GEN = ("breed", "survivors", "batch_penalty")
SEARCH_MODES = ("lahc", "nsga_rank", "nsga_survivors", "parallel_rooms")
# K13 runs only under --trace-mode deltas|stats, K14 only under --quality
K13 = ("compress_trace", "moment_rows")
K14 = ("quality_ops", "div_stats")
K8 = ("random_ls_events", "random_ls")
LS = K8 + ("full_eval_ls",)
# the lane forms run only on the serve path: K6 and K8's chain with a
# lane table every dispatch, K13's and K14's under its trace modes and
# --quality
LANES = ("breed_lanes", "random_ls_lanes")
LANE_TRACE = ("compress_trace_lanes", "div_stats_lanes")
# K7's halo form runs only where the ring crosses shards (the mesh phase)
HALO = ("migrate_halo",)
PATH_KERNELS = {
    "main": (PER_GEN, ("assign_rooms", "sweep_pass", "migrate"),
             ("move1_sweep", "delta_one") + LS + SEARCH_MODES + K13 + K14
             + LANES + LANE_TRACE + HALO),
    "reference": (("breed", "survivors") + K8,
                  ("assign_rooms", "batch_penalty"),
                  ("move1_sweep", "delta_one", "sweep_pass", "full_eval_ls")
                  + SEARCH_MODES + K13 + K14 + LANES + LANE_TRACE + HALO),
    "full-eval": (("breed", "survivors", "random_ls_events",
                   "full_eval_ls"), ("assign_rooms", "batch_penalty"),
                  ("move1_sweep", "delta_one", "sweep_pass", "random_ls")
                  + SEARCH_MODES + K13 + K14 + LANES + LANE_TRACE + HALO),
    # comp01s is feasible inside the initial polish, so the LAHC walkers
    # take the whole budget after it; K10 takes its candidates' events
    # from K8's pre-pass
    "lahc": ((), ("assign_rooms", "sweep_pass", "batch_penalty", "lahc",
                  "random_ls_events"),
             ("move1_sweep", "delta_one", "random_ls", "full_eval_ls")
             + ("nsga_rank", "nsga_survivors", "parallel_rooms") + K13
             + K14 + LANES + LANE_TRACE + HALO),
    "nsga": (("breed", "nsga_rank", "nsga_survivors", "batch_penalty"),
             ("assign_rooms", "sweep_pass"),
             ("move1_sweep", "delta_one") + LS + ("lahc", "parallel_rooms")
             + K13 + K14 + LANES + LANE_TRACE + HALO),
    # the mesh phase: the main path on one shard of 4 islands, and on a
    # 2-shard mesh of the one card, where every migration crosses a
    # shard boundary (K7's halo form, never its in-card ring)
    "mesh-one": (PER_GEN, ("assign_rooms", "sweep_pass", "migrate"),
                 ("move1_sweep", "delta_one") + LS + SEARCH_MODES + K13
                 + K14 + LANES + LANE_TRACE + HALO),
    "mesh": (PER_GEN, ("assign_rooms", "sweep_pass") + HALO,
             ("move1_sweep", "delta_one", "migrate") + LS + SEARCH_MODES
             + K13 + K14 + LANES + LANE_TRACE),
}
# the scale phase's main path on the 2000-event / 80-room .tim
PATH_KERNELS["scale"] = PATH_KERNELS["main"]
# the serve path: its lanes' kernels every dispatch, K1 and K2 once a
# started job (each job's init), and none of the engine paths' others
SERVE_NEVER = (("breed", "random_ls", "relocate", "move1_sweep",
                "delta_one", "sweep_pass", "migrate", "full_eval_ls")
               + SEARCH_MODES + K13 + K14 + LANE_TRACE + HALO)
# the serve path's telemetry legs: SERVE_JOBS again under each, its
# stream equal to the full run's; which of K13's and K14's lane forms
# (and K14's quality_ops) each launches
SERVE_LEGS = {"deltas": ["--trace-mode", "deltas"],
              "stats": ["--trace-mode", "stats"],
              "quality": ["--quality"],
              "quality-stats": ["--quality", "--trace-mode", "stats"]}
# the warm start: s1 shipped at its first host fence after this many
# generations and resumed from the wire
SERVE_SHIP_AT = 100
# the edit leg: an edit of comp01s (one event removed, one added) at
# w_anchor 1 from the finished s1's wire, and a cross-bucket edit (144
# events removed: comp01s's 400 fall into the 256-event bucket), which
# demotes
EDIT_GENS = 50
EDIT_OPS = [{"op": "remove_event", "event": 7},
            {"op": "add_event", "students": [0, 5, 17, 42],
             "features": [1]}]
EDIT_CROSS_OPS = [{"op": "remove_event", "event": 0}] * 144
# the serve path's requests: the service's defaults (4 lanes, pop 16,
# quantum 25, -m 32, 8 candidates); s1-s4 and s6 share comp01s's
# bucket (512, 16, 16, 256, 5, 9), s5 (comp05s) is the second bucket
SERVE_JOBS = (("s1", TIM, 1, 200, 0), ("s2", TIM, 2, 200, 0),
              ("s3", TIM, 3, 200, 0), ("s4", "itc", 4, 200, 0),
              ("s5", TIM05, 5, 200, 0), ("s6", TIM, 6, 100, 5))
# the four mixed lanes of the lane-kernel phase: comp01s, the ITC-like
# 400/10/10/200 instance, and padded copies of each cut to 360 and 300
# events, all in comp01s's bucket; pop 16 a lane
LANE_POP = 16
K2_ONLY_AT_INIT = ("reference", "full-eval")
# K2's cluster sizes held against its plain version (None: the wrapper's
# own choice), at P = 4 (the post phase), 16 (the repair phase) and 256
K2_CLUSTERS = (None, 1, 2, 4, 8)
# fused evaluations held against batch_penalty_plain, by kernel
FUSED_CHECKS = {"breed": 0, "random_ls": 0, "full_eval_ls": 0}
# K9's timed calls by timing key, for their device times (k9_device_times)
K9_TIMED = {}
# K13's grid: islands, trace lengths and event caps (each trace also at
# its islands' least and largest improvement counts), and its timed
# shapes: the resume path's dispatch (1 island, 100 generations, stats)
# and the main path's polish row (16 rows)
K13_L = (1, 4, 16)
K13_T = (1, 8, 33, 64, 200, 1000)
K13_CAPS = (1, 3, 64, 5000)
K13_TIMED = {"compress_trace": (1, 100), "moment_rows": (1, 16)}
# K13 and K14's lane forms: the grid (lanes x quantum lengths, each with
# an idle lane, a lane at the quantum and lanes between), and the serve
# path's shape they are timed at: the lane phase's four lanes of
# comp01s's bucket (E = 512 padded; 400, 400, 360 and 300 live events),
# a quantum of 25 generations, pop 16 a lane, an idle lane
K13_LANE_L = (1, 4, 16)
K13_LANE_T = (1, 8, 25, 33, 200)
LANE_TRACE_T = 25
LANE_COUNTS = (25, 0, 13, 25)
K14_LANE_POP = (1, 2, 3, 16, 33)
# the resume path: the reference config on comp01s, 300 generations
# checkpointed every epoch in stats mode, resumed to 600, against 600
# uninterrupted in full mode; then the tuned main path for -t 15 with a
# checkpoint, resumed for another -t 15
RESUME = ["--no-auto-tune", "-p", "2", "-s", "42", "-t", "120", "--trace"]
RESUME_MAIN = ["-s", "42", "-t", "15", "--generations", "100000",
               "--trace-mode", "stats", "--trace"]
# K14's grid (islands x rows an island) and its timed shape: the main
# path's repair population, one island of 16
K14_L = (1, 4, 16)
K14_POP = (2, 3, 4, 10, 16)
K14_TIMED = (1, 16)
# the stall fixture: the JAX quality tests' 30-event instance, the sweep
# on two islands of 8, a stall after 2 dispatches with no new best at
# any diversity, and the auto-kick
STALL = ["--no-auto-tune", "--ls-mode", "sweep", "--ls-sweeps", "1",
         "--init-sweeps", "2", "--pop-size", "8", "--islands", "2",
         "--migration-period", "10", "--generations", "300", "-s", "5",
         "-t", "120", "--trace", "--quality", "--stall-window", "2",
         "--stall-hamming", "1.0", "--auto-kick-on-stall"]


# the pipeline and fault legs: the reference config for 300 generations
# (three dispatches of 100), each fault plan with the faultEntry (site,
# action, recovery, level, mode, lostGens) sequence the JAX engine
# writes for it on the same config, pipelined: dispatch 2 fails with
# dispatch 1 in flight (100 generations lost), and fetch 3 (after the
# init fence and the first snapshot) is dispatch 1's trace, read with
# dispatch 2 in flight (200)
PIPE = RESUME + ["--generations", "300"]
# the obs phase's flags: every span and a metricsEntry every dispatch
OBS = ["--obs", "--metrics-every", "1"]
# the obs phase's serve tenants (the other jobs are the default tenant)
SERVE_TENANTS = {"s1": "acme", "s2": "acme", "s5": "zeta"}
FAULT_LEGS = {
    "dispatch": (["--faults", "dispatch:2:unavailable"],
                 [("dispatch", "recover", 1, 0, None, 100)]),
    "fetch-hang": (["--faults", "fetch:3:hang", "--fetch-timeout", "2"],
                   [("fetch", "recover", 1, 0, None, 200)]),
    "degrade": (["--faults", "dispatch:1:unavailable,dispatch:2:unavailable",
                 "--max-recoveries", "5"],
                [("dispatch", "recover", 1, 0, None, 0),
                 ("dispatch", "recover", 2, 0, None, 0),
                 ("dispatch", "degrade", 2, 1, "serial", None)]),
    "checkpoint": (["--checkpoint-every", "1", "--faults",
                    "dispatch:3:unavailable"],
                   [("dispatch", "recover", 1, 0, None, 0)]),
}
# the serve fault legs: two buckets, s6 at priority 5
SERVE_FAULT_JOBS = tuple(x for x in SERVE_JOBS if x[0] in
                         ("s1", "s2", "s5", "s6"))


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


def bind_counts():
    """Bind the package's peaks (obs/cost.py) and per-element operation
    counts (work.py OPS_*) as this script's globals, and the shape-only
    counts it shares with the package's work table: penalty_ops,
    penalty_bytes, parallel_rooms_ops and parallel_rooms_bytes."""
    from timetabling_ga_tpu_torch import work
    from timetabling_ga_tpu_torch.obs import cost
    g = globals()
    g.update({k: getattr(work, k) for k in dir(work)
              if k.startswith("OPS_")})
    g.update(PEAK_BYTES_S=cost.H100_HBM_BYTES_S,
             PEAK_INT_OPS_S=cost.H100_INT32_OPS_S,
             PEAK_FP32_OPS_S=cost.H100_FP32_OPS_S)
    for name in ("penalty_ops", "penalty_bytes", "parallel_rooms_ops",
                 "parallel_rooms_bytes"):
        g[name] = getattr(work, name)


def kernel_cases(pa, P, dev):
    """For each kernel: (kernel call, plain call, bytes moved, integer
    operations) at the main path's shapes with P individuals; the
    operations are each inner loop's trip count times its loads and ALU
    instructions, counted by hand from the kernel's source."""
    import torch
    from timetabling_ga_tpu_torch import work
    from timetabling_ga_tpu_torch.ops import delta, fitness, rooms, sweep
    g = torch.Generator(device=dev).manual_seed(1000 + P)
    E, R, T, S = pa.n_events, pa.n_rooms, pa.n_slots, pa.n_students
    W = pa.conflict_bits.shape[1]
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
    # breeding, truncation and migration: islands of the main path's 16
    # rows; parents with random rooms (not their slots' matching)
    from timetabling_ga_tpu_torch.ops import ga, moves
    from timetabling_ga_tpu_torch.parallel import islands
    L, pop = P // 16, 16
    cfg = ga.GAConfig(pop_size=pop, p3=0.2)
    par = ga.evaluate(pa, slots, torch.randint(
        0, R, (P, E), generator=g, device=dev, dtype=torch.int32), L)
    bd = ga.make_breed_draws([g] * L, pop, E, T, cfg, dev)
    n_x, n_m = int(bd.do_x.sum()), int(bd.do_m.sum())
    chain = moves.MoveDraws(*(x[None] for x in bd.move))
    c_slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                            dtype=torch.int32)
    ch = ga.evaluate(pa, c_slots, rooms.assign_rooms_plain(pa, c_slots), L)
    surv = ga.survivors_plain(par, ch, L, pop)
    row_b = 4 * (2 * E + 3)                  # a row's five fields
    top3_ops = E * OPS_TOP3 + 3 * R * OPS_ROOM_KEY
    cases = {
        "breed": (
            lambda: ga.make_children(pa, bd, par, cfg, L),
            lambda: ga.make_children_plain(pa, bd, par, cfg, L),
            nbytes(par.slots, par.rooms, par.penalty, par.scv, *bd[:5],
                   *bd.move, pa.room_order) + prob + penalty_bytes(pa)
            + 2 * P * E * 4 + 3 * P * 4,
            n_x * E * (R * OPS_ROOM_KEY + 2) + (P - n_x) * E * 3
            + n_m * top3_ops + P * 2 * cfg.tournament_k * OPS_LEX
            + P * penalty_ops(pa)),
        "relocate": (
            lambda: moves.relocation_chain(pa, chain, slots, rms, 1),
            lambda: moves.relocation_chain_plain(pa, chain, slots, rms, 1),
            rows + nbytes(*bd.move) + prob + 2 * P * E * 4,
            P * (E * 3 + top3_ops)),
        "survivors": (
            lambda: ga.survivors(par, ch, L, pop),
            lambda: ga.survivors_plain(par, ch, L, pop),
            2 * 2 * P * 4 + 2 * P * row_b,
            L * (2 * pop) ** 2 * OPS_LEX + P * (2 * E + 3) * OPS_COPY),
        "migrate": (
            lambda: islands.migrate(surv, L),
            lambda: islands.migrate_plain(surv, L),
            2 * P * 4 + 2 * P * row_b,
            L * pop ** 2 * OPS_LEX + P * (2 * E + 3) * OPS_COPY),
    }
    cases["parallel_rooms"] = (
        lambda: rooms.parallel_assign_rooms(pa, slots),
        lambda: rooms.augment_rooms_plain(pa, slots,
                                          rooms.best_fit_rooms(pa, P)),
        parallel_rooms_bytes(pa, slots),
        P * parallel_rooms_ops(E, ga.PARALLEL_ROUNDS))
    w_assign = work.assign_rooms(pa, slots)
    w_pen = work.batch_penalty(pa, slots)
    w_move1 = work.move1_sweep(pa, st.slots, st.att, st.occ, piv)
    return {**cases, **{
        "assign_rooms": (
            lambda: rooms.assign_rooms(pa, slots),
            lambda: rooms.assign_rooms_plain(pa, slots),
            w_assign.bytes, w_assign.ops),
        "batch_penalty": (
            lambda: fitness.batch_penalty(pa, slots, rms),
            lambda: fitness.batch_penalty_plain(pa, slots, rms),
            w_pen.bytes, w_pen.ops),
        "move1_sweep": (
            lambda: sweep.move1_sweep(pa, st.slots, st.rooms, st.att,
                                      st.occ, piv),
            lambda: sweep.move1_sweep_plain(pa, st.slots, st.rooms, st.att,
                                            st.occ, piv),
            w_move1.bytes, w_move1.ops),
        "delta_one": (
            lambda: delta.delta_one(pa, st.slots, st.rooms, st.att, st.occ,
                                    evs, ns, act),
            lambda: delta.delta_one_plain(pa, st.slots, st.rooms, st.att,
                                          st.occ, evs, ns, act),
            rows + nbytes(st.att, st.occ, evs, ns, act) + prob
            + nbytes(pa.student_count, pa.conflict_bits, pa.attends_u8,
                     pa.ev_ptr, pa.ev_stu) + P * (S * 8 + T * W * 4)
            + P * C * 5 * 4,
            k4_body_ops(pa, st.slots, evs, ns)),
    }}


def padded_arrays(problem, dev, n_pad_events=5, n_pad_rooms=2):
    """`problem` padded with masked-out events and rooms (zero attendance
    and capacity, suitable nowhere), as a serving bucket pads it."""
    import numpy as np
    from timetabling_ga_tpu_torch.problem import derive, make_problem_arrays
    E, R = problem.n_events, problem.n_rooms
    Ep, Rp = E + n_pad_events, R + n_pad_rooms
    attends = np.zeros((problem.n_students, Ep), np.int8)
    attends[:, :E] = problem.attends
    feats = np.zeros((Ep, problem.n_features), np.int8)
    feats[:E] = problem.event_features
    room_feats = np.zeros((Rp, problem.n_features), np.int8)
    room_feats[:R] = problem.room_features
    size = np.zeros(Rp, np.int32)
    size[:R] = problem.room_size
    p = derive(Ep, Rp, problem.n_features, problem.n_students, size,
               attends, room_feats, feats)
    possible = np.array(p.possible)
    possible[E:, :] = False
    possible[:, R:] = False
    return make_problem_arrays(
        attends=p.attends, conflict=p.conflict, possible=possible,
        student_count=p.student_count, room_size=p.room_size,
        event_mask=(np.arange(Ep) < E).astype(np.float32),
        room_mask=np.arange(Rp) < R, anchor_slots=np.zeros(Ep, np.int32),
        anchor_w=np.zeros(Ep, np.int32), n_days=problem.n_days,
        slots_per_day=problem.slots_per_day, device=dev)


def compare_parallel_rooms_padded(problem, dev):
    """K9 against its plain version on a padded copy of comp01s at P = 16
    and 256, from best-fit rooms and from random incoming rooms at 1 and
    4 rounds, exactly."""
    import torch
    from timetabling_ga_tpu_torch.ops import rooms
    pa = padded_arrays(problem, dev)
    cases = 0
    for P in (16, 256):
        g = torch.Generator(device=dev).manual_seed(7500 + P)
        slots = torch.randint(0, pa.n_slots, (P, pa.n_events), generator=g,
                              device=dev, dtype=torch.int32)
        rms = torch.randint(0, pa.n_rooms - 2, (P, pa.n_events),
                            generator=g, device=dev, dtype=torch.int32)
        got = rooms.parallel_assign_rooms(pa, slots)
        want = rooms.augment_rooms_plain(pa, slots,
                                         rooms.best_fit_rooms(pa, P))
        check(torch.equal(got, want), f"parallel_rooms padded P={P}: kernel "
                                      f"differs from its plain version")
        for n in (1, 4):
            check(torch.equal(rooms.augment_rooms(pa, slots, rms, n),
                              rooms.augment_rooms_plain(pa, slots, rms, n)),
                  f"augment_rooms padded P={P} n_rounds={n}: kernel differs "
                  f"from its plain version")
        cases += 3
    return cases


def compare_breed_modes(pa, dev):
    """K6 in every mode against make_children_plain at P = 16 and 256
    (islands of 16): the greedy matcher, the crowded tournament (ranks
    and crowding from nsga_rank), the parallel matcher, and both, parents
    with random rooms; exactly, with the scores K6 writes for its
    children also held against batch_penalty_plain of the children it
    wrote; then both timed."""
    import torch
    from timetabling_ga_tpu_torch.ops import fitness, ga, nsga
    E, R, T = pa.n_events, pa.n_rooms, pa.n_slots
    out = []
    for P in (16, 256):
        L = P // 16
        g = torch.Generator(device=dev).manual_seed(7000 + P)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        par = ga.evaluate(pa, slots, torch.randint(
            0, R, (P, E), generator=g, device=dev, dtype=torch.int32), L)
        for mo, mode in ((False, "scan"), (True, "scan"),
                         (False, "parallel"), (True, "parallel")):
            cfg = ga.GAConfig(pop_size=16, p3=0.2, rooms_mode=mode,
                              multi_objective=mo)
            bd = ga.make_breed_draws([g] * L, 16, E, T, cfg, dev)
            stats = nsga.rank_crowd(par.hcv, par.scv, L) if mo else None

            def kern(bd=bd, cfg=cfg, stats=stats):
                return ga.make_children(pa, bd, par, cfg, L, stats)

            def plain(bd=bd, cfg=cfg, stats=stats):
                return ga.make_children_plain(pa, bd, par, cfg, L, stats)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            name = ("nsga2+" if mo else "") + mode
            check(all(torch.equal(w, x) for w, x in zip(want, got)),
                  f"breed {name} P={P}: kernel differs from its plain "
                  f"version")
            full = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
            check(all(torch.equal(w, x) for w, x in zip(full, got[2:])),
                  f"breed {name} P={P}: the children's scores are not "
                  f"batch_penalty_plain of the children")
            FUSED_CHECKS["breed"] += 1
            out.append({"breed_mode": name, "P": P, "ms": time_ms(kern, 20),
                        "plain_ms": time_ms(plain, 2), "max_abs_err": 0})
    return out


def degenerate_slots(pa, P, g):
    """(P, E) slots with degenerate slot buckets for the greedy matcher,
    which runs a chain per slot: row 0 every event in the last slot, row
    1 every event in slot 0 or the last (the rest empty), row 2 half the
    events in slot 3; the others random."""
    import torch
    slots = torch.randint(0, pa.n_slots, (P, pa.n_events), generator=g,
                          device=pa.device, dtype=torch.int32)
    last = pa.n_slots - 1
    slots[0] = last
    slots[1] = torch.where(slots[1] % 2 == 0, 0, last)
    slots[2, :pa.n_events // 2] = 3
    return slots


def compare_matching_degenerate(problem, pa, dev):
    """K1 and K6 (crossover on for every child, and mixed) against their
    plain versions on degenerate slot buckets (`degenerate_slots`), P =
    16 (one island), on comp01s, on a padded copy (dead events and
    rooms) and on comp01s cut to its first room (R = 1), exactly."""
    import torch
    from timetabling_ga_tpu_torch.ops import ga, rooms
    from timetabling_ga_tpu_torch.problem import derive
    one_room = derive(problem.n_events, 1, problem.n_features,
                      problem.n_students, problem.room_size[:1],
                      problem.attends, problem.room_features[:1],
                      problem.event_features).device_arrays(dev)
    cases = 0
    for name, p in (("comp01s", pa), ("padded", padded_arrays(problem, dev)),
                    ("one room", one_room)):
        g = torch.Generator(device=dev).manual_seed(7700 + cases)
        slots = degenerate_slots(p, 16, g)
        check(torch.equal(rooms.assign_rooms(p, slots),
                          rooms.assign_rooms_plain(p, slots)),
              f"assign_rooms {name}, degenerate buckets: kernel differs "
              f"from its plain version")
        par = ga.evaluate(p, slots, torch.randint(
            0, p.n_rooms, slots.shape, generator=g, device=dev,
            dtype=torch.int32))
        cfg = ga.GAConfig(pop_size=16, p3=0.2)
        bd = ga.make_breed_draws([g], 16, p.n_events, p.n_slots, cfg, dev)
        for d in (bd._replace(do_x=torch.ones_like(bd.do_x)), bd):
            got = ga.make_children(p, d, par, cfg, 1)
            want = ga.make_children_plain(p, d, par, cfg, 1)
            torch.cuda.synchronize()
            check(all(torch.equal(w, x) for w, x in zip(want, got)),
                  f"breed {name}, degenerate buckets: kernel differs from "
                  f"its plain version")
        cases += 3
    return cases


def nsga_state(g, L, pop, E, T, dev):
    """L islands of `pop` rows, (hcv, scv) from {0..3} x {0..11} so that
    duplicate pairs and shared fronts are common."""
    import torch
    from timetabling_ga_tpu_torch.ops import ga
    n = L * pop
    hcv = torch.randint(0, 4, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    scv = torch.randint(0, 12, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    pen = torch.where(hcv == 0, scv, 1_000_000 + hcv).to(torch.int32)
    slots = torch.randint(0, T, (n, E), generator=g, device=dev,
                          dtype=torch.int32)
    return ga.PopState(slots, slots.flip(1).contiguous(), pen, hcv, scv)


def compare_nsga(pa, dev):
    """K11 against its plain versions at island sizes 8, 20, 32 (two
    islands each), 33 and 70 (two and three dominator words; with the
    children, 66 and 140 rows: three and five), 512 (one) and 700 and
    1,400 (the survivors' 1,400 and 2,800 rows too many for the dominator
    words in shared memory, so peeled without them), duplicate objectives
    common, exactly."""
    import torch
    from timetabling_ga_tpu_torch.ops import nsga
    E, T = pa.n_events, pa.n_slots
    g = torch.Generator(device=dev).manual_seed(8000)
    for pop, L in ((8, 2), (20, 2), (32, 2), (33, 2), (70, 1), (512, 1),
                   (700, 1), (1400, 1)):
        par, ch = nsga_state(g, L, pop, E, T, dev), nsga_state(g, L, pop, E,
                                                                T, dev)
        got = nsga.rank_crowd(par.hcv, par.scv, L)
        want = nsga.rank_crowd_plain(par.hcv, par.scv, L)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(
            got[1].view(torch.int32), want[1].view(torch.int32)),
            f"nsga_rank pop={pop} L={L}: kernel differs from its plain "
            f"version")
        got = nsga.survivors(par, ch, L, pop)
        want = nsga.survivors_plain(par, ch, L, pop)
        check(all(torch.equal(w, x) for w, x in zip(want, got)),
              f"nsga_survivors pop={pop} L={L}: kernel differs from its "
              f"plain version")


def nsga_timings(par, ch, pop):
    """K11's two entry points and their plain versions timed on one
    island of `pop` parents (ranks) and `pop` + `pop` rows (survivors),
    with their bounds counted from these rows' fronts: the n^2 tests
    that build the dominator words once, then each front's round over
    every row's ceil(n/32) words."""
    import torch
    from timetabling_ga_tpu_torch.ops import nsga
    E = par.slots.shape[1]
    both_h = torch.cat([par.hcv, ch.hcv])
    both_s = torch.cat([par.scv, ch.scv])
    row_b = 4 * (2 * E + 3)
    n2 = 2 * pop
    out = {}
    for name, kern, plain, n, fronts, extra_b, extra_ops in (
            ("nsga_rank",
             lambda: nsga.rank_crowd(par.hcv, par.scv),
             lambda: nsga.rank_crowd_plain(par.hcv, par.scv), pop,
             int(nsga.rank_crowd_plain(par.hcv, par.scv)[0].max()) + 1,
             2 * pop * 4, 0),
            ("nsga_survivors",
             lambda: nsga.survivors(par, ch, 1, pop),
             lambda: nsga.survivors_plain(par, ch, 1, pop), n2,
             int(nsga.rank_crowd_plain(both_h, both_s)[0].max()) + 1,
             n2 * 4 + 2 * pop * row_b,
             n2 * n2 * OPS_LEX + pop * n2 * OPS_LEX
             + pop * (2 * E + 3) * OPS_COPY)):
        nb = n * 2 * 4 + extra_b
        ops = (n * n * OPS_DOM + fronts * n * -(-n // 32) * OPS_DOM_WORD
               + 2 * n * n * OPS_LEX + extra_ops)
        bytes_ms = nb / PEAK_BYTES_S * 1e3
        ops_ms = ops / PEAK_INT_OPS_S * 1e3
        out[(name, pop)] = dict(
            ms=time_ms(kern, 50), plain_ms=time_ms(plain, 5), max_abs_err=0,
            rows=n, fronts=fronts, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return out


def compare_nsga_path(pa05, dev):
    """The nsga path's own shapes on comp05s, for its repair config (one
    island of 16) and its post config (the elite rows; every generation
    of the path when it is feasible inside the polish), parents from
    random starts and from feasible ones (the comp05s witness, a few
    events moved): K11 nsga_rank on the parents, K6 in its crowded and
    parallel modes with crossover on for every child and off for every
    child, K9 on the children's slots and K11 nsga_survivors on parents +
    children, each exactly against its plain version. Then, from the
    feasible start at both pops, K11 timed (`nsga_timings`) and K6 timed.
    Returns (timings, the timing key of each K11 entry at the path's
    generations, K6 rows, cases checked)."""
    import torch
    from timetabling_ga_tpu_torch.ops import fitness, ga, nsga, rooms
    from timetabling_ga_tpu_torch.runtime import config, engine
    cfg = config.parse_args(["-i", TIM05] + PATHS["nsga"]
                            ).apply_tuned_defaults(pa05.n_events)
    repair = engine.build_ga_config(cfg)
    post = engine.build_post_config(cfg, repair)
    E, T = pa05.n_events, pa05.n_slots
    timings, breed_rows, cases = {}, [], 0
    for phase, gacfg in (("repair", repair), ("post", post)):
        check(gacfg.multi_objective and gacfg.rooms_mode == "parallel",
              f"nsga path {phase} config: not NSGA-II with the parallel "
              f"matcher")
        pop = gacfg.pop_size
        g = torch.Generator(device=dev).manual_seed(9500 + pop)
        slots = torch.randint(0, T, (pop, E), generator=g, device=dev,
                              dtype=torch.int32)
        w = witness_state(pa05, pop, g, WITNESS05)
        starts = (("random", ga.evaluate(
                      pa05, slots, rooms.assign_rooms_plain(pa05, slots))),
                  ("feasible", ga.evaluate(pa05, w.slots, w.rooms)))
        for start, par in starts:
            tag = f"nsga path {phase} pop={pop} {start}"
            got = nsga.rank_crowd(par.hcv, par.scv)
            mo = nsga.rank_crowd_plain(par.hcv, par.scv)
            torch.cuda.synchronize()
            check(torch.equal(got[0], mo[0]) and torch.equal(
                got[1].view(torch.int32), mo[1].view(torch.int32)),
                f"{tag}: nsga_rank differs from its plain version")
            bd = ga.make_breed_draws([g], pop, E, T, gacfg, dev)
            for do_x in (None, True, False):
                d = bd if do_x is None else bd._replace(
                    do_x=torch.full_like(bd.do_x, do_x))
                kid = ga.make_children(pa05, d, par, gacfg, 1, mo)
                want = ga.make_children_plain(pa05, d, par, gacfg, 1, mo)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(want, kid)),
                      f"{tag} do_x={do_x}: breed differs from its plain "
                      f"version")
                cases += 1
            kid = ga.make_children(pa05, bd, par, gacfg, 1, mo)
            check(torch.equal(
                rooms.parallel_assign_rooms(pa05, kid.slots),
                rooms.augment_rooms_plain(pa05, kid.slots,
                                          rooms.best_fit_rooms(pa05, pop))),
                f"{tag}: parallel_rooms differs from its plain version")
            full = fitness.batch_penalty_plain(pa05, kid.slots, kid.rooms)
            check(all(torch.equal(a, b) for a, b in zip(full, kid[2:])),
                  f"{tag}: the children's scores are not "
                  f"batch_penalty_plain of the children")
            FUSED_CHECKS["breed"] += 1
            ch = ga.PopState(*kid)
            got = nsga.survivors(par, ch, 1, pop)
            want = nsga.survivors_plain(par, ch, 1, pop)
            check(all(torch.equal(a, b) for a, b in zip(want, got)),
                  f"{tag}: nsga_survivors differs from its plain version")
            cases += 3
        timings.update(nsga_timings(par, ch, pop))
        cases += compare_matcher_one_slot(pa05, par, gacfg, mo, g, phase)

        def k9(kid=kid):
            return rooms.parallel_assign_rooms(pa05, kid.slots)

        def k9_plain(kid=kid, pop=pop):
            return rooms.augment_rooms_plain(pa05, kid.slots,
                                             rooms.best_fit_rooms(pa05, pop))
        b, by = bound(parallel_rooms_bytes(pa05, kid.slots),
                      pop * parallel_rooms_ops(E, ga.PARALLEL_ROUNDS))
        key = ("parallel_rooms", "comp05s", pop)
        timings[key] = dict(ms=time_ms(k9, 50), plain_ms=time_ms(k9_plain, 5),
                            max_abs_err=0, bound_ms=b, bound_by=by)
        K9_TIMED[key] = k9

        def kern(bd=bd, par=par, mo=mo, gacfg=gacfg):
            return ga.make_children(pa05, bd, par, gacfg, 1, mo)

        def plain(bd=bd, par=par, mo=mo, gacfg=gacfg):
            return ga.make_children_plain(pa05, bd, par, gacfg, 1, mo)
        breed_rows.append({"breed_mode": "nsga2+parallel (nsga path, "
                                         f"comp05s {phase})", "P": pop,
                           "ms": time_ms(kern, 20),
                           "plain_ms": time_ms(plain, 2), "max_abs_err": 0})
    path_keys = {k: (k, post.pop_size) for k in ("nsga_rank",
                                                 "nsga_survivors")}
    return timings, path_keys, breed_rows, cases


def compare_matcher_one_slot(pa05, par, gacfg, mo, g, phase):
    """The parallel matcher on comp05s rows with every event in one slot
    (350 events: eleven chunks of a warp's 32): K9 from best-fit rooms
    and from the parents' rooms at 0, 1 and 4 rounds, and K6 breeding
    from parents in that slot with crossover on for every child, each
    exactly against its plain version. Returns the cases checked."""
    import torch
    from timetabling_ga_tpu_torch.ops import ga, rooms
    pop, E = par.slots.shape
    slots = torch.full_like(par.slots, pa05.n_slots - 1)
    tag = f"nsga path {phase} pop={pop}, every event in one slot"
    check(torch.equal(rooms.parallel_assign_rooms(pa05, slots),
                      rooms.augment_rooms_plain(
                          pa05, slots, rooms.best_fit_rooms(pa05, pop))),
          f"{tag}: parallel_rooms differs from its plain version")
    for n in (0, 1, 4):
        check(torch.equal(rooms.augment_rooms(pa05, slots, par.rooms, n),
                          rooms.augment_rooms_plain(pa05, slots, par.rooms,
                                                    n)),
              f"{tag}: augment_rooms n_rounds={n} differs from its plain "
              f"version")
    one = par._replace(slots=slots)
    bd = ga.make_breed_draws([g], pop, E, pa05.n_slots, gacfg, pa05.device)
    bd = bd._replace(do_x=torch.ones_like(bd.do_x))
    got = ga.make_children(pa05, bd, one, gacfg, 1, mo)
    want = ga.make_children_plain(pa05, bd, one, gacfg, 1, mo)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(want, got)),
          f"{tag}: breed differs from its plain version")
    return 5


def lahc_work(pa, l0, draws):
    """(bytes, integer operations) of one LAHC call, the function's work
    whatever computes it (K8's pre-pass and K10 together): the walkers'
    state read and written once (of each history ring the entries the
    steps touch), the draws and problem arrays read once; per step and
    candidate the top-3 scan of E uniforms and the K4 body on the
    bitsets (k4_body_ops) on the candidate (its events and new
    slots taken on the slots the call starts from); the bitsets' build,
    the choice, the acceptance and the apply are left out, so the count
    stays below what the kernels do."""
    from timetabling_ga_tpu_torch.ops import moves
    n, W, K = draws.mtype.shape
    E = pa.n_events
    touched = min(n, l0.hist_pen.shape[1])
    nb = (2 * nbytes(*l0.ls, *l0[3:]) + 2 * 2 * W * touched * 4
          + nbytes(*draws)
          + nbytes(pa.possible_u8, pa.live, pa.student_count,
                   pa.conflict_bits, pa.cap_rank, pa.dead, pa.attends_u8,
                   pa.ev_ptr, pa.ev_stu, pa.anchor_slots, pa.anchor_w))
    md = moves.MoveDraws(draws.mtype.permute(1, 0, 2).reshape(-1),
                         draws.u.permute(1, 0, 2, 3).reshape(-1, E),
                         draws.t.permute(1, 0, 2).reshape(-1))
    evs, ns, _ = moves.sample_move(
        pa, md, l0.ls.slots.repeat_interleave(n * K, 0))
    ops = (k4_body_ops(pa, l0.ls.slots, evs.view(W, n * K, 3),
                       ns.view(W, n * K, 3))
           + W * n * K * E * OPS_TOP3)
    return nb, ops


def lahc_copy(state):
    """A copy of a LahcState, for K10 to update in place."""
    from timetabling_ga_tpu_torch.ops import lahc
    return lahc.LahcState(lahc.LSState(*(x.clone() for x in state.ls)),
                          *(x.clone() for x in state[1:]))


def compare_lahc(pa, dev):
    """K8's pre-pass and K10 against lahc_steps_plain over 200 steps at 4
    and 64 walkers, K = 1 and 16 candidates, histories of 5 and 5000 (the
    lahc path's shape is 4 walkers, K 16, Lh 5000), from random starts
    and from feasible ones (the witness, a few events moved), every state
    field exactly, one launch of each a call; at the path's shape also
    on tied uniforms, and with a history of 30,000 (the ring does not fit
    in shared memory: K10's global layout); then timed from the feasible
    start at the path's shape: the pre-pass and K10 together (the
    function, beside its bound), K10 alone on the pre-pass's events, and
    both on one walker (the chain's floor)."""
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.ops import lahc, rooms
    from timetabling_ga_tpu_torch.runtime import config, engine
    cfg = config.parse_args(["-i", TIM] + PATHS["lahc"])
    cfg.apply_tuned_defaults(pa.n_events)
    post = engine.build_post_config(cfg, engine.build_ga_config(cfg))
    E, T, n = pa.n_events, pa.n_slots, 200
    path_shape = (post.pop_size, cfg.post_lahc_k, cfg.post_lahc)
    out = {}
    for W, K, Lh, tied in ((*path_shape, False), (4, 1, 5, False),
                           (64, 16, 5, False), (64, 1, 5000, False),
                           (*path_shape[:2], 30_000, False),
                           (*path_shape, True)):
        g = torch.Generator(device=dev).manual_seed(9000 + W * K + Lh)
        slots = torch.randint(0, T, (W, E), generator=g, device=dev,
                              dtype=torch.int32)
        w = witness_state(pa, W, g)
        draws = lahc.make_lahc_draws([g], W, n, K, E, T, post.p1, post.p2,
                                     post.p3, dev)
        if tied:
            # every candidate's top three tied at 2.0, row 0's largest
            # tied twice at 3.0
            draws.u[..., [E - 1, 33, 2]] = 2.0
            draws.u.view(-1, E)[0, [40, 5]] = 3.0
        starts = (("random", slots, rooms.assign_rooms_plain(pa, slots)),
                  ("feasible", w.slots, w.rooms))
        tag = f"lahc W={W} K={K} Lh={Lh}{' tied' if tied else ''}"
        for start, s0, r0 in starts:
            l0 = lahc.init_lahc(pa, s0, r0, Lh)
            kernels.reset_launches()
            got = lahc.lahc_steps_kernel(pa, draws, lahc_copy(l0))
            want = lahc.lahc_steps_plain(pa, draws, l0)
            torch.cuda.synchronize()
            check(kernels.LAUNCHES["random_ls_events"] == 1
                  and kernels.LAUNCHES["lahc"] == 1,
                  f"{tag} {start}: not one pre-pass and one K10 launch")
            check(all(torch.equal(a, b) for a, b in zip(want.ls, got.ls))
                  and all(torch.equal(a, b)
                          for a, b in zip(want[1:], got[1:])),
                  f"{tag} {start}: kernel differs from its plain version")
            # from the witness a single candidate a step is mostly uphill
            # and refused; from a random start walkers must move
            check(start == "feasible"
                  or not torch.equal(got.ls.slots, l0.ls.slots),
                  f"{tag} {start}: no walker moved")
        if (W, K, Lh) != path_shape or tied:
            continue
        lk = lahc_copy(l0)
        ms = time_ms(lambda: lahc.lahc_steps_kernel(pa, draws, lk), 5)
        ev = lahc.lahc_events(draws)
        k10_ms = time_ms(lambda: lahc.lahc_steps_kernel(pa, draws, lk, ev),
                         5)
        plain_ms = time_ms(lambda: lahc.lahc_steps_plain(pa, draws, l0), 1)
        one = lahc.LahcState(lahc.LSState(*(x[:1] for x in lk.ls)),
                             *(x[:1] for x in lk[1:]))
        d1 = lahc.LahcDraws(*(x[:, :1].contiguous() for x in draws))
        ms1 = time_ms(lambda: lahc.lahc_steps_kernel(pa, d1, one), 5)
        ev1 = lahc.lahc_events(d1)
        k10_ms1 = time_ms(lambda: lahc.lahc_steps_kernel(pa, d1, one, ev1),
                          5)
        nb, ops = lahc_work(pa, l0, draws)
        bytes_ms = nb / PEAK_BYTES_S * 1e3
        ops_ms = ops / PEAK_INT_OPS_S * 1e3
        out[("lahc", W, K, Lh)] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=0, steps=n,
            us_per_step=ms * 1e3 / n, k10_ms=k10_ms,
            k10_us_per_step=k10_ms * 1e3 / n, chain_floor_ms=ms1,
            us_per_step_one_walker=ms1 * 1e3 / n,
            k10_us_per_step_one_walker=k10_ms1 * 1e3 / n,
            smem_bytes=lahc.lahc_smem_bytes(pa, K, Lh),
            feasible_rows=int((w.hcv == 0).sum()), int_ops=ops,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return out


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
            if name == "parallel_rooms":
                K9_TIMED[(name, P)] = kern
            bytes_ms = nb / PEAK_BYTES_S * 1e3
            ops_ms = ops / PEAK_INT_OPS_S * 1e3
            out[(name, P)] = dict(
                ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return out


def event_students(pa):
    """The number of students of each event, int64."""
    import torch
    return (pa.ev_ptr[1:] - pa.ev_ptr[:-1]).to(torch.int64)


def k4_body_ops(pa, slots, ev, ns):
    """Integer operations of the K4 body on candidates ev, ns (P, X, 3)
    over slots (P, E): 3 room argmins, then for each event that changes
    slot its conflict row and its students' days, counted once per
    (event, student, day), the days being the distinct days the moving
    events leave and enter, as sweep_dev.cuh tt_delta_one_bits_warp does
    them (popcounts of the row against slot_ev, a student's days from its
    amask word with the two slots each of its moving events touches
    recomputed)."""
    import torch
    import torch.nn.functional as F
    i64 = torch.int64
    W, spd = pa.conflict_bits.shape[1], pa.slots_per_day
    n_st = event_students(pa)
    slots = slots.to(i64)
    ev, ns = ev.to(i64), ns.to(i64)
    os = slots.gather(1, ev.flatten(1)).view_as(ev)
    shift = (ns != os).to(i64)
    days = torch.cat([os, ns], -1) // spd
    on = torch.cat([shift, shift], -1)
    n_d = ((F.one_hot(days, pa.n_days) * on[..., None]).sum(-2) > 0
           ).sum(-1, keepdim=True)
    per = shift * (W * OPS_DOT_WORD + n_st[ev] * (
        OPS_STUDENT + OPS_AMASK + 2 * OPS_FIX_SLOT
        + n_d * 2 * (OPS_DAY_BITS + OPS_DAY_SCORE)))
    return int(per.sum()) + ev.shape[0] * ev.shape[1] * (
        3 * pa.n_rooms * OPS_ROOM_KEY + OPS_CAND)


def sweep_pass_work(pa, sh, st, draws, piv):
    """(bytes, integer operations, float operations) of one K5 pass on
    this state, these draws and these pivots (P, K). Bytes: the state
    read and written once, the draws and problem arrays read once,
    strict_rows and the pivots written. Operations: the elements K5 must
    visit on this data, times the OPS_* constants above, in the bitset
    forms K5 runs — per step, each block pivot's Move1 (its conflict row
    against every slot's event words, its students' amask words and old
    day, T targets of R room keys and one update per student), and each
    Move2 / Move3 candidate's K4 body (k4_body_ops) plus its
    share of the choice; in hot mode the prologue's heat per event (its
    conflict row against its slot's words while the row is infeasible,
    its students' days once feasible) and the E^2 rank compares (float).
    Slots are those the pass starts from; the bitsets' build, the apply,
    which runs only on an accepted step, and the cluster's extra copies
    of the work that every CTA repeats are left out, so the count stays
    below what the kernel does."""
    import torch
    from timetabling_ga_tpu_torch.ops import sweep
    E, R, T = pa.n_events, pa.n_rooms, pa.n_slots
    W, spd = pa.conflict_bits.shape[1], pa.slots_per_day
    P, dev, i64 = st.slots.shape[0], st.slots.device, torch.int64
    nb = (2 * nbytes(*st) + nbytes(*(x for x in draws if x is not None))
          + nbytes(pa.possible_u8, pa.live, pa.student_count,
                   pa.conflict_bits, pa.cap_rank, pa.dead, pa.attends_u8,
                   pa.ev_ptr, pa.ev_stu, pa.event_mask, pa.anchor_slots,
                   pa.anchor_w) + P + P * sh.K * 4)
    n_st = event_students(pa)
    slots = st.slots.to(i64)
    pos = torch.arange(sh.n_steps, device=dev)[:, None]
    blk = torch.arange(sh.B, device=dev)[None, :]
    e = piv.to(i64)[:, ((pos * sh.B + blk) % sh.K).flatten()]   # (P, n*B)
    ops = int((T * W * OPS_SLOT_WORD
               + n_st[e] * (OPS_AMASK + 2 * (OPS_DAY_BITS + OPS_DAY_SCORE))
               + T * (R * OPS_ROOM_KEY + OPS_CAND
                      + n_st[e] * OPS_MOVE1_STUDENT)).sum())
    perm = sweep._perms(draws, E, dev).to(i64)
    if sh.SB:
        k = torch.arange(sh.SB, device=dev)
        j = (pos[..., None] * sh.B + 1 + blk[..., None] + k).flatten()
        e2 = e.view(P, sh.n_steps, sh.B, 1).expand(
            P, sh.n_steps, sh.B, sh.SB).reshape(P, -1)
        q = perm[:, j % E]
        pad = torch.where((e2 + 1) % E == q, (e2 + 2) % E, (e2 + 1) % E)
        ev = torch.stack([e2, q, pad], -1)
        sl = slots.gather(1, ev.flatten(1)).view_as(ev)
        ops += k4_body_ops(pa, slots, ev, sl[..., [1, 0, 2]])
    if sh.with_move3 and sh.SB >= 2:
        k = torch.arange(sh.SB - 1, device=dev)
        j = (pos[..., None] * sh.B + 1 + blk[..., None] + k).flatten()
        e3 = e.view(P, sh.n_steps, sh.B, 1).expand(
            P, sh.n_steps, sh.B, sh.SB - 1).reshape(P, -1)
        ev = torch.stack([e3, perm[:, j % E], perm[:, (j + 1) % E]], -1)
        sl = slots.gather(1, ev.flatten(1)).view_as(ev)
        ops += (k4_body_ops(pa, slots, ev, sl[..., [1, 2, 0]])
                + k4_body_ops(pa, slots, ev, sl[..., [2, 0, 1]]))
    fops = 0
    if sh.use_hot:
        infeasible = (st.hcv > 0).to(i64)[:, None]
        heat = (infeasible * W * OPS_SLOT_WORD
                + (1 - infeasible) * n_st * OPS_HEAT_STUDENT + OPS_HEAT)
        ops += int(heat.sum())
        fops = P * (2 * E + OPS_RANK * E * E)
    return nb, ops, fops


def witness_state(pa, P, g, witness=WITNESS):
    """P copies of the planted zero-penalty witness, row i with i % 4 of
    three spread events moved to random slots (rooms kept): the unmoved
    rows and the moved ones that stay clash-free are feasible, so the
    pass takes the hot heat's feasible branch and a choice decided by
    scv on them."""
    import torch
    from timetabling_ga_tpu_torch.ops import delta
    dev = pa.conflict.device
    E, T = pa.n_events, pa.n_slots
    with open(witness) as f:
        w = json.load(f)
    slots = torch.tensor(w["slots"], dtype=torch.int32,
                         device=dev).repeat(P, 1)
    rms = torch.tensor(w["rooms"], dtype=torch.int32,
                       device=dev).repeat(P, 1)
    base = torch.randint(0, E, (P, 1), generator=g, device=dev)
    ev = (base + torch.tensor([0, E // 3, 2 * E // 3], device=dev)) % E
    to = torch.randint(0, T, (P, 3), generator=g, device=dev,
                       dtype=torch.int32)
    moved = (torch.arange(3, device=dev)[None, :]
             < (torch.arange(P, device=dev) % 4)[:, None])
    slots.scatter_(1, ev, torch.where(moved, to, slots.gather(1, ev)))
    return delta.init_state(pa, slots, rms)


def compare_sweep_pass(pa, pa05, dev):
    """K5 against sweep_pass_plain at the main path's three sweep shapes
    on comp01s (the engine's repair config at P = 16 and 256, its post
    config at P = 4) and the nsga path's two on comp05s (repair P = 16,
    post P = 4), exactly, from random starts and from feasible ones (the
    witness, a few events moved), at every cluster size K5 takes (1, 2,
    4, 8) and at the wrapper's own choice; then each cluster size timed
    from the random start, the plain pass once, and K5 on one individual
    at its own choice (the step chain's floor)."""
    import torch
    from timetabling_ga_tpu_torch.ops import delta, rooms, sweep
    from timetabling_ga_tpu_torch.runtime import config, engine
    cfg = config.parse_args(["-i", TIM]).apply_tuned_defaults(pa.n_events)
    repair = engine.build_ga_config(cfg)
    post = engine.build_post_config(cfg, repair)
    cfg05 = config.parse_args(["-i", TIM05] + PATHS["nsga"]
                              ).apply_tuned_defaults(pa05.n_events)
    repair05 = engine.build_ga_config(cfg05)
    post05 = engine.build_post_config(cfg05, repair05)
    out = {}
    for phase, P, gc, pa_, wit in (
            ("repair", 16, repair, pa, WITNESS),
            ("repair", 256, repair, pa, WITNESS),
            ("post", post.pop_size, post, pa, WITNESS),
            ("nsga-repair", 16, repair05, pa05, WITNESS05),
            ("nsga-post", post05.pop_size, post05, pa05, WITNESS05)):
        E, T = pa_.n_events, pa_.n_slots
        args = (gc.ls_swap_block, gc.ls_block_events, gc.ls_sideways,
                gc.ls_hot_k, gc.p3)
        sh = sweep.sweep_shape(E, T, gc.ls_swap_block, gc.ls_block_events,
                               gc.ls_hot_k, gc.p3)
        auto = sweep.auto_cluster(pa_, sh, P, dev)
        g = torch.Generator(device=dev).manual_seed(2000 + P)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        st = delta.init_state(pa_, slots,
                              rooms.assign_rooms_plain(pa_, slots))
        draws = sweep.make_sweep_draws([g], P, sh, E, gc.ls_sideways, dev)
        feasible = witness_state(pa_, P, g, wit)
        check(int((feasible.hcv == 0).sum()) >= P // 4,
              f"sweep_pass {phase} P={P}: too few feasible witness rows")
        err = 0
        for start, s0 in (("random", st), ("feasible", feasible)):
            want, want_rows = sweep.sweep_pass_plain(pa_, draws, s0, *args)
            want_piv = (sweep.hot_pivots(pa_, s0, draws.hot_noise, sh.K)
                        if sh.use_hot else sweep._perms(draws, E, dev))
            for cs in K5_CLUSTERS:
                got, rows, piv = sweep.sweep_pass_kernel(pa_, draws, s0,
                                                         *args, cluster=cs)
                torch.cuda.synchronize()
                for gt, wt in zip((*got, rows, piv),
                                  (*want, want_rows, want_piv)):
                    check(gt.shape == wt.shape and gt.dtype == wt.dtype,
                          f"sweep_pass {phase} P={P} {start} cluster {cs}: "
                          f"kernel output {tuple(gt.shape)} {gt.dtype} vs "
                          f"plain {tuple(wt.shape)} {wt.dtype}")
                    err = max(err, int((gt.long() - wt.long()).abs().max()))
                check(err == 0, f"sweep_pass {phase} P={P} {start} cluster "
                                f"{cs}: kernel differs from its plain "
                                f"version (max abs err {err})")
            check(not torch.equal(want.slots, s0.slots),
                  f"sweep_pass {phase} P={P} {start}: the pass moved "
                  f"nothing")
            if start == "random":
                work = sweep_pass_work(pa_, sh, s0, draws, want_piv)
        reps = 20 if phase.endswith("repair") else 5
        ms_by_cluster = {
            str(cs): time_ms(lambda cs=cs: sweep.sweep_pass_kernel(
                pa_, draws, st, *args, cluster=cs), reps)
            for cs in sorted({1, 2, 4, 8, auto})}
        ms = ms_by_cluster[str(auto)]
        plain_ms = time_ms(lambda: sweep.sweep_pass_plain(pa_, draws, st,
                                                          *args), 1)
        # the step chain alone: one individual, one cluster
        one = delta.LSState(*(x[:1] for x in st))
        d1 = sweep.SweepDraws(
            draws.a[:1], draws.b[:1],
            None if draws.hot_noise is None else draws.hot_noise[:1],
            None if draws.tie_noise is None else draws.tie_noise[:, :1],
            None if draws.allow is None else draws.allow[:, :1])
        auto1 = sweep.auto_cluster(pa_, sh, 1, dev)
        ms1 = time_ms(lambda: sweep.sweep_pass_kernel(pa_, d1, one, *args),
                      reps)
        nb, ops, fops = work
        bytes_ms = nb / PEAK_BYTES_S * 1e3
        ops_ms = (ops / PEAK_INT_OPS_S + fops / PEAK_FP32_OPS_S) * 1e3
        out[(phase, P)] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=err, steps=sh.n_steps,
            cluster=auto, ctas=P * auto, ms_by_cluster=ms_by_cluster,
            us_per_step=ms * 1e3 / sh.n_steps, chain_floor_ms=ms1,
            chain_floor_cluster=auto1,
            us_per_step_one_individual=ms1 * 1e3 / sh.n_steps,
            clusters_compared=[str(c) for c in K5_CLUSTERS],
            smem_bytes=sweep.sweep_pass_smem_bytes(pa_, sh),
            feasible_rows=int((feasible.hcv == 0).sum()),
            int_ops=ops, fp32_ops=fops,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return out


def compare_kick_chains(pa, dev):
    """K6's relocation entry against its plain version on the kick's
    chains, exactly: draws shaped (KICK_MAX_MOVES, N, E) as the kick makes
    them, N = 2 clone rows (the post phase's pop 4) and 8 (pop 16), every
    chain length the engine's kick streak runs (3, 6, 12, 16), the clones
    of one random row and of the planted witness."""
    import torch
    from timetabling_ga_tpu_torch.ops import moves, rooms
    from timetabling_ga_tpu_torch.parallel import islands
    from timetabling_ga_tpu_torch.runtime import config, engine
    gc = engine.build_ga_config(config.parse_args(
        ["-i", TIM]).apply_tuned_defaults(pa.n_events))
    E, T = pa.n_events, pa.n_slots
    g = torch.Generator(device=dev).manual_seed(6000)
    cases = 0
    for N in (2, 8):
        slots = torch.randint(0, T, (1, E), generator=g, device=dev,
                              dtype=torch.int32)
        starts = (("random", slots, rooms.assign_rooms_plain(pa, slots)),
                  ("witness",) + tuple(witness_state(pa, 1, g)[:2]))
        draws = [moves.make_move_draws([g], N, E, T, gc.p1, gc.p2, gc.p3,
                                       dev)
                 for _ in range(islands.KICK_MAX_MOVES)]
        draws = moves.MoveDraws(*map(torch.stack, zip(*draws)))
        for start, s0, r0 in starts:
            s0 = s0.expand(N, E).contiguous()
            r0 = r0.expand(N, E).contiguous()
            for n in (3, 6, 12, islands.KICK_MAX_MOVES):
                got = moves.relocation_chain(pa, draws, s0, r0, n)
                want = moves.relocation_chain_plain(pa, draws, s0, r0, n)
                torch.cuda.synchronize()
                check(all(torch.equal(w, x) for w, x in zip(want, got)),
                      f"relocate N={N} n_moves={n} {start}: kernel differs "
                      f"from its plain version")
                check(not torch.equal(got[0], s0),
                      f"relocate N={N} n_moves={n} {start}: nothing moved")
                cases += 1
    return cases


def compare_islands(pa, dev):
    """K7 (survivors, migrate) against the plain versions at L = 1, 2, 4
    and 16 islands of 2, 3 and 16 rows, with rows of comp01s's E = 400
    (16-byte copies) and E = 397 (4-byte ones), (penalty, scv) drawn from
    {0, 1, 2}^2 so that ties are common, exactly."""
    import torch
    from timetabling_ga_tpu_torch.ops import ga
    from timetabling_ga_tpu_torch.parallel import islands
    T = pa.n_slots
    g = torch.Generator(device=dev).manual_seed(4000)

    def state(n, E):
        slots = torch.randint(0, T, (n, E), generator=g, device=dev,
                              dtype=torch.int32)
        ps = torch.randint(0, 3, (2, n), generator=g, device=dev,
                           dtype=torch.int32)
        return ga.PopState(slots, slots.flip(1), ps[0], ps[0] * 2, ps[1])

    cases = 0
    for E in (pa.n_events, pa.n_events - 3):
        for L in (1, 2, 4, 16):
            for pop in (2, 3, 16):
                par, ch = state(L * pop, E), state(L * pop, E)
                for b, keep in ((ch, pop), (None, None)):
                    got = ga.survivors(par, b, L, keep)
                    want = ga.survivors_plain(par, b, L, keep)
                    check(all(torch.equal(w, x) for w, x in zip(want, got)),
                          f"survivors L={L} pop={pop} E={E}: kernel "
                          f"differs from its plain version")
                got = islands.migrate(want, L)
                check(all(torch.equal(w, x) for w, x in zip(
                    islands.migrate_plain(want, L), got)),
                    f"migrate L={L} pop={pop} E={E}: kernel differs from "
                    f"its plain version")
                cases += 1
    return cases


def compare_batch_penalty(pa, dev):
    """K2 at P = 4, 16 and 256 rows of comp01s (random slots, their
    greedy rooms) at every cluster size it takes and the wrapper's own
    choice, exactly against batch_penalty_plain, each timed."""
    import torch
    from timetabling_ga_tpu_torch.ops import fitness, rooms
    E, T = pa.n_events, pa.n_slots
    out = {}
    for P in (4, 16, 256):
        g = torch.Generator(device=dev).manual_seed(8000 + P)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        rms = rooms.assign_rooms_plain(pa, slots)
        want = fitness.batch_penalty_plain(pa, slots, rms)
        plain_ms = time_ms(lambda: fitness.batch_penalty_plain(pa, slots,
                                                               rms), 5)
        b, by = bound(nbytes(slots, rms) + penalty_bytes(pa) + 3 * P * 4,
                      P * penalty_ops(pa))
        for cs in K2_CLUSTERS:
            def kern(cs=cs):
                return fitness.batch_penalty_kernel(pa, slots, rms, cs)
            got = kern()
            torch.cuda.synchronize()
            check(all(torch.equal(w, x) for w, x in zip(want, got)),
                  f"batch_penalty P={P} cluster={cs}: kernel differs from "
                  f"its plain version")
            out[("batch_penalty", P, cs or "auto")] = dict(
                ms=time_ms(kern, 50), plain_ms=plain_ms, max_abs_err=0,
                cluster=cs or fitness.penalty_cluster(pa, P, dev),
                bound_ms=b, bound_by=by)
    return out


def k2_device_times(pa, dev, timings):
    """K2's device time a launch at each shape and cluster size of
    compare_batch_penalty (torch.profiler, 20 launches each), added to
    its timings; run after the profile windows, each its own profiler
    session."""
    import torch
    from timetabling_ga_tpu_torch.k5_phases import device_us_per_launch
    from timetabling_ga_tpu_torch.ops import fitness, rooms
    E, T = pa.n_events, pa.n_slots
    for P in (4, 16, 256):
        g = torch.Generator(device=dev).manual_seed(8000 + P)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        rms = rooms.assign_rooms_plain(pa, slots)
        for cs in K2_CLUSTERS:
            def kern(cs=cs):
                return fitness.batch_penalty_kernel(pa, slots, rms, cs)
            timings[("batch_penalty", P, cs or "auto")]["device_us"] = \
                device_us_per_launch(kern, "batch_penalty")


def phase_lines(pa, dev):
    """K2's, K7's, K8's pre-pass's, K12's, K10's, K11's and the parallel
    matcher's (K9's own launch and K6) phase counters (k5_phases): each
    instrumented kernel checked equal to the regular one, then its cycles
    a launch (a round for K12, a step for K10) by phase."""
    from timetabling_ga_tpu_torch import k5_phases
    return [json.loads(x) for f in (k5_phases.k2_lines, k5_phases.k7_lines,
                                    k5_phases.k8e_lines, k5_phases.k12_lines,
                                    k5_phases.k10_lines,
                                    k5_phases.k11_lines, k5_phases.k9_lines)
            for x in f(pa, dev)]


def k9_device_times(timings, cases):
    """K9's own launch's device time at each of its timed shapes (its
    body runs inside K6 on the paths), from torch.profiler, added to its
    timings; `cases` maps each timing key to its kernel call. Run after
    the profile windows, each its own profiler session."""
    from timetabling_ga_tpu_torch.k5_phases import device_us_per_launch
    for key, kern in cases.items():
        timings[key]["device_us"] = device_us_per_launch(kern,
                                                         "parallel_rooms")


def random_ls_work(pa, st, draws, events):
    """{entry point: (bytes, integer operations)} of one K8 call. The
    pre-pass reads the draws' uniforms once and writes the events, and
    does a top-3 scan of E uniforms a row. The chain reads and writes the
    state once and reads the other draws, the events and the problem
    arrays once; per round and candidate it runs the K4 body on the
    bitsets (k4_body_ops; the candidate's events and new slots taken on
    the slots the call starts from), and its epilogue one full evaluation
    a row (penalty_ops); the prologue's att/occ/bitset build, the choice
    and the apply, which runs only on an accepted round, are left out, so
    the counts stay below what the kernels do."""
    from timetabling_ga_tpu_torch.ops import moves
    n_rounds, K, P = draws.mtype.shape
    E = pa.n_events
    reps = n_rounds * K
    md = moves.MoveDraws(draws.mtype.permute(2, 0, 1).reshape(-1),
                         draws.u.permute(2, 0, 1, 3).reshape(-1, E),
                         draws.t.permute(2, 0, 1).reshape(-1))
    evs, ns, _ = moves.sample_move(
        pa, md, st.slots.repeat_interleave(reps, 0))
    chain_b = (2 * nbytes(*st) + nbytes(draws.mtype, draws.t, events)
               + nbytes(pa.possible_u8, pa.live, pa.student_count,
                        pa.conflict_bits, pa.cap_rank, pa.dead,
                        pa.attends_u8, pa.ev_ptr, pa.ev_stu, pa.stu_ptr,
                        pa.stu_ev, pa.anchor_slots, pa.anchor_w))
    return {
        "random_ls_events": (nbytes(draws.u, events),
                             P * reps * E * OPS_TOP3),
        "random_ls": (chain_b, k4_body_ops(pa, st.slots,
                                           evs.view(P, reps, 3),
                                           ns.view(P, reps, 3))
                      + P * penalty_ops(pa))}


def bound(nb, ops):
    """(bound ms, "bytes" or "operations") of work moving `nb` bytes and
    doing `ops` integer operations on the card."""
    bytes_ms = nb / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_INT_OPS_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def compare_random_ls(pa, dev):
    """K8 against random_local_search_plain at the reference path's
    shape (-p 2: 125 rounds of 8 candidates) with P = 10 (its population)
    and 256, from random starts and from feasible ones, exactly, and its
    pre-pass against random_ls_events_plain, also on uniforms with ties;
    then each entry point and the plain search timed from the random
    start (the chain on the pre-pass's events), and K8 on one individual
    (its chain's floor)."""
    import torch
    from timetabling_ga_tpu_torch.ops import delta, fitness, rooms
    from timetabling_ga_tpu_torch.runtime import config, engine
    gc = engine.build_ga_config(config.parse_args(
        ["-i", TIM] + PATHS["reference"]))
    E, T = pa.n_events, pa.n_slots
    out = {}
    for P in (10, 256):
        g = torch.Generator(device=dev).manual_seed(5000 + P)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        st = delta.init_rows(pa, slots, rooms.assign_rooms_plain(pa, slots))
        draws = delta.make_ls_draws([g], P, gc.ls_steps, gc.ls_candidates,
                                    E, T, gc.p1, gc.p2, gc.p3, dev)
        w = witness_state(pa, P, g)
        feasible = delta.LSRows(w.slots, w.rooms, w.pen, w.hcv, w.scv)
        tied = draws._replace(u=(draws.u * 64).floor() / 64)
        for d, tag in ((draws, ""), (tied, " (tied uniforms)")):
            check(torch.equal(delta.random_ls_events_kernel(d),
                              delta.random_ls_events_plain(d)),
                  f"random_ls_events P={P}{tag}: kernel differs from its "
                  f"plain version")
        err = 0
        for start, s0 in (("random", st), ("feasible", feasible)):
            got = delta.random_local_search_kernel(pa, draws, s0)
            want = delta.random_local_search_plain(pa, draws, s0)
            torch.cuda.synchronize()
            for gt, wt in zip(got, want):
                check(gt.shape == wt.shape and gt.dtype == wt.dtype,
                      f"random_ls P={P} {start}: kernel output "
                      f"{tuple(gt.shape)} {gt.dtype} vs plain "
                      f"{tuple(wt.shape)} {wt.dtype}")
                err = max(err, int((gt.long() - wt.long()).abs().max()))
            check(err == 0, f"random_ls P={P} {start}: kernel differs from "
                            f"its plain version (max abs err {err})")
            full = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
            check(all(torch.equal(w, x) for w, x in zip(full, got[2:])),
                  f"random_ls P={P} {start}: the epilogue's terms are not "
                  f"batch_penalty_plain of its rows")
            FUSED_CHECKS["random_ls"] += 1
            if start == "random":
                check(bool((got.pen < s0.pen).all()),
                      f"random_ls P={P}: a row did not improve")
        events = delta.random_ls_events_kernel(draws)
        ms = time_ms(lambda: delta.random_ls_chain(pa, draws, st, events),
                     10)
        ev_ms = time_ms(lambda: delta.random_ls_events_kernel(draws), 10)
        plain_ms = time_ms(
            lambda: delta.random_local_search_plain(pa, draws, st), 1)
        ev_plain_ms = time_ms(lambda: delta.random_ls_events_plain(draws),
                              5)
        # one PyTorch call each: the stable descending sort is moves.top3
        # itself (exact, ties included); topk differs only where a row's
        # top three tie
        u2 = draws.u.view(-1, E)
        sort_ms = time_ms(lambda: torch.sort(u2, dim=-1, descending=True,
                                             stable=True), 5)
        topk_ms = time_ms(lambda: torch.topk(u2, 3, -1), 10)
        topk_equal = {tag: bool(torch.equal(
            torch.topk(d.u.view(-1, E), 3, -1).indices,
            torch.sort(d.u.view(-1, E), dim=-1, descending=True,
                       stable=True).indices[:, :3]))
            for d, tag in ((draws, "random"), (tied, "tied"))}
        one = delta.LSRows(*(x[:1] for x in st))
        d1 = delta.LSDraws(*(x[:, :, :1] for x in draws))
        ms1 = time_ms(lambda: delta.random_ls_chain(pa, d1, one,
                                                    events[:1]), 10)
        work = random_ls_work(pa, st, draws, events)
        b, by = bound(*work["random_ls"])
        out[("random_ls", P)] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=err,
            rounds=gc.ls_steps, candidates=gc.ls_candidates,
            chain_floor_ms=ms1, us_per_round=ms1 * 1e3 / gc.ls_steps,
            us_per_round_of_the_call=ms * 1e3 / gc.ls_steps,
            with_pre_pass_ms=ms + ev_ms,
            smem_bytes=delta.random_ls_smem_bytes(pa, gc.ls_candidates),
            feasible_rows=int((feasible.hcv == 0).sum()),
            int_ops=work["random_ls"][1], bound_ms=b, bound_by=by)
        b, by = bound(*work["random_ls_events"])
        out[("random_ls_events", P)] = dict(
            ms=ev_ms, plain_ms=ev_plain_ms, max_abs_err=0,
            rows=gc.ls_steps * gc.ls_candidates * P,
            int_ops=work["random_ls_events"][1], bound_ms=b, bound_by=by,
            library_ms=sort_ms, library="torch.sort(stable=True) (exact)",
            library_ms_topk=topk_ms, topk_equals_exact=topk_equal)
    return out


def full_eval_work(pa, rows, draws, events):
    """(bytes, integer operations) of one K12 call: the rows read and
    written once, the draws (move types, targets, the pre-pass's events)
    and the problem arrays read once; per round and candidate a
    relocation (three room argmins) and a full evaluation
    (penalty_ops). The copy, the exchange and the apply are left out."""
    n_rounds, K, P = draws.mtype.shape
    nb = (2 * nbytes(*rows) + nbytes(draws.mtype, draws.t, events)
          + penalty_bytes(pa) + nbytes(pa.cap_rank, pa.dead))
    ops = n_rounds * K * P * (penalty_ops(pa)
                              + 3 * pa.n_rooms * OPS_ROOM_KEY)
    return nb, ops


def compare_full_eval_ls(pa, dev):
    """K12 against batch_local_search_plain at the full-eval path's
    shape (-p 1: 25 rounds of 8 candidates, pop 10), at P = 256 and at K
    = 12 (more candidates than the cluster's 8 CTAs), from random starts
    and from feasible ones, exactly, its terms also against
    batch_penalty_plain of its rows; then its chain timed on the
    pre-pass's events, the plain search, and one individual (the chain's
    floor)."""
    import torch
    from timetabling_ga_tpu_torch.ops import delta, fitness, local_search
    from timetabling_ga_tpu_torch.ops import rooms
    from timetabling_ga_tpu_torch.runtime import config, engine
    gc = engine.build_ga_config(config.parse_args(
        ["-i", TIM] + PATHS["full-eval"]))
    E, T = pa.n_events, pa.n_slots
    out = {}
    for P, K in ((gc.pop_size, gc.ls_candidates), (256, gc.ls_candidates),
                 (gc.pop_size, 12)):
        g = torch.Generator(device=dev).manual_seed(5500 + P + K)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        st = delta.init_rows(pa, slots, rooms.assign_rooms_plain(pa, slots))
        draws = delta.make_ls_draws([g], P, gc.ls_steps, K, E, T, gc.p1,
                                    gc.p2, gc.p3, dev)
        w = witness_state(pa, P, g)
        feasible = delta.LSRows(w.slots, w.rooms, w.pen, w.hcv, w.scv)
        err = 0
        for start, s0 in (("random", st), ("feasible", feasible)):
            got = local_search.batch_local_search_kernel(pa, draws, s0)
            want = local_search.batch_local_search_plain(pa, draws, s0)
            torch.cuda.synchronize()
            for gt, wt in zip(got, want):
                check(gt.shape == wt.shape and gt.dtype == wt.dtype,
                      f"full_eval_ls P={P} K={K} {start}: kernel output "
                      f"{tuple(gt.shape)} {gt.dtype} vs plain "
                      f"{tuple(wt.shape)} {wt.dtype}")
                err = max(err, int((gt.long() - wt.long()).abs().max()))
            check(err == 0, f"full_eval_ls P={P} K={K} {start}: kernel "
                            f"differs from its plain version (max abs err "
                            f"{err})")
            full = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
            check(all(torch.equal(x, y) for x, y in zip(full, got[2:])),
                  f"full_eval_ls P={P} K={K} {start}: its terms are not "
                  f"batch_penalty_plain of its rows")
            FUSED_CHECKS["full_eval_ls"] += 1
            if start == "random":
                check(bool((got.pen < s0.pen).all()),
                      f"full_eval_ls P={P} K={K}: a row did not improve")
        events = delta.random_ls_events_kernel(draws)
        ms = time_ms(lambda: local_search.full_eval_ls_chain(
            pa, draws, st, events), 10)
        plain_ms = time_ms(
            lambda: local_search.batch_local_search_plain(pa, draws, st), 1)
        one = delta.LSRows(*(x[:1] for x in st))
        d1 = delta.LSDraws(*(x[:, :, :1] for x in draws))
        ms1 = time_ms(lambda: local_search.full_eval_ls_chain(
            pa, d1, one, events[:1]), 10)
        b, by = bound(*full_eval_work(pa, st, draws, events))
        key = ("full_eval_ls", P) if K == gc.ls_candidates else \
            ("full_eval_ls", P, K)
        out[key] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=err, rounds=gc.ls_steps,
            candidates=K, cluster=local_search.full_eval_cluster(K),
            chain_floor_ms=ms1, us_per_round=ms1 * 1e3 / gc.ls_steps,
            us_per_round_of_the_call=ms * 1e3 / gc.ls_steps,
            smem_bytes=local_search.full_eval_ls_smem_bytes(pa, K),
            feasible_rows=int((feasible.hcv == 0).sum()),
            int_ops=full_eval_work(pa, st, draws, events)[1], bound_ms=b,
            bound_by=by)
    return out


def profile_phases(pa, pa05, dev):
    """A short torch.profiler window per phase: one warm population init
    (pop 16: K1, K2, K7), one warm repair generation (pop 16), one warm post-phase sweep pass (pop 4), one warm
    reference-path generation (pop 10, -p 2), one kick of the post
    population (3 moves: K6 relocate), one LAHC launch of the lahc path's
    walkers (256 steps) and two NSGA-II generations of the nsga path on
    comp05s (repair, pop 16; post phase, pop 4, from feasible rows). For
    each: wall time, device time summed over CUDA
    events, the device's idle share, device launches and wall per sweep
    pass, device time per launch of each hand kernel and the kernels
    taking the most device time. Full tables go to build/chip_smoke/."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.obs.prof import kernel_entry
    from timetabling_ga_tpu_torch.ops import delta, ga, lahc, sweep
    from timetabling_ga_tpu_torch.parallel import islands
    from timetabling_ga_tpu_torch.runtime import config, engine
    cfg = config.parse_args(["-i", TIM]).apply_tuned_defaults(pa.n_events)
    repair = engine.build_ga_config(cfg)
    post = engine.build_post_config(cfg, repair)
    ref = engine.build_ga_config(config.parse_args(
        ["-i", TIM] + PATHS["reference"]))
    full = engine.build_ga_config(config.parse_args(
        ["-i", TIM] + PATHS["full-eval"]))
    cfg05 = config.parse_args(["-i", TIM05] + PATHS["nsga"]
                              ).apply_tuned_defaults(pa05.n_events)
    nsga_cfg = engine.build_ga_config(cfg05)
    cfgl = config.parse_args(["-i", TIM] + PATHS["lahc"]
                             ).apply_tuned_defaults(pa.n_events)
    gens = engine.island_generators(dev, 7, 0, 1)
    windows = [("init", repair.pop_size, "one population init",
                lambda gens=gens: islands.init_island_population(
                    pa, gens, repair.pop_size))]
    for name, gacfg in (("repair", repair), ("reference", ref),
                        ("full-eval", full)):
        gens = engine.island_generators(dev, 7, 0, 1)
        st = islands.init_island_population(pa, gens, gacfg.pop_size)
        windows.append((name, gacfg.pop_size, "one generation",
                        lambda st=st, gens=gens, gacfg=gacfg:
                        islands.run_epochs(pa, gens, st, gacfg, 1, 1)))
    gens = engine.island_generators(dev, 7, 0, 1)
    st = islands.init_island_population(pa, gens, post.pop_size)
    ls = delta.init_state(pa, st.slots, st.rooms)
    draws_fn = ga.sweep_draws_fn(gens, post.pop_size, pa, post)
    windows.insert(2, ("post", post.pop_size, "one sweep pass",
                       lambda: sweep.sweep_pass(
                           pa, draws_fn(0), ls, post.ls_swap_block,
                           post.ls_block_events, post.ls_sideways,
                           post.ls_hot_k, post.p3)))
    windows.append(("kick", post.pop_size, "one kick (3 moves)",
                    lambda: islands.kick(pa, gens, st, post, 3)))
    w = witness_state(pa, post.pop_size, torch.Generator(
        device=dev).manual_seed(11))
    lstate = lahc.init_lahc(pa, w.slots, w.rooms, cfgl.post_lahc)
    windows.append(("lahc", post.pop_size, "one LAHC launch (256 steps)",
                    lambda: islands.lahc_run(pa, gens, lstate, post, 256,
                                             cfgl.post_lahc_k)))
    gens05 = engine.island_generators(dev, 7, 0, 1)
    st05 = islands.init_island_population(pa05, gens05, nsga_cfg.pop_size)
    windows.append(("nsga", nsga_cfg.pop_size,
                    "one generation (comp05s, --nsga2 --rooms-mode "
                    "parallel)",
                    lambda: islands.run_epochs(pa05, gens05, st05, nsga_cfg,
                                               1, 1)))
    post05 = engine.build_post_config(cfg05, nsga_cfg)
    w05 = witness_state(pa05, post05.pop_size, torch.Generator(
        device=dev).manual_seed(12), WITNESS05)
    st05p = ga.evaluate(pa05, w05.slots, w05.rooms)
    windows.append(("nsga-post", post05.pop_size,
                    "one post-phase generation (comp05s, --nsga2 "
                    "--rooms-mode parallel)",
                    lambda: islands.run_epochs(pa05, gens05, st05p, post05,
                                               1, 1)))
    out = []
    for name, pop, window, work in windows:
        work()                                              # warm-up
        torch.cuda.synchronize()
        # a session whose trace lacks a hand kernel the window launched
        # (the profiler drops events now and then) is taken again, up to
        # three times
        for _ in range(3):
            before = dict(kernels.LAUNCHES)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                work()
                torch.cuda.synchronize()
                wall_ms = (time.monotonic() - t0) * 1e3
            passes = kernels.LAUNCHES["sweep_pass"] - before["sweep_pass"]
            averages = prof.key_averages()
            rows = []
            per_launch = {}
            for ev in averages:
                if getattr(ev, "device_type", None) != DeviceType.CUDA:
                    continue
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = ev.self_cuda_time_total
                rows.append((dev_us, ev.count, ev.key[:60]))
                k = kernel_entry(ev.key)
                if k in KERNELS and ev.count:
                    per_launch[k] = dev_us / ev.count
            if all(k in per_launch for k in KERNELS
                   if kernels.LAUNCHES[k] > before[k]):
                break
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows) / 1e3
        launches = sum(r[1] for r in rows)
        with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
            f.write(averages.table(sort_by="self_cpu_time_total",
                                   row_limit=40))
        out.append({"config": name, "pop": pop, "window": window,
                    "sweep_passes": passes, "wall_ms": wall_ms,
                    "device_ms": device_ms,
                    "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
                    "device_launches": launches,
                    "launches_per_pass": launches / max(passes, 1),
                    "wall_ms_per_pass": wall_ms / max(passes, 1),
                    "kernel_us_per_launch": per_launch,
                    "top": [[k, c, us / 1e3] for us, c, k in rows[:8]]})
    return out


def k13_trace(L, T, seed, dev, sentinels=True):
    """(L, T, 2) int32 per-generation (hcv, scv) traces with planted ties
    and long runs of equal rows: a falling staircase with repeats, rows
    equal to an earlier best, random rows and, unless `sentinels` is
    False (the timed traces, like a run's), a few sentinel rows (the
    CPU tests' `_trace`)."""
    import numpy as np
    import torch
    from timetabling_ga_tpu_torch.parallel import islands
    g = np.random.default_rng(seed)
    h = np.maximum(0, 6 - np.cumsum(g.random((L, T)) < 0.05, 1))
    s = np.maximum(0, 400 - np.cumsum(g.integers(0, 3, (L, T)), 1))
    run = g.random((L, T)) < 0.5
    for t in range(1, T):
        h[:, t] = np.where(run[:, t], h[:, t - 1], h[:, t])
        s[:, t] = np.where(run[:, t], s[:, t - 1], s[:, t])
    wild = g.random((L, T)) < 0.1
    h = np.where(wild, g.integers(0, 9, (L, T)), h)
    s = np.where(wild, g.integers(0, 900, (L, T)), s)
    sent = (g.random((L, T)) < 0.02) & sentinels
    h = np.where(sent, islands.SENTINEL, h)
    s = np.where(sent & (g.random((L, T)) < 0.5), islands.SENTINEL, s)
    return torch.tensor(np.stack([h, s], -1), dtype=torch.int32,
                        device=dev)


def k13_moments_err(got, want, rep, what):
    """The stated tolerance of K13's moments against the plain version:
    min and max exact, mean within a relative 1e-6, var within
    4 n 2^-24 mean(rep^2) over the n values `rep` of each row. Returns
    the largest absolute difference."""
    import numpy as np
    got = np.asarray(got, np.float64).reshape(-1, 4)
    want = np.asarray(want, np.float64).reshape(-1, 4)
    rep = np.asarray(rep, np.float64).reshape(got.shape[0], -1)
    tol = 4 * rep.shape[1] * 2.0 ** -24 * (rep * rep).mean(1)
    check((got[:, 2:] == want[:, 2:]).all(), f"{what}: min/max differ")
    check((np.abs(got[:, 0] - want[:, 0])
           <= 1e-6 * np.abs(want[:, 0])).all(), f"{what}: mean differs")
    check((np.abs(got[:, 1] - want[:, 1]) <= tol).all(),
          f"{what}: var differs beyond 4 n 2^-24 mean(rep^2)")
    return float(np.abs(got - want).max())


def k13_equal(trace, mode, what):
    """compress_trace against its plain version: events and counts
    exactly, moments within the tolerance; (plain leaf, max abs err)."""
    import numpy as np
    from timetabling_ga_tpu_torch.parallel import islands
    got = islands.compress_trace_kernel(trace, mode).cpu().numpy()
    want = islands.compress_trace_plain(trace, mode).cpu().numpy()
    check(got.shape == want.shape, f"{what}: leaf shape")
    K = min(trace.shape[1], islands.TRACE_DELTAS_CAP)
    check((got[:, :3 * K + 1] == want[:, :3 * K + 1]).all(),
          f"{what}: events or counts differ")
    err = 0.0
    if mode == "stats":
        t = trace.cpu()
        err = k13_moments_err(
            got[:, 3 * K + 1:].view(np.float32),
            want[:, 3 * K + 1:].view(np.float32),
            islands.reported_f32(t[..., 0], t[..., 1]).numpy(), what)
    return want, err


def compare_trace_compress(dev):
    """K13 against its plain version: compress_trace in both modes over
    K13_L x K13_T, each trace at the caps K13_CAPS and at its islands'
    least and largest improvement counts (K below, equal to and above),
    and moment_rows on (L, n) rows; then both timed at K13_TIMED.
    Returns (timings, cases compared, cases with an island over its
    cap)."""
    import torch
    from timetabling_ga_tpu_torch.parallel import islands
    saved = islands.TRACE_DELTAS_CAP
    n = over = 0
    try:
        for mode in ("deltas", "stats"):
            for L in K13_L:
                for T in K13_T:
                    tr = k13_trace(L, T, L * T, dev)
                    islands.TRACE_DELTAS_CAP = T
                    counts = k13_equal(tr, mode, f"compress_trace L={L} "
                                       f"T={T}")[0][:, 3 * T]
                    for cap in sorted({*K13_CAPS, int(counts.min()),
                                       int(counts.max())}):
                        islands.TRACE_DELTAS_CAP = cap
                        what = f"compress_trace {mode} L={L} T={T} K={cap}"
                        leaf = k13_equal(tr, mode, what)[0]
                        check((leaf[:, 3 * min(T, cap)] == counts).all(),
                              f"{what}: count changed with the cap")
                        n += 1
                        over += bool((counts > min(T, cap)).any())
        check(over > 0, "compress_trace: no case overflowed its cap")
        for L in K13_L:
            for pop in (1, 4, 10, 16, 64):
                tr = k13_trace(L, pop, 7 * pop + L, dev)
                h, s = tr[..., 0].contiguous(), tr[..., 1].contiguous()
                k13_moments_err(
                    islands.moment_rows_kernel(h, s).cpu().numpy()
                    .view("float32").T,
                    islands.moment_rows_plain(h, s).cpu().numpy()
                    .view("float32").T,
                    islands.reported_f32(h, s).cpu().numpy(),
                    f"moment_rows L={L} n={pop}")
                n += 1
        islands.TRACE_DELTAS_CAP = 64
        out = {}
        L, T = K13_TIMED["compress_trace"]
        tr = k13_trace(L, T, 1, dev, sentinels=False)
        _, err = k13_equal(tr, "stats", "compress_trace timed")
        W = islands.trace_leaf_width(T, "stats")
        b, by = bound(L * T * 2 * 4 + L * W * 4, 0)
        out[("compress_trace", L, T)] = dict(
            ms=time_ms(lambda: islands.compress_trace_kernel(tr, "stats"),
                       200),
            plain_ms=time_ms(
                lambda: islands.compress_trace_plain(tr, "stats"), 20),
            max_abs_err=err, bound_ms=b, bound_by=by, library_ms=None)
        L, m = K13_TIMED["moment_rows"]
        tr = k13_trace(L, m, 2, dev, sentinels=False)
        h, s = tr[..., 0].contiguous(), tr[..., 1].contiguous()
        err = k13_moments_err(
            islands.moment_rows_kernel(h, s).cpu().numpy().view("float32").T,
            islands.moment_rows_plain(h, s).cpu().numpy().view("float32").T,
            islands.reported_f32(h, s).cpu().numpy(), "moment_rows timed")
        b, by = bound(2 * L * m * 4 + 4 * L * 4, 0)
        out[("moment_rows", L, m)] = dict(
            ms=time_ms(lambda: islands.moment_rows_kernel(h, s), 200),
            plain_ms=time_ms(lambda: islands.moment_rows_plain(h, s), 20),
            max_abs_err=err, bound_ms=b, bound_by=by, library_ms=None)
        torch.cuda.synchronize()
        return out, n, over
    finally:
        islands.TRACE_DELTAS_CAP = saved


def k13_device_times(dev, timings):
    """K13's device time a launch at its timed shapes (torch.profiler),
    added to its timings; run after the profile windows."""
    from timetabling_ga_tpu_torch.k5_phases import device_us_per_launch
    from timetabling_ga_tpu_torch.parallel import islands
    L, T = K13_TIMED["compress_trace"]
    tr = k13_trace(L, T, 1, dev, sentinels=False)
    timings[("compress_trace", L, T)]["device_us"] = device_us_per_launch(
        lambda: islands.compress_trace_kernel(tr, "stats"), "compress_trace")
    L, m = K13_TIMED["moment_rows"]
    tr = k13_trace(L, m, 2, dev, sentinels=False)
    h, s = tr[..., 0].contiguous(), tr[..., 1].contiguous()
    timings[("moment_rows", L, m)]["device_us"] = device_us_per_launch(
        lambda: islands.moment_rows_kernel(h, s), "moment_rows")


def k14_ops_case(L, pop, g, dev):
    """One generation's flags and scores for quality_ops: parents within
    each island, penalties in a small range (ties are no win), the
    sweep's counts and an accumulator already holding counts."""
    import torch
    P, i32 = L * pop, torch.int32

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=i32)
    base = torch.arange(P, device=dev, dtype=i32) // pop * pop
    return dict(do_x=torch.rand(P, generator=g, device=dev) < 0.6,
                do_m=torch.rand(P, generator=g, device=dev) < 0.5,
                parent=(base + ints(pop, (P,))).to(i32),
                child_pen=ints(5, (P,)), parent_pen=ints(5, (P,)),
                sweep_ops=ints(40, (P, 3)), acc=ints(100, (L, 7)), L=L)


def k14_div_case(E, L, pop, g, dev):
    """(slots, penalty, scv) of L islands: slots with repeated values (so
    pairs can agree), penalties mixing the feasible and infeasible
    domains (to ~9e6, past float32's 2^24), scv in a small range."""
    import torch
    P, i32 = L * pop, torch.int32
    base = torch.randint(0, 45, (P, E), generator=g, device=dev, dtype=i32)
    same = torch.rand((P, E), generator=g, device=dev) < 0.6
    slots = torch.where(same, base[:1], base)
    hcv = torch.randint(0, 9, (P,), generator=g, device=dev, dtype=i32) * (
        torch.rand(P, generator=g, device=dev) < 0.5)
    scv = torch.randint(0, 200, (P,), generator=g, device=dev, dtype=i32)
    pen = torch.where(hcv > 0, 1_000_000 * hcv + scv + 7, scv).to(i32)
    return slots, pen, scv


def k14_moments_err(got, want, x, what):
    """The stated tolerance of div_stats' moments (float32 mean, var, min,
    max of the float32 values x by JAX's min-shifted formula): min and
    max exact, the mean within a relative 1e-6 of the shifted mean plus
    one float32 spacing of the mean, the var within 4 n 2^-24 mean(c^2),
    c = x - min. Returns the largest absolute difference."""
    import numpy as np
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    x = np.asarray(x, np.float32).astype(np.float64)
    c = x - x.min()
    check((got[2:] == want[2:]).all(), f"{what}: min/max differ")
    tol = 1e-6 * abs(c.mean()) + float(np.spacing(np.abs(want[0])))
    check(abs(float(got[0]) - float(want[0])) <= tol,
          f"{what}: mean {got[0]} vs {want[0]}")
    tol = 4 * len(x) * 2.0 ** -24 * (c * c).mean()
    check(abs(float(got[1]) - float(want[1])) <= tol,
          f"{what}: var {got[1]} vs {want[1]}")
    return float(np.abs(got.astype(np.float64) - want).max())


def k14_div_equal(pa, slots, pen, scv, L, what):
    """div_stats against its plain version; returns the max abs err of
    the float values (0 on the exact columns)."""
    import numpy as np
    from timetabling_ga_tpu_torch.parallel import islands
    args = (pa.event_mask, slots, pen, scv, L)
    got = islands.div_stats_kernel(*args).cpu().numpy()
    want = islands.div_stats_plain(*args).cpu().numpy()
    check(got.shape == want.shape, f"{what}: shape")
    check((got[:, 8] == want[:, 8]).all(), f"{what}: Hamming differs")
    pop = pen.shape[0] // L
    err = 0.0
    for i in range(L):
        r = slice(i * pop, (i + 1) * pop)
        gf, wf = got[i].view(np.float32), want[i].view(np.float32)
        err = max(err, k14_moments_err(gf[:4], wf[:4],
                                       pen[r].float().cpu().numpy(), what),
                  k14_moments_err(gf[4:8], wf[4:8],
                                  scv[r].float().cpu().numpy(), what))
    return err


def quality_ops_work(L, pop):
    """(bytes, integer operations) of one quality_ops call (work.py)."""
    from timetabling_ga_tpu_torch import work
    w = work.quality_ops(L, pop)
    return w.bytes, w.ops


def div_stats_work(L, pop, E):
    """(bytes, integer and float operations) of one div_stats call
    (work.py)."""
    from timetabling_ga_tpu_torch import work
    from timetabling_ga_tpu_torch.obs.quality import HAMMING_PAIRS
    w = work.div_stats(L, pop, E, HAMMING_PAIRS)
    return w.bytes, w.ops


def compare_quality(problem, pa, dev):
    """K14 and the new outputs of K5, K6 and K7 against their plain
    versions (the quality telemetry): quality_ops and div_stats over
    K14_L x K14_POP on comp01s and a padded copy; K5's accepted-move
    counts at the main path's repair (P = 16) and post (P = 4) passes
    from random and feasible starts; K6's base parents at P = 16 and 256
    in the greedy and crowded tournaments and with the parallel matcher;
    K7's migrate gain at L = 1, 2, 4, 16 x pop 2, 3, 16 (E = 400): the
    new outputs exact, every other output equal to the call without
    them. Then quality_ops and div_stats timed at K14_TIMED, and each
    new output's call against the same call without it. Returns
    (timings, cases compared, new-output rows)."""
    import torch
    from timetabling_ga_tpu_torch.ops import delta, ga, nsga, rooms, sweep
    from timetabling_ga_tpu_torch.parallel import islands
    from timetabling_ga_tpu_torch.runtime import config, engine
    g = torch.Generator(device=dev).manual_seed(9000)
    cases = 0
    padded = padded_arrays(problem, dev)
    for name, pa_ in (("comp01s", pa), ("padded", padded)):
        for L in K14_L:
            for pop in K14_POP:
                what = f"quality_ops {name} L={L} pop={pop}"
                c = k14_ops_case(L, pop, g, dev)
                for sw in (c["sweep_ops"], None):
                    c2 = {**c, "sweep_ops": sw}
                    want = ga.quality_ops_plain(**{**c2,
                                                   "acc": c["acc"].clone()})
                    got = ga.quality_ops_kernel(**{**c2,
                                                   "acc": c["acc"].clone()})
                    check(torch.equal(want, got), f"{what}: differs")
                slots, pen, scv = k14_div_case(pa_.n_events, L, pop, g, dev)
                k14_div_equal(pa_, slots, pen, scv, L,
                              f"div_stats {name} L={L} pop={pop}")
                cases += 2
    # K5's counts at the main path's repair and post passes
    cfg = config.parse_args(["-i", TIM]).apply_tuned_defaults(pa.n_events)
    repair = engine.build_ga_config(cfg)
    post = engine.build_post_config(cfg, repair)
    rows_out = []
    for phase, P, gc in (("repair", 16, repair),
                         ("post", post.pop_size, post)):
        E, T = pa.n_events, pa.n_slots
        args = (gc.ls_swap_block, gc.ls_block_events, gc.ls_sideways,
                gc.ls_hot_k, gc.p3)
        sh = sweep.sweep_shape(E, T, *args[:2], gc.ls_hot_k, gc.p3)
        slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                              dtype=torch.int32)
        st = delta.init_state(pa, slots, rooms.assign_rooms_plain(pa, slots))
        draws = sweep.make_sweep_draws([g], P, sh, E, gc.ls_sideways, dev)
        ops0 = torch.randint(0, 4, (P, 3), generator=g, device=dev,
                             dtype=torch.int32)
        n = 0
        for start, s0 in (("random", st), ("feasible",
                                            witness_state(pa, P, g))):
            want = sweep.sweep_pass_plain(pa, draws, s0, *args, ops=ops0)
            got = sweep.sweep_pass_kernel(pa, draws, s0, *args, ops=ops0)
            off = sweep.sweep_pass_kernel(pa, draws, s0, *args)
            what = f"sweep_pass ops {phase} P={P} {start}"
            check(torch.equal(got[3], want[2]), f"{what}: counts differ")
            check(all(torch.equal(a, b) for a, b in zip(got[0], off[0]))
                  and all(torch.equal(a, b) for a, b in zip(got[1:3],
                                                            off[1:3])),
                  f"{what}: the counts changed the pass")
            n += int((want[2] - ops0).sum())
            cases += 1
        check(n > 0, f"sweep_pass ops {phase}: no move counted")
        rows_out.append({"new_output": "sweep_pass ops", "shape": [phase, P],
                         "moves_counted": n,
                         "ms": time_ms(lambda: sweep.sweep_pass_kernel(
                             pa, draws, st, *args, ops=ops0), 5),
                         "ms_off": time_ms(lambda: sweep.sweep_pass_kernel(
                             pa, draws, st, *args), 5)})
    # K6's base parents
    E, R, T = pa.n_events, pa.n_rooms, pa.n_slots
    for P in (16, 256):
        L = P // 16
        par = ga.evaluate(pa, torch.randint(
            0, T, (P, E), generator=g, device=dev, dtype=torch.int32),
            torch.randint(0, R, (P, E), generator=g, device=dev,
                          dtype=torch.int32), L)
        for mode, mo in (("greedy", False), ("crowded", True),
                         ("parallel", False)):
            rm = "parallel" if mode == "parallel" else "scan"
            gc = ga.GAConfig(pop_size=16, p3=0.2, rooms_mode=rm,
                             multi_objective=mo)
            bd = ga.make_breed_draws([g] * L, 16, E, T, gc, dev)
            stats = nsga.rank_crowd(par.hcv, par.scv, L) if mo else None
            got, parent = ga.make_children_kernel(pa, bd, par, L, stats, rm,
                                                  with_parent=True)
            off = ga.make_children_kernel(pa, bd, par, L, stats, rm)
            want, wp = ga.make_children_plain(pa, bd, par, gc, L, stats,
                                              with_parent=True)
            what = f"breed parents {mode} P={P}"
            check(torch.equal(parent, wp), f"{what}: parents differ")
            check(all(torch.equal(a, b) and torch.equal(a, c)
                      for a, b, c in zip(got, off, want)),
                  f"{what}: the parents changed the children")
            cases += 1
            if P == 16 and mode == "greedy":
                rows_out.append({
                    "new_output": "breed parent", "shape": [mode, P],
                    "ms": time_ms(lambda: ga.make_children_kernel(
                        pa, bd, par, L, stats, rm, with_parent=True), 20),
                    "ms_off": time_ms(lambda: ga.make_children_kernel(
                        pa, bd, par, L, stats, rm), 20)})
    # K7's migrate gain
    for L in (1, 2, 4, 16):
        for pop in (2, 3, 16):
            P = L * pop
            pen = torch.randint(0, 3, (P,), generator=g, device=dev,
                                dtype=torch.int32)
            isl = torch.arange(P, device=dev) // pop
            pen = (pen + 3 * (L - 1 - isl)).to(torch.int32)
            sc = torch.randint(0, 3, (P,), generator=g, device=dev,
                               dtype=torch.int32)
            sl = torch.randint(0, T, (P, E), generator=g, device=dev,
                               dtype=torch.int32)
            st = ga.survivors_plain(ga.PopState(sl, sl.flip(1), pen,
                                                pen.clone(), sc), groups=L)
            got, gain = islands.migrate_kernel(st, L, return_gain=True)
            off = islands.migrate_kernel(st, L)
            want, wg = islands.migrate_plain(st, L, return_gain=True)
            what = f"migrate gain L={L} pop={pop}"
            check(torch.equal(gain, wg), f"{what}: gain differs")
            check(all(torch.equal(a, b) and torch.equal(a, c)
                      for a, b, c in zip(got, off, want)),
                  f"{what}: the gain changed the exchange")
            check((int(gain.sum()) > 0) == (L > 1 and pop >= 3),
                  f"{what}: gain {gain.tolist()}")
            cases += 1
            if (L, pop) == (1, 16):
                rows_out.append({
                    "new_output": "migrate gain", "shape": [L, pop],
                    "ms": time_ms(lambda: islands.migrate_kernel(
                        st, L, return_gain=True), 50),
                    "ms_off": time_ms(lambda: islands.migrate_kernel(
                        st, L), 50)})
    # K14 timed at the main path's repair population
    L, pop = K14_TIMED
    c = k14_ops_case(L, pop, g, dev)
    nb, ops = quality_ops_work(L, pop)
    b, by = bound(nb, ops)
    out = {("quality_ops", pop): dict(
        ms=time_ms(lambda: ga.quality_ops_kernel(**c), 200),
        plain_ms=time_ms(lambda: ga.quality_ops_plain(**c), 20),
        max_abs_err=0, bound_ms=b, bound_by=by, library_ms=None,
        bytes=nb, int_ops=ops)}
    slots, pen, scv = k14_div_case(pa.n_events, L, pop, g, dev)
    err = k14_div_equal(pa, slots, pen, scv, L, "div_stats timed")
    nb, ops = div_stats_work(L, pop, pa.n_events)
    b, by = bound(nb, ops)
    args = (pa.event_mask, slots, pen, scv, L)
    out[("div_stats", pop)] = dict(
        ms=time_ms(lambda: islands.div_stats_kernel(*args), 200),
        plain_ms=time_ms(lambda: islands.div_stats_plain(*args), 20),
        max_abs_err=err, bound_ms=b, bound_by=by, library_ms=None,
        bytes=nb, int_ops=ops)
    torch.cuda.synchronize()
    return out, cases, rows_out


def k14_device_times(pa, dev, timings):
    """K14's device time a launch at its timed shape (torch.profiler),
    added to its timings; run after the profile windows."""
    import torch
    from timetabling_ga_tpu_torch.k5_phases import device_us_per_launch
    from timetabling_ga_tpu_torch.ops import ga
    from timetabling_ga_tpu_torch.parallel import islands
    L, pop = K14_TIMED
    g = torch.Generator(device=dev).manual_seed(9100)
    c = k14_ops_case(L, pop, g, dev)
    timings[("quality_ops", pop)]["device_us"] = device_us_per_launch(
        lambda: ga.quality_ops_kernel(**c), "quality_ops")
    slots, pen, scv = k14_div_case(pa.n_events, L, pop, g, dev)
    timings[("div_stats", pop)]["device_us"] = device_us_per_launch(
        lambda: islands.div_stats_kernel(pa.event_mask, slots, pen, scv, L),
        "div_stats")


def itc_problem():
    """The ITC-like 400/10/10/200 instance of the lane phase and the
    serve path (the port's generator, seed 4): comp01s's bucket."""
    from timetabling_ga_tpu_torch.problem import itc_like_instance
    return itc_like_instance(4, n_events=400, n_rooms=10, n_features=10,
                             n_students=200)


def cut_problem(problem, n_events):
    """`problem` restricted to its first `n_events` events."""
    from timetabling_ga_tpu_torch.problem import derive
    return derive(n_events, problem.n_rooms, problem.n_features,
                  problem.n_students, problem.room_size,
                  problem.attends[:, :n_events], problem.room_features,
                  problem.event_features[:n_events])


def lane_problems(problem, dev, anchored=False):
    """The lane phase's four mixed lanes (LANE_POP's comment), padded
    into comp01s's bucket, as a LaneProblems on `dev`; with `anchored`,
    the first three carry an edit's anchor (random slots, weights 1-3 on
    every event but each eighth, which is new: weight 0) and the fourth
    none."""
    import dataclasses
    import numpy as np
    from timetabling_ga_tpu_torch.problem import LaneProblems
    from timetabling_ga_tpu_torch.serve import bucket
    itc = itc_problem()
    lanes = [problem, itc, cut_problem(problem, 360), cut_problem(itc, 300)]
    if anchored:
        g = np.random.default_rng(8000)
        for i in range(3):
            E = lanes[i].n_events
            w = g.integers(1, 4, E).astype(np.int32)
            w[::8] = 0
            lanes[i] = dataclasses.replace(
                lanes[i], anchor_w=w, anchor_slots=g.integers(
                    0, lanes[i].n_slots, E).astype(np.int32))
    keys = {bucket.bucket_key(p) for p in lanes}
    check(keys == {(512, 16, 16, 256, 5, 9)},
          f"lane phase: the lanes are not in comp01s's bucket: {keys}")
    return LaneProblems([bucket.pad_problem(p).device_arrays(dev)
                         for p in lanes])


def lane_work(lp, par, draws, rows, ls, events):
    """{form: (bytes, integer operations)} of one K6 and one K8 chain
    call over the lanes, each lane's problem arrays read once and its
    rows' work counted on its own problem, as kernel_cases and
    random_ls_work count them for one problem."""
    from timetabling_ga_tpu_torch.ops import delta
    L = len(lp)
    pop = par.slots.shape[0] // L
    E, R = lp.n_events, lp.n_rooms
    k6_b = (nbytes(par.slots, par.rooms, par.penalty, par.scv, *draws[:5],
                   *draws.move) + 2 * par.slots.numel() * 4
            + 3 * par.penalty.numel() * 4 + lp.table.numel() * 8)
    k6_ops = 0
    k8_b = k8_ops = 0
    top3_ops = E * OPS_TOP3 + 3 * R * OPS_ROOM_KEY
    for lane, pa in enumerate(lp.pas):
        r = slice(lane * pop, (lane + 1) * pop)
        n_x = int(draws.do_x[r].sum())
        n_m = int(draws.do_m[r].sum())
        k6_b += (nbytes(pa.possible_u8, pa.live, pa.cap_rank, pa.dead,
                        pa.room_order) + penalty_bytes(pa))
        k6_ops += (n_x * E * (R * OPS_ROOM_KEY + 2) + (pop - n_x) * E * 3
                   + n_m * top3_ops + pop * 2 * 5 * OPS_LEX
                   + pop * penalty_ops(pa))
        b, ops = random_ls_work(
            pa, delta.LSRows(*(x[r] for x in rows)),
            delta.LSDraws(*(x[:, :, r] for x in ls)), events[r])["random_ls"]
        k8_b += b
        k8_ops += ops
    return {"breed_lanes": (k6_b, k6_ops),
            "random_ls_lanes": (k8_b + lp.table.numel() * 8, k8_ops)}


def compare_lane_kernels(problem, dev):
    """K6 (both tournament modes, the serve generation's greedy matcher)
    and K8's chain with the lane table against their lane-looped plain
    versions on four mixed lanes of LANE_POP rows, exactly (and the
    chain's terms against batch_penalty_plain of each lane's rows on its
    own problem); then ms a call, the plain ms, and device us a launch
    with the table and without it (every lane on comp01s's padded
    problem) at the same shapes."""
    import torch
    from timetabling_ga_tpu_torch.k5_phases import device_us_per_launch
    from timetabling_ga_tpu_torch.ops import delta, fitness, ga, nsga
    from timetabling_ga_tpu_torch.runtime import config
    from timetabling_ga_tpu_torch.serve.scheduler import serve_ga_config
    lp = lane_problems(problem, dev)
    L, pop = len(lp), LANE_POP
    cfg = serve_ga_config(config.ServeConfig())
    g = torch.Generator(device=dev).manual_seed(7000)

    def rand(n):
        return torch.randint(0, n, (pop, lp.n_events), generator=g,
                             device=dev, dtype=torch.int32)
    # each lane's parents: random slots and rooms, scored and sorted on
    # its own problem
    par = ga.PopState(*(torch.cat(x) for x in zip(*(
        ga.evaluate(pa, rand(pa.n_slots), rand(pa.n_rooms))
        for pa in lp.pas))))
    draws = ga.make_breed_draws([g] * L, pop, lp.n_events, lp.n_slots, cfg,
                                dev)
    mo = nsga.rank_crowd_plain(par.hcv, par.scv, L)
    for tag, m in (("penalty", None), ("crowded", mo)):
        got = ga.make_children_kernel(lp, draws, par, L, m)
        want = ga.make_children_lanes_plain(lp, draws, par, cfg, m)
        torch.cuda.synchronize()
        check(all(torch.equal(w, x) for w, x in zip(want, got)),
              f"breed_lanes ({tag} tournament): kernel differs from its "
              f"lane-looped plain version")
    rows = ga.make_children_kernel(lp, draws, par, L)
    ls = delta.make_ls_draws([g], L * pop, cfg.ls_steps, cfg.ls_candidates,
                             lp.n_events, lp.n_slots, cfg.p1, cfg.p2,
                             cfg.p3, dev)
    events = delta.random_ls_events_kernel(ls)
    got = delta.random_ls_chain(lp, ls, rows, events)
    want = delta.random_ls_lanes_plain(lp, ls, rows)
    torch.cuda.synchronize()
    check(all(torch.equal(w, x) for w, x in zip(want, got)),
          "random_ls_lanes: kernel differs from its lane-looped plain "
          "version")
    for lane, pa in enumerate(lp.pas):
        r = slice(lane * pop, (lane + 1) * pop)
        full = fitness.batch_penalty_plain(pa, got.slots[r], got.rooms[r])
        check(all(torch.equal(w, x[r]) for w, x in zip(full, got[2:])),
              f"random_ls_lanes lane {lane}: the epilogue's terms are not "
              f"batch_penalty_plain of its rows on its problem")
    compare_anchored_lanes(problem, dev, cfg, g)
    one = lp.first
    calls = {
        "breed_lanes": (
            lambda: ga.make_children_kernel(lp, draws, par, L),
            lambda: ga.make_children_kernel(one, draws, par, L),
            lambda: ga.make_children_lanes_plain(lp, draws, par, cfg),
            "breed"),
        "random_ls_lanes": (
            lambda: delta.random_ls_chain(lp, ls, rows, events),
            lambda: delta.random_ls_chain(one, ls, rows, events),
            lambda: delta.random_ls_lanes_plain(lp, ls, rows),
            "random_ls"),
    }
    work = lane_work(lp, par, draws, rows, ls, events)
    out = {}
    for name, (kern, no_table, plain, kname) in calls.items():
        b, by = bound(*work[name])
        out[(name, L)] = dict(
            ms=time_ms(kern, 20), plain_ms=time_ms(plain, 1),
            max_abs_err=0, lanes=L, rows_a_lane=pop,
            device_us=device_us_per_launch(kern, kname),
            device_us_without_table=device_us_per_launch(no_table, kname),
            bound_ms=b, bound_by=by, library_ms=None)
    return out


def compare_anchored_lanes(problem, dev, cfg, g):
    """K6 and K8's chain with a lane table whose lanes carry an edit's
    anchor (three anchored lanes and a plain one, as an edit job packs
    with other jobs) against their lane-looped plain versions, exactly,
    and the chain's terms against batch_penalty_plain on each lane's
    anchored problem."""
    import torch
    from timetabling_ga_tpu_torch.ops import delta, fitness, ga
    lp = lane_problems(problem, dev, anchored=True)
    check([pa.anchored for pa in lp.pas] == [True, True, True, False],
          "anchored lanes: the anchors did not reach the lane table")
    L, pop = len(lp), LANE_POP
    par = ga.PopState(*(torch.cat(x) for x in zip(*(
        ga.evaluate(pa, torch.randint(0, pa.n_slots, (pop, lp.n_events),
                                      generator=g, device=dev,
                                      dtype=torch.int32),
                    torch.randint(0, pa.n_rooms, (pop, lp.n_events),
                                  generator=g, device=dev,
                                  dtype=torch.int32))
        for pa in lp.pas))))
    draws = ga.make_breed_draws([g] * L, pop, lp.n_events, lp.n_slots, cfg,
                                dev)
    got = ga.make_children_kernel(lp, draws, par, L)
    want = ga.make_children_lanes_plain(lp, draws, par, cfg)
    torch.cuda.synchronize()
    check(all(torch.equal(w, x) for w, x in zip(want, got)),
          "breed_lanes (anchored lanes): kernel differs from its plain "
          "version")
    ls = delta.make_ls_draws([g], L * pop, cfg.ls_steps, cfg.ls_candidates,
                             lp.n_events, lp.n_slots, cfg.p1, cfg.p2,
                             cfg.p3, dev)
    events = delta.random_ls_events_kernel(ls)
    rows = delta.random_ls_chain(lp, ls, got, events)
    want = delta.random_ls_lanes_plain(lp, ls, got)
    torch.cuda.synchronize()
    check(all(torch.equal(w, x) for w, x in zip(want, rows)),
          "random_ls_lanes (anchored lanes): kernel differs from its plain "
          "version")
    for lane, pa in enumerate(lp.pas):
        r = slice(lane * pop, (lane + 1) * pop)
        full = fitness.batch_penalty_plain(pa, rows.slots[r], rows.rooms[r])
        check(all(torch.equal(w, x[r]) for w, x in zip(full, rows[2:])),
              f"random_ls_lanes anchored lane {lane}: its terms are not "
              f"batch_penalty_plain of its rows")


def k13_lanes_equal(trace, mode, nv, cap, what):
    """compress_trace's lane form against its plain version: events and
    counts exactly; the moments of each lane's first nv[l] rows within
    the stated tolerance, an idle lane's (0, 0, +inf, -inf) exactly.
    Returns (plain leaf, max abs err over the finite moments)."""
    import numpy as np
    import torch
    from timetabling_ga_tpu_torch.parallel import islands
    n_valid = torch.tensor(list(nv), dtype=torch.int32, device=trace.device)
    got = islands.compress_trace_kernel(trace, mode, cap, n_valid)
    got = got.cpu().numpy()
    want = islands.compress_trace_plain(trace, mode, cap,
                                        n_valid).cpu().numpy()
    check(got.shape == want.shape, f"{what}: leaf shape")
    T = trace.shape[1]
    K = min(T, islands.TRACE_DELTAS_CAP if cap is None else cap)
    check((got[:, :3 * K + 1] == want[:, :3 * K + 1]).all(),
          f"{what}: events or counts differ")
    err = 0.0
    if mode == "stats":
        t = trace.cpu()
        rep = islands.reported_f32(t[..., 0], t[..., 1]).numpy()
        gm = got[:, 3 * K + 1:].view(np.float32)
        wm = want[:, 3 * K + 1:].view(np.float32)
        empty = np.array([0, 0, np.inf, -np.inf], np.float32)
        for lane, n in enumerate(nv):
            if n == 0:
                check((gm[lane].view(np.int32) == empty.view(np.int32)).all()
                      and (wm[lane].view(np.int32)
                           == empty.view(np.int32)).all(),
                      f"{what}: idle lane {lane} moments {gm[lane]}")
            else:
                err = max(err, k13_moments_err(
                    gm[lane:lane + 1], wm[lane:lane + 1],
                    rep[lane:lane + 1, :n], f"{what} lane {lane}"))
    return want, err


def k14_lanes_equal(masks, slots, pen, scv, L, what):
    """div_stats' lane form (a mask row a lane) against its plain
    version, and each lane's row against the shared-mask form run on
    that lane alone (bit for bit: the same sums); returns the max abs
    err of the float values."""
    import numpy as np
    from timetabling_ga_tpu_torch.parallel import islands
    got = islands.div_stats_kernel(masks, slots, pen, scv, L).cpu().numpy()
    want = islands.div_stats_plain(masks, slots, pen, scv, L).cpu().numpy()
    check(got.shape == want.shape, f"{what}: shape")
    check((got[:, 8] == want[:, 8]).all(), f"{what}: Hamming differs")
    pop = pen.shape[0] // L
    err = 0.0
    for i in range(L):
        r = slice(i * pop, (i + 1) * pop)
        gf, wf = got[i].view(np.float32), want[i].view(np.float32)
        err = max(err, k14_moments_err(gf[:4], wf[:4],
                                       pen[r].float().cpu().numpy(), what),
                  k14_moments_err(gf[4:8], wf[4:8],
                                  scv[r].float().cpu().numpy(), what))
        one = islands.div_stats_kernel(masks[i].contiguous(), slots[r],
                                       pen[r], scv[r], 1).cpu().numpy()
        check((one[0] == got[i]).all(),
              f"{what}: lane {i} differs from the shared-mask form")
    return err


def lane_counts(L, T, g):
    """(L,) valid counts: an idle lane, a lane at the quantum, the rest
    between."""
    nv = [int(x) for x in g.integers(0, T + 1, L)]
    nv[0] = 0
    if L > 1:
        nv[-1] = T
    return nv


def compare_lane_trace_forms(problem, dev):
    """K13's compress_trace and K14's div_stats in their lane forms (the
    serve path's --trace-mode deltas|stats and --quality) against their
    plain versions: compress_trace_lanes over K13_LANE_L x K13_LANE_T in
    both modes at caps 3 (overflow), the default and T (a quality-packed
    full trace); div_stats_lanes on the lane phase's four lanes of
    comp01s's bucket (and 16 lanes of them) at K14_LANE_POP. Then each
    timed at the serve shape (LANE_COUNTS, pop 16). Returns (timings,
    cases)."""
    import numpy as np
    import torch
    from timetabling_ga_tpu_torch.obs.quality import N_DIV
    from timetabling_ga_tpu_torch.parallel import islands
    saved = islands.TRACE_DELTAS_CAP
    g = np.random.default_rng(9000)
    n = 0
    try:
        for L in K13_LANE_L:
            for T in K13_LANE_T:
                tr = k13_trace(L, T, 31 * T + L, dev)
                nv = lane_counts(L, T, g)
                for mode in ("deltas", "stats"):
                    for cap in (3, 64):
                        islands.TRACE_DELTAS_CAP = cap
                        k13_lanes_equal(tr, mode, nv, None,
                                        f"compress_trace_lanes {mode} "
                                        f"L={L} T={T} cap={cap}")
                        n += 1
                    k13_lanes_equal(tr, mode, nv, T,
                                    f"compress_trace_lanes {mode} L={L} "
                                    f"T={T} K=T")
                    n += 1
    finally:
        islands.TRACE_DELTAS_CAP = saved
    lp = lane_problems(problem, dev)
    masks = lp.event_masks
    E = lp.n_events
    gt = torch.Generator(device=dev).manual_seed(9001)
    for L, m in ((4, masks), (16, masks.repeat(4, 1))):
        for pop in K14_LANE_POP:
            slots, pen, scv = k14_div_case(E, L, pop, gt, dev)
            k14_lanes_equal(m, slots, pen, scv, L,
                            f"div_stats_lanes L={L} pop={pop}")
            n += 1
    out = {}
    L, T = len(LANE_COUNTS), LANE_TRACE_T
    tr = k13_trace(L, T, 9002, dev, sentinels=False)
    nv = torch.tensor(LANE_COUNTS, dtype=torch.int32, device=dev)
    _, err = k13_lanes_equal(tr, "stats", LANE_COUNTS, None,
                             "compress_trace_lanes timed")
    W = islands.trace_leaf_width(T, "stats")
    # each warp reads only its lane's first min(count, T) rows
    rows = sum(min(c, T) for c in LANE_COUNTS)
    b, by = bound(rows * 2 * 4 + L * 4 + L * W * 4, 0)
    out[("compress_trace_lanes", L, T)] = dict(
        ms=time_ms(lambda: islands.compress_trace_kernel(
            tr, "stats", None, nv), 200),
        plain_ms=time_ms(lambda: islands.compress_trace_plain(
            tr, "stats", None, nv), 20),
        max_abs_err=err, counts=list(LANE_COUNTS), bound_ms=b, bound_by=by,
        library_ms=None)
    pop = LANE_POP
    slots, pen, scv = k14_div_case(E, L, pop, gt, dev)
    err = k14_lanes_equal(masks, slots, pen, scv, L, "div_stats_lanes timed")
    nb, ops = div_stats_work(L, pop, E)
    b, by = bound(nb + (L - 1) * E * 4, ops)
    out[("div_stats_lanes", L, pop)] = dict(
        ms=time_ms(lambda: islands.div_stats_kernel(masks, slots, pen, scv,
                                                    L), 200),
        plain_ms=time_ms(lambda: islands.div_stats_plain(masks, slots, pen,
                                                         scv, L), 20),
        max_abs_err=err, bound_ms=b, bound_by=by, library_ms=None,
        n_div=N_DIV)
    torch.cuda.synchronize()
    return out, n


def lane_trace_device_times(problem, dev, timings):
    """The lane forms' device time a launch at their timed shapes
    (torch.profiler), added to their timings; run after the profile
    windows."""
    import torch
    from timetabling_ga_tpu_torch.k5_phases import device_us_per_launch
    from timetabling_ga_tpu_torch.parallel import islands
    L, T = len(LANE_COUNTS), LANE_TRACE_T
    tr = k13_trace(L, T, 9002, dev, sentinels=False)
    nv = torch.tensor(LANE_COUNTS, dtype=torch.int32, device=dev)
    timings[("compress_trace_lanes", L, T)]["device_us"] = \
        device_us_per_launch(lambda: islands.compress_trace_kernel(
            tr, "stats", None, nv), "compress_trace")
    lp = lane_problems(problem, dev)
    gt = torch.Generator(device=dev).manual_seed(9003)
    slots, pen, scv = k14_div_case(lp.n_events, L, LANE_POP, gt, dev)
    masks = lp.event_masks
    timings[("div_stats_lanes", L, LANE_POP)]["device_us"] = \
        device_us_per_launch(lambda: islands.div_stats_kernel(
            masks, slots, pen, scv, L), "div_stats")


def serve_requests(path, itc_tim):
    """The serve path's request file (SERVE_JOBS, then s7 submitted and
    cancelled, s8 with a deadline that passes before its first slice, a
    malformed line, drain)."""
    lines = []
    for jid, tim, seed, gens, prio in SERVE_JOBS:
        sub = {"id": jid, "seed": seed, "generations": gens,
               "priority": prio}
        if tim == "itc":
            sub["tim"] = itc_tim
        else:
            sub["instance"] = tim
        lines.append({"submit": sub})
    lines += [{"submit": {"id": "s7", "instance": TIM, "seed": 7}},
              {"cancel": "s7"},
              {"submit": {"id": "s8", "instance": TIM, "seed": 8,
                          "deadline": 1e-6}},
              "{malformed",
              {"drain": True}]
    with open(path, "w") as f:
        for x in lines:
            f.write((x if isinstance(x, str) else json.dumps(x)) + "\n")


def run_serve(name, req, extra=()):
    """`python -m timetabling_ga_tpu_torch serve -i req` on the card, the
    launch counters zeroed just before and read just after; returns
    (records, seconds, launches, the serve.* counters it added)."""
    from timetabling_ga_tpu_torch import cli, kernels
    from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
    out = os.path.join(OUT_DIR, f"serve_{name}.jsonl")
    before = REGISTRY.snapshot().get("counters", {})
    kernels.reset_launches()
    t0 = time.monotonic()
    rc = cli.main(["serve", "-i", req, "-o", out] + list(extra))
    seconds = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    check(rc == 0, f"serve {name}: cli exited {rc}")
    after = REGISTRY.snapshot().get("counters", {})
    counters = {k: v - before.get(k, 0) for k, v in after.items()
                if k.startswith("serve.")}
    with open(out) as f:
        records = [json.loads(line) for line in f]
    return records, seconds, launches, counters


def _job_records(records, jid):
    return [r for r in records if next(iter(r.values())).get("job") == jid]


def serve_path(pa_cpu):
    """The serve path at the service's defaults on SERVE_JOBS: every
    lifecycle, every feasible solution re-scored on its unpadded
    instance, s1 and s4 alone equal to their packed records and a
    --no-resident run equal to the resident one under strip_timing, and
    which kernels it launched. Returns (summary, launches)."""
    import torch
    from timetabling_ga_tpu_torch.ops import fitness
    from timetabling_ga_tpu_torch.problem import dump_tim
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    itc = itc_problem()
    itc_tim = dump_tim(itc)
    req = os.path.join(OUT_DIR, "serve_requests.jsonl")
    serve_requests(req, itc_tim)
    records, seconds, launches, counters = run_serve("packed", req)
    events = {}
    for r in records:
        if "jobEntry" in r:
            e = r["jobEntry"]
            events.setdefault(e["job"], []).append(e)
    for jid, _, _, gens, _ in SERVE_JOBS:
        ev = [e["event"] for e in events.get(jid, [])]
        check(ev == ["admitted", "started", "done"],
              f"serve: {jid} lifecycle {ev}")
        check(events[jid][-1]["gens"] == gens,
              f"serve: {jid} ran {events[jid][-1]['gens']} generations")
    check([e["event"] for e in events["s7"]] == ["admitted", "cancelled"],
          f"serve: s7 lifecycle {events['s7']}")
    check([(e["event"], e.get("reason")) for e in events["s8"]]
          == [("admitted", None), ("failed", "deadline")],
          f"serve: s8 lifecycle {events['s8']}")
    check([e["event"] for e in events["?"]] == ["rejected"],
          f"serve: the malformed line gave {events['?']}")
    pas = {TIM: pa_cpu[TIM], TIM05: pa_cpu[TIM05],
           "itc": itc.device_arrays("cpu")}
    done_s, feasible = {}, 0
    for jid, tim, _, _, _ in SERVE_JOBS:
        recs = _job_records(records, jid)
        sols = [r["solution"] for r in recs if "solution" in r]
        runs = [r["runEntry"] for r in recs if "runEntry" in r]
        check(len(sols) == 1 and len(runs) == 2,
              f"serve: {jid} has {len(sols)} solutions, {len(runs)} runs")
        logs = [r["logEntry"]["best"] for r in recs if "logEntry" in r]
        check(logs == sorted(logs, reverse=True) and logs
              and logs[-1] == sols[0]["totalBest"],
              f"serve: {jid} logEntry bests {logs[-3:]}")
        done_s[jid] = round(sols[0]["totalTime"], 3)
        if sols[0]["feasible"]:
            feasible += 1
            sl = torch.tensor([sols[0]["timeslots"]], dtype=torch.int32)
            rm = torch.tensor([sols[0]["rooms"]], dtype=torch.int32)
            _, hcv, scv = fitness.batch_penalty_plain(pas[tim], sl, rm)
            check(int(hcv[0]) == 0 and int(scv[0]) == sols[0]["totalBest"],
                  f"serve: {jid}'s timetable does not re-score to its "
                  f"best")
    started = sum(1 for ev in events.values()
                  if any(e["event"] == "started" for e in ev))
    n_disp = counters.get("serve.dispatches", 0)
    check(launches["assign_rooms"] == started
          and launches["batch_penalty"] == started,
          f"serve: K1 {launches['assign_rooms']} and K2 "
          f"{launches['batch_penalty']} launches for {started} started jobs")
    for k in LANES + ("random_ls_events", "survivors"):
        check(launches[k] >= n_disp,
              f"serve: {k} launched {launches[k]} times in {n_disp} "
              f"dispatches")
    for k in SERVE_NEVER:
        check(launches[k] == 0,
              f"serve: {k} launched {launches[k]} times")
    stripped = strip_timing(records)
    alone_records = {}
    for jid, tim in (("s1", TIM), ("s4", "itc")):
        sub = os.path.join(OUT_DIR, f"serve_{jid}_alone_requests.jsonl")
        row = next(x for x in SERVE_JOBS if x[0] == jid)
        with open(sub, "w") as f:
            s = {"id": jid, "seed": row[2], "generations": row[3],
                 "priority": row[4]}
            s.update({"tim": itc_tim} if tim == "itc" else {"instance": tim})
            f.write(json.dumps({"submit": s}) + "\n")
        alone, _, _, _ = run_serve(f"{jid}_alone", sub)
        check(strip_timing(alone) == strip_timing(_job_records(records,
                                                               jid)),
              f"serve: {jid} alone differs from {jid} packed")
        alone_records[jid] = alone
    nores, nores_s, _, nores_c = run_serve("no_resident", req,
                                           ["--no-resident"])
    check(strip_timing(nores) == stripped,
          "serve: the --no-resident stream differs from the resident one")
    check(nores_c.get("serve.resident_hits", 0) == 0
          and counters.get("serve.resident_hits", 0) > 0,
          f"serve: resident hits {counters.get('serve.resident_hits')} / "
          f"{nores_c.get('serve.resident_hits')} without residency")
    legs, leg_launches = serve_legs(req, stripped, n_disp)
    lane_gens = counters.get("serve.gens", 0)
    return dict(
        legs=legs, warm_start=serve_warm_start(alone_records["s1"]),
        wall_s=round(seconds, 3), dispatches=n_disp, lane_gens=lane_gens,
        lane_gens_per_s=lane_gens / seconds,
        lane_gens_per_quantum_s=(
            lane_gens / counters["serve.quantum_seconds"]),
        time_to_done_s=done_s, feasible_jobs=feasible,
        resident_hits=counters.get("serve.resident_hits", 0),
        park_bytes=counters.get("serve.park_bytes", 0),
        resume_bytes=counters.get("serve.resume_bytes", 0),
        no_resident_wall_s=round(nores_s, 3),
        no_resident_park_bytes=nores_c.get("serve.park_bytes", 0)), \
        dict(leg_launches, serve=launches)


def serve_legs(req, stripped, n_disp):
    """SERVE_JOBS under each SERVE_LEGS entry: the stream equal to the
    full run's under strip_timing, K13's lane form every dispatch of a
    packed leaf (a quality-packed full trace too) and K14's div_stats
    lane form every dispatch under --quality, K14's quality_ops a
    generation step under it, the one-problem K13/K14 forms never.
    Returns ({leg: summary}, {"serve-" + leg: launches})."""
    from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    out, launches = {}, {}
    for leg, extra in SERVE_LEGS.items():
        recs, secs, la, c = run_serve(leg, req, extra)
        check(strip_timing(recs) == stripped,
              f"serve {leg}: the stream differs from trace mode full's")
        quality = "--quality" in extra
        check(la["compress_trace_lanes"] == c.get("serve.dispatches", 0)
              == n_disp,
              f"serve {leg}: compress_trace_lanes launched "
              f"{la['compress_trace_lanes']} times in "
              f"{c.get('serve.dispatches')} dispatches")
        check(la["div_stats_lanes"] == (n_disp if quality else 0),
              f"serve {leg}: div_stats_lanes launched "
              f"{la['div_stats_lanes']} times")
        check(la["quality_ops"] == (la["breed_lanes"] if quality else 0),
              f"serve {leg}: quality_ops {la['quality_ops']} for "
              f"{la['breed_lanes']} generation steps")
        check(all(la[k] == 0 for k in K13 + ("div_stats",)),
              f"serve {leg}: a one-problem K13/K14 form launched")
        summary = dict(wall_s=round(secs, 3),
                       lane_gens_per_s=c.get("serve.gens", 0) / secs,
                       trace_delta_overflow=c.get(
                           "serve.trace_delta_overflow", 0))
        if quality:
            snap = REGISTRY.snapshot()
            summary["hamming_min"] = snap["gauges"].get(
                "quality.diversity.hamming_min")
            check(snap["counters"].get("quality.ops.crossover_attempts", 0)
                  > 0, f"serve {leg}: no quality counters")
        out[leg] = summary
        launches["serve-" + leg] = la
    return out, launches


def _service(out):
    """A SolveService at the service's defaults on the card, with its
    own registry."""
    from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
    from timetabling_ga_tpu_torch.runtime.config import ServeConfig
    from timetabling_ga_tpu_torch.serve.service import SolveService
    return SolveService(ServeConfig(), out=out, registry=MetricsRegistry())


def _lines(buf):
    return [json.loads(x) for x in buf.getvalue().splitlines()]


def serve_warm_start(alone_s1):
    """s1 alone through the Python API, shipped at its first host fence
    at or after SERVE_SHIP_AT generations (its group is resident by then:
    the fence is flush_resident's), then a new service resumed from the
    wire: the shipped prefix plus the continuation equals the
    uninterrupted s1 under strip_timing, resumed_at is the fence's
    generation, and the resumed run launches no K1 or K2 (no init)."""
    import io
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.problem import load_tim_file
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    row = next(x for x in SERVE_JOBS if x[0] == "s1")
    problem = load_tim_file(TIM)
    svc = _service(io.StringIO())
    svc.submit(problem, job_id="s1", seed=row[2], generations=row[3])
    job = svc.queue.get("s1")
    while job.gens_done < SERVE_SHIP_AT:
        svc.step()
    resident = bool(svc.scheduler._resident)
    svc.scheduler.flush_resident()
    ship = job.ship
    check(ship.gens_done == job.gens_done >= SERVE_SHIP_AT
          and not ship.truncated,
          f"warm start: shipped at {ship.gens_done}, job at "
          f"{job.gens_done}")
    wire = json.loads(json.dumps(ship.pack()))
    prefix = list(ship.records)
    svc.close()
    buf = io.StringIO()
    svc = _service(buf)
    kernels.reset_launches()
    t0 = time.monotonic()
    svc.submit(problem, job_id="s1", seed=row[2], generations=row[3],
               snapshot=wire)
    svc.drive()
    seconds = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    svc.close()
    cont = _lines(buf)
    check(strip_timing(prefix + cont) == strip_timing(alone_s1),
          "warm start: prefix + continuation differs from s1 alone")
    res = svc.result("s1")
    check(res["resumed_at"] == ship.gens_done and res["gens"] == row[3],
          f"warm start: result {res['resumed_at']} / {res['gens']}")
    # the wire's usage cursor: the resumed job's meter continues it
    check(wire["usage"]["gens"] == ship.gens_done
          and res["usage"]["gens"] == row[3],
          f"warm start: cursor {wire['usage']}, meter {res['usage']}")
    check(launches["assign_rooms"] == 0 and launches["batch_penalty"] == 0,
          "warm start: the resumed job ran an init")
    seams = [(r["faultEntry"]["site"], r["faultEntry"]["action"])
             for r in cont if "faultEntry" in r]
    check(seams == [("fleet", "resume")], f"warm start: seams {seams}")
    counters = svc.registry.snapshot()["counters"]
    return dict(shipped_at=ship.gens_done, resident_before_ship=resident,
                wire_bytes=len(json.dumps(wire)),
                resumed_seconds=round(seconds, 3),
                resumed_resident_hits=counters.get("serve.resident_hits",
                                                   0),
                base_wire=json.loads(json.dumps(
                    svc.queue.get("s1").ship.pack())))


def serve_edits(base_wire, pa_cpu):
    """An edit of comp01s (EDIT_OPS) at w_anchor 1 from the finished s1's
    wire, warm (its K6 and K8 lane forms launched on its anchored lane,
    K2 once for the transplant, no K1), done with its edit_distance; its
    solution re-scored on the edited instance; then a cross-bucket edit
    (EDIT_CROSS_OPS), demoted with exactly one faultEntry."""
    import io
    import numpy as np
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.ops import fitness
    from timetabling_ga_tpu_torch.runtime import jsonl
    from timetabling_ga_tpu_torch.problem import dump_tim, load_tim_file
    from timetabling_ga_tpu_torch.serve import editsolve
    tim = dump_tim(load_tim_file(TIM))
    out = {}
    for name, ops in (("edit", EDIT_OPS), ("edit-cross", EDIT_CROSS_OPS)):
        buf = io.StringIO()
        svc = _service(buf)
        spec = {"base": {"tim": tim}, "base_id": "s1", "ops": ops,
                "w_anchor": 1, "snapshot": base_wire}
        kernels.reset_launches()
        t0 = time.monotonic()
        svc.submit(None, job_id=name, seed=9, generations=EDIT_GENS,
                   edit=spec)
        job = svc.queue.get(name)
        anchored = bool(job.pa_dev.anchored)
        svc.drive()
        seconds = time.monotonic() - t0
        launches = dict(kernels.LAUNCHES)
        svc.close()
        recs = _lines(buf)
        res = svc.result(name)
        faults = [(r["faultEntry"]["site"], r["faultEntry"]["action"])
                  for r in recs if "faultEntry" in r]
        done = [r["jobEntry"] for r in recs if "jobEntry" in r
                and r["jobEntry"]["event"] == "done"]
        check(len(done) == 1 and done[0].get("mode") == "edit"
              and isinstance(res["edit_distance"], int)
              and done[0].get("edit_distance") == res["edit_distance"],
              f"{name}: done record {done}")
        if name == "edit":
            check(faults == [("fleet", "resume")] and not res["edit_demoted"],
                  f"edit: faults {faults}, demoted {res['edit_demoted']}")
            check(anchored, "edit: the edit job's problem is not anchored")
            check(launches["breed_lanes"] > 0
                  and launches["random_ls_lanes"] > 0
                  and launches["batch_penalty"] == 1
                  and launches["assign_rooms"] == 0,
                  f"edit: launches {launches}")
            # the answer re-scored on the edited instance, feasible or
            # not, and its distance to the base recomputed on the host
            edited, _ = editsolve.apply_ops(load_tim_file(TIM), ops)
            _, hcv, scv = fitness.batch_penalty_plain(
                edited.device_arrays("cpu"),
                torch.tensor([res["timeslots"]], dtype=torch.int32),
                torch.tensor([res["rooms"]], dtype=torch.int32))
            hcv, scv = int(hcv[0]), int(scv[0])
            check((hcv, scv) == (res["hcv"], res["scv"])
                  and res["feasible"] == (hcv == 0)
                  and res["best"] <= jsonl.reported_best(hcv, scv),
                  f"edit: re-scored ({hcv}, {scv}), result "
                  f"({res['hcv']}, {res['scv']}) best {res['best']}")
            dist = editsolve.edit_distance(
                np.asarray(res["timeslots"]), job.padded.anchor_slots,
                job.edit_map)
            check(dist == res["edit_distance"],
                  f"edit: edit_distance {res['edit_distance']}, "
                  f"recomputed {dist}")
        else:
            check(faults == [("edit", "demote")] and res["edit_demoted"],
                  f"edit-cross: faults {faults}")
        out[name] = dict(seconds=round(seconds, 3),
                         edit_distance=res["edit_distance"],
                         best=res["best"], feasible=res["feasible"],
                         demoted=res["edit_demoted"], anchored=anchored,
                         launches={k: v for k, v in launches.items() if v})
    return out


# the fleet-replica phase: the serve path's defaults through an
# in-process replica's /v1 front. FLEET_LONG is the freshness and preempt
# job (the ITC-like instance): long enough that it is still running when
# the polls end and the preempt lands; FLEET_POLLS ?snapshot=1 polls are
# held to one quantum of its cursor
FLEET_LONG = ("f1", "itc", 11, 2000)
FLEET_POLLS = 10
FLEET_SETTLED = ("done", "failed", "cancelled", "shed", "rejected")
# FLEET_LONG's uninterrupted records, written by the fleet-replica phase
FLEET_LONG_RECORDS = os.path.join(OUT_DIR, "fleet_long.jsonl")


def _fleet_payload(jid, tim, seed, gens, prio, texts):
    return {"id": jid, "tim": texts[tim], "seed": seed,
            "generations": gens, "priority": prio}


def _fleet_settle(handle, ids, what, timeout=120.0):
    """Poll GET /v1/jobs until every id has settled, then each job's view
    until its tail holds its settling jobEntry (the writer's thread
    feeds the tail); returns ({id: view}, the settle time)."""
    deadline = time.monotonic() + timeout
    while True:
        states = handle.list_jobs()
        if all(states.get(j, {}).get("state") in FLEET_SETTLED
               for j in ids):
            break
        check(time.monotonic() < deadline,
              f"fleet-replica: {what} not settled: {states}")
        # a tight poll would take the interpreter's lock from the drive
        # loop's host work
        time.sleep(0.02)
    t_settled = time.monotonic()
    views = {}
    for j in ids:
        while True:
            v = handle.get_job(j, timeout=30.0)
            ev = [r["jobEntry"]["event"] for r in v["records"]
                  if "jobEntry" in r]
            if ev and ev[-1] in FLEET_SETTLED:
                views[j] = v
                break
            check(time.monotonic() < deadline,
                  f"fleet-replica: {what}: {j}'s tail never settled")
            time.sleep(0.02)
    return views, t_settled


def _fleet_reaped(rep, ids):
    """Wait until the drive loop has dropped every settled job's tensors
    (and any cached pack holding them); returns memory_allocated."""
    import torch
    deadline = time.monotonic() + 60.0
    while True:
        jobs = [rep.svc.queue.get(j) for j in ids]
        packed = {jid for jids, _ in rep.svc.scheduler._packs.values()
                  for jid in jids}
        if all(j.pa_dev is None and j.padded is None for j in jobs) \
                and not packed.intersection(ids):
            break
        check(time.monotonic() < deadline,
              "fleet-replica: settled jobs' tensors never reaped")
        time.sleep(0.01)
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def fleet_replica_path(serve_summary):
    """The fleet replica on the card (fleet/replicas.py, the serve path's
    defaults): (a) SERVE_JOBS through POST /v1/solve on an in-process
    replica, each job's records equal to the serve phase's line-JSON
    records of the same job (strip_timing), the lane kernels launched;
    (e) the same jobs again, and after each round settles and is reaped
    the card's allocated memory no higher than after the first; (b)
    FLEET_LONG until its group stays resident, then ?snapshot=1 at each
    fence: resident hits stop and every wire is within one quantum of
    the job's cursor; (c) POST /v1/drain?mode=preempt: the job reads
    `preempted` with its wire, the fetch lets the replica exit before
    --preempt-grace, and the wire resumed on a second replica continues
    at its fence (0 generations re-run) to the records of an
    uninterrupted run; (d) `python -m timetabling_ga_tpu_torch serve
    --http ... --preempt-on-term -o LOG` on the card sent SIGTERM after
    its job's first ship: the fetch of the preempted job, exit 0 within
    the grace, the log ending with the `preempted` jobEntry."""
    import io
    import signal
    import statistics
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.fleet import replicas
    from timetabling_ga_tpu_torch.problem import dump_tim, load_tim
    from timetabling_ga_tpu_torch.runtime.config import ServeConfig
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    with open(TIM) as f:
        tim01 = f.read()
    with open(TIM05) as f:
        tim05 = f.read()
    texts = {TIM: tim01, TIM05: tim05, "itc": dump_tim(itc_problem())}
    with open(os.path.join(OUT_DIR, "serve_packed.jsonl")) as f:
        line_json = [json.loads(x) for x in f]
    cfg = ServeConfig(http="127.0.0.1:0")
    out = {"card": CARD}
    t_phase = time.monotonic()

    # (a) SERVE_JOBS over HTTP against the serve phase's line-JSON run
    rep, handle = replicas.in_process_replica(cfg, "card")
    try:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        kernels.reset_launches()
        t0 = time.monotonic()
        for row in SERVE_JOBS:
            handle.post_job(_fleet_payload(*row, texts))
        ids = [row[0] for row in SERVE_JOBS]
        views, t_done = _fleet_settle(handle, ids, "SERVE_JOBS")
        launches = dict(kernels.LAUNCHES)
        wall = t_done - t0
        equal = 0
        for jid, _, _, gens, _ in SERVE_JOBS:
            v = views[jid]
            check(v["state"] == "done" and v["result"]["gens"] == gens,
                  f"fleet-replica: {jid} {v['state']} {v.get('error')}")
            check(not v["records_truncated"],
                  f"fleet-replica: {jid}'s tail truncated")
            check(strip_timing(v["records"])
                  == strip_timing(_job_records(line_json, jid)),
                  f"fleet-replica: {jid} over HTTP differs from its "
                  f"line-JSON records")
            equal += 1
        for k in LANES + ("random_ls_events", "survivors",
                          "assign_rooms", "batch_penalty"):
            check(launches[k] > 0,
                  f"fleet-replica: {k} never launched over HTTP")
        for k in SERVE_NEVER:
            check(launches[k] == 0,
                  f"fleet-replica: {k} launched {launches[k]} times")
        counters = rep.svc.registry.snapshot()["counters"]
        lane_gens = counters.get("serve.gens", 0)
        out.update(jobs_equal=equal, jobs=len(SERVE_JOBS),
                   http_wall_s=wall, lane_gens=lane_gens,
                   lane_gens_per_s_http=lane_gens / wall,
                   lane_gens_per_s_line_json=serve_summary[
                       "lane_gens_per_s"],
                   dispatches=counters.get("serve.dispatches", 0),
                   launches={k: launches[k] for k in
                             LANES + ("random_ls_events", "survivors",
                                      "assign_rooms", "batch_penalty")})

        # (e) the card's memory after a round is reaped, twice
        mem1 = _fleet_reaped(rep, ids)
        ids2 = [row[0] + "-2" for row in SERVE_JOBS]
        for row in SERVE_JOBS:
            handle.post_job(_fleet_payload(row[0] + "-2", *row[1:], texts))
        views2, _ = _fleet_settle(handle, ids2, "the second round")
        check(all(v["state"] == "done" for v in views2.values()),
              "fleet-replica: the second round did not finish")
        mem2 = _fleet_reaped(rep, ids2)
        check(mem2 <= mem1, f"fleet-replica: {mem2} bytes allocated "
              f"after the second round, {mem1} after the first")
        out.update(mem_allocated_before=mem0, mem_allocated_round1=mem1,
                   mem_allocated_round2=mem2)

        # (b) freshness: the long job resident, then polled at each fence
        jid, tim, seed, gens = FLEET_LONG
        handle.post_job(_fleet_payload(jid, tim, seed, gens, 0, texts))
        hits = rep.svc.registry.counter("serve.resident_hits")
        h0 = hits.value
        deadline = time.monotonic() + 60.0
        while hits.value < h0 + 2:
            check(time.monotonic() < deadline,
                  "fleet-replica: the long job never stayed resident")
            time.sleep(0.002)
        job = rep.svc.queue.get(jid)
        first = handle.get_job(jid, with_records=False, snapshot=True)
        first_lag = first["gens"] - first["snapshot"]["gens_done"]
        g_first = job.gens_done
        while job.gens_done < g_first + 2 * cfg.quantum:
            check(job.gens_done < gens,
                  "fleet-replica: the long job ended during the polls")
            time.sleep(0.002)
        h_polled = hits.value
        fetch_ms, lags = [], []
        for _ in range(FLEET_POLLS):
            t1 = time.monotonic()
            v = handle.get_job(jid, with_records=False, snapshot=True)
            fetch_ms.append(1e3 * (time.monotonic() - t1))
            lag = v["gens"] - v["snapshot"]["gens_done"]
            check(abs(lag) <= cfg.quantum,
                  f"fleet-replica: a wire {lag} generations behind the "
                  f"cursor {v['gens']}")
            lags.append(lag)
            g = job.gens_done
            while job.gens_done == g and job.gens_done < gens:
                time.sleep(0.001)            # the next fence
        check(hits.value == h_polled,
              f"fleet-replica: {hits.value - h_polled} resident hits "
              f"while polled")
        check(job.gens_done < gens,
              "fleet-replica: the long job ended before its preemption")
        out.update(first_poll_lag_gens=first_lag, poll_lags_gens=lags,
                   snapshot_fetch_ms_median=statistics.median(fetch_ms),
                   snapshot_wire_bytes=len(json.dumps(v["snapshot"])))

        # (c) the preempt drain, then the wire resumed elsewhere
        t1 = time.monotonic()
        handle.drain(mode="preempt")
        while True:
            v = handle.get_job(jid, with_records=False, snapshot=True)
            if v["state"] == "preempted":
                break
            check(time.monotonic() - t1 < cfg.preempt_grace,
                  f"fleet-replica: not preempted: {v['state']}")
            time.sleep(0.005)
        check(rep.drained.wait(cfg.preempt_grace),
              "fleet-replica: no exit within --preempt-grace")
        preempt_exit = time.monotonic() - t1
        wire, prefix = v["snapshot"], v["snapshot_records"]
        fence = wire["gens_done"]
        check(fence == v["gens"] < gens and not v["snapshot_truncated"],
              f"fleet-replica: preempted at {v['gens']}, wire {fence}")
        out.update(preempt_to_exit_s=preempt_exit, preempted_at=fence,
                   jobs_preempted=rep.svc.registry.counter(
                       "serve.jobs_preempted").value)
    finally:
        rep.kill()
    rep2, handle2 = replicas.in_process_replica(cfg, "card2")
    try:
        handle2.post_job(dict(_fleet_payload(jid, tim, seed, gens, 0,
                                             texts), snapshot=wire))
        views, _ = _fleet_settle(handle2, [jid], "the resumed job")
        res = views[jid]["result"]
        ran = rep2.svc.registry.counter("serve.gens").value
        check(views[jid]["state"] == "done"
              and res["resumed_at"] == fence and res["gens"] == gens
              and ran == gens - fence,
              f"fleet-replica: resumed at {res.get('resumed_at')}, ran "
              f"{ran} of {gens - fence}")
        cont = views[jid]["records"]
    finally:
        rep2.kill()
    buf = io.StringIO()
    svc = _service(buf)
    svc.submit(load_tim(texts[tim]), job_id=jid, seed=seed,
               generations=gens)
    svc.drive()
    svc.close()
    check(strip_timing(prefix + cont) == strip_timing(_lines(buf)),
          "fleet-replica: the preempted and resumed job differs from "
          "its uninterrupted run")
    # the fleet-gateway phase holds its failed-over jobs to this run
    with open(FLEET_LONG_RECORDS, "w") as f:
        for rec in _lines(buf):
            f.write(json.dumps(rec) + "\n")
    out["gens_rerun"] = ran - (gens - fence)

    # (d) the real entry point, SIGTERM under --preempt-on-term
    port = _free_port()
    log = os.path.join(OUT_DIR, "fleet_replica.jsonl")
    if os.path.exists(log):
        os.remove(log)
    url = f"http://127.0.0.1:{port}"
    t1 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "timetabling_ga_tpu_torch", "serve",
         "--http", f"127.0.0.1:{port}", "--preempt-on-term", "-o", log],
        cwd=HERE, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        while True:
            try:
                replicas.http_json("GET", url + "/readyz", ok=(200, 503))
                break
            except OSError:
                check(proc.poll() is None and time.monotonic() - t1 < 120,
                      "fleet-replica: serve --http never came up")
                time.sleep(0.1)
        boot = time.monotonic() - t1
        sub = replicas.ReplicaHandle("proc", url)
        sub.post_job(_fleet_payload("t1", TIM, 1, 100000, 0, texts))
        while sub.get_job("t1", with_records=False).get("gens", 0) == 0:
            check(time.monotonic() - t1 < 180,
                  "fleet-replica: the process's job never parked")
            time.sleep(0.01)
        t2 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        while True:
            try:
                if sub.get_job("t1", with_records=False,
                               snapshot=True)["state"] == "preempted":
                    break
            except OSError:
                # the drain ended and the process closed its server
                # between two polls: its exit code, its time to exit and
                # its log's last record (below) say whether it preempted
                break
            check(time.monotonic() - t2 < cfg.preempt_grace,
                  "fleet-replica: SIGTERM did not preempt")
            time.sleep(0.01)
        rc = proc.wait(timeout=cfg.preempt_grace + 30)
        term_exit = time.monotonic() - t2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err = proc.stderr.read().decode()
        proc.stderr.close()
    check(rc == 0,
          f"fleet-replica: serve --http exited {rc}: {err[-2000:]}")
    check(term_exit < cfg.preempt_grace,
          f"fleet-replica: {term_exit:.1f} s from SIGTERM to exit")
    with open(log) as f:
        last = json.loads(f.read().splitlines()[-1])
    check(last.get("jobEntry", {}).get("event") == "preempted"
          and last["jobEntry"]["job"] == "t1"
          and last["jobEntry"]["shipped"] is True,
          f"fleet-replica: the log ends with {last}")
    out.update(process_boot_s=boot, sigterm_to_exit_s=term_exit,
               phase_s=time.monotonic() - t_phase)
    return out


# the fleet-gateway phase: `python -m timetabling_ga_tpu_torch fleet
# --spawn N` over `serve --http` processes of the port on the card, at
# the serve path's defaults (the workers also under --obs: their
# usageEntry records). The probe and poll cadences are tightened; the
# boot grace, dead-after and restart budget are the defaults
FLEET_WORKER_ARGS = ["--obs"]
FLEET_CADENCE = ["--probe-every", "0.2", "--poll-every", "0.05"]
# the autoscaler's gateway: one worker, at most two, short windows
FLEET_SCALE = ["--spawn", "1", "--scale-min", "1", "--scale-max", "2",
               "--scale-up-queue", "4", "--scale-up-for", "0.5",
               "--scale-down-queue", "1", "--scale-down-for", "2",
               "--scale-idle-window", "2", "--scale-cooldown", "1",
               "--scale-every", "0.2", "--history-every", "0.2",
               "--scale-warm-recent", "0"]
# the generations the targeted preempt's job runs on its owner first
FLEET_PREEMPT_AT = 50
FLEET_EXIT = re.compile(
    r"^# tt fleet: replica (\S+) \(pid (\d+)\) exited (-?\d+)$")


def _get_url(url):
    from timetabling_ga_tpu_torch.fleet.replicas import http_json
    return http_json("GET", url, ok=(200,), timeout=30.0)


def _serving_pids(ports):
    """{port: pid} of the live processes whose argv holds `--http
    127.0.0.1:<port>` for a port in `ports` (a zombie's argv is
    empty)."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                args = [a.decode("utf-8", "replace")
                        for a in f.read().split(b"\0")]
        except OSError:
            continue
        if "--http" in args[:-1]:
            addr = args[args.index("--http") + 1]
            port = int(addr.rsplit(":", 1)[1]) if ":" in addr else None
            if port in ports:
                out[port] = int(d)
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return bool(f.read())
    except OSError:
        return False


def _as_job(records, jid):
    """`records` with every job id set to `jid` (one job's stream under
    another id)."""
    out = json.loads(json.dumps(records))
    for rec in out:
        body = next(iter(rec.values()))
        if isinstance(body, dict) and "job" in body:
            body["job"] = jid
    return out


class _Fleet:
    """One `fleet` process of the port, its log and its workers' logs in
    build/chip_smoke/<name>/ (its cwd), its stderr in gateway.err."""

    def __init__(self, name, argv):
        self.dir = os.path.join(OUT_DIR, name)
        os.makedirs(self.dir, exist_ok=True)
        for f in os.listdir(self.dir):
            os.remove(os.path.join(self.dir, f))
        port = _free_port()
        self.url = f"http://127.0.0.1:{port}"
        self.log = os.path.join(self.dir, "gateway.jsonl")
        self.err = os.path.join(self.dir, "gateway.err")
        env = dict(os.environ, PYTHONPATH=HERE)
        self.t0 = time.monotonic()
        with open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "timetabling_ga_tpu_torch",
                 "fleet", "--listen", f"127.0.0.1:{port}", "-o",
                 self.log, *argv], cwd=self.dir, env=env,
                stdout=subprocess.DEVNULL, stderr=err)
        self.ports = set()

    def get(self, path, **kw):
        from timetabling_ga_tpu_torch.fleet.replicas import http_json
        return http_json("GET", self.url + path, ok=(200,), **kw)

    def post(self, path, obj, ok=(200, 202)):
        from timetabling_ga_tpu_torch.fleet.replicas import http_json
        return http_json("POST", self.url + path, obj, ok=ok, timeout=30.0)

    def view(self):
        """GET /v1/fleet, the workers' ports noted."""
        v = self.get("/v1/fleet")
        for r in v["replicas"]:
            self.ports.add(int(r["url"].rsplit(":", 1)[1]))
        return v

    def replica(self, name):
        return next((r for r in self.view()["replicas"]
                     if r["name"] == name), None)

    def wait_ready(self, names, what, since=None, timeout=180.0):
        """{name: seconds from `since` (the fleet's start) until each
        replica first probed ready}."""
        since = self.t0 if since is None else since
        got = {}
        while len(got) < len(names):
            check(self.proc.poll() is None,
                  f"fleet-gateway: the fleet exited {self.proc.returncode}"
                  f" waiting for {what}: {self.tail()}")
            try:
                for r in self.view()["replicas"]:
                    if (r["name"] in names and r["ready"]
                            and not r["dead"] and r["name"] not in got):
                        got[r["name"]] = time.monotonic() - since
            except OSError:
                pass                # the front is not up yet
            check(time.monotonic() - since < timeout,
                  f"fleet-gateway: {what} never ready: {got}")
            time.sleep(0.05)
        return got

    def settle(self, ids, what, timeout=240.0):
        """{id: the gateway's view} once every id settled."""
        deadline = time.monotonic() + timeout
        while True:
            states = self.get("/v1/jobs")["jobs"]
            if all(states.get(j, {}).get("state") in FLEET_SETTLED
                   for j in ids):
                return {j: self.get(f"/v1/jobs/{j}", timeout=30.0)
                        for j in ids}
            check(time.monotonic() < deadline,
                  f"fleet-gateway: {what} not settled: "
                  f"{ {j: states.get(j) for j in ids} }")
            time.sleep(0.05)

    def metric(self, url, name):
        from timetabling_ga_tpu_torch.fleet.replicas import http_text
        from timetabling_ga_tpu_torch.obs import scrape
        return scrape.scalar(scrape.parse_exposition(
            http_text(url + "/metrics")), name, 0.0)

    def tail(self):
        with open(self.err) as f:
            return f.read()[-2000:]

    def exits(self):
        """[(replica, pid, exit status)] the gateway reported."""
        with open(self.err) as f:
            return [(m.group(1), int(m.group(2)), int(m.group(3)))
                    for m in map(FLEET_EXIT.match, f.read().splitlines())
                    if m]

    def drain(self, what):
        """POST /v1/drain; the fleet and every worker exit, 0 each, and
        no worker is left. Returns (the fleet's exit seconds, exits)."""
        t1 = time.monotonic()
        ack = self.post("/v1/drain", {}, ok=(200,))
        check(ack.get("draining") is True,
              f"fleet-gateway: {what}: drain answered {ack}")
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            rc = None
        drained_s = time.monotonic() - t1
        check(rc == 0, f"fleet-gateway: {what}: the fleet exited {rc}: "
              f"{self.tail()}")
        left = _serving_pids(self.ports)
        check(not left, f"fleet-gateway: {what}: workers left {left}")
        return drained_s, self.exits()

    def records(self, name="gateway"):
        """A log's records (a live log's torn last line skipped)."""
        path = (self.log if name == "gateway"
                else os.path.join(self.dir, f"tt-fleet-{name}.jsonl"))
        out = []
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
        return out

    def kill(self):
        """Stop the fleet and its workers, whatever state they are in."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for pid in _serving_pids(self.ports).values():
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


def fleet_gateway_path(serve_summary):
    """The fleet gateway on the card (fleet/gateway.py, router.py,
    replicas.py's ReplicaSet and spawn_one, autoscaler.py, client.py):
    `fleet --spawn 2 -- --obs` at the serve path's defaults, two `serve
    --http` processes of the port on the one card: (a) SERVE_JOBS, s1
    through the `submit` CLI and the rest through POST /v1/solve: every
    job's records equal to the serve phase's line-JSON records of the
    job (strip_timing), each bucket's first landing `warm` and the
    others `hit`, no `miss`, the routeEntry lines agreeing with
    /v1/fleet's router stats, each worker's lane kernels launched (its
    `kernels.launches.*` gauges), each worker's usageEntry flops above 0
    and /v1/usage the sum of the workers' ledgers; (b) FLEET_LONG's
    owner SIGKILLed while the gateway's cached wire is at its cursor:
    the job resumes on the other worker (at most one quantum re-run,
    fleet.resume.hits), its records those of the uninterrupted run; (c)
    once the killed worker is respawned and ready, a second FLEET_LONG
    job preempted on its owner at FLEET_PREEMPT_AT generations through
    POST /v1/drain?mode=preempt&replica=NAME: it resumes at the
    preempted fence (0 generations re-run), the owner exits 0, the
    records those of the uninterrupted run; (e) POST /v1/drain: the
    fleet and every worker exit 0, none is left; (d) a second gateway,
    FLEET_SCALE: a burst (SERVE_JOBS twice) gives a scaleEntry `up`, the
    spawned worker is adopted and serves a job of a bucket of its own,
    idle gives `down` through the preempt drain, every job's records
    equal, the retired worker exits 0; then (e) again."""
    from timetabling_ga_tpu_torch.problem import dump_tim
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    itc_path = os.path.join(OUT_DIR, "itc.tim")
    with open(itc_path, "w") as f:
        f.write(dump_tim(itc_problem()))
    paths = {TIM: TIM, TIM05: TIM05, "itc": itc_path}
    texts = {}
    for k, p in paths.items():
        with open(p) as f:
            texts[k] = f.read()
    with open(os.path.join(OUT_DIR, "serve_packed.jsonl")) as f:
        line_json = [json.loads(x) for x in f]
    with open(FLEET_LONG_RECORDS) as f:
        long_base = strip_timing([json.loads(x) for x in f])
    out = {"card": CARD}
    t_phase = time.monotonic()
    fleets = []
    try:
        fl = _Fleet("fleet_gateway", ["--spawn", "2", *FLEET_CADENCE,
                                      "--", *FLEET_WORKER_ARGS])
        fleets.append(fl)
        boot = fl.wait_ready(["r0", "r1"], "the two workers")
        out["replica_boot_s"] = boot
        out.update(_fleet_routing(fl, paths, texts, line_json,
                                  serve_summary))
        out.update(_fleet_failover(fl, texts, long_base))
        # the preempted worker is respawned: let it boot before the drain
        # (one still importing torch would be stopped by a signal)
        deadline = time.monotonic() + 180.0
        while not all(r["ready"] and not r["dead"]
                      for r in fl.view()["replicas"]):
            check(time.monotonic() < deadline,
                  f"fleet-gateway: not every worker ready before the "
                  f"drain: {fl.view()['replicas']}")
            time.sleep(0.05)
        routes = fl.view()["router"]
        drained_s, exits = fl.drain("the first gateway")
        out.update(_fleet_exits(fl, exits, routes))
        out["drain_to_exit_s"] = drained_s
        out["scale"] = _fleet_autoscaler(texts, line_json)
    finally:
        for fl in fleets:
            fl.kill()
    out["phase_s"] = time.monotonic() - t_phase
    return out


def _fleet_payload_of(row, texts, prefix=""):
    jid, tim, seed, gens, prio = row
    return {"id": prefix + jid, "tim": texts[tim], "seed": seed,
            "generations": gens, "priority": prio}


def _fleet_routing(fl, paths, texts, line_json, serve_summary):
    """(a): SERVE_JOBS through the gateway, s1 through the submit CLI."""
    from timetabling_ga_tpu_torch.obs import usage as obs_usage
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    out = {}
    ids = [row[0] for row in SERVE_JOBS]
    sub_out = os.path.join(fl.dir, "submit_s1.jsonl")
    jid, tim, seed, gens, prio = SERVE_JOBS[0]
    t0 = time.monotonic()
    sub = subprocess.Popen(
        [sys.executable, "-m", "timetabling_ga_tpu_torch", "submit",
         fl.url, paths[tim], "--id", jid, "-s", str(seed),
         "--generations", str(gens), "--priority", str(prio), "--poll",
         "0.1", "--records-out", sub_out],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the other jobs once s1 is in the table, so the placements run
        # in SERVE_JOBS' order
        deadline = time.monotonic() + 60.0
        while jid not in fl.get("/v1/jobs")["jobs"]:
            check(sub.poll() is None and time.monotonic() < deadline,
                  "fleet-gateway: submit never reached the gateway")
            time.sleep(0.01)
        for row in SERVE_JOBS[1:]:
            fl.post("/v1/solve", _fleet_payload_of(row, texts))
        views = fl.settle(ids, "SERVE_JOBS")
        wall = time.monotonic() - t0
        so, se = sub.communicate(timeout=120)
    finally:
        if sub.poll() is None:
            sub.kill()
            sub.wait()
    check(sub.returncode == 0,
          f"fleet-gateway: submit exited {sub.returncode}: {se[-2000:]}")
    check(json.loads(so.strip().splitlines()[-1])["state"] == "done",
          f"fleet-gateway: submit printed {so[-500:]}")
    with open(sub_out) as f:
        check([json.loads(x) for x in f if x.strip()]
              == views[jid]["records"],
              "fleet-gateway: submit's --records-out differs from the "
              "gateway's record tail")
    for row in SERVE_JOBS:
        v = views[row[0]]
        check(v["state"] == "done" and v["result"]["gens"] == row[3],
              f"fleet-gateway: {row[0]} {v['state']} {v.get('error')}")
        check(not v["records_truncated"],
              f"fleet-gateway: {row[0]}'s records truncated")
        check(strip_timing(v["records"])
              == strip_timing(_job_records(line_json, row[0])),
              f"fleet-gateway: {row[0]} through the gateway differs from "
              f"its line-JSON records")
    view = fl.view()
    router = view["router"]
    owners = {views[j]["replica"] for j in ids}
    check(owners == {"r0", "r1"},
          f"fleet-gateway: two buckets, owners {owners}")
    check(router["misses"] == 0 and router["warmups"] == 2
          and router["affinity_hits"] == len(ids) - 2,
          f"fleet-gateway: router {router}")
    reps = {r["name"]: r["url"] for r in view["replicas"]}
    lane_gens, launches = 0.0, {}
    for name, url in reps.items():
        lane_gens += fl.metric(url, "tt_serve_gens_total")
        mine = {k: fl.metric(url, f"tt_kernels_launches_{k}")
                for k in LANES + ("random_ls_events", "survivors",
                                  "assign_rooms", "batch_penalty")
                + SERVE_NEVER}
        for k in LANES + ("random_ls_events", "survivors"):
            check(mine[k] > 0,
                  f"fleet-gateway: {name} never launched {k}")
        for k in SERVE_NEVER:
            check(mine[k] == 0,
                  f"fleet-gateway: {name} launched {k} {mine[k]} times")
        launches[name] = {k: int(v) for k, v in mine.items() if v}

    # /v1/usage: the workers' ledgers summed, once the prober read them
    def usage_agrees():
        fleet = fl.get("/v1/usage")
        want = obs_usage.aggregate(
            [(n, False, _get_url(u + "/v1/usage")) for n, u in
             reps.items()])
        return (fleet["tenants"], fleet["jobs"]) == (want["tenants"],
                                                      want["jobs"])
    deadline = time.monotonic() + 30.0
    while not usage_agrees():
        check(time.monotonic() < deadline,
              "fleet-gateway: /v1/usage never equal to the workers' sum")
        time.sleep(0.2)
    out.update(jobs_equal=len(ids), http_wall_s=wall, lane_gens=lane_gens,
               lane_gens_per_s_gateway=lane_gens / wall,
               lane_gens_per_s_line_json=serve_summary["lane_gens_per_s"],
               affinity_hit_rate=router["affinity_hit_rate"],
               routing=router, launches=launches,
               usage_tenants=fl.get("/v1/usage")["tenants"])
    return out


def _fleet_failover(fl, texts, long_base):
    """(b) and (c): a SIGKILLed owner, then a targeted preempt."""
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    from timetabling_ga_tpu_torch.runtime.config import ServeConfig
    out = {}
    quantum = ServeConfig().quantum
    jid, tim, seed, gens = FLEET_LONG
    fl.post("/v1/solve", _fleet_payload_of((jid, tim, seed, gens, 0),
                                           texts))
    # (b) kill the owner while the gateway's cached wire is at its cursor
    deadline = time.monotonic() + 120.0
    while True:
        v = fl.get(f"/v1/jobs/{jid}?records=0&snapshot=1", timeout=30.0)
        owner = v.get("replica")
        wire = v.get("snapshot")
        if owner and wire and wire["gens_done"] >= quantum:
            rep = fl.replica(owner)
            t_read = time.monotonic()
            cursor = _get_url(
                f"{rep['url']}/v1/jobs/{jid}?records=0")["gens"]
            if cursor == wire["gens_done"]:
                pid = _serving_pids(fl.ports)[
                    int(rep["url"].rsplit(":", 1)[1])]
                os.kill(pid, signal.SIGKILL)
                t_kill = time.monotonic()
                break
        check(v["state"] not in FLEET_SETTLED and time.monotonic()
              < deadline, f"fleet-gateway: no kill point for {jid}: "
              f"{v['state']}")
        time.sleep(0.005)
    survivor = "r1" if owner == "r0" else "r0"
    while fl.get(f"/v1/jobs/{jid}?records=0").get("replica") != survivor:
        check(time.monotonic() - t_kill < 60.0,
              f"fleet-gateway: {jid} never moved to {survivor}")
        time.sleep(0.005)
    kill_to_resumed = time.monotonic() - t_kill
    # (c) the killed worker respawned, then a preempt moves a job to it
    while True:
        r = fl.replica(owner)
        if r["restarts"] == 1 and r["ready"] and not r["dead"]:
            break
        check(time.monotonic() - t_kill < 180.0,
              f"fleet-gateway: {owner} never came back: {r}")
        time.sleep(0.02)
    respawn_ready = time.monotonic() - t_kill
    jid3 = "f3"
    fl.post("/v1/solve", _fleet_payload_of((jid3, tim, seed, gens, 0),
                                           texts))
    deadline = time.monotonic() + 120.0
    while True:
        v3 = fl.get(f"/v1/jobs/{jid3}?records=0")
        owner3 = v3.get("replica")
        if owner3:
            rep3 = fl.replica(owner3)
            g3 = _get_url(f"{rep3['url']}/v1/jobs/{jid3}?records=0"
                            ).get("gens", 0)
            if g3 >= FLEET_PREEMPT_AT:
                break
        check(time.monotonic() < deadline,
              f"fleet-gateway: {jid3} never reached "
              f"{FLEET_PREEMPT_AT} generations")
        time.sleep(0.01)
    pid3 = _serving_pids(fl.ports)[int(rep3["url"].rsplit(":", 1)[1])]
    t_pre = time.monotonic()
    ack = fl.post(f"/v1/drain?mode=preempt&replica={owner3}", {},
                  ok=(202,))
    check(ack == {"preempting": owner3},
          f"fleet-gateway: the preempt answered {ack}")
    while _alive(pid3):
        check(time.monotonic() - t_pre < 60.0,
              f"fleet-gateway: {owner3} did not exit after its preempt")
        time.sleep(0.005)
    preempt_to_exit = time.monotonic() - t_pre
    views = fl.settle([jid, jid3], "the failed-over jobs", timeout=300.0)
    res3 = views[jid3]["result"]
    for j in (jid, jid3):
        check(views[j]["state"] == "done"
              and views[j]["result"]["gens"] == gens,
              f"fleet-gateway: {j} {views[j]['state']}")
        check(strip_timing(_as_job(views[j]["records"], jid)) == long_base,
              f"fleet-gateway: {j} differs from its uninterrupted run")
    check(views[jid3]["replica"] != owner3,
          f"fleet-gateway: {jid3} still on {owner3}")
    # the gateway's `resume` spans: each failover's fence, in order (f1
    # may move twice: at the kill, and again if the preempt found it)
    deadline = time.monotonic() + 30.0
    while True:
        spans = [r["spanEntry"] for r in fl.records()
                 if r.get("spanEntry", {}).get("name") == "resume"]
        fences = {j: [sp["gens"] for sp in spans if sp.get("job") == j]
                  for j in (jid, jid3)}
        if fences[jid] and fences[jid3]:
            break
        check(time.monotonic() < deadline,
              f"fleet-gateway: resume spans {fences}")
        time.sleep(0.05)
    kill_fence = fences[jid][0]
    # (b)'s bound: the wire was at the cursor when read, and the owner
    # could pass at most one more fence before the signal landed
    check(kill_fence >= cursor > 0,
          f"fleet-gateway: {jid} resumed at {kill_fence}, cursor "
          f"{cursor} at the kill (more than a quantum re-run)")
    preempted = [r["jobEntry"] for r in fl.records(owner3)
                 if r.get("jobEntry", {}).get("job") == jid3
                 and r["jobEntry"]["event"] == "preempted"]
    check(len(preempted) == 1 and preempted[0]["shipped"] is True,
          f"fleet-gateway: {owner3}'s log: {preempted}")
    check(res3["resumed_at"] == fences[jid3][-1] == preempted[0]["gens"]
          > 0, f"fleet-gateway: {jid3} resumed at {res3['resumed_at']}, "
          f"preempted at {preempted[0]['gens']}")
    hits = fl.metric(fl.url, "tt_fleet_resume_hits_total")
    check(hits >= 2, f"fleet-gateway: fleet.resume.hits {hits}")
    out.update(killed=owner, kill_cursor_gens=cursor,
               read_to_kill_ms=1e3 * (t_kill - t_read),
               kill_resumed_at=kill_fence,
               # the owner had done cursor or, had a fence passed between
               # the read and the signal, cursor + a quantum
               gens_rerun_at_kill_at_most=cursor + quantum - kill_fence,
               kill_to_resumed_s=kill_to_resumed,
               f1_fences=fences[jid],
               respawn_ready_after_kill_s=respawn_ready,
               preempted=owner3, preempted_at=preempted[0]["gens"],
               preempt_resumed_at=res3["resumed_at"],
               gens_rerun_at_preempt=(preempted[0]["gens"]
                                      - res3["resumed_at"]),
               preempt_to_exit_s=preempt_to_exit,
               pid_preempted=pid3, resume_hits=hits)
    return out


def _fleet_exits(fl, exits, router):
    """(e)'s checks after the first gateway's drain: each worker's last
    incarnation and the preempted one exit 0, the killed one -9; the
    log's routeEntry lines agree with the router's stats; each worker's
    usageEntry flops above 0."""
    out = {}
    by_pid = {pid: (name, rc) for name, pid, rc in exits}
    killed = [x for x in exits if x[2] == -9]
    check(len(killed) == 1, f"fleet-gateway: exits {exits}")
    clean = [x for x in exits if x[2] == 0]
    check(len(clean) == len(exits) - 1 and len(clean) >= 3,
          f"fleet-gateway: exits {exits}")
    recs = fl.records()
    routes = [r["routeEntry"] for r in recs if "routeEntry" in r]
    tally = {o: sum(1 for r in routes if r["outcome"] == o)
             for o in ("hit", "warm", "miss")}
    check(len(routes) == router["routed"]
          and tally["hit"] == router["affinity_hits"]
          and tally["warm"] == router["warmups"]
          and tally["miss"] == router["misses"],
          f"fleet-gateway: routeEntry {tally} ({len(routes)}) against "
          f"/v1/fleet {router}")
    first = {}
    for r in routes:
        if r["job"] in {row[0] for row in SERVE_JOBS}:
            b = tuple(r["bucket"])
            want = "warm" if b not in first else "hit"
            first.setdefault(b, r["replica"])
            check(r["outcome"] == want,
                  f"fleet-gateway: {r['job']} landed {r['outcome']}")
    for name in ("r0", "r1"):
        flops = sum(r["usageEntry"].get("flops", 0)
                    for r in fl.records(name) if "usageEntry" in r)
        check(flops > 0, f"fleet-gateway: {name}'s usageEntry flops "
              f"{flops}")
        out[f"usage_flops_{name}"] = flops
    out.update(exits=exits, routes=tally, router_final=router)
    return out


def _fleet_autoscaler(texts, line_json):
    """(d): the autoscaler's gateway over one worker."""
    from timetabling_ga_tpu_torch.problem import dump_tim, load_tim_file
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    out = {}
    fl = _Fleet("fleet_scale", [*FLEET_SCALE, *FLEET_CADENCE, "--",
                                *FLEET_WORKER_ARGS])
    try:
        out["replica_boot_s"] = fl.wait_ready(["r0"], "the first worker")
        burst = [("a" + str(k) + "-", row) for k in (1, 2)
                 for row in SERVE_JOBS]
        for prefix, row in burst:
            fl.post("/v1/solve", _fleet_payload_of(row, texts, prefix))
        deadline = time.monotonic() + 60.0
        while fl.metric(fl.url, "tt_fleet_scale_ups_total") < 1:
            check(time.monotonic() < deadline,
                  "fleet-gateway: the burst never scaled up")
            time.sleep(0.02)
        t_up = time.monotonic()
        ready = fl.wait_ready(["s0"], "the spawned worker", since=t_up)
        # a bucket of its own: the least loaded, least pinned replica
        fresh = dump_tim(cut_problem(load_tim_file(TIM), 200))
        fl.post("/v1/solve", {"id": "fresh", "tim": fresh, "seed": 9,
                              "generations": 50})
        ids = [p + row[0] for p, row in burst] + ["fresh"]
        views = fl.settle(ids, "the burst", timeout=300.0)
        t_served = time.monotonic()
        check(views["fresh"]["replica"] == "s0"
              and views["fresh"]["state"] == "done",
              f"fleet-gateway: the fresh bucket's job "
              f"{views['fresh']['replica']} {views['fresh']['state']}")
        for prefix, row in burst:
            v = views[prefix + row[0]]
            check(v["state"] == "done"
                  and strip_timing(_as_job(v["records"], row[0]))
                  == strip_timing(_job_records(line_json, row[0])),
                  f"fleet-gateway: {prefix + row[0]} differs")
        deadline = time.monotonic() + 60.0
        while fl.metric(fl.url, "tt_fleet_scale_downs_total") < 1:
            check(time.monotonic() < deadline,
                  "fleet-gateway: idle never scaled down")
            time.sleep(0.02)
        t_down = time.monotonic()
        retired = None
        while retired is None:
            retired = next((r["scaleEntry"]["replica"]
                            for r in fl.records() if r.get(
                                "scaleEntry", {}).get("action") == "down"
                            and not r["scaleEntry"].get("blocked")), None)
            check(time.monotonic() - t_down < 30.0,
                  "fleet-gateway: no scaleEntry down on the log")
            time.sleep(0.02)
        pid = _serving_pids(fl.ports).get(
            int(fl.replica(retired)["url"].rsplit(":", 1)[1]))
        while pid is not None and _alive(pid):
            check(time.monotonic() - t_down < 60.0,
                  f"fleet-gateway: the retired {retired} never exited")
            time.sleep(0.01)
        down_to_exit = time.monotonic() - t_down
        drained_s, exits = fl.drain("the autoscaler's gateway")
        check(sorted(name for name, _, _ in exits) == ["r0", "s0"]
              and all(rc == 0 for _, _, rc in exits),
              f"fleet-gateway: the autoscaler's exits {exits}")
        entries = [r["scaleEntry"] for r in fl.records()
                   if "scaleEntry" in r]
        acted = [(e["action"], e["reason"], e.get("replica"))
                 for e in entries if not e.get("blocked")]
        check(acted[:1] == [("up", "queue_depth", "s0")]
              and any(a[:2] == ("down", "idle") for a in acted),
              f"fleet-gateway: scale decisions {acted}")
        out.update(decisions=acted, up_to_ready_s=ready["s0"],
                   up_to_served_s=t_served - t_up, retired=retired,
                   down_to_exit_s=down_to_exit,
                   up_decision_ts=next(e["ts"] for e in entries
                                       if e["action"] == "up"),
                   exits=exits, drain_to_exit_s=drained_s)
    finally:
        fl.kill()
    return out


def run_cli(name, argv, tim=TIM):
    """Run the CLI with `argv` (output to build/chip_smoke/), the launch
    counters zeroed just before and read just after; returns (records,
    seconds, launches)."""
    from timetabling_ga_tpu_torch import cli, kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"comp01s_s42_{name}.jsonl")
    kernels.reset_launches()
    t0 = time.monotonic()
    rc = cli.main(["-i", tim, "-o", path] + argv)
    seconds = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    check(rc == 0, f"{name}: cli exited {rc}")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return records, seconds, launches


def _fresh(path):
    for p in (path, path + ".prev"):
        if os.path.exists(p):
            os.unlink(p)
    return path


def _phases(records, name):
    return [r["phase"] for r in records
            if "phase" in r and r["phase"]["name"] == name]


def _dispatched(records):
    return sum(p["gens"] for p in _phases(records, "dispatch"))


def _rate(records):
    """Generations per second of a run's dispatches."""
    d = _phases(records, "dispatch")
    return sum(p["gens"] for p in d) / sum(p["seconds"] for p in d)


def _check_resumed(name, records, gen0, floor, gen1):
    """A resumed run: it ran gen1 - gen0 generations, and each island's
    logEntry bests fall, below the saved floor."""
    check(_dispatched(records) == gen1 - gen0,
          f"{name}: {_dispatched(records)} generations, not "
          f"{gen1} - {gen0}")
    for r in records:
        if "logEntry" in r:
            e = r["logEntry"]
            check(e["best"] < floor[e["procID"]],
                  f"{name}: logEntry {e['best']} not below the saved "
                  f"floor {floor[e['procID']]}")


# the profile phase's worker-started capture: the main path's tuned
# defaults with the pull front, --profile-for 2 at launch, -t long
# enough for the client's second capture to land: the launch
# capture's stop and attribution take seconds, and the dispatches
# beside them slow down
PROF_MAIN = ["-s", "42", "-t", "30", "--generations", "100000", "--trace",
             "--obs"]
# the scopes' cost: reference-path legs of this many generations
PROF_SCOPE_GENS = 600

# the `profile` client's process: it waits for the launch capture to
# land (GET /profile?last=1 at argv[1]), then becomes `python -m
# timetabling_ga_tpu_torch profile URL --for 1 --attribute`
PROF_CLIENT = r"""
import json, os, sys, time, urllib.request
url = sys.argv[1]
t0 = time.monotonic()
while time.monotonic() - t0 < 120:
    try:
        with urllib.request.urlopen(url + "/profile?last=1", timeout=5) as r:
            if json.loads(r.read()).get("completed", 0) >= 1:
                break
    except OSError:
        pass
    time.sleep(0.2)
os.execv(sys.executable, [sys.executable, "-m", "timetabling_ga_tpu_torch",
                          "profile", url, "--for", "1", "--attribute",
                          "--timeout", "60"])
"""

# a gens/s leg runner for the scopes' cost: one process per setting of
# TT_PROF_SCOPES (read at import), each running the reference legs fed
# to it on stdin, one JSON argv a line, and answering each with the
# leg's generations a second of its gen-loop
SCOPE_LEGS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from timetabling_ga_tpu_torch import cli, kernels
kernels.build()
print(json.dumps({"ready": True}), flush=True)
for line in sys.stdin:
    argv = json.loads(line)
    rc = cli.main(argv)
    with open(argv[argv.index("-o") + 1]) as f:
        recs = [json.loads(x) for x in f]
    ph = [r["phase"] for r in recs if "phase" in r]
    gens = sum(p["gens"] for p in ph if p["name"] == "dispatch")
    loop = [p for p in ph if p["name"] == "gen-loop"][-1]
    print(json.dumps({"rc": rc, "gens": gens,
                      "gens_per_s": gens / loop["seconds"]}), flush=True)
"""


def _device_seconds(trace_path):
    """Kernel, memcpy and memset time summed straight off a Chrome
    trace, in seconds (the attribution's independent check)."""
    import gzip
    with gzip.open(trace_path, "rt") as f:
        doc = json.load(f)
    return sum(float(e.get("dur", 0)) for e in doc.get("traceEvents", [])
               if isinstance(e, dict) and e.get("ph") == "X"
               and str(e.get("cat", "")).lower()
               in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e6


def _newest_trace(capture_dir):
    import glob
    runs = sorted(glob.glob(os.path.join(capture_dir, "plugins", "profile",
                                         "*")))
    check(runs, f"profile: no capture under {capture_dir}")
    files = glob.glob(os.path.join(runs[-1], "*.pt.trace.json.gz"))
    check(len(files) == 1, f"profile: trace files {files}")
    return files[0], len(runs)


def _trace_has_ranges(trace_path):
    """True when the capture holds `tt.*` ranges on the card's timeline
    (gpu_user_annotation), False when it recorded kernels only."""
    import gzip
    from timetabling_ga_tpu_torch.obs import prof
    with gzip.open(trace_path, "rt") as f:
        doc = json.load(f)
    return any(isinstance(e, dict) and e.get("name") in prof.PHASES
               and str(e.get("cat", "")).lower() == "gpu_user_annotation"
               for e in doc.get("traceEvents", []))


def scopes_cost():
    """(d) gens/s of the reference path with the scopes on and with
    TT_PROF_SCOPES=0, each in a process of its own started together, the
    legs interleaved on, off, on, off at the same generation budget."""
    procs = {}
    argv0 = PIPE[:PIPE.index("--generations")] + [
        "--generations", str(PROF_SCOPE_GENS)]
    try:
        for name, val in (("on", "1"), ("off", "0")):
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", SCOPE_LEGS, HERE], cwd=HERE,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                env={**os.environ, "TT_PROF_SCOPES": val})
        for name, p in procs.items():
            check(json.loads(p.stdout.readline()).get("ready"),
                  f"profile: the scopes-{name} process did not start")
        rates = {"on": [], "off": []}
        for i in range(2):
            for name in ("on", "off"):
                out = os.path.join(OUT_DIR, f"prof_scopes_{name}{i}.jsonl")
                p = procs[name]
                p.stdin.write(json.dumps(
                    ["-i", TIM, "-o", out] + argv0) + "\n")
                p.stdin.flush()
                res = json.loads(p.stdout.readline())
                check(res["rc"] == 0 and res["gens"] == PROF_SCOPE_GENS,
                      f"profile: scopes-{name} leg {res}")
                rates[name].append(res["gens_per_s"])
    finally:
        for p in procs.values():
            if p.stdin:
                p.stdin.close()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for name, p in procs.items():
        check(p.returncode == 0, f"profile: scopes-{name} exited "
                                 f"{p.returncode}")
    on, off = sum(rates["on"]) / 2, sum(rates["off"]) / 2
    return {"gens_per_s_on": rates["on"], "gens_per_s_off": rates["off"],
            "ratio_on_off": on / off}


def profile_path(pa_cpu):
    """The profile phase, (a)-(e): a --trace-profile capture of the
    reference path; a worker-started capture of the main path (launch
    and `profile` client) with hotspots on its log; stream equality;
    the scopes' cost; serve's counted flops. Returns (summary, launches
    by leg)."""
    import shutil
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.obs import prof
    from timetabling_ga_tpu_torch.parallel import islands
    from timetabling_ga_tpu_torch.problem import dump_tim
    from timetabling_ga_tpu_torch.runtime import jsonl
    out, launches = {"card": CARD}, {}
    # (a) one synchronous capture on the reference path
    adir = os.path.join(OUT_DIR, "prof_trace")
    shutil.rmtree(adir, ignore_errors=True)
    t0 = time.monotonic()
    recs_a, secs_a, launches["prof-a"] = run_cli(
        "prof-a", PIPE + ["--trace-profile", adir])
    check_stream(recs_a, pa_cpu)
    ph = _phases(recs_a, "profile")
    check(len(ph) == 1 and ph[0]["dir"] == adir,
          f"profile (a): profile phase records {ph}")
    ta = time.monotonic()
    attr = prof.attribute(adir)
    attr_s = time.monotonic() - ta
    trace_a, _ = _newest_trace(adir)
    dev_s = _device_seconds(trace_a)
    check(attr["unattributed_frac"] <= 0.10,
          f"profile (a): unattributed {attr['unattributed_frac']}")
    delta = attr["phases"].get("delta", {})
    check(delta and prof.kernel_entry(delta["top_ops"][0][0]) == "random_ls",
          f"profile (a): delta's top op {delta.get('top_ops')}")
    check(abs(attr["total_s"] - dev_s) <= 0.02 * dev_s,
          f"profile (a): attributed {attr['total_s']} s against "
          f"{dev_s} s of device time")
    out["a"] = {"wall_s": round(secs_a, 3), "capture_s": ph[0]["seconds"],
                "attribute_s": attr_s, "n_events": attr["n_events"],
                "total_s": attr["total_s"], "device_s": dev_s,
                "unattributed_frac": attr["unattributed_frac"],
                "phases": {k: [v["seconds"], v["frac"],
                               v["top_ops"][0][0][:40]]
                           for k, v in attr["phases"].items()},
                "ranges": _trace_has_ranges(trace_a)}
    # (b) worker-started captures: --profile-for 2 at launch, then the
    # `profile` client's, from a process of its own
    bdir = os.path.join(OUT_DIR, "prof_worker")
    shutil.rmtree(bdir, ignore_errors=True)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    client = subprocess.Popen([sys.executable, "-c", PROF_CLIENT, url],
                              cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        with _FreshRegistry() as reg:
            recs_b, secs_b, launches["prof-b"] = run_cli(
                "prof-b", PROF_MAIN + ["--obs-listen", f"127.0.0.1:{port}",
                                       "--profile-dir", bdir,
                                       "--profile-for", "2"])
            gauges = reg.snapshot()["gauges"]
        cout, cerr = client.communicate(timeout=120)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
    check(client.returncode == 0,
          f"profile (b): the client exited {client.returncode}: {cerr}")
    check("== phases (" in cout, f"profile (b): client output {cout}")
    check_stream(recs_b, pa_cpu, ("spanEntry", "metricsEntry",
                                  "costEntry", "profEntry"))
    trace_b, n_runs = _newest_trace(bdir)
    check(n_runs == 2, f"profile (b): {n_runs} captures landed")
    entries = [r["profEntry"] for r in recs_b if "profEntry" in r]
    check(len(entries) == 2, f"profile (b): {len(entries)} profEntry "
                             f"records")
    post = entries[-1]["phases"]
    check(post and max(post, key=lambda k: post[k]["s"]) == "sweep",
          f"profile (b): the post capture's phases {post}")
    log_b = os.path.join(OUT_DIR, "comp01s_s42_prof-b.jsonl")
    hs = _reader(["hotspots", log_b])
    check(hs.returncode == 0 and "== phases (" in hs.stdout,
          f"profile (b): hotspots LOG: {hs.stderr}")
    hd = _reader(["hotspots", "--diff", adir, log_b])
    check(hd.returncode == 0 and "== phase diff" in hd.stdout,
          f"profile (b): hotspots --diff: {hd.stderr}")
    out["b"] = {"wall_s": round(secs_b, 3),
                "ranges": _trace_has_ranges(trace_b),
                "launch_capture": {k: v["s"] for k, v in
                                   entries[0]["phases"].items()},
                "post_capture": {k: v["s"] for k, v in post.items()},
                "post_unattributed_frac": entries[-1]["unattributedFrac"],
                "prof_gauges": sorted(k for k in gauges
                                      if k.startswith("prof.")),
                "client": next(x for x in cout.splitlines()
                               if x.startswith("== phases ("))}
    # (c) (a)'s config without a capture and with --profile-for
    streams = {"trace-profile": jsonl.strip_timing(recs_a)}
    for name, extra in (("none", []),
                        ("profile-for", ["--profile-for", "1",
                                         "--profile-dir",
                                         os.path.join(OUT_DIR,
                                                      "prof_c")])):
        recs, _, launches["prof-c-" + name] = run_cli("prof-c-" + name,
                                                      PIPE + extra)
        streams[name] = jsonl.strip_timing(recs)
    check(streams["none"] == streams["trace-profile"]
          == streams["profile-for"],
          "profile (c): the streams differ with a capture")
    out["c"] = {"equal": True, "records": len(streams["none"])}
    # (d) the scopes' cost
    out["d"] = scopes_cost()
    # (e) serve: each dispatch usageEntry's flops is its quantum's
    # counted work
    req = os.path.join(OUT_DIR, "prof_serve_requests.jsonl")
    serve_requests(req, dump_tim(itc_problem()))
    counted = []
    lane_run = islands.lane_run

    def spy(*a, **k):
        o0 = kernels.WORK["ops"]
        res = lane_run(*a, **k)
        counted.append(kernels.WORK["ops"] - o0)
        return res

    islands.lane_run = spy
    try:
        with _FreshRegistry() as reg:
            recs_e, secs_e, launches["prof-serve"], _ = run_serve(
                "prof", req, ["--obs"])
            util = reg.gauge("cost.flop_utilization_pct").value
            tflops = reg.gauge("cost.achieved_tflops").value
    finally:
        islands.lane_run = lane_run
    disp = sorted((r["usageEntry"] for r in recs_e if "usageEntry" in r
                   and "dispatch" in r["usageEntry"]),
                  key=lambda u: u["dispatch"])
    check(disp and len(disp) == len(counted),
          f"profile (e): {len(disp)} usageEntry for {len(counted)} quanta")
    for u, c in zip(disp, counted):
        check(c > 0 and u["flops"] == float(c),
              f"profile (e): usageEntry flops {u['flops']} for {c}")
        check(sum(x["flops"] for x in u["lanes"]) == u["flops"],
              "profile (e): the lanes' flops do not sum")
    check(0 < util <= 100, f"profile (e): flop_utilization_pct {util}")
    out["e"] = {"dispatches": len(disp), "flops": sum(counted),
                "flops_per_dispatch": sum(counted) / len(counted),
                "flop_utilization_pct": util, "achieved_tflops": tflops,
                "wall_s": round(secs_e, 3)}
    out["seconds"] = round(time.monotonic() - t0, 3)
    torch.cuda.synchronize()
    return out, launches


def resume_path(pa_cpu, gens=300):
    """The checkpoint/resume path on comp01s: (a) 300 generations of the
    reference config checkpointed every epoch in stats mode, (b) resumed
    to 600, (c) 600 uninterrupted in full mode; the final checkpoints
    equal bit for bit, (a)'s logEntry values then (b)'s equal (c)'s, and
    K13 runs on (a) and (b), never on (c). Then the tuned main path, -t
    15 with a checkpoint in stats mode, resumed for another -t 15: it
    starts at the saved generation, stays below the saved floor, and its
    population kept the tuned 16 rows (post_pop_size dropped). Returns
    (summary, launches by path)."""
    import numpy as np
    from timetabling_ga_tpu_torch.runtime import config, jsonl
    a_ck = _fresh(os.path.join(OUT_DIR, "resume_A.npz"))
    c_ck = _fresh(os.path.join(OUT_DIR, "resume_B.npz"))
    ck = ["--checkpoint-every", "1", "--trace-mode", "stats"]
    runs = {}
    for name, argv in (
            ("resume-a", ["--generations", str(gens), "--checkpoint", a_ck]
             + ck),
            ("resume-b", ["--generations", str(2 * gens), "--checkpoint",
                          a_ck, "--resume"] + ck),
            ("resume-c", ["--generations", str(2 * gens), "--checkpoint",
                          c_ck])):
        runs[name] = run_cli(name, RESUME + argv)
    (a, _, la), (b, _, lb), (c, _, lc) = runs.values()
    # (b) may improve on no floor; its values are held against (c)'s
    check_stream(a, pa_cpu)
    check_stream(c, pa_cpu)
    check(_dispatched(a) == gens and _dispatched(b) == gens
          and _dispatched(c) == 2 * gens, "resume: generations per run")
    with np.load(a_ck) as za, np.load(c_ck) as zc:
        for k in ("slots", "rooms", "penalty", "hcv", "scv", "generation",
                  "best_seen"):
            check(np.array_equal(za[k], zc[k]),
                  f"resume: final checkpoints differ in {k}")
        check(int(za["generation"]) == 2 * gens,
              "resume: final generation")

    def logs(recs):
        return jsonl.strip_timing([r for r in recs if "logEntry" in r])
    check(logs(a) + logs(b) == logs(c),
          "resume: (a) then (b) logEntry values differ from (c)'s")
    for name, la_ in (("resume-a", la), ("resume-b", lb)):
        check(la_["compress_trace"] > 0, f"{name}: K13 never launched")
    check(lc["compress_trace"] == 0 and lc["moment_rows"] == 0,
          "resume-c: K13 launched in full mode")
    m_ck = _fresh(os.path.join(OUT_DIR, "resume_main.npz"))
    tuned = config.parse_args(["-i", TIM, "--checkpoint", m_ck]
                              + RESUME_MAIN).apply_tuned_defaults(400)
    check(tuned.post_pop_size is None,
          "resume-main: tuned post_pop_size kept under --checkpoint")
    m1, s1, l1 = run_cli("resume-main-1",
                         RESUME_MAIN + ["--checkpoint", m_ck])
    check_stream(m1, pa_cpu)
    with np.load(m_ck) as z:
        gen0, floor = int(z["generation"]), z["best_seen"].tolist()
    m2, s2, l2 = run_cli("resume-main-2",
                         RESUME_MAIN + ["--checkpoint", m_ck, "--resume"])
    with np.load(m_ck) as z:
        gen1, rows = int(z["generation"]), z["slots"].shape[0]
    _check_resumed("resume-main-2", m2, gen0, floor, gen1)
    check(rows == tuned.pop_size,
          f"resume-main: {rows} rows saved, not the tuned {tuned.pop_size}")
    check(l1["moment_rows"] > 0, "resume-main-1: moment_rows never ran")
    saves = [p["seconds"] * 1e3 for r in (a, b, m1, m2)
             for p in _phases(r, "checkpoint")]
    summary = dict(
        generations=[_dispatched(r) for r in (a, b, c)],
        gens_per_s=[_rate(r) for r in (a, b, c)],
        checkpoint_ms=dict(n=len(saves), mean=sum(saves) / len(saves),
                           max=max(saves)),
        wall_s=[round(x[1], 3) for x in runs.values()],
        final_best=[r["runEntry"]["totalBest"] for r in (a[-1], b[-1],
                                                          c[-1])],
        main_saved_generation=gen0, main_final_generation=gen1,
        main_wall_s=[round(s1, 3), round(s2, 3)],
        main_gens_per_s=[_rate(m1), _rate(m2)],
        main_final_best=[m1[-1]["runEntry"]["totalBest"],
                         m2[-1]["runEntry"]["totalBest"]])
    launches = {name: launch for name, (_, _, launch) in runs.items()}
    launches["resume-main-1"], launches["resume-main-2"] = l1, l2
    launches["resume"] = {k: la[k] + lb[k] for k in la}
    launches["resume-main"] = {k: l1[k] + l2[k] for k in l1}
    return summary, launches


def trace_modes_path(pa_cpu, gens=300):
    """The reference config on comp01s for `gens` generations in each
    trace mode: the three record streams equal under strip_timing, K13
    launched in deltas and stats and never in full. Returns the runs'
    generations per second by mode."""
    from timetabling_ga_tpu_torch.runtime import jsonl
    streams, rates = {}, {}
    for mode in ("full", "deltas", "stats"):
        recs, _, launch = run_cli(f"trace-{mode}", RESUME + [
            "--generations", str(gens), "--trace-mode", mode])
        check_stream(recs, pa_cpu)
        check((launch["compress_trace"] > 0) == (mode != "full"),
              f"trace-{mode}: K13 launched {launch['compress_trace']} "
              f"times")
        streams[mode] = jsonl.strip_timing(recs)
        rates[mode] = _rate(recs)
    for mode in ("deltas", "stats"):
        check(streams[mode] == streams["full"],
              f"trace-{mode}: record stream differs from full")
    return rates


def quality_path(pa_cpu, gens=300):
    """The reference config on comp01s for `gens` generations without and
    with --quality: the record streams equal under strip_timing, K14
    launched only with it (quality_ops every generation, div_stats every
    dispatch), the quality counters in the registry. Returns (rates,
    launches of the quality run)."""
    from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
    from timetabling_ga_tpu_torch.runtime import jsonl
    streams, rates, launches, n_disp = {}, {}, {}, 0
    for name, extra in (("quality-off", []), ("quality", ["--quality"])):
        before = REGISTRY.counter("quality.ops.crossover_attempts").value
        recs, _, launches[name] = run_cli(name, RESUME + [
            "--generations", str(gens)] + extra)
        check_stream(recs, pa_cpu)
        streams[name] = jsonl.strip_timing(recs)
        n_disp = len(_phases(recs, "dispatch"))
        rates[name] = _rate(recs)
        moved = REGISTRY.counter("quality.ops.crossover_attempts").value \
            - before
        check((moved > 0) == bool(extra),
              f"{name}: quality counters moved by {moved}")
    check(streams["quality"] == streams["quality-off"],
          "quality: record stream differs from the run without --quality")
    on, off = launches["quality"], launches["quality-off"]
    check(all(off[k] == 0 for k in K14),
          f"quality-off: K14 launched {[off[k] for k in K14]} times")
    check(on["quality_ops"] >= gens and on["div_stats"] >= n_disp > 0,
          f"quality: quality_ops {on['quality_ops']}, div_stats "
          f"{on['div_stats']} launches in {gens} generations and "
          f"{n_disp} dispatches")
    return rates, on


def stall_path():
    """The stall fixture (JAX tests/test_quality.py's instance: 30
    events, 4 rooms, 20 students) with the sweep and --quality
    --stall-window 2 --stall-hamming 1.0 --auto-kick-on-stall: a
    quality/stall faultEntry, then a quality/kick one (moves >= 3),
    engine.kicks counted, K5 and K14 launched. Returns its summary."""
    from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
    from timetabling_ga_tpu_torch.problem import (
        dump_tim, load_tim_file, random_instance)
    tim = os.path.join(OUT_DIR, "stall.tim")
    with open(tim, "w") as f:
        f.write(dump_tim(random_instance(1, n_events=30, n_rooms=4,
                                         n_features=3, n_students=20,
                                         attend_prob=0.15)))
    kicks0 = REGISTRY.counter("engine.kicks").value
    recs, seconds, launch = run_cli("stall", STALL, tim)
    check_stream(recs, load_tim_file(tim).device_arrays("cpu"),
                 ("faultEntry",))
    faults = [r["faultEntry"] for r in recs if "faultEntry" in r]
    acts = [(f["site"], f["action"]) for f in faults]
    check(("quality", "stall") in acts, f"stall: no stall record {acts}")
    first = acts.index(("quality", "stall"))
    check(("quality", "kick") in acts[first:],
          f"stall: no kick record after the stall {acts}")
    kicks = [f for f in faults if f["action"] == "kick"]
    check(kicks[0]["moves"] >= 3, f"stall: kick moves {kicks[0]}")
    n_kicks = REGISTRY.counter("engine.kicks").value - kicks0
    check(n_kicks >= 1 and n_kicks == len(kicks),
          f"stall: engine.kicks moved by {n_kicks}, {len(kicks)} kicks")
    for k in ("sweep_pass",) + K14:
        check(launch[k] > 0, f"stall: {k} never launched")
    return dict(stalls=acts.count(("quality", "stall")), kicks=len(kicks),
                kick_moves=[f["moves"] for f in kicks],
                engine_kicks=n_kicks, wall_s=round(seconds, 3),
                gens_per_s=_rate(recs),
                launches={k: launch[k] for k in (
                    "sweep_pass", "breed", "migrate") + K14})


class _SyncDebug:
    """Every dispatch of the engine's generation loop (islands.
    mesh_run_epochs, the enqueue of its trace's copy) and every retire's
    event wait under torch.cuda.set_sync_debug_mode("error"): a hidden
    host synchronization there raises instead of serializing the
    pipeline without a word."""

    def __enter__(self):
        import torch
        from timetabling_ga_tpu_torch.parallel import islands
        from timetabling_ga_tpu_torch.runtime import dispatch_core as dcore

        def strict(fn):
            def wrapped(*a, **k):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            return wrapped

        class StrictCopy(dcore.HostCopy):
            __init__ = strict(dcore.HostCopy.__init__)
            wait = strict(dcore.HostCopy.wait)

        # the mode is armed: a host read raises under it
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.zeros(1, device="cuda").item()
            armed = False
        except RuntimeError:
            armed = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(armed, "sync debug mode: .item() did not raise")
        self._saved = (islands.mesh_run_epochs, dcore.HostCopy)
        islands.mesh_run_epochs = strict(islands.mesh_run_epochs)
        dcore.HostCopy = StrictCopy
        return self

    def __exit__(self, *exc):
        from timetabling_ga_tpu_torch.parallel import islands
        from timetabling_ga_tpu_torch.runtime import dispatch_core as dcore
        islands.mesh_run_epochs, dcore.HostCopy = self._saved
        return False


def _loop(records):
    loop = _phases(records, "gen-loop")
    check(len(loop) == 1, f"gen-loop records {loop}")
    return loop[0]


def _fault_seq(records):
    return [(f["site"], f["action"], f["recovery"], f["level"],
             f.get("mode"), f.get("lostGens"))
            for f in (r["faultEntry"] for r in records if "faultEntry" in r)]


class _FreshRegistry:
    """The port's process metrics registry swapped for a fresh one, so a
    run's metricsEntry counts are its own."""

    def __enter__(self):
        from timetabling_ga_tpu_torch.obs import metrics
        self._saved = metrics.REGISTRY
        metrics.REGISTRY = metrics.MetricsRegistry()
        return metrics.REGISTRY

    def __exit__(self, *exc):
        from timetabling_ga_tpu_torch.obs import metrics
        metrics.REGISTRY = self._saved
        return False


def pipeline_path(pa_cpu):
    """(a) The reference config pipelined, with --no-pipeline and
    pipelined with OBS (in a fresh registry), every dispatch under the
    sync-debug mode (_SyncDebug): equal streams, `gen-loop` pipelined
    true, false and true; then the full-eval config pipelined. Returns
    (summary, the clean stream, launches by run, the OBS leg's
    records)."""
    import contextlib
    from timetabling_ga_tpu_torch.obs import metrics
    from timetabling_ga_tpu_torch.runtime import jsonl
    gens = int(PIPE[PIPE.index("--generations") + 1])
    out, streams, launches, obs_recs = {}, {}, {}, None
    with _SyncDebug():
        for name, extra in (("pipelined", []),
                            ("serial", ["--no-pipeline"]),
                            ("obs", OBS)):
            with (_FreshRegistry() if name == "obs"
                  else contextlib.nullcontext(metrics.REGISTRY)) as reg:
                recs, secs, launches["pipe-" + name] = run_cli(
                    "pipe-" + name, PIPE + extra)
                gauges = {k: reg.gauge(k).value for k in (
                    "engine.host_gap_ms_per_gen",
                    "engine.device_busy_frac")}
            check_stream(recs, pa_cpu,
                         ("spanEntry", "metricsEntry") if extra == OBS
                         else ())
            loop = _loop(recs)
            check(loop["pipelined"] is (name != "serial"),
                  f"pipe-{name}: gen-loop says {loop}")
            check(_dispatched(recs) == gens,
                  f"pipe-{name}: {_dispatched(recs)} generations")
            streams[name] = jsonl.strip_timing(recs)
            out[name] = dict(
                wall_s=round(secs, 3), dispatches=loop["dispatches"],
                gens_per_s=gens / loop["seconds"],
                dispatch_gens_per_s=_rate(recs),
                host_gap_ms_per_gen=gauges["engine.host_gap_ms_per_gen"],
                device_busy_frac=gauges["engine.device_busy_frac"])
            if name == "obs":
                obs_recs = recs
    check(streams["pipelined"] == streams["serial"],
          "pipe: the pipelined stream differs from the serial one")
    check(streams["obs"] == streams["pipelined"],
          "pipe: the --obs stream differs from the clean one")
    argv = ["--no-auto-tune", "-p", "1", "--ls-full-eval", "-s", "42",
            "-t", "120", "--trace", "--generations", str(gens)]
    recs, secs, launches["pipe-full-eval"] = run_cli("pipe-full-eval", argv)
    check_stream(recs, pa_cpu)
    check(_loop(recs)["pipelined"] is True, "pipe-full-eval: not pipelined")
    check(launches["pipe-full-eval"]["full_eval_ls"] >= gens,
          "pipe-full-eval: full_eval_ls did not run every generation")
    out["full-eval"] = dict(wall_s=round(secs, 3),
                            gens_per_s=gens / _loop(recs)["seconds"])
    return out, streams["pipelined"], launches, obs_recs


def _spans(records, name=None):
    return [r["spanEntry"] for r in records if "spanEntry" in r
            and (name is None or r["spanEntry"]["name"] == name)]


def obs_path(obs_recs, pipe):
    """(a) of the obs phase, on the pipeline's OBS leg: every dispatch
    with its dispatch, fetch and process spans on one flow (and the
    watchdog's fetch-read on it), the last metricsEntry's counts the
    run's, the port's `trace` and `stats` subcommands on its log.
    Returns the summary."""
    import contextlib
    import io
    from timetabling_ga_tpu_torch import cli
    gens = int(PIPE[PIPE.index("--generations") + 1])
    n_disp = pipe["obs"]["dispatches"]
    flows = {}
    for name in ("dispatch", "fetch", "process"):
        flows[name] = [s["flow"] for s in _spans(obs_recs, name)
                       if "flow" in s]
        check(len(flows[name]) == n_disp == len(set(flows[name])),
              f"obs: {len(flows[name])} {name} spans on "
              f"{len(set(flows[name]))} flows for {n_disp} dispatches")
    check(set(flows["dispatch"]) == set(flows["fetch"])
          == set(flows["process"]),
          "obs: a dispatch's dispatch, fetch and process spans are on "
          "different flows")
    metrics = [r["metricsEntry"] for r in obs_recs if "metricsEntry" in r]
    check(len(metrics) == n_disp + 1,
          f"obs: {len(metrics)} metricsEntry records for {n_disp} "
          f"dispatches and the try's end")
    c = metrics[-1]["counters"]
    check(c.get("engine.dispatches") == n_disp
          and c.get("engine.gens") == gens,
          f"obs: the last metricsEntry counts {c.get('engine.dispatches')}"
          f" dispatches and {c.get('engine.gens')} generations")
    log = os.path.join(OUT_DIR, "comp01s_s42_pipe-obs.jsonl")
    trace = os.path.join(OUT_DIR, "obs_trace.json")
    err, text = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        check(cli.main(["trace", log, "-o", trace]) == 0,
              "obs: the trace subcommand failed")
    with open(trace) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"]
          if e["ph"] == "X" and e["cat"] not in ("phase", "compile")]
    spans = _spans(obs_recs)
    check(len(xs) == len(spans),
          f"obs: {len(xs)} X events for {len(spans)} spans")
    with contextlib.redirect_stdout(text):
        check(cli.main(["stats", log]) == 0,
              "obs: the stats subcommand failed")
    check("== record stream" in text.getvalue(), "obs: stats printed "
          "no record-stream section")
    secs = {}
    for s in spans:
        secs[s["name"]] = secs.get(s["name"], 0.0) + s["dur"]
    return dict(card=CARD, dispatches=n_disp,
                obs_records_per_dispatch=(len(spans) + len(metrics))
                / n_disp,
                gens_per_s_obs=pipe["obs"]["gens_per_s"],
                gens_per_s_clean=pipe["pipelined"]["gens_per_s"],
                wall_s_obs=pipe["obs"]["wall_s"],
                wall_s_clean=pipe["pipelined"]["wall_s"],
                span_seconds={k: round(v, 6) for k, v in secs.items()},
                trace_events=len(doc["traceEvents"]))


def fault_legs(pa_cpu, clean, clean_wall):
    """(b)-(e): each FAULT_LEGS plan on the reference config: its
    faultEntry sequence JAX's, its stream equal to the clean one under
    strip_timing, its wall beside the clean run's. Returns (summary,
    launches by leg)."""
    import numpy as np
    from timetabling_ga_tpu_torch.runtime import faults, jsonl
    gens = int(PIPE[PIPE.index("--generations") + 1])
    out, launches = {}, {}
    for leg, (extra, want) in FAULT_LEGS.items():
        argv = PIPE + extra + ["--obs"]
        ck = None
        if "--checkpoint-every" in extra:
            ck = _fresh(os.path.join(OUT_DIR, "fault_leg.npz"))
            argv = argv + ["--checkpoint", ck]
        recs, secs, launches["fault-" + leg] = run_cli("fault-" + leg, argv)
        check_stream(recs, pa_cpu,
                     ("faultEntry", "spanEntry", "metricsEntry"))
        seq = _fault_seq(recs)
        check(seq == want, f"fault-{leg}: faultEntry sequence {seq}, "
                           f"JAX writes {want}")
        check(jsonl.strip_timing(recs) == clean,
              f"fault-{leg}: the stream differs from the clean run's")
        fe = [r["faultEntry"] for r in recs if "faultEntry" in r]
        # each rehydrate's wall, off its `recover` span
        rec = _spans(recs, "recover")
        n_rec = sum(1 for f in fe if f["action"] == "recover")
        check(len(rec) == n_rec and all(s["site"] == f["site"] for s, f in
                                        zip(rec, (f for f in fe if
                                                  f["action"] == "recover"))),
              f"fault-{leg}: {len(rec)} recover spans for {n_rec} "
              f"recoveries")
        row = dict(wall_s=round(secs, 3),
                   wall_over_clean_s=round(secs - clean_wall, 3),
                   rehydrate_s=[s["dur"] for s in rec],
                   lost_gens=[f.get("lostGens") for f in fe
                              if f["action"] == "recover"],
                   pipelined=_loop(recs)["pipelined"])
        if leg == "fetch-hang":
            check("fetch watchdog" in fe[0]["error"],
                  f"fault-fetch-hang: {fe[0]['error']}")
            check(secs < faults.HANG_S,
                  f"fault-fetch-hang: {secs:.1f} s, the hang is "
                  f"{faults.HANG_S} s")
        if leg == "degrade":
            check(row["pipelined"] is False,
                  "fault-degrade: the ladder did not serialize the loop")
        if ck is not None:
            with np.load(ck) as z:
                check(int(z["generation"]) == gens,
                      f"fault-checkpoint: the npz holds generation "
                      f"{int(z['generation'])}")
            row["checkpoints"] = len(_phases(recs, "checkpoint"))
        out[leg] = row
    return out, launches


def serve_fault_legs():
    """(f) SERVE_FAULT_JOBS through `serve` clean, with a transient
    quantum fault, with that fault and --max-job-recoveries 0, and with
    --shed-queue-hwm 2. Returns (summary, launches by leg)."""
    from timetabling_ga_tpu_torch.runtime import faults
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    req = os.path.join(OUT_DIR, "serve_fault_requests.jsonl")
    with open(req, "w") as f:
        for jid, tim, seed, gens, prio in SERVE_FAULT_JOBS:
            f.write(json.dumps({"submit": {
                "id": jid, "instance": tim, "seed": seed,
                "generations": gens, "priority": prio}}) + "\n")
        f.write(json.dumps({"drain": True}) + "\n")
    ids = [x[0] for x in SERVE_FAULT_JOBS]

    def jobs(records):
        return {j: strip_timing(_job_records(records, j)) for j in ids}

    def final(records, jid):
        ev = [r["jobEntry"] for r in _job_records(records, jid)
              if "jobEntry" in r]
        return ev[-1] if ev else {}

    clean, secs, launches, _ = run_serve("faults_clean", req)
    base = jobs(clean)
    check(all(final(clean, j).get("event") == "done" for j in ids),
          "serve faults: the clean run did not finish every job")
    out = {"clean": dict(wall_s=round(secs, 3))}
    legs = {"requeue": ["--faults", "quantum:2:unavailable"],
            "fail-alone": ["--faults", "quantum:2:unavailable",
                           "--max-job-recoveries", "0"],
            "shed": ["--shed-queue-hwm", "2"]}
    all_launches = {"serve-faults-clean": launches}
    for leg, extra in legs.items():
        try:
            recs, secs, la, c = run_serve("faults_" + leg, req, extra)
        finally:
            faults.install(None)     # the service leaves its plan
        all_launches["serve-faults-" + leg] = la
        got = jobs(recs)
        state = {j: final(recs, j).get("event") for j in ids}
        row = dict(wall_s=round(secs, 3), states=state,
                   recoveries=c.get("serve.job_recoveries", 0),
                   shed=c.get("serve.jobs_shed", 0))
        if leg == "requeue":
            check(c.get("serve.job_recoveries", 0) >= 1,
                  "serve requeue: no job recovered")
            for j in ids:
                check(got[j] == base[j],
                      f"serve requeue: {j}'s records differ from clean")
        elif leg == "fail-alone":
            failed = [j for j in ids if state[j] == "failed"]
            check(len(failed) >= 1 and len(failed) < len(ids),
                  f"serve fail-alone: states {state}")
            for j in ids:
                if j not in failed:
                    check(got[j] == base[j],
                          f"serve fail-alone: co-tenant {j} differs")
            row["failed"] = failed
        else:
            shed = [j for j in ids if state[j] == "shed"]
            check(shed and all(final(recs, j)["reason"] == "queue_hwm"
                               for j in shed),
                  f"serve shed: states {state}")
            top = max(SERVE_FAULT_JOBS, key=lambda x: x[4])[0]
            check(top not in shed and got[top] == base[top],
                  f"serve shed: {top} was shed or differs from clean")
            row["shed_jobs"] = shed
        out[leg] = row
    return out, all_launches


_PROM_LINE = None


def _prometheus_ok(text):
    """Every line of a text exposition a `# TYPE` comment or a sample."""
    import re
    global _PROM_LINE
    if _PROM_LINE is None:
        _PROM_LINE = re.compile(
            r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
            r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? (NaN|[-+0-9.e]+)$')
    lines = text.splitlines()
    return bool(lines) and all(
        x.startswith("# TYPE ") or _PROM_LINE.match(x) for x in lines)


def serve_obs_path():
    """(c) of the obs phase: SERVE_JOBS with SERVE_TENANTS, drained, then
    a {"stats": "prometheus"} request, through the serve path with --obs
    (metering on, the Python API so the results can be read) and with
    --no-usage (the CLI): equal streams under strip_timing, every
    dispatch usageEntry conserving its totals exactly over its lanes,
    every job's result with its tenant and a meter of the generations
    it ran, the exposition parsed. Returns (summary, launches)."""
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.problem import dump_tim
    from timetabling_ga_tpu_torch.runtime import config
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    from timetabling_ga_tpu_torch.serve.service import serve_stream
    itc_tim = dump_tim(itc_problem())
    req = os.path.join(OUT_DIR, "serve_obs_requests.jsonl")
    with open(req, "w") as f:
        for jid, tim, seed, gens, prio in SERVE_JOBS:
            sub = {"id": jid, "seed": seed, "generations": gens,
                   "priority": prio}
            sub.update({"tim": itc_tim} if tim == "itc"
                       else {"instance": tim})
            if jid in SERVE_TENANTS:
                sub["tenant"] = SERVE_TENANTS[jid]
            f.write(json.dumps({"submit": sub}) + "\n")
        f.write(json.dumps({"drain": True}) + "\n")
        f.write(json.dumps({"stats": "prometheus"}) + "\n")
    out = os.path.join(OUT_DIR, "serve_obs.jsonl")
    kernels.reset_launches()
    t0 = time.monotonic()
    with open(req) as fi, open(out, "w") as fo:
        svc = serve_stream(config.parse_serve_args(["--obs"]), fi, fo)
    wall = time.monotonic() - t0
    launches = {"serve-obs": dict(kernels.LAUNCHES)}
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    plain, plain_s, launches["serve-no-usage"], _ = run_serve(
        "obs_no_usage", req, ["--no-usage"])
    check(strip_timing(recs) == strip_timing(plain),
          "serve obs: the --obs stream differs from the --no-usage one")
    check(not any("usageEntry" in r or "spanEntry" in r for r in plain),
          "serve obs: --no-usage wrote obs records")
    disp = [r["usageEntry"] for r in recs
            if "usageEntry" in r and "lanes" in r["usageEntry"]]
    check(disp, "serve obs: no dispatch usageEntry")
    for u in disp:
        for fld in ("gens", "device_seconds", "compile_seconds", "flops"):
            check(sum(lane[fld] for lane in u["lanes"]) == u[fld],
                  f"serve obs: dispatch {u['dispatch']}'s lanes' {fld} "
                  f"do not sum to its total")
    for jid, _, _, gens, _ in SERVE_JOBS:
        res = svc.result(jid)
        want = SERVE_TENANTS.get(jid, "default")
        check(res["tenant"] == want and res["usage"]["gens"] == gens
              == res["gens"],
              f"serve obs: {jid}'s result tenant {res.get('tenant')} "
              f"usage {res.get('usage')} for {gens} generations")
    finals = [r["usageEntry"] for r in recs
              if r.get("usageEntry", {}).get("event") == "total"]
    check(sorted(f["job"] for f in finals)
          == sorted(x[0] for x in SERVE_JOBS),
          f"serve obs: settle totals for {[f['job'] for f in finals]}")
    names = {s["name"] for s in _spans(recs)}
    check({"admit", "pack", "init", "resume", "quantum", "park",
           "finalize"} <= names, f"serve obs: spans {sorted(names)}")
    # the ledger's settlement lag: from a quantum's park fence (its park
    # span's end; the drive loop hands the settlement over just before)
    # to the stamp of the usageEntry the ledger thread writes for it
    parks = _spans(recs, "park")
    check(len(parks) == len(disp),
          f"serve obs: {len(parks)} park spans for {len(disp)} dispatches")
    lags = sorted(u["ts"] - (p["ts"] + p["dur"]) for u, p in zip(
        sorted(disp, key=lambda u: u["dispatch"]), parks))
    device_s = sum(u["device_seconds"] for u in disp)
    compile_s = sum(u["compile_seconds"] for u in disp)
    quanta_s = sum(s["dur"] for s in _spans(recs, "quantum"))
    check(device_s <= quanta_s + 1e-3 and quanta_s <= wall,
          f"serve obs: device {device_s} s, quanta {quanta_s} s, "
          f"wall {wall} s")
    prom = [r["metricsEntry"] for r in recs if "metricsEntry" in r
            and "prometheus" in r["metricsEntry"]]
    check(len(prom) == 1 and _prometheus_ok(prom[0]["prometheus"])
          and "tt_serve_dispatches_total" in prom[0]["prometheus"],
          "serve obs: the prometheus answer is not a text exposition")
    return dict(card=CARD, wall_s=round(wall, 3),
                no_usage_wall_s=round(plain_s, 3),
                dispatches=len(disp), device_seconds=device_s,
                compile_seconds=compile_s, quantum_span_seconds=quanta_s,
                flops=sum(u["flops"] for u in disp),
                settle_lag_ms=dict(median=1e3 * lags[len(lags) // 2],
                                   max=1e3 * lags[-1]),
                obs_records=sum(1 for r in recs if next(iter(r)) in (
                    "spanEntry", "metricsEntry", "usageEntry")),
                tenants=svc.usage.totals(),
                prometheus_lines=len(prom[0]["prometheus"].splitlines())
                ), launches


# the pullfront phase: the recorder and ring flags (the listener's port
# is picked free at run time), and the fault each leg takes
PULL = ["--obs", "--history-every", "0.2", "--incident-min-interval", "0"]
PULL_FAULT = ["--faults", "dispatch:2:unavailable"]
PULL_ROUTES = ("/metrics", "/healthz", "/readyz",
               "/metrics/history?window=10")
# /readyz's body keys (JAX obs/http.py readiness)
READYZ_KEYS = {"ready", "reasons", "queue_depth", "backlog",
               "degrade_level", "recovery_budget_remaining",
               "mem_frac_used", "stalled", "draining"}
# (c): three decisions of the autoscaler's log
SCALE_LOG = [
    {"scaleEntry": {"ts": 1.5, "action": "up", "reason": "backlog",
                    "replica": "r2", "live": 1, "target": 2,
                    "evidence": {"serve.queue_depth": {
                        "op": ">=", "threshold": 8.0, "for_s": 30.0,
                        "mean": 9.5}}}},
    {"scaleEntry": {"ts": 9.0, "action": "down", "reason": "idle",
                    "replica": "r1", "live": 2}},
    {"scaleEntry": {"action": "hold", "reason": "cooldown",
                    "blocked": "cooldown"}},
]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the pull front's scraper, a process of its own as Prometheus would be
# (a thread of this process would take the interpreter's lock from the
# host loop it measures): it scrapes every route in argv[2:] of the
# front at argv[1] every 50 ms until its stdin closes, skipping a scrape
# the listener refuses (not up yet, or closed), then prints one JSON
# object: each route's (status, content type) answers and last body,
# and each /metrics scrape's latency in ms
SCRAPER = r"""
import json, sys, threading, time, urllib.error, urllib.request
url, routes = sys.argv[1], sys.argv[2:]
stop = threading.Event()
threading.Thread(target=lambda: (sys.stdin.read(), stop.set()),
                 daemon=True).start()
out = {r: {"answers": [], "body": None} for r in routes}
ms = []
while not stop.wait(0.05):
    for route in routes:
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(url + route, timeout=5) as r:
                ans = (r.status, r.headers["Content-Type"], r.read())
        except urllib.error.HTTPError as e:
            ans = (e.code, e.headers["Content-Type"], e.read())
        except OSError:
            continue
        if route == "/metrics":
            ms.append(1e3 * (time.monotonic() - t0))
        out[route]["answers"].append(ans[:2])
        out[route]["body"] = ans[2].decode()
print(json.dumps({"routes": out, "metrics_ms": ms}))
"""


class _Scraper:
    """The SCRAPER process on the front at `url` for the block's length;
    `got(route)` is then the route's (status, content type) answers and
    `body(route)` its last body."""

    def __init__(self, url, routes=PULL_ROUTES):
        self._argv = [sys.executable, "-c", SCRAPER, url, *routes]

    def __enter__(self):
        self._proc = subprocess.Popen(self._argv, stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        out, _ = self._proc.communicate(input="", timeout=60)
        check(self._proc.returncode == 0, "pull: the scraper failed")
        res = json.loads(out)
        self._routes, self.metrics_ms = res["routes"], res["metrics_ms"]
        return False

    def got(self, route):
        return self._routes[route]["answers"]

    def body(self, route):
        return self._routes[route]["body"]


def _reader(argv):
    """`python -m timetabling_ga_tpu_torch <argv>` from the checkout;
    returns its completed process."""
    return subprocess.run([sys.executable, "-m", "timetabling_ga_tpu_torch",
                           *argv], cwd=HERE, capture_output=True,
                          text=True, timeout=120)


def _bundles(d):
    from timetabling_ga_tpu_torch.obs import flight
    return [(p, flight.load_bundle(p)) for p in flight.list_bundles(d)]


def pullfront_path(pa_cpu):
    """(a)-(c) of the pullfront phase. Returns (summary, launches by
    leg)."""
    import shutil
    import statistics
    import torch
    from timetabling_ga_tpu_torch.obs import flight, scrape
    from timetabling_ga_tpu_torch.runtime import jsonl
    gens = int(PIPE[PIPE.index("--generations") + 1])
    inc = os.path.join(OUT_DIR, "incidents")
    shutil.rmtree(inc, ignore_errors=True)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    legs = {"clean": PIPE,
            "front": PIPE + PULL + PULL_FAULT + [
                "--obs-listen", f"127.0.0.1:{port}", "--incident-dir", inc],
            "fault": PIPE + ["--obs"] + PULL_FAULT}
    out, streams, launches, records = {}, {}, {}, {}
    for leg, argv in legs.items():
        with _FreshRegistry() as reg:
            if leg == "front":
                with _Scraper(url) as scraper:
                    recs, secs, la = run_cli("pull-" + leg, argv)
            else:
                recs, secs, la = run_cli("pull-" + leg, argv)
            gauges = reg.snapshot().get("gauges", {})
        summary = check_stream(recs, pa_cpu, () if leg == "clean" else
                               ("faultEntry", "spanEntry", "metricsEntry"))
        check(_dispatched(recs) >= gens,
              f"pull-{leg}: {_dispatched(recs)} generations")
        if leg == "clean":
            check_path_kernels("reference", la, summary["generations"],
                               summary["kicks"])
        else:
            # a recovery re-runs its lost generations: the reference
            # path's kernels every generation, none of the others
            per_gen, _, none = PATH_KERNELS["reference"]
            check(all(la[k] >= gens for k in per_gen)
                  and not any(la[k] for k in none),
                  f"pull-{leg}: launches {la}")
        streams[leg] = jsonl.strip_timing(recs)
        launches["pull-" + leg], records[leg] = la, recs
        out[leg] = dict(wall_s=round(secs, 3),
                        gens_per_s=gens / _loop(recs)["seconds"])
        if leg == "front":
            mem = {k: gauges.get("device." + k) for k in (
                "mem_bytes_in_use", "mem_peak_bytes_in_use",
                "mem_bytes_limit", "mem_frac_used")}
    for leg in ("front", "fault"):
        check(streams[leg] == streams["clean"],
              f"pull-{leg}: the stream differs from the clean leg's")
    check(launches["pull-front"] == launches["pull-fault"],
          "pull-front: the launches differ from the fault leg's without "
          "the listener and the recorder")
    # the front, read during the run
    m = scraper.got("/metrics")
    check(m and all(a[0] == 200 for a in m), "pull: /metrics scrapes "
          f"{[a[0] for a in m]}")
    body = scraper.body("/metrics")
    check(body.endswith("# EOF\n") and 'dispatch="' in body,
          "pull: /metrics is not OpenMetrics with a dispatch= exemplar")
    h = scraper.got("/healthz")
    check(h and all(a[0] == 200 for a in h), f"pull: /healthz "
          f"{[a[0] for a in h]}")
    r = scraper.got("/readyz")
    check(r and all(a[1] == "application/json" for a in r)
          and set(json.loads(scraper.body("/readyz"))) == READYZ_KEYS,
          "pull: /readyz is not JAX's JSON")
    hw = "/metrics/history?window=10"
    hist = json.loads(scraper.body(hw)) if scraper.got(hw) else None
    check(hist and hist["series"], "pull: the history has no series")
    fams = scrape.parse_exposition(body)
    total = torch.cuda.get_device_properties(0).total_memory
    check(mem["mem_bytes_limit"] == total
          and scrape.scalar(fams, "tt_device_mem_bytes_limit") == total,
          f"pull: device.mem_bytes_limit {mem['mem_bytes_limit']}, the "
          f"card's total memory {total}")
    check((mem["mem_bytes_in_use"] or 0) > 0,
          f"pull: device.mem_bytes_in_use {mem['mem_bytes_in_use']}")
    # the bundles: one a faultEntry at --incident-min-interval 0
    got = _bundles(inc)
    check([c["trigger"] for _, c in got] == ["fault:dispatch/recover"],
          f"pull: bundles {[c['trigger'] for _, c in got]}")
    dumps = _spans(records["front"], "flight_dump")
    check(sorted(s["path"] for s in dumps)
          == sorted(os.path.basename(p) for p, _ in got),
          "pull: a bundle without its flight_dump span")
    log = os.path.join(OUT_DIR, "comp01s_s42_pull-front.jsonl")
    for argv in (["incident", inc, "-o", os.path.join(OUT_DIR,
                                                      "incident.json")],
                 ["trace", log, got[0][0], "-o",
                  os.path.join(OUT_DIR, "pull_trace.json")]):
        proc = _reader(argv)
        check(proc.returncode == 0, f"pull: {argv[0]} exited "
              f"{proc.returncode}: {proc.stderr[-400:]}")
    core = got[0][1]
    out["front"].update(
        metrics_scrapes=len(m),
        scrape_ms=dict(median=statistics.median(scraper.metrics_ms),
                       max=max(scraper.metrics_ms)),
        history=dict(series=len(hist["series"]),
                     samples=hist["samples"]),
        bundle=dict(spans=len(core["spans"]),
                    spans_dropped=core["spans_dropped"],
                    records=len(core["records"]),
                    records_dropped=core["records_dropped"],
                    span_ring_bytes_hw=core["metrics"]["gauges"].get(
                        "flight.span_ring_bytes_hw"),
                    file_bytes=os.path.getsize(got[0][0])),
        mem=dict(mem, total_memory=total))
    serve, launches["pull-serve"] = _pull_serve(inc + "-serve")
    ttd = [s["dur"] for s in dumps] + serve.pop("dump_s")
    # (c) the scale reader
    slog = os.path.join(OUT_DIR, "scale.jsonl")
    with open(slog, "w") as f:
        f.write("\n".join(json.dumps(x) for x in SCALE_LOG) + "\n")
    proc = _reader(["scale", slog])
    check(proc.returncode == 0 and "== scale decisions (3 records)"
          in proc.stdout, f"pull: scale exited {proc.returncode}")
    return dict(card=CARD, legs=out, serve=serve,
                time_to_dump_ms=dict(median=1e3 * statistics.median(ttd),
                                     n=len(ttd))), launches


def _pull_serve(inc):
    """(b): SERVE_FAULT_JOBS under the requeue leg's fault with the
    front, the recorder and --obs on; returns (summary, launches)."""
    import shutil
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.obs import flight
    from timetabling_ga_tpu_torch.runtime import config, faults
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    from timetabling_ga_tpu_torch.serve.service import serve_stream
    shutil.rmtree(inc, ignore_errors=True)
    port = _free_port()
    req = os.path.join(OUT_DIR, "serve_fault_requests.jsonl")
    out = os.path.join(OUT_DIR, "serve_pull.jsonl")
    cfg = config.parse_serve_args(
        ["--obs", "--obs-listen", f"127.0.0.1:{port}", "--incident-dir",
         inc, "--incident-min-interval", "0", "--history-every", "0.2",
         "--faults", "quantum:2:unavailable"])
    kernels.reset_launches()
    t0 = time.monotonic()
    try:
        with _FreshRegistry(), _Scraper(f"http://127.0.0.1:{port}",
                                        ("/readyz",)) as scraper, \
                open(req) as fi, open(out, "w") as fo:
            svc = serve_stream(cfg, fi, fo)
    finally:
        faults.install(None)             # the service leaves its plan
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(OUT_DIR, "serve_faults_requeue.jsonl")) as f:
        base = [json.loads(line) for line in f]
    for jid, *_ in SERVE_FAULT_JOBS:
        check(strip_timing(_job_records(recs, jid))
              == strip_timing(_job_records(base, jid)),
              f"pull serve: {jid}'s records differ from the serve-faults "
              f"requeue leg's")
    got = _bundles(inc)
    check([c["trigger"] for _, c in got] == ["fault:quantum/requeue"],
          f"pull serve: bundles {[c['trigger'] for _, c in got]}")
    status, body = flight.incident_response(svc.flight)
    check(status == 200 and body["incident"]["trigger"]
          == "fault:quantum/requeue", f"pull serve: /v1/incident {status}")
    r = scraper.got("/readyz")
    check(r and all(a[1] == "application/json" for a in r)
          and set(json.loads(scraper.body("/readyz"))) == READYZ_KEYS,
          "pull serve: /readyz was not answered during the run")
    dumps = _spans(recs, "flight_dump")
    check(len(dumps) == 1, f"pull serve: {len(dumps)} flight_dump spans")
    return dict(wall_s=round(wall, 3), readyz_answers=len(r),
                bundle_records=len(got[0][1]["records"]),
                dump_s=[s["dur"] for s in dumps]), launches


# The mesh phase (islands across cards and processes): the main path's
# tuned config on 4 islands at a fixed generation count, once on one
# shard and once on a 2-shard mesh of the one card; the reference config
# on 4 islands in one process and in two processes sharing the card (2
# islands each); the peer death and the resume across processes.
MESH_MAIN = ["-s", "42", "-t", "600", "--islands", "4", "--generations",
             "20", "--trace"]
MESH_REF = ["--no-auto-tune", "-p", "2", "-s", "42", "-t", "600",
            "--islands", "4", "--generations", "200", "--trace"]
MESH_PEER = ["--peer-timeout", "5", "--checkpoint-every", "1"]
# K7's halo form against migrate_plain: the CPU tests' (shards, islands a
# shard) x pop at E = 8, then comp01s at the mesh path's shape
MESH_HALO_CASES = [(d, l, p) for d, l in ((2, 1), (2, 2), (4, 2))
                   for p in (3, 8)]
MESH_EXCHANGES = 200
# two processes on the card time `ProcessGroup.exchange` of one comp01s
# halo row each way through gloo (argv: rank, port, E)
EXCHANGE_SCRIPT = r"""
import json, sys, time, datetime
import torch
import torch.distributed as dist
from timetabling_ga_tpu_torch.parallel import comm
rank, port, E = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
store = dist.TCPStore("127.0.0.1", port, 2, is_master=rank == 0,
                      timeout=datetime.timedelta(seconds=60))
group = comm.start(store, rank, 2, [dev], False, 60.0)
row = torch.arange(2 * E + 3, dtype=torch.int32, device=dev) + rank
for _ in range(10):
    group.exchange(row, row)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(%d):
    a, b = group.exchange(row, row)
torch.cuda.synchronize()
ms = (time.perf_counter() - t0) * 1e3 / %d
ok = bool((a == row - rank + (1 - rank)).all() and (b == a).all())
print(json.dumps({"rank": rank, "ms_per_exchange": ms, "ok": ok,
                  "backend": group.backend}))
""" % (MESH_EXCHANGES, MESH_EXCHANGES)


def _halo_state(L, pop, E, g, dev):
    """L sorted islands of pop rows of E int32 on `dev`, with ties in
    (penalty, scv) and feasible and infeasible rows."""
    import torch
    from timetabling_ga_tpu_torch.ops import ga
    n = L * pop
    pen = torch.randint(0, 6, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    scv = torch.randint(0, 4, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    hcv = (torch.randint(0, 2, (n,), generator=g, device=dev,
                         dtype=torch.int32) * pen)
    slots = torch.randint(0, 45, (n, E), generator=g, device=dev,
                          dtype=torch.int32)
    rooms = torch.randint(0, 10, (n, E), generator=g, device=dev,
                          dtype=torch.int32)
    return ga.survivors_plain(ga.PopState(slots, rooms, pen, hcv, scv),
                              groups=L)


def compare_migrate_halo(pa, dev):
    """K7's halo form (`migrate_kernel` with a shard's halo rows)
    against migrate_plain on every shard of a mesh of `dev` repeated, at
    the CPU tests' cases and on comp01s rows at the mesh path's shape
    (2 shards of 2 islands of 16 rows): populations and gains exact.
    Times the halo form, the in-card form and the plain version at that
    shape. Returns ({("migrate_halo", 16): timing}, cases)."""
    import torch
    from timetabling_ga_tpu_torch import work
    from timetabling_ga_tpu_torch.ops import ga, rooms
    from timetabling_ga_tpu_torch.parallel import comm, islands
    g = torch.Generator(device=dev).manual_seed(2020)
    cases = [(d, l, p, 8) for d, l, p in MESH_HALO_CASES] + [
        (2, 2, 16, pa.n_events)]
    for D, L, pop, E in cases:
        mesh = islands.Mesh([dev] * D, comm.SOLO)
        if E == pa.n_events:
            slots = torch.randint(0, pa.n_slots, (D * L * pop, E),
                                  generator=g, device=dev,
                                  dtype=torch.int32)
            full = ga.evaluate(pa, slots, rooms.assign_rooms(pa, slots),
                               groups=D * L)
        else:
            full = _halo_state(D * L, pop, E, g, dev)
        states = [ga.PopState(*(x[s * L * pop:(s + 1) * L * pop]
                                for x in full)) for s in range(D)]
        to_next = [islands.halo_row(st, (L - 1) * pop) for st in states]
        to_prev = [islands.halo_row(st, 1) for st in states]
        fwd, bwd = mesh.halo(to_next, to_prev)
        for s, st in enumerate(states):
            got, gain = islands.migrate_kernel(st, L, True, fwd[s], bwd[s])
            off = islands.migrate_kernel(st, L, False, fwd[s], bwd[s])
            want, wgain = islands.migrate_plain(st, L, True, fwd[s], bwd[s])
            torch.cuda.synchronize()
            check(all(torch.equal(w, x) and torch.equal(w, o)
                      for w, x, o in zip(want, got, off))
                  and torch.equal(gain, wgain),
                  f"migrate_halo D={D} L={L} pop={pop} E={E} shard {s}: "
                  f"kernel differs from plain")
    st, f, b = states[0], fwd[0], bwd[0]
    w = work.migrate(L, pop, E, halo=True)
    bound_ms, by = bound(w.bytes, w.ops)
    t = {"max_abs_err": 0,
         "ms": time_ms(lambda: islands.migrate_kernel(st, L, False, f, b),
                       200),
         "in_card_ms": time_ms(lambda: islands.migrate_kernel(st, L), 200),
         "plain_ms": time_ms(lambda: islands.migrate_plain(st, L, False, f,
                                                           b), 20),
         "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
    return {("migrate_halo", 16): t}, len(cases)


def run_mesh_engine(name, argv, devices):
    """The engine in this process on the mesh over `devices` (one card
    repeated), the launch counters zeroed just before and read just
    after; returns (records, seconds, launches)."""
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.runtime import config, engine
    path = os.path.join(OUT_DIR, f"mesh_{name}.jsonl")
    cfg = config.parse_args(["-i", TIM, "-o", path] + argv)
    kernels.reset_launches()
    t0 = time.monotonic()
    engine.run(cfg, devices=devices)
    seconds = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return records, seconds, launches


def _two_processes(name, argv, faults=None, timeout=300):
    """Two CLI processes on the card joined by --coordinator (each rank
    on cuda:0: gloo); returns [(rc, stderr, records or None)] a rank and
    the wall. Both are stopped whatever happens."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("TT_FAULTS", None)
    if faults:
        env["TT_FAULTS"] = faults
    outs = [os.path.join(OUT_DIR, f"mesh_{name}_p{r}.jsonl")
            for r in range(2)]
    for o in outs:
        if os.path.exists(o):
            os.unlink(o)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "timetabling_ga_tpu_torch", "-i", TIM,
         "-o", outs[r], *argv, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)], cwd=HERE,
        env=env, stderr=subprocess.PIPE, text=True) for r in range(2)]
    res = []
    try:
        for p, o in zip(procs, outs):
            _, err = p.communicate(timeout=timeout)
            recs = None
            if os.path.exists(o):
                with open(o) as f:
                    recs = [json.loads(line) for line in f]
            res.append((p.returncode, err, recs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res, time.monotonic() - t0


def _core(records):
    """The records a resumed run must share with an uninterrupted one."""
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    return [r for r in strip_timing(records)
            if "solution" in r or "runEntry" in r]


def _first_diff(a, b):
    """The first differing pair of two record lists (or their lengths),
    for a failure's message."""
    for x, y in zip(a, b):
        if x != y:
            return f"{json.dumps(x)[:300]} != {json.dumps(y)[:300]}"
    return f"{len(a)} records against {len(b)}"


def exchange_ms():
    """One halo exchange through gloo between two processes on the card,
    each way one comp01s halo row (ProcessGroup.exchange): ms an
    exchange over MESH_EXCHANGES."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", EXCHANGE_SCRIPT, str(r), str(port), "400"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            check(p.returncode == 0, f"exchange timing: rc {p.returncode} "
                  f"{err[-800:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(o["ok"] and o["backend"] == "gloo" for o in outs),
          f"exchange timing: rows or backend wrong {outs}")
    return max(o["ms_per_exchange"] for o in outs)


def mesh_path(pa_cpu, serve_summary):
    """The islands across cards and processes, on the one card. (a) The
    main path's tuned config, 4 islands, MESH_MAIN's generations: one
    shard, then a 2-shard mesh of cuda:0 (the engine in this process with
    its `devices`), the streams equal under strip_timing, every migration
    of the mesh run K7's halo form. (b) The reference config, 4 islands:
    one process, then two processes sharing the card (2 islands each,
    gloo, printed as such): process 0's stream equal to one process's,
    process 1's file never written. (c) `--faults dispatch@1:2:die
    --peer-timeout 5` with a checkpoint: process 0 exits 70 within the
    timeout with the abort faultEntry (lostProc 1, agreed false) and the
    checkpoint; a fresh two-process --resume run ends as (b) does. (d) A
    halo exchange's time through gloo. (e) SERVE_JOBS on a 2-shard lane
    mesh of the card, each job's records equal to the serve path's
    line-JSON leg. Returns (summary, launches)."""
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
    from timetabling_ga_tpu_torch.runtime import config
    from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
    from timetabling_ga_tpu_torch.serve.service import serve_stream
    dev = torch.device("cuda", 0)
    t_phase = time.monotonic()
    launches = {}
    # (a) one shard, then two shards of the card
    one, one_s, launches["mesh-one"] = run_cli("mesh_one", MESH_MAIN)
    two, two_s, launches["mesh"] = run_mesh_engine("mesh_two", MESH_MAIN,
                                                   [dev, dev])
    check(strip_timing(two) == strip_timing(one),
          "mesh: the 2-shard main path differs from one shard: "
          + _first_diff(strip_timing(two), strip_timing(one)))
    for name, recs in (("mesh-one", one), ("mesh", two)):
        s = check_stream(recs, pa_cpu)
        check(s["generations"] > 0, f"{name}: no generation")
        check_path_kernels(name, launches[name], s["generations"],
                           s["kicks"])
    check([r["runEntry"] for r in two if "runEntry" in r][1]["procsNum"]
          == 4, "mesh: runEntry.procsNum is not 4")
    # (b) one process, then two processes sharing the card
    ref, ref_s, _ = run_cli("mesh_ref", MESH_REF)
    res, two_proc_s = _two_processes("ref", MESH_REF)
    for r, (rc, err, _) in enumerate(res):
        check(rc == 0, f"mesh two processes: rank {r} exited {rc}: "
              f"{err[-1500:]}")
        check("gloo process group (ranks 0 and 1 share card" in err,
              f"mesh two processes: rank {r} did not choose gloo: "
              f"{err[-600:]}")
    check(res[1][2] is None, "mesh two processes: process 1 wrote records")
    two_ref = res[0][2]
    check(strip_timing(two_ref) == strip_timing(ref),
          "mesh two processes: process 0's stream differs from one "
          "process's: " + _first_diff(strip_timing(two_ref),
                                      strip_timing(ref)))
    # (c) process 1 dies at its second dispatch
    ck = _fresh(os.path.join(OUT_DIR, "mesh_peer.npz"))
    peer = MESH_REF + MESH_PEER + ["--checkpoint", ck]
    res, peer_s = _two_processes("peer", peer, faults="dispatch@1:2:die")
    (rc0, err0, recs0), (rc1, _, _) = res
    check(rc0 == 70 and rc1 != 0, f"mesh peer death: exits {rc0}, {rc1}: "
          f"{err0[-1500:]}")
    check("lost contact with process 1" in err0, "mesh peer death: no "
          "PeerLost on process 0")
    fe = [r["faultEntry"] for r in recs0 if "faultEntry" in r]
    check(fe and fe[-1]["site"] == "accord" and fe[-1]["action"] == "abort"
          and fe[-1]["lostProc"] == 1 and fe[-1]["agreed"] is False
          and fe[-1]["time"] < 60,
          f"mesh peer death: the abort faultEntry {fe[-1:]}")
    check(os.path.exists(ck), "mesh peer death: no checkpoint")
    res, resume_s = _two_processes("resume", peer + ["--resume"])
    for r, (rc, err, _) in enumerate(res):
        check(rc == 0, f"mesh resume: rank {r} exited {rc}: {err[-1500:]}")
    check(_core(res[0][2]) == _core(two_ref),
          "mesh resume: the resumed run ends elsewhere than the "
          "uninterrupted one: " + _first_diff(_core(res[0][2]),
                                              _core(two_ref)))
    # (d) the halo exchange through gloo
    ex_ms = exchange_ms()
    # (e) the serve lane mesh, two shards of the card
    req = os.path.join(OUT_DIR, "serve_requests.jsonl")
    out = os.path.join(OUT_DIR, "serve_mesh2.jsonl")
    reg = MetricsRegistry()
    kernels.reset_launches()
    t0 = time.monotonic()
    with open(req) as fin, open(out, "w") as fout:
        serve_stream(config.parse_serve_args([]), fin, out_stream=fout,
                     registry=reg, devices=[dev, dev])
    serve_s = time.monotonic() - t0
    launches["serve-mesh"] = dict(kernels.LAUNCHES)
    with open(out) as f:
        mesh_recs = [json.loads(line) for line in f]
    with open(os.path.join(OUT_DIR, "serve_packed.jsonl")) as f:
        base = [json.loads(line) for line in f]
    for jid, *_ in SERVE_JOBS:
        check(strip_timing(_job_records(mesh_recs, jid))
              == strip_timing(_job_records(base, jid)),
              f"serve mesh: job {jid}'s records differ from the line-JSON "
              f"leg's")
    check(reg.gauge("serve.mesh_devices").value == 2,
          "serve mesh: serve.mesh_devices is not 2")
    for k in LANES:
        check(launches["serve-mesh"][k] > 0, f"serve mesh: {k} never ran")
    check(launches["serve-mesh"]["migrate_halo"] == 0,
          "serve mesh: a lane migrated")
    lane_gens = reg.counter("serve.gens").value
    return dict(
        card=CARD, main_one_shard_gens_per_s=_rate(one),
        main_two_shards_gens_per_s=_rate(two),
        main_wall_s=[round(one_s, 3), round(two_s, 3)],
        migrate_halo_launches=launches["mesh"]["migrate_halo"],
        reference_one_process_gens_per_s=_rate(ref),
        reference_two_processes_gens_per_s=_rate(two_ref),
        two_processes_wall_s=round(two_proc_s, 3),
        peer_lost_after_s=fe[-1]["time"], peer_wall_s=round(peer_s, 3),
        resume_wall_s=round(resume_s, 3),
        gloo_exchange_ms=ex_ms,
        serve_lane_gens_per_s_one_shard=serve_summary["lane_gens_per_s"],
        serve_lane_gens_per_s_two_shards=lane_gens / serve_s,
        phase_s=round(time.monotonic() - t_phase, 3)), launches


# ---- the scale configuration: BASELINE.json's fourth, a synthetic
# 2000-event / 80-room / 1,000-student instance at pop 32,768 (the JAX
# bench builds it at bench.py:540-577 `measure_scale` with the JAX
# package's generator; here the port's own random_instance makes it from
# the same seed and arguments and it is written as a .tim, so nothing is
# downloaded). Every kernel that chooses a room takes its 80 rooms (three
# of them a lane, three suitability words an event); one individual's
# conflict bitset (504,000 bytes) does not fit in shared memory, so K5,
# K8 and K10 read it from global memory, and K12 its suitable-rooms
# table (160,000 bytes) too.
SCALE_SEED = 7
SCALE_SHAPE = dict(n_events=2000, n_rooms=80, n_features=10,
                   n_students=1000, attend_prob=0.01)
SCALE_TIM = os.path.join(OUT_DIR, "scale_e2000_r80.tim")
SCALE_POP = 32_768
# rows of the plain K2 a chunk: its (P, T, E) float32 one-hots of a
# chunk take ~1.5 GB
SCALE_PLAIN_CHUNK = 4096
# the main path on the scale .tim: the size-tuned defaults (E > 200:
# islands of 16, hot-K 48 repair, the post polish on 4 rows)
SCALE_MAIN = ["-s", "42", "-t", "20", "--generations", "100000", "--trace"]
# the lane forms past 32 rooms: two jobs of 40 and 36 rooms in serve's
# 64-room bucket (dead rooms 40-63 and 36-63)
SCALE_LANES = ((41, 200, 40), (42, 180, 36))


def scale_problem():
    """The scale instance, written to SCALE_TIM and read back from it
    (the file the CLI leg reads)."""
    from timetabling_ga_tpu_torch.problem import (
        dump_tim, load_tim_file, random_instance)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(SCALE_TIM, "w") as f:
        f.write(dump_tim(random_instance(SCALE_SEED, **SCALE_SHAPE)))
    return load_tim_file(SCALE_TIM)


def _outputs(x):
    """A call's tensors, flattened out of tuples and named tuples."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _outputs(y)]


def scale_compare(name, shape, kern, plain, smem=None, branch=None,
                  reps=3, extra=None, tag="scale", want=None):
    """`kern` (the kernel's wrapper) and `plain` on the same inputs: every
    output exactly equal; the kernel's ms a call (CUDA events, `reps`
    calls after one), the plain version's (one call, host clock after a
    synchronize), and the bound of the work the kernel's launches counted
    (kernels.WORK: work.py's table, the most those launches can do).
    `want` (the plain version's outputs and ms) skips the plain call.
    Prints one `<tag>_kernel` line and returns it, the plain outputs
    under "_want"."""
    import torch
    from timetabling_ga_tpu_torch import kernels
    before = dict(kernels.WORK)
    got = _outputs(kern())
    torch.cuda.synchronize()
    nb = kernels.WORK["bytes"] - before["bytes"]
    ops = kernels.WORK["ops"] - before["ops"]
    if want is None:
        t0 = time.monotonic()
        want = _outputs(plain())
        torch.cuda.synchronize()
        want = (want, (time.monotonic() - t0) * 1e3)
    want, plain_ms = want
    check(len(got) == len(want), f"{tag} {name} {shape}: output count")
    err = 0
    for gt, wt in zip(got, want):
        check(gt.shape == wt.shape, f"{tag} {name} {shape}: kernel shape "
              f"{tuple(gt.shape)} vs plain {tuple(wt.shape)}")
        err = max(err, int((gt.long() - wt.long()).abs().max())
                  if gt.numel() else 0)
    check(err == 0, f"{tag} {name} {shape}: kernel differs from its plain "
                    f"version (max abs err {err})")
    b, by = bound(nb, ops)
    line = {f"{tag}_kernel": name, "shape": shape,
            "ms": time_ms(kern, reps), "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": b, "bound_by": by,
            "smem_bytes": smem, "branch": branch, **(extra or {}),
            "card": CARD}
    print(json.dumps(line))
    line["_want"] = (want, plain_ms)
    return line


def compare_scale_kernels(problem, dev):
    """Every kernel against its plain version on the scale instance, at a
    few rows (P = 2-4) so that the plain versions stay short, exactly;
    each line with the kernel's ms a call, its bound, the shared memory
    a block takes and what it stages or reads from global memory."""
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.ops import (
        delta, fitness, ga, lahc, local_search, moves, nsga, rooms, sweep)
    from timetabling_ga_tpu_torch.parallel import islands
    pa = problem.device_arrays(dev)
    E, R, T = pa.n_events, pa.n_rooms, pa.n_slots
    check((E, R) == (SCALE_SHAPE["n_events"], SCALE_SHAPE["n_rooms"]),
          f"scale instance is {E} x {R}")
    g = torch.Generator(device=dev).manual_seed(12_000)

    def rand(n, P):
        return torch.randint(0, n, (P, E), generator=g, device=dev,
                             dtype=torch.int32)
    lines = []
    slots = rand(T, 4)
    rms = rooms.assign_rooms(pa, slots)
    lines.append(scale_compare(
        "assign_rooms", [4], lambda: rooms.assign_rooms(pa, slots),
        lambda: rooms.assign_rooms_plain(pa, slots),
        smem=rooms.assign_rooms_smem_bytes(pa)))
    lines.append(scale_compare(
        "batch_penalty", [4], lambda: fitness.batch_penalty(pa, slots, rms),
        lambda: fitness.batch_penalty_plain(pa, slots, rms)))
    st = delta.init_state(pa, slots, rms)
    md = moves.make_move_draws([g], 4 * 8, E, T, 1.0, 1.0, 1.0, dev)
    evs, ns, act = (x.reshape(4, 8, 3) for x in moves.sample_move(
        pa, md, slots.repeat_interleave(8, 0)))
    lines.append(scale_compare(
        "delta_one", [4, 8],
        lambda: delta.delta_one(pa, st.slots, st.rooms, st.att, st.occ,
                                evs, ns, act),
        lambda: delta.delta_one_plain(pa, st.slots, st.rooms, st.att,
                                      st.occ, evs, ns, act)))
    # K5 at the main path's repair pass (hot-K 48) and post pass (swap
    # block 64, the permutation: 2,000 steps), every cluster size
    st2 = delta.LSState(*(x[:2] for x in st))
    for phase, case in (("repair", (8, 1, 0.25, 48, 0.0)),
                        ("post", (64, 1, 0.25, 0, 0.0))):
        sh = sweep.sweep_shape(E, T, case[0], case[1], case[3], case[4])
        draws = sweep.make_sweep_draws([g], 2, sh, E, case[2], dev)
        smem, bits, _ = sweep.sweep_pass_layout(pa, sh)
        t0 = time.monotonic()
        want, want_rows = sweep.sweep_pass_plain(pa, draws, st2, *case)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        per_cluster = {}
        for cs in K5_CLUSTERS:
            before = dict(kernels.WORK)
            got, got_rows, _ = sweep.sweep_pass_kernel(pa, draws, st2,
                                                       *case, cluster=cs)
            torch.cuda.synchronize()
            nb = kernels.WORK["bytes"] - before["bytes"]
            ops = kernels.WORK["ops"] - before["ops"]
            check(all(torch.equal(w, x) for w, x in zip(want, got))
                  and torch.equal(want_rows, got_rows),
                  f"scale sweep_pass {phase} cluster {cs}: kernel differs "
                  f"from its plain version")
            per_cluster[str(cs or "auto")] = time_ms(
                lambda cs=cs: sweep.sweep_pass_kernel(pa, draws, st2, *case,
                                                      cluster=cs), 2)
        b, by = bound(nb, ops)
        line = {"scale_kernel": "sweep_pass", "shape": [phase, 2],
                "steps": sh.n_steps, "ms": per_cluster["auto"],
                "ms_by_cluster": per_cluster, "plain_ms": plain_ms,
                "max_abs_err": 0, "bound_ms": b, "bound_by": by,
                "smem_bytes": smem,
                "branch": "conflict bits " + ("staged" if bits
                                              else "global"),
                "card": CARD}
        check(not bits, "scale sweep_pass: the conflict bits were staged; "
                        "this phase holds the global branch")
        print(json.dumps(line))
        lines.append(line)
    # K6: the greedy, crowded and parallel modes, two islands of 2; its
    # relocation entry on chains of 3 moves
    L, pop = 2, 2
    par = ga.evaluate(pa, rand(T, L * pop), rand(R, L * pop), L)
    for mode in ("greedy", "crowded", "parallel"):
        cfg = ga.GAConfig(pop_size=pop, p3=0.2,
                          rooms_mode="parallel" if mode == "parallel"
                          else "scan", multi_objective=mode == "crowded")
        bd = ga.make_breed_draws([g] * L, pop, E, T, cfg, dev)
        mo = (nsga.rank_crowd_plain(par.hcv, par.scv, L)
              if mode == "crowded" else None)
        lines.append(scale_compare(
            "breed", [mode, L * pop],
            lambda bd=bd, mo=mo, cfg=cfg: ga.make_children_kernel(
                pa, bd, par, L, mo, cfg.rooms_mode),
            lambda bd=bd, mo=mo, cfg=cfg: ga.make_children_plain(
                pa, bd, par, cfg, L, mo),
            smem=ga.breed_smem_bytes(pa, mode == "parallel")))
    d3 = moves.make_move_draws([g] * 3, 4, E, T, 1.0, 1.0, 1.0, dev)
    chain = moves.MoveDraws(*(x.reshape((3, 4) + x.shape[1:]) for x in d3))
    lines.append(scale_compare(
        "relocate", [4, 3],
        lambda: moves.relocation_chain_kernel(pa, chain, slots, rms, 3),
        lambda: moves.relocation_chain_plain(pa, chain, slots, rms, 3),
        smem=moves.relocate_smem_bytes(pa)))
    # K7: truncation and the ring migration, two islands of 4
    p8 = ga.evaluate(pa, rand(T, 8), rand(R, 8), 2)
    c8 = ga.evaluate(pa, rand(T, 8), rand(R, 8), 2)
    surv = ga.survivors(p8, c8, 2, 4)
    lines.append(scale_compare(
        "survivors", [2, 4], lambda: ga.survivors(p8, c8, 2, 4),
        lambda: ga.survivors_plain(p8, c8, 2, 4)))
    lines.append(scale_compare(
        "migrate", [2, 4], lambda: islands.migrate(surv, 2),
        lambda: islands.migrate_plain(surv, 2)))
    # K8: the pre-pass and the chain (-p 2's K 8), three rows, 5 rounds
    rows = delta.init_rows(pa, slots[:3], rms[:3])
    ls = delta.make_ls_draws([g], 3, 5, 8, E, T, 1.0, 1.0, 0.5, dev)
    events = delta.random_ls_events_kernel(ls)
    lines.append(scale_compare(
        "random_ls_events", [3, 5, 8],
        lambda: delta.random_ls_events_kernel(ls),
        lambda: delta.random_ls_events_plain(ls)))
    k8_smem, k8_bits, _, _ = delta.random_ls_layout(pa, 8)
    check(not k8_bits, "scale random_ls: the conflict bits were staged")
    lines.append(scale_compare(
        "random_ls", [3, 5, 8],
        lambda: delta.random_ls_chain(pa, ls, rows, events),
        lambda: delta.random_local_search_plain(pa, ls, rows),
        smem=k8_smem, branch="conflict bits global"))
    # K9 from random rooms (4 rounds) on crowded slots, and from best fit
    crowd = slots.clone()
    crowd[:, ::2] %= 3
    incoming = rand(R, 4)
    lines.append(scale_compare(
        "parallel_rooms", [4, "augment"],
        lambda: rooms.augment_rooms(pa, crowd, incoming, 4),
        lambda: rooms.augment_rooms_plain(pa, crowd, incoming, 4),
        smem=rooms.parallel_rooms_smem_bytes(pa)))
    lines.append(scale_compare(
        "parallel_rooms", [4, "best-fit"],
        lambda: rooms.parallel_assign_rooms(pa, crowd),
        lambda: rooms.augment_rooms_plain(pa, crowd,
                                          rooms.best_fit_rooms(pa, 4)),
        smem=rooms.parallel_rooms_smem_bytes(pa)))
    # K10 at the lahc path's K 16 and Lh 5,000, two walkers, 20 steps
    l0 = lahc.init_lahc(pa, slots[:2], rms[:2], 5000)
    ld = lahc.make_lahc_draws([g], 2, 20, 16, E, T, 1.0, 1.0, 0.0, dev)
    k10_smem, k10_bits, k10_ring, _ = lahc.lahc_layout(pa, 16, 5000)
    check(not k10_bits, "scale lahc: the conflict bits were staged")
    lines.append(scale_compare(
        "lahc", [2, 16, 5000, 20],
        lambda: lahc.lahc_steps_kernel(pa, ld, lahc_copy(l0)),
        lambda: lahc.lahc_steps_plain(pa, ld, l0), smem=k10_smem,
        branch="conflict bits global, history ring "
               + ("staged" if k10_ring else "global")))
    # K12 (-p 1's K 8), from the pre-pass, two rows, 5 rounds
    k12_smem, _, k12_table, k12_staged = local_search.full_eval_ls_layout(
        pa, 8)
    check(not k12_table, "scale full_eval_ls: the suitable rooms were "
                         "staged; this phase holds the global table")
    lines.append(scale_compare(
        "full_eval_ls", [2, 5, 8],
        lambda: local_search.batch_local_search_kernel(
            pa, delta.LSDraws(*(x[:, :, :2] for x in ls)),
            delta.init_rows(pa, slots[:2], rms[:2])),
        lambda: local_search.batch_local_search_plain(
            pa, delta.LSDraws(*(x[:, :, :2] for x in ls)),
            delta.init_rows(pa, slots[:2], rms[:2])),
        smem=k12_smem,
        branch="suitable rooms global, conflict bits and CSR "
               + ("staged" if k12_staged else "global")))
    lines += compare_scale_lanes(dev)
    return lines


def compare_scale_lanes(dev):
    """K6 (both tournament modes) and K8's chain with a lane table on two
    jobs of 40 and 36 rooms padded into serve's 64-room bucket (their
    dead rooms key 2^20 higher), against the lane-looped plain versions,
    exactly."""
    import torch
    from timetabling_ga_tpu_torch.ops import delta, ga, nsga
    from timetabling_ga_tpu_torch.problem import LaneProblems, random_instance
    from timetabling_ga_tpu_torch.runtime import config
    from timetabling_ga_tpu_torch.serve import bucket
    from timetabling_ga_tpu_torch.serve.scheduler import serve_ga_config
    jobs = [random_instance(s, n_events=E, n_rooms=R, n_features=10,
                            n_students=200, attend_prob=0.02)
            for s, E, R in SCALE_LANES]
    keys = {bucket.bucket_key(p) for p in jobs}
    check(len(keys) == 1 and next(iter(keys))[1] == 64,
          f"scale lanes: not one 64-room bucket: {keys}")
    lp = LaneProblems([bucket.pad_problem(p).device_arrays(dev)
                       for p in jobs])
    L, pop = len(lp), LANE_POP
    cfg = serve_ga_config(config.ServeConfig())
    g = torch.Generator(device=dev).manual_seed(12_500)
    par = ga.PopState(*(torch.cat(x) for x in zip(*(
        ga.evaluate(pa, torch.randint(0, pa.n_slots, (pop, pa.n_events),
                                      generator=g, device=dev,
                                      dtype=torch.int32),
                    torch.randint(0, pa.n_rooms, (pop, pa.n_events),
                                  generator=g, device=dev,
                                  dtype=torch.int32))
        for pa in lp.pas))))
    draws = ga.make_breed_draws([g] * L, pop, lp.n_events, lp.n_slots, cfg,
                                dev)
    mo = nsga.rank_crowd_plain(par.hcv, par.scv, L)
    lines = []
    for tag, m in (("penalty", None), ("crowded", mo)):
        lines.append(scale_compare(
            "breed_lanes", [tag, L, pop, lp.n_rooms],
            lambda m=m: ga.make_children_kernel(lp, draws, par, L, m),
            lambda m=m: ga.make_children_lanes_plain(lp, draws, par, cfg,
                                                     m)))
    rows = ga.make_children_kernel(lp, draws, par, L)
    ls = delta.make_ls_draws([g], L * pop, cfg.ls_steps, cfg.ls_candidates,
                             lp.n_events, lp.n_slots, cfg.p1, cfg.p2,
                             cfg.p3, dev)
    events = delta.random_ls_events_kernel(ls)
    lines.append(scale_compare(
        "random_ls_lanes", [L, pop, lp.n_rooms],
        lambda: delta.random_ls_chain(lp, ls, rows, events),
        lambda: delta.random_ls_lanes_plain(lp, ls, rows)))
    return lines


def scale_k2(problem, dev):
    """K2 at pop 32,768 on the scale instance (measure_scale's batch:
    random slots and rooms from numpy seed 0): ms a batch over 10
    batches, evaluations a second and the peak allocated memory, every
    row equal to the plain version's, taken in chunks of
    SCALE_PLAIN_CHUNK rows."""
    import numpy as np
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.ops import fitness
    pa = problem.device_arrays(dev)
    rng = np.random.default_rng(0)
    P, E = SCALE_POP, pa.n_events
    slots = torch.tensor(rng.integers(0, pa.n_slots, (P, E),
                                      dtype=np.int32), device=dev)
    rms = torch.tensor(rng.integers(0, pa.n_rooms, (P, E), dtype=np.int32),
                       device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = dict(kernels.WORK)
    got = fitness.batch_penalty(pa, slots, rms)
    torch.cuda.synchronize()
    nb = kernels.WORK["bytes"] - before["bytes"]
    ops = kernels.WORK["ops"] - before["ops"]
    ms = time_ms(lambda: fitness.batch_penalty(pa, slots, rms), 10)
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.monotonic()
    for i in range(0, P, SCALE_PLAIN_CHUNK):
        want = fitness.batch_penalty_plain(pa, slots[i:i + SCALE_PLAIN_CHUNK],
                                           rms[i:i + SCALE_PLAIN_CHUNK])
        check(all(torch.equal(w, x[i:i + SCALE_PLAIN_CHUNK])
                  for w, x in zip(want, got)),
              f"scale K2 pop {P}: rows {i}+ differ from the plain version")
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    b, by = bound(nb, ops)
    line = {"scale_k2": P, "ms_per_batch": ms,
            "evals_per_s": P / ms * 1e3, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by,
            "max_memory_allocated": peak, "card": CARD}
    print(json.dumps(line))
    return line


def scale_generation(problem, dev):
    """One size-tuned repair generation at pop 32,768 (2,048 islands of
    the tuned 16 rows, ops/ga.generation as the engine calls it: K6, K5
    twice, K2, K7) from a matched random population, under
    torch.profiler: its wall, device ms by kernel and the peak allocated
    memory; every row's reported (penalty, hcv, scv) equal to the plain
    K2's of its slots and rooms, in chunks."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.obs.prof import kernel_entry
    from timetabling_ga_tpu_torch.ops import fitness, ga, rooms
    from timetabling_ga_tpu_torch.runtime import config, engine
    pa = problem.device_arrays(dev)
    cfg = config.parse_args(["-i", SCALE_TIM] + SCALE_MAIN
                            ).apply_tuned_defaults(pa.n_events)
    gacfg = engine.build_ga_config(cfg)
    L = SCALE_POP // gacfg.pop_size
    gens = engine.island_generators(dev, 42, 0, L)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    g = torch.Generator(device=dev).manual_seed(13_000)
    slots = torch.randint(0, pa.n_slots, (SCALE_POP, pa.n_events),
                          generator=g, device=dev, dtype=torch.int32)
    state = ga.evaluate(pa, slots, rooms.assign_rooms(pa, slots), L)
    del slots
    draws = ga.make_breed_draws(gens, gacfg.pop_size, pa.n_events,
                                pa.n_slots, gacfg, dev)
    ls_fn = ga.ls_draws_fn(gens, gacfg.pop_size, pa, gacfg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = ga.generation(pa, draws, ls_fn, state, gacfg, L)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    for k in ("breed", "sweep_pass", "batch_penalty", "survivors"):
        check(launches.get(k, 0) > 0,
              f"scale generation: {k} never launched ({launches})")
    by_kernel, others = {}, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        key = kernel_entry(ev.key)
        key = key if key in KERNELS else "other"
        by_kernel[key] = by_kernel.get(key, 0.0) + us / 1e3
        if key == "other":
            others.append([ev.key[:60], ev.count, us / 1e3])
    others.sort(key=lambda x: -x[2])
    for i in range(0, SCALE_POP, SCALE_PLAIN_CHUNK):
        c = slice(i, i + SCALE_PLAIN_CHUNK)
        want = fitness.batch_penalty_plain(pa, out.slots[c], out.rooms[c])
        check(all(torch.equal(w, x[c]) for w, x in
                  zip(want, (out.penalty, out.hcv, out.scv))),
              f"scale generation: rows {i}+ report other terms than the "
              f"plain K2 of their slots and rooms")
    line = {"scale_generation": SCALE_POP, "islands": L,
            "pop_size": gacfg.pop_size, "wall_ms": wall_ms,
            "device_ms": sum(by_kernel.values()),
            "device_ms_by_kernel": by_kernel, "top_other": others[:6],
            "launches": launches,
            "max_memory_allocated": peak,
            "best_penalty": int(out.penalty.min()), "card": CARD}
    print(json.dumps(line))
    return line


def scale_path(problem):
    """The main path through the CLI on the scale .tim (size-tuned
    defaults, seed 42, -t 20, --trace), its stream and its launches held
    to the main path's checks; gens/s, the best at the budget, the time
    to the first feasible row where it gets there, and the launches by
    kernel."""
    records, seconds, launches = run_cli("scale", SCALE_MAIN, SCALE_TIM)
    summary = check_stream(records, problem.device_arrays("cpu"))
    summary["wall_s"] = round(seconds, 3)
    check_path_kernels("scale", launches, summary["generations"],
                       summary["kicks"])
    line = {"path": "scale", **summary, "card": CARD,
            "launches": {k: v for k, v in launches.items() if v}}
    print(json.dumps(line))
    return line, launches


def scale_phase(dev):
    """The scale configuration: its kernels against their plain versions,
    K2 at pop 32,768, one repair generation at pop 32,768 and the main
    path on its .tim; the phase's wall printed with the card."""
    t0 = time.monotonic()
    problem = scale_problem()
    compare_scale_kernels(problem, dev)
    scale_k2(problem, dev)
    scale_generation(problem, dev)
    _, launches = scale_path(problem)
    print(json.dumps({"scale_phase_s": time.monotonic() - t0,
                      "card": CARD}))
    return launches


# ---- the university configuration: a registrar timetabling a whole
# university, past ITC-2002 sizes (2,400 events, 400 rooms, 10,000
# students, ~72,000 attendances, ~7 events a student, T 45), inside
# JAX's bounds (E, R < 4096) and cut in no dimension. One individual's
# attendance (900,000 bytes) does not fit in a block's shared memory, so
# K5, K8 and K10 keep it in global memory, K12 its two occupancies, K9
# and K6's parallel matcher their suitability words (and K6 the child's
# occupancy), and K6's relocation entry takes two rows a block; each
# kernel is held against its plain version in the branch the sizes
# choose and again with every region in global memory
# (kernels.STAGE_LIMIT 0), then the five paths run on its .tim.
UNIV_SEED = 11
UNIV_SHAPE = dict(n_events=2400, n_rooms=400, n_features=10,
                  n_students=10_000, attend_prob=0.003)
UNIV_TIM = os.path.join(OUT_DIR, "university_e2400_r400_s10000.tim")
# the five paths with short budgets (the size-tuned main path runs it at
# pop 16: E > 200)
UNIV_PATHS = {
    "main": ["-s", "42", "-t", "12", "--generations", "100000",
             "--trace"],
    "reference": ["--no-auto-tune", "-p", "2", "-s", "42", "-t", "8",
                  "--generations", "100000", "--trace"],
    "full-eval": ["--no-auto-tune", "-p", "1", "--ls-full-eval", "-s", "42",
                  "-t", "8", "--generations", "100000", "--trace"],
    "lahc": ["-s", "42", "-t", "8", "--post-lahc", "5000",
             "--generations", "100000", "--trace"],
    "nsga": ["-s", "42", "-t", "10", "--nsga2", "--rooms-mode", "parallel",
             "--generations", "100000", "--trace"],
}
# two jobs of one serve bucket past shared memory (4,096 students: the
# att of a lane row is 368,640 bytes; 512 rooms) for the lane forms
UNIV_LANES = ((51, 200, 400, 3000), (52, 180, 380, 2600))


def university_problem():
    """The university instance, written to UNIV_TIM and read back."""
    from timetabling_ga_tpu_torch.problem import (
        dump_tim, load_tim_file, random_instance)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(UNIV_TIM, "w") as f:
        f.write(dump_tim(random_instance(UNIV_SEED, **UNIV_SHAPE)))
    return load_tim_file(UNIV_TIM)


def _staged(mask, names):
    """"name staged|global, ..." of a stage mask (bit i: names[i])."""
    return ", ".join(f"{n} {'staged' if mask >> i & 1 else 'global'}"
                     for i, n in enumerate(names))


def univ_branches(pa, k8=8, k10=16, lh=5000, k12=8, shapes=()):
    """Each kernel's branch at `pa`'s sizes under the current
    STAGE_LIMIT, from the wrappers' own layout functions: {name: (bytes
    a block, what it stages)}."""
    from timetabling_ga_tpu_torch.ops import (
        delta, fitness, ga, lahc, local_search, moves, rooms, sweep)
    state = ("occ", "amask", "att")
    out = {}
    for tag, sh in shapes:
        smem, bits, st = sweep.sweep_pass_layout(pa, sh)
        out[f"sweep_pass {tag}"] = (smem, _staged(st, state)
                                    + f", conflict bits "
                                    f"{'staged' if bits else 'global'}")
    smem, bits, st, _ = delta.random_ls_layout(pa, k8)
    out["random_ls"] = (smem, _staged(st, state) + ", conflict bits "
                        + ("staged" if bits else "global"))
    smem, bits, ring, st = lahc.lahc_layout(pa, k10, lh)
    out["lahc"] = (smem, _staged(st, state) + ", conflict bits "
                   + ("staged" if bits else "global") + ", history ring "
                   + ("staged" if ring else "global"))
    smem, occ, table, csr = local_search.full_eval_ls_layout(pa, k12)
    out["full_eval_ls"] = (smem, _staged(int(occ), ("occupancies",))
                           + ", suitable rooms "
                           + ("staged" if table else "global")
                           + ", conflict bits and CSR "
                           + ("staged" if csr else "global"))
    smem, st, _ = rooms.assign_rooms_stage(pa)
    out["assign_rooms"] = (smem, _staged(st, ("occupancy",)))
    smem, st, _ = rooms.parallel_rooms_stage(pa)
    out["parallel_rooms"] = (smem, _staged(st, ("rank rows", "words")))
    for mode, par in (("greedy", False), ("parallel", True)):
        smem, st, _ = ga.breed_stage(pa, par)
        names = ("rank rows", "words", "occupancy")
        out[f"breed {mode}"] = (smem, _staged(st, names) if par
                                else _staged(st >> 2, names[2:]))
    smem, rows, _ = moves.relocate_stage(pa)
    out["relocate"] = (smem, f"{rows} rows a block staged" if rows
                       else "4 rows a block, occupancy global")
    smem, occ = fitness.batch_penalty_stage(pa)
    out["batch_penalty"] = (smem, _staged(int(occ), ("occupancy",)))
    return out


def compare_university_kernels(problem, dev):
    """Every kernel with a branch past shared memory against its plain
    version on the university instance, exactly, at 2-4 rows: in the
    branch the sizes choose, then with every region that grows with the
    students or the rooms in global memory (STAGE_LIMIT 0); K5 at the
    repair shape (hot-K 48: 48 steps) and the post shape cut to 100
    steps (swap block 64, 100 hot pivots), every cluster size. Each line
    names its branch, its bytes a block, its ms a call and the bound of
    work.py's count."""
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.ops import (
        delta, fitness, ga, lahc, local_search, moves, nsga, rooms, sweep)
    pa = problem.device_arrays(dev)
    E, R, T = pa.n_events, pa.n_rooms, pa.n_slots
    check((E, R, pa.n_students) == (UNIV_SHAPE["n_events"],
                                    UNIV_SHAPE["n_rooms"],
                                    UNIV_SHAPE["n_students"]),
          f"university instance is {E} x {R} x {pa.n_students}")
    g = torch.Generator(device=dev).manual_seed(14_000)
    shapes = (("repair", (8, 1, 0.25, 48, 0.0)),
              ("post", (64, 1, 0.25, 100, 0.0)))
    sh = {k: sweep.sweep_shape(E, T, c[0], c[1], c[3], c[4])
          for k, c in shapes}

    def rand(n, P):
        return torch.randint(0, n, (P, E), generator=g, device=dev,
                             dtype=torch.int32)
    slots = rand(T, 4)
    rms = rooms.assign_rooms_plain(pa, slots)
    st = delta.init_state(pa, slots, rms)
    st2 = delta.LSState(*(x[:2] for x in st))
    L, pop = 2, 2
    par = ga.evaluate(pa, rand(T, L * pop), rand(R, L * pop), L)
    d3 = moves.make_move_draws([g] * 3, 4, E, T, 1.0, 1.0, 1.0, dev)
    chain = moves.MoveDraws(*(x.reshape((3, 4) + x.shape[1:]) for x in d3))
    rows = delta.init_rows(pa, slots[:3], rms[:3])
    ls = delta.make_ls_draws([g], 3, 5, 8, E, T, 1.0, 1.0, 0.5, dev)
    events = delta.random_ls_events_kernel(ls)
    ls2 = delta.LSDraws(*(x[:, :, :2] for x in ls))
    rows2 = delta.init_rows(pa, slots[:2], rms[:2])
    crowd = slots.clone()
    crowd[:, ::2] %= 3
    incoming = rand(R, 4)
    l0 = lahc.init_lahc(pa, slots[:2], rms[:2], 5000)
    ld = lahc.make_lahc_draws([g], 2, 20, 16, E, T, 1.0, 1.0, 0.0, dev)
    sweep_draws = {k: sweep.make_sweep_draws([g], 2, sh[k], E, c[2], dev)
                   for k, c in shapes}
    breed = {}
    for mode in ("greedy", "crowded", "parallel"):
        cfg = ga.GAConfig(pop_size=pop, p3=0.2,
                          rooms_mode="parallel" if mode == "parallel"
                          else "scan", multi_objective=mode == "crowded")
        breed[mode] = (cfg, ga.make_breed_draws([g] * L, pop, E, T, cfg, dev),
                       nsga.rank_crowd_plain(par.hcv, par.scv, L)
                       if mode == "crowded" else None)
    calls = [("assign_rooms", [4], lambda: rooms.assign_rooms(pa, slots),
              lambda: rooms.assign_rooms_plain(pa, slots), "assign_rooms"),
             ("batch_penalty", [4],
              lambda: fitness.batch_penalty(pa, slots, rms),
              lambda: fitness.batch_penalty_plain(pa, slots, rms),
              "batch_penalty")]
    for mode, (cfg, bd, mo) in breed.items():
        calls.append((
            "breed", [mode, L * pop],
            lambda bd=bd, mo=mo, cfg=cfg: ga.make_children_kernel(
                pa, bd, par, L, mo, cfg.rooms_mode),
            lambda bd=bd, mo=mo, cfg=cfg: ga.make_children_plain(
                pa, bd, par, cfg, L, mo),
            "breed parallel" if mode == "parallel" else "breed greedy"))
    calls += [
        ("relocate", [4, 3],
         lambda: moves.relocation_chain_kernel(pa, chain, slots, rms, 3),
         lambda: moves.relocation_chain_plain(pa, chain, slots, rms, 3),
         "relocate"),
        ("random_ls_events", [3, 5, 8],
         lambda: delta.random_ls_events_kernel(ls),
         lambda: delta.random_ls_events_plain(ls), None),
        ("random_ls", [3, 5, 8],
         lambda: delta.random_ls_chain(pa, ls, rows, events),
         lambda: delta.random_local_search_plain(pa, ls, rows), "random_ls"),
        ("parallel_rooms", [4, "augment"],
         lambda: rooms.augment_rooms(pa, crowd, incoming, 4),
         lambda: rooms.augment_rooms_plain(pa, crowd, incoming, 4),
         "parallel_rooms"),
        ("parallel_rooms", [4, "best-fit"],
         lambda: rooms.parallel_assign_rooms(pa, crowd),
         lambda: rooms.augment_rooms_plain(pa, crowd,
                                           rooms.best_fit_rooms(pa, 4)),
         "parallel_rooms"),
        ("lahc", [2, 16, 5000, 20],
         lambda: lahc.lahc_steps_kernel(pa, ld, lahc_copy(l0)),
         lambda: lahc.lahc_steps_plain(pa, ld, l0), "lahc"),
        ("full_eval_ls", [2, 5, 8],
         lambda: local_search.batch_local_search_kernel(pa, ls2, rows2),
         lambda: local_search.batch_local_search_plain(pa, ls2, rows2),
         "full_eval_ls")]
    lines, plain = [], {}
    for force in (False, True):
        saved = kernels.STAGE_LIMIT
        if force:
            kernels.STAGE_LIMIT = 0
        try:
            branch = univ_branches(pa, shapes=tuple(sh.items()))
            for name, shape, kern, pl, key in calls:
                smem, desc = branch.get(key, (None, None))
                line = scale_compare(
                    name, shape, kern, pl, smem=smem, branch=desc, reps=2,
                    tag="university", want=plain.get((name, str(shape))),
                    extra={"forced_global": force})
                plain[(name, str(shape))] = line.pop("_want")
                lines.append(line)
            for phase, case in shapes:
                lines.append(univ_sweep(pa, st2, sweep_draws[phase], phase,
                                        case, sh[phase],
                                        branch[f"sweep_pass {phase}"],
                                        force, plain))
        finally:
            kernels.STAGE_LIMIT = saved
    lines += compare_university_lanes(dev)
    return lines


def univ_sweep(pa, st2, draws, phase, case, sh, branch, force, plain):
    """K5 at one shape of the university phase, every cluster size, against
    its plain pass (taken once), exactly; one line."""
    import torch
    from timetabling_ga_tpu_torch import kernels
    from timetabling_ga_tpu_torch.ops import sweep
    key = ("sweep_pass", phase)
    if key not in plain:
        t0 = time.monotonic()
        want = sweep.sweep_pass_plain(pa, draws, st2, *case)
        torch.cuda.synchronize()
        plain[key] = (want, (time.monotonic() - t0) * 1e3)
    (want, want_rows), plain_ms = plain[key]
    per_cluster = {}
    for cs in K5_CLUSTERS:
        before = dict(kernels.WORK)
        got, got_rows, _ = sweep.sweep_pass_kernel(pa, draws, st2, *case,
                                                   cluster=cs)
        torch.cuda.synchronize()
        nb = kernels.WORK["bytes"] - before["bytes"]
        ops = kernels.WORK["ops"] - before["ops"]
        check(all(torch.equal(w, x) for w, x in zip(want, got))
              and torch.equal(want_rows, got_rows),
              f"university sweep_pass {phase} cluster {cs} (forced global "
              f"{force}): kernel differs from its plain version")
        per_cluster[str(cs or "auto")] = time_ms(
            lambda cs=cs: sweep.sweep_pass_kernel(pa, draws, st2, *case,
                                                  cluster=cs), 2)
    b, by = bound(nb, ops)
    line = {"university_kernel": "sweep_pass", "shape": [phase, 2],
            "steps": sh.n_steps, "ms": per_cluster["auto"],
            "ms_by_cluster": per_cluster, "plain_ms": plain_ms,
            "max_abs_err": 0, "bound_ms": b, "bound_by": by,
            "smem_bytes": branch[0], "branch": branch[1],
            "forced_global": force, "card": CARD}
    print(json.dumps(line))
    return line


def compare_university_lanes(dev):
    """K6 (greedy and crowded; parallel) and K8's chain with a lane table
    on two jobs of one serve bucket past shared memory (UNIV_LANES: 4,096
    students and 512 rooms padded), against the lane-looped plain
    versions, exactly, in the branch the sizes choose."""
    import dataclasses

    import torch
    from timetabling_ga_tpu_torch.ops import delta, ga, nsga
    from timetabling_ga_tpu_torch.problem import LaneProblems, random_instance
    from timetabling_ga_tpu_torch.runtime import config
    from timetabling_ga_tpu_torch.serve import bucket
    from timetabling_ga_tpu_torch.serve.scheduler import serve_ga_config
    jobs = [random_instance(s, n_events=E, n_rooms=R, n_features=10,
                            n_students=S, attend_prob=0.01)
            for s, E, R, S in UNIV_LANES]
    keys = {bucket.bucket_key(p) for p in jobs}
    check(len(keys) == 1, f"university lanes: not one bucket: {keys}")
    lp = LaneProblems([bucket.pad_problem(p).device_arrays(dev)
                       for p in jobs])
    L, pop = len(lp), 4
    cfg = serve_ga_config(config.ServeConfig())
    g = torch.Generator(device=dev).manual_seed(14_500)
    par = ga.PopState(*(torch.cat(x) for x in zip(*(
        ga.evaluate(pa, torch.randint(0, pa.n_slots, (pop, pa.n_events),
                                      generator=g, device=dev,
                                      dtype=torch.int32),
                    torch.randint(0, pa.n_rooms, (pop, pa.n_events),
                                  generator=g, device=dev,
                                  dtype=torch.int32))
        for pa in lp.pas))))
    draws = ga.make_breed_draws([g] * L, pop, lp.n_events, lp.n_slots, cfg,
                                dev)
    mo = nsga.rank_crowd_plain(par.hcv, par.scv, L)
    branch = univ_branches(lp.first, k8=cfg.ls_candidates)
    bucket_shape = [lp.n_events, lp.n_rooms, lp.first.n_students]
    lines = []
    for tag, m, mode in (("penalty", None, "scan"), ("crowded", mo, "scan"),
                         ("parallel", None, "parallel")):
        c = dataclasses.replace(cfg, rooms_mode=mode)
        key = "breed parallel" if mode == "parallel" else "breed greedy"
        lines.append(scale_compare(
            "breed_lanes", [tag, L, pop, *bucket_shape],
            lambda m=m, mode=mode: ga.make_children_kernel(
                lp, draws, par, L, m, mode),
            lambda m=m, c=c: ga.make_children_lanes_plain(lp, draws, par, c,
                                                          m),
            smem=branch[key][0], branch=branch[key][1], reps=2,
            tag="university"))
    rows = ga.make_children_kernel(lp, draws, par, L)
    ls = delta.make_ls_draws([g], L * pop, cfg.ls_steps, cfg.ls_candidates,
                             lp.n_events, lp.n_slots, cfg.p1, cfg.p2,
                             cfg.p3, dev)
    events = delta.random_ls_events_kernel(ls)
    lines.append(scale_compare(
        "random_ls_lanes", [L, pop, *bucket_shape],
        lambda: delta.random_ls_chain(lp, ls, rows, events),
        lambda: delta.random_ls_lanes_plain(lp, ls, rows),
        smem=branch["random_ls"][0], branch=branch["random_ls"][1], reps=2,
        tag="university"))
    return lines


def university_paths(problem):
    """The five paths through the CLI on the university .tim, each with a
    short -t, the stream and the launches held to the comp01s paths'
    checks (the lahc path's K10 only where its polish reached
    feasibility: the walkers start there); gens/s (steps/s), the best at
    the budget and the peak memory allocated by each."""
    import torch
    pa_cpu = problem.device_arrays("cpu")
    launches, out = {}, []
    for name, argv in UNIV_PATHS.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        records, seconds, launches[name] = run_cli(f"university-{name}",
                                                   argv, UNIV_TIM)
        peak = torch.cuda.max_memory_allocated()
        summary = check_stream(records, pa_cpu)
        summary["wall_s"] = round(seconds, 3)
        lahc_ran = name != "lahc" or summary["time_to_feasible_s"] is not None
        if lahc_ran:
            check_path_kernels(name, launches[name], summary["generations"],
                               summary["kicks"])
        else:
            check(launches[name]["lahc"] == 0,
                  "university lahc path: K10 launched before feasibility")
            check_path_kernels("main", launches[name],
                               summary["generations"], summary["kicks"])
        if summary["lahc_steps"]:
            summary["lahc_steps_per_s"] = (summary["lahc_steps"]
                                           / summary["lahc_seconds"])
        line = {"path": f"university-{name}", **summary,
                "lahc_reached": lahc_ran if name == "lahc" else None,
                "max_memory_allocated": peak, "card": CARD,
                "launches": {k: v for k, v in launches[name].items() if v}}
        print(json.dumps(line))
        out.append(line)
    return out, launches


def university_phase(dev):
    """The university configuration: its kernels against their plain
    versions in both branches, and the five paths on its .tim; the
    phase's wall printed with the card."""
    t0 = time.monotonic()
    problem = university_problem()
    compare_university_kernels(problem, dev)
    university_paths(problem)
    print(json.dumps({"university_phase_s": time.monotonic() - t0,
                      "card": CARD}))


def run_path(name):
    """Run the CLI on the path's instance with its flags, the launch
    counters zeroed just before and read just after; returns (records,
    seconds, launches)."""
    return run_cli(name, PATHS[name], PATH_TIM.get(name, TIM))


def check_path_kernels(name, launches, generations, kicks):
    per_gen, some, none = PATH_KERNELS[name]
    if name in K2_ONLY_AT_INIT:
        check(launches["batch_penalty"] == 1 + kicks,
              f"{name} path: batch_penalty launched "
              f"{launches['batch_penalty']} times, more than at the "
              f"initial population and the {kicks} kicks")
        check(launches["relocate"] <= kicks,
              f"{name} path: relocate launched {launches['relocate']} "
              f"times, more than at its {kicks} kicks")
    check(generations > 0 or not per_gen,
          f"{name} path: no generation ran")
    for k in per_gen:
        check(launches[k] >= generations,
              f"{name} path: {k} launched {launches[k]} times in "
              f"{generations} generations")
    for k in some:
        check(launches[k] > 0, f"{name} path: {k} never launched")
    for k in none:
        check(launches[k] == 0,
              f"{name} path: {k} launched {launches[k]} times")


def check_stream(records, pa_cpu, extra_kinds=()):
    """Protocol checks (record kinds: the protocol's, phase records and
    `extra_kinds`); returns the summary numbers."""
    import torch
    from timetabling_ga_tpu_torch.ops import fitness
    kinds = {"logEntry", "solution", "runEntry", "phase", *extra_kinds}
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
    lahc = [p for p in phases if p["name"] == "lahc"]
    return dict(
        kicks=sum(1 for p in phases if p["name"] == "kick"),
        lahc_steps=sum(p["steps"] for p in lahc),
        lahc_seconds=sum(p["seconds"] for p in lahc),
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
        from timetabling_ga_tpu_torch.runtime import config
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    bind_counts()
    print(CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build_s = kernels.build()
    print(json.dumps({"build_seconds": round(build_s, 3)}))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in kernels.BUILD_INFO["ptxas"].items():
            f.write(f"== {name}\n{text}\n")
    if sys.argv[1:] in (["scale"], ["university"]):
        # the scale or the university phase alone (`python3 chip_smoke.py
        # scale`, `python3 chip_smoke.py university`)
        (scale_phase if sys.argv[1] == "scale" else university_phase)(dev)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
    problem05 = load_tim_file(TIM05)
    pa05 = problem05.device_arrays(dev)
    with open(WITNESS05) as f:
        w = json.load(f)
    pen, hcv, scv = fitness.batch_penalty(
        pa05, torch.tensor([w["slots"]], dtype=torch.int32, device=dev),
        torch.tensor([w["rooms"]], dtype=torch.int32, device=dev))
    check((int(pen[0]), int(hcv[0]), int(scv[0])) == (0, 0, 0),
          "comp05s witness does not score (0, 0)")

    timings = compare(pa, dev)
    timings.update(compare_batch_penalty(pa, dev))
    timings.update(compare_sweep_pass(pa, pa05, dev))
    timings.update(compare_random_ls(pa, dev))
    timings.update(compare_full_eval_ls(pa, dev))
    timings.update(compare_lahc(pa, dev))
    compare_nsga(pa, dev)
    nsga_t, nsga_keys, nsga_breed, nsga_cases = compare_nsga_path(pa05, dev)
    timings.update(nsga_t)
    k13_t, k13_cases, k13_over = compare_trace_compress(dev)
    timings.update(k13_t)
    print(json.dumps({"trace_compress_compared": k13_cases,
                      "over_cap": k13_over}))
    k14_t, k14_cases, new_outputs = compare_quality(problem, pa, dev)
    timings.update(k14_t)
    print(json.dumps({"quality_compared": k14_cases}))
    for row in new_outputs:
        print(json.dumps(row))
    lane_t = compare_lane_kernels(problem, dev)
    timings.update(lane_t)
    for key, t in lane_t.items():
        print(json.dumps({"lane_kernel": key[0], "lanes": key[1], **t}))
    lane_trace_t, lane_trace_cases = compare_lane_trace_forms(problem, dev)
    timings.update(lane_trace_t)
    print(json.dumps({"lane_trace_forms_compared": lane_trace_cases}))
    print(json.dumps({"islands_compared": compare_islands(pa, dev)}))
    print(json.dumps({"kick_chains_compared": compare_kick_chains(pa, dev)}))
    print(json.dumps({"padded_parallel_rooms_compared":
                      compare_parallel_rooms_padded(problem, dev)}))
    print(json.dumps({"degenerate_matching_compared":
                      compare_matching_degenerate(problem, pa, dev)}))
    print(json.dumps({"nsga_path_shapes_compared": nsga_cases}))
    for row in compare_breed_modes(pa, dev) + nsga_breed:
        print(json.dumps(row))
    print(json.dumps({"fused_scores_compared": FUSED_CHECKS}))
    pa_cpu = {TIM: problem.device_arrays("cpu"),
              TIM05: problem05.device_arrays("cpu")}
    launches = {}
    for name in PATHS:
        records, seconds, launches[name] = run_path(name)
        summary = check_stream(records, pa_cpu[PATH_TIM.get(name, TIM)])
        summary["wall_s"] = round(seconds, 3)
        check_path_kernels(name, launches[name], summary["generations"],
                           summary["kicks"])
        if summary["lahc_steps"]:
            lcfg = config.parse_args(["-i", TIM] + PATHS[name]
                                     ).apply_tuned_defaults(pa.n_events)
            rate = summary["lahc_steps"] / summary["lahc_seconds"]
            summary["lahc_steps_per_s"] = rate
            summary["lahc_candidates_per_s"] = (
                rate * lcfg.post_pop_size * lcfg.post_lahc_k)
        print(json.dumps({"path": name, **summary,
                          "launches": launches[name]}))
    launches["scale"] = scale_phase(dev)
    university_phase(dev)
    print(json.dumps({"path": "trace-modes",
                      "gens_per_s": trace_modes_path(pa_cpu[TIM])}))
    q_rates, launches["quality"] = quality_path(pa_cpu[TIM])
    print(json.dumps({"path": "quality", "gens_per_s": q_rates,
                      "launches": launches["quality"]}))
    print(json.dumps({"path": "stall", **stall_path()}))
    pipe, clean, pipe_launches, obs_recs = pipeline_path(pa_cpu[TIM])
    launches.update(pipe_launches)
    print(json.dumps({"path": "pipeline", "card": CARD, **pipe}))
    print(json.dumps({"path": "obs", **obs_path(obs_recs, pipe)}))
    legs, fault_launches = fault_legs(pa_cpu[TIM], clean,
                                      pipe["pipelined"]["wall_s"])
    launches.update(fault_launches)
    print(json.dumps({"path": "faults", "card": CARD, **legs}))
    serve_obs, serve_obs_launches = serve_obs_path()
    launches.update(serve_obs_launches)
    print(json.dumps({"path": "serve-obs", **serve_obs}))
    serve_faults, serve_fault_launches = serve_fault_legs()
    launches.update(serve_fault_launches)
    print(json.dumps({"path": "serve-faults", **serve_faults}))
    serve_summary, serve_launches = serve_path(pa_cpu)
    launches.update(serve_launches)
    base_wire = serve_summary["warm_start"].pop("base_wire")
    print(json.dumps({"path": "serve", **serve_summary,
                      "launches": launches["serve"]}))
    print(json.dumps({"path": "fleet-replica",
                      **fleet_replica_path(serve_summary)}))
    print(json.dumps({"path": "fleet-gateway",
                      **fleet_gateway_path(serve_summary)}))
    halo_t, halo_cases = compare_migrate_halo(pa, dev)
    timings.update(halo_t)
    print(json.dumps({"migrate_halo_compared": halo_cases}))
    mesh, mesh_launches = mesh_path(pa_cpu[TIM], serve_summary)
    launches.update(mesh_launches)
    print(json.dumps({"path": "mesh", **mesh,
                      "launches": mesh_launches["mesh"]}))
    print(json.dumps({"path": "serve-edit",
                      **serve_edits(base_wire, pa_cpu)}))
    pull, pull_launches = pullfront_path(pa_cpu[TIM])
    launches.update(pull_launches)
    print(json.dumps({"path": "pullfront", **pull}))
    summary, resume_launches = resume_path(pa_cpu[TIM])
    launches.update(resume_launches)
    for name in ("resume", "resume-main"):
        check(all(resume_launches[name][k] == 0 for k in K14),
              f"{name}: K14 launched without --quality")
    print(json.dumps({"path": "resume", **summary, "launches": {
        k: resume_launches[k] for k in ("resume-a", "resume-b", "resume-c",
                                        "resume-main-1", "resume-main-2")}}))
    prof_summary, prof_launches = profile_path(pa_cpu[TIM])
    launches.update(prof_launches)
    print(json.dumps({"path": "profile", **prof_summary}))
    for prof in profile_phases(pa, pa05, dev):
        print(json.dumps({"profile": prof}))
    k2_device_times(pa, dev, timings)
    k9_device_times(timings, K9_TIMED)
    k13_device_times(dev, timings)
    k14_device_times(pa, dev, timings)
    lane_trace_device_times(problem, dev, timings)
    for line in phase_lines(pa, dev):
        print(json.dumps({"phases": line}))
    for key, t in timings.items():
        name = key[0] if key[0] in KERNELS else "sweep_pass"
        print(json.dumps({"kernel": name, "shape": list(key), **t,
                          "launches": launches[KERNELS[name][2]][name]}))
    rows = []
    for name, (src, replaces, path) in KERNELS.items():
        t = timings[{"sweep_pass": ("repair", 16),
                     "random_ls": ("random_ls", 10),
                     "random_ls_events": ("random_ls_events", 10),
                     "full_eval_ls": ("full_eval_ls", 10),
                     "lahc": ("lahc", 4, 16, 5000), **nsga_keys,
                     **{k: (k, 4) for k in LANES},
                     "compress_trace_lanes": ("compress_trace_lanes",
                                              len(LANE_COUNTS),
                                              LANE_TRACE_T),
                     "div_stats_lanes": ("div_stats_lanes",
                                         len(LANE_COUNTS), LANE_POP),
                     **{k: (k, *v) for k, v in K13_TIMED.items()}
                     }.get(name, (name, 16))]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[path][name],
               "path": path, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"],
               "library_ms": t.get("library_ms")}
        if "chain_floor_ms" in t:
            row["chain_floor_ms"] = t["chain_floor_ms"]
        if name == "lahc":
            # the row's ms is the pre-pass and K10 together, the work its
            # bound counts; K10 alone and the one-walker floor beside it
            row.update({k: t[k] for k in (
                "us_per_step", "k10_ms", "k10_us_per_step",
                "us_per_step_one_walker", "k10_us_per_step_one_walker")})
        if "library" in t:
            row["library"] = t["library"]
            row["library_ms_topk"] = t["library_ms_topk"]
        if name in BODY_RUNS_IN:
            row["body_runs_in"] = BODY_RUNS_IN[name]
        if name in K13_TIMED or name in K14 or name in LANE_TRACE:
            row["device_us"] = t.get("device_us")
        if name in LANES:
            row["device_us"] = t["device_us"]
            row["device_us_without_table"] = t["device_us_without_table"]
        rows.append(row)
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
