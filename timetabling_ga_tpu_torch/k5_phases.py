"""Where one K5 sweep pass spends its time, on the card.

    python -m timetabling_ga_tpu_torch.k5_phases

Builds csrc/sweep_pass.cu once more with K5's phase counters compiled in
(-DTT_K5_PROF: block 0's thread 0 — rank 0 of cluster 0 — reads
clock64() at each phase boundary, csrc/sweep_dev.cuh), under
build/torch_kernels/k5_phases/. At the main path's three sweep shapes on
fixtures/comp01s.tim — the engine's repair pass at P = 16 and 256
individuals, its post pass at P = 4 — each at the cluster size K5's
wrapper takes there, it checks that the instrumented K5 equals the
regular one exactly and prints one JSON line per shape with the cluster
size, each phase's share of that thread's cycles and its cycles per
step ("cluster reduction" is the wait at the cluster barrier and the
read of the other CTAs' records). The first line is the card's name and
power limit. Needs a CUDA device and nvcc.
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
# counter k of csrc/sweep_pass.cu / sweep_dev.cuh TT_PROF(k)
PHASES = ("move1", "k4 occupancy + room argmins",
          "k4 unsuitable + conflict dots", "k4 day re-score",
          "candidate store", "wait for the other warps",
          "reduction 1 (lex min)", "reduction 2 + choice", "apply",
          "prologue (load + pivots)", "epilogue", "cluster reduction")


def build_prof():
    """K5 with the phase counters compiled in, loaded as kernels.load
    loads the regular library."""
    out = kernels.BUILD_DIR / "k5_phases"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "sweep_pass-prof.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DTT_K5_PROF", "-o",
         str(path), str(kernels.CSRC / "sweep_pass.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"k5_phases: K5 does not build:\n{proc.stdout}")
    return kernels.load("sweep_pass", path)


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
    regular = kernels._LIBS["sweep_pass"]
    prof = build_prof()
    pa = load_tim_file(str(COMP01S)).device_arrays(dev)
    cfg = config.parse_args(["-i", str(COMP01S)]).apply_tuned_defaults(
        pa.n_events)
    repair = engine.build_ga_config(cfg)
    post = engine.build_post_config(cfg, repair)
    E, T = pa.n_events, pa.n_slots
    counters = (ctypes.c_ulonglong * 16)()
    take = prof[0].tt_prof_take
    take.argtypes = [ctypes.c_void_p]
    take.restype = ctypes.c_int
    try:
        for phase, P, gc in (("repair", 16, repair), ("repair", 256, repair),
                             ("post", post.pop_size, post)):
            args = (gc.ls_swap_block, gc.ls_block_events, gc.ls_sideways,
                    gc.ls_hot_k, gc.p3)
            sh = sweep.sweep_shape(E, T, gc.ls_swap_block,
                                   gc.ls_block_events, gc.ls_hot_k, gc.p3)
            g = torch.Generator(device=dev).manual_seed(3000 + P)
            slots = torch.randint(0, T, (P, E), generator=g, device=dev,
                                  dtype=torch.int32)
            st = delta.init_state(pa, slots,
                                  rooms.assign_rooms_plain(pa, slots))
            draws = sweep.make_sweep_draws([g], P, sh, E, gc.ls_sideways,
                                           dev)

            cs = sweep.auto_cluster(pa, sh, P, dev)

            def run(lib):
                kernels._LIBS["sweep_pass"] = lib
                return sweep.sweep_pass_kernel(pa, draws, st, *args,
                                               cluster=cs)

            want = run(regular)
            if take(ctypes.addressof(counters)) != 0:
                raise RuntimeError("k5_phases: reading the counters failed")
            got = run(prof)
            torch.cuda.synchronize()
            if take(ctypes.addressof(counters)) != 0:
                raise RuntimeError("k5_phases: reading the counters failed")
            if not all(torch.equal(w, x) for w, x in zip(
                    (*want[0], *want[1:]), (*got[0], *got[1:]))):
                raise RuntimeError(f"k5_phases: the instrumented K5 differs "
                                   f"from K5 ({phase}, P={P})")
            cyc = [int(counters[k]) for k in range(len(PHASES))]
            total = sum(cyc)
            print(json.dumps({
                "shape": [phase, P], "steps": sh.n_steps, "cluster": cs,
                "rank0_cycles": total,
                "share": {n: c / total for n, c in zip(PHASES, cyc)},
                "cycles_per_step": {n: c / sh.n_steps
                                    for n, c in zip(PHASES, cyc)}}))
    finally:
        kernels._LIBS["sweep_pass"] = regular
    return 0


if __name__ == "__main__":
    sys.exit(main())
