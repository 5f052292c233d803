"""Build and bind the hand-written CUDA kernels (plain C interface).

Each `csrc/<source>.cu` compiles with `nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC` into its own
shared library under `build/torch_kernels/` at the repository root,
named by a hash of the source, the local headers it includes and the
flags, so a checkout builds exactly what it holds. All sources compile
in parallel, once, at the first CUDA launch (or an explicit `build()`);
nothing here runs at import time, so `import timetabling_ga_tpu_torch`
needs no CUDA toolchain.

A source may hold several entry points (K6 `breed.cu`: breed and
relocate; K7 `survivors.cu`: survivors and migrate; K8 `random_ls.cu`:
its pre-pass random_ls_events, which also feeds K12 `full_eval_ls.cu`
and K10 `lahc.cu`, and the chain random_ls; K11 `nsga.cu`:
nsga_rank and nsga_survivors; K13 `trace_compress.cu`: compress_trace
and moment_rows; K14 `quality.cu`: quality_ops and div_stats); each has
its own name here; K6 and K8's chain launched with a lane table, K13's
compress_trace with per-lane valid counts and K14's div_stats with
per-lane masks (the serve path), and K7's migrate with an island mesh's
halo rows, count under FORMS' names. Every C entry
point launches on PyTorch's current stream and returns
`cudaGetLastError()`; `launch` raises on a non-zero code.
`LAUNCHES` counts the launches of each entry point: a wrapper adds one
exactly where it launches its kernel, so a run can show its path went
through them. `WORK` sums the operations and bytes of every launch
(work.py TABLE, counted from shapes, the port's counterpart of XLA's
cost_analysis); on the CPU each wrapper adds its kernel branch's work
with `tally`, so a program's counted work is the same on either device
(obs/cost.py CostProgram reads its growth over a call).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the most dynamic shared memory one block may opt into on sm_90
SMEM_LIMIT = 232_448
# the most shared memory a block stages the regions of stage_regions in;
# the emulated tests set 0 to run every global-memory branch
STAGE_LIMIT = SMEM_LIMIT

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signature of each entry point: pointers, then ints, then the stream;
# and the csrc/<source>.cu that holds it
SIGNATURES = {
    "assign_rooms": ("tt_assign_rooms", [_P] * 8 + [_I] * 6 + [_P],
                     "assign_rooms"),
    "batch_penalty": ("tt_batch_penalty", [_P] * 15 + [_I] * 11 + [_P],
                      "batch_penalty"),
    "move1_sweep": ("tt_move1_sweep", [_P] * 18 + [_I] * 9 + [_P],
                    "move1_sweep"),
    "delta_one": ("tt_delta_one", [_P] * 21 + [_I] * 8 + [_P],
                  "delta_one"),
    "sweep_pass": ("tt_sweep_pass", [_P] * 37 + [_I] * 18 + [_P],
                   "sweep_pass"),
    "breed": ("tt_breed", [_P] * 33 + [_I] * 13 + [_P], "breed"),
    "relocate": ("tt_relocate", [_P] * 12 + [_I] * 7 + [_P], "breed"),
    "survivors": ("tt_survivors", [_P] * 15 + [_I] * 5 + [_P],
                  "survivors"),
    "migrate": ("tt_migrate", [_P] * 13 + [_I] * 3 + [_P], "survivors"),
    "random_ls_events": ("tt_random_ls_events", [_P] * 2 + [_I] * 4 + [_P],
                         "random_ls"),
    "random_ls": ("tt_random_ls", [_P] * 28 + [_I] * 13 + [_P],
                  "random_ls"),
    "full_eval_ls": ("tt_full_eval_ls", [_P] * 24 + [_I] * 14 + [_P],
                     "full_eval_ls"),
    "parallel_rooms": ("tt_parallel_rooms", [_P] * 9 + [_I] * 7 + [_P],
                       "parallel_rooms"),
    "lahc": ("tt_lahc", [_P] * 30 + [_I] * 12 + [_P], "lahc"),
    "nsga_rank": ("tt_nsga_rank", [_P] * 4 + [_I] * 2 + [_P], "nsga"),
    "nsga_survivors": ("tt_nsga_survivors", [_P] * 15 + [_I] * 5 + [_P],
                       "nsga"),
    "compress_trace": ("tt_compress_trace", [_P] * 3 + [_I] * 4 + [_P],
                       "trace_compress"),
    "moment_rows": ("tt_moment_rows", [_P] * 3 + [_I] * 2 + [_P],
                    "trace_compress"),
    "quality_ops": ("tt_quality_ops", [_P] * 7 + [_I] * 2 + [_P],
                    "quality"),
    "div_stats": ("tt_div_stats", [_P] * 5 + [_I] * 6 + [_P], "quality"),
}

# the entry points of each source
SOURCES: dict = {}
for _name, (_, _, _src) in SIGNATURES.items():
    SOURCES.setdefault(_src, []).append(_name)

# Forms of an entry point counted under a name of their own, the serve
# lanes' (problem.py LaneProblems): K6 and K8's chain with a lane table,
# K13's compress_trace with a per-lane valid count and K14's div_stats
# with a mask row a lane are the same C entry points as without them
FORMS = {"breed_lanes": "breed", "random_ls_lanes": "random_ls",
         "compress_trace_lanes": "compress_trace",
         "div_stats_lanes": "div_stats",
         # K7's migrate with the halo rows of an island mesh's shard
         # boundary (parallel/islands.py mesh_migrate)
         "migrate_halo": "migrate"}

LAUNCHES = {name: 0 for name in (*SIGNATURES, *FORMS)}
# running totals of the launched (or, on the CPU, tallied) work
WORK = {"ops": 0, "bytes": 0}

_LIBS: dict = {}
_LOCK = threading.Lock()
# seconds the last build() took, the seconds of every build that loaded
# a library (the serve meter's compile_seconds reads its growth across a
# quantum) and the compiler's resource report
BUILD_INFO: dict = {"seconds": None, "total_seconds": 0.0, "ptxas": {}}


def stage_regions(base: int, regions) -> tuple:
    """Which of a kernel's `regions` that grow with the students or the
    rooms one block stages in shared memory, beside the `base` bytes it
    always stages: `regions` are their sizes in bytes, most read by the
    kernel's hot loop first, and each in turn is staged where it still
    fits under STAGE_LIMIT (the rest are read and written in global
    memory). Each region is rounded up to 16 bytes. Decided from the
    sizes alone, on the host, before any build or launch. Returns (the
    staged bytes, base included, and a flag a region)."""
    total, flags = base, []
    for size in regions:
        size = -(-size // 16) * 16
        fits = total + size <= min(STAGE_LIMIT, SMEM_LIMIT)
        flags.append(fits)
        total += size if fits else 0
    return total, tuple(flags)


def stage_bits(flags) -> int:
    """The flags of stage_regions as the bit mask a C entry point takes
    (bit i: region i staged)."""
    return sum(1 << i for i, f in enumerate(flags) if f)


def resident_grid(n: int, device, cluster: int = 1) -> int:
    """Blocks (or clusters of `cluster` CTAs) of a launch whose CTAs
    each own a scratch row in global memory and loop over its `n` items
    (grid-stride): as many CTAs as the card holds at once at two a
    streaming multiprocessor, at most n blocks or clusters and at least
    one, so the scratch is sized by the card and not by n. On the CPU
    (where the C sources run only in the emulated tests) two CTAs, so
    that a block takes several items."""
    ctas = 2
    if getattr(device, "type", device) == "cuda":
        ctas *= torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n, ctas // cluster))


def check_smem(name: str, smem: int) -> None:
    """Raise ValueError, before any launch, where one block of kernel
    `name` would need `smem` bytes of shared memory, more than
    SMEM_LIMIT."""
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: one individual's state needs {smem} bytes of shared "
            f"memory, more than the {SMEM_LIMIT} a block can have")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tally(work) -> None:
    """Add one launch's `work` (a work.Work) to WORK: `launch` does it
    for a kernel, a wrapper's CPU branch for its plain version."""
    WORK["ops"] += int(work.ops)
    WORK["bytes"] += int(work.bytes)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(source: str) -> list:
    """`csrc/<source>.cu` and every local header it includes,
    recursively, in first-include order."""
    out, todo = [], [CSRC / f"{source}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return out


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for part in _sources(source):
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every kernel library that is not built yet, all in
    parallel, and load them. Returns the seconds it took."""
    with _LOCK:
        t0 = time.monotonic()
        todo = {src: _lib_path(src) for src, names in SOURCES.items()
                if any(n not in _LIBS for n in names)}
        missing = {src: p for src, p in todo.items() if not p.exists()}
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for src, path in missing.items():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{src}.cu")]
                procs[src] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, path)
            failed = []
            for src, (proc, tmp, path) in procs.items():
                out, _ = proc.communicate()
                BUILD_INFO["ptxas"][src] = out
                if proc.returncode != 0:
                    failed.append(f"{src}:\n{out}")
                    continue
                os.replace(tmp, path)
            if failed:
                raise RuntimeError("CUDA kernel build failed:\n"
                                   + "\n".join(failed))
        for src, path in todo.items():
            for name in SOURCES[src]:
                # keyed by entry name alone: `path` hashes the source and
                # NVCC_FLAGS (_lib_path). The one other writer,
                # k5_phases._instrumented, swaps in -DTT_K5_PROF builds
                # under the same names and puts these back in its `finally`
                # tt-analyze: ignore[TT202]
                _LIBS[name] = load(name, path)
        BUILD_INFO["seconds"] = time.monotonic() - t0
        if todo:
            BUILD_INFO["total_seconds"] += BUILD_INFO["seconds"]
        return BUILD_INFO["seconds"]


def load(name: str, path) -> tuple:
    """(library, entry point) of kernel `name` from the shared library
    at `path`, with the C signature bound."""
    lib = ctypes.CDLL(str(path))
    sym, argtypes, _ = SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.tt_error_string.argtypes = [ctypes.c_int]
    lib.tt_error_string.restype = ctypes.c_char_p
    return lib, fn


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a contiguous CUDA tensor."""
    if not t.is_cuda:
        raise ValueError("kernel argument is not on a CUDA device")
    if not t.is_contiguous():
        raise ValueError("kernel argument is not contiguous")
    return t.data_ptr()


def launch(name: str, *args, work=None) -> None:
    """Launch kernel `name` (an entry point, or one of its FORMS, which
    counts under its own name) on the current stream, adding its `work`
    (a work.Work) to WORK; raise on an error."""
    entry = FORMS.get(name, name)
    if entry not in _LIBS:
        build()
    lib, fn = _LIBS[entry]
    stream = torch.cuda.current_stream().cuda_stream
    LAUNCHES[name] += 1
    if work is not None:
        tally(work)
    rc = fn(*args, stream)
    if rc != 0:
        msg = lib.tt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({rc})")
