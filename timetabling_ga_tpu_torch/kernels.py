"""Build and bind the hand-written CUDA kernels (plain C interface).

Each `csrc/<name>.cu` compiles with `nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC` into its own
shared library under `build/torch_kernels/` at the repository root,
named by a hash of the sources and flags, so a checkout builds exactly
what it holds. All sources compile in parallel, once, at the first CUDA
launch (or an explicit `build()`); nothing here runs at import time, so
`import timetabling_ga_tpu_torch` needs no CUDA toolchain.

Every C entry point launches on PyTorch's current stream and returns
`cudaGetLastError()`; `launch` raises on a non-zero code. `LAUNCHES`
counts the launches of each kernel: a wrapper adds one exactly where it
launches its kernel, so a run can show its path went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signature of each entry point: pointers, then ints, then the stream
SIGNATURES = {
    "assign_rooms": ("tt_assign_rooms", [_P] * 7 + [_I] * 4 + [_P]),
    "batch_penalty": ("tt_batch_penalty", [_P] * 13 + [_I] * 8 + [_P]),
    "move1_sweep": ("tt_move1_sweep", [_P] * 16 + [_I] * 9 + [_P]),
    "delta_one": ("tt_delta_one", [_P] * 19 + [_I] * 8 + [_P]),
}

LAUNCHES = {name: 0 for name in SIGNATURES}

_LIBS: dict = {}
_LOCK = threading.Lock()
# seconds the last build() took and the compiler's resource report
BUILD_INFO: dict = {"seconds": None, "ptxas": {}}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every kernel library that is not built yet, all in
    parallel, and load them. Returns the seconds it took."""
    with _LOCK:
        t0 = time.monotonic()
        todo = {n: _lib_path(n) for n in SIGNATURES if n not in _LIBS}
        missing = {n: p for n, p in todo.items() if not p.exists()}
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name, path in missing.items():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, path)
            failed = []
            for name, (proc, tmp, path) in procs.items():
                out, _ = proc.communicate()
                BUILD_INFO["ptxas"][name] = out
                if proc.returncode != 0:
                    failed.append(f"{name}:\n{out}")
                    continue
                os.replace(tmp, path)
            if failed:
                raise RuntimeError("CUDA kernel build failed:\n"
                                   + "\n".join(failed))
        for name, path in todo.items():
            lib = ctypes.CDLL(str(path))
            sym, argtypes = SIGNATURES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.tt_error_string.argtypes = [ctypes.c_int]
            lib.tt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = (lib, fn)
        BUILD_INFO["seconds"] = time.monotonic() - t0
        return BUILD_INFO["seconds"]


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a contiguous CUDA tensor."""
    if not t.is_cuda:
        raise ValueError("kernel argument is not on a CUDA device")
    if not t.is_contiguous():
        raise ValueError("kernel argument is not contiguous")
    return t.data_ptr()


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream; raise on an error."""
    if name not in _LIBS:
        build()
    lib, fn = _LIBS[name]
    stream = torch.cuda.current_stream().cuda_stream
    LAUNCHES[name] += 1
    rc = fn(*args, stream)
    if rc != 0:
        msg = lib.tt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({rc})")
