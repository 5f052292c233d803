"""timetabling_ga_tpu_torch — the PyTorch/CUDA port of timetabling_ga_tpu.

The same memetic GA for university course timetabling (`.tim` input,
the same CLI flags, the same JSONL protocol), running on an NVIDIA
Hopper GPU: plain PyTorch for the tensor code and hand-written CUDA
kernels (csrc/, K1-K14, built lazily by kernels.py) for every device
program of its paths — the CLI solve and the multi-tenant `serve`
subcommand (serve/). Importing the package needs no CUDA toolchain and
never imports JAX; it imports torch only when one of the names below is
first read (PEP 562), so the offline log readers (`trace`, `stats`,
`quality`, `usage`) run without it.
"""

__all__ = ["Problem", "ProblemArrays", "load_tim", "load_tim_file"]


def __getattr__(name):
    if name in __all__:
        from timetabling_ga_tpu_torch import problem
        return getattr(problem, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
