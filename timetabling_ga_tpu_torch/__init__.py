"""timetabling_ga_tpu_torch — the PyTorch/CUDA port of timetabling_ga_tpu.

The same memetic GA for university course timetabling (`.tim` input,
the same CLI flags, the same JSONL protocol), running on an NVIDIA
Hopper GPU: plain PyTorch for the tensor code and hand-written CUDA
kernels (csrc/, K1-K14, built lazily by kernels.py) for every device
program of its paths — the CLI solve and the multi-tenant `serve`
subcommand (serve/). Importing the package needs no CUDA toolchain and
never imports JAX.
"""

from timetabling_ga_tpu_torch.problem import (  # noqa: F401
    Problem, ProblemArrays, load_tim, load_tim_file)
