"""The CUDA sources of K1-K14, run on the CPU, against their plain
PyTorch versions.

The kernels run only on the card (tests/test_torch_kernels.py, marked
`cuda`), but their sources are plain CUDA C++. Here they compile with
g++ against a small stand-in for `cuda_runtime.h` that runs every CUDA
thread of a block as a std::thread: `__syncthreads` and the warp
shuffles become barrier waits, shared-memory atomics become atomic
builtins, and a launch runs its blocks one after another — or, for K5's
thread-block clusters (`cudaLaunchKernelEx`), one cluster after another
with all of a cluster's blocks at once, each on its own shared memory,
`cooperative_groups`' cluster barrier a barrier over their threads
and `map_shared_rank` a pointer into the other block's buffer. The C entry
points are then called through ctypes on CPU tensors. This checks the
kernels' indexing, tie order, reductions and shared-memory layout on
every machine with a C++20 compiler; what nvcc alone refuses, and
timing, show only on the card. The file imports no JAX. The barriers
(`emu_barrier`) put a waiting thread to sleep at once: a block's
threads outnumber the cores, and on a loaded machine (the test run's
other workers) spinning waiters would starve the threads still to
arrive.

This file holds the stand-in and `emulated_fixture`, which builds only
the libraries a test file launches, the shared helpers, and the tests
of K2, K3 and K4; the other kernels' tests are in files of their own
(tests/test_torch_cuda_emu_<kernels>.py: k1_k6, k9, k7, k11, ls,
lanes and K5's k5*), so that under `--dist loadfile` they spread over
the workers.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from tests.test_torch_kernels import (
    WIDE_R, _instances, _ls_draws, _past_one_warp, _state,
    k4_wide_equal_plain)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import delta, fitness, lahc, moves, sweep
from timetabling_ga_tpu_torch.problem import (
    make_problem_arrays, random_instance)

torch.set_num_threads(1)

CUDA_STUB = r'''
#pragma once
#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <optional>
#include <thread>
#include <vector>
#ifdef __linux__
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>
#endif
// std::barrier's interface on an arrival count and a phase word. A
// waiter sleeps on the phase word at once (a futex wait on Linux, with
// no spin first, unlike std::barrier and std::atomic::wait): when a
// block's threads outnumber the cores of a loaded machine, spinning
// waiters would take the cores from the threads still to arrive.
struct emu_barrier {
    using arrival_token = unsigned;
    explicit emu_barrier(int n) : n_(n), left_(n) {}
    arrival_token arrive() {
        arrival_token phase = phase_.load(std::memory_order_acquire);
        if (left_.fetch_sub(1, std::memory_order_acq_rel) == 1) {
            left_.store(n_.load(std::memory_order_relaxed),
                        std::memory_order_relaxed);
            phase_.fetch_add(1, std::memory_order_release);
            wake();
        }
        return phase;
    }
    void wait(arrival_token phase) {
        while (phase_.load(std::memory_order_acquire) == phase)
            sleep(phase);
    }
    void arrive_and_wait() { wait(arrive()); }
    void arrive_and_drop() {
        n_.fetch_sub(1, std::memory_order_relaxed);
        arrive();
    }
  private:
#ifdef __linux__
    void sleep(arrival_token phase) {
        syscall(SYS_futex, &phase_, FUTEX_WAIT_PRIVATE, phase, nullptr,
                nullptr, 0);
    }
    void wake() {
        syscall(SYS_futex, &phase_, FUTEX_WAKE_PRIVATE, INT_MAX, nullptr,
                nullptr, 0);
    }
#else
    void sleep(arrival_token phase) { phase_.wait(phase); }
    void wake() { phase_.notify_all(); }
#endif
    std::atomic<int> n_, left_;
    std::atomic<arrival_token> phase_{0};
};
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchOutOfResources = 2 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
struct emu_dim { unsigned x, y, z; };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// one block's shared memory, barriers and shuffle scratch
struct emu_block {
    std::vector<uint64_t> smem;
    std::unique_ptr<emu_barrier> bar;
    std::vector<std::unique_ptr<emu_barrier>> warp_bar;
    uint64_t lanes[1024];
    int or_acc;
};
inline thread_local emu_dim threadIdx, blockIdx;
inline emu_dim blockDim, gridDim;
inline thread_local unsigned char* emu_smem;
inline thread_local emu_block* emu_blk;
// the thread's cluster: its rank, size, barrier and every block's
// shared memory
inline thread_local unsigned emu_cluster_rank, emu_cluster_n;
inline thread_local emu_barrier* emu_cluster_bar;
inline thread_local std::optional<emu_barrier::arrival_token>
    emu_cluster_token;
inline thread_local unsigned char* const* emu_cluster_smem;
// what cudaOccupancyMaxActiveClusters answers (a test sets 0)
extern "C" {
int emu_max_active_clusters = 1;
}
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
    emu_blk->warp_bar[threadIdx.x >> 5]->arrive_and_wait();
}
template <class T> T emu_shfl_xor(T v, int off) {
    int t = threadIdx.x, w = t >> 5, lane = t & 31;
    std::memcpy(&emu_blk->lanes[t], &v, sizeof(T));
    emu_blk->warp_bar[w]->arrive_and_wait();
    T r;
    std::memcpy(&r, &emu_blk->lanes[(w << 5) | (lane ^ off)], sizeof(T));
    emu_blk->warp_bar[w]->arrive_and_wait();
    return r;
}
#define __shfl_xor_sync(mask, v, off) emu_shfl_xor(v, off)
inline unsigned emu_ballot(bool pred) {
    int t = threadIdx.x, w = t >> 5;
    emu_blk->lanes[t] = pred ? 1 : 0;
    emu_blk->warp_bar[w]->arrive_and_wait();
    unsigned m = 0;
    for (int l = 0; l < 32; ++l)
        if (emu_blk->lanes[(w << 5) | l]) m |= 1u << l;
    emu_blk->warp_bar[w]->arrive_and_wait();
    return m;
}
#define __ballot_sync(mask, pred) emu_ballot(pred)
// every lane's value, then what each lane asks of the 32
template <class T, class F> T emu_warp_all(T v, F f) {
    int t = threadIdx.x, w = t >> 5;
    std::memcpy(&emu_blk->lanes[t], &v, sizeof(T));
    emu_blk->warp_bar[w]->arrive_and_wait();
    T all[32];
    for (int l = 0; l < 32; ++l)
        std::memcpy(&all[l], &emu_blk->lanes[(w << 5) | l], sizeof(T));
    T r = f(all, t & 31);
    emu_blk->warp_bar[w]->arrive_and_wait();
    return r;
}
#define __shfl_sync(mask, v, src) emu_warp_all(v, [&](auto* a, int) { \
    return a[(src) & 31]; })
#define __shfl_up_sync(mask, v, d) emu_warp_all(v, [&](auto* a, int l) { \
    return l >= (d) ? a[l - (d)] : a[l]; })
inline unsigned emu_match_any(int v) {
    return (unsigned)emu_warp_all((int64_t)v, [](int64_t* a, int l) {
        int64_t m = 0;
        for (int i = 0; i < 32; ++i)
            if (a[i] == a[l]) m |= int64_t(1) << i;
        return m;
    });
}
#define __match_any_sync(mask, v) emu_match_any(v)
inline unsigned emu_reduce_or(unsigned v) {
    return emu_warp_all(v, [](unsigned* a, int) {
        unsigned r = 0;
        for (int i = 0; i < 32; ++i) r |= a[i];
        return r;
    });
}
template <class T> T emu_reduce_min(T v) {
    return emu_warp_all(v, [](T* a, int) {
        T r = a[0];
        for (int i = 1; i < 32; ++i) r = a[i] < r ? a[i] : r;
        return r;
    });
}
template <class T> T emu_reduce_max(T v) {
    return emu_warp_all(v, [](T* a, int) {
        T r = a[0];
        for (int i = 1; i < 32; ++i) r = a[i] > r ? a[i] : r;
        return r;
    });
}
#define __reduce_or_sync(mask, v) emu_reduce_or(v)
#define __reduce_min_sync(mask, v) emu_reduce_min(v)
#define __reduce_max_sync(mask, v) emu_reduce_max(v)
// a block barrier answering whether any thread's predicate was non-zero
inline int __syncthreads_or(int pred) {
    if (threadIdx.x == 0) __atomic_store_n(&emu_blk->or_acc, 0,
                                           __ATOMIC_SEQ_CST);
    emu_blk->bar->arrive_and_wait();
    if (pred) __atomic_store_n(&emu_blk->or_acc, 1, __ATOMIC_SEQ_CST);
    emu_blk->bar->arrive_and_wait();
    int r = __atomic_load_n(&emu_blk->or_acc, __ATOMIC_SEQ_CST);
    emu_blk->bar->arrive_and_wait();
    return r;
}
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
    return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAnd(unsigned* p, unsigned v) {
    return __atomic_fetch_and(p, v, __ATOMIC_SEQ_CST);
}
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) int2 { int x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline int atomicMin(int* p, int v) {
    int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
    while (v < old && !__atomic_compare_exchange_n(
               p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
    }
    return old;
}
using std::max;
using std::min;
inline float __int_as_float(int x) {
    float f;
    std::memcpy(&f, &x, 4);
    return f;
}
inline int __float_as_int(float x) {
    int i;
    std::memcpy(&i, &x, 4);
    return i;
}
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r;}
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r;}
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
// a card of two SMs, one block each
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
    *v = 2;
    return 0;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
    *n = 1;
    return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
// Runs a grid cluster by cluster: every thread of a cluster's blocks at
// once, each block with its own poisoned shared memory.
inline void emu_run(int grid, int block, size_t smem, int cluster,
                    std::function<void()> body) {
    blockDim = {(unsigned)block, 1, 1};
    gridDim = {(unsigned)grid, 1, 1};
    for (int c = 0; c < grid / cluster; ++c) {
        std::vector<emu_block> blocks(cluster);
        std::vector<unsigned char*> bases(cluster);
        for (int r = 0; r < cluster; ++r) {
            blocks[r].smem.assign(smem / 8 + 2, 0xABABABABABABABABull);
            blocks[r].bar.reset(new emu_barrier(block));
            for (int w = 0; w < (block + 31) / 32; ++w)
                blocks[r].warp_bar.emplace_back(new emu_barrier(32));
            bases[r] = (unsigned char*)blocks[r].smem.data();
        }
        emu_barrier cbar(cluster * block);
        std::vector<std::thread> th;
        for (int r = 0; r < cluster; ++r)
            for (int t = 0; t < block; ++t)
                th.emplace_back([&, r, t] {
                    threadIdx = {(unsigned)t, 0, 0};
                    blockIdx = {(unsigned)(c * cluster + r), 0, 0};
                    emu_blk = &blocks[r];
                    emu_smem = bases[r];
                    emu_cluster_rank = r;
                    emu_cluster_n = cluster;
                    emu_cluster_bar = &cbar;
                    emu_cluster_smem = bases.data();
                    body();
                    emu_blk->bar->arrive_and_drop();
                    cbar.arrive_and_drop();
                });
        for (auto& x : th) x.join();
    }
}
inline void emu_launch(int grid, int block, size_t smem,
                       std::function<void()> body) {
    emu_run(grid, block, smem, 1, body);
}
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue {
    struct { unsigned x, y, z; } clusterDim;
    char pad[64];
};
struct cudaLaunchAttribute {
    cudaLaunchAttributeID id;
    cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K,
                                           const cudaLaunchConfig_t*) {
    *n = emu_max_active_clusters;
    return 0;
}
template <class... A, class... B>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(A...), B&&... args) {
    unsigned cluster = 1;
    for (unsigned i = 0; i < cfg->numAttrs; ++i)
        if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
            cluster = cfg->attrs[i].val.clusterDim.x;
    if (cluster < 1 || cfg->gridDim.x % cluster) return cudaErrorInvalidValue;
    emu_run(cfg->gridDim.x, cfg->blockDim.x, cfg->dynamicSmemBytes, cluster,
            [&] { kernel(args...); });
    return cudaSuccess;
}
'''

CG_STUB = r'''
#pragma once
#include <cuda_runtime.h>
namespace cooperative_groups {
struct cluster_group {
    unsigned block_rank() const { return emu_cluster_rank; }
    unsigned num_blocks() const { return emu_cluster_n; }
    template <class T> T* map_shared_rank(T* p, unsigned rank) const {
        return (T*)(emu_cluster_smem[rank]
                    + ((unsigned char*)p - emu_smem));
    }
    void sync() const { emu_cluster_bar->arrive_and_wait(); }
    // the two halves of sync(); a thread holds one arrival at a time
    void barrier_arrive() const {
        emu_cluster_token.emplace(emu_cluster_bar->arrive());
    }
    void barrier_wait() const {
        emu_cluster_bar->wait(std::move(*emu_cluster_token));
        emu_cluster_token.reset();
    }
};
inline cluster_group this_cluster() { return cluster_group{}; }
}  // namespace cooperative_groups
'''

# K5 built with 128-thread CTAs (4 warps), which keeps a cluster's
# std::threads few; K2 built to stage nothing, which runs its
# global-memory path (a CSR slice and rows too large for shared memory),
# and K12 so too (the conflict bitset and the CSR from global memory),
# and K12 reading its suitable-rooms table from global memory as well
K5_SMALL = "sweep_pass_small"
K2_GLOBAL = "batch_penalty_global"
K12_GLOBAL = "full_eval_ls_global"
K12_TABLE = "full_eval_ls_table"
K11_NO_WORDS = "nsga_no_words"
EMULATED = ("assign_rooms", "batch_penalty", "move1_sweep", "delta_one",
            "sweep_pass", "breed", "survivors", "random_ls",
            "parallel_rooms", "lahc", "nsga", "full_eval_ls",
            "trace_compress", "quality")
# the block-per-row kernels built with two warps a block (their thread
# counts are macros), which keeps the std::threads few and gives each
# warp several slots or candidates; K8 with room for 48 bytes of events
# (two rounds of 4 candidates), so that its rounds cross chunks; K2 with
# 128-thread CTAs, as K5's cluster tests take them; K7 with two warps;
# K12 with two-warp CTAs and room for 112 bytes of draws (one to four
# rounds at K = 5 to 2), so that its rounds cross chunks; K10 with two
# warps and room for 200 bytes of draws (one to three steps at K = 5 to
# 1), so that its steps cross chunks
SMALL = {"lahc": ["-DK10_MAX_WARPS=2", "-DK10_CHUNK_BYTES=200"],
         "assign_rooms": ["-DK1_THREADS=64"], "breed": ["-DK6_THREADS=64"],
         "nsga": ["-DK11_THREADS=64"], "parallel_rooms": ["-DK9_THREADS=64"],
         "random_ls": ["-DK8_MAX_WARPS=2", "-DK8_EVENT_BYTES=48"],
         "batch_penalty": ["-DK2_THREADS=128"],
         "survivors": ["-DK7_THREADS=64"], "quality": ["-DK14_THREADS=64"],
         "full_eval_ls": ["-DK12_THREADS=64", "-DK12_CHUNK_BYTES=112"]}


def _for_the_cpu(src: str) -> str:
    """A kernel source with its shared-memory declaration pointed at the
    stand-in's block buffer and its launch made a call of emu_launch."""
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu_smem;", src)
    return re.sub(
        r"(\w+)<<<(.*?)>>>\((.*?)\);",
        lambda m: (f"emu_launch({m.group(2).rsplit(',', 1)[0]}, "
                   f"[&] {{ {m.group(1)}({m.group(3)}); }});"),
        src, flags=re.S)


# each library as the card builds its source but for SMALL's thread
# counts (name: (source, flags)), and the variants: K5 with 128-thread
# CTAs, K2 and K12 staging nothing (K12 also without its table), K11
# without its dominator words
BUILDS = {n: (n, SMALL.get(n, [])) for n in EMULATED}
BUILDS[K5_SMALL] = ("sweep_pass", ["-DK5_THREADS=128"])
BUILDS[K2_GLOBAL] = ("batch_penalty",
                     SMALL["batch_penalty"] + ["-DK2_STAGE_LIMIT=0"])
BUILDS[K12_GLOBAL] = ("full_eval_ls",
                      SMALL["full_eval_ls"] + ["-DK12_STAGE_LIMIT=0"])
BUILDS[K12_TABLE] = ("full_eval_ls",
                     SMALL["full_eval_ls"] + ["-DK12_STAGE_LIMIT=0",
                                              "-DK12_TABLE_LIMIT=0"])
BUILDS[K11_NO_WORDS] = ("nsga", SMALL["nsga"] + ["-DK11_WORDS_LIMIT=0"])


def _keys(name: str, src: str) -> dict:
    """`kernels._LIBS` key -> entry point of library `name` built from
    `src`: a source's own build under its entry points' names, a variant
    of a one-entry source under its own name, else under its name
    followed by each entry point's."""
    entries = kernels.SOURCES[src]
    if name == src:
        return {e: e for e in entries}
    if len(entries) == 1:
        return {name: entries[0]}
    return {name + e: e for e in entries}


def emulated_fixture(*names):
    """A module fixture that builds the libraries `names` (keys of
    BUILDS) for the CPU, all at once, and swaps them into `kernels` (and
    `kernels.ptr` taught to take CPU tensors) for the module's tests.
    Each test file builds only what its tests launch."""

    @pytest.fixture(scope="module")
    def emulated(tmp_path_factory):
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("needs g++ to build the CUDA sources for the CPU")
        d = tmp_path_factory.mktemp("cuda_emu")
        (d / "cuda_runtime.h").write_text(CUDA_STUB)
        (d / "cooperative_groups.h").write_text(CG_STUB)
        for path in kernels.CSRC.iterdir():
            (d / path.name).write_text(_for_the_cpu(path.read_text()))
        procs = {n: subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-x", "c++",
             f"-I{d}", *BUILDS[n][1], "-o", str(d / f"{n}.so"),
             str(d / f"{BUILDS[n][0]}.cu"), "-lpthread"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in names}
        for n, proc in procs.items():
            out, _ = proc.communicate()
            assert proc.returncode == 0, (
                f"{n} does not build for the CPU:\n{out}")
        saved = dict(kernels._LIBS), kernels.ptr, kernels.launch
        for n in names:
            for key, entry in _keys(n, BUILDS[n][0]).items():
                kernels._LIBS[key] = kernels.load(entry, d / f"{n}.so")

        def launch(name, *args, work=None):
            kernels.LAUNCHES[name] += 1
            if work is not None:
                kernels.tally(work)
            entry = kernels.FORMS.get(name, name)
            assert kernels._LIBS[entry][1](*args, None) == 0

        kernels.ptr = lambda t: t.data_ptr()
        kernels.launch = launch
        yield
        kernels._LIBS.clear()
        kernels._LIBS.update(saved[0])
        kernels.ptr, kernels.launch = saved[1], saved[2]

    return emulated


# the tests of K2, K3 and K4 (and K8's epilogue against K2)
emulated = emulated_fixture("move1_sweep", "delta_one", "batch_penalty",
                            K2_GLOBAL, "random_ls")


def _k3(pa, st, piv):
    """move1_sweep's kernel path, on CPU tensors."""
    P, B = piv.shape
    out = torch.empty((3, P, B, pa.n_slots), dtype=torch.int32)
    amask, slot_ev = delta.slot_bitsets(pa, st.slots, st.att)
    p = kernels.ptr
    kernels.launch(
        "move1_sweep", p(st.slots), p(st.rooms), p(st.att), p(st.occ),
        p(amask), p(slot_ev), p(piv), p(pa.possible_u8), p(pa.live), p(pa.student_count),
        p(pa.conflict_bits), p(pa.cap_rank), p(pa.dead), p(pa.ev_ptr),
        p(pa.ev_stu), p(out[0]), p(out[1]), p(out[2]), P, B, pa.n_events,
        pa.n_rooms, pa.n_students, pa.n_slots, pa.slots_per_day,
        pa.conflict_bits.shape[1], pa.max_ev_students)
    return out[0], out[1], out[2]


def _k4(pa, st, evs, ns, act):
    """delta_one's kernel path, on CPU tensors."""
    P, C, _ = evs.shape
    d = torch.empty((2, P, C), dtype=torch.int32)
    nr = torch.empty((P, C, 3), dtype=torch.int32)
    args = [x.contiguous() for x in (
        *delta.slot_bitsets(pa, st.slots, st.att), evs, ns,
        act.to(torch.uint8))]
    p = kernels.ptr
    kernels.launch(
        "delta_one", p(st.slots), p(st.rooms), p(st.att), p(st.occ),
        *(p(a) for a in args), p(pa.possible_u8), p(pa.live),
        p(pa.student_count), p(pa.conflict_bits), p(pa.cap_rank),
        p(pa.dead), p(pa.attends_u8), p(pa.ev_ptr), p(pa.ev_stu), p(d[0]),
        p(d[1]), p(nr), P, C, pa.n_events, pa.n_rooms, pa.n_students,
        pa.n_slots, pa.slots_per_day, pa.conflict_bits.shape[1])
    return d[0], d[1], nr


def _tiny():
    """A 24-event instance, small enough for a full-permutation pass."""
    return random_instance(7, n_events=24, n_rooms=4, n_features=3,
                           n_students=30, attend_prob=0.15).device_arrays()


def _event_draws(P, n_rounds, K, E, offset, seed):
    """LSDraws whose uniforms (n_rounds, K, P, E) start `offset` floats
    into their buffer (off a 16-byte boundary when offset % 4 != 0); the
    pre-pass reads only the uniforms."""
    g = torch.Generator().manual_seed(seed)
    n = n_rounds * K * P
    buf = torch.rand(offset + n * E, generator=g)
    z = torch.zeros((n_rounds, K, P), dtype=torch.int32)
    return delta.LSDraws(z, buf[offset:].view(n_rounds, K, P, E), z)


def _tied_top3(draws):
    """Every row's top three tied at 2.0 at indices spread over lanes,
    the body and the last floats, and row 0 with its largest tied at
    3.0 twice and its third tied with a later index."""
    u = draws.u.clone()
    E = u.shape[-1]
    for i in (E - 1, 33 % E, 2):
        u[..., i] = 2.0
    u.view(-1, E)[0, [40 % E, 5 % E]] = 3.0
    u.view(-1, E)[0, E - 2] = 2.0
    return draws._replace(u=u)


def _k2_rows(pa, P, seed):
    """P random rows and rooms, with a few clashes and unsuitable rooms
    (rooms drawn at random, not matched)."""
    g = torch.Generator().manual_seed(seed)
    slots = torch.randint(0, pa.n_slots, (P, pa.n_events), generator=g,
                          dtype=torch.int32)
    rms = torch.randint(0, pa.n_rooms, (P, pa.n_events), generator=g,
                        dtype=torch.int32)
    return slots, rms


# a history longer than shared memory holds (2 x 30,000 ints): K10 keeps
# the ring in global memory
K10_GLOBAL_LH = 30_000


def lahc_start(pa, W, Lh, seed):
    """Walkers from random rows, their history rings spread around each
    walker's cost (so the entry a step reads decides some acceptances)
    and their steps apart (so their ring positions differ)."""
    st = _state(pa, W, seed)
    ls0 = lahc.init_lahc(pa, st.slots, st.rooms, Lh)
    g = torch.Generator().manual_seed(seed)
    jitter = torch.randint(-2, 3, (2, W, Lh), generator=g,
                           dtype=torch.int32)
    return ls0._replace(hist_pen=ls0.hist_pen + jitter[0],
                        hist_scv=ls0.hist_scv + jitter[1],
                        step=torch.arange(W, dtype=torch.int32) * 7)


def k10_equals_plain(pa, draws, ls0):
    """The pre-pass and K10 on a copy of `ls0`, one launch each, against
    lahc_steps_plain: every field of the state, exactly."""
    kernels.reset_launches()
    ls1 = lahc.LahcState(lahc.LSState(*(x.clone() for x in ls0.ls)),
                         *(x.clone() for x in ls0[1:]))
    got = lahc.lahc_steps_kernel(pa, draws, ls1)
    want = lahc.lahc_steps_plain(pa, draws, ls0)
    assert kernels.LAUNCHES["random_ls_events"] == 1
    assert kernels.LAUNCHES["lahc"] == 1
    assert all(torch.equal(w, x) for w, x in zip(want.ls, got.ls))
    assert all(torch.equal(w, x) for w, x in zip(want[1:], got[1:]))
    return got


# (instance, K, cluster): the ITC-like, medium, padded and anchored
# instances; K <= CS (a candidate a CTA) and K > CS (a CTA takes several)
K12_CASES = [(1, 2, None), (2, 4, 4), (3, 5, 2), (0, 3, 1), (2, 3, 2)]


@pytest.mark.parametrize("inst", range(4))
def test_k3_k4_sources_equal_plain(emulated, inst):
    pa = _instances("cpu")[inst]
    st = _state(pa, 4, 3)
    piv = torch.randint(0, pa.n_events, (4, 2), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    got = _k3(pa, st, piv)
    want = sweep.move1_sweep_plain(pa, st.slots, st.rooms, st.att, st.occ,
                                   piv)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    P, C = 3, 5
    d = moves.make_move_draws([torch.Generator().manual_seed(5)], P * C,
                              pa.n_events, pa.n_slots, 1.0, 1.0, 1.0, "cpu")
    st3 = delta.LSState(*(x[:P] for x in st))
    evs, ns, act = moves.sample_move(pa, d,
                                     st3.slots.repeat_interleave(C, 0))
    evs, ns, act = (x.reshape(P, C, 3) for x in (evs, ns, act))
    evs[0, 0, 1] = evs[0, 0, 0]          # a duplicate-event candidate
    got = _k4(pa, st3, evs, ns, act)
    want = delta.delta_one_plain(pa, st3.slots, st3.rooms, st3.att,
                                 st3.occ, evs, ns, act)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("inst", [0, 1, 2, 3, "tiny"])
def test_k2_source_equals_plain(emulated, inst, cluster):
    """K2's own launch, a cluster of 1, 2 or 4 128-thread CTAs a row
    (each its share of the cells, events, correlation words and the
    students of its staged CSR slice, rank 0 summing the others' through
    their shared memory), equals batch_penalty_plain on random rows, on
    the 24-120-event instances (random, ITC-like, padded, anchored)."""
    pa = _tiny() if inst == "tiny" else _instances("cpu")[inst]
    slots, rms = _k2_rows(pa, 3, 300 + cluster)
    kernels.reset_launches()
    got = fitness.batch_penalty_kernel(pa, slots, rms, cluster=cluster)
    want = fitness.batch_penalty_plain(pa, slots, rms)
    assert kernels.LAUNCHES["batch_penalty"] == 1
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert int(want[1].min()) > 0          # infeasible rows: every term


@pytest.mark.parametrize("cluster", [1, 4])
def test_k2_global_memory_path_equals_plain(emulated, monkeypatch,
                                            cluster):
    """K2 built to stage nothing reads the students' CSR and the conflict
    rows from global memory, as it does where they do not fit in shared
    memory, and equals batch_penalty_plain."""
    monkeypatch.setitem(kernels._LIBS, "batch_penalty",
                        kernels._LIBS[K2_GLOBAL])
    for inst in (2, 3):
        pa = _instances("cpu")[inst]
        slots, rms = _k2_rows(pa, 3, 310 + inst)
        got = fitness.batch_penalty_kernel(pa, slots, rms, cluster=cluster)
        want = fitness.batch_penalty_plain(pa, slots, rms)
        assert all(torch.equal(w, g) for w, g in zip(want, got))


def test_k2_refused_cluster_is_not_shrunk(emulated, monkeypatch):
    """When the card can place no cluster of the asked size, K2's entry
    point returns an error before it launches (the wrapper's
    kernels.launch raises on it), and no smaller cluster is tried."""
    pa = _tiny()
    slots, rms = _k2_rows(pa, 2, 5)
    lib = kernels._LIBS["batch_penalty"][0]
    answer = ctypes.c_int.in_dll(lib, "emu_max_active_clusters")
    rcs = []
    monkeypatch.setattr(kernels, "launch", lambda name, *args, work=None: rcs.append(
        kernels._LIBS[name][1](*args, None)))
    answer.value = 0
    try:
        fitness.batch_penalty_kernel(pa, slots, rms, cluster=2)
    finally:
        answer.value = 1
    assert rcs == [2]                      # cudaErrorLaunchOutOfResources


def test_evaluations_count_live_events_only(emulated):
    """compute_hcv counts conflicts between live events only. K8's slot
    bitsets hold padded events too, so its epilogue's full evaluation
    masks them out; K2 builds its bitsets from live events alone. Both
    equal the plain versions where a padded event's conflict row is not
    empty (here made so: padded events 80-84 conflict with live events
    0-4, each pair in one slot)."""
    pa = _instances("cpu")[2]
    fields = {k: getattr(pa, k).numpy().copy() for k in (
        "attends", "conflict", "possible", "student_count", "room_size",
        "event_mask", "room_mask", "anchor_slots", "anchor_w")}
    live = fields["event_mask"] > 0.5
    pad = [e for e in range(pa.n_events) if not live[e]]
    assert len(pad) >= 5
    for f, e in enumerate(pad[:5]):
        fields["conflict"][e, f] = fields["conflict"][f, e] = 1.0
    pa = make_problem_arrays(**fields, n_days=pa.n_days,
                             slots_per_day=pa.slots_per_day)
    slots, rms = _state(pa, 3, 44)[:2]
    slots[:, pad[:5]] = slots[:, :5]       # each pair in one slot
    st = delta.init_rows(pa, slots, rms)
    draws = _ls_draws(pa, "cpu", 3, 3, 4, 54)
    got = delta.random_local_search_kernel(pa, draws, st)
    want = delta.random_local_search_plain(pa, draws, st)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert (got.slots[:, pad[:5]] == got.slots[:, :5]).any()
    for cs in (1, 2):
        assert all(torch.equal(w, g) for w, g in zip(
            fitness.batch_penalty_plain(pa, slots, rms),
            fitness.batch_penalty_kernel(pa, slots, rms, cs)))


@pytest.mark.parametrize("R", WIDE_R)
def test_k4_source_past_one_warp_equals_plain(emulated, R):
    """K4's own launch at 33 and 80 rooms: the body's room choice over
    rooms l, l + 32, ... of each lane, then the warp's."""
    k4_wide_equal_plain(_past_one_warp(R, "cpu"), "cpu", 710 + R, _k4)
