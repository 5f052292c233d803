// Shared helpers of the timetabling kernels (sm_90a, plain C interface).
//
// Every kernel here is integer-exact: it reproduces the JAX package's
// float32-of-small-integers arithmetic with int32 arithmetic, so its
// outputs equal the plain PyTorch versions (and the JAX reference) bit
// for bit. Each C entry point launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper raises on non-zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Phase counters of the kernels k5_phases reads (K2, K5, K7-K12),
// compiled in only with -DTT_K5_PROF (see timetabling_ga_tpu_torch/k5_phases.py): block 0's
// thread 0 (rank 0 of cluster 0) adds the clock64() cycles since its
// previous mark to counter k, so the counters partition that thread's
// time in the launch. TT_PROF_BARRIER() is a block barrier in that build
// only, where a phase's own time should not include the wait for the
// block's slowest thread. Otherwise the marks are empty statements.
#ifdef TT_K5_PROF
__device__ unsigned long long tt_prof_acc[16];
__device__ long long tt_prof_last;
#define TT_PROF_START()                                                \
    do {                                                               \
        if (blockIdx.x == 0 && threadIdx.x == 0)                       \
            tt_prof_last = clock64();                                  \
    } while (0)
#define TT_PROF(k)                                                     \
    do {                                                               \
        if (blockIdx.x == 0 && threadIdx.x == 0) {                     \
            long long now_ = clock64();                                \
            tt_prof_acc[k] += now_ - tt_prof_last;                     \
            tt_prof_last = now_;                                       \
        }                                                              \
    } while (0)
#define TT_PROF_BARRIER() __syncthreads()
// copy the counters out and zero them
extern "C" int tt_prof_take(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, tt_prof_acc,
                                           sizeof(tt_prof_acc));
    if (err != cudaSuccess) return (int)err;
    unsigned long long zero[16] = {0};
    return (int)cudaMemcpyToSymbol(tt_prof_acc, zero, sizeof(zero));
}
#else
#define TT_PROF_START() do {} while (0)
#define TT_PROF(k) do {} while (0)
#define TT_PROF_BARRIER() do {} while (0)
#endif

// Room-key weights: marginal hcv cost >> suitability tie >> capacity
// rank (timetabling_ga_tpu/ops/rooms.py:42-51, _room_key). The dead-room
// penalty arrives precomputed per room (`dead`), as in _dead_rooms.
#define TT_W_COST (1 << 13)
#define TT_W_UNSUIT (1 << 12)
#define TT_INFEASIBLE_OFFSET 1000000
#define TT_FULL_MASK 0xffffffffu
// the most dynamic shared memory one block may opt into on sm_90
// (kernels.SMEM_LIMIT in Python)
#define TT_SMEM_LIMIT 232448

// The room key's packing bound (ops/rooms.py check_packing, JAX
// rooms.py:122): cap_rank < R stays under the unsuitable flag's 2^12 and
// the key inside int32 for E < 4096 and R < 4096. Every kernel that
// chooses a room takes any such E and R; what is refused past them is
// refused by the bytes of shared memory a block needs.
static inline bool tt_rooms_fit(int E, int R) {
    return E > 0 && E < 4096 && R > 0 && R < 4096;
}

// Whether a room choice needs more than one room a lane: lane l takes
// rooms l, l + 32, ..., and where there are no more rooms than a warp's
// lanes the kernels run their one-room-a-lane instance.
#define TT_WARP_LANES 32
__host__ __device__ __forceinline__ bool tt_wide_rooms(int R) {
    return R > TT_WARP_LANES;
}

extern "C" const char* tt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// scv of one student's day: runs of >= 3 (+1 per extra class) and a
// single-class day (+1) — ops/delta.py _day_scv on a bit row of
// `spd` slots (bit j = slot j of the day attended).
__device__ __forceinline__ int tt_day_scv(uint32_t bits) {
    int consec = __popc(bits & (bits >> 1) & (bits >> 2));
    return consec + (__popc(bits) == 1 ? 1 : 0);
}

// The `spd` bits of day `d` of a 64-bit attended-slot mask.
__device__ __forceinline__ uint32_t tt_day_bits(uint64_t mask, int d,
                                                int spd) {
    return (uint32_t)((mask >> (d * spd)) & ((1ull << spd) - 1ull));
}

// Warp-wide argmin of (key, idx): every lane ends with the winner; ties
// go to the lower index, as jnp.argmin / torch.argmin return the first.
__device__ __forceinline__ int tt_warp_argmin(int key, int idx) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        int k2 = __shfl_xor_sync(TT_FULL_MASK, key, off);
        int i2 = __shfl_xor_sync(TT_FULL_MASK, idx, off);
        if (k2 < key || (k2 == key && i2 < idx)) {
            key = k2;
            idx = i2;
        }
    }
    return idx;
}

__device__ __forceinline__ int tt_warp_sum(int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(TT_FULL_MASK, v, off);
    return v;
}

// Block-wide sum; `scratch` holds one int per warp. All threads get it.
__device__ __forceinline__ int tt_block_sum(int v, int* scratch) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int nw = (blockDim.x + 31) >> 5;
    v = tt_warp_sum(v);
    __syncthreads();
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < nw; ++w) total += scratch[w];
    return total;
}

// A lane table (the serve path's per-lane problems, problem.py
// LaneProblems): one row of TT_LANE_FIELDS int64 a lane, the device
// addresses of that lane's ProblemArrays fields and then its scalars.
// K6 and K8's chain take it as one pointer: null, they read the problem
// from their other arguments; else a block reads its lane's row once and
// runs the shared bodies on that lane's arrays. Within a bucket every
// lane has the same E, R, S, T and W, so the shared memory a block takes
// is the same for every lane. The order is problem.py LANE_FIELDS.
enum {
    TT_LANE_POSSIBLE, TT_LANE_CAP_RANK, TT_LANE_DEAD, TT_LANE_LIVE,
    TT_LANE_ROOM_ORDER, TT_LANE_SUIT_RANK, TT_LANE_ROOM_OF_RANK,
    TT_LANE_STUDENT_COUNT, TT_LANE_CONFLICT_BITS, TT_LANE_STU_PTR,
    TT_LANE_STU_EV, TT_LANE_EV_PTR, TT_LANE_EV_STU, TT_LANE_ATTENDS,
    TT_LANE_ANCHOR_SLOTS, TT_LANE_ANCHOR_W, TT_LANE_DIAG, TT_LANE_ANCHORED,
    TT_LANE_FIELDS
};

// field `f` of a lane's row, as a pointer to T
template <typename T>
__device__ __forceinline__ const T* tt_lane_ptr(const long long* row,
                                                int f) {
    return (const T*)(uintptr_t)row[f];
}

// Start copying n ints from global `src` to shared `dst`, each thread
// its own, with cp.async: every copy of the block in flight at once, no
// register round trip. tt_async_wait, then a block barrier, makes them
// visible. (Elsewhere than on the card, a plain copy.)
__device__ __forceinline__ void tt_async_ints(int* dst, const int* src,
                                              int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
#ifdef __CUDA_ARCH__
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(d), "l"(src + i) : "memory");
#else
        dst[i] = src[i];
#endif
    }
}

// One cp.async copy of this thread, of 16 bytes (both addresses 16-byte
// aligned; it bypasses L1) or of 4; tt_async_wait and a barrier make it
// visible, as above.
__device__ __forceinline__ void tt_async_16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
#else
    for (int i = 0; i < 16; ++i)
        ((unsigned char*)dst)[i] = ((const unsigned char*)src)[i];
#endif
}

__device__ __forceinline__ void tt_async_4(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
#else
    *(int*)dst = *(const int*)src;
#endif
}

// Wait for every cp.async copy this thread started.
__device__ __forceinline__ void tt_async_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t tt_set_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
