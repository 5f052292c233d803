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

// Room-key weights: marginal hcv cost >> suitability tie >> capacity
// rank (timetabling_ga_tpu/ops/rooms.py:42-51, _room_key). The dead-room
// penalty arrives precomputed per room (`dead`), as in _dead_rooms.
#define TT_W_COST (1 << 13)
#define TT_W_UNSUIT (1 << 12)
#define TT_INFEASIBLE_OFFSET 1000000
#define TT_FULL_MASK 0xffffffffu

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

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t tt_set_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
