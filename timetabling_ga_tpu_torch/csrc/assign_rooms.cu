// K1: greedy most-constrained-first room matching of a population.
//
// Replaces timetabling_ga_tpu/ops/rooms.py:108 `assign_rooms` (with
// `choose_room` :93, `_room_key` :68 and `capacity_rank` :60), which XLA
// runs as an E-step lax.scan whose carry is the (T, R) occupancy grid.
//
// Bound on this card: neither bytes nor operations. One individual moves
// 2*E int32 (3.2 KB at E=400) and does E*R key evaluations; the chain of
// E dependent argmins is latency: each step reads the slot, the R
// occupancy counts and the R suitability flags, reduces, and writes one
// count that the next step may read.
//
// Design: one warp per individual, one lane per room (R <= 32). The
// individual's slots and its (T, R) occupancy live in shared memory, so
// a step is shared-memory loads plus a 5-level shuffle argmin that
// breaks ties toward the lower room (jnp.argmin's first-index rule). The
// event order (a stable sort of suitable-room counts) and the capacity
// rank are computed once per problem on the host, as the JAX version
// computes them once per trace.
#include "common.cuh"

#define K1_WARPS 4

__global__ void assign_rooms_kernel(
    const int* __restrict__ slots, int* __restrict__ rooms,
    const uint8_t* __restrict__ possible, const int* __restrict__ cap_rank,
    const int* __restrict__ dead, const int* __restrict__ live,
    const int* __restrict__ order, int P, int E, int R, int T) {
    extern __shared__ int smem[];
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* ord = smem;                                   // (E,)
    int* base = smem + E + warp * (T * R + E);
    int* occ = base;                                   // (T, R)
    int* sl = base + T * R;                            // (E,)
    for (int i = threadIdx.x; i < E; i += blockDim.x) ord[i] = order[i];
    int p = blockIdx.x * K1_WARPS + warp;
    bool active = p < P;
    if (active) {
        for (int i = lane; i < T * R; i += 32) occ[i] = 0;
        for (int i = lane; i < E; i += 32) sl[i] = slots[(size_t)p * E + i];
    }
    __syncthreads();
    if (!active) return;
    int cr = lane < R ? cap_rank[lane] : 0;
    int dd = lane < R ? dead[lane] : 0;
    int* out = rooms + (size_t)p * E;
    for (int i = 0; i < E; ++i) {
        int e = ord[i];
        int t = sl[e];
        int key = 0x7fffffff;
        if (lane < R) {
            int unsuit = possible[e * R + lane] ? 0 : 1;
            key = (occ[t * R + lane] + unsuit) * TT_W_COST
                  + unsuit * TT_W_UNSUIT + cr + dd;
        }
        int r = tt_warp_argmin(key, lane);
        if (lane == 0) {
            out[e] = r;
            // padded events choose a room but occupy nothing
            occ[t * R + r] += live[e];
        }
        __syncwarp();
    }
}

extern "C" int tt_assign_rooms(const int* slots, int* rooms,
                               const uint8_t* possible, const int* cap_rank,
                               const int* dead, const int* live,
                               const int* order, int P, int E, int R, int T,
                               void* stream) {
    if (R > 32 || P <= 0) return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * ((size_t)E + K1_WARPS * ((size_t)T * R + E));
    cudaError_t err = tt_set_smem(assign_rooms_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    int grid = (P + K1_WARPS - 1) / K1_WARPS;
    assign_rooms_kernel<<<grid, 32 * K1_WARPS, smem, (cudaStream_t)stream>>>(
        slots, rooms, possible, cap_rank, dead, live, order, P, E, R, T);
    return (int)cudaGetLastError();
}
