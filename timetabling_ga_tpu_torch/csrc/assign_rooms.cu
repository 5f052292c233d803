// K1: greedy most-constrained-first room matching of a population.
//
// Replaces timetabling_ga_tpu/ops/rooms.py:108 `assign_rooms` (with
// `choose_room` :93, `_room_key` :68 and `capacity_rank` :60), which XLA
// runs as an E-step lax.scan whose carry is the (T, R) occupancy grid.
//
// Bound on this card: neither bytes nor operations. One individual moves
// 2*E int32 (3.2 KB at E=400) and does E*R key evaluations; the time is
// the longest chain of dependent argmins: each step reads the slot's R
// occupancy counts and the event's R suitability flags, reduces, and
// writes one count that the slot's next step reads.
//
// Design: one block per individual. As the JAX docstring says (rooms.py
// :111-117), slot occupancies are independent: an event's key reads only
// its own slot's row, so the E-step chain splits exactly into T chains,
// one per slot, each that slot's events in the matching order — at most
// R live events a slot in a feasible timetable, about E/T in a random
// one. The block takes each event's slot in matching order into shared
// memory, then its warps walk their slots' chains in parallel
// (rooms_dev.cuh `tt_match_rooms_block`: a ballot over the order picks a
// slot's events, each lane over rooms l, l + 32, ... takes its part of
// each argmin, ties toward the lower room as jnp.argmin). The event
// order (a stable sort of suitable-room counts) and the capacity rank
// are computed once per problem on the host, as the JAX version
// computes them once per trace.
// K6 runs the same body on every crossover child. Where the occupancy
// does not fit in shared memory (past ~1,283 rooms at E = 400; the
// wrapper's stage flag, decided from the sizes), the GLOB instance keeps
// it in a global scratch row a block and its `grid` blocks stride over
// the individuals, so the scratch is sized by the card, not by P.
#include "rooms_dev.cuh"

// threads of a block (the CPU stand-in builds it small)
#ifndef K1_THREADS
#define K1_THREADS 512
#endif
// bit of the stage mask (kernels.stage_regions): the occupancy staged
#define K1_OCC 1

// individual p's rooms, with `so` and `occ` the block's (the caller
// syncs after)
__device__ __forceinline__ void k1_row(const TTRoomProblem& rp,
                                       const int* slots, int* rooms,
                                       const int* order, int* so, int* occ,
                                       int p) {
    const int E = rp.E;
    const int* sl = slots + (size_t)p * E;
    for (int i = threadIdx.x; i < E; i += blockDim.x) so[i] = sl[order[i]];
    for (int i = threadIdx.x; i < rp.T * rp.R; i += blockDim.x) occ[i] = 0;
    __syncthreads();
    tt_match_rooms_block(rp, order, so, occ, rooms + (size_t)p * E);
}

template <bool GLOB>
__global__ void __launch_bounds__(K1_THREADS) assign_rooms_kernel(
    const int* __restrict__ slots, int* __restrict__ rooms,
    const uint8_t* __restrict__ possible, const int* __restrict__ cap_rank,
    const int* __restrict__ dead, const int* __restrict__ live,
    const int* __restrict__ order, int* __restrict__ scratch, int P, int E,
    int R, int T) {
    extern __shared__ int smem[];
    int* so = smem;                                    // (E,)
    const TTRoomProblem rp = {possible, cap_rank, dead, live, E, R, T};
    if (!GLOB) {
        // (T, R) after so; a block an individual
        k1_row(rp, slots, rooms, order, so, smem + E, blockIdx.x);
        return;
    }
    // the block's scratch row, its individuals grid-stride
    int* occ = scratch + (size_t)blockIdx.x * T * R;
    for (int p = blockIdx.x; p < P; p += gridDim.x) {
        k1_row(rp, slots, rooms, order, so, occ, p);
        __syncthreads();
    }
}

extern "C" int tt_assign_rooms(const int* slots, int* rooms,
                               const uint8_t* possible, const int* cap_rank,
                               const int* dead, const int* live,
                               const int* order, int* scratch, int P, int E,
                               int R, int T, int stage, int grid,
                               void* stream) {
    const bool glob = !(stage & K1_OCC);
    if (!tt_rooms_fit(E, R) || P <= 0 || (glob && (!scratch || grid <= 0)))
        return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * ((size_t)E + (glob ? 0 : (size_t)T * R));
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    const auto kernel = glob ? assign_rooms_kernel<true>
                             : assign_rooms_kernel<false>;
    cudaError_t err = tt_set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<glob ? grid : P, K1_THREADS, smem, (cudaStream_t)stream>>>(
        slots, rooms, possible, cap_rank, dead, live, order, scratch, P, E,
        R, T);
    return (int)cudaGetLastError();
}
