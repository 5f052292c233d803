// K9: the parallel room matcher of a population in one launch.
//
// Replaces timetabling_ga_tpu/ops/rooms.py:154 `augment_rooms` and :304
// `parallel_assign_rooms` (vmapped by `batch_parallel_assign_rooms`),
// the O(1)-depth alternative to K1's E-long greedy chain that
// --rooms-mode parallel puts on every crossover child (ops/ga.py:200-204).
// XLA runs a round as a dozen (E, R) gathers, argmins and (T, R+1)
// scatter-mins.
//
// Bound on this card: neither bytes (an individual's slots and rooms,
// ~3 KB at E=400) nor operations (a round takes an event two picks, an
// AND and a find-first-set each, and two ballot bids); its time is the
// chain of dependent steps of a slot's matching. The phase
// counters of the previous design (the whole individual on one warp,
// ~40 dependent warp phases over (T, R+1) grids in shared memory;
// k5_phases) put four-fifths of a launch in the augment rounds.
//
// Design: one block per individual, its warps a slot each, with the body
// in rooms_dev.cuh (`tt_parallel_rooms_block`: rooms as bits in
// capacity-rank order in ceil(R / 32) words, the slot's rank rows in
// shared memory, bids resolved by __match_any_sync peers and bid-for
// words), which K6 runs on each crossover child;
// this entry runs it on whole rows, for the unit checks and for batch
// calls. The block keeps the slots, the rooms, the matched ranks, the
// events' suitability words (ceil(R / 32) an event), the events bucketed
// by slot and each warp's rank rows in shared memory (~21 KB at comp05s,
// ~74 KB at E = 2000, R = 80). Without
// incoming rooms the start is parallel_assign_rooms's best-fit room per
// event.
#include "rooms_dev.cuh"

// threads of a block (the CPU stand-in builds it small)
#ifndef K9_THREADS
#define K9_THREADS 512
#endif

__global__ void __launch_bounds__(K9_THREADS) parallel_rooms_kernel(
    const int* __restrict__ slots, const int* __restrict__ rooms_in,
    const int* __restrict__ cap_rank, const int* __restrict__ dead,
    const int* __restrict__ live,
    const uint32_t* __restrict__ suit, const int* __restrict__ room_of,
    int* __restrict__ rooms_out, int E, int R, int T, int n_rounds) {
    extern __shared__ int k9_smem[];
    TT_PROF_START();
    const int c = blockIdx.x;
    int* sl = k9_smem;
    int* rm = sl + E;
    // the matcher reads the rooms' suitability as suit words only
    const TTRoomProblem rp = {nullptr, cap_rank, dead, live, E, R, T};
    const TTRankRooms rr = {suit, room_of, (R + 31) / 32};
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        sl[e] = slots[(size_t)c * E + e];
        rm[e] = rooms_in ? rooms_in[(size_t)c * E + e]
                         : tt_best_fit_room(rr, e);
    }
    __syncthreads();
    TT_PROF(0);
    tt_parallel_rooms_block(rp, rr, sl, rm, rm + E, n_rounds, nullptr);
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x)
        rooms_out[(size_t)c * E + e] = rm[e];
    TT_PROF(4);
}

extern "C" int tt_parallel_rooms(const int* slots, const int* rooms_in,
                                 const int* cap_rank, const int* dead,
                                 const int* live, const uint32_t* suit,
                                 const int* room_of, int* rooms_out, int P,
                                 int E, int R, int T, int n_rounds,
                                 void* stream) {
    if (!tt_rooms_fit(E, R) || T > 64 || P <= 0 || n_rounds < 0)
        return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * (2 * (size_t)E
                                 + tt_parallel_rooms_ints(E, R, T,
                                                          K9_THREADS / 32));
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    cudaError_t err = tt_set_smem(parallel_rooms_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    parallel_rooms_kernel<<<P, K9_THREADS, smem, (cudaStream_t)stream>>>(
        slots, rooms_in, cap_rank, dead, live, suit, room_of,
        rooms_out, E, R, T, n_rounds);
    return (int)cudaGetLastError();
}
