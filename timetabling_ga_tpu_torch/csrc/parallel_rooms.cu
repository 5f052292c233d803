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
// event. Where the rank rows or the suitability words do not fit (the
// wrapper's stage mask, decided from the sizes: the rows are staged
// first, as the bids read them most), the GLOB instance reads the words
// from the problem's and keeps the rows in a global scratch row a block,
// its `grid` blocks striding over the individuals.
#include "rooms_dev.cuh"

#ifndef K9_THREADS
#define K9_THREADS 512
#endif
// bits of the stage mask (kernels.stage_regions): the warps' rank rows
// staged, the suitability words staged
#define K9_ROWS 1
#define K9_SUIT 2

// the matching of individual p on the block (it syncs after)
template <bool GLOB>
__device__ __forceinline__ void k9_row(
    const TTRoomProblem& rp, const TTRankRooms& rr, const int* slots,
    const int* rooms_in, int* rooms_out, int* sl, int n_rounds, int p,
    bool su_glob, int* rows_g) {
    const int E = rp.E;
    int* rm = sl + E;
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        sl[e] = slots[(size_t)p * E + e];
        rm[e] = rooms_in ? rooms_in[(size_t)p * E + e]
                         : tt_best_fit_room(rr, e);
    }
    __syncthreads();
    TT_PROF(0);
    if (GLOB)
        tt_parallel_rooms_block(rp, rr, sl, rm, rm + E, n_rounds, nullptr,
                                su_glob, rows_g);
    else
        tt_parallel_rooms_block(rp, rr, sl, rm, rm + E, n_rounds, nullptr);
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x)
        rooms_out[(size_t)p * E + e] = rm[e];
    TT_PROF(4);
}

template <bool GLOB>
__global__ void __launch_bounds__(K9_THREADS) parallel_rooms_kernel(
    const int* __restrict__ slots, const int* __restrict__ rooms_in,
    const int* __restrict__ cap_rank, const int* __restrict__ dead,
    const int* __restrict__ live,
    const uint32_t* __restrict__ suit, const int* __restrict__ room_of,
    int* __restrict__ rooms_out, int* __restrict__ scratch, int P, int E,
    int R, int T, int n_rounds, int stage) {
    extern __shared__ int k9_smem[];
    TT_PROF_START();
    // the matcher reads the rooms' suitability as suit words only
    const TTRoomProblem rp = {nullptr, cap_rank, dead, live, E, R, T};
    const TTRankRooms rr = {suit, room_of, (R + 31) / 32};
    if (!GLOB) {
        k9_row<false>(rp, rr, slots, rooms_in, rooms_out, k9_smem,
                      n_rounds, blockIdx.x, false, nullptr);
        return;
    }
    // the block's rank rows, in its scratch row where they are not staged
    int* rows_g = (stage & K9_ROWS)
                      ? nullptr
                      : scratch + (size_t)blockIdx.x * tt_rank_row_ints(R)
                                      * (K9_THREADS / 32);
    for (int p = blockIdx.x; p < P; p += gridDim.x)
        k9_row<true>(rp, rr, slots, rooms_in, rooms_out, k9_smem, n_rounds,
                     p, !(stage & K9_SUIT), rows_g);
}

extern "C" int tt_parallel_rooms(const int* slots, const int* rooms_in,
                                 const int* cap_rank, const int* dead,
                                 const int* live, const uint32_t* suit,
                                 const int* room_of, int* rooms_out,
                                 int* scratch, int P, int E, int R, int T,
                                 int n_rounds, int stage, int grid,
                                 void* stream) {
    const bool glob = (stage & (K9_ROWS | K9_SUIT)) != (K9_ROWS | K9_SUIT);
    if (!tt_rooms_fit(E, R) || T > 64 || P <= 0 || n_rounds < 0
        || (glob && grid <= 0) || (!(stage & K9_ROWS) && !scratch))
        return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * (2 * (size_t)E
                                 + tt_parallel_rooms_ints(
                                     E, R, T, K9_THREADS / 32,
                                     stage & K9_SUIT, stage & K9_ROWS));
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    const auto kernel = glob ? parallel_rooms_kernel<true>
                             : parallel_rooms_kernel<false>;
    cudaError_t err = tt_set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<glob ? grid : P, K9_THREADS, smem, (cudaStream_t)stream>>>(
        slots, rooms_in, cap_rank, dead, live, suit, room_of, rooms_out,
        scratch, P, E, R, T, n_rounds, stage);
    return (int)cudaGetLastError();
}
