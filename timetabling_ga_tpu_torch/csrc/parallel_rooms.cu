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
// ~3 KB at E=400) nor operations (each round ~4 E R key compares); its
// time is the chain of ~40 dependent warp phases.
//
// Design: one warp per individual, as K1 and K6, with the body in
// rooms_dev.cuh (`tt_parallel_rooms_warp`), which K6 runs on each
// crossover child; this entry runs it on whole rows, for the unit checks
// and for batch calls. The warp keeps the slots, the rooms, three
// per-event arrays and three (T, R+1) grids in shared memory
// (~15.8 KB at comp01s). Without incoming rooms the start is
// parallel_assign_rooms's best-fit room per event.
#include "rooms_dev.cuh"

#define K9_WARPS 4

__global__ void parallel_rooms_kernel(
    const int* __restrict__ slots, const int* __restrict__ rooms_in,
    const uint8_t* __restrict__ possible, const int* __restrict__ cap_rank,
    const int* __restrict__ dead, const int* __restrict__ live,
    int* __restrict__ rooms_out, int P, int E, int R, int T, int n_rounds) {
    extern __shared__ int k9_smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = blockIdx.x * K9_WARPS + warp;
    if (c >= P) return;
    const int per_warp = 2 * E + tt_parallel_rooms_ints(E, R, T);
    int* sl = k9_smem + warp * per_warp;
    int* rm = sl + E;
    const TTRoomProblem rp = {possible, cap_rank, dead, live, E, R, T};
    for (int e = lane; e < E; e += 32) {
        sl[e] = slots[(size_t)c * E + e];
        rm[e] = rooms_in ? rooms_in[(size_t)c * E + e]
                         : tt_best_fit_room(rp, e);
    }
    __syncwarp();
    tt_parallel_rooms_warp(rp, sl, rm, rm + E, n_rounds, lane);
    for (int e = lane; e < E; e += 32) rooms_out[(size_t)c * E + e] = rm[e];
}

extern "C" int tt_parallel_rooms(const int* slots, const int* rooms_in,
                                 const uint8_t* possible,
                                 const int* cap_rank, const int* dead,
                                 const int* live, int* rooms_out, int P,
                                 int E, int R, int T, int n_rounds,
                                 void* stream) {
    if (R > 32 || P <= 0 || E <= 0 || n_rounds < 0)
        return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * K9_WARPS
                  * (2 * (size_t)E + tt_parallel_rooms_ints(E, R, T));
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    cudaError_t err = tt_set_smem(parallel_rooms_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    int grid = (P + K9_WARPS - 1) / K9_WARPS;
    parallel_rooms_kernel<<<grid, 32 * K9_WARPS, smem,
                            (cudaStream_t)stream>>>(
        slots, rooms_in, possible, cap_rank, dead, live, rooms_out, P, E, R,
        T, n_rounds);
    return (int)cudaGetLastError();
}
