// K4: delta of a padded 3-relocation candidate on one individual.
//
// Replaces timetabling_ga_tpu/ops/delta.py:90 `_delta_one`, which XLA
// runs vmapped over (individual, candidate): a replay of <= 6 occupancy
// cells with greedy re-rooming, the unsuitable delta, three conflict-row
// dots over slot equalities plus a 3x3 within-move correction, the
// last-slot term and a re-score of <= 6 deduplicated days from (S, spd)
// attendance patches.
//
// Bound on this card: latency. A candidate reads <= 3 conflict rows
// (ceil(E/32) words each) against two slot rows of the individual's
// slot_ev bitset, <= 3 occupancy rows and the amask words and touched
// attendance counts of its events' students; it writes five int32.
//
// Design: one warp per candidate, running the body K5, K8 and K10 run
// (sweep_dev.cuh tt_delta_one_bits_warp): the occupancy replay with the
// <= 6 touched cells kept as a delta list in registers and the room
// argmin over each lane's rooms, then the warp's (ties to the lower
// room); the conflict dots as popcounts of each moving event's row
// against the slot_ev rows of its new and old slot, the lanes over
// words; the day re-score one lane
// per student of the moving events (each student once), from its amask
// word with the touched slots recomputed. The wrapper builds amask and
// slot_ev with their plain version (ops/delta.py slot_bitsets); this
// launch is the unit check of the body the others keep in shared memory.
#include "sweep_dev.cuh"

#define K4_WARPS 4

template <bool WIDE>
__global__ void delta_one_kernel(
    TTSweepProblem pb, const int* __restrict__ slots,
    const int* __restrict__ rooms, const int16_t* __restrict__ att,
    const int16_t* __restrict__ occ, const uint64_t* __restrict__ amask,
    const uint32_t* __restrict__ slot_ev, const int* __restrict__ evs,
    const int* __restrict__ new_slots, const uint8_t* __restrict__ active,
    int* __restrict__ d_hcv, int* __restrict__ d_scv,
    int* __restrict__ new_rooms, int PC, int C) {
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int cand = blockIdx.x * K4_WARPS + warp;
    if (cand >= PC) return;
    const int E = pb.E, R = pb.R, S = pb.S, T = pb.T, W = pb.W;
    int p = cand / C;
    int ev[3], ns[3], on[3], nr[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        ev[m] = evs[(size_t)cand * 3 + m];
        ns[m] = new_slots[(size_t)cand * 3 + m];
        on[m] = active[(size_t)cand * 3 + m] ? 1 : 0;
    }
    int dh, ds;
    tt_delta_one_bits_warp<WIDE>(
        pb, slots + (size_t)p * E, rooms + (size_t)p * E,
        att + (size_t)p * S * T, occ + (size_t)p * T * R,
        amask + (size_t)p * S, slot_ev + (size_t)p * T * W, ev, ns, on,
        lane, &dh, &ds, nr);
    if (lane == 0) {
        d_hcv[cand] = dh;
        d_scv[cand] = ds;
#pragma unroll
        for (int m = 0; m < 3; ++m) new_rooms[(size_t)cand * 3 + m] = nr[m];
    }
}

extern "C" int tt_delta_one(
    const int* slots, const int* rooms, const int16_t* att,
    const int16_t* occ, const uint64_t* amask, const uint32_t* slot_ev,
    const int* evs, const int* new_slots, const uint8_t* active,
    const uint8_t* possible, const int* live, const int* student_count,
    const uint32_t* conflict_bits, const int* cap_rank, const int* dead,
    const uint8_t* attends, const int* ev_ptr, const int* ev_stu,
    int* d_hcv, int* d_scv, int* new_rooms, int P, int C, int E, int R,
    int S, int T, int spd, int W, void* stream) {
    if (!tt_rooms_fit(E, R) || spd > 32 || T > 64 || P * C <= 0)
        return (int)cudaErrorInvalidValue;
    int PC = P * C;
    int grid = (PC + K4_WARPS - 1) / K4_WARPS;
    TTSweepProblem pb = {possible, live, student_count, conflict_bits,
                         cap_rank, dead, attends, ev_ptr, ev_stu,
                         E, R, S, T, spd, W};
    const auto kernel = tt_wide_rooms(R) ? delta_one_kernel<true>
                               : delta_one_kernel<false>;
    kernel<<<grid, 32 * K4_WARPS, 0, (cudaStream_t)stream>>>(
        pb, slots, rooms, att, occ, amask, slot_ev, evs, new_slots, active,
        d_hcv, d_scv, new_rooms, PC, C);
    return (int)cudaGetLastError();
}
