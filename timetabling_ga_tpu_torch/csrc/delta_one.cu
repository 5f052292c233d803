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
// (ceil(E/32) words each), the slots of the conflicting events, <= 3
// occupancy rows and the day rows of its events' students; it writes
// five int32.
//
// Design: one warp per candidate. The occupancy replay is sequential
// and in order — all removes, then the adds for m = 0, 1, 2, each
// re-rooming on the row as updated so far — with the <= 6 touched cells
// kept as a delta list in registers; the room argmin is one lane per
// room with a shuffle reduction (ties to the lower room). The conflict
// dots walk the set bits of each row (moved events masked out) with the
// lanes over words. The day re-score walks the union of the moved
// events' students (each student once: it is skipped under event m when
// it also attends an earlier moved event), one lane per student, and
// rebuilds that student's day bits before and after the patch. The body
// lives in sweep_dev.cuh (tt_delta_one_warp), shared with K5.
#include "sweep_dev.cuh"

#define K4_WARPS 4

__global__ void delta_one_kernel(
    TTSweepProblem pb, const int* __restrict__ slots,
    const int* __restrict__ rooms, const int16_t* __restrict__ att,
    const int16_t* __restrict__ occ, const int* __restrict__ evs,
    const int* __restrict__ new_slots, const uint8_t* __restrict__ active,
    int* __restrict__ d_hcv, int* __restrict__ d_scv,
    int* __restrict__ new_rooms, int PC, int C) {
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int cand = blockIdx.x * K4_WARPS + warp;
    if (cand >= PC) return;
    const int E = pb.E, R = pb.R, S = pb.S, T = pb.T;
    int p = cand / C;
    int ev[3], ns[3], on[3], nr[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        ev[m] = evs[(size_t)cand * 3 + m];
        ns[m] = new_slots[(size_t)cand * 3 + m];
        on[m] = active[(size_t)cand * 3 + m] ? 1 : 0;
    }
    int dh, ds;
    tt_delta_one_warp(pb, slots + (size_t)p * E, rooms + (size_t)p * E,
                      att + (size_t)p * S * T, occ + (size_t)p * T * R, ev,
                      ns, on, lane, &dh, &ds, nr);
    if (lane == 0) {
        d_hcv[cand] = dh;
        d_scv[cand] = ds;
#pragma unroll
        for (int m = 0; m < 3; ++m) new_rooms[(size_t)cand * 3 + m] = nr[m];
    }
}

extern "C" int tt_delta_one(
    const int* slots, const int* rooms, const int16_t* att,
    const int16_t* occ, const int* evs, const int* new_slots,
    const uint8_t* active, const uint8_t* possible, const int* live,
    const int* student_count, const uint32_t* conflict_bits,
    const int* cap_rank, const int* dead, const uint8_t* attends,
    const int* ev_ptr, const int* ev_stu, int* d_hcv, int* d_scv,
    int* new_rooms, int P, int C, int E, int R, int S, int T, int spd,
    int W, void* stream) {
    if (R > 32 || spd > 32 || P * C <= 0) return (int)cudaErrorInvalidValue;
    int PC = P * C;
    int grid = (PC + K4_WARPS - 1) / K4_WARPS;
    TTSweepProblem pb = {possible, live, student_count, conflict_bits,
                         cap_rank, dead, attends, ev_ptr, ev_stu,
                         E, R, S, T, spd, W};
    delta_one_kernel<<<grid, 32 * K4_WARPS, 0, (cudaStream_t)stream>>>(
        pb, slots, rooms, att, occ, evs, new_slots, active, d_hcv, d_scv,
        new_rooms, PC, C);
    return (int)cudaGetLastError();
}
