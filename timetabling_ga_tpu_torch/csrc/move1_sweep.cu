// K3: Move1 deltas of one pivot event to every target slot.
//
// Replaces timetabling_ga_tpu/ops/sweep.py:78 `_move1_sweep`, which XLA
// runs vmapped over (individual, pivot): a (T, R) room-key argmin, a
// segment sum of the pivot's conflict row over slots, and per-target
// add deltas contracted over students from neighbour masks.
//
// Bound on this card: latency. One (individual, pivot) reads the pivot's
// conflict row (ceil(E/32) words) against each slot's event bits, one
// (T, R) occupancy grid and one attended-slot word and one attendance
// count per student of its own; it writes 3*T int32.
//
// Design: one CTA per (individual, pivot), one thread per target slot
// for the room choice and the final combine. The room key stays in
// lockstep with rooms.py `_room_key` (sweep.py:102 says so): occupancy
// minus the pivot's own cell, plus the unsuitable flag, times 2^13, plus
// the suitability tie, capacity rank and dead-room penalty; argmin takes
// the first room. The correlation delta counts the conflict row's
// events in each slot as popcounts against that slot's events (slot_ev,
// (T, W) u32 per individual). The scv delta re-scores the pivot's old
// day and adds the per-target window terms of the binarized post-removal
// attendance of the pivot's students, one 64-bit mask per student in
// shared memory, taken from the student's attended-slot word (amask,
// (S,) u64 per individual) with the old slot's bit recomputed. The
// wrapper builds both bitsets with their plain version (ops/delta.py
// slot_bitsets); K5 keeps them in shared memory. A padded pivot's deltas
// are forced to 0. The body lives in sweep_dev.cuh (tt_move1_prepare /
// tt_move1_target), shared with K5.
#include "sweep_dev.cuh"

#define K3_THREADS 64

__global__ void move1_sweep_kernel(
    TTSweepProblem pb, const int* __restrict__ slots,
    const int* __restrict__ rooms, const int16_t* __restrict__ att,
    const int16_t* __restrict__ occ, const uint64_t* __restrict__ amask,
    const uint32_t* __restrict__ slot_ev, const int* __restrict__ pivots,
    int* __restrict__ d_hcv, int* __restrict__ d_scv,
    int* __restrict__ new_rooms, int B) {
    extern __shared__ int smem[];
    const int E = pb.E, R = pb.R, S = pb.S, T = pb.T, W = pb.W;
    int* per_slot = smem;                               // (T,)
    int* rm_acc = per_slot + T;                         // (1,)
    // 8-byte aligned after the int section (T + 2 rounded up to even)
    uint64_t* masks = (uint64_t*)(smem + ((T + 3) & ~1));  // (students of e,)
    int cand = blockIdx.x;                              // p * B + b
    int p = cand / B;
    int e = pivots[cand];
    const int* s_p = slots + (size_t)p * E;
    const int* r_p = rooms + (size_t)p * E;
    const int16_t* occ_p = occ + (size_t)p * T * R;
    const int16_t* att_p = att + (size_t)p * S * T;
    tt_move1_prepare(pb, s_p, att_p, amask + (size_t)p * S,
                     slot_ev + (size_t)p * T * W, e, per_slot, rm_acc,
                     masks);
    int t = threadIdx.x;
    if (t >= T) return;
    size_t o = (size_t)cand * T + t;
    tt_move1_target(pb, s_p, r_p, occ_p, e, t, per_slot, masks, rm_acc[0],
                    &d_hcv[o], &d_scv[o], &new_rooms[o]);
}

extern "C" int tt_move1_sweep(
    const int* slots, const int* rooms, const int16_t* att,
    const int16_t* occ, const uint64_t* amask, const uint32_t* slot_ev,
    const int* pivots, const uint8_t* possible,
    const int* live, const int* student_count, const uint32_t* conflict_bits,
    const int* cap_rank, const int* dead, const int* ev_ptr,
    const int* ev_stu, int* d_hcv, int* d_scv, int* new_rooms, int P, int B,
    int E, int R, int S, int T, int spd, int W, int max_students,
    void* stream) {
    if (T > K3_THREADS || spd > 32 || P * B <= 0)
        return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * (size_t)((T + 3) & ~1)
                  + sizeof(uint64_t) * (size_t)(max_students > 0 ? max_students : 1);
    cudaError_t err = tt_set_smem(move1_sweep_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    TTSweepProblem pb = {possible, live, student_count, conflict_bits,
                         cap_rank, dead, nullptr, ev_ptr, ev_stu,
                         E, R, S, T, spd, W};
    move1_sweep_kernel<<<P * B, K3_THREADS, smem, (cudaStream_t)stream>>>(
        pb, slots, rooms, att, occ, amask, slot_ev, pivots, d_hcv, d_scv,
        new_rooms, B);
    return (int)cudaGetLastError();
}
