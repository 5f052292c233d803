// K3: Move1 deltas of one pivot event to every target slot.
//
// Replaces timetabling_ga_tpu/ops/sweep.py:78 `_move1_sweep`, which XLA
// runs vmapped over (individual, pivot): a (T, R) room-key argmin, a
// segment sum of the pivot's conflict row over slots, and per-target
// add deltas contracted over students from neighbour masks.
//
// Bound on this card: latency. One (individual, pivot) reads the pivot's
// conflict row (ceil(E/32) words), the slots of its conflicting events,
// one (T, R) occupancy grid and the attendance rows of its own students
// (T int16 each); it writes 3*T int32.
//
// Design: one CTA per (individual, pivot), one thread per target slot
// for the room choice and the final combine. The room key stays in
// lockstep with rooms.py `_room_key` (sweep.py:102 says so): occupancy
// minus the pivot's own cell, plus the unsuitable flag, times 2^13, plus
// the suitability tie, capacity rank and dead-room penalty; argmin takes
// the first room. The correlation delta is a shared-memory histogram of
// the conflict row by slot. The scv delta re-scores the pivot's old day
// and adds the per-target window terms of the binarized post-removal
// attendance of the pivot's students, one 64-bit mask per student in
// shared memory. A padded pivot's deltas are forced to 0.
#include "common.cuh"

#define K3_THREADS 64

__global__ void move1_sweep_kernel(
    const int* __restrict__ slots, const int* __restrict__ rooms,
    const int16_t* __restrict__ att, const int16_t* __restrict__ occ,
    const int* __restrict__ pivots, const uint8_t* __restrict__ possible,
    const int* __restrict__ live, const int* __restrict__ student_count,
    const uint32_t* __restrict__ conflict_bits,
    const int* __restrict__ cap_rank, const int* __restrict__ dead,
    const int* __restrict__ ev_ptr, const int* __restrict__ ev_stu,
    int* __restrict__ d_hcv, int* __restrict__ d_scv,
    int* __restrict__ new_rooms, int B, int E, int R, int S, int T, int spd,
    int W) {
    extern __shared__ int smem[];
    int* per_slot = smem;                               // (T,)
    int* rm_acc = per_slot + T;                         // (1,)
    // 8-byte aligned after the int section (T + 2 rounded up to even)
    uint64_t* masks = (uint64_t*)(smem + ((T + 3) & ~1));  // (students of e,)
    int cand = blockIdx.x;                              // p * B + b
    int p = cand / B;
    int e = pivots[cand];
    const int* s_p = slots + (size_t)p * E;
    const int16_t* occ_p = occ + (size_t)p * T * R;
    const int16_t* att_p = att + (size_t)p * S * T;
    int s_old = s_p[e];
    int r_old = rooms[(size_t)p * E + e];
    int lv = live[e];
    int D0 = s_old / spd;
    for (int t = threadIdx.x; t < T; t += blockDim.x) per_slot[t] = 0;
    if (threadIdx.x == 0) rm_acc[0] = 0;
    __syncthreads();

    // correlation: conflicting events (pivot excluded) per slot
    const uint32_t* row = conflict_bits + (size_t)e * W;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
        uint32_t bits = row[w];
        if (w == (e >> 5)) bits &= ~(1u << (e & 31));
        while (bits) {
            int f = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            atomicAdd(&per_slot[s_p[f]], 1);
        }
    }
    // the pivot's students: post-removal masks + the old day's re-score
    int k0 = ev_ptr[e], nst = ev_ptr[e + 1] - k0;
    int rm = 0;
    for (int i = threadIdx.x; i < nst; i += blockDim.x) {
        int s = ev_stu[k0 + i];
        const int16_t* a = att_p + (size_t)s * T;
        uint64_t before = 0ull, after = 0ull;
        for (int t = 0; t < T; ++t) {
            int v = a[t];
            if (v > 0) before |= 1ull << t;
            if (v - (t == s_old ? 1 : 0) > 0) after |= 1ull << t;
        }
        masks[i] = after;
        rm += tt_day_scv(tt_day_bits(after, D0, spd))
              - tt_day_scv(tt_day_bits(before, D0, spd));
    }
    if (rm) atomicAdd(rm_acc, rm);
    __syncthreads();

    int t = threadIdx.x;
    if (t >= T) return;
    // room choice in target slot t on occupancy minus the pivot's cell
    int best_key = 0x7fffffff, best_r = 0;
    for (int r = 0; r < R; ++r) {
        int o = occ_p[t * R + r] - ((t == s_old && r == r_old) ? lv : 0);
        int unsuit = possible[e * R + r] ? 0 : 1;
        int key = (o + unsuit) * TT_W_COST + unsuit * TT_W_UNSUIT
                  + cap_rank[r] + dead[r];
        if (key < best_key) {
            best_key = key;
            best_r = r;
        }
    }
    int add_d = occ_p[t * R + best_r]
                - ((t == s_old && best_r == r_old) ? lv : 0);
    int remove_d = -(occ_p[s_old * R + r_old] - 1);
    int unsuit_d = (possible[e * R + best_r] ? 0 : 1)
                   - (possible[e * R + r_old] ? 0 : 1);
    int corr_d = per_slot[t] - per_slot[s_old];
    int dh = remove_d + add_d + unsuit_d + corr_d;

    int sc = student_count[e];
    int last_d = (t % spd == spd - 1 ? sc : 0)
                 - (s_old % spd == spd - 1 ? sc : 0);
    // adding the pivot at t: new runs of 3 through t and the day-count
    // single shift, for every student of the pivot with t free
    int d = t / spd, j = t % spd, add = 0;
    for (int i = 0; i < nst; ++i) {
        uint32_t b = tt_day_bits(masks[i], d, spd);
        if ((b >> j) & 1u) continue;
        int l1 = j >= 1 ? (b >> (j - 1)) & 1u : 0;
        int l2 = j >= 2 ? (b >> (j - 2)) & 1u : 0;
        int r1 = j + 1 < spd ? (b >> (j + 1)) & 1u : 0;
        int r2 = j + 2 < spd ? (b >> (j + 2)) & 1u : 0;
        int cnt = __popc(b);
        add += (l2 & l1) + (l1 & r1) + (r1 & r2)
               + (cnt == 0 ? 1 : 0) - (cnt == 1 ? 1 : 0);
    }
    int ds = last_d + rm_acc[0] + add;
    size_t o = (size_t)cand * T + t;
    d_hcv[o] = dh * lv;
    d_scv[o] = ds * lv;
    new_rooms[o] = best_r;
}

extern "C" int tt_move1_sweep(
    const int* slots, const int* rooms, const int16_t* att,
    const int16_t* occ, const int* pivots, const uint8_t* possible,
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
    move1_sweep_kernel<<<P * B, K3_THREADS, smem, (cudaStream_t)stream>>>(
        slots, rooms, att, occ, pivots, possible, live, student_count,
        conflict_bits, cap_rank, dead, ev_ptr, ev_stu, d_hcv, d_scv,
        new_rooms, B, E, R, S, T, spd, W);
    return (int)cudaGetLastError();
}
