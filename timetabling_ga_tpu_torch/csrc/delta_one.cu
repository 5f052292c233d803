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
// rebuilds that student's day bits before and after the patch.
#include "common.cuh"

#define K4_WARPS 4

__global__ void delta_one_kernel(
    const int* __restrict__ slots, const int* __restrict__ rooms,
    const int16_t* __restrict__ att, const int16_t* __restrict__ occ,
    const int* __restrict__ evs, const int* __restrict__ new_slots,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ possible,
    const int* __restrict__ live, const int* __restrict__ student_count,
    const uint32_t* __restrict__ conflict_bits,
    const int* __restrict__ cap_rank, const int* __restrict__ dead,
    const uint8_t* __restrict__ attends, const int* __restrict__ ev_ptr,
    const int* __restrict__ ev_stu, int* __restrict__ d_hcv,
    int* __restrict__ d_scv, int* __restrict__ new_rooms, int PC, int C,
    int E, int R, int S, int T, int spd, int W) {
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int cand = blockIdx.x * K4_WARPS + warp;
    if (cand >= PC) return;
    int p = cand / C;
    const int* s_p = slots + (size_t)p * E;
    const int* r_p = rooms + (size_t)p * E;
    const int16_t* occ_p = occ + (size_t)p * T * R;
    const int16_t* att_p = att + (size_t)p * S * T;

    int ev[3], ns[3], os[3], orr[3], act[3], on[3], nr[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        ev[m] = evs[(size_t)cand * 3 + m];
        ns[m] = new_slots[(size_t)cand * 3 + m];
        on[m] = active[(size_t)cand * 3 + m] ? 1 : 0;
        os[m] = s_p[ev[m]];
        orr[m] = r_p[ev[m]];
        act[m] = on[m] * live[ev[m]];
    }

    // ---- occupancy replay: removes, then re-roomed adds, in order
    int dt[6], dr[6], dv[6];
    int pair_d = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) { dt[k] = -1; dr[k] = -1; dv[k] = 0; }
    auto cell = [&](int t, int r) {
        int v = occ_p[t * R + r];
#pragma unroll
        for (int k = 0; k < 6; ++k)
            if (dt[k] == t && dr[k] == r) v += dv[k];
        return v;
    };
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        pair_d -= act[m] * (cell(os[m], orr[m]) - 1);
        dt[m] = os[m]; dr[m] = orr[m]; dv[m] = -act[m];
    }
    int cr = lane < R ? cap_rank[lane] : 0;
    int dd = lane < R ? dead[lane] : 0;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        int key = 0x7fffffff;
        if (lane < R) {
            int unsuit = possible[ev[m] * R + lane] ? 0 : 1;
            key = (cell(ns[m], lane) + unsuit) * TT_W_COST
                  + unsuit * TT_W_UNSUIT + cr + dd;
        }
        int rc = tt_warp_argmin(key, lane);
        nr[m] = on[m] ? rc : orr[m];
        pair_d += act[m] * cell(ns[m], nr[m]);
        dt[3 + m] = ns[m]; dr[3 + m] = nr[m]; dv[3 + m] = act[m];
    }

    // ---- unsuitable, last-slot and within-move correlation terms
    int unsuit_d = 0, last_d = 0, corr = 0;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        unsuit_d += (possible[ev[m] * R + nr[m]] ? 0 : 1)
                    - (possible[ev[m] * R + orr[m]] ? 0 : 1);
        int sc = student_count[ev[m]];
        last_d += (ns[m] % spd == spd - 1 ? sc : 0)
                  - (os[m] % spd == spd - 1 ? sc : 0);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int mm = m + 1; mm < 3; ++mm) {
            uint32_t c = (conflict_bits[(size_t)ev[m] * W + (ev[mm] >> 5)]
                          >> (ev[mm] & 31)) & 1u;
            corr += (int)c * ((ns[m] == ns[mm] ? 1 : 0)
                              - (os[m] == os[mm] ? 1 : 0));
        }

    // ---- moved x unmoved correlation: conflict rows over slot equality
    int corr_l = 0;
    for (int w = lane; w < W; w += 32) {
        uint32_t moved = 0u;
#pragma unroll
        for (int m = 0; m < 3; ++m)
            if ((ev[m] >> 5) == w) moved |= 1u << (ev[m] & 31);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            uint32_t bits = conflict_bits[(size_t)ev[m] * W + w] & ~moved;
            while (bits) {
                int f = w * 32 + __ffs(bits) - 1;
                bits &= bits - 1;
                int sf = s_p[f];
                corr_l += (sf == ns[m] ? 1 : 0) - (sf == os[m] ? 1 : 0);
            }
        }
    }
    corr += tt_warp_sum(corr_l);

    // ---- affected days (<= 6, deduplicated), re-scored per student
    int days[6];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        days[m] = os[m] / spd;
        days[3 + m] = ns[m] / spd;
    }
    int scv_l = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        int d = days[i];
        bool unique = true;
#pragma unroll
        for (int k = 0; k < i; ++k)
            if (days[k] == d) unique = false;
        if (!unique) continue;
        for (int m = 0; m < 3; ++m) {
            int k0 = ev_ptr[ev[m]], nst = ev_ptr[ev[m] + 1] - k0;
            for (int k = lane; k < nst; k += 32) {
                int s = ev_stu[k0 + k];
                const uint8_t* a_s = attends + (size_t)s * E;
                bool seen = false;
                for (int q = 0; q < m; ++q)
                    if (a_s[ev[q]]) seen = true;
                if (seen) continue;
                int col[3];
#pragma unroll
                for (int q = 0; q < 3; ++q) col[q] = a_s[ev[q]];
                uint32_t before = 0u, after = 0u;
                for (int j = 0; j < spd; ++j) {
                    int t = d * spd + j;
                    int v = att_p[(size_t)s * T + t];
                    int w = v;
#pragma unroll
                    for (int q = 0; q < 3; ++q)
                        w += col[q] * ((ns[q] == t ? 1 : 0)
                                       - (os[q] == t ? 1 : 0));
                    if (v > 0) before |= 1u << j;
                    if (w > 0) after |= 1u << j;
                }
                scv_l += tt_day_scv(after) - tt_day_scv(before);
            }
        }
    }
    int scv_days = tt_warp_sum(scv_l);

    if (lane == 0) {
        d_hcv[cand] = pair_d + unsuit_d + corr;
        d_scv[cand] = last_d + scv_days;
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
    delta_one_kernel<<<grid, 32 * K4_WARPS, 0, (cudaStream_t)stream>>>(
        slots, rooms, att, occ, evs, new_slots, active, possible, live,
        student_count, conflict_bits, cap_rank, dead, attends, ev_ptr,
        ev_stu, d_hcv, d_scv, new_rooms, PC, C, E, R, S, T, spd, W);
    return (int)cudaGetLastError();
}
