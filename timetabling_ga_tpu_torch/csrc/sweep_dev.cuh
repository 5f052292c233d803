// Device bodies of the sweep's delta evaluators, shared by K3
// (move1_sweep.cu), K4 (delta_one.cu) and K5 (sweep_pass.cu), and the
// random-candidate scoring and apply that K8 (random_ls.cu) and K10
// (lahc.cu) share.
//
// Every function takes the individual's state through generic pointers
// (slots, rooms, att, occ), so the same arithmetic reads it from global
// memory in K3/K4 and from shared memory in K5; the K3/K4 kernel-vs-plain
// checks therefore guard what K5 computes. The problem-wide arrays come
// in one TTSweepProblem, read from global memory (the conflict bitset
// may point at a shared-memory copy).
#pragma once

#include "common.cuh"

// Phase counters of K5, compiled in only with -DTT_K5_PROF (see
// timetabling_ga_tpu_torch/k5_phases.py): block 0's thread 0 adds the
// clock64() cycles since its previous mark to counter k, so the counters
// partition that thread's time in the pass. Otherwise the marks are
// empty statements.
#ifdef TT_K5_PROF
__device__ unsigned long long tt_prof_acc[16];
__device__ long long tt_prof_last;
#define TT_PROF_START()                                                \
    do {                                                               \
        if (blockIdx.x == 0 && threadIdx.x == 0)                       \
            tt_prof_last = clock64();                                  \
    } while (0)
#define TT_PROF(k)                                                     \
    do {                                                               \
        if (blockIdx.x == 0 && threadIdx.x == 0) {                     \
            long long now_ = clock64();                                \
            tt_prof_acc[k] += now_ - tt_prof_last;                     \
            tt_prof_last = now_;                                       \
        }                                                              \
    } while (0)
// copy the counters out and zero them
extern "C" int tt_prof_take(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, tt_prof_acc,
                                           sizeof(tt_prof_acc));
    if (err != cudaSuccess) return (int)err;
    unsigned long long zero[16] = {0};
    return (int)cudaMemcpyToSymbol(tt_prof_acc, zero, sizeof(zero));
}
#else
#define TT_PROF_START() do {} while (0)
#define TT_PROF(k) do {} while (0)
#endif

struct TTSweepProblem {
    const uint8_t* possible;       // (E, R)
    const int* live;               // (E,)
    const int* student_count;      // (E,)
    const uint32_t* conflict_bits; // (E, W)
    const int* cap_rank;           // (R,)
    const int* dead;               // (R,)
    const uint8_t* attends;        // (S, E)
    const int* ev_ptr;             // (E+1,)
    const int* ev_stu;             // (nnz,)
    int E, R, S, T, spd, W;
};

// K3's body, phase 1, run by every thread of the block (it syncs twice):
// the conflict row of pivot `e` (pivot excluded) as a per-slot
// histogram, the post-removal slot masks of e's students (one 64-bit
// mask each) and the re-score of e's old day summed into *rm_acc.
__device__ __forceinline__ void tt_move1_prepare(
    const TTSweepProblem& pb, const int* slots, const int16_t* att, int e,
    int* per_slot, int* rm_acc, uint64_t* masks) {
    const int T = pb.T, spd = pb.spd, W = pb.W;
    const int s_old = slots[e];
    const int D0 = s_old / spd;
    for (int t = threadIdx.x; t < T; t += blockDim.x) per_slot[t] = 0;
    if (threadIdx.x == 0) rm_acc[0] = 0;
    __syncthreads();

    // correlation: conflicting events (pivot excluded) per slot
    const uint32_t* row = pb.conflict_bits + (size_t)e * W;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
        uint32_t bits = row[w];
        if (w == (e >> 5)) bits &= ~(1u << (e & 31));
        while (bits) {
            int f = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            atomicAdd(&per_slot[slots[f]], 1);
        }
    }
    // the pivot's students: post-removal masks + the old day's re-score
    int k0 = pb.ev_ptr[e], nst = pb.ev_ptr[e + 1] - k0;
    int rm = 0;
    for (int i = threadIdx.x; i < nst; i += blockDim.x) {
        int s = pb.ev_stu[k0 + i];
        const int16_t* a = att + (size_t)s * T;
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
}

// K3's body, phase 2: the Move1 delta of pivot `e` to target slot `t`,
// from what tt_move1_prepare left (`rm` = *rm_acc). The room key stays
// in lockstep with rooms.py `_room_key` (sweep.py:102): occupancy minus
// the pivot's own cell, plus the unsuitable flag, times 2^13, plus the
// suitability tie, capacity rank and dead-room penalty; the argmin takes
// the first room. A padded pivot's deltas are forced to 0.
__device__ __forceinline__ void tt_move1_target(
    const TTSweepProblem& pb, const int* slots, const int* rooms,
    const int16_t* occ, int e, int t, const int* per_slot,
    const uint64_t* masks, int rm, int* d_hcv, int* d_scv, int* new_room) {
    const int R = pb.R, spd = pb.spd;
    const int s_old = slots[e], r_old = rooms[e];
    const int lv = pb.live[e];
    // room choice in target slot t on occupancy minus the pivot's cell
    int best_key = 0x7fffffff, best_r = 0;
    for (int r = 0; r < R; ++r) {
        int o = occ[t * R + r] - ((t == s_old && r == r_old) ? lv : 0);
        int unsuit = pb.possible[e * R + r] ? 0 : 1;
        int key = (o + unsuit) * TT_W_COST + unsuit * TT_W_UNSUIT
                  + pb.cap_rank[r] + pb.dead[r];
        if (key < best_key) {
            best_key = key;
            best_r = r;
        }
    }
    int add_d = occ[t * R + best_r]
                - ((t == s_old && best_r == r_old) ? lv : 0);
    int remove_d = -(occ[s_old * R + r_old] - 1);
    int unsuit_d = (pb.possible[e * R + best_r] ? 0 : 1)
                   - (pb.possible[e * R + r_old] ? 0 : 1);
    int corr_d = per_slot[t] - per_slot[s_old];
    int dh = remove_d + add_d + unsuit_d + corr_d;

    int sc = pb.student_count[e];
    int last_d = (t % spd == spd - 1 ? sc : 0)
                 - (s_old % spd == spd - 1 ? sc : 0);
    // adding the pivot at t: new runs of 3 through t and the day-count
    // single shift, for every student of the pivot with t free
    int nst = pb.ev_ptr[e + 1] - pb.ev_ptr[e];
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
    int ds = last_d + rm + add;
    *d_hcv = dh * lv;
    *d_scv = ds * lv;
    *new_room = best_r;
}

// K4's body: the delta of one padded 3-relocation candidate (events ev,
// new slots ns, active flags on), run by all 32 lanes of one warp; every
// lane returns the result. The occupancy replay is sequential and in
// order — all removes, then the adds for m = 0, 1, 2, each re-rooming on
// the row as updated so far — with the <= 6 touched cells kept as a
// delta list in registers; the room argmin is one lane per room with a
// shuffle reduction (ties to the lower room). The conflict dots walk the
// set bits of each row (moved events masked out) with the lanes over
// words. The day re-score walks the union of the students of the events
// that change slot (each student once: it is skipped under event m when
// it also attends an earlier one), one lane per student, and rebuilds
// that student's bits of every affected day before and after the patch.
__device__ __forceinline__ void tt_delta_one_warp(
    const TTSweepProblem& pb, const int* slots, const int* rooms,
    const int16_t* att, const int16_t* occ, const int ev[3],
    const int ns[3], const int on[3], int lane, int* d_hcv, int* d_scv,
    int nr[3]) {
    const int E = pb.E, R = pb.R, T = pb.T, spd = pb.spd, W = pb.W;
    int os[3], orr[3], act[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        os[m] = slots[ev[m]];
        orr[m] = rooms[ev[m]];
        act[m] = on[m] * pb.live[ev[m]];
    }

    // ---- occupancy replay: removes, then re-roomed adds, in order
    int dt[6], dr[6], dv[6];
    int pair_d = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) { dt[k] = -1; dr[k] = -1; dv[k] = 0; }
    auto cell = [&](int t, int r) {
        int v = occ[t * R + r];
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
    int cr = lane < R ? pb.cap_rank[lane] : 0;
    int dd = lane < R ? pb.dead[lane] : 0;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        int key = 0x7fffffff;
        if (lane < R) {
            int unsuit = pb.possible[ev[m] * R + lane] ? 0 : 1;
            key = (cell(ns[m], lane) + unsuit) * TT_W_COST
                  + unsuit * TT_W_UNSUIT + cr + dd;
        }
        int rc = tt_warp_argmin(key, lane);
        nr[m] = on[m] ? rc : orr[m];
        pair_d += act[m] * cell(ns[m], nr[m]);
        dt[3 + m] = ns[m]; dr[3 + m] = nr[m]; dv[3 + m] = act[m];
    }

    TT_PROF(1);
    // ---- unsuitable, last-slot and within-move correlation terms
    int unsuit_d = 0, last_d = 0, corr = 0;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        unsuit_d += (pb.possible[ev[m] * R + nr[m]] ? 0 : 1)
                    - (pb.possible[ev[m] * R + orr[m]] ? 0 : 1);
        int sc = pb.student_count[ev[m]];
        last_d += (ns[m] % spd == spd - 1 ? sc : 0)
                  - (os[m] % spd == spd - 1 ? sc : 0);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int mm = m + 1; mm < 3; ++mm) {
            uint32_t c = (pb.conflict_bits[(size_t)ev[m] * W + (ev[mm] >> 5)]
                          >> (ev[mm] & 31)) & 1u;
            corr += (int)c * ((ns[m] == ns[mm] ? 1 : 0)
                              - (os[m] == os[mm] ? 1 : 0));
        }

    // ---- moved x unmoved correlation: conflict rows over slot equality.
    // An entry that keeps its slot (ns == os: an inactive pad) adds 0
    // here and to every attendance patch below, so it is skipped.
    bool shift[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) shift[m] = ns[m] != os[m];
    int corr_l = 0;
    for (int w = lane; w < W; w += 32) {
        uint32_t moved = 0u;
#pragma unroll
        for (int m = 0; m < 3; ++m)
            if ((ev[m] >> 5) == w) moved |= 1u << (ev[m] & 31);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            if (!shift[m]) continue;
            uint32_t bits = pb.conflict_bits[(size_t)ev[m] * W + w] & ~moved;
            while (bits) {
                int f = w * 32 + __ffs(bits) - 1;
                bits &= bits - 1;
                int sf = slots[f];
                corr_l += (sf == ns[m] ? 1 : 0) - (sf == os[m] ? 1 : 0);
            }
        }
    }
    corr += tt_warp_sum(corr_l);
    TT_PROF(2);

    // ---- affected days (<= 6, deduplicated), re-scored per student:
    // each student of the slot-changing events once (skipped under event
    // m when it also attends an earlier one), all its days in turn, so
    // the student lists and attendance bytes are read once per student.
    // Only those events' days and students can change.
    int days[6];
    bool uniq[6];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        days[m] = os[m] / spd;
        days[3 + m] = ns[m] / spd;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        uniq[i] = shift[i % 3];
#pragma unroll
        for (int k = 0; k < i; ++k)
            if (shift[k % 3] && days[k] == days[i]) uniq[i] = false;
    }
    int scv_l = 0;
    for (int m = 0; m < 3; ++m) {
        if (!shift[m]) continue;
        int k0 = pb.ev_ptr[ev[m]], nst = pb.ev_ptr[ev[m] + 1] - k0;
        for (int k = lane; k < nst; k += 32) {
            int s = pb.ev_stu[k0 + k];
            const uint8_t* a_s = pb.attends + (size_t)s * E;
            int col[3];
#pragma unroll
            for (int q = 0; q < 3; ++q) col[q] = a_s[ev[q]];
            bool seen = false;
            for (int q = 0; q < m; ++q)
                if (shift[q] && col[q]) seen = true;
            if (seen) continue;
            const int16_t* att_s = att + (size_t)s * T;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                if (!uniq[i]) continue;
                int d = days[i];
                uint32_t before = 0u, after = 0u;
                for (int j = 0; j < spd; ++j) {
                    int t = d * spd + j;
                    int v = att_s[t];
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
    *d_hcv = pair_d + unsuit_d + corr;
    *d_scv = last_d + tt_warp_sum(scv_l);
    TT_PROF(3);
}

// delta.py:188 _apply_move on one individual's state in shared memory,
// run by the whole block: `mv` holds the accepted move's events (3), old
// slots (3), old rooms (3), new slots (3) and new rooms (3). Inactive
// pad entries (new == old) cancel; padded events weigh 0 in occupancy.
// K5 (sweep_pass.cu) and K8 (random_ls.cu) apply their moves with it.
__device__ __forceinline__ void tt_apply_move_block(
    const TTSweepProblem& pb, const int* mv, int* slots, int* rooms,
    int16_t* att, int16_t* occ) {
    const int E = pb.E, R = pb.R, T = pb.T;
    for (int s = threadIdx.x; s < pb.S; s += blockDim.x) {
        const uint8_t* a_s = pb.attends + (size_t)s * E;
        int16_t* row = att + (size_t)s * T;
#pragma unroll
        for (int m = 0; m < 3; ++m)
            if (a_s[mv[m]]) {
                row[mv[3 + m]] -= 1;
                row[mv[9 + m]] += 1;
            }
    }
    if (threadIdx.x == 0) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            int lv = pb.live[mv[m]];
            occ[mv[3 + m] * R + mv[6 + m]] -= lv;
            occ[mv[9 + m] * R + mv[12 + m]] += lv;
        }
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            slots[mv[m]] = mv[9 + m];
            rooms[mv[m]] = mv[12 + m];
        }
    }
}

// fitness.base_penalty: scv once feasible, else 1e6 + hcv
__device__ __forceinline__ int tt_base_penalty(int hcv, int scv) {
    return hcv == 0 ? scv : TT_INFEASIBLE_OFFSET + hcv;
}

// One random candidate of K8 and K10 (ops/delta.py:240-257, ops/lahc.py
// :255-281), run by the 32 lanes of one warp: the padded 3-relocation
// (ev, ns, on) of the individual whose (pen, hcv, scv) are st[0..2]
// scored by K4's body, then, on lane 0, 12 ints stored at `o`: the
// candidate's penalty — its base penalty plus, when anchored, the
// state's anchor residual pen - base_penalty(hcv, scv) and the move's
// anchor delta — its hcv and scv, ev[3], ns[3] and the new rooms nr[3].
__device__ __forceinline__ void tt_score_candidate_warp(
    const TTSweepProblem& pb, const int* slots, const int* rooms,
    const int16_t* att, const int16_t* occ, const int ev[3],
    const int ns[3], const int on[3], const int* st,
    const int* anchor_slots, const int* anchor_w, int anchored, int lane,
    int* o) {
    int nr[3], dh, ds;
    tt_delta_one_warp(pb, slots, rooms, att, occ, ev, ns, on, lane, &dh,
                      &ds, nr);
    if (lane != 0) return;
    const int hcv = st[1] + dh, scv = st[2] + ds;
    int pen = tt_base_penalty(hcv, scv);
    if (anchored) {
        int da = 0;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            const int anc = anchor_slots[ev[m]];
            da += anchor_w[ev[m]]
                  * ((ns[m] != anc ? 1 : 0) - (slots[ev[m]] != anc ? 1 : 0));
        }
        pen += st[0] - tt_base_penalty(st[1], st[2]) + da;
    }
    o[0] = pen;
    o[1] = hcv;
    o[2] = scv;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        o[3 + m] = ev[m];
        o[6 + m] = ns[m];
        o[9 + m] = nr[m];
    }
}

// The chosen candidate `o` (12 ints, as tt_score_candidate_warp stores
// them) as the 15-int move tt_apply_move_block takes.
__device__ __forceinline__ void tt_move_of_candidate(const int* o,
                                                     const int* slots,
                                                     const int* rooms,
                                                     int* mv) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        mv[m] = o[3 + m];
        mv[3 + m] = slots[o[3 + m]];
        mv[6 + m] = rooms[o[3 + m]];
        mv[9 + m] = o[6 + m];
        mv[12 + m] = o[9 + m];
    }
}
