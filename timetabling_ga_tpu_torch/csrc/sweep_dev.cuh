// Device bodies of the sweep's delta evaluators, shared by K3
// (move1_sweep.cu), K4 (delta_one.cu) and K5 (sweep_pass.cu), and the
// random-candidate scoring and apply that K8 (random_ls.cu) and K10
// (lahc.cu) share.
//
// Every function takes the individual's state through generic pointers
// (slots, rooms, att, occ and, for the bitset forms, amask and slot_ev),
// so the same arithmetic reads it from global memory in K3/K4 and from
// shared memory in K5, K8 and K10; the K3/K4 kernel-vs-plain checks
// therefore guard what the others compute. The problem-wide arrays come
// in one TTSweepProblem, read from global memory (the conflict bitset
// may point at a shared-memory copy).
//
// Two bitsets summarise an individual's state (ops/delta.py
// `slot_bitsets` is their plain version):
//   amask   (S,) u64     bit t of student s set iff att[s, t] > 0
//   slot_ev (T, W) u32   bit f of row t set iff slots[f] == t
// K5, K8 and K10 build them in their prologue (tt_build_bitsets_block)
// and keep them up to date in their apply (tt_apply_move_bits_block);
// the K4 body (tt_delta_one_bits_warp, also K4's own launch, whose
// wrapper builds the bitsets) reads a student's days from one word and
// counts a conflict row's events in a slot with popcounts.
#pragma once

#include "common.cuh"

// Bits of the stage mask of an individual's state regions that grow
// with the students or the rooms (K5, K8, K10; kernels.stage_regions on
// the host, in the order the hot loops read them most: occ, then amask,
// then att). A region not staged is read and written in global memory.
#define TT_STAGE_OCC 1
#define TT_STAGE_AMASK 2
#define TT_STAGE_ATT 4
#define TT_STAGE_ALL 7

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

// amask of the attendance att, built by the whole block (a thread per
// student); the caller syncs before and after.
__device__ __forceinline__ void tt_build_amask_block(const TTSweepProblem& pb,
                                                     const int16_t* att,
                                                     uint64_t* amask) {
    const int T = pb.T;
    for (int s = threadIdx.x; s < pb.S; s += blockDim.x) {
        const int16_t* a = att + (size_t)s * T;
        uint64_t m = 0ull;
        for (int t = 0; t < T; ++t)
            if (a[t] > 0) m |= 1ull << t;
        amask[s] = m;
    }
}

// slot_ev of the slots, built by the whole block (a thread per (slot,
// word)); the caller syncs before and after.
__device__ __forceinline__ void tt_build_slot_ev_block(
    const TTSweepProblem& pb, const int* slots, uint32_t* slot_ev) {
    const int E = pb.E, T = pb.T, W = pb.W;
    for (int i = threadIdx.x; i < T * W; i += blockDim.x) {
        const int t = i / W, f0 = (i % W) * 32;
        const int f1 = min(E, f0 + 32);
        uint32_t bits = 0u;
        for (int f = f0; f < f1; ++f)
            if (slots[f] == t) bits |= 1u << (f - f0);
        slot_ev[i] = bits;
    }
}

// amask and slot_ev of the state in slots/att, built by the whole block;
// the caller syncs before and after.
__device__ __forceinline__ void tt_build_bitsets_block(
    const TTSweepProblem& pb, const int* slots, const int16_t* att,
    uint64_t* amask, uint32_t* slot_ev) {
    tt_build_amask_block(pb, att, amask);
    tt_build_slot_ev_block(pb, slots, slot_ev);
}

// K3's body, phase 1, run by every thread of the block (it syncs twice):
// the conflict row of pivot `e` (pivot excluded) as a per-slot count —
// a popcount of the row against each slot's event bits — the
// post-removal slot masks of e's students (each its amask word with the
// old slot's bit recomputed) and the re-score of e's old day summed into
// *rm_acc.
__device__ __forceinline__ void tt_move1_prepare(
    const TTSweepProblem& pb, const int* slots, const int16_t* att,
    const uint64_t* amask, const uint32_t* slot_ev, int e, int* per_slot,
    int* rm_acc, uint64_t* masks) {
    const int T = pb.T, spd = pb.spd, W = pb.W;
    const int s_old = slots[e];
    const int D0 = s_old / spd;
    if (threadIdx.x == 0) rm_acc[0] = 0;
    // correlation: conflicting events (pivot excluded) per slot
    const uint32_t* row = pb.conflict_bits + (size_t)e * W;
    const int we = e >> 5;
    const uint32_t self = 1u << (e & 31);
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const uint32_t* sev = slot_ev + (size_t)t * W;
        int n = 0;
        for (int w = 0; w < W; ++w) {
            uint32_t bits = row[w] & sev[w];
            if (w == we) bits &= ~self;
            n += __popc(bits);
        }
        per_slot[t] = n;
    }
    __syncthreads();
    // the pivot's students: post-removal masks + the old day's re-score
    int k0 = pb.ev_ptr[e], nst = pb.ev_ptr[e + 1] - k0;
    int rm = 0;
    for (int i = threadIdx.x; i < nst; i += blockDim.x) {
        int s = pb.ev_stu[k0 + i];
        uint64_t before = amask[s];
        uint64_t after = att[(size_t)s * T + s_old] > 1
                             ? before : before & ~(1ull << s_old);
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

// The part of K4's body that reads no attendance, run by all 32 lanes of
// one warp on the padded 3-relocation candidate (ev, ns, on): the
// occupancy replay — all removes, then the adds for m = 0, 1, 2, each
// re-rooming on the row as updated so far — with the <= 6 touched cells
// kept as a delta list in registers, the room argmin over each lane's
// rooms l, l + 32, ... then a shuffle reduction (ties to the lower room,
// any R < 4096); then the
// unsuitable, last-slot and within-move correlation terms. Returns the
// old slots `os`, the new rooms `nr`, which events change slot
// (`shift`), and the hcv (*dh) and scv (*ds) terms so far.
template <bool WIDE>
__device__ __forceinline__ void tt_delta_rooms_warp(
    const TTSweepProblem& pb, const int* slots, const int* rooms,
    const int16_t* occ, const int ev[3], const int ns[3], const int on[3],
    int lane, int os[3], bool shift[3], int* dh, int* ds, int nr[3]) {
    const int R = pb.R, spd = pb.spd, W = pb.W;
    int orr[3], act[3];
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
    // the key's room part of the lane's first room, in registers; its
    // rooms from 32 on (tt_wide_rooms) are read as they come
    int cr = lane < R ? pb.cap_rank[lane] : 0;
    int dd = lane < R ? pb.dead[lane] : 0;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        int key = 0x7fffffff, best = lane;
        if (lane < R) {
            int unsuit = pb.possible[ev[m] * R + lane] ? 0 : 1;
            key = (cell(ns[m], lane) + unsuit) * TT_W_COST
                  + unsuit * TT_W_UNSUIT + cr + dd;
        }
        // the lane's rooms in increasing order: strict keeps the lowest
        for (int r = lane + 32; WIDE && r < R; r += 32) {
            const int unsuit = pb.possible[ev[m] * R + r] ? 0 : 1;
            const int k = (cell(ns[m], r) + unsuit) * TT_W_COST
                          + unsuit * TT_W_UNSUIT + pb.cap_rank[r]
                          + pb.dead[r];
            if (k < key) {
                key = k;
                best = r;
            }
        }
        int rc = tt_warp_argmin(key, best);
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
    // An entry that keeps its slot (ns == os: an inactive pad) adds 0 to
    // the moved x unmoved correlation and to every attendance patch, so
    // the body skips it.
#pragma unroll
    for (int m = 0; m < 3; ++m) shift[m] = ns[m] != os[m];
    *dh = pair_d + unsuit_d + corr;
    *ds = last_d;
}

// The affected days (<= 6: the old and new days of the events that
// change slot), each flagged unique on its first occurrence.
__device__ __forceinline__ void tt_affected_days(const int os[3],
                                                 const int ns[3],
                                                 const bool shift[3],
                                                 int spd, int days[6],
                                                 bool uniq[6]) {
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
}

// The moved events of word w of the conflict rows (they are masked out
// of the moved x unmoved correlation).
__device__ __forceinline__ uint32_t tt_moved_word(const int ev[3], int w) {
    uint32_t moved = 0u;
#pragma unroll
    for (int m = 0; m < 3; ++m)
        if ((ev[m] >> 5) == w) moved |= 1u << (ev[m] & 31);
    return moved;
}

// K4's body (K4, K5, K8, K10): the delta of one padded 3-relocation
// candidate (events ev, new slots ns, active flags on), run by all 32
// lanes of one warp; every lane returns the result. Each kernel that
// runs it has two instances, and its wrapper launches the WIDE one only
// where tt_wide_rooms(R): the room choice then takes each lane's rooms
// past the first 32, and at R <= 32 the kernel is the one-room-a-lane
// code of before, its registers and schedule its own. After the
// attendance-free terms (tt_delta_rooms_warp), the conflict dots count,
// for each event m that changes slot, the row's events (moved ones
// masked out) in its new slot minus those in its old one — popcounts of
// the row against slot_ev's two rows, the lanes over words. The day
// re-score walks the union of the students of the events that change
// slot (each student once: it is skipped under event m when it also
// attends an earlier one), one lane per student; it takes the student's
// attended slots from its amask word (`before`) and recomputes only the
// bits of the <= 6 slots the move touches from att plus the patch
// (`after`); every affected day is then re-scored from the two words.
template <bool WIDE>
__device__ __forceinline__ void tt_delta_one_bits_warp(
    const TTSweepProblem& pb, const int* slots, const int* rooms,
    const int16_t* att, const int16_t* occ, const uint64_t* amask,
    const uint32_t* slot_ev, const int ev[3], const int ns[3],
    const int on[3], int lane, int* d_hcv, int* d_scv, int nr[3]) {
    const int E = pb.E, T = pb.T, spd = pb.spd, W = pb.W;
    int os[3], dh, ds;
    bool shift[3];
    tt_delta_rooms_warp<WIDE>(pb, slots, rooms, occ, ev, ns, on, lane, os,
                              shift, &dh, &ds, nr);

    // ---- moved x unmoved correlation: popcounts against slot_ev
    int corr_l = 0;
    for (int w = lane; w < W; w += 32) {
        const uint32_t moved = tt_moved_word(ev, w);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            if (!shift[m]) continue;
            const uint32_t row =
                pb.conflict_bits[(size_t)ev[m] * W + w] & ~moved;
            corr_l += __popc(row & slot_ev[(size_t)ns[m] * W + w])
                      - __popc(row & slot_ev[(size_t)os[m] * W + w]);
        }
    }
    dh += tt_warp_sum(corr_l);
    TT_PROF(2);

    // ---- affected days re-scored per student from its amask word
    int days[6];
    bool uniq[6];
    tt_affected_days(os, ns, shift, spd, days, uniq);
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
            const uint64_t before = amask[s];
            uint64_t after = before;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                if (!shift[q] || !col[q]) continue;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int t = h ? ns[q] : os[q];
                    int v = att_s[t];
#pragma unroll
                    for (int x = 0; x < 3; ++x)
                        v += col[x] * ((ns[x] == t ? 1 : 0)
                                       - (os[x] == t ? 1 : 0));
                    after = v > 0 ? after | (1ull << t)
                                  : after & ~(1ull << t);
                }
            }
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                if (!uniq[i]) continue;
                scv_l += tt_day_scv(tt_day_bits(after, days[i], spd))
                         - tt_day_scv(tt_day_bits(before, days[i], spd));
            }
        }
    }
    *d_hcv = dh;
    *d_scv = ds + tt_warp_sum(scv_l);
    TT_PROF(3);
}

// delta.py:188 _apply_move on one individual's state in shared memory,
// run by the whole block; it ends on a barrier. `mv` holds the accepted
// move's events (3), old slots (3), old rooms (3), new slots (3) and new
// rooms (3); inactive pad entries (new == old) cancel, and padded events
// weigh 0 in occupancy. Only the students of the events that
// change slot are visited (ev_ptr / ev_stu), one event after another
// with a barrier between, since a student may attend two of them: each
// such student's att row loses the old slot and gains the new one, and
// its amask bits of those two slots are recomputed. Thread 0 meanwhile
// moves occupancy, slots, rooms and the events' slot_ev bits from the
// old slot's row to the new one's (delta.py:188 _apply_move, and
// ops/delta.py apply_bitsets for the bitsets).
// K5's CTAs of a cluster share the regions in global memory: there only
// the writer (rank 0) moves them, `w_occ`, `w_att` and `w_amask` false
// elsewhere (every caller but K5's GLOB instance takes the defaults,
// which compile to the code without them).
__device__ __forceinline__ void tt_apply_move_bits_block(
    const TTSweepProblem& pb, const int* mv, int* slots, int* rooms,
    int16_t* att, int16_t* occ, uint64_t* amask, uint32_t* slot_ev,
    bool w_occ = true, bool w_att = true, bool w_amask = true) {
    const int R = pb.R, T = pb.T, W = pb.W;
    if (threadIdx.x == 0) {
        if (w_occ) {
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                int lv = pb.live[mv[m]];
                occ[mv[3 + m] * R + mv[6 + m]] -= lv;
                occ[mv[9 + m] * R + mv[12 + m]] += lv;
            }
        }
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            slots[mv[m]] = mv[9 + m];
            rooms[mv[m]] = mv[12 + m];
            if (mv[3 + m] != mv[9 + m]) {
                const int w = mv[m] >> 5;
                const uint32_t bit = 1u << (mv[m] & 31);
                slot_ev[(size_t)mv[3 + m] * W + w] &= ~bit;
                slot_ev[(size_t)mv[9 + m] * W + w] |= bit;
            }
        }
    }
    for (int m = 0; m < 3; ++m) {
        const int e = mv[m], so = mv[3 + m], sn = mv[9 + m];
        if (so != sn && (w_att || w_amask))
            for (int k = pb.ev_ptr[e] + threadIdx.x; k < pb.ev_ptr[e + 1];
                 k += blockDim.x) {
                const int s = pb.ev_stu[k];
                int16_t* row = att + (size_t)s * T;
                const int vo = row[so] - 1, vn = row[sn] + 1;
                if (w_att) {
                    row[so] = (int16_t)vo;
                    row[sn] = (int16_t)vn;
                }
                if (w_amask) {
                    uint64_t a = amask[s];
                    a = vo > 0 ? a | (1ull << so) : a & ~(1ull << so);
                    a = vn > 0 ? a | (1ull << sn) : a & ~(1ull << sn);
                    amask[s] = a;
                }
            }
        __syncthreads();
    }
}

// The amask bits of the accepted move `mv`'s moved students at its old
// and new slots, recomputed from att as the apply left it (K5: a CTA
// whose amask is its own but whose att is rank 0's, after the cluster
// barrier that follows rank 0's apply). One event after another with a
// barrier between, as the apply, since a student may attend two.
__device__ __forceinline__ void tt_refresh_amask_block(
    const TTSweepProblem& pb, const int* mv, const int16_t* att,
    uint64_t* amask) {
    const int T = pb.T;
    for (int m = 0; m < 3; ++m) {
        const int e = mv[m], so = mv[3 + m], sn = mv[9 + m];
        if (so != sn)
            for (int k = pb.ev_ptr[e] + threadIdx.x; k < pb.ev_ptr[e + 1];
                 k += blockDim.x) {
                const int s = pb.ev_stu[k];
                const int16_t* row = att + (size_t)s * T;
                uint64_t a = amask[s];
                a = row[so] > 0 ? a | (1ull << so) : a & ~(1ull << so);
                a = row[sn] > 0 ? a | (1ull << sn) : a & ~(1ull << sn);
                amask[s] = a;
            }
        __syncthreads();
    }
}

// fitness.base_penalty: scv once feasible, else 1e6 + hcv
__device__ __forceinline__ int tt_base_penalty(int hcv, int scv) {
    return hcv == 0 ? scv : TT_INFEASIBLE_OFFSET + hcv;
}

// Lane 0's part of the random-candidate scoring (ops/delta.py:240-257):
// 12 ints of the candidate (ev, ns) of the individual whose (pen, hcv,
// scv) are st[0..2], with deltas (dh, ds) and new rooms nr, stored at
// `o`: the candidate's penalty — its base penalty plus, when anchored,
// the state's anchor residual pen - base_penalty(hcv, scv) and the
// move's anchor delta — its hcv and scv, ev[3], ns[3] and nr[3].
__device__ __forceinline__ void tt_store_candidate(
    const int* slots, const int ev[3], const int ns[3], const int nr[3],
    int dh, int ds, const int* st, const int* anchor_slots,
    const int* anchor_w, int anchored, int* o) {
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
