// Device body of the full evaluation (fitness.batch_penalty), shared by
// K2's own launch (batch_penalty.cu), the epilogue of K6's breeding
// (breed.cu), the epilogue of K8's chain (random_ls.cu) and every
// candidate of K12's search (full_eval_ls.cu).
//
// It scores one individual whose slots and rooms are already in shared
// memory, from what the caller holds there, in four integer sums:
//   h2      room pairs n(n-1) over the (T, R) live occupancy, plus each
//           live event's conflict row ANDed with its slot's live events
//           and popcounted (the diagonal included, as compute_hcv's
//           `full`)
//   unsuit  live events in rooms they do not fit
//   scv     last-slot classes weighted by students, plus each student's
//           days re-scored from its 64-bit attended-slot mask (runs of 3,
//           single-class days)
//   anchor  the weighted Hamming distance to the anchor timetable
// then hcv = (h2 - diag) / 2 + unsuit and penalty = base(hcv, scv) +
// anchor, as K2 always computed them (fitness.py compute_hcv /
// scv_from_attendance / anchor_cost, in int32).
//
// Every part takes a range of its items (cells, events, (event, word)
// pairs, students) and the block's threads stride over it, so that a
// cluster's CTAs can split an individual (K2) and a single block can
// take all of it (K6, K8, K12). The students' masks come from a CSR walk
// (tt_pen_students_csr: K2 and K12 with it staged in shared memory by
// cp.async, K6 from global memory) or from the amask bitset K5/K8/K10 keep
// (tt_pen_students_amask). The four sums are reduced in one pass
// (tt_pen_block_reduce: warp shuffles on the four at once, one barrier,
// warp 0 finishes).
#pragma once

#include "common.cuh"

struct TTPenaltyProblem {
    const uint8_t* possible;       // (E, R)
    const int* live;               // (E,)
    const int* student_count;      // (E,)
    const uint32_t* conflict_bits; // (E, W)
    const int* stu_ptr;            // (S+1,) CSR of each student's events
    const int* stu_ev;             // (nnz,)
    const int* anchor_slots;       // (E,)
    const int* anchor_w;           // (E,)
    int E, R, S, T, spd, W, diag;
};

// one thread's share of the four sums
struct TTPenAcc {
    int h2, unsuit, scv, anchor;
};

__device__ __forceinline__ TTPenAcc tt_pen_zero() {
    TTPenAcc a = {0, 0, 0, 0};
    return a;
}

// The live events' slot bitsets slot_ev (T x W u32, bit f of row t set
// iff slots[f] == t and f is live), built by the whole block from `sl` in
// shared memory: zeroed, a barrier, one shared-memory atomicOr a live
// event. The caller syncs after.
__device__ __forceinline__ void tt_pen_slot_bits(const TTPenaltyProblem& pp,
                                                 const int* sl,
                                                 uint32_t* slot_ev) {
    for (int i = threadIdx.x; i < pp.T * pp.W; i += blockDim.x)
        slot_ev[i] = 0u;
    __syncthreads();
    for (int e = threadIdx.x; e < pp.E; e += blockDim.x)
        if (pp.live[e])
            atomicOr(&slot_ev[sl[e] * pp.W + (e >> 5)], 1u << (e & 31));
}

// Room pairs over occupancy cells [c0, c1): n(n-1) each.
template <class Occ>
__device__ __forceinline__ void tt_pen_cells(const Occ* occ, int c0, int c1,
                                             TTPenAcc& a) {
    for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
        const int n = occ[i];
        a.h2 += n * (n - 1);
    }
}

// Events [e0, e1): unsuitable rooms (live events), last-slot classes and
// the anchor distance (every event; padded ones weigh 0).
__device__ __forceinline__ void tt_pen_events(const TTPenaltyProblem& pp,
                                              const int* sl, const int* rm,
                                              int e0, int e1, TTPenAcc& a) {
    const int spd = pp.spd;
    for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
        const int t = sl[e];
        if (pp.live[e]) a.unsuit += pp.possible[e * pp.R + rm[e]] ? 0 : 1;
        if (t % spd == spd - 1) a.scv += pp.student_count[e];
        a.anchor += pp.anchor_w[e] * (t != pp.anchor_slots[e] ? 1 : 0);
    }
}

// Correlation of events [e0, e1), an event a thread: live event e's
// conflict row (row e - e0 of `rows`: the conflict bitset from e0 on, in
// global or shared memory) ANDed with its slot's row of slot_ev and, when
// slot_ev holds padded events too (K8's), with `live_bits`, popcounted
// word by word (the words' loads are independent, so they overlap).
// `live` is the (E,) live flags, in global or shared memory.
__device__ __forceinline__ void tt_pen_corr(const TTPenaltyProblem& pp,
                                            const int* sl,
                                            const uint32_t* rows,
                                            const int* live,
                                            const uint32_t* slot_ev,
                                            const uint32_t* live_bits,
                                            int e0, int e1, TTPenAcc& a) {
    const int W = pp.W;
    for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
        if (!live[e]) continue;
        const uint32_t* row = rows + (size_t)(e - e0) * W;
        const uint32_t* sev = slot_ev + sl[e] * W;
        int n = 0;
#pragma unroll 4
        for (int w = 0; w < W; ++w) {
            uint32_t bits = row[w] & sev[w];
            if (live_bits) bits &= live_bits[w];
            n += __popc(bits);
        }
        a.h2 += n;
    }
}

// scv of one student's days from its attended-slot mask: lane j of the
// student's group of g lanes takes days j, j + g, ...
__device__ __forceinline__ int tt_pen_days(uint64_t mask, int j, int g,
                                           int n_days, int spd) {
    int soft = 0;
    for (int d = j; d < n_days; d += g)
        soft += tt_day_scv(tt_day_bits(mask, d, spd));
    return soft;
}

// Students [s0, s1) from a CSR walk: `ptr` holds the students' n + 1
// offsets (ptr[i] is student s0 + i's first entry) and `ev` their events,
// entry k at ev[k - ptr[0]] — global memory or a staged slice in shared
// memory. Each student takes a group of g lanes (a power of two, as many
// as the block has for its students, at most 32): the lanes OR the slot
// bits of every g-th event, a shuffle butterfly joins the masks, and the
// group scores the days. The loop is uniform over the block (every lane
// takes part in the shuffles).
__device__ __forceinline__ void tt_pen_students_csr(
    const TTPenaltyProblem& pp, const int* sl, const int* ptr,
    const int* ev, int s0, int s1, TTPenAcc& a) {
    const int n = s1 - s0;
    if (n <= 0) return;
    int g = 1;
    while (g < 32 && 2 * g * n <= (int)blockDim.x) g *= 2;
    const int j = threadIdx.x & (g - 1), per = blockDim.x / g;
    const int k_base = ptr[0], n_days = pp.T / pp.spd;
    for (int b = 0; b < n; b += per) {
        const int i = b + (int)threadIdx.x / g;
        uint32_t lo = 0u, hi = 0u;
        if (i < n) {
            const int k1 = ptr[i + 1] - k_base;
#pragma unroll 4
            for (int k = ptr[i] - k_base + j; k < k1; k += g) {
                const int t = sl[ev[k]];
                if (t < 32) lo |= 1u << t;
                else hi |= 1u << (t - 32);
            }
        }
        for (int off = g >> 1; off > 0; off >>= 1) {
            lo |= __shfl_xor_sync(TT_FULL_MASK, lo, off);
            hi |= __shfl_xor_sync(TT_FULL_MASK, hi, off);
        }
        if (i < n)
            a.scv += tt_pen_days(((uint64_t)hi << 32) | lo, j, g, n_days,
                                 pp.spd);
    }
}

// Students [s0, s1) from their amask words (K5/K8/K10's bitset: bit t of
// student s set iff it attends an event in slot t), one (student, day) a
// thread.
__device__ __forceinline__ void tt_pen_students_amask(
    const TTPenaltyProblem& pp, const uint64_t* amask, int s0, int s1,
    TTPenAcc& a) {
    const int D = pp.T / pp.spd;
    for (int i = s0 * D + threadIdx.x; i < s1 * D; i += blockDim.x) {
        const int s = i / D, d = i - s * D;
        a.scv += tt_day_scv(tt_day_bits(amask[s], d, pp.spd));
    }
}

// The block's four sums in one pass: each warp reduces the four at once
// with shuffles, lane 0 stores them in `scratch` (4 ints a warp), one
// barrier, and warp 0 sums the warps'. The result is valid in warp 0.
__device__ __forceinline__ TTPenAcc tt_pen_block_reduce(TTPenAcc a,
                                                        int* scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = (blockDim.x + 31) >> 5;
    a.h2 = tt_warp_sum(a.h2);
    a.unsuit = tt_warp_sum(a.unsuit);
    a.scv = tt_warp_sum(a.scv);
    a.anchor = tt_warp_sum(a.anchor);
    if (lane == 0) {
        scratch[4 * warp] = a.h2;
        scratch[4 * warp + 1] = a.unsuit;
        scratch[4 * warp + 2] = a.scv;
        scratch[4 * warp + 3] = a.anchor;
    }
    __syncthreads();
    TTPenAcc r = tt_pen_zero();
    if (warp == 0) {
        if (lane < nw) {
            r.h2 = scratch[4 * lane];
            r.unsuit = scratch[4 * lane + 1];
            r.scv = scratch[4 * lane + 2];
            r.anchor = scratch[4 * lane + 3];
        }
        r.h2 = tt_warp_sum(r.h2);
        r.unsuit = tt_warp_sum(r.unsuit);
        r.scv = tt_warp_sum(r.scv);
        r.anchor = tt_warp_sum(r.anchor);
    }
    return r;
}

// (penalty, hcv, scv) of the individual's four sums: compute_hcv's
// (sum n(n-1) * 0.5 + (full - diag) * 0.5) -> int32, plus the
// unsuitable rooms; base_penalty plus the anchor distance.
__device__ __forceinline__ void tt_pen_finish(const TTPenaltyProblem& pp,
                                              TTPenAcc a, int* pen,
                                              int* hcv, int* scv) {
    const int h = (a.h2 - pp.diag) / 2 + a.unsuit;
    *hcv = h;
    *scv = a.scv;
    *pen = (h == 0 ? a.scv : TT_INFEASIBLE_OFFSET + h) + a.anchor;
}
