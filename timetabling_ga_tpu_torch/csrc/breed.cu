// K6: breeding of a whole population in one launch, and chains of random
// moves (its relocation entry).
//
// Replaces timetabling_ga_tpu/ops/ga.py:154 `tournament` and :168
// `_make_child` (vmapped over the children by `generation` :221) — with
// NSGA-II's crowded tournament (ops/nsga.py:109) under --nsga2 and the
// parallel room matcher (ops/rooms.py:304) under --rooms-mode parallel —
// and B7 fused: ops/moves.py:106/149/174 `sample_move` / `apply_relocation`
// / `random_move`, and the kick's chain of them (parallel/islands.py:823
// `_kick`). XLA runs a child as two k-draw lexsorts, a gather of two
// parents, the crossover's E-step room-matching scan and the mutation's
// occupancy rebuild; the port ran it as ~40 batched torch launches.
//
// Bound on this card: neither bytes nor operations. A child reads two
// parent rows and writes one (~10 KB at E=400) and does E*R room keys;
// its time is the matching's longest chain of dependent argmins, then a
// few more for the move.
//
// Design: one block per child (K6_THREADS, 16 warps), which keeps the
// child's slots, rooms and (T, R) occupancy in shared memory from the
// crossover through the mutation:
//   - two k-draw tournaments by (penalty, scv) — or, with `mo`, by
//     (rank asc, crowding desc) from K11's nsga_rank — the earliest draw
//     kept on a full tie (jnp.lexsort(...)[0]); draws index the child's
//     island; every thread takes them itself;
//   - do_x: the masked crossover of the parents' slots and K1's matching
//     body (rooms_dev.cuh tt_match_rooms_block: the slots' chains in
//     parallel, a warp per slot, each lane over its rooms; the greedy
//     scan was one warp's chain of E dependent argmins, ~0.1 ms) — or,
//     with
//     `parallel`, the parallel matcher's body from best-fit rooms
//     (rooms_dev.cuh tt_parallel_rooms_block: a warp per slot, rooms as
//     bits in capacity-rank order, each warp also writing its slots'
//     occupancy rows; on warp 0 alone it was ~130 us); else parent A's
//     slots and rooms, unmatched, and the occupancy counted from them;
//   - do_m, on warp 0 after a barrier: the top 3 of the row's E uniforms
//     by warp argmax (ties to the lower index), sample_move's padded
//     3-relocation and apply_relocation on the child's occupancy;
//   - the epilogue writes the child and scores it where it lies, with
//     penalty_dev.cuh's body on its slots, rooms and occupancy in shared
//     memory (the live slot bitsets built there, the students' masks from
//     the CSR in global memory), into the (3, P) (penalty, hcv, scv)
//     rows: the children's evaluation needs no launch of K2 of its own;
//   - with `out_parent` (the quality telemetry: its crossover and
//     mutation wins compare a child with its base parent,
//     ga.py:221-302 with_quality), thread 0 also writes tournament A's
//     winner, the row the child started from; without it nothing more;
//   - with `lanes` (the serve path, parallel/islands.py:1115
//     make_lane_runner: every island a job's lane, each its own problem
//     of one bucket), the block reads its island's row of the lane table
//     (common.cuh) once and runs every body above on that lane's arrays;
//     null, the problem is the one of the other arguments, as before.
// The relocation entry (kicks, the full-evaluation local search) keeps
// one warp per row and runs only the last step, n_moves times in order
// per row, on an occupancy counted once at the start.
// Past shared memory (the wrappers' stage masks, decided on the host from
// the sizes alone, kernels.stage_regions): a breeding block stages the
// parallel matcher's rank rows first, then its suitability words, then
// the child's occupancy, and the GLOB instance reads the words from the
// problem's and keeps the rows and the occupancy in a global scratch row
// a block, its `grid` blocks striding over the children (so the scratch
// is sized by the card, not by the population); a relocation block takes
// 4, 2 or 1 rows, as many as fit, and past one its GLOB instance keeps
// each row's occupancy in a scratch row a warp, striding so too.
#include "penalty_dev.cuh"
#include "rooms_dev.cuh"

// threads of a breeding block (the CPU stand-in builds it small), and
// rows of a relocation block
#ifndef K6_THREADS
#define K6_THREADS 512
#endif
#define K6_WARPS 4
// bits of the breeding stage mask: the matcher's rank rows, its
// suitability words, the child's occupancy staged
#define K6_ROWS 1
#define K6_SUIT 2
#define K6_OCC 4

// the winner of one tournament: `draws` (k) index the island's rows
// from `base`; strict improvement only, so the earliest draw wins ties.
// By (penalty, scv) ascending, or, when `ranks` is given, by the crowded
// comparison: rank ascending, crowding descending (an infinite crowding
// ties with another and falls back to the draw order).
__device__ __forceinline__ int k6_tournament(const int* draws, int k,
                                             int base, const int* pen,
                                             const int* scv,
                                             const int* ranks,
                                             const float* crowd) {
    int best = base + draws[0];
    for (int i = 1; i < k; ++i) {
        int j = base + draws[i];
        bool better =
            ranks ? (ranks[j] < ranks[best]
                     || (ranks[j] == ranks[best] && crowd[j] > crowd[best]))
                  : (pen[j] < pen[best]
                     || (pen[j] == pen[best] && scv[j] < scv[best]));
        if (better) best = j;
    }
    return best;
}

// one random move of row (sl, rm, occ) from its draws
__device__ __forceinline__ void k6_random_move(const TTRoomProblem& rp,
                                               int* sl, int* rm, int* occ,
                                               const float* u, int mtype,
                                               int t, int lane, int rank) {
    int ev[3], ns[3], on[3];
    tt_top3_warp(u, rp.E, lane, ev);
    tt_sample_move(sl, mtype, t, ev, ns, on);
    __syncwarp();
    tt_relocate_warp(rp, sl, rm, occ, ev, ns, on, lane, rank);
}

template <bool GLOB>
__global__ void __launch_bounds__(K6_THREADS) breed_kernel(
    const int* __restrict__ slots, const int* __restrict__ rooms,
    const int* __restrict__ pen, const int* __restrict__ scv,
    const int* __restrict__ ta, const int* __restrict__ tb,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ do_x,
    const uint8_t* __restrict__ do_m, const int* __restrict__ mtype,
    const float* __restrict__ u, const int* __restrict__ tgt,
    const uint8_t* __restrict__ possible, const int* __restrict__ cap_rank,
    const int* __restrict__ dead, const int* __restrict__ live,
    const int* __restrict__ order, const uint32_t* __restrict__ suit,
    const int* __restrict__ room_of, const int* __restrict__ ranks,
    const float* __restrict__ crowd, TTPenaltyProblem pp,
    const long long* __restrict__ lanes, int* __restrict__ out_slots,
    int* __restrict__ out_rooms, int* __restrict__ out_eval,
    int* __restrict__ out_parent, int* __restrict__ scratch, int P,
    int pop, int k, int E, int R, int T, int n_rounds, int so_ints,
    int stage) {
    extern __shared__ int k6_smem[];
    TT_PROF_START();
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // the GLOB instance's regions past shared memory: the occupancy
    // (T x R) and then the warps' rank rows, in the block's scratch row
    const bool occ_staged = !GLOB || (stage & K6_OCC);
    int* g_row = GLOB ? scratch + (size_t)blockIdx.x
                                      * ((occ_staged ? 0 : (size_t)T * R)
                                         + ((stage & K6_ROWS)
                                                ? 0
                                                : (size_t)tt_rank_row_ints(R)
                                                      * (K6_THREADS / 32)))
                      : nullptr;
    int* rows_g = GLOB && !(stage & K6_ROWS)
                      ? g_row + (occ_staged ? 0 : (size_t)T * R)
                      : nullptr;
    const bool su_glob = GLOB && !(stage & K6_SUIT);
    // child c, the whole block
    auto child = [&](const int c) {
    if (lanes) {
        // this island's lane: its problem's arrays and scalars
        const long long* row = lanes + (size_t)(c / pop) * TT_LANE_FIELDS;
        possible = tt_lane_ptr<uint8_t>(row, TT_LANE_POSSIBLE);
        cap_rank = tt_lane_ptr<int>(row, TT_LANE_CAP_RANK);
        dead = tt_lane_ptr<int>(row, TT_LANE_DEAD);
        live = tt_lane_ptr<int>(row, TT_LANE_LIVE);
        order = tt_lane_ptr<int>(row, TT_LANE_ROOM_ORDER);
        suit = tt_lane_ptr<uint32_t>(row, TT_LANE_SUIT_RANK);
        room_of = tt_lane_ptr<int>(row, TT_LANE_ROOM_OF_RANK);
        pp.possible = possible;
        pp.live = live;
        pp.student_count = tt_lane_ptr<int>(row, TT_LANE_STUDENT_COUNT);
        pp.conflict_bits =
            tt_lane_ptr<uint32_t>(row, TT_LANE_CONFLICT_BITS);
        pp.stu_ptr = tt_lane_ptr<int>(row, TT_LANE_STU_PTR);
        pp.stu_ev = tt_lane_ptr<int>(row, TT_LANE_STU_EV);
        pp.anchor_slots = tt_lane_ptr<int>(row, TT_LANE_ANCHOR_SLOTS);
        pp.anchor_w = tt_lane_ptr<int>(row, TT_LANE_ANCHOR_W);
        pp.diag = (int)row[TT_LANE_DIAG];
    }
    int* sl = k6_smem;                                   // (E,)
    int* rm = sl + E;                                    // (E,)
    // (T, R), staged after rm, or the block's scratch row
    int* occ = occ_staged ? rm + E : g_row;
    // the greedy matcher's event slots in matching order, or the
    // parallel matcher's scratch (tt_parallel_rooms_ints)
    int* so = occ_staged ? occ + T * R : rm + E;
    // the child's live slot bitsets and the reduction's scratch, for the
    // epilogue's evaluation
    uint32_t* slot_ev = (uint32_t*)(so + so_ints);
    int* red = (int*)(slot_ev + T * pp.W);
    const TTRoomProblem rp = {possible, cap_rank, dead, live, E, R, T};
    // every thread takes both tournaments (a few reads, no barrier)
    const int base = c / pop * pop;
    const int ia = k6_tournament(ta + (size_t)c * k, k, base, pen, scv,
                                 ranks, crowd);
    const int ib = k6_tournament(tb + (size_t)c * k, k, base, pen, scv,
                                 ranks, crowd);
    const int* sa = slots + (size_t)ia * E;
    const int* ra = rooms + (size_t)ia * E;
    const int* sb = slots + (size_t)ib * E;
    if (out_parent && tid == 0) out_parent[c] = ia;
    if (do_x[c]) {
        const uint8_t* mk = mask + (size_t)c * E;
        for (int e = tid; e < E; e += blockDim.x)
            sl[e] = mk[e] ? sa[e] : sb[e];
        if (n_rounds >= 0) {
            const TTRankRooms rr = {suit, room_of, (R + 31) / 32};
            for (int e = tid; e < E; e += blockDim.x)
                rm[e] = tt_best_fit_room(rr, e);
            __syncthreads();
            TT_PROF(0);
            if (GLOB)
                tt_parallel_rooms_block(rp, rr, sl, rm, so, n_rounds, occ,
                                        su_glob, rows_g);
            else
                tt_parallel_rooms_block(rp, rr, sl, rm, so, n_rounds, occ);
            TT_PROF(4);
        } else {
            for (int i = tid; i < T * R; i += blockDim.x) occ[i] = 0;
            for (int i = tid; i < E; i += blockDim.x)
                so[i] = mk[order[i]] ? sa[order[i]] : sb[order[i]];
            __syncthreads();
            tt_match_rooms_block(rp, order, so, occ, rm);
        }
    } else {
        for (int e = tid; e < E; e += blockDim.x) {
            sl[e] = sa[e];
            rm[e] = ra[e];
        }
        __syncthreads();
        if (warp == 0) tt_occupancy_warp(rp, sl, rm, occ, lane);
    }
    __syncthreads();
    if (do_m[c] && warp == 0)
        k6_random_move(rp, sl, rm, occ, u + (size_t)c * E, mtype[c], tgt[c],
                       lane, tt_room_rank(rp, lane));
    __syncthreads();
    tt_pen_slot_bits(pp, sl, slot_ev);
    for (int e = tid; e < E; e += blockDim.x) {
        out_slots[(size_t)c * E + e] = sl[e];
        out_rooms[(size_t)c * E + e] = rm[e];
    }
    __syncthreads();
    TTPenAcc acc = tt_pen_zero();
    tt_pen_cells(occ, 0, T * R, acc);
    tt_pen_events(pp, sl, rm, 0, E, acc);
    tt_pen_corr(pp, sl, pp.conflict_bits, live, slot_ev, nullptr, 0, E, acc);
    tt_pen_students_csr(pp, sl, pp.stu_ptr, pp.stu_ev, 0, pp.S, acc);
    acc = tt_pen_block_reduce(acc, red);
    if (tid == 0)
        tt_pen_finish(pp, acc, out_eval + c, out_eval + P + c,
                      out_eval + 2 * P + c);
    };
    if (!GLOB) {
        // a block a child
        child(blockIdx.x);
        return;
    }
    for (int c = blockIdx.x; c < P; c += gridDim.x) {
        child(c);
        __syncthreads();
    }
}

// row c's chain on warp `warp`'s slots, rooms and occupancy (the warp
// syncs after)
__device__ __forceinline__ void k6_relocate_row(
    const TTRoomProblem& rp, const int* __restrict__ slots,
    const int* __restrict__ rooms, const int* __restrict__ mtype,
    const float* __restrict__ u, const int* __restrict__ tgt,
    int* __restrict__ out_slots, int* __restrict__ out_rooms, int* sl,
    int* rm, int* occ, int c, int N, int n_moves, int lane, int rank) {
    const int E = rp.E;
    for (int e = lane; e < E; e += 32) {
        sl[e] = slots[(size_t)c * E + e];
        rm[e] = rooms[(size_t)c * E + e];
    }
    __syncwarp();
    tt_occupancy_warp(rp, sl, rm, occ, lane);
    for (int i = 0; i < n_moves; ++i) {
        size_t row = (size_t)i * N + c;
        k6_random_move(rp, sl, rm, occ, u + row * E, mtype[row], tgt[row],
                       lane, rank);
    }
    __syncwarp();
    for (int e = lane; e < E; e += 32) {
        out_slots[(size_t)c * E + e] = sl[e];
        out_rooms[(size_t)c * E + e] = rm[e];
    }
}

// RPB rows a block, a warp a row; the GLOB instance keeps each warp's
// occupancy in its scratch row and strides over the rows
template <int RPB, bool GLOB>
__global__ void relocate_kernel(
    const int* __restrict__ slots, const int* __restrict__ rooms,
    const int* __restrict__ mtype, const float* __restrict__ u,
    const int* __restrict__ tgt, const uint8_t* __restrict__ possible,
    const int* __restrict__ cap_rank, const int* __restrict__ dead,
    const int* __restrict__ live, int* __restrict__ out_slots,
    int* __restrict__ out_rooms, int* __restrict__ scratch, int N,
    int n_moves, int E, int R, int T) {
    extern __shared__ int k6_smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const TTRoomProblem rp = {possible, cap_rank, dead, live, E, R, T};
    if (!GLOB) {
        const int c = blockIdx.x * RPB + warp;
        if (c >= N) return;
        int* sl = k6_smem + warp * (2 * E + T * R);
        int* rm = sl + E;
        int* occ = rm + E;
        const int rank = tt_room_rank(rp, lane);
        k6_relocate_row(rp, slots, rooms, mtype, u, tgt, out_slots,
                        out_rooms, sl, rm, occ, c, N, n_moves, lane, rank);
        return;
    }
    int* sl = k6_smem + warp * 2 * E;
    int* rm = sl + E;
    int* occ = scratch + ((size_t)blockIdx.x * RPB + warp) * T * R;
    const int rank = tt_room_rank(rp, lane);
    for (int c = blockIdx.x * RPB + warp; c < N; c += gridDim.x * RPB) {
        k6_relocate_row(rp, slots, rooms, mtype, u, tgt, out_slots,
                        out_rooms, sl, rm, occ, c, N, n_moves, lane, rank);
        __syncwarp();
    }
}

extern "C" int tt_breed(
    const int* slots, const int* rooms, const int* pen, const int* scv,
    const int* ta, const int* tb, const uint8_t* mask, const uint8_t* do_x,
    const uint8_t* do_m, const int* mtype, const float* u, const int* tgt,
    const uint8_t* possible, const int* cap_rank, const int* dead,
    const int* live, const int* order, const uint32_t* suit,
    const int* room_of, const int* ranks, const float* crowd,
    const int* student_count, const uint32_t* conflict_bits,
    const int* stu_ptr, const int* stu_ev, const int* anchor_slots,
    const int* anchor_w, const long long* lanes, int* out_slots,
    int* out_rooms, int* out_eval, int* out_parent, int* scratch, int P,
    int pop, int k, int E, int R, int T, int n_rounds, int S, int spd,
    int W, int diag, int stage, int grid, void* stream) {
    const bool par = n_rounds >= 0;
    // the greedy matcher has no rows and no words: only the occupancy
    if (!par) stage |= K6_ROWS | K6_SUIT;
    const bool glob = (stage & (K6_ROWS | K6_SUIT | K6_OCC))
                      != (K6_ROWS | K6_SUIT | K6_OCC);
    if (!tt_rooms_fit(E, R) || E < 3 || P <= 0 || pop <= 0 || P % pop != 0
        || k <= 0 || T > 64 || spd > 32
        || (ranks != nullptr) != (crowd != nullptr)
        || (glob && grid <= 0)
        || (((stage & (K6_ROWS | K6_OCC)) != (K6_ROWS | K6_OCC))
            && !scratch))
        return (int)cudaErrorInvalidValue;
    const size_t so_ints =
        par ? tt_parallel_rooms_ints(E, R, T, K6_THREADS / 32,
                                     stage & K6_SUIT, stage & K6_ROWS)
            : (size_t)E;
    size_t smem = sizeof(int)
                  * (2 * (size_t)E + ((stage & K6_OCC) ? (size_t)T * R : 0)
                     + so_ints + (size_t)T * W + 4 * (K6_THREADS / 32));
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    const auto kernel = glob ? breed_kernel<true> : breed_kernel<false>;
    cudaError_t err = tt_set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const TTPenaltyProblem pp = {possible, live, student_count,
                                 conflict_bits, stu_ptr, stu_ev,
                                 anchor_slots, anchor_w, E, R, S, T, spd, W,
                                 diag};
    kernel<<<glob ? grid : P, K6_THREADS, smem, (cudaStream_t)stream>>>(
        slots, rooms, pen, scv, ta, tb, mask, do_x, do_m, mtype, u, tgt,
        possible, cap_rank, dead, live, order, suit, room_of, ranks, crowd,
        pp, lanes, out_slots, out_rooms, out_eval, out_parent, scratch, P,
        pop, k, E, R, T, n_rounds, (int)so_ints, stage);
    return (int)cudaGetLastError();
}

// `rows` a block (4, 2 or 1: as many as fit in shared memory, the
// wrapper's choice), or 0: past one, four a block with each row's
// occupancy in `scratch`, `grid` blocks
extern "C" int tt_relocate(
    const int* slots, const int* rooms, const int* mtype, const float* u,
    const int* tgt, const uint8_t* possible, const int* cap_rank,
    const int* dead, const int* live, int* out_slots, int* out_rooms,
    int* scratch, int N, int n_moves, int E, int R, int T, int rows,
    int grid, void* stream) {
    if (!tt_rooms_fit(E, R) || E < 3 || N <= 0 || n_moves < 0
        || (rows != 0 && rows != 1 && rows != 2 && rows != K6_WARPS)
        || (rows == 0 && (!scratch || grid <= 0)))
        return (int)cudaErrorInvalidValue;
    const int rpb = rows ? rows : K6_WARPS;
    size_t smem = sizeof(int) * rpb
                  * (2 * (size_t)E + (rows ? (size_t)T * R : 0));
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    const auto kernel = rows == K6_WARPS ? relocate_kernel<K6_WARPS, false>
                      : rows == 2 ? relocate_kernel<2, false>
                      : rows == 1 ? relocate_kernel<1, false>
                                  : relocate_kernel<K6_WARPS, true>;
    cudaError_t err = tt_set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = rows ? (N + rpb - 1) / rpb : grid;
    kernel<<<blocks, 32 * rpb, smem, (cudaStream_t)stream>>>(
        slots, rooms, mtype, u, tgt, possible, cap_rank, dead, live,
        out_slots, out_rooms, scratch, N, n_moves, E, R, T);
    return (int)cudaGetLastError();
}
