// K8: the random-candidate delta local search of a population, all
// rounds in one launch, after a wide pre-pass that takes every
// candidate's events.
//
// Replaces timetabling_ga_tpu/ops/delta.py:212 `batch_local_search_delta`
// — a lax.scan of n_rounds rounds, each drawing K random padded
// 3-relocations per individual (moves.py `sample_move`), scoring each by
// `_delta_one`, taking the first argmin of the anchored penalty and
// applying it on a strict improvement (`_apply_move`). It is the local
// search of the reference-faithful CLI path (the untuned default,
// `--ls-mode random`, sized by -p / -m).
//
// Bound on this card: the serial chain of n_rounds block-wide rounds
// (evaluate, one barrier, the K-way choice, the apply), not bytes: an
// individual's rows and penalty terms are read and written once a call,
// the draws (K uniform rows of E floats a round) once, by the pre-pass.
//
// Design, in two entry points:
//   - random_ls_events (the pre-pass; it also feeds K12,
//     full_eval_ls.cu, and K10, lahc.cu): sample_move's events are the top 3 of each
//     candidate's uniforms (moves.py:128, lax.top_k of iid draws), a
//     pure function of the draws, so they are known before round 0. It
//     is bound by bytes: it reads every uniform once (16 MB at P = 10,
//     -p 2) and writes 6 bytes a row, but its compares, merge and store
//     cost instructions a row too. A grid as large as the card holds at
//     once strides over groups of four rows, a warp a group at a time, 8
//     lanes a row; a lane issues all its loads of its row before any
//     compare: 16-byte loads for the aligned body (scalar ones for the 0-3
//     floats before and after it), each row read once. Each lane keeps a
//     sorted top 3 of (value, index) in registers; three argmax rounds
//     over its row's 8 lanes' heads merge them (largest first, ties to
//     the lower index; the winning lane pops), for the four rows at once,
//     and one store writes them. The events go out as int16, (P, n_rounds,
//     K, 3), each individual's contiguous. (The earlier body,
//     rooms_dev.cuh tt_top3_warp, made three passes of 4-byte loads,
//     each ending in a dependent shuffle argmax.)
//   - random_ls (the chain): one block per individual for the whole
//     call, one warp per candidate (a warp takes several when K >
//     K8_MAX_WARPS). The prologue loads the slots, rooms and, when it
//     fits, the conflict bitset into dynamic shared memory and builds
//     there att (S x T int16), occ (T x R int16, live events only) and
//     K5's two bitsets (amask, slot_ev; sweep_dev.cuh
//     tt_build_bitsets_block). The events come in chunks of rounds
//     (K8_EVENT_BYTES) into shared memory. A round: each warp builds
//     its candidate's relocation from the chunk and scores it with K5's
//     K4 body on the bitsets (tt_delta_one_bits_warp) and the anchor
//     terms; after one barrier every warp takes the first candidate of
//     least penalty (jnp.argmin) with a warp reduction, and every
//     thread, holding the individual's (pen, hcv, scv) in registers,
//     accepts it when strictly below; the block applies it with K5's
//     apply, which keeps the bitsets (tt_apply_move_bits_block). The
//     candidate records carry the move whole (old slots and rooms too)
//     and alternate between two buffers by round parity, so a rejected
//     round needs no second barrier. The K4 body then holds about half
//     of a round (k5_phases); splitting its student loop over the free
//     warps (K = 8 of 16) would save at most ~12% of a round on a path
//     whose pace the host's launches now set, so a candidate keeps one
//     warp.
// With a lane table (the serve path, parallel/islands.py:1115
// make_lane_runner; common.cuh), individual p's block reads the row of
// lane p / lane_rows once and runs everything above on that lane's
// problem; with a null table the problem is the one of the arguments.
// Nothing goes back to global memory until the epilogue, which writes
// slots, rooms and a full evaluation of the final row: penalty_dev.cuh's
// body on the block's occupancy, slot bitsets (masked to the live events)
// and amask words, in place of the delta-tracked terms — the value K2
// would give, so the generation needs no launch of K2 after the search.
// Integer-exact: equal to the plain version (ops/delta.py) bit for bit.
// Where att, amask or occ do not fit (the wrapper's stage mask, decided
// from the sizes: att goes to global memory first, then amask, then
// occ), the GLOB instance keeps them in the individual's global scratch
// row (g_att, g_amask, g_occ), the block's alone; the best of the rest
// stays staged.
#include "penalty_dev.cuh"
#include "sweep_dev.cuh"
#include "rooms_dev.cuh"

// the most warps of the chain's block (the CPU stand-in builds it small)
#ifndef K8_MAX_WARPS
#define K8_MAX_WARPS 16
#endif
// a candidate's record: pen, hcv, scv, ev[3], ns[3], nr[3] (as
// tt_store_candidate writes them), then the old slots and rooms[3]
#define K8_CAND_INTS 18
// shared memory for one chunk of rounds' events (at least one round;
// the CPU stand-in builds it small, to cross chunks)
#ifndef K8_EVENT_BYTES
#define K8_EVENT_BYTES 12288
#endif
// the pre-pass: warps a block, lanes a draw row, and float4 loads a lane
// keeps in flight (a row of up to 4 x K8E_LANES x K8E_VEC + 6 floats in
// one batch: 518 at these sizes, every ITC-2002 instance)
#define K8E_WARPS 4
#define K8E_LANES 8
#define K8E_VEC 16

struct K8Smem {
    unsigned slots, rooms, cand, amask, slot_ev, occ, att, events, eval,
        bits, total;
    int chunk_rounds, bits_in_smem, stage;
    // byte offsets of the regions not staged in an individual's global
    // scratch row, and its bytes
    unsigned g_amask, g_att, g_occ, g_bytes;
};

__host__ __device__ inline unsigned k8_align(size_t x) {
    return (unsigned)((x + 15) & ~(size_t)15);
}

__host__ __device__ inline K8Smem k8_smem_layout(int E, int R, int S, int T,
                                                 int K, int W,
                                                 int stage = TT_STAGE_ALL) {
    K8Smem m;
    unsigned o = 0;
    const size_t amask = k8_align(8 * (size_t)S);
    const size_t occ = k8_align(2 * (size_t)T * R);
    const size_t att = k8_align(2 * (size_t)S * T);
    m.stage = stage;
    m.g_amask = 0;
    m.g_att = m.g_amask + ((stage & TT_STAGE_AMASK) ? 0 : amask);
    m.g_occ = m.g_att + ((stage & TT_STAGE_ATT) ? 0 : att);
    m.g_bytes = m.g_occ + ((stage & TT_STAGE_OCC) ? 0 : occ);
    m.chunk_rounds = K8_EVENT_BYTES / (6 * K);
    if (m.chunk_rounds < 1) m.chunk_rounds = 1;
    m.slots = o; o += k8_align(4 * (size_t)E);
    m.rooms = o; o += k8_align(4 * (size_t)E);
    m.cand = o; o += k8_align(2 * 4 * (size_t)K8_CAND_INTS * K);
    m.amask = o; o += (stage & TT_STAGE_AMASK) ? amask : 0;
    m.slot_ev = o; o += k8_align(4 * (size_t)T * W);
    m.occ = o; o += (stage & TT_STAGE_OCC) ? occ : 0;
    m.att = o; o += (stage & TT_STAGE_ATT) ? att : 0;
    m.events = o; o += k8_align(6 * (size_t)K * m.chunk_rounds);
    // the epilogue's live-event words and reduction scratch
    m.eval = o; o += k8_align(4 * ((size_t)W + 4 * K8_MAX_WARPS));
    m.bits = o;
    unsigned with_bits = o + k8_align(4 * (size_t)E * W);
    m.bits_in_smem = with_bits <= TT_SMEM_LIMIT ? 1 : 0;
    m.total = m.bits_in_smem ? with_bits : o;
    return m;
}

struct K8Args {
    TTSweepProblem pb;             // conflict_bits: the global copy
    const int* anchor_slots;       // (E,)
    const int* anchor_w;           // (E,)
    const int* stu_ptr;            // (S+1,) CSR of each student's events
    const int* stu_ev;             // (nnz,)
    int diag;                      // sum of the conflict diagonal
    // rows in, (P, ...)
    const int* slots; const int* rooms; const int* pen; const int* hcv;
    const int* scv;
    // draws: row (round * K + candidate) * P + individual
    const int* mtype; const int* tgt;
    const int16_t* events;         // (P, n_rounds, K, 3) from the pre-pass
    // rows out
    int* slots_out; int* rooms_out; int* pen_out; int* hcv_out;
    int* scv_out;
    int P, K, n_rounds, anchored;
    // the serve path's lane table and rows a lane (null: one problem)
    const long long* lanes;
    int lane_rows;
    // the individuals' global scratch rows (lay.g_bytes each), or null
    unsigned char* scratch;
    K8Smem lay;
};

// One (value, index) into a lane's sorted top 3. A lane visits its
// indices in increasing order, so a later equal value never displaces an
// earlier one and a strict compare keeps lax.top_k's tie order.
__device__ __forceinline__ void k8e_push(float v, int i, float* tv,
                                         int* ti) {
    if (v > tv[2]) {
        if (v > tv[1]) {
            tv[2] = tv[1];
            ti[2] = ti[1];
            if (v > tv[0]) {
                tv[1] = tv[0];
                ti[1] = ti[0];
                tv[0] = v;
                ti[0] = i;
            } else {
                tv[1] = v;
                ti[1] = i;
            }
        } else {
            tv[2] = v;
            ti[2] = i;
        }
    }
}

// A row's top 3 from its K8E_LANES lanes' sorted lists: three argmax
// rounds over the lanes' heads (greater value, then lower index), the
// winning lane popping its head. Every lane of the group returns them.
__device__ __forceinline__ void k8e_merge(float* tv, int* ti, int ev[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float bv = tv[0];
        int bi = ti[0];
#pragma unroll
        for (int off = K8E_LANES / 2; off > 0; off >>= 1) {
            const float v2 = __shfl_xor_sync(TT_FULL_MASK, bv, off);
            const int i2 = __shfl_xor_sync(TT_FULL_MASK, bi, off);
            if (v2 > bv || (v2 == bv && i2 < bi)) {
                bv = v2;
                bi = i2;
            }
        }
        ev[k] = bi;
        if (ti[0] == bi) {
            tv[0] = tv[1];
            ti[0] = ti[1];
            tv[1] = tv[2];
            ti[1] = ti[2];
            tv[2] = __int_as_float(0xff800000);   // -inf
            ti[2] = 0x7fffffff;
        }
    }
}

// Warps stride over groups of 32 / K8E_LANES consecutive draw rows (a
// grid as large as the card holds at once, so no wave of blocks waits for
// another), K8E_LANES lanes a row. A lane loads its share of its row in
// one batch before any compare: of the row's first 0-3 floats up to a
// 16-byte boundary and its last 0-3 (scalar), and of the float4s between
// (K8E_VEC a lane; a longer row takes more batches). The merge and the
// store then serve the group's rows at once.
__global__ void __launch_bounds__(32 * K8E_WARPS)
random_ls_events_kernel(const float* __restrict__ u,
                        int16_t* __restrict__ events, int P, int E, int K,
                        int n_rounds) {
    constexpr int G = 32 / K8E_LANES;
    const int lane = threadIdx.x & 31, sub = lane % K8E_LANES;
    const unsigned rows = (unsigned)n_rounds * K * P;
    const unsigned groups = (rows + G - 1) / G;
    const unsigned stride = gridDim.x * K8E_WARPS;
    const float NEG = __int_as_float(0xff800000);   // -inf
    TT_PROF_START();
    for (unsigned g = blockIdx.x * K8E_WARPS + (threadIdx.x >> 5);
         g < groups; g += stride) {
        const unsigned q = g * G + lane / K8E_LANES;
        const bool ok = q < rows;
        const float* row = u + (size_t)(ok ? q : 0) * E;
        const unsigned mis = (unsigned)(uintptr_t)row & 15u;
        const int head = ok ? min(E, (int)(((16u - mis) & 15u) >> 2)) : 0;
        const int nv = ok ? (E - head) >> 2 : 0;
        const int t0 = head + 4 * nv;
        const float hx = sub < head ? row[sub] : NEG;
        const float tx = ok && sub < E - t0 ? row[t0 + sub] : NEG;
        const float4* r4 = (const float4*)(row + head);
        float tv[3] = {NEG, NEG, NEG};
        int ti[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff};
        if (sub < head) k8e_push(hx, sub, tv, ti);
        for (int b = 0; b < nv; b += K8E_LANES * K8E_VEC) {
            float4 x[K8E_VEC];
#pragma unroll
            for (int k = 0; k < K8E_VEC; ++k) {
                const int i = b + K8E_LANES * k + sub;
                if (i < nv) x[k] = r4[i];
            }
#ifdef TT_K5_PROF
            // the phase counters' load: until the first float arrives
            if (b + sub < nv) {
                float s;
                asm volatile("mov.b32 %0, %1;" : "=f"(s) : "f"(x[0].x));
            }
#endif
            TT_PROF(12);
#pragma unroll
            for (int k = 0; k < K8E_VEC; ++k) {
                const int i = b + K8E_LANES * k + sub;
                if (i < nv) {
                    const int f = head + 4 * i;
                    k8e_push(x[k].x, f, tv, ti);
                    k8e_push(x[k].y, f + 1, tv, ti);
                    k8e_push(x[k].z, f + 2, tv, ti);
                    k8e_push(x[k].w, f + 3, tv, ti);
                }
            }
        }
        k8e_push(tx, t0 + sub, tv, ti);
        TT_PROF(13);
        int ev[3];
        k8e_merge(tv, ti, ev);
        TT_PROF(14);
        // draw row q = (round * K + c) * P + p -> event row (p, round, c)
        if (ok && sub < 3) {
            const unsigned p = q % (unsigned)P, rc = q / (unsigned)P;
            events[((size_t)p * n_rounds * K + rc) * 3 + sub] =
                (int16_t)(sub == 0 ? ev[0] : sub == 1 ? ev[1] : ev[2]);
        }
        TT_PROF(15);
    }
}

template <bool WIDE, bool GLOB>
__global__ void __launch_bounds__(32 * K8_MAX_WARPS)
random_ls_kernel(K8Args A) {
    extern __shared__ __align__(16) unsigned char k8_smem[];
    const int E = A.pb.E, R = A.pb.R, S = A.pb.S, T = A.pb.T, W = A.pb.W;
    const int K = A.K, chunk = A.lay.chunk_rounds;
    const int p = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    int* slots = (int*)(k8_smem + A.lay.slots);
    int* rooms = (int*)(k8_smem + A.lay.rooms);
    int* cand = (int*)(k8_smem + A.lay.cand);    // 2 x K records
    // each region staged, or in the individual's scratch row
    unsigned char* g_row =
        GLOB ? A.scratch + (size_t)p * A.lay.g_bytes : nullptr;
    const int stage = GLOB ? A.lay.stage : TT_STAGE_ALL;
    uint64_t* amask = (uint64_t*)((stage & TT_STAGE_AMASK)
                                      ? k8_smem + A.lay.amask
                                      : g_row + A.lay.g_amask);
    uint32_t* slot_ev = (uint32_t*)(k8_smem + A.lay.slot_ev);
    int16_t* occ = (int16_t*)((stage & TT_STAGE_OCC) ? k8_smem + A.lay.occ
                                                     : g_row + A.lay.g_occ);
    int16_t* att = (int16_t*)((stage & TT_STAGE_ATT) ? k8_smem + A.lay.att
                                                     : g_row + A.lay.g_att);
    int16_t* evs = (int16_t*)(k8_smem + A.lay.events);
    uint32_t* bits = (uint32_t*)(k8_smem + A.lay.bits);

    TT_PROF_START();
    TTSweepProblem pb = A.pb;
    const int *anchor_slots = A.anchor_slots, *anchor_w = A.anchor_w;
    const int *stu_ptr = A.stu_ptr, *stu_ev = A.stu_ev;
    int diag = A.diag, anchored = A.anchored;
    if (A.lanes) {
        // this individual's lane: its problem's arrays and scalars
        const long long* row =
            A.lanes + (size_t)(p / A.lane_rows) * TT_LANE_FIELDS;
        pb.possible = tt_lane_ptr<uint8_t>(row, TT_LANE_POSSIBLE);
        pb.live = tt_lane_ptr<int>(row, TT_LANE_LIVE);
        pb.student_count = tt_lane_ptr<int>(row, TT_LANE_STUDENT_COUNT);
        pb.conflict_bits = tt_lane_ptr<uint32_t>(row, TT_LANE_CONFLICT_BITS);
        pb.cap_rank = tt_lane_ptr<int>(row, TT_LANE_CAP_RANK);
        pb.dead = tt_lane_ptr<int>(row, TT_LANE_DEAD);
        pb.attends = tt_lane_ptr<uint8_t>(row, TT_LANE_ATTENDS);
        pb.ev_ptr = tt_lane_ptr<int>(row, TT_LANE_EV_PTR);
        pb.ev_stu = tt_lane_ptr<int>(row, TT_LANE_EV_STU);
        anchor_slots = tt_lane_ptr<int>(row, TT_LANE_ANCHOR_SLOTS);
        anchor_w = tt_lane_ptr<int>(row, TT_LANE_ANCHOR_W);
        stu_ptr = tt_lane_ptr<int>(row, TT_LANE_STU_PTR);
        stu_ev = tt_lane_ptr<int>(row, TT_LANE_STU_EV);
        diag = (int)row[TT_LANE_DIAG];
        anchored = (int)row[TT_LANE_ANCHORED];
    }
    const uint32_t* g_bits = pb.conflict_bits;
    const int* g_slots = A.slots + (size_t)p * E;
    const int* g_rooms = A.rooms + (size_t)p * E;
    for (int i = tid; i < E; i += blockDim.x) {
        slots[i] = g_slots[i];
        rooms[i] = g_rooms[i];
    }
    if (A.lay.bits_in_smem) {
        for (int i = tid; i < E * W; i += blockDim.x) bits[i] = g_bits[i];
        pb.conflict_bits = bits;
    }
    // every thread keeps the individual's (pen, hcv, scv)
    int st[3] = {A.pen[p], A.hcv[p], A.scv[p]};
    __syncthreads();
    // att[s][t]: student s's attended events in slot t (delta.py
    // attendance_counts); each thread owns its students' rows
    for (int s = tid; s < S; s += blockDim.x) {
        int16_t* row = att + (size_t)s * T;
        for (int t = 0; t < T; ++t) row[t] = 0;
        for (int k = stu_ptr[s]; k < stu_ptr[s + 1]; ++k) {
            const int e = stu_ev[k];
            row[slots[e]] += pb.attends[(size_t)s * E + e];
        }
    }
    // occ[t][r]: live events in (slot t, room r) (rooms.py occupancy);
    // each thread owns its slots' rows
    for (int t = tid; t < T; t += blockDim.x) {
        int16_t* row = occ + (size_t)t * R;
        for (int r = 0; r < R; ++r) row[r] = 0;
        for (int e = 0; e < E; ++e)
            if (slots[e] == t && pb.live[e]) row[rooms[e]] += 1;
    }
    __syncthreads();
    tt_build_bitsets_block(pb, slots, att, amask, slot_ev);
    __syncthreads();
    TT_PROF(9);

    const int16_t* g_ev = A.events + (size_t)p * A.n_rounds * K * 3;
    for (int r = 0; r < A.n_rounds; ++r) {
        const int rc = r % chunk;
        if (rc == 0) {
            // every read of the previous chunk came before the previous
            // round's barrier
            const int n = min(chunk, A.n_rounds - r) * K * 3;
            for (int i = tid; i < n; i += blockDim.x)
                evs[i] = g_ev[(size_t)r * K * 3 + i];
            __syncthreads();
            TT_PROF(6);
        }
        int* rec = cand + (r & 1) * K * K8_CAND_INTS;
        for (int c = warp; c < K; c += n_warps) {
            const size_t row = ((size_t)r * K + c) * A.P + p;
            const int16_t* e3 = evs + (rc * K + c) * 3;
            int ev[3] = {e3[0], e3[1], e3[2]};
            int ns[3], on[3], nr[3], dh, ds;
            tt_sample_move(slots, A.mtype[row], A.tgt[row], ev, ns, on);
            TT_PROF(0);
            tt_delta_one_bits_warp<WIDE>(pb, slots, rooms, att, occ,
                                         amask, slot_ev, ev, ns, on, lane,
                                         &dh, &ds, nr);
            if (lane == 0) {
                int* o = rec + c * K8_CAND_INTS;
                tt_store_candidate(slots, ev, ns, nr, dh, ds, st,
                                   anchor_slots, anchor_w, anchored, o);
#pragma unroll
                for (int m = 0; m < 3; ++m) {
                    o[12 + m] = slots[ev[m]];
                    o[15 + m] = rooms[ev[m]];
                }
            }
            TT_PROF(4);
        }
        __syncthreads();
        TT_PROF(5);
        // the first candidate of least penalty, in every warp: each lane
        // keeps its first least, the reduction the lowest index of those
        int key = 0x7fffffff, idx = 0x7fffffff;
        for (int c = lane; c < K; c += 32) {
            const int v = rec[c * K8_CAND_INTS];
            if (v < key) {
                key = v;
                idx = c;
            }
        }
        const int* o = rec + tt_warp_argmin(key, idx) * K8_CAND_INTS;
        TT_PROF(7);
        if (o[0] < st[0]) {
            // the move as the apply takes it: events, old slots, old
            // rooms, new slots, new rooms
            int mv[15];
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                mv[m] = o[3 + m];
                mv[3 + m] = o[12 + m];
                mv[6 + m] = o[15 + m];
                mv[9 + m] = o[6 + m];
                mv[12 + m] = o[9 + m];
            }
            st[0] = o[0];
            st[1] = o[1];
            st[2] = o[2];
            tt_apply_move_bits_block(pb, mv, slots, rooms, att, occ, amask,
                                     slot_ev);
            TT_PROF(8);
        }
    }

    // the last apply ended on a barrier; a rejected round wrote nothing
    for (int i = tid; i < E; i += blockDim.x) {
        A.slots_out[(size_t)p * E + i] = slots[i];
        A.rooms_out[(size_t)p * E + i] = rooms[i];
    }
    // the full evaluation of the final row: slot_ev holds padded events
    // too, so the correlation masks it with the live events' words
    uint32_t* live_bits = (uint32_t*)(k8_smem + A.lay.eval);
    int* red = (int*)(live_bits + W);
    for (int w = warp; w < W; w += n_warps) {
        const int f = 32 * w + lane;
        const uint32_t b = __ballot_sync(TT_FULL_MASK, f < E && pb.live[f]);
        if (lane == 0) live_bits[w] = b;
    }
    __syncthreads();
    TT_PROF(10);
    const TTPenaltyProblem pp = {pb.possible, pb.live, pb.student_count,
                                 pb.conflict_bits, stu_ptr, stu_ev,
                                 anchor_slots, anchor_w, E, R, S, T,
                                 pb.spd, W, diag};
    TTPenAcc acc = tt_pen_zero();
    tt_pen_cells(occ, 0, T * R, acc);
    tt_pen_events(pp, slots, rooms, 0, E, acc);
    tt_pen_corr(pp, slots, pb.conflict_bits, pb.live, slot_ev, live_bits, 0,
                E, acc);
    tt_pen_students_amask(pp, amask, 0, S, acc);
    acc = tt_pen_block_reduce(acc, red);
    if (tid == 0)
        tt_pen_finish(pp, acc, A.pen_out + p, A.hcv_out + p, A.scv_out + p);
    TT_PROF(11);
}

extern "C" int tt_random_ls_smem_bytes(int E, int R, int S, int T, int K,
                                       int W) {
    return (int)k8_smem_layout(E, R, S, T, K, W).total;
}

extern "C" int tt_random_ls_events(const float* u, int16_t* events, int P,
                                   int E, int K, int n_rounds,
                                   void* stream) {
    if (P <= 0 || E < 3 || E > 32767 || K <= 0 || n_rounds <= 0)
        return (int)cudaErrorInvalidValue;
    const size_t rows = (size_t)n_rounds * K * P;
    if (rows > 0x7fffffffu) return (int)cudaErrorInvalidValue;
    // as many blocks as the card holds at once (asked once a device), at
    // most a block a K8E_WARPS groups of rows
    static int resident[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
    if (resident[dev] == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, random_ls_events_kernel, 32 * K8E_WARPS, 0);
        if (err != cudaSuccess) return (int)err;
        resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const size_t per_block = (size_t)K8E_WARPS * (32 / K8E_LANES);
    size_t grid = (rows + per_block - 1) / per_block;
    if (grid > (size_t)resident[dev]) grid = resident[dev];
    random_ls_events_kernel<<<(unsigned)grid, 32 * K8E_WARPS, 0,
                              (cudaStream_t)stream>>>(u, events, P, E, K,
                                                      n_rounds);
    return (int)cudaGetLastError();
}

extern "C" int tt_random_ls(
    const int* slots, const int* rooms, const int* pen, const int* hcv,
    const int* scv, const int* mtype, const int16_t* events, const int* tgt,
    const uint8_t* possible, const int* live, const int* student_count,
    const uint32_t* conflict_bits, const int* cap_rank, const int* dead,
    const uint8_t* attends, const int* ev_ptr, const int* ev_stu,
    const int* stu_ptr, const int* stu_ev, const int* anchor_slots,
    const int* anchor_w, const long long* lanes, int* slots_out,
    int* rooms_out, int* pen_out, int* hcv_out, int* scv_out,
    unsigned char* scratch, int P, int E, int R, int S, int T, int spd,
    int W, int K, int n_rounds, int anchored, int diag, int lane_rows,
    int stage, void* stream) {
    stage &= TT_STAGE_ALL;
    const bool glob = stage != TT_STAGE_ALL;
    if (P <= 0 || E < 3 || !tt_rooms_fit(E, R) || T > 64 || spd > 32
        || K <= 0
        || n_rounds < 0 || (lanes && (lane_rows <= 0 || P % lane_rows))
        || (glob && !scratch))
        return (int)cudaErrorInvalidValue;
    K8Smem lay = k8_smem_layout(E, R, S, T, K, W, stage);
    if (lay.total > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    // the instance that chooses among rooms past the first 32, where
    // there are some; the one with regions in global memory chooses
    // among any R
    const auto kernel = glob ? random_ls_kernel<true, true>
                        : tt_wide_rooms(R) ? random_ls_kernel<true, false>
                                           : random_ls_kernel<false, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lay.total);
    if (err != cudaSuccess) return (int)err;
    K8Args A;
    A.pb = {possible, live, student_count, conflict_bits, cap_rank, dead,
            attends, ev_ptr, ev_stu, E, R, S, T, spd, W};
    A.anchor_slots = anchor_slots; A.anchor_w = anchor_w;
    A.stu_ptr = stu_ptr; A.stu_ev = stu_ev; A.diag = diag;
    A.slots = slots; A.rooms = rooms; A.pen = pen; A.hcv = hcv; A.scv = scv;
    A.mtype = mtype; A.tgt = tgt; A.events = events;
    A.slots_out = slots_out; A.rooms_out = rooms_out; A.pen_out = pen_out;
    A.hcv_out = hcv_out; A.scv_out = scv_out;
    A.P = P; A.K = K; A.n_rounds = n_rounds; A.anchored = anchored;
    A.lanes = lanes; A.lane_rows = lane_rows;
    A.scratch = glob ? scratch : nullptr;
    A.lay = lay;
    int threads = 32 * (K < K8_MAX_WARPS ? K : K8_MAX_WARPS);
    kernel<<<P, threads, lay.total, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}
