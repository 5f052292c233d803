// K10: Late-Acceptance Hill Climbing walkers, every step of a launch in
// one launch, after K8's pre-pass has taken every candidate's events.
//
// Replaces timetabling_ga_tpu/ops/lahc.py:106 `lahc_steps` (and the
// state :89 `init_lahc` builds), run by parallel/islands.py:899
// `make_lahc_runners` in the --post-lahc endgame. XLA runs a step as a
// vmap over walkers of K sample_move + _delta_one candidates, a lexsort
// and _apply_move, a fori_loop of steps.
//
// Bound on this card: the latency of the serial chain of steps (K
// candidates scored, one barrier, the choice and the acceptance, the
// apply), not bytes: a walker's state is read and written once a launch,
// its draws once.
//
// Design: K8's chain (random_ls.cu), one block per walker for every step
// of the launch, one warp per candidate (a warp takes several when K >
// K10_MAX_WARPS). The candidates' events come from K8's pre-pass
// (random_ls_events on the uniforms as one individual's n rounds of W x K
// candidates: (n, W, K, 3) int16, in a buffer the wrapper pads by 32
// bytes), so no top 3 and no uniform runs on the chain. The walker's
// slots, rooms, att and occ, K5's two bitsets (amask, slot_ev; built in
// the prologue, sweep_dev.cuh), its best-so-far slots and rooms, its
// history ring (when it fits; else the ring stays in global memory, the
// layout's flag) and the conflict bitset (when it fits) stay in shared
// memory. The draws come in chunks of steps (K10_CHUNK_BYTES), two
// buffers: a chunk's cp.async copies are issued one chunk ahead, after
// the barrier that opens the chunk before, so no step waits on device
// memory. A step's run of a walker is its K events (6K bytes at a stride
// of 6WK), move types and targets (4K bytes each at a stride of 4WK): the
// events go as 16-byte copies from the 16-byte boundary at or below the
// run (the padding covers the last run's overhang), the move types and
// targets as 16-byte copies when K % 4 == 0, else as 4-byte ones. A step:
// each warp builds its candidate's relocation from the chunk and scores
// it with K5's K4 body on the bitsets (tt_delta_one_bits_warp) and the
// anchor terms; lane 0 stores the record with the move whole (old slots
// and rooms too), into one of two buffers by step parity. After one
// barrier every warp takes the first least (pen, scv) of the K records
// (jnp.lexsort((cs, cp))[0]) with three warp minima, and every thread,
// holding the walker's (pen, hcv, scv), its best triple and the step's
// history entry in registers, accepts it when it is no worse than the
// entry or than the current cost (both lexicographic, non-strict). Thread
// 0 writes the post-decision cost into the ring; every thread then reads
// the next step's entry (the ring's next slot, written at least a step
// earlier; with Lh = 1 the cost it just wrote, from its registers). An
// accepted move is applied by the block with K5's apply, which keeps the
// bitsets and ends on a barrier; a strict improvement then copies the
// slots and rooms into the best snapshot. A rejected step writes no
// state but the ring entry, so it needs no second barrier. The state goes
// back to global memory in the epilogue (the bitsets die with the block).
// Integer-exact: equal to the plain version (ops/lahc.py) bit for bit.
// Where att, amask or occ do not fit (the wrapper's stage mask, decided
// from the sizes: att goes to global memory first, then amask, then
// occ), the GLOB instance works on the walker's own att and occ rows in
// place and keeps amask in the walker's global scratch row; the best
// snapshot holds slots and rooms only, so it needs none of them.
#include "sweep_dev.cuh"
#include "rooms_dev.cuh"

// the most warps of a block (the CPU stand-in builds it small)
#ifndef K10_MAX_WARPS
#define K10_MAX_WARPS 16
#endif
// a candidate's record: pen, hcv, scv, ev[3], ns[3], nr[3] (as
// tt_store_candidate writes them), then the old slots and rooms[3]
#define K10_CAND_INTS 18
// shared memory for one chunk of steps' draws (at least one step; the
// CPU stand-in builds it small, to cross chunks)
#ifndef K10_CHUNK_BYTES
#define K10_CHUNK_BYTES 12288
#endif

struct K10Smem {
    unsigned slots, rooms, best_slots, best_rooms, cand, amask, slot_ev,
        occ, att, draws, bits, hist, total;
    // a step's bytes in a chunk: its events (from a 16-byte boundary),
    // then its move types and its targets, each 16-byte aligned
    unsigned ev_bytes, mt_bytes, step_bytes;
    int chunk_steps, bits_in_smem, hist_in_smem, stage;
};

__host__ __device__ inline unsigned k10_align(size_t x) {
    return (unsigned)((x + 15) & ~(size_t)15);
}

__host__ __device__ inline K10Smem k10_smem_layout(int E, int R, int S,
                                                   int T, int K, int W,
                                                   int Lh,
                                                   int stage = TT_STAGE_ALL) {
    K10Smem m;
    unsigned o = 0;
    m.stage = stage;
    m.ev_bytes = k10_align(6 * (size_t)K) + 16;
    m.mt_bytes = k10_align(4 * (size_t)K);
    m.step_bytes = m.ev_bytes + 2 * m.mt_bytes;
    m.chunk_steps = K10_CHUNK_BYTES / m.step_bytes;
    if (m.chunk_steps < 1) m.chunk_steps = 1;
    m.slots = o; o += k10_align(4 * (size_t)E);
    m.rooms = o; o += k10_align(4 * (size_t)E);
    m.best_slots = o; o += k10_align(4 * (size_t)E);
    m.best_rooms = o; o += k10_align(4 * (size_t)E);
    m.cand = o; o += k10_align(2 * 4 * (size_t)K10_CAND_INTS * K);
    m.amask = o;
    o += (stage & TT_STAGE_AMASK) ? k10_align(8 * (size_t)S) : 0;
    m.slot_ev = o; o += k10_align(4 * (size_t)T * W);
    m.occ = o;
    o += (stage & TT_STAGE_OCC) ? k10_align(2 * (size_t)T * R) : 0;
    m.att = o;
    o += (stage & TT_STAGE_ATT) ? k10_align(2 * (size_t)S * T) : 0;
    m.draws = o; o += 2 * m.chunk_steps * m.step_bytes;
    // the conflict bitset, then the history ring, where they still fit
    m.bits = o;
    const unsigned bits = k10_align(4 * (size_t)E * W);
    m.bits_in_smem = o + bits <= TT_SMEM_LIMIT ? 1 : 0;
    if (m.bits_in_smem) o += bits;
    m.hist = o;
    const unsigned hist = 2 * k10_align(4 * (size_t)Lh);
    m.hist_in_smem = o + hist <= TT_SMEM_LIMIT ? 1 : 0;
    if (m.hist_in_smem) o += hist;
    m.total = o;
    return m;
}

struct K10Args {
    TTSweepProblem pb;             // conflict_bits: the global copy
    const int* anchor_slots;       // (E,)
    const int* anchor_w;           // (E,)
    // the walkers' state, (W, ...), updated in place
    int* slots; int* rooms; int16_t* att; int16_t* occ;
    int* pen; int* hcv; int* scv;
    int* hist_pen; int* hist_scv;  // (W, Lh)
    int* step;
    int* best_slots; int* best_rooms; int* best_pen; int* best_hcv;
    int* best_scv;
    // draws: row (step * W + walker) * K + candidate
    const int* mtype; const int16_t* events; const int* tgt;
    int W, K, Lh, n_steps, anchored;
    // the walkers' amask rows where it is not staged (S u64 each), or null
    uint64_t* amask_g;
    K10Smem lay;
};

__device__ __forceinline__ bool k10_lex_le(int pa, int sa, int pb, int sb) {
    return pa < pb || (pa == pb && sa <= sb);
}

__device__ __forceinline__ bool k10_lex_lt(int pa, int sa, int pb, int sb) {
    return pa < pb || (pa == pb && sa < sb);
}

// The 16-byte boundary at or below walker w's events of step s.
__device__ __forceinline__ const unsigned char* k10_ev_run(const K10Args& A,
                                                           int s, int w) {
    const uintptr_t a = (uintptr_t)(A.events
                                    + ((size_t)s * A.W + w) * A.K * 3);
    return (const unsigned char*)(a & ~(uintptr_t)15);
}

// Issue the cp.async copies of steps [s0, s0 + n) of walker w into chunk
// buffer `buf`, spread over the block's threads (16-byte pieces of the
// events, 16- or 4-byte pieces of the move types and targets).
__device__ __forceinline__ void k10_stage(const K10Args& A,
                                          unsigned char* buf, int s0,
                                          int n, int w, int mt_ints) {
    const K10Smem& L = A.lay;
    const int pe = L.ev_bytes / 16, pm = A.K / mt_ints;
    const int per = pe + 2 * pm;
    for (int q = threadIdx.x; q < n * per; q += blockDim.x) {
        const int j = q / per;
        int r = q - j * per;
        const int s = s0 + j;
        unsigned char* dst = buf + (size_t)j * L.step_bytes;
        if (r < pe) {
            tt_async_16(dst + 16 * r, k10_ev_run(A, s, w) + 16 * r);
            continue;
        }
        r -= pe;
        const int* src = A.mtype;
        dst += L.ev_bytes;
        if (r >= pm) {
            r -= pm;
            src = A.tgt;
            dst += L.mt_bytes;
        }
        src += ((size_t)s * A.W + w) * A.K + r * mt_ints;
        dst += 4 * r * mt_ints;
        if (mt_ints == 4) tt_async_16(dst, src);
        else tt_async_4(dst, src);
    }
}

template <bool WIDE, bool GLOB>
__global__ void __launch_bounds__(32 * K10_MAX_WARPS) lahc_kernel(K10Args A) {
    extern __shared__ __align__(16) unsigned char k10_smem[];
    const int E = A.pb.E, R = A.pb.R, S = A.pb.S, T = A.pb.T, W = A.pb.W;
    const int K = A.K, Lh = A.Lh, chunk = A.lay.chunk_steps;
    const int w = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    int* slots = (int*)(k10_smem + A.lay.slots);
    int* rooms = (int*)(k10_smem + A.lay.rooms);
    int* bslots = (int*)(k10_smem + A.lay.best_slots);
    int* brooms = (int*)(k10_smem + A.lay.best_rooms);
    int* cand = (int*)(k10_smem + A.lay.cand);    // 2 x K records
    // each region staged, or the walker's own row in global memory
    const int stage = GLOB ? A.lay.stage : TT_STAGE_ALL;
    uint64_t* amask = (stage & TT_STAGE_AMASK)
                          ? (uint64_t*)(k10_smem + A.lay.amask)
                          : A.amask_g + (size_t)w * S;
    uint32_t* slot_ev = (uint32_t*)(k10_smem + A.lay.slot_ev);
    int16_t* occ = (stage & TT_STAGE_OCC)
                       ? (int16_t*)(k10_smem + A.lay.occ)
                       : A.occ + (size_t)w * T * R;
    int16_t* att = (stage & TT_STAGE_ATT)
                       ? (int16_t*)(k10_smem + A.lay.att)
                       : A.att + (size_t)w * S * T;
    unsigned char* draws = k10_smem + A.lay.draws;
    uint32_t* bits = (uint32_t*)(k10_smem + A.lay.bits);
    // the move types' and targets' copy size, in ints
    const int mt_ints = (K % 4 == 0 && ((uintptr_t)A.mtype & 15u) == 0
                         && ((uintptr_t)A.tgt & 15u) == 0) ? 4 : 1;

    TT_PROF_START();
    // ---- prologue: chunk 0's draws, the rows, the ring and the conflict
    // bitset where they fit, all in flight at once
    if (A.n_steps > 0)
        k10_stage(A, draws, 0, min(chunk, A.n_steps), w, mt_ints);
    const size_t re = (size_t)w * E;
    tt_async_ints(slots, A.slots + re, E);
    tt_async_ints(rooms, A.rooms + re, E);
    tt_async_ints(bslots, A.best_slots + re, E);
    tt_async_ints(brooms, A.best_rooms + re, E);
    int* hp = A.hist_pen + (size_t)w * Lh;
    int* hs = A.hist_scv + (size_t)w * Lh;
    if (A.lay.hist_in_smem) {
        int* sp = (int*)(k10_smem + A.lay.hist);
        int* ss = sp + k10_align(4 * (size_t)Lh) / 4;
        tt_async_ints(sp, hp, Lh);
        tt_async_ints(ss, hs, Lh);
        hp = sp;
        hs = ss;
    }
    TTSweepProblem pb = A.pb;
    if (A.lay.bits_in_smem) {
        tt_async_ints((int*)bits, (const int*)A.pb.conflict_bits, E * W);
        pb.conflict_bits = bits;
    }
    if (stage & TT_STAGE_ATT)
        for (int i = tid; i < S * T; i += blockDim.x)
            att[i] = A.att[(size_t)w * S * T + i];
    if (stage & TT_STAGE_OCC)
        for (int i = tid; i < T * R; i += blockDim.x)
            occ[i] = A.occ[(size_t)w * T * R + i];
    // every thread keeps the walker's (pen, hcv, scv), its best triple
    // and the step's history entry
    int st[3] = {A.pen[w], A.hcv[w], A.scv[w]};
    int best[3] = {A.best_pen[w], A.best_hcv[w], A.best_scv[w]};
    const int step0 = A.step[w];
    int v = step0 % Lh;
    tt_async_wait();
    __syncthreads();
    tt_build_bitsets_block(pb, slots, att, amask, slot_ev);
    int h_pen = hp[v], h_scv = hs[v];
    // the step's place in its chunk, its chunk's buffer, and the address
    // of its events (6WK bytes a step)
    int rc = 0, buf = 0;
    uintptr_t ev_at = (uintptr_t)(A.events + (size_t)w * K * 3);
    const size_t ev_stride = (size_t)A.W * K * 6;
    __syncthreads();
    TT_PROF(9);

    for (int i = 0; i < A.n_steps; ++i) {
        if (rc == 0) {
            // this chunk's copies, issued a chunk ago; after the barrier
            // every read of the other buffer is done, so the next chunk
            // goes there
            tt_async_wait();
            __syncthreads();
            if (i + chunk < A.n_steps)
                k10_stage(A, draws + (size_t)(buf ^ 1) * chunk
                                         * A.lay.step_bytes,
                          i + chunk, min(chunk, A.n_steps - i - chunk), w,
                          mt_ints);
            TT_PROF(6);
        }
        const unsigned char* sb =
            draws + (size_t)(buf * chunk + rc) * A.lay.step_bytes;
        const int16_t* evs = (const int16_t*)(sb + (ev_at & 15u));
        const int* mts = (const int*)(sb + A.lay.ev_bytes);
        const int* tgs = (const int*)(sb + A.lay.ev_bytes + A.lay.mt_bytes);
        int* rec = cand + (i & 1) * K * K10_CAND_INTS;
        for (int c = warp; c < K; c += n_warps) {
            int ev[3] = {evs[3 * c], evs[3 * c + 1], evs[3 * c + 2]};
            TT_PROF(0);
            int ns[3], on[3], nr[3], dh, ds;
            tt_sample_move(slots, mts[c], tgs[c], ev, ns, on);
            TT_PROF(12);
            tt_delta_one_bits_warp<WIDE>(pb, slots, rooms, att, occ,
                                         amask, slot_ev, ev, ns, on, lane,
                                         &dh, &ds, nr);
            if (lane == 0) {
                int* o = rec + c * K10_CAND_INTS;
                tt_store_candidate(slots, ev, ns, nr, dh, ds, st,
                                   A.anchor_slots, A.anchor_w, A.anchored,
                                   o);
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
        // the first least (pen, scv), in every warp: each lane keeps its
        // first least; three warp minima then take the least penalty, the
        // least scv among those and the lowest index among those
        int kp = 0x7fffffff, ks = 0x7fffffff, ki = 0x7fffffff;
        for (int c = lane; c < K; c += 32) {
            const int* x = rec + c * K10_CAND_INTS;
            if (k10_lex_lt(x[0], x[2], kp, ks)) {
                kp = x[0];
                ks = x[2];
                ki = c;
            }
        }
        const int mp = __reduce_min_sync(TT_FULL_MASK, kp);
        const int ms = __reduce_min_sync(TT_FULL_MASK,
                                         kp == mp ? ks : 0x7fffffff);
        const int* o = rec + __reduce_min_sync(
            TT_FULL_MASK, kp == mp && ks == ms ? ki : 0x7fffffff)
            * K10_CAND_INTS;
        const bool accept = k10_lex_le(o[0], o[2], h_pen, h_scv)
                            || k10_lex_le(o[0], o[2], st[0], st[2]);
        if (accept) {
            st[0] = o[0];
            st[1] = o[1];
            st[2] = o[2];
        }
        const bool improved = k10_lex_lt(st[0], st[2], best[0], best[2]);
        if (improved) {
            best[0] = st[0];
            best[1] = st[1];
            best[2] = st[2];
        }
        TT_PROF(7);
        // the ring: this step's entry takes the post-decision cost; the
        // next step's entry was written a step or more ago (every read of
        // this one came before the barrier above)
        if (tid == 0) {
            hp[v] = st[0];
            hs[v] = st[2];
        }
        v = v + 1 == Lh ? 0 : v + 1;
        if (Lh == 1) {
            h_pen = st[0];
            h_scv = st[2];
        } else {
            h_pen = hp[v];
            h_scv = hs[v];
        }
        TT_PROF(11);
        if (accept) {
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
            // the apply ends on a barrier
            tt_apply_move_bits_block(pb, mv, slots, rooms, att, occ, amask,
                                     slot_ev);
            TT_PROF(8);
        }
        // the next step's barrier orders this copy before any later apply
        if (improved) {
            for (int e = tid; e < E; e += blockDim.x) {
                bslots[e] = slots[e];
                brooms[e] = rooms[e];
            }
            TT_PROF(13);
        }
        ev_at += ev_stride;
        if (++rc == chunk) {
            rc = 0;
            buf ^= 1;
        }
    }
    __syncthreads();

    // ---- epilogue
    for (int i = tid; i < E; i += blockDim.x) {
        A.slots[re + i] = slots[i];
        A.rooms[re + i] = rooms[i];
        A.best_slots[re + i] = bslots[i];
        A.best_rooms[re + i] = brooms[i];
    }
    if (stage & TT_STAGE_ATT)
        for (int i = tid; i < S * T; i += blockDim.x)
            A.att[(size_t)w * S * T + i] = att[i];
    if (stage & TT_STAGE_OCC)
        for (int i = tid; i < T * R; i += blockDim.x)
            A.occ[(size_t)w * T * R + i] = occ[i];
    if (A.lay.hist_in_smem)
        for (int i = tid; i < Lh; i += blockDim.x) {
            A.hist_pen[(size_t)w * Lh + i] = hp[i];
            A.hist_scv[(size_t)w * Lh + i] = hs[i];
        }
    if (tid == 0) {
        A.pen[w] = st[0]; A.hcv[w] = st[1]; A.scv[w] = st[2];
        A.best_pen[w] = best[0]; A.best_hcv[w] = best[1];
        A.best_scv[w] = best[2];
        A.step[w] = step0 + A.n_steps;
    }
    TT_PROF(10);
}

extern "C" int tt_lahc_smem_bytes(int E, int R, int S, int T, int K, int W,
                                  int Lh) {
    return (int)k10_smem_layout(E, R, S, T, K, W, Lh).total;
}

extern "C" int tt_lahc(
    int* slots, int* rooms, int16_t* att, int16_t* occ, int* pen, int* hcv,
    int* scv, int* hist_pen, int* hist_scv, int* step, int* best_slots,
    int* best_rooms, int* best_pen, int* best_hcv, int* best_scv,
    const int* mtype, const int16_t* events, const int* tgt,
    const uint8_t* possible, const int* live, const int* student_count,
    const uint32_t* conflict_bits, const int* cap_rank, const int* dead,
    const uint8_t* attends, const int* ev_ptr, const int* ev_stu,
    const int* anchor_slots, const int* anchor_w, uint64_t* amask_g,
    int W, int E, int R, int S, int T, int spd, int n_words, int K, int Lh,
    int n_steps, int anchored, int stage, void* stream) {
    stage &= TT_STAGE_ALL;
    const bool glob = stage != TT_STAGE_ALL;
    if (W <= 0 || E < 3 || !tt_rooms_fit(E, R) || T > 64 || spd > 32
        || K <= 0
        || Lh <= 0 || n_steps < 0 || ((uintptr_t)events & 15u)
        || (!(stage & TT_STAGE_AMASK) && !amask_g))
        return (int)cudaErrorInvalidValue;
    K10Smem lay = k10_smem_layout(E, R, S, T, K, n_words, Lh, stage);
    if (lay.total > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    // the instance that chooses among rooms past the first 32, where
    // there are some; the one with regions in global memory chooses
    // among any R
    const auto kernel = glob ? lahc_kernel<true, true>
                        : tt_wide_rooms(R) ? lahc_kernel<true, false>
                                           : lahc_kernel<false, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lay.total);
    if (err != cudaSuccess) return (int)err;
    K10Args A;
    A.pb = {possible, live, student_count, conflict_bits, cap_rank, dead,
            attends, ev_ptr, ev_stu, E, R, S, T, spd, n_words};
    A.anchor_slots = anchor_slots; A.anchor_w = anchor_w;
    A.slots = slots; A.rooms = rooms; A.att = att; A.occ = occ;
    A.pen = pen; A.hcv = hcv; A.scv = scv;
    A.hist_pen = hist_pen; A.hist_scv = hist_scv; A.step = step;
    A.best_slots = best_slots; A.best_rooms = best_rooms;
    A.best_pen = best_pen; A.best_hcv = best_hcv; A.best_scv = best_scv;
    A.mtype = mtype; A.events = events; A.tgt = tgt;
    A.W = W; A.K = K; A.Lh = Lh; A.n_steps = n_steps; A.anchored = anchored;
    A.amask_g = amask_g;
    A.lay = lay;
    int threads = 32 * (K < K10_MAX_WARPS ? K : K10_MAX_WARPS);
    kernel<<<W, threads, lay.total, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}
