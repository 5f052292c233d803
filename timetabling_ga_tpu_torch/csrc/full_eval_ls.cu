// K12: the random-candidate local search by full re-evaluation of a
// population, every round in one launch.
//
// Replaces timetabling_ga_tpu/ops/local_search.py:40 `batch_local_search`
// — a lax.scan of n_rounds rounds, each a lax.map over K candidates: a
// random padded 3-relocation of every individual's current row
// (moves.py `random_move`), scored by a full `fitness.batch_penalty`; the
// first candidate of least penalty (jnp.argmin) is kept where it is
// strictly below the individual's penalty. It is the `--ls-full-eval`
// form of the reference-faithful path: the independent check of K8,
// which scores the same candidates by delta. The port ran each round as
// ~15 launches (K6's relocation entry, K2, the choice in torch), so the
// path was paced by the host.
//
// Bound on this card: the serial chain of n_rounds rounds, each a full
// evaluation of a candidate row (E x W conflict words, the students'
// CSR), not bytes: a row and its terms are read and written once a call,
// the draws once.
//
// Design: a thread-block cluster of CS CTAs (K12_THREADS each) per
// individual, CS = min(K, 8) unless the caller asks for another size,
// launched with cudaLaunchKernelEx. Rank c takes candidates c, c + CS,
// ... of every round. Every CTA holds the individual's current row in
// shared memory for the whole call: slots, rooms, the (T, R) live
// occupancy and the live events' slot bitsets; beside it a candidate copy
// of the four; the per-event problem arrays (live flags, student counts,
// anchors); and, where they fit, the suitable-rooms table (E x R bytes),
// then the conflict bitset and the students' CSR, all staged once by
// cp.async (what does not fit is read from global memory). The
// candidates' events come from K8's pre-pass (random_ls_events,
// (P, n_rounds, K, 3) int16), staged with the move types and targets in
// chunks of rounds, so no top-3 runs on the chain. A candidate: the
// block copies the current row into the copy; warp 0 applies the
// relocation there (rooms_dev.cuh tt_sample_move, tt_relocate_warp) and
// moves the events' bits; then the block scores the
// copy with penalty_dev.cuh's body, from shared memory (cells, events,
// correlation against the slot bitsets, students from the CSR), one block
// reduction. Warp 0 keeps the CTA's first least record (penalty terms,
// candidate index, events, new slots and rooms). Each round ends with one
// cluster exchange: every CTA stores its record into every CTA's inbox
// (distributed shared memory, double-buffered by round parity), one
// cluster barrier, and every thread reads the CS records from its own
// inbox and takes the same first least; on a strict improvement every
// CTA applies it to its own current row (its slots, rooms, occupancy
// and bitsets), so no row is copied between CTAs. Rank 0 writes the final
// row and the penalty terms of its last accepted evaluation (the starting
// terms come from the caller), so the generation needs no K2 after the
// search. Integer-exact: equal to the plain version
// (ops/local_search.py batch_local_search_plain) bit for bit.
// Where the two (T, R) int32 occupancies do not fit (past ~560 rooms at
// E = 400; the wrapper's stage flag, decided from the sizes), the GLOB
// instance keeps them in a global scratch row a CTA, and the grid's
// clusters stride over the individuals, so the scratch is sized by the
// card, not by P.
#include <cooperative_groups.h>

#include "penalty_dev.cuh"
#include "rooms_dev.cuh"

namespace cg = cooperative_groups;

// threads of a CTA (the CPU stand-in builds it small)
#ifndef K12_THREADS
#define K12_THREADS 512
#endif
// the largest cluster (ops/local_search.py K12_MAX_CLUSTER)
#define K12_MAX_CLUSTER 8
// a record: pen, hcv, scv, candidate, ev[3], ns[3], nr[3], then padding
#define K12_REC 16
// shared memory for one chunk of rounds' draws: 3 int16 events, a move
// type and a target slot a candidate (the CPU stand-in builds it small,
// to cross chunks)
#ifndef K12_CHUNK_BYTES
#define K12_CHUNK_BYTES 12288
#endif
// the most shared memory a CTA stages the conflict bitset and the CSR in
// (the CPU stand-in builds it 0, to run the global-memory path)
#ifndef K12_STAGE_LIMIT
#define K12_STAGE_LIMIT TT_SMEM_LIMIT
#endif
// the most shared memory a CTA stages the suitable-rooms table in (the
// CPU stand-in builds it 0, to read the table from global memory)
#ifndef K12_TABLE_LIMIT
#define K12_TABLE_LIMIT TT_SMEM_LIMIT
#endif

struct K12Smem {
    // byte offsets
    unsigned sl, rm, occ, bits_cur, csl, crm, cocc, bits_cand, red, inbox,
        ev, mt, tg, live, count, anc_s, anc_w, possible, conflict, ptr, csr,
        total;
    int chunk_rounds, table_staged, staged;
};

__host__ __device__ inline unsigned k12_align(size_t x) {
    return (unsigned)((x + 15) & ~(size_t)15);
}

// `occ_staged`: the two occupancies in shared memory (else 0 bytes here,
// a global scratch row of 2 T R ints a CTA)
__host__ __device__ inline K12Smem k12_smem_layout(int E, int R, int S,
                                                   int T, int K, int W,
                                                   int nnz,
                                                   int occ_staged = 1) {
    K12Smem m;
    unsigned o = 0;
    m.chunk_rounds = K12_CHUNK_BYTES / (14 * K);
    if (m.chunk_rounds < 1) m.chunk_rounds = 1;
    const size_t n = (size_t)m.chunk_rounds * K;
    const size_t occ = occ_staged ? 4 * (size_t)T * R : 0;
    m.sl = o; o += k12_align(4 * (size_t)E);
    m.rm = o; o += k12_align(4 * (size_t)E);
    m.occ = o; o += k12_align(occ);
    m.bits_cur = o; o += k12_align(4 * (size_t)T * W);
    m.csl = o; o += k12_align(4 * (size_t)E);
    m.crm = o; o += k12_align(4 * (size_t)E);
    m.cocc = o; o += k12_align(occ);
    m.bits_cand = o; o += k12_align(4 * (size_t)T * W);
    m.red = o; o += k12_align(4 * 4 * (size_t)(K12_THREADS / 32));
    m.inbox = o; o += k12_align(4 * 2 * (size_t)K12_MAX_CLUSTER * K12_REC);
    m.ev = o; o += k12_align(2 * 3 * n);
    m.mt = o; o += k12_align(4 * n);
    m.tg = o; o += k12_align(4 * n);
    // the per-event problem arrays the relocation, the evaluation's event
    // terms and the apply read every round
    m.live = o; o += k12_align(4 * (size_t)E);
    m.count = o; o += k12_align(4 * (size_t)E);
    m.anc_s = o; o += k12_align(4 * (size_t)E);
    m.anc_w = o; o += k12_align(4 * (size_t)E);
    // the suitable rooms where they fit (E x R bytes: 160,000 at E = 2000
    // and R = 80, where they do not)
    m.possible = o;
    const unsigned with_table = o + k12_align((size_t)E * R);
    m.table_staged =
        with_table <= K12_TABLE_LIMIT && with_table <= TT_SMEM_LIMIT ? 1 : 0;
    if (m.table_staged) o = with_table;
    m.conflict = o;
    unsigned staged = o + k12_align(4 * (size_t)E * W);
    m.ptr = staged; staged += k12_align(4 * ((size_t)S + 1));
    m.csr = staged; staged += k12_align(4 * (size_t)nnz);
    m.staged = staged <= K12_STAGE_LIMIT && staged <= TT_SMEM_LIMIT ? 1 : 0;
    m.total = m.staged ? staged : o;
    return m;
}

struct K12Args {
    TTPenaltyProblem pp;       // conflict_bits, stu_ptr, stu_ev: global
    const int* cap_rank;       // (R,)
    const int* dead;           // (R,)
    // rows in, (P, ...)
    const int* slots; const int* rooms; const int* pen; const int* hcv;
    const int* scv;
    // draws: row (round * K + candidate) * P + individual
    const int* mtype; const int* tgt;
    const int16_t* events;     // (P, n_rounds, K, 3) from the pre-pass
    // rows out
    int* slots_out; int* rooms_out; int* pen_out; int* hcv_out;
    int* scv_out;
    int P, K, n_rounds, CS, nnz;
    // the GLOB instance's occupancies: 2 T R ints a CTA
    int* scratch;
    K12Smem lay;
};

template <bool GLOB>
__global__ void __launch_bounds__(K12_THREADS) full_eval_ls_kernel(
    K12Args A) {
    extern __shared__ __align__(16) unsigned char k12_smem[];
    cg::cluster_group cl = cg::this_cluster();
    const TTPenaltyProblem& gp = A.pp;
    const int E = gp.E, R = gp.R, S = gp.S, T = gp.T, W = gp.W;
    const int K = A.K, CS = A.CS, chunk = A.lay.chunk_rounds;
    const int rank = CS > 1 ? (int)cl.block_rank() : 0;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    int* sl = (int*)(k12_smem + A.lay.sl);
    int* rm = (int*)(k12_smem + A.lay.rm);
    int* occ = GLOB ? A.scratch + (size_t)blockIdx.x * 2 * T * R
                    : (int*)(k12_smem + A.lay.occ);
    uint32_t* bits = (uint32_t*)(k12_smem + A.lay.bits_cur);
    int* csl = (int*)(k12_smem + A.lay.csl);
    int* crm = (int*)(k12_smem + A.lay.crm);
    int* cocc = GLOB ? occ + T * R : (int*)(k12_smem + A.lay.cocc);
    uint32_t* cbits = (uint32_t*)(k12_smem + A.lay.bits_cand);
    int* red = (int*)(k12_smem + A.lay.red);
    int* inboxes = (int*)(k12_smem + A.lay.inbox);
    int16_t* c_ev = (int16_t*)(k12_smem + A.lay.ev);
    int* c_mt = (int*)(k12_smem + A.lay.mt);
    int* c_tg = (int*)(k12_smem + A.lay.tg);

    TT_PROF_START();
    // individual p, the whole cluster
    auto indiv = [&](const int p) {
    // ---- prologue: the row, the per-event problem arrays, and the
    // conflict bitset and CSR where they fit, in one round trip of
    // cp.async copies
    TTPenaltyProblem pp = gp;
    tt_async_ints(sl, A.slots + (size_t)p * E, E);
    tt_async_ints(rm, A.rooms + (size_t)p * E, E);
    {
        int* live = (int*)(k12_smem + A.lay.live);
        int* count = (int*)(k12_smem + A.lay.count);
        int* anc_s = (int*)(k12_smem + A.lay.anc_s);
        int* anc_w = (int*)(k12_smem + A.lay.anc_w);
        tt_async_ints(live, gp.live, E);
        tt_async_ints(count, gp.student_count, E);
        tt_async_ints(anc_s, gp.anchor_slots, E);
        tt_async_ints(anc_w, gp.anchor_w, E);
        pp.live = live;
        pp.student_count = count;
        pp.anchor_slots = anc_s;
        pp.anchor_w = anc_w;
    }
    if (A.lay.table_staged) {
        uint8_t* possible = k12_smem + A.lay.possible;
        for (int i = tid; i < E * R; i += blockDim.x)
            possible[i] = gp.possible[i];
        pp.possible = possible;
    }
    if (A.lay.staged) {
        int* sc = (int*)(k12_smem + A.lay.conflict);
        int* sp = (int*)(k12_smem + A.lay.ptr);
        int* se = (int*)(k12_smem + A.lay.csr);
        tt_async_ints(sc, (const int*)gp.conflict_bits, E * W);
        tt_async_ints(sp, gp.stu_ptr, S + 1);
        tt_async_ints(se, gp.stu_ev, A.nnz);
        pp.conflict_bits = (const uint32_t*)sc;
        pp.stu_ptr = sp;
        pp.stu_ev = se;
    }
    for (int i = tid; i < T * R; i += blockDim.x) occ[i] = 0;
    for (int i = tid; i < T * W; i += blockDim.x) bits[i] = 0u;
    tt_async_wait();
    __syncthreads();
    // the live occupancy and slot bitsets of the current row
    for (int e = tid; e < E; e += blockDim.x)
        if (pp.live[e]) {
            atomicAdd(&occ[sl[e] * R + rm[e]], 1);
            atomicOr(&bits[sl[e] * W + (e >> 5)], 1u << (e & 31));
        }
    // every thread keeps the individual's (pen, hcv, scv)
    int st[3] = {A.pen[p], A.hcv[p], A.scv[p]};
    const TTRoomProblem rp = {pp.possible, A.cap_rank, A.dead, pp.live, E,
                              R, T};
    const int room_rank = tt_room_rank(rp, lane);
    // every CTA of the cluster runs before the first remote store
    if (CS > 1) cl.sync();
    else __syncthreads();
    TT_PROF(0);

    const int16_t* g_ev = A.events + (size_t)p * A.n_rounds * K * 3;
    for (int r = 0; r < A.n_rounds; ++r) {
        const int rc = r % chunk;
        if (rc == 0) {
            // every read of the previous chunk came before a barrier of
            // the previous round
            const int n = min(chunk, A.n_rounds - r) * K;
            for (int i = tid; i < 3 * n; i += blockDim.x)
                c_ev[i] = g_ev[(size_t)r * K * 3 + i];
            for (int i = tid; i < n; i += blockDim.x) {
                const size_t row = ((size_t)r * K + i) * A.P + p;
                c_mt[i] = A.mtype[row];
                c_tg[i] = A.tgt[row];
            }
            __syncthreads();
            TT_PROF(1);
        }
        // warp 0's first least record of this CTA's candidates
        int b_pen = 0x7fffffff, b_hcv = 0, b_scv = 0, b_c = 0x7fffffff;
        int b_ev[3] = {0, 0, 0}, b_ns[3] = {0, 0, 0}, b_nr[3] = {0, 0, 0};
        for (int c = rank; c < K; c += CS) {
            // ---- the candidate copy of the current row
            for (int i = tid; i < E; i += blockDim.x) {
                csl[i] = sl[i];
                crm[i] = rm[i];
            }
            for (int i = tid; i < T * R; i += blockDim.x) cocc[i] = occ[i];
            for (int i = tid; i < T * W; i += blockDim.x) cbits[i] = bits[i];
            __syncthreads();
            TT_PROF(2);
            // ---- warp 0: the relocation on the copy, and its events'
            // bits moved from their old slots' rows to their new ones'
            int ev[3], ns[3], on[3], nr[3];
            if (warp == 0) {
                const int q = rc * K + c;
                ev[0] = c_ev[3 * q];
                ev[1] = c_ev[3 * q + 1];
                ev[2] = c_ev[3 * q + 2];
                int os[3];
#pragma unroll
                for (int m = 0; m < 3; ++m) os[m] = sl[ev[m]];
                tt_sample_move(csl, c_mt[q], c_tg[q], ev, ns, on);
                tt_relocate_warp(rp, csl, crm, cocc, ev, ns, on, lane,
                                 room_rank);
#pragma unroll
                for (int m = 0; m < 3; ++m) nr[m] = crm[ev[m]];
                // lane m moves event m's bit (two events may share a word)
                if (lane < 3) {
                    const int e = ev[lane];
                    if (pp.live[e]) {
                        const int w = e >> 5;
                        const uint32_t b = 1u << (e & 31);
                        atomicAnd(&cbits[os[lane] * W + w], ~b);
                        atomicOr(&cbits[ns[lane] * W + w], b);
                    }
                }
            }
            __syncthreads();
            TT_PROF(3);
            // ---- the full evaluation of the copy
            TTPenAcc acc = tt_pen_zero();
            tt_pen_cells(cocc, 0, T * R, acc);
            tt_pen_events(pp, csl, crm, 0, E, acc);
            TT_PROF(4);
            tt_pen_corr(pp, csl, pp.conflict_bits, pp.live, cbits, nullptr,
                        0, E, acc);
            TT_PROF(5);
            tt_pen_students_csr(pp, csl, pp.stu_ptr, pp.stu_ev, 0, S, acc);
            TT_PROF(6);
            TT_PROF_BARRIER();
            TT_PROF(7);
            acc = tt_pen_block_reduce(acc, red);
            if (warp == 0) {
                int c_pen, c_hcv, c_scv;
                tt_pen_finish(pp, acc, &c_pen, &c_hcv, &c_scv);
                // this CTA's candidates come in increasing order: strict
                // keeps the first least
                if (c_pen < b_pen) {
                    b_pen = c_pen;
                    b_hcv = c_hcv;
                    b_scv = c_scv;
                    b_c = c;
#pragma unroll
                    for (int m = 0; m < 3; ++m) {
                        b_ev[m] = ev[m];
                        b_ns[m] = ns[m];
                        b_nr[m] = nr[m];
                    }
                }
            }
            TT_PROF(8);
        }
        // ---- the cluster exchange: lane 0 writes the CTA's record into
        // its own inbox, warp 0 copies it into the other CTAs'
        int* inbox = inboxes + (r & 1) * K12_MAX_CLUSTER * K12_REC;
        if (warp == 0) {
            int* mine = inbox + rank * K12_REC;
            if (lane == 0) {
                mine[0] = b_pen;
                mine[1] = b_hcv;
                mine[2] = b_scv;
                mine[3] = b_c;
                for (int m = 0; m < 3; ++m) {
                    mine[4 + m] = b_ev[m];
                    mine[7 + m] = b_ns[m];
                    mine[10 + m] = b_nr[m];
                }
            }
            __syncwarp();
            const int f = lane & 15;
            for (int q = lane >> 4; q < CS; q += 2)
                if (q != rank)
                    cl.map_shared_rank(inbox, (unsigned)q)[rank * K12_REC + f] =
                        mine[f];
        }
        if (CS > 1) cl.sync();
        else __syncthreads();
        TT_PROF(9);
        // ---- the first candidate of least penalty, in every thread
        int key = 0x7fffffff, idx = 0x7fffffff;
        if (lane < CS) {
            key = inbox[lane * K12_REC];
            idx = inbox[lane * K12_REC + 3];
        }
        const int* o = inbox + (tt_warp_argmin(key, idx) % CS) * K12_REC;
        TT_PROF(10);
        if (o[0] < st[0]) {
            st[0] = o[0];
            st[1] = o[1];
            st[2] = o[2];
            if (tid < 3) {
                // thread m moves event m: a live event leaves its cell and
                // slot row and enters the new ones (an inactive entry
                // keeps both); two events may share a cell or a word
                const int e = o[4 + tid], s_new = o[7 + tid];
                const int r_new = o[10 + tid];
                if (pp.live[e]) {
                    const uint32_t b = 1u << (e & 31);
                    atomicAdd(&occ[sl[e] * R + rm[e]], -1);
                    atomicAnd(&bits[sl[e] * W + (e >> 5)], ~b);
                    atomicAdd(&occ[s_new * R + r_new], 1);
                    atomicOr(&bits[s_new * W + (e >> 5)], b);
                }
                sl[e] = s_new;
                rm[e] = r_new;
            }
            __syncthreads();
            TT_PROF(11);
        }
    }

    // ---- epilogue: rank 0 writes the row and its terms (the last apply
    // ended on a barrier)
    if (rank == 0) {
        for (int i = tid; i < E; i += blockDim.x) {
            A.slots_out[(size_t)p * E + i] = sl[i];
            A.rooms_out[(size_t)p * E + i] = rm[i];
        }
        if (tid == 0) {
            A.pen_out[p] = st[0];
            A.hcv_out[p] = st[1];
            A.scv_out[p] = st[2];
        }
    }
    TT_PROF(12);
    };
    if (!GLOB) {
        // a cluster an individual
        indiv(blockIdx.x / CS);
        return;
    }
    // the clusters stride over the individuals; a cluster barrier ends
    // each, so no CTA stores into an inbox another still reads, nor
    // restages what another still reads
    for (int p = blockIdx.x / CS; p < A.P; p += gridDim.x / CS) {
        indiv(p);
        if (CS > 1) cl.sync();
        else __syncthreads();
    }
}

extern "C" int tt_full_eval_ls_smem_bytes(int E, int R, int S, int T, int K,
                                          int W, int nnz) {
    return (int)k12_smem_layout(E, R, S, T, K, W, nnz).total;
}

extern "C" int tt_full_eval_ls(
    const int* slots, const int* rooms, const int* pen, const int* hcv,
    const int* scv, const int* mtype, const int16_t* events, const int* tgt,
    const uint8_t* possible, const int* cap_rank, const int* dead,
    const int* live, const int* student_count,
    const uint32_t* conflict_bits, const int* stu_ptr, const int* stu_ev,
    const int* anchor_slots, const int* anchor_w, int* slots_out,
    int* rooms_out, int* pen_out, int* hcv_out, int* scv_out, int* scratch,
    int P, int E,
    int R, int S, int T, int spd, int W, int K, int n_rounds, int nnz,
    int diag, int cluster, int stage, int grid, void* stream) {
    // stage bit 0: the occupancies staged; else `scratch` holds them, 2 T
    // R ints for each of the `grid` clusters' CTAs
    const bool glob = !(stage & 1);
    if (P <= 0 || E < 3 || !tt_rooms_fit(E, R) || T > 64 || spd > 32
        || K <= 0
        || n_rounds < 0 || cluster < 1 || cluster > K12_MAX_CLUSTER
        || cluster > K || (glob && (!scratch || grid <= 0)))
        return (int)cudaErrorInvalidValue;
    const K12Smem lay = k12_smem_layout(E, R, S, T, K, W, nnz, !glob);
    if (lay.total > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    const auto kernel = glob ? full_eval_ls_kernel<true>
                             : full_eval_ls_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lay.total);
    if (err != cudaSuccess) return (int)err;
    K12Args A;
    A.pp = {possible, live, student_count, conflict_bits, stu_ptr, stu_ev,
            anchor_slots, anchor_w, E, R, S, T, spd, W, diag};
    A.cap_rank = cap_rank; A.dead = dead;
    A.slots = slots; A.rooms = rooms; A.pen = pen; A.hcv = hcv; A.scv = scv;
    A.mtype = mtype; A.tgt = tgt; A.events = events;
    A.slots_out = slots_out; A.rooms_out = rooms_out; A.pen_out = pen_out;
    A.hcv_out = hcv_out; A.scv_out = scv_out;
    A.P = P; A.K = K; A.n_rounds = n_rounds; A.CS = cluster; A.nnz = nnz;
    A.scratch = scratch;
    A.lay = lay;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((glob ? grid : P) * cluster, 1, 1);
    cfg.blockDim = dim3(K12_THREADS, 1, 1);
    cfg.dynamicSmemBytes = lay.total;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cluster > 1) {
        // a cluster the card cannot place is refused, never shrunk
        int n_clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (n_clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    }
    err = cudaLaunchKernelEx(&cfg, kernel, A);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
