// K10: Late-Acceptance Hill Climbing walkers, every step of a launch in
// one launch.
//
// Replaces timetabling_ga_tpu/ops/lahc.py:106 `lahc_steps` (and the
// state :89 `init_lahc` builds), run by parallel/islands.py:899
// `make_lahc_runners` in the --post-lahc endgame. XLA runs a step as a
// vmap over walkers of K sample_move + _delta_one candidates, a lexsort
// and _apply_move, a fori_loop of steps.
//
// Bound on this card: the serial chain of steps (K candidates scored,
// one barrier, the choice and the acceptance on one thread, the apply),
// not bytes: a walker's state is read and written once a launch and its
// draws (K uniform rows of E floats a step) once.
//
// Design: K8's (random_ls.cu), one block per walker for every step of
// the launch, one warp per candidate (a warp takes several when K > 16).
// The walker's slots, rooms, att and occ, the two bitsets K5 keeps
// (amask: a student's attended slots as one u64; slot_ev: each slot's
// events as W words; built in the prologue, sweep_dev.cuh), its
// best-so-far slots and rooms and, when it fits, the conflict bitset
// stay in shared memory (~51 KB at comp01s, K = 16). A step: each warp
// takes its candidate's events as the top 3 of its uniforms, builds
// sample_move's relocation and scores it (sweep_dev.cuh
// `tt_score_candidate_bits_warp`: K5's K4 body on the bitsets and the
// anchor residual); thread 0 then
//   - takes the block's lexicographic argmin over (pen, scv), the first
//     candidate on a tie (jnp.lexsort((cs, cp))[0]);
//   - accepts it when (pen, scv) <= hist[step % Lh] or <= the current
//     cost, both lexicographic and non-strict;
//   - writes the post-decision current cost into hist[step % Lh] (the
//     two history rings stay in global memory, one entry read and
//     written a step) and advances the step;
//   - moves the best snapshot on a strict lexicographic improvement;
// and the block applies an accepted move with K5's apply, which keeps
// the bitsets. The state goes back to global memory in the epilogue, for
// the next launch (the bitsets die with the block).
// Integer-exact: equal to the plain version (ops/lahc.py) bit for bit.
#include "sweep_dev.cuh"
#include "rooms_dev.cuh"

#define K10_MAX_WARPS 16
#define K10_CAND_INTS 12
// block-wide scalars: (pen, hcv, scv), accept + the 15-int move,
// improved, (best pen, hcv, scv), step
#define K10_MISC_INTS 32

struct K10Smem {
    unsigned slots, rooms, best_slots, best_rooms, cand, misc, amask,
        slot_ev, occ, att, bits, total;
    int bits_in_smem;
};

__host__ __device__ inline unsigned k10_align(size_t x) {
    return (unsigned)((x + 15) & ~(size_t)15);
}

__host__ __device__ inline K10Smem k10_smem_layout(int E, int R, int S,
                                                   int T, int K, int W) {
    K10Smem m;
    unsigned o = 0;
    m.slots = o; o += k10_align(4 * (size_t)E);
    m.rooms = o; o += k10_align(4 * (size_t)E);
    m.best_slots = o; o += k10_align(4 * (size_t)E);
    m.best_rooms = o; o += k10_align(4 * (size_t)E);
    m.cand = o; o += k10_align(4 * (size_t)K10_CAND_INTS * K);
    m.misc = o; o += k10_align(4 * (size_t)K10_MISC_INTS);
    m.amask = o; o += k10_align(8 * (size_t)S);
    m.slot_ev = o; o += k10_align(4 * (size_t)T * W);
    m.occ = o; o += k10_align(2 * (size_t)T * R);
    m.att = o; o += k10_align(2 * (size_t)S * T);
    m.bits = o;
    unsigned with_bits = o + k10_align(4 * (size_t)E * W);
    m.bits_in_smem = with_bits <= TT_SMEM_LIMIT ? 1 : 0;
    m.total = m.bits_in_smem ? with_bits : o;
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
    const int* mtype; const float* u; const int* tgt;
    int W, K, Lh, n_steps, anchored;
    K10Smem lay;
};

__device__ __forceinline__ bool k10_lex_le(int pa, int sa, int pb, int sb) {
    return pa < pb || (pa == pb && sa <= sb);
}

__device__ __forceinline__ bool k10_lex_lt(int pa, int sa, int pb, int sb) {
    return pa < pb || (pa == pb && sa < sb);
}

__global__ void __launch_bounds__(32 * K10_MAX_WARPS) lahc_kernel(K10Args A) {
    extern __shared__ __align__(16) unsigned char k10_smem[];
    const int E = A.pb.E, R = A.pb.R, S = A.pb.S, T = A.pb.T, W = A.pb.W;
    const int w = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    int* slots = (int*)(k10_smem + A.lay.slots);
    int* rooms = (int*)(k10_smem + A.lay.rooms);
    int* bslots = (int*)(k10_smem + A.lay.best_slots);
    int* brooms = (int*)(k10_smem + A.lay.best_rooms);
    int* cand = (int*)(k10_smem + A.lay.cand);
    int* st = (int*)(k10_smem + A.lay.misc);     // pen, hcv, scv
    int* mv = st + 4;                            // accept, then the move
    int* flag = mv + 16;                         // improved
    int* best = flag + 1;                        // pen, hcv, scv
    int* stp = best + 3;                         // step
    uint64_t* amask = (uint64_t*)(k10_smem + A.lay.amask);
    uint32_t* slot_ev = (uint32_t*)(k10_smem + A.lay.slot_ev);
    int16_t* occ = (int16_t*)(k10_smem + A.lay.occ);
    int16_t* att = (int16_t*)(k10_smem + A.lay.att);
    uint32_t* bits = (uint32_t*)(k10_smem + A.lay.bits);

    const size_t re = (size_t)w * E;
    for (int i = tid; i < E; i += blockDim.x) {
        slots[i] = A.slots[re + i];
        rooms[i] = A.rooms[re + i];
        bslots[i] = A.best_slots[re + i];
        brooms[i] = A.best_rooms[re + i];
    }
    for (int i = tid; i < S * T; i += blockDim.x)
        att[i] = A.att[(size_t)w * S * T + i];
    for (int i = tid; i < T * R; i += blockDim.x)
        occ[i] = A.occ[(size_t)w * T * R + i];
    TTSweepProblem pb = A.pb;
    if (A.lay.bits_in_smem) {
        for (int i = tid; i < E * W; i += blockDim.x)
            bits[i] = A.pb.conflict_bits[i];
        pb.conflict_bits = bits;
    }
    if (tid == 0) {
        st[0] = A.pen[w]; st[1] = A.hcv[w]; st[2] = A.scv[w];
        best[0] = A.best_pen[w]; best[1] = A.best_hcv[w];
        best[2] = A.best_scv[w];
        stp[0] = A.step[w];
    }
    int* hp = A.hist_pen + (size_t)w * A.Lh;
    int* hs = A.hist_scv + (size_t)w * A.Lh;
    __syncthreads();
    tt_build_bitsets_block(pb, slots, att, amask, slot_ev);
    __syncthreads();

    for (int i = 0; i < A.n_steps; ++i) {
        for (int c = warp; c < A.K; c += n_warps) {
            const size_t row = ((size_t)i * A.W + w) * A.K + c;
            int ev[3], ns[3], on[3];
            tt_top3_warp(A.u + row * E, E, lane, ev);
            tt_sample_move(slots, A.mtype[row], A.tgt[row], ev, ns, on);
            tt_score_candidate_bits_warp(pb, slots, rooms, att, occ, amask,
                                         slot_ev, ev, ns, on, st,
                                         A.anchor_slots, A.anchor_w,
                                         A.anchored, lane,
                                         cand + c * K10_CAND_INTS);
        }
        __syncthreads();
        if (tid == 0) {
            int b = 0;
            for (int c = 1; c < A.K; ++c) {
                const int* x = cand + c * K10_CAND_INTS;
                const int* y = cand + b * K10_CAND_INTS;
                if (k10_lex_lt(x[0], x[2], y[0], y[2])) b = c;
            }
            const int* o = cand + b * K10_CAND_INTS;
            const int v = stp[0] % A.Lh;
            mv[0] = (k10_lex_le(o[0], o[2], hp[v], hs[v])
                     || k10_lex_le(o[0], o[2], st[0], st[2])) ? 1 : 0;
            if (mv[0]) {
                tt_move_of_candidate(o, slots, rooms, mv + 1);
                st[0] = o[0]; st[1] = o[1]; st[2] = o[2];
            }
            hp[v] = st[0];
            hs[v] = st[2];
            stp[0] += 1;
            flag[0] = k10_lex_lt(st[0], st[2], best[0], best[2]) ? 1 : 0;
            if (flag[0]) {
                best[0] = st[0]; best[1] = st[1]; best[2] = st[2];
            }
        }
        __syncthreads();
        // the apply ends on a barrier; without one, the barrier above
        // orders the copy after the flag's write
        if (mv[0])
            tt_apply_move_bits_block(pb, mv + 1, slots, rooms, att, occ,
                                     amask, slot_ev);
        // the next step's barrier orders this copy before any later apply
        if (flag[0])
            for (int e = tid; e < E; e += blockDim.x) {
                bslots[e] = slots[e];
                brooms[e] = rooms[e];
            }
    }
    __syncthreads();

    for (int i = tid; i < E; i += blockDim.x) {
        A.slots[re + i] = slots[i];
        A.rooms[re + i] = rooms[i];
        A.best_slots[re + i] = bslots[i];
        A.best_rooms[re + i] = brooms[i];
    }
    for (int i = tid; i < S * T; i += blockDim.x)
        A.att[(size_t)w * S * T + i] = att[i];
    for (int i = tid; i < T * R; i += blockDim.x)
        A.occ[(size_t)w * T * R + i] = occ[i];
    if (tid == 0) {
        A.pen[w] = st[0]; A.hcv[w] = st[1]; A.scv[w] = st[2];
        A.best_pen[w] = best[0]; A.best_hcv[w] = best[1];
        A.best_scv[w] = best[2];
        A.step[w] = stp[0];
    }
}

extern "C" int tt_lahc_smem_bytes(int E, int R, int S, int T, int K,
                                  int W) {
    return (int)k10_smem_layout(E, R, S, T, K, W).total;
}

extern "C" int tt_lahc(
    int* slots, int* rooms, int16_t* att, int16_t* occ, int* pen, int* hcv,
    int* scv, int* hist_pen, int* hist_scv, int* step, int* best_slots,
    int* best_rooms, int* best_pen, int* best_hcv, int* best_scv,
    const int* mtype, const float* u, const int* tgt,
    const uint8_t* possible, const int* live, const int* student_count,
    const uint32_t* conflict_bits, const int* cap_rank, const int* dead,
    const uint8_t* attends, const int* ev_ptr, const int* ev_stu,
    const int* anchor_slots, const int* anchor_w, int W, int E, int R,
    int S, int T, int spd, int n_words, int K, int Lh, int n_steps,
    int anchored, void* stream) {
    if (W <= 0 || E < 3 || T > 64 || R > 32 || spd > 32 || K <= 0
        || Lh <= 0 || n_steps < 0)
        return (int)cudaErrorInvalidValue;
    K10Smem lay = k10_smem_layout(E, R, S, T, K, n_words);
    if (lay.total > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    cudaError_t err = cudaFuncSetAttribute(
        lahc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
    A.mtype = mtype; A.u = u; A.tgt = tgt;
    A.W = W; A.K = K; A.Lh = Lh; A.n_steps = n_steps; A.anchored = anchored;
    A.lay = lay;
    int threads = 32 * (K < K10_MAX_WARPS ? K : K10_MAX_WARPS);
    lahc_kernel<<<W, threads, lay.total, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}
