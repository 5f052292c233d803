// K8: the random-candidate delta local search of a population, all
// rounds in one launch.
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
// (evaluate, one barrier, a K-way choice, the apply), not bytes: an
// individual's rows and penalty terms are read and written once a call,
// and the draws (K uniforms rows of E floats a round) once.
//
// Design: one block per individual for the whole call, one warp per
// candidate (a warp takes several when K > 16). The prologue loads the
// individual's slots and rooms and, when it fits, the conflict bitset
// into dynamic shared memory, and builds there the maintained att
// (S x T int16, a thread per student over its events) and occ (T x R
// int16, live events only, a thread per slot), which JAX's init_state
// computes on the way in; the penalty terms arrive from K2. A round:
// each warp takes its candidate's events as the top 3 of its uniforms
// (warp argmax, ties to the lower index; rooms_dev.cuh), builds
// sample_move's relocation and scores it with K4's body and the anchor
// terms (sweep_dev.cuh `tt_score_candidate_warp`, which K10 shares);
// thread 0 takes the first candidate of least
// penalty (jnp.argmin) and accepts it when strictly below the current
// one; the block applies it with K5's apply. Nothing goes back to global
// memory until the epilogue, which writes slots, rooms and the penalty
// terms (att and occ die with the block). Integer-exact: equal to the
// plain version (ops/delta.py) bit for bit.
#include "sweep_dev.cuh"
#include "rooms_dev.cuh"

#define K8_MAX_WARPS 16
#define K8_CAND_INTS 12
// block-wide scalars: (pen, hcv, scv) and the 16-int chosen move
#define K8_MISC_INTS 32

struct K8Smem {
    unsigned slots, rooms, cand, misc, occ, att, bits, total;
    int bits_in_smem;
};

__host__ __device__ inline unsigned k8_align(size_t x) {
    return (unsigned)((x + 15) & ~(size_t)15);
}

__host__ __device__ inline K8Smem k8_smem_layout(int E, int R, int S, int T,
                                                 int K, int W) {
    K8Smem m;
    unsigned o = 0;
    m.slots = o; o += k8_align(4 * (size_t)E);
    m.rooms = o; o += k8_align(4 * (size_t)E);
    m.cand = o; o += k8_align(4 * (size_t)K8_CAND_INTS * K);
    m.misc = o; o += k8_align(4 * (size_t)K8_MISC_INTS);
    m.occ = o; o += k8_align(2 * (size_t)T * R);
    m.att = o; o += k8_align(2 * (size_t)S * T);
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
    // rows in, (P, ...)
    const int* slots; const int* rooms; const int* pen; const int* hcv;
    const int* scv;
    // draws: row (round * K + candidate) * P + individual
    const int* mtype; const float* u; const int* tgt;
    // rows out
    int* slots_out; int* rooms_out; int* pen_out; int* hcv_out;
    int* scv_out;
    int P, K, n_rounds, anchored;
    K8Smem lay;
};

__global__ void __launch_bounds__(32 * K8_MAX_WARPS)
random_ls_kernel(K8Args A) {
    extern __shared__ __align__(16) unsigned char k8_smem[];
    const int E = A.pb.E, R = A.pb.R, S = A.pb.S, T = A.pb.T, W = A.pb.W;
    const int p = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    int* slots = (int*)(k8_smem + A.lay.slots);
    int* rooms = (int*)(k8_smem + A.lay.rooms);
    int* cand = (int*)(k8_smem + A.lay.cand);    // K x (pen, hcv, scv,
    //                                              ev[3], ns[3], nr[3])
    int* st = (int*)(k8_smem + A.lay.misc);      // pen, hcv, scv
    int* mv = st + 4;                            // accept, then the move
    int16_t* occ = (int16_t*)(k8_smem + A.lay.occ);
    int16_t* att = (int16_t*)(k8_smem + A.lay.att);
    uint32_t* bits = (uint32_t*)(k8_smem + A.lay.bits);

    const int* g_slots = A.slots + (size_t)p * E;
    const int* g_rooms = A.rooms + (size_t)p * E;
    for (int i = tid; i < E; i += blockDim.x) {
        slots[i] = g_slots[i];
        rooms[i] = g_rooms[i];
    }
    TTSweepProblem pb = A.pb;
    if (A.lay.bits_in_smem) {
        for (int i = tid; i < E * W; i += blockDim.x)
            bits[i] = A.pb.conflict_bits[i];
        pb.conflict_bits = bits;
    }
    if (tid == 0) {
        st[0] = A.pen[p]; st[1] = A.hcv[p]; st[2] = A.scv[p];
    }
    __syncthreads();
    // att[s][t]: student s's attended events in slot t (delta.py
    // attendance_counts); each thread owns its students' rows
    for (int s = tid; s < S; s += blockDim.x) {
        int16_t* row = att + (size_t)s * T;
        for (int t = 0; t < T; ++t) row[t] = 0;
        for (int k = A.stu_ptr[s]; k < A.stu_ptr[s + 1]; ++k) {
            const int e = A.stu_ev[k];
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

    for (int r = 0; r < A.n_rounds; ++r) {
        for (int c = warp; c < A.K; c += n_warps) {
            const size_t row = ((size_t)r * A.K + c) * A.P + p;
            int ev[3], ns[3], on[3];
            tt_top3_warp(A.u + row * E, E, lane, ev);
            tt_sample_move(slots, A.mtype[row], A.tgt[row], ev, ns, on);
            tt_score_candidate_warp(pb, slots, rooms, att, occ, ev, ns, on,
                                    st, A.anchor_slots, A.anchor_w,
                                    A.anchored, lane,
                                    cand + c * K8_CAND_INTS);
        }
        __syncthreads();
        if (tid == 0) {
            int best = 0;
            for (int c = 1; c < A.K; ++c)
                if (cand[c * K8_CAND_INTS] < cand[best * K8_CAND_INTS])
                    best = c;
            const int* o = cand + best * K8_CAND_INTS;
            mv[0] = o[0] < st[0] ? 1 : 0;
            if (mv[0]) {
                tt_move_of_candidate(o, slots, rooms, mv + 1);
                st[0] = o[0]; st[1] = o[1]; st[2] = o[2];
            }
        }
        __syncthreads();
        if (mv[0]) tt_apply_move_block(pb, mv + 1, slots, rooms, att, occ);
        __syncthreads();
    }

    for (int i = tid; i < E; i += blockDim.x) {
        A.slots_out[(size_t)p * E + i] = slots[i];
        A.rooms_out[(size_t)p * E + i] = rooms[i];
    }
    if (tid == 0) {
        A.pen_out[p] = st[0];
        A.hcv_out[p] = st[1];
        A.scv_out[p] = st[2];
    }
}

extern "C" int tt_random_ls_smem_bytes(int E, int R, int S, int T, int K,
                                       int W) {
    return (int)k8_smem_layout(E, R, S, T, K, W).total;
}

extern "C" int tt_random_ls(
    const int* slots, const int* rooms, const int* pen, const int* hcv,
    const int* scv, const int* mtype, const float* u, const int* tgt,
    const uint8_t* possible, const int* live, const int* student_count,
    const uint32_t* conflict_bits, const int* cap_rank, const int* dead,
    const uint8_t* attends, const int* ev_ptr, const int* ev_stu,
    const int* stu_ptr, const int* stu_ev, const int* anchor_slots,
    const int* anchor_w, int* slots_out, int* rooms_out, int* pen_out,
    int* hcv_out, int* scv_out, int P, int E, int R, int S, int T, int spd,
    int W, int K, int n_rounds, int anchored, void* stream) {
    if (P <= 0 || E < 3 || T > 64 || R > 32 || spd > 32 || K <= 0
        || n_rounds < 0)
        return (int)cudaErrorInvalidValue;
    K8Smem lay = k8_smem_layout(E, R, S, T, K, W);
    if (lay.total > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    cudaError_t err = cudaFuncSetAttribute(
        random_ls_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lay.total);
    if (err != cudaSuccess) return (int)err;
    K8Args A;
    A.pb = {possible, live, student_count, conflict_bits, cap_rank, dead,
            attends, ev_ptr, ev_stu, E, R, S, T, spd, W};
    A.anchor_slots = anchor_slots; A.anchor_w = anchor_w;
    A.stu_ptr = stu_ptr; A.stu_ev = stu_ev;
    A.slots = slots; A.rooms = rooms; A.pen = pen; A.hcv = hcv; A.scv = scv;
    A.mtype = mtype; A.u = u; A.tgt = tgt;
    A.slots_out = slots_out; A.rooms_out = rooms_out; A.pen_out = pen_out;
    A.hcv_out = hcv_out; A.scv_out = scv_out;
    A.P = P; A.K = K; A.n_rounds = n_rounds; A.anchored = anchored;
    A.lay = lay;
    int threads = 32 * (K < K8_MAX_WARPS ? K : K8_MAX_WARPS);
    random_ls_kernel<<<P, threads, lay.total, (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}
