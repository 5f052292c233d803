// K5: one whole sweep pass for every individual, in one launch.
//
// Replaces timetabling_ga_tpu/ops/sweep.py:230-591 `sweep_pass` — the
// lax.scan of n_steps = ceil(K/B) steps, each delta-evaluating B pivots'
// Move1 (all T slots), Move2 (SB partners) and Move3 (2(SB-1) 3-cycles)
// candidates, taking the lexicographic (penalty, scv) best with the
// sideways drift/descent mix and applying it — together with its hot
// pivot pick, sweep.py:173-226 `event_heat` plus the `lax.top_k` at
// :322. Before this kernel the port ran each step as ~130 launches: K3
// (move1_sweep.cu) and K4 (delta_one.cu) plus the plain-torch step body.
//
// Bound on this card: the serial chain of n_steps steps, each a handful
// of barrier-separated phases (evaluate, the reductions, apply), not
// bytes: one individual's state is ~51 KB at comp scale and is read and
// written once per pass.
//
// Design: a thread-block cluster of CS CTAs (512 threads each) per
// individual, launched with cudaLaunchKernelEx. Every CTA of a cluster
// loads the individual's slots, rooms, att (S x T int16) and occ (T x R
// int16), and the conflict bitset when it fits, into its own dynamic
// shared memory (from L2 after the first), and builds two bitsets there
// (sweep_dev.cuh): amask, a student's attended slots as one u64, and
// slot_ev, each slot's events as W words. It builds the pivots: the
// affine permutation (a*j + b) mod E, or in hot mode the event heat in
// integers, made float32 as fadd_rn(fmul_rn(heat, mask), noise) (no FMA
// contraction, as torch computes it) and ranked by counting (value
// descending, lower index first on ties: the stable sort's and
// lax.top_k's order). Each step splits the candidates over the cluster:
// block pivot b's Move1 (K3's body, a thread per target slot) goes to
// the CTA of rank b mod CS, and the Move2/Move3 candidates to the
// cluster's CS x 16 warps, one warp each (K4's body on the bitsets). Each
// CTA reduces its own candidates to the lexicographic (pen, scv, index)
// min and publishes it, with the winner's hcv and packed rooms, in its
// shared memory; after a cluster barrier every warp reads the CS records
// through distributed shared memory and reduces them (with sideways, a
// second such round takes the argmax of the tie noise, lowest index on
// ties). Both orders are total, so the winner does not depend on CS. The
// records are double-buffered by step parity: a CTA writes step pos+2's
// record only after the cluster barrier of step pos+1, which every CTA
// reaches after reading step pos's. Every CTA then applies the same move
// to its own copy (keeping att, occ and both bitsets), so the copies
// never diverge; rank 0 writes the epilogue and the pivots. A last
// cluster barrier keeps every CTA's shared memory alive until no other
// reads it. All arithmetic is integer-exact and equals sweep_pass_plain
// (ops/sweep.py) bit for bit. With `ops` (the quality telemetry,
// sweep.py:567-589 return_ops), thread 0 also counts each accepted move
// (sideways accepts too) by the block its candidate index falls in,
// Move1 | Move2 | Move3, in registers, and rank 0 writes ops_out = ops_in
// + those counts a row; without it nothing more is done.
// Past shared memory (the wrapper's stage mask, decided from the sizes:
// att goes to global memory first, then amask, then occ; the bitset body
// reads att only for the <= 6 slots a move touches), the GLOB instance
// keeps a region in one copy an individual: att and occ in its own
// att_out and occ_out rows (rank 0 copies the input there first), amask
// in its scratch row. Only rank 0 writes such a region, in the apply;
// every CTA still moves its own slots, rooms, slot_ev and staged
// regions, and a CTA whose amask is its own but whose att is rank 0's
// recomputes the moved students' bits from att after the apply. A
// cluster barrier follows the apply (a release and an acquire at
// cluster scope), so no CTA reads step pos+1's state before rank 0 has
// written step pos's; rank 0 writes step pos+1's only after the barrier
// of its choice, which every CTA reaches after its reads of step pos+1.
#include <cooperative_groups.h>

#include "sweep_dev.cuh"

namespace cg = cooperative_groups;

// threads of one CTA; a build may ask for fewer (any multiple of 32 of at
// least T), as the CPU emulation in tests/test_torch_cuda_emu.py does
#ifndef K5_THREADS
#define K5_THREADS 512
#endif
#define K5_WARPS (K5_THREADS / 32)
// the largest portable cluster (ops/sweep.py K5_MAX_CLUSTER)
#define K5_MAX_CLUSTER 8
#define K5_BIG (1 << 20)
#define K5_INT_MAX 0x7fffffff
// per-step cluster records, two of each for the parity double buffer:
// (pen, scv, idx, hcv | rooms hi, rooms lo) of the lexicographic min and
// (noise, idx, pen, scv, hcv | rooms hi, rooms lo) of the tie argmax
#define K5_LEX_REC 5
#define K5_ARG_REC 6
// block-wide scalars: the Move1 accumulator and the row's (pen, hcv, scv,
// strict), 3 + 2 reduction ints per warp, the 16-int chosen move, the
// cluster records; the Python side mirrors the 128 in ops/sweep.py
// _K5_MISC_INTS
#define K5_MISC_INTS 128
// the stage mask's bit of the Move1 masks (beside sweep_dev.cuh's
// TT_STAGE_*: occ, amask, att)
#define K5_STAGE_MASKS 8
#define K5_MISC_MV (8 + 5 * K5_WARPS)
#define K5_MISC_LEX (K5_MISC_MV + 16)
#define K5_MISC_ARG (K5_MISC_LEX + 2 * K5_LEX_REC)
static_assert(K5_MISC_ARG + 2 * K5_ARG_REC <= K5_MISC_INTS,
              "K5's misc region is too small for its warps");

// Byte offsets of the shared-memory regions; the Python side mirrors it
// in ops/sweep.py sweep_pass_smem_bytes.
struct K5Smem {
    unsigned slots, rooms, piv, heat, cand, per_slot, misc, masks, amask,
        slot_ev, occ, att, bits, total;
    int bits_in_smem, stage;
};

__host__ __device__ inline unsigned k5_align(size_t x) {
    return (unsigned)((x + 15) & ~(size_t)15);
}

__host__ __device__ inline K5Smem k5_smem_layout(
    int E, int R, int S, int T, int K, int n_cand, int use_hot,
    int max_students, int W,
    int stage = TT_STAGE_ALL | K5_STAGE_MASKS) {
    K5Smem m;
    unsigned o = 0;
    m.stage = stage;
    m.slots = o; o += k5_align(4 * (size_t)E);
    m.rooms = o; o += k5_align(4 * (size_t)E);
    m.piv = o; o += k5_align(4 * (size_t)K);
    m.heat = o; o += use_hot ? k5_align(4 * (size_t)E) : 0;
    m.cand = o; o += k5_align(16 * (size_t)n_cand);
    m.per_slot = o; o += k5_align(4 * (size_t)T);
    m.misc = o; o += k5_align(4 * (size_t)K5_MISC_INTS);
    // the Move1 scratch: a pivot's students' masks (where they do not
    // fit, a global row a CTA)
    m.masks = o;
    o += (stage & K5_STAGE_MASKS)
             ? k5_align(8 * (size_t)(max_students > 0 ? max_students : 1))
             : 0;
    m.amask = o;
    o += (stage & TT_STAGE_AMASK) ? k5_align(8 * (size_t)S) : 0;
    m.slot_ev = o; o += k5_align(4 * (size_t)T * W);
    m.occ = o;
    o += (stage & TT_STAGE_OCC) ? k5_align(2 * (size_t)T * R) : 0;
    m.att = o;
    o += (stage & TT_STAGE_ATT) ? k5_align(2 * (size_t)S * T) : 0;
    m.bits = o;
    unsigned with_bits = o + k5_align(4 * (size_t)E * W);
    m.bits_in_smem = with_bits <= TT_SMEM_LIMIT ? 1 : 0;
    m.total = m.bits_in_smem ? with_bits : o;
    return m;
}

struct K5Args {
    TTSweepProblem pb;             // conflict_bits: the global copy
    const float* event_mask;       // (E,)
    const int* anchor_slots;       // (E,)
    const int* anchor_w;           // (E,)
    // state in, (P, ...)
    const int* slots; const int* rooms; const int16_t* att;
    const int16_t* occ; const int* pen; const int* hcv; const int* scv;
    // draws
    const int* a; const int* b;    // (P,)
    const float* hot_noise;        // (P, E), hot mode
    const float* tie_noise;        // (n_steps, P, n_cand), sideways
    const uint8_t* allow;          // (n_steps, P), sideways
    // state out, strict_rows (P,) and pivots (P, K)
    int* slots_out; int* rooms_out; int16_t* att_out; int16_t* occ_out;
    int* pen_out; int* hcv_out; int* scv_out; uint8_t* strict_out;
    int* pivots_out;
    // accepted moves by kind (P, 3): ops_out = ops_in + this pass's, or
    // null (no counting)
    const int* ops_in; int* ops_out;
    // the individuals' amask rows where it is not staged (S u64 each),
    // and the CTAs' Move1 masks rows where they are not (max_students
    // u64 each)
    uint64_t* amask_g;
    uint64_t* masks_g;
    int max_students;
    int P, K, B, SB, n_steps, n_cand, use_hot, sideways, anchored, CS;
    K5Smem lay;
};

__device__ __forceinline__ int k5_base_penalty(int hcv, int scv) {
    return hcv == 0 ? scv : TT_INFEASIBLE_OFFSET + hcv;
}

__device__ __forceinline__ int k5_perm(int a, int b, int j, int E) {
    return (a * j + b) % E;
}

// Events, new slots and active flags of candidate `c` of step `pos`, in
// the plain version's concatenation order: Move1 (b, t) | Move2 (b, k) |
// Move3 (orientation, b, k). `invalid` marks a Move2/Move3 candidate
// whose events collide (masked to BIG, sweep.py:408-417, :454).
__device__ __forceinline__ void k5_candidate(
    const K5Args& A, int perm_a, int perm_b, const int* piv,
    const int* slots, int pos, int c, int ev[3], int ns[3], int on[3],
    int* invalid) {
    const int E = A.pb.E, T = A.pb.T, B = A.B, SB = A.SB;
    const int n1 = B * T, n2 = B * SB;
    *invalid = 0;
    if (c < n1) {
        int b = c / T, t = c % T;
        int e = piv[(pos * B + b) % A.K];
        ev[0] = e; ev[1] = (e + 1) % E; ev[2] = (e + 2) % E;
        ns[0] = t; ns[1] = slots[ev[1]]; ns[2] = slots[ev[2]];
        on[0] = 1; on[1] = 0; on[2] = 0;
        return;
    }
    if (c < n1 + n2) {
        int b = (c - n1) / SB, k = (c - n1) % SB;
        int e = piv[(pos * B + b) % A.K];
        int q = k5_perm(perm_a, perm_b, (pos * B + 1 + b + k) % E, E);
        int pad = (e + 1) % E;
        if (pad == q) pad = (e + 2) % E;
        ev[0] = e; ev[1] = q; ev[2] = pad;
        ns[0] = slots[q]; ns[1] = slots[e]; ns[2] = slots[pad];
        on[0] = 1; on[1] = 1; on[2] = 0;
        *invalid = q == e;
        return;
    }
    int c3 = c - n1 - n2, nb = B * (SB - 1);
    int o = c3 / nb, rem = c3 % nb;
    int b = rem / (SB - 1), k = rem % (SB - 1);
    int e = piv[(pos * B + b) % A.K];
    int j = pos * B + 1 + b + k;
    int q1 = k5_perm(perm_a, perm_b, j % E, E);
    int q2 = k5_perm(perm_a, perm_b, (j + 1) % E, E);
    ev[0] = e; ev[1] = q1; ev[2] = q2;
    if (o == 0) {
        ns[0] = slots[q1]; ns[1] = slots[q2]; ns[2] = slots[e];
    } else {
        ns[0] = slots[q2]; ns[1] = slots[e]; ns[2] = slots[q1];
    }
    on[0] = 1; on[1] = 1; on[2] = 1;
    *invalid = q1 == e || q2 == e || q1 == q2;
}

// The rank of the CTA that evaluates candidate `c`: block pivot b's
// Move1 targets go to rank b mod CS, Move2/Move3 candidate n1 + g to the
// cluster's warp g mod (CS x 16), which is warp g mod 16 of rank
// (g / 16) mod CS.
__device__ __forceinline__ int k5_owner(int c, int n1, int T, int CS) {
    return c < n1 ? (c / T) % CS : ((c - n1) / K5_WARPS) % CS;
}

// A candidate's hcv and three new rooms in 64 bits, any R < 4096 (12
// bits a room): lo = nr0 | nr1 << 12 | (nr2 & 255) << 24, hi = hcv << 4
// | nr2 >> 8. hcv stays below 2^25 for E < 4096 (at most E(E-1)/2 clash
// pairs and as many correlated pairs, the events, and K5_BIG on a
// masked candidate), so hi never overflows.
__device__ __forceinline__ int k5_pack_hi(int hcv, int nr2) {
    return (hcv << 4) | (nr2 >> 8);
}

__device__ __forceinline__ int k5_pack_lo(int nr0, int nr1, int nr2) {
    return (int)((unsigned)nr0 | (unsigned)nr1 << 12
                 | ((unsigned)nr2 & 255u) << 24);
}

__device__ __forceinline__ int k5_unpack_room(int hi, int lo, int m) {
    const unsigned u = (unsigned)lo;
    return m == 0 ? (int)(u & 4095u)
         : m == 1 ? (int)((u >> 12) & 4095u)
                  : (int)((u >> 24) | ((unsigned)hi & 15u) << 8);
}

// New (pen, scv) and the packed hcv and rooms of candidate `c`; `st`
// holds the individual's (pen, hcv, scv). The anchor residual and the
// candidate's anchor delta enter only on anchored instances, as in the
// plain version.
__device__ __forceinline__ void k5_store(
    const K5Args& A, const int* st, const int* slots, int c, int dh, int ds,
    const int ev[3], const int ns[3], int nr0, int nr1, int nr2,
    int* c_pen, int* c_scv, int* c_hi, int* c_lo) {
    int hcv = st[1] + dh, scv = st[2] + ds;
    int pen = k5_base_penalty(hcv, scv);
    if (A.anchored) {
        int da = 0;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            int anc = A.anchor_slots[ev[m]];
            da += A.anchor_w[ev[m]] * ((ns[m] != anc ? 1 : 0)
                                       - (slots[ev[m]] != anc ? 1 : 0));
        }
        pen += st[0] - k5_base_penalty(st[1], st[2]) + da;
    }
    c_pen[c] = pen;
    c_scv[c] = scv;
    c_hi[c] = k5_pack_hi(hcv, nr2);
    c_lo[c] = k5_pack_lo(nr0, nr1, nr2);
}

// Event heat (sweep.py:173): while infeasible the clash count of e's
// cell + its unsuitable flag + correlated events sharing its slot (a
// popcount of e's conflict row against its slot's events); once feasible
// its last-slot cost + run-of-3 and single-day membership over its
// students, their days read from amask. Integers; the caller makes it
// float32.
__device__ __forceinline__ int k5_heat(
    const TTSweepProblem& pb, const int* slots, const int* rooms,
    const int16_t* occ, const uint64_t* amask, const uint32_t* slot_ev,
    int e, bool infeasible) {
    const int R = pb.R, spd = pb.spd, W = pb.W;
    const int s_e = slots[e];
    if (infeasible) {
        int r_e = rooms[e];
        int h = occ[s_e * R + r_e] - 1 + (pb.possible[e * R + r_e] ? 0 : 1);
        const uint32_t* row = pb.conflict_bits + (size_t)e * W;
        const uint32_t* sev = slot_ev + (size_t)s_e * W;
        for (int w = 0; w < W; ++w) {
            uint32_t bits = row[w] & sev[w];
            if (w == (e >> 5)) bits &= ~(1u << (e & 31));
            h += __popc(bits);
        }
        return h;
    }
    int d = s_e / spd, j = s_e % spd;
    int h = j == spd - 1 ? pb.student_count[e] : 0;
    for (int k = pb.ev_ptr[e]; k < pb.ev_ptr[e + 1]; ++k) {
        uint32_t b = tt_day_bits(amask[pb.ev_stu[k]], d, spd);
        if (!((b >> j) & 1u)) continue;
        int l1 = j >= 1 ? (b >> (j - 1)) & 1u : 0;
        int l2 = j >= 2 ? (b >> (j - 2)) & 1u : 0;
        int r1 = j + 1 < spd ? (b >> (j + 1)) & 1u : 0;
        int r2 = j + 2 < spd ? (b >> (j + 2)) & 1u : 0;
        h += ((l2 & l1) | (l1 & r1) | (r1 & r2)) + (__popc(b) == 1 ? 1 : 0);
    }
    return h;
}

__device__ __forceinline__ bool k5_lex_less(int p1, int s1, int i1, int p2,
                                            int s2, int i2) {
    return p1 < p2 || (p1 == p2 && (s1 < s2 || (s1 == s2 && i1 < i2)));
}

__device__ __forceinline__ bool k5_arg_better(float v1, int i1, float v2,
                                              int i2) {
    return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Block-wide lexicographic min of (pen, scv, idx); `red` holds 3 ints
// per warp. Every thread returns the winner.
__device__ __forceinline__ void k5_block_lexmin(int* kp, int* ks, int* ki,
                                                int* red) {
    int p = *kp, s = *ks, i = *ki;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        int p2 = __shfl_xor_sync(TT_FULL_MASK, p, off);
        int s2 = __shfl_xor_sync(TT_FULL_MASK, s, off);
        int i2 = __shfl_xor_sync(TT_FULL_MASK, i, off);
        if (k5_lex_less(p2, s2, i2, p, s, i)) { p = p2; s = s2; i = i2; }
    }
    int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        red[3 * warp] = p; red[3 * warp + 1] = s; red[3 * warp + 2] = i;
    }
    __syncthreads();
    p = red[0]; s = red[1]; i = red[2];
    for (int w = 1; w < K5_WARPS; ++w)
        if (k5_lex_less(red[3 * w], red[3 * w + 1], red[3 * w + 2], p, s, i)) {
            p = red[3 * w]; s = red[3 * w + 1]; i = red[3 * w + 2];
        }
    *kp = p; *ks = s; *ki = i;
}

// Block-wide argmax of (value, -idx): the highest value, the lowest
// index among equal ones (torch.argmax / jnp.argmax take the first).
// Every thread returns the winner in *v, *i.
__device__ __forceinline__ void k5_block_argmax(float* kv, int* ki,
                                                float* redv, int* redi) {
    float v = *kv;
    int i = *ki;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        float v2 = __shfl_xor_sync(TT_FULL_MASK, v, off);
        int i2 = __shfl_xor_sync(TT_FULL_MASK, i, off);
        if (k5_arg_better(v2, i2, v, i)) { v = v2; i = i2; }
    }
    int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) { redv[warp] = v; redi[warp] = i; }
    __syncthreads();
    v = redv[0]; i = redi[0];
    for (int w = 1; w < K5_WARPS; ++w)
        if (k5_arg_better(redv[w], redi[w], v, i)) {
            v = redv[w]; i = redi[w];
        }
    *kv = v; *ki = i;
}

// A barrier over the cluster (one CTA: over the block). Its arrive
// releases and its wait acquires this CTA's shared-memory writes.
__device__ __forceinline__ void k5_cluster_sync(cg::cluster_group& cl,
                                                int CS) {
    if (CS > 1)
        cl.sync();
    else
        __syncthreads();
}

// The cluster-wide winner of the records `rec` (n ints at the same
// offset in every CTA's shared memory): lane q < CS reads rank q's
// record through distributed shared memory, and a shuffle reduction
// under `better` leaves the winner in every lane's out[0..n).
template <int N, class Better>
__device__ __forceinline__ void k5_cluster_reduce(cg::cluster_group& cl,
                                                  int CS, int* rec,
                                                  int lane, int out[N],
                                                  const int empty[N],
                                                  Better better) {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = empty[k];
    if (lane < CS) {
        const int* r = CS > 1 ? cl.map_shared_rank(rec, (unsigned)lane) : rec;
#pragma unroll
        for (int k = 0; k < N; ++k) out[k] = r[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        int o[N];
#pragma unroll
        for (int k = 0; k < N; ++k)
            o[k] = __shfl_xor_sync(TT_FULL_MASK, out[k], off);
        if (better(o, out)) {
#pragma unroll
            for (int k = 0; k < N; ++k) out[k] = o[k];
        }
    }
}

// Two CTAs an SM (at most 64 registers a thread): a repair pass of 256
// individuals then runs in one wave on 132 SMs instead of two.
template <bool WIDE, bool GLOB>
__global__ void __launch_bounds__(K5_THREADS, 2)
    sweep_pass_kernel(K5Args A) {
    extern __shared__ __align__(16) unsigned char k5_smem[];
    cg::cluster_group cl = cg::this_cluster();
    const int E = A.pb.E, R = A.pb.R, S = A.pb.S, T = A.pb.T, W = A.pb.W;
    const int CS = A.CS, rank = (int)cl.block_rank();
    const int p = blockIdx.x / CS, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    int* slots = (int*)(k5_smem + A.lay.slots);
    int* rooms = (int*)(k5_smem + A.lay.rooms);
    int* piv = (int*)(k5_smem + A.lay.piv);
    float* heat = (float*)(k5_smem + A.lay.heat);
    int* c_pen = (int*)(k5_smem + A.lay.cand);
    int* c_scv = c_pen + A.n_cand;
    int* c_hi = c_scv + A.n_cand;
    int* c_lo = c_hi + A.n_cand;
    int* per_slot = (int*)(k5_smem + A.lay.per_slot);
    int* misc = (int*)(k5_smem + A.lay.misc);
    uint64_t* masks =
        GLOB && !(A.lay.stage & K5_STAGE_MASKS)
            ? A.masks_g + (size_t)blockIdx.x * A.max_students
            : (uint64_t*)(k5_smem + A.lay.masks);
    // each region staged, or the individual's one copy in global memory
    const int stage = GLOB ? A.lay.stage : TT_STAGE_ALL;
    const bool att_g = !(stage & TT_STAGE_ATT);
    const bool amask_g = !(stage & TT_STAGE_AMASK);
    const bool occ_g = !(stage & TT_STAGE_OCC);
    uint64_t* amask = amask_g ? A.amask_g + (size_t)p * S
                              : (uint64_t*)(k5_smem + A.lay.amask);
    uint32_t* slot_ev = (uint32_t*)(k5_smem + A.lay.slot_ev);
    int16_t* occ = occ_g ? A.occ_out + (size_t)p * T * R
                         : (int16_t*)(k5_smem + A.lay.occ);
    int16_t* att = att_g ? A.att_out + (size_t)p * S * T
                         : (int16_t*)(k5_smem + A.lay.att);
    uint32_t* bits = (uint32_t*)(k5_smem + A.lay.bits);
    int* rm_acc = misc;              // (1,)
    int* st = misc + 4;              // pen, hcv, scv, strict
    int* red = misc + 8;             // 3 per warp
    float* redv = (float*)(misc + 8 + 3 * K5_WARPS);
    int* redi = misc + 8 + 4 * K5_WARPS;
    int* mv = misc + K5_MISC_MV;     // accept, ev, old slot/room, ns, nr
    int* lexrec = misc + K5_MISC_LEX;
    int* argrec = misc + K5_MISC_ARG;

    TT_PROF_START();
    // ---- prologue: the individual's state into shared memory
    const int* g_slots = A.slots + (size_t)p * E;
    const int* g_rooms = A.rooms + (size_t)p * E;
    for (int i = tid; i < E; i += K5_THREADS) {
        slots[i] = g_slots[i];
        rooms[i] = g_rooms[i];
    }
    // a region in global memory is copied once, by rank 0
    const int16_t* g_att = A.att + (size_t)p * S * T;
    if (!att_g || rank == 0)
        for (int i = tid; i < S * T; i += K5_THREADS) att[i] = g_att[i];
    const int16_t* g_occ = A.occ + (size_t)p * T * R;
    if (!occ_g || rank == 0)
        for (int i = tid; i < T * R; i += K5_THREADS) occ[i] = g_occ[i];
    TTSweepProblem pb = A.pb;
    if (A.lay.bits_in_smem) {
        for (int i = tid; i < E * W; i += K5_THREADS)
            bits[i] = A.pb.conflict_bits[i];
        pb.conflict_bits = bits;
    }
    if (tid == 0) {
        st[0] = A.pen[p]; st[1] = A.hcv[p]; st[2] = A.scv[p]; st[3] = 0;
    }
    const int perm_a = A.a[p], perm_b = A.b[p];
    __syncthreads();
    if (!GLOB) {
        tt_build_bitsets_block(pb, slots, att, amask, slot_ev);
        __syncthreads();
    } else {
        // amask from the input rows (rank 0 alone where it is global),
        // then every CTA waits for rank 0's copies
        if (!amask_g || rank == 0) tt_build_amask_block(pb, g_att, amask);
        tt_build_slot_ev_block(pb, slots, slot_ev);
        k5_cluster_sync(cl, CS);
    }

    // ---- pivots: the permutation, or the top-K events by heat
    if (A.use_hot) {
        const bool infeasible = st[1] > 0;
        for (int e = tid; e < E; e += K5_THREADS) {
            int h = k5_heat(pb, slots, rooms, occ, amask, slot_ev, e,
                            infeasible);
            heat[e] = __fadd_rn(__fmul_rn((float)h, A.event_mask[e]),
                                A.hot_noise[(size_t)p * E + e]);
        }
        __syncthreads();
        for (int e = tid; e < E; e += K5_THREADS) {
            float v = heat[e];
            int rank_e = 0;
            for (int f = 0; f < E; ++f) {
                float u = heat[f];
                rank_e += (u > v || (u == v && f < e)) ? 1 : 0;
            }
            if (rank_e < A.K) piv[rank_e] = e;
        }
    } else {
        for (int j = tid; j < E; j += K5_THREADS)
            piv[j] = k5_perm(perm_a, perm_b, j, E);
    }
    __syncthreads();
    if (rank == 0)
        for (int j = tid; j < A.K; j += K5_THREADS)
            A.pivots_out[(size_t)p * A.K + j] = piv[j];

    TT_PROF(9);
    const int n1 = A.B * T;
    const int lex_empty[K5_LEX_REC] = {K5_INT_MAX, K5_INT_MAX, K5_INT_MAX,
                                       0, 0};
    const int arg_empty[K5_ARG_REC] = {__float_as_int(-1.0f), K5_INT_MAX,
                                       0, 0, 0, 0};
    // thread 0's accepted Move1 / Move2 / Move3 counts
    int n_acc[3] = {0, 0, 0};
    for (int pos = 0; pos < A.n_steps; ++pos) {
        const int buf = pos & 1;
        // ---- Move1: this rank's block pivots to every slot (K3's body)
        for (int b = rank; b < A.B; b += CS) {
            const int e = piv[(pos * A.B + b) % A.K];
            __syncthreads();
            tt_move1_prepare(pb, slots, att, amask, slot_ev, e, per_slot,
                             rm_acc, masks);
            if (tid < T) {
                int dh, ds, nr;
                tt_move1_target(pb, slots, rooms, occ, e, tid, per_slot,
                                masks, rm_acc[0], &dh, &ds, &nr);
                int ev[3] = {e, (e + 1) % E, (e + 2) % E};
                int ns[3] = {tid, slots[ev[1]], slots[ev[2]]};
                k5_store(A, st, slots, b * T + tid, dh, ds, ev, ns, nr,
                         rooms[ev[1]], rooms[ev[2]], c_pen, c_scv, c_hi,
                         c_lo);
            }
        }
        TT_PROF(0);
        // ---- Move2 / Move3: one warp of the cluster per candidate (K4's
        // body on the bitsets)
        for (int c = n1 + rank * K5_WARPS + warp; c < A.n_cand;
             c += CS * K5_WARPS) {
            int ev[3], ns[3], on[3], nr[3], invalid, dh, ds;
            k5_candidate(A, perm_a, perm_b, piv, slots, pos, c, ev, ns, on,
                         &invalid);
            tt_delta_one_bits_warp<WIDE>(pb, slots, rooms, att, occ,
                                         amask, slot_ev, ev, ns, on, lane,
                                         &dh, &ds, nr);
            if (lane == 0)
                k5_store(A, st, slots, c, invalid ? K5_BIG : dh, ds, ev, ns,
                         nr[0], nr[1], nr[2], c_pen, c_scv, c_hi, c_lo);
            TT_PROF(4);
        }
        TT_PROF(4);
        __syncthreads();
        TT_PROF(5);

        // ---- the choice (sweep.py:507-550): this CTA's lexicographic
        // min, then the cluster's
        int row_min = K5_INT_MAX, scv_min = K5_INT_MAX, best = K5_INT_MAX;
        for (int c = tid; c < A.n_cand; c += K5_THREADS)
            if (k5_owner(c, n1, T, CS) == rank
                && k5_lex_less(c_pen[c], c_scv[c], c, row_min, scv_min,
                               best)) {
                row_min = c_pen[c]; scv_min = c_scv[c]; best = c;
            }
        k5_block_lexmin(&row_min, &scv_min, &best, red);
        if (tid == 0) {
            int* r = lexrec + K5_LEX_REC * buf;
            const bool any = best != K5_INT_MAX;
            r[0] = row_min; r[1] = scv_min; r[2] = best;
            r[3] = any ? c_hi[best] : 0;
            r[4] = any ? c_lo[best] : 0;
        }
        TT_PROF(6);
        k5_cluster_sync(cl, CS);
        int win[K5_LEX_REC];
        k5_cluster_reduce<K5_LEX_REC>(
            cl, CS, lexrec + K5_LEX_REC * buf, lane, win, lex_empty,
            [](const int* x, const int* y) {
                return k5_lex_less(x[0], x[1], x[2], y[0], y[1], y[2]);
            });
        TT_PROF(11);
        row_min = win[0]; scv_min = win[1]; best = win[2];
        int bp = row_min, bs = scv_min, bhi = win[3], blo = win[4];
        int allow = 0;
        if (A.sideways) {
            // drift: any penalty tie; descent: the lexicographic ties;
            // the highest tie noise wins
            const size_t row = (size_t)pos * A.P + p;
            allow = A.allow[row] ? 1 : 0;
            const float* noise = A.tie_noise + row * A.n_cand;
            float bv = -1.0f;
            int bi = K5_INT_MAX;
            for (int c = tid; c < A.n_cand; c += K5_THREADS) {
                bool tie = k5_owner(c, n1, T, CS) == rank
                           && c_pen[c] == row_min
                           && (allow || c_scv[c] == scv_min);
                if (tie && k5_arg_better(noise[c], c, bv, bi)) {
                    bv = noise[c];
                    bi = c;
                }
            }
            k5_block_argmax(&bv, &bi, redv, redi);
            if (tid == 0) {
                int* r = argrec + K5_ARG_REC * buf;
                const bool any = bi != K5_INT_MAX;
                r[0] = __float_as_int(bv); r[1] = bi;
                r[2] = any ? c_pen[bi] : 0;
                r[3] = any ? c_scv[bi] : 0;
                r[4] = any ? c_hi[bi] : 0;
                r[5] = any ? c_lo[bi] : 0;
            }
            TT_PROF(7);
            k5_cluster_sync(cl, CS);
            int aw[K5_ARG_REC];
            k5_cluster_reduce<K5_ARG_REC>(
                cl, CS, argrec + K5_ARG_REC * buf, lane, aw, arg_empty,
                [](const int* x, const int* y) {
                    return k5_arg_better(__int_as_float(x[0]), x[1],
                                         __int_as_float(y[0]), y[1]);
                });
            TT_PROF(11);
            best = aw[1]; bp = aw[2]; bs = aw[3]; bhi = aw[4]; blo = aw[5];
        }
        if (tid == 0) {
            bool strict = bp < st[0] || (bp == st[0] && bs < st[2]);
            bool better = strict || (allow && bp == st[0]);
            st[3] |= strict ? 1 : 0;
            mv[0] = better ? 1 : 0;
            if (better && A.ops_out)
                ++n_acc[best < n1 ? 0 : best < n1 + A.B * A.SB ? 1 : 2];
            if (better) {
                int ev[3], ns[3], on[3], invalid;
                k5_candidate(A, perm_a, perm_b, piv, slots, pos, best, ev,
                             ns, on, &invalid);
#pragma unroll
                for (int m = 0; m < 3; ++m) {
                    mv[1 + m] = ev[m];
                    mv[4 + m] = slots[ev[m]];
                    mv[7 + m] = rooms[ev[m]];
                    mv[10 + m] = ns[m];
                    mv[13 + m] = k5_unpack_room(bhi, blo, m);
                }
                st[0] = bp; st[1] = bhi >> 4; st[2] = bs;
            }
        }
        __syncthreads();

        TT_PROF(7);
        // ---- the apply (delta.py:188 _apply_move), in shared memory, the
        // same move in every CTA of the cluster
        if (!GLOB) {
            if (mv[0])
                tt_apply_move_bits_block(pb, mv + 1, slots, rooms, att, occ,
                                         amask, slot_ev);
        } else if (mv[0]) {
            // a region in global memory is rank 0's to move; a staged
            // amask beside rank 0's att is refreshed after the barrier
            tt_apply_move_bits_block(
                pb, mv + 1, slots, rooms, att, occ, amask, slot_ev,
                !occ_g || rank == 0, !att_g || rank == 0,
                amask_g ? rank == 0 : !att_g || rank == 0);
            if (CS > 1) {
                cl.sync();
                if (att_g && !amask_g && rank != 0)
                    tt_refresh_amask_block(pb, mv + 1, att, amask);
            }
        }
        TT_PROF(8);
    }
    __syncthreads();

    // ---- epilogue: rank 0 writes the state back to global memory
    if (rank == 0) {
        for (int i = tid; i < E; i += K5_THREADS) {
            A.slots_out[(size_t)p * E + i] = slots[i];
            A.rooms_out[(size_t)p * E + i] = rooms[i];
        }
        // (a region in global memory is in its out row already)
        if (!att_g)
            for (int i = tid; i < S * T; i += K5_THREADS)
                A.att_out[(size_t)p * S * T + i] = att[i];
        if (!occ_g)
            for (int i = tid; i < T * R; i += K5_THREADS)
                A.occ_out[(size_t)p * T * R + i] = occ[i];
        if (tid == 0) {
            A.pen_out[p] = st[0];
            A.hcv_out[p] = st[1];
            A.scv_out[p] = st[2];
            A.strict_out[p] = (uint8_t)st[3];
            if (A.ops_out)
                for (int k = 0; k < 3; ++k)
                    A.ops_out[(size_t)p * 3 + k] =
                        (A.ops_in ? A.ops_in[(size_t)p * 3 + k] : 0)
                        + n_acc[k];
        }
    }
    // no CTA leaves while another may still read its records
    k5_cluster_sync(cl, CS);
    TT_PROF(10);
}

extern "C" int tt_sweep_pass_smem_bytes(int E, int R, int S, int T, int K,
                                        int n_cand, int use_hot,
                                        int max_students, int W) {
    return (int)k5_smem_layout(E, R, S, T, K, n_cand, use_hot, max_students,
                               W).total;
}

extern "C" int tt_sweep_pass(
    const int* slots, const int* rooms, const int16_t* att,
    const int16_t* occ, const int* pen, const int* hcv, const int* scv,
    const int* a, const int* b, const float* hot_noise,
    const float* tie_noise, const uint8_t* allow, const uint8_t* possible,
    const int* live, const int* student_count, const uint32_t* conflict_bits,
    const int* cap_rank, const int* dead, const uint8_t* attends,
    const int* ev_ptr, const int* ev_stu, const float* event_mask,
    const int* anchor_slots, const int* anchor_w, int* slots_out,
    int* rooms_out, int16_t* att_out, int16_t* occ_out, int* pen_out,
    int* hcv_out, int* scv_out, uint8_t* strict_out, int* pivots_out,
    const int* ops_in, int* ops_out, uint64_t* amask_g, uint64_t* masks_g,
    int P, int E,
    int R, int S, int T, int spd, int W, int max_students, int K, int B,
    int SB, int n_steps, int n_cand, int use_hot, int sideways,
    int anchored, int cluster, int stage, void* stream) {
    stage &= TT_STAGE_ALL | K5_STAGE_MASKS;
    const bool glob = stage != (TT_STAGE_ALL | K5_STAGE_MASKS);
    if (P <= 0 || E < 3 || !tt_rooms_fit(E, R) || T > 64 || T > K5_THREADS
        || spd > 32 || K <= 0 || B <= 0 || SB < 0 || n_steps <= 0
        || n_cand < B * T
        || cluster < 1 || cluster > K5_MAX_CLUSTER
        || (use_hot && !hot_noise) || (sideways && (!tie_noise || !allow))
        || (!(stage & TT_STAGE_AMASK) && !amask_g)
        || (!(stage & K5_STAGE_MASKS) && !masks_g))
        return (int)cudaErrorInvalidValue;
    K5Smem lay = k5_smem_layout(E, R, S, T, K, n_cand, use_hot,
                                max_students, W, stage);
    if (lay.total > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    // the instance that chooses among rooms past the first 32, where
    // there are some; the one with regions in global memory chooses
    // among any R
    const auto kernel = glob ? sweep_pass_kernel<true, true>
                        : tt_wide_rooms(R) ? sweep_pass_kernel<true, false>
                                           : sweep_pass_kernel<false, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lay.total);
    if (err != cudaSuccess) return (int)err;
    K5Args A;
    A.pb = {possible, live, student_count, conflict_bits, cap_rank, dead,
            attends, ev_ptr, ev_stu, E, R, S, T, spd, W};
    A.event_mask = event_mask; A.anchor_slots = anchor_slots;
    A.anchor_w = anchor_w;
    A.slots = slots; A.rooms = rooms; A.att = att; A.occ = occ;
    A.pen = pen; A.hcv = hcv; A.scv = scv;
    A.a = a; A.b = b; A.hot_noise = hot_noise; A.tie_noise = tie_noise;
    A.allow = allow;
    A.slots_out = slots_out; A.rooms_out = rooms_out; A.att_out = att_out;
    A.occ_out = occ_out; A.pen_out = pen_out; A.hcv_out = hcv_out;
    A.scv_out = scv_out; A.strict_out = strict_out;
    A.pivots_out = pivots_out;
    A.ops_in = ops_in; A.ops_out = ops_out;
    A.amask_g = amask_g;
    A.masks_g = masks_g;
    A.max_students = max_students > 0 ? max_students : 1;
    A.P = P; A.K = K; A.B = B; A.SB = SB; A.n_steps = n_steps;
    A.n_cand = n_cand; A.use_hot = use_hot; A.sideways = sideways;
    A.anchored = anchored; A.CS = cluster; A.lay = lay;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(P * cluster, 1, 1);
    cfg.blockDim = dim3(K5_THREADS, 1, 1);
    cfg.dynamicSmemBytes = lay.total;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a cluster the card cannot place is refused, never shrunk
    int n_clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n_clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    err = cudaLaunchKernelEx(&cfg, kernel, A);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
