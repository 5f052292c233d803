// K11: NSGA-II selection of every island in one launch: the parents'
// non-dominated ranks and crowding distances (entry `nsga_rank`, the
// crowded tournament's keys) and the replacement (entry
// `nsga_survivors`).
//
// Replaces timetabling_ga_tpu/ops/nsga.py:30-118 (domination_matrix,
// nondominated_ranks, crowding_distance, nsga_survivor_indices) as run
// by ops/ga.py:239-245 and :282-288 under --nsga2. XLA runs an island
// as an (N, N) domination tensor, a while_loop peeling fronts, two
// lexsorts per objective and a lexsort of the survivors.
//
// Bound on this card: neither bytes (a few ints a row, and the kept
// rows' copy) nor operations (N^2 compares); its time is the launch and
// the chain of block-wide passes. The phase counters of the previous
// design (a thread a row on one warp, k5_phases) put half to
// four-fifths of a launch in the peel, which rescanned all n rows for an
// unassigned dominator every round, and a quarter of the survivors'
// launch in the row copy, one warp's chain of 4-byte loads.
//
// Design: a block of K11_THREADS per island (nsga_rank), or a grid of
// ceil(keep / K11_ROWS) blocks per island (nsga_survivors), every block
// recomputing its island's selection, which is cheap while the
// dominator words fit, so that no block waits for another, and copying
// only its own K11_ROWS output rows with K7's row copy (rows_dev.cuh);
// an island too large for the words takes one block, which copies all
// of its rows. The whole block takes part in the selection even at
// n <= 32: one warp doing it alone, with no block barrier, measured
// slower (its ballots and counts in series).
// Everything else lives in shared memory:
//   - dominators: row i's dominators as ceil(n/32) words, word w bit b
//     set when row 32w + b dominates row i, one __ballot_sync a word,
//     computed once (an island too large for them in shared memory,
//     n above ~1,300, counts a row's words anew each round, up to the
//     first that holds an unassigned dominator);
//   - ranks: complete peeling against the bitset of unassigned rows; a
//     round puts in the current front every unassigned row none of whose
//     dominators is still unassigned (the JAX count of remaining
//     dominators reaching 0), until none is left (at most n rounds). At
//     n <= 32 the whole peel is one warp's ballots; above, a round tests
//     each row's words against the unassigned words (double buffered)
//     and ends in one __syncthreads_or;
//   - crowding, per objective: in the stable order by (rank, objective,
//     row), a row's neighbours both share its front exactly when a row
//     of its front comes before it and one after, and their values are
//     the front's largest before it and least after it, so one pass over
//     the other rows (both objectives, G threads a row, combined by
//     shuffles) gives them; the neighbours' gap over max(max - min, 1)
//     of the island's objective (the min and max taken once, by one
//     warp's __reduce_min/max_sync), else +inf, added to 0 in objective
//     order with IEEE float32 (__fsub_rn, __fdiv_rn, __fadd_rn; the
//     build uses no fast math);
//   - survivors: positions by (rank asc, crowd desc, row), the first
//     `keep` kept, re-ranked among themselves by (penalty, scv,
//     position in that order), each counted the same way, then the
//     block's rows copied.
// Counting, not sorting, gives the orders: ties fall to the lower row
// exactly as a stable sort leaves them.
#include "rows_dev.cuh"

// threads of a block (the CPU stand-in builds it small)
#ifndef K11_THREADS
#define K11_THREADS 256
#endif
// output rows a survivors block copies
#ifndef K11_ROWS
#define K11_ROWS 2
#endif

// i dominates j: no worse in both objectives, better in one
__device__ __forceinline__ bool k11_dom(int hi, int si, int hj, int sj) {
    return hi <= hj && si <= sj && (hi < hj || si < sj);
}

__host__ __device__ __forceinline__ int k11_words(int n) {
    return (n + 31) / 32;
}

// the most shared memory the dominator words may bring a block to (the
// CPU stand-in builds it 0, which tests the peel without them)
#ifndef K11_WORDS_LIMIT
#define K11_WORDS_LIMIT TT_SMEM_LIMIT
#endif

struct K11Smem {
    int *hcv, *scv, *rank, *pos, *pen, *mm;
    float* crowd;
    uint32_t *dom, *left;
};

// An island of n rows: 4 n ints (6 with the survivors' crowded
// positions and penalties), the objectives' min and max, two unassigned
// bitsets; then, where they fit (`words`), the dominator words.
static size_t k11_smem_bytes(int n, int surv, int words) {
    const size_t nw = (size_t)k11_words(n);
    return sizeof(int) * ((surv ? 6 : 4) * (size_t)n + 4 + 2 * nw
                          + (words ? nw * n : 0));
}

__device__ __forceinline__ K11Smem k11_smem(int n, int surv) {
    extern __shared__ int k11_buf[];
    K11Smem m;
    m.hcv = k11_buf;
    m.scv = m.hcv + n;
    m.rank = m.scv + n;
    m.crowd = (float*)(m.rank + n);
    m.pos = (int*)(m.crowd + n);    // position in the crowded order
    m.pen = m.pos + (surv ? n : 0);
    m.mm = m.pen + (surv ? n : 0);  // min hcv, max hcv, min scv, max scv
    m.left = (uint32_t*)(m.mm + 4);
    m.dom = m.left + 2 * k11_words(n);
    return m;
}

// For every row i: c = the sum over rows j of f(j, i, acc), which may
// also fold j into acc (an Acc of per-row extremes), then out(i, c,
// acc). A row's G threads (the largest power of two G <= 8 with G n
// threads in the block, else 1: rows strided) are adjacent lanes that
// take every G-th j and combine by shuffles; the loop bounds are alike
// for every thread, so every lane reaches every shuffle.
template <class Acc, class F, class Out>
__device__ __forceinline__ void k11_count(int n, F f, Out out) {
    const int nt = blockDim.x;
    int G = 1;
    while (G < 8 && 2 * G * n <= nt) G *= 2;
    const int sub = threadIdx.x & (G - 1), per = nt / G;
    for (int i0 = 0; i0 < n; i0 += per) {
        const int i = i0 + (int)threadIdx.x / G;
        int c = 0;
        Acc acc;
        if (i < n)
            for (int j = sub; j < n; j += G) c += f(j, i, acc);
        for (int off = G >> 1; off > 0; off >>= 1) {
            c += __shfl_xor_sync(TT_FULL_MASK, c, off);
            acc.merge(off);
        }
        if (i < n && sub == 0) out(i, c, acc);
    }
}

// no per-row extremes
struct K11NoAcc {
    __device__ __forceinline__ void merge(int) {}
};

// A row's nearest neighbours within its front in the order by
// (objective, row), per objective: the largest objective value among the
// front's rows before it (-1: none) and the least among those after it
// (0x7fffffff: none). Objectives are >= 0.
struct K11Neighbours {
    int pred[2] = {-1, -1}, succ[2] = {0x7fffffff, 0x7fffffff};
    __device__ __forceinline__ void merge(int off) {
        for (int o = 0; o < 2; ++o) {
            pred[o] =
                max(pred[o], __shfl_xor_sync(TT_FULL_MASK, pred[o], off));
            succ[o] =
                min(succ[o], __shfl_xor_sync(TT_FULL_MASK, succ[o], off));
        }
    }
};

// Row i's dominators among rows 32 w .. 32 w + 31, bit b for row 32 w +
// b: the stored word, or without the words (an island too large for
// them) counted here.
__device__ __forceinline__ uint32_t k11_dom_word(const K11Smem& m, int n,
                                                 int i, int w, int words) {
    if (words) return m.dom[w * n + i];
    uint32_t d = 0;
    for (int b = 0; b < 32 && 32 * w + b < n; ++b)
        if (k11_dom(m.hcv[32 * w + b], m.scv[32 * w + b], m.hcv[i], m.scv[i]))
            d |= 1u << b;
    return d;
}

// ranks and crowding distances of the n rows (hcv, scv) in shared
// memory; the caller syncs before
__device__ void k11_rank_crowd(int n, const K11Smem& m, int words) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n_warps = blockDim.x >> 5, nw = k11_words(n);
    const int *hcv = m.hcv, *scv = m.scv;
    // dominator words, a ballot each: word w of row i at w * n + i
    for (int w = 0; words && w < nw; ++w) {
        const int j = 32 * w + lane;
        const int hj = j < n ? hcv[j] : 0, sj = j < n ? scv[j] : 0;
        for (int i = warp; i < n; i += n_warps) {
            const unsigned word = __ballot_sync(
                TT_FULL_MASK, j < n && k11_dom(hj, sj, hcv[i], scv[i]));
            if (lane == 0) m.dom[w * n + i] = word;
        }
    }
    // the objectives' ranges, by the last warp
    if (warp == n_warps - 1) {
        int lo_h = 0x7fffffff, hi_h = 0, lo_s = lo_h, hi_s = 0;
        for (int i = lane; i < n; i += 32) {
            lo_h = min(lo_h, hcv[i]);
            hi_h = max(hi_h, hcv[i]);
            lo_s = min(lo_s, scv[i]);
            hi_s = max(hi_s, scv[i]);
        }
        lo_h = __reduce_min_sync(TT_FULL_MASK, lo_h);
        hi_h = __reduce_max_sync(TT_FULL_MASK, hi_h);
        lo_s = __reduce_min_sync(TT_FULL_MASK, lo_s);
        hi_s = __reduce_max_sync(TT_FULL_MASK, hi_s);
        if (lane == 0) {
            m.mm[0] = lo_h;
            m.mm[1] = hi_h;
            m.mm[2] = lo_s;
            m.mm[3] = hi_s;
        }
    }
    __syncthreads();
    TT_PROF(1);
    if (n <= 32) {
        // the whole peel on warp 0's ballots, row = lane
        if (warp == 0) {
            unsigned left = __ballot_sync(TT_FULL_MASK, lane < n);
            const unsigned d =
                lane < n ? k11_dom_word(m, n, lane, 0, words) : 0u;
            int r = -1;
            // at most n fronts: a bound that holds the loop finite
            for (int f = 0; left && f < n; ++f) {
                const bool ready = ((left >> lane) & 1u) && !(d & left);
                if (ready) r = f;
                left &= ~__ballot_sync(TT_FULL_MASK, ready);
            }
            if (lane < n) m.rank[lane] = r;
        }
    } else {
        // warp w' takes words w = w', w' + n_warps, ...: rows 32 w + lane
        uint32_t* cur = m.left;
        uint32_t* nxt = m.left + nw;
        for (int w = tid; w < nw; w += blockDim.x)
            cur[w] = (w < nw - 1 || n % 32 == 0)
                     ? 0xffffffffu : (1u << (n % 32)) - 1u;
        __syncthreads();
        for (int f = 0; f < n; ++f) {
            int more = 0;
            for (int w = warp; w < nw; w += n_warps) {
                const int i = 32 * w + lane;
                const unsigned left = cur[w];
                bool ready = (left >> lane) & 1u;
                for (int v = 0; v < nw && ready; ++v)
                    ready = !(k11_dom_word(m, n, i, v, words) & cur[v]);
                if (ready) m.rank[i] = f;
                const unsigned now =
                    left & ~__ballot_sync(TT_FULL_MASK, ready);
                if (lane == 0) nxt[w] = now;
                more |= now != 0u;
            }
            if (!__syncthreads_or(more)) break;
            uint32_t* t = cur;
            cur = nxt;
            nxt = t;
        }
    }
    __syncthreads();
    TT_PROF(2);
    // crowding: in the stable order by (rank, objective, row), a row's
    // neighbours both share its front exactly when some row of its front
    // comes before it and some after; their values are the front's
    // largest before it and least after it
    const int* rank = m.rank;
    const float rng_h =
        fmaxf(__fsub_rn((float)m.mm[1], (float)m.mm[0]), 1.0f);
    const float rng_s =
        fmaxf(__fsub_rn((float)m.mm[3], (float)m.mm[2]), 1.0f);
    k11_count<K11Neighbours>(
        n,
        [&](int j, int i, K11Neighbours& nb) {
            if (rank[j] == rank[i] && j != i) {
                for (int o = 0; o < 2; ++o) {
                    const int* obj = o == 0 ? hcv : scv;
                    if (obj[j] < obj[i] || (obj[j] == obj[i] && j < i))
                        nb.pred[o] = max(nb.pred[o], obj[j]);
                    else
                        nb.succ[o] = min(nb.succ[o], obj[j]);
                }
            }
            return 0;
        },
        [&](int i, int, const K11Neighbours& nb) {
            float dist = 0.0f;
            for (int o = 0; o < 2; ++o) {
                float gap = __int_as_float(0x7f800000);
                if (nb.pred[o] >= 0 && nb.succ[o] != 0x7fffffff)
                    gap = __fdiv_rn(__fsub_rn((float)nb.succ[o],
                                              (float)nb.pred[o]),
                                    o == 0 ? rng_h : rng_s);
                dist = __fadd_rn(dist, gap);
            }
            m.crowd[i] = dist;
        });
    __syncthreads();
    TT_PROF(3);
}

__global__ void __launch_bounds__(K11_THREADS) nsga_rank_kernel(
    const int* __restrict__ hcv, const int* __restrict__ scv,
    int* __restrict__ ranks_out, float* __restrict__ crowd_out, int n,
    int words) {
    K11Smem m = k11_smem(n, 0);
    TT_PROF_START();
    const size_t base = (size_t)blockIdx.x * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        m.hcv[i] = hcv[base + i];
        m.scv[i] = scv[base + i];
    }
    __syncthreads();
    TT_PROF(0);
    k11_rank_crowd(n, m, words);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        ranks_out[base + i] = m.rank[i];
        crowd_out[base + i] = m.crowd[i];
    }
    TT_PROF(6);
}

// `rows`: output rows a block copies (K11_ROWS, or the whole `keep`
// where the selection is too dear to repeat)
__global__ void __launch_bounds__(K11_THREADS) nsga_survivors_kernel(
    TTRows a, TTRows b, TTRowsOut out, int na, int nb, int keep, int E,
    int vec, int words, int rows) {
    const int n = na + nb;
    const int per = (keep + rows - 1) / rows;
    const int g = blockIdx.x / per, o0 = (blockIdx.x % per) * rows;
    const int o1 = min(keep, o0 + rows);
    K11Smem m = k11_smem(n, 1);
    TT_PROF_START();
    // row i < na: parent g * na + i; else child g * nb + i - na
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const bool pa = i < na;
        const int r = pa ? g * na + i : g * nb + i - na;
        m.pen[i] = pa ? a.pen[r] : b.pen[r];
        m.hcv[i] = pa ? a.hcv[r] : b.hcv[r];
        m.scv[i] = pa ? a.scv[r] : b.scv[r];
    }
    __syncthreads();
    TT_PROF(0);
    k11_rank_crowd(n, m, words);
    // position in the crowded order (rank asc, crowd desc, row)
    const int* rank = m.rank;
    const float* crowd = m.crowd;
    k11_count<K11NoAcc>(
        n,
        [&](int j, int i, K11NoAcc&) {
            return (rank[j] < rank[i]
                    || (rank[j] == rank[i]
                        && (crowd[j] > crowd[i]
                            || (crowd[j] == crowd[i] && j < i)))) ? 1 : 0;
        },
        [&](int i, int c, const K11NoAcc&) { m.pos[i] = c; });
    __syncthreads();
    // the kept rows' places by (penalty, scv, crowded position); this
    // block's are out rows [o0, o1), out row q row srow[q] of buffer
    // sbuf[q] (0 parents, 1 children), kept in the places of hcv, the
    // ranks and the crowding, which this count does not read (oq[q] = q
    // indexes them for the copy)
    const int* pos = m.pos;
    const int *pen = m.pen, *scv = m.scv;
    int *oq = m.hcv, *sbuf = m.rank, *srow = (int*)m.crowd;
    k11_count<K11NoAcc>(
        n,
        [&](int j, int i, K11NoAcc&) {
            const int pj = pos[j], pi = pos[i];
            return (pj < keep
                    && (pen[j] < pen[i]
                        || (pen[j] == pen[i]
                            && (scv[j] < scv[i]
                                || (scv[j] == scv[i] && pj < pi))))) ? 1 : 0;
        },
        [&](int i, int q, const K11NoAcc&) {
            if (pos[i] < keep && q >= o0 && q < o1) {
                oq[q] = q;
                sbuf[q] = i < na ? 0 : 1;
                srow[q] = i < na ? g * na + i : g * nb + i - na;
            }
        });
    __syncthreads();
    TT_PROF(4);
    const TTRows from[2] = {a, b};
    for (int c = o0; c < o1; c += blockDim.x)
        tt_copy_rows(oq + c, min((int)blockDim.x, o1 - c), sbuf, srow,
                     from, out, (size_t)g * keep + c, E, vec);
    TT_PROF(5);
}

extern "C" int tt_nsga_rank(const int* hcv, const int* scv, int* ranks,
                            float* crowd, int groups, int n, void* stream) {
    if (groups <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    const int words = k11_smem_bytes(n, 0, 1) <= K11_WORDS_LIMIT;
    size_t smem = k11_smem_bytes(n, 0, words);
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    cudaError_t err = tt_set_smem(nsga_rank_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    nsga_rank_kernel<<<groups, K11_THREADS, smem, (cudaStream_t)stream>>>(
        hcv, scv, ranks, crowd, n, words);
    return (int)cudaGetLastError();
}

extern "C" int tt_nsga_survivors(
    const int* a_slots, const int* a_rooms, const int* a_pen,
    const int* a_hcv, const int* a_scv, const int* b_slots,
    const int* b_rooms, const int* b_pen, const int* b_hcv,
    const int* b_scv, int* o_slots, int* o_rooms, int* o_pen, int* o_hcv,
    int* o_scv, int groups, int na, int nb, int keep, int E, void* stream) {
    const int n = na + nb;
    if (groups <= 0 || na < 0 || nb < 0 || n <= 0 || keep <= 0 || keep > n
        || E <= 0)
        return (int)cudaErrorInvalidValue;
    const int words = k11_smem_bytes(n, 1, 1) <= K11_WORDS_LIMIT;
    size_t smem = k11_smem_bytes(n, 1, words);
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    cudaError_t err = tt_set_smem(nsga_survivors_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const void* rows[6] = {a_slots, a_rooms, b_slots, b_rooms, o_slots,
                           o_rooms};
    TTRows a = {a_slots, a_rooms, a_pen, a_hcv, a_scv};
    TTRows b = {b_slots, b_rooms, b_pen, b_hcv, b_scv};
    TTRowsOut out = {o_slots, o_rooms, o_pen, o_hcv, o_scv};
    // without the dominator words a block's selection costs a peel of
    // n^2 tests a front: one block an island does it once
    const int per_block = words ? K11_ROWS : keep;
    const int grid = groups * ((keep + per_block - 1) / per_block);
    nsga_survivors_kernel<<<grid, K11_THREADS, smem,
                            (cudaStream_t)stream>>>(
        a, b, out, na, nb, keep, E, tt_rows_vec(E, rows, 6), words,
        per_block);
    return (int)cudaGetLastError();
}
