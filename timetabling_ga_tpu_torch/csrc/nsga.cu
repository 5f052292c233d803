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
// Bound on this card: neither bytes (a few ints a row) nor operations
// (N^2 compares a pass); its time is the launch and the chain of
// block-wide passes, one per front.
//
// Design: one block per island, a thread per row (strided when the
// island has more rows than the block has threads), everything in
// shared memory. Sorting is by counting, as K7 does: a row's position
// is the number of rows before it in the order, so no sort runs and
// ties fall to the lower row exactly as a stable sort leaves them.
//   - ranks: complete peeling; a round puts in the current front every
//     unassigned row none of whose dominators is still unassigned (the
//     JAX count of remaining dominators reaching 0), until none is left;
//   - crowding, per objective: the stable order by (rank, objective),
//     the neighbours' gap over max(max - min, 1) of the island's
//     objective when both neighbours share the row's front, else +inf,
//     added to 0 in objective order with IEEE float32 (__fsub_rn,
//     __fdiv_rn, __fadd_rn; the build uses no fast math);
//   - survivors: positions by (rank asc, crowd desc, row), the first
//     `keep` kept, re-ranked among themselves by (penalty, scv,
//     position in that order), the rows gathered to their places.
#include "common.cuh"

#define K11_THREADS 1024

// i dominates j: no worse in both objectives, better in one
__device__ __forceinline__ bool k11_dom(int hi, int si, int hj, int sj) {
    return hi <= hj && si <= sj && (hi < hj || si < sj);
}

// ranks and crowding distances of n rows (hcv, scv) in shared memory;
// `nxt` and `sorted` are n ints of scratch, `scratch` one int a warp
__device__ void k11_rank_crowd(int n, const int* hcv, const int* scv,
                               int* rank, float* crowd, int* nxt,
                               int* sorted, int* scratch) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < n; i += nt) rank[i] = -1;
    __syncthreads();
    for (int f = 0;; ++f) {
        int left = 0;
        for (int i = tid; i < n; i += nt) {
            nxt[i] = rank[i];
            if (rank[i] >= 0) continue;
            bool ready = true;
            for (int j = 0; j < n && ready; ++j)
                if (rank[j] < 0 && k11_dom(hcv[j], scv[j], hcv[i], scv[i]))
                    ready = false;
            if (ready) nxt[i] = f;
            else left = 1;
        }
        // tt_block_sum syncs before it reads what the round wrote
        int remaining = tt_block_sum(left, scratch);
        for (int i = tid; i < n; i += nt) rank[i] = nxt[i];
        __syncthreads();
        if (remaining == 0) break;
    }
    for (int i = tid; i < n; i += nt) crowd[i] = 0.0f;
    for (int o = 0; o < 2; ++o) {
        const int* obj = o == 0 ? hcv : scv;
        for (int i = tid; i < n; i += nt) {
            int pos = 0;
            for (int j = 0; j < n; ++j)
                pos += (rank[j] < rank[i]
                        || (rank[j] == rank[i]
                            && (obj[j] < obj[i]
                                || (obj[j] == obj[i] && j < i))));
            nxt[i] = pos;
            sorted[pos] = i;
        }
        __syncthreads();
        int lo = obj[0], hi = obj[0];
        for (int j = 1; j < n; ++j) {
            lo = min(lo, obj[j]);
            hi = max(hi, obj[j]);
        }
        const float rng = fmaxf(__fsub_rn((float)hi, (float)lo), 1.0f);
        for (int i = tid; i < n; i += nt) {
            const int p = nxt[i];
            float gap = __int_as_float(0x7f800000);
            if (p > 0 && p < n - 1 && rank[sorted[p - 1]] == rank[i]
                && rank[sorted[p + 1]] == rank[i])
                gap = __fdiv_rn(__fsub_rn((float)obj[sorted[p + 1]],
                                          (float)obj[sorted[p - 1]]),
                                rng);
            crowd[i] = __fadd_rn(crowd[i], gap);
        }
        __syncthreads();
    }
}

struct K11Smem {
    int *hcv, *scv, *pen, *rank, *nxt, *sorted, *pos, *scratch;
    float* crowd;
};

__device__ __forceinline__ K11Smem k11_smem(int n) {
    extern __shared__ int k11_buf[];
    K11Smem m;
    m.hcv = k11_buf;
    m.scv = m.hcv + n;
    m.pen = m.scv + n;
    m.rank = m.pen + n;
    m.nxt = m.rank + n;
    m.sorted = m.nxt + n;
    m.pos = m.sorted + n;
    m.crowd = (float*)(m.pos + n);
    m.scratch = (int*)(m.crowd + n);
    return m;
}

static size_t k11_smem_bytes(int n) {
    return sizeof(int) * (8 * (size_t)n + K11_THREADS / 32);
}

__global__ void nsga_rank_kernel(const int* __restrict__ hcv,
                                 const int* __restrict__ scv,
                                 int* __restrict__ ranks_out,
                                 float* __restrict__ crowd_out, int n) {
    K11Smem m = k11_smem(n);
    const size_t base = (size_t)blockIdx.x * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        m.hcv[i] = hcv[base + i];
        m.scv[i] = scv[base + i];
    }
    __syncthreads();
    k11_rank_crowd(n, m.hcv, m.scv, m.rank, m.crowd, m.nxt, m.sorted,
                   m.scratch);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        ranks_out[base + i] = m.rank[i];
        crowd_out[base + i] = m.crowd[i];
    }
}

__global__ void nsga_survivors_kernel(
    const int* __restrict__ a_slots, const int* __restrict__ a_rooms,
    const int* __restrict__ a_pen, const int* __restrict__ a_hcv,
    const int* __restrict__ a_scv, const int* __restrict__ b_slots,
    const int* __restrict__ b_rooms, const int* __restrict__ b_pen,
    const int* __restrict__ b_hcv, const int* __restrict__ b_scv,
    int* __restrict__ o_slots, int* __restrict__ o_rooms,
    int* __restrict__ o_pen, int* __restrict__ o_hcv,
    int* __restrict__ o_scv, int na, int nb, int keep, int E) {
    const int n = na + nb, g = blockIdx.x, tid = threadIdx.x;
    const int nt = blockDim.x;
    K11Smem m = k11_smem(n);
    // row i < na: parent g * na + i; else child g * nb + i - na
    for (int i = tid; i < n; i += nt) {
        const bool pa = i < na;
        const size_t r = pa ? (size_t)g * na + i : (size_t)g * nb + i - na;
        m.pen[i] = pa ? a_pen[r] : b_pen[r];
        m.hcv[i] = pa ? a_hcv[r] : b_hcv[r];
        m.scv[i] = pa ? a_scv[r] : b_scv[r];
    }
    __syncthreads();
    k11_rank_crowd(n, m.hcv, m.scv, m.rank, m.crowd, m.nxt, m.sorted,
                   m.scratch);
    // position in the crowded order (rank asc, crowd desc, row)
    for (int i = tid; i < n; i += nt) {
        int pos = 0;
        for (int j = 0; j < n; ++j)
            pos += (m.rank[j] < m.rank[i]
                    || (m.rank[j] == m.rank[i]
                        && (m.crowd[j] > m.crowd[i]
                            || (m.crowd[j] == m.crowd[i] && j < i))));
        m.pos[i] = pos;
    }
    __syncthreads();
    // the kept rows' places by (penalty, scv, crowded position)
    for (int i = tid; i < n; i += nt) {
        const int pi = m.pos[i];
        if (pi >= keep) continue;
        int q = 0;
        for (int j = 0; j < n; ++j) {
            const int pj = m.pos[j];
            q += pj < keep
                 && (m.pen[j] < m.pen[i]
                     || (m.pen[j] == m.pen[i]
                         && (m.scv[j] < m.scv[i]
                             || (m.scv[j] == m.scv[i] && pj < pi))));
        }
        m.sorted[q] = i;
    }
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31, n_warps = nt >> 5;
    for (int q = warp; q < keep; q += n_warps) {
        const int i = m.sorted[q];
        const bool pa = i < na;
        const size_t r = pa ? (size_t)g * na + i : (size_t)g * nb + i - na;
        const int* ss = (pa ? a_slots : b_slots) + r * E;
        const int* rs = (pa ? a_rooms : b_rooms) + r * E;
        const size_t o = (size_t)g * keep + q;
        for (int e = lane; e < E; e += 32) {
            o_slots[o * E + e] = ss[e];
            o_rooms[o * E + e] = rs[e];
        }
        if (lane == 0) {
            o_pen[o] = m.pen[i];
            o_hcv[o] = m.hcv[i];
            o_scv[o] = m.scv[i];
        }
    }
}

static int k11_threads(int n) {
    int t = ((n + 31) / 32) * 32;
    return t < K11_THREADS ? t : K11_THREADS;
}

extern "C" int tt_nsga_rank(const int* hcv, const int* scv, int* ranks,
                            float* crowd, int groups, int n, void* stream) {
    if (groups <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    size_t smem = k11_smem_bytes(n);
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    cudaError_t err = tt_set_smem(nsga_rank_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    nsga_rank_kernel<<<groups, k11_threads(n), smem, (cudaStream_t)stream>>>(
        hcv, scv, ranks, crowd, n);
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
    size_t smem = k11_smem_bytes(n);
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    cudaError_t err = tt_set_smem(nsga_survivors_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    nsga_survivors_kernel<<<groups, k11_threads(n), smem,
                            (cudaStream_t)stream>>>(
        a_slots, a_rooms, a_pen, a_hcv, a_scv, b_slots, b_rooms, b_pen,
        b_hcv, b_scv, o_slots, o_rooms, o_pen, o_hcv, o_scv, na, nb, keep,
        E);
    return (int)cudaGetLastError();
}
