// K7: survivor selection of every island in one launch, and the ring
// migration (its migrate entry).
//
// Replaces the (mu+lambda) truncation of timetabling_ga_tpu/ops/ga.py
// :276-293 `generation` (a stable jnp.lexsort of parents + children by
// (penalty, scv), the first pop_size kept; also the sort of `evaluate`
// :105) and parallel/islands.py:213 `_migrate` (rows 0/1 of each island
// to its neighbours' rows -1/-2, then a re-sort per island). The port
// ran them as two stable torch sorts plus gathers of every field.
//
// Bound on this card: bytes. The survivors' rows are copied once (2*E
// int32 a row); the rank counting is (2 pop)^2 compares an island,
// negligible at pop <= 256.
//
// Design: one block per island. The entry ranks each candidate row by
// counting the rows that precede it in (penalty, scv, index) order,
// index being parents first then children, which is the stable
// lexsort's order; the rows ranked below `keep` are written to their
// rank, a warp per row. The migrate entry reads another island's rows,
// so it is a launch of its own after the truncation, reading the
// truncation's output and writing a new buffer: no block reads what a
// block of the same launch writes, and the emigrants are read before any
// write, as `_migrate` snapshots them (which matters at pop 3, where row
// 1 is both an emigrant and a victim). With one island the ring closes
// on itself. Populations under 3 do not migrate (the wrapper returns
// them unchanged).
#include "common.cuh"

#define K7_THREADS 256

__device__ __forceinline__ bool k7_less(int p1, int s1, int i1, int p2,
                                        int s2, int i2) {
    return p1 < p2 || (p1 == p2 && (s1 < s2 || (s1 == s2 && i1 < i2)));
}

struct K7Rows {
    const int* slots; const int* rooms;
    const int* pen; const int* hcv; const int* scv;
};

struct K7Out {
    int* slots; int* rooms; int* pen; int* hcv; int* scv;
};

// Rank the n candidates (cp, cs) of this block by counting, then copy
// the source rows `src_row[i]` (a row of `from[src_buf[i]]`) of those
// ranked below `keep` to out rows `out0 + rank`.
__device__ __forceinline__ void k7_rank_and_copy(
    const int* cp, const int* cs, const int* src_buf, const int* src_row,
    int* dst, int n, int keep, const K7Rows* from, K7Out out,
    size_t out0, int E) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        int rank = 0;
        for (int j = 0; j < n; ++j)
            rank += k7_less(cp[j], cs[j], j, cp[i], cs[i], i) ? 1 : 0;
        if (rank < keep) dst[rank] = i;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < keep; o += blockDim.x) {
        int i = dst[o];
        const K7Rows& f = from[src_buf[i]];
        size_t r = (size_t)src_row[i];
        out.pen[out0 + o] = f.pen[r];
        out.hcv[out0 + o] = f.hcv[r];
        out.scv[out0 + o] = f.scv[r];
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    for (int o = warp; o < keep; o += n_warps) {
        int i = dst[o];
        const K7Rows& f = from[src_buf[i]];
        const int* s = f.slots + (size_t)src_row[i] * E;
        const int* r = f.rooms + (size_t)src_row[i] * E;
        int* so = out.slots + (out0 + o) * E;
        int* ro = out.rooms + (out0 + o) * E;
        for (int e = lane; e < E; e += 32) {
            so[e] = s[e];
            ro[e] = r[e];
        }
    }
}

__global__ void __launch_bounds__(K7_THREADS) survivors_kernel(
    K7Rows a, K7Rows b, K7Out out, int na, int nb, int keep, int E) {
    extern __shared__ int k7_smem[];
    const int n = na + nb, l = blockIdx.x;
    int* cp = k7_smem;          // (n,) penalty
    int* cs = cp + n;           // (n,) scv
    int* buf = cs + n;          // (n,) 0 parents / 1 children
    int* row = buf + n;         // (n,) row in that buffer
    int* dst = row + n;         // (keep,) candidate of each output row
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        bool par = i < na;
        int r = par ? l * na + i : l * nb + (i - na);
        buf[i] = par ? 0 : 1;
        row[i] = r;
        cp[i] = par ? a.pen[r] : b.pen[r];
        cs[i] = par ? a.scv[r] : b.scv[r];
    }
    __syncthreads();
    K7Rows from[2] = {a, b};
    k7_rank_and_copy(cp, cs, buf, row, dst, n, keep, from, out,
                     (size_t)l * keep, E);
}

__global__ void __launch_bounds__(K7_THREADS) migrate_kernel(
    K7Rows in, K7Out out, int L, int pop, int E) {
    extern __shared__ int k7_smem[];
    const int l = blockIdx.x;
    int* cp = k7_smem;
    int* cs = cp + pop;
    int* buf = cs + pop;
    int* row = buf + pop;
    int* dst = row + pop;
    for (int j = threadIdx.x; j < pop; j += blockDim.x) {
        int r = l * pop + j;
        // row -1 <- the previous island's best, row -2 <- the next
        // island's second best (ga.cpp:522-535)
        if (j == pop - 1) r = ((l + L - 1) % L) * pop;
        else if (j == pop - 2) r = ((l + 1) % L) * pop + 1;
        buf[j] = 0;
        row[j] = r;
        cp[j] = in.pen[r];
        cs[j] = in.scv[r];
    }
    __syncthreads();
    k7_rank_and_copy(cp, cs, buf, row, dst, pop, pop, &in, out,
                     (size_t)l * pop, E);
}

extern "C" int tt_survivors(
    const int* a_slots, const int* a_rooms, const int* a_pen,
    const int* a_hcv, const int* a_scv, const int* b_slots,
    const int* b_rooms, const int* b_pen, const int* b_hcv,
    const int* b_scv, int* out_slots, int* out_rooms, int* out_pen,
    int* out_hcv, int* out_scv, int L, int na, int nb, int keep, int E,
    void* stream) {
    if (L <= 0 || na < 0 || nb < 0 || keep <= 0 || keep > na + nb || E <= 0)
        return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * (4 * (size_t)(na + nb) + keep);
    cudaError_t err = tt_set_smem(survivors_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    K7Rows a = {a_slots, a_rooms, a_pen, a_hcv, a_scv};
    K7Rows b = {b_slots, b_rooms, b_pen, b_hcv, b_scv};
    K7Out out = {out_slots, out_rooms, out_pen, out_hcv, out_scv};
    survivors_kernel<<<L, K7_THREADS, smem, (cudaStream_t)stream>>>(
        a, b, out, na, nb, keep, E);
    return (int)cudaGetLastError();
}

extern "C" int tt_migrate(
    const int* slots, const int* rooms, const int* pen, const int* hcv,
    const int* scv, int* out_slots, int* out_rooms, int* out_pen,
    int* out_hcv, int* out_scv, int L, int pop, int E, void* stream) {
    if (L <= 0 || pop < 3 || E <= 0) return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * 5 * (size_t)pop;
    cudaError_t err = tt_set_smem(migrate_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    K7Rows in = {slots, rooms, pen, hcv, scv};
    K7Out out = {out_slots, out_rooms, out_pen, out_hcv, out_scv};
    migrate_kernel<<<L, K7_THREADS, smem, (cudaStream_t)stream>>>(
        in, out, L, pop, E);
    return (int)cudaGetLastError();
}
