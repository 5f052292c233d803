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
// negligible at pop <= 256. The phase counters of the previous design
// (one block an island; k5_phases) put four-fifths of a launch in the
// row copy: 8 warps copied `keep` rows with 4-byte loads, a chain of
// dependent L2 round trips through one SM.
//
// Design: a grid of L x ceil(keep / K7_ROWS) blocks. Every block loads
// its island's n (penalty, scv) keys into shared memory and ranks all n
// candidates by counting the ones that precede each in (penalty, scv,
// index) order, index being parents first then children, which is the
// stable lexsort's order — cheap, and duplicated so that no block waits
// for another. It then copies only its own K7_ROWS output rows: the
// penalty terms, and the slots and rooms with 16-byte loads and stores
// when E % 4 == 0 and every row pointer is 16-byte aligned (8-byte or
// 4-byte ones otherwise), the block's threads over all of its rows'
// words at once (rows_dev.cuh, shared with K11).
// The migrate entry reads another island's rows, so it is a launch of its
// own after the truncation, reading the truncation's output and writing a
// new buffer: no block reads what a block of the same launch writes, and
// the emigrants are read from the input, as `_migrate` snapshots them
// (which matters at pop 3, where row 1 is both an emigrant and a victim).
// With one island the ring closes on itself. Populations under 3 do not
// migrate (the wrapper returns them unchanged). With `gain` (the quality
// telemetry, islands.py:213 _migrate return_gain), thread 0 of each
// island's first block, which holds the island's new row 0, also writes
// max(reported best before - after, 0) in int32 (scv once feasible,
// else hcv * 1e6 + scv, wrapping as XLA's int32 does); without it
// nothing more is done.
#include "rows_dev.cuh"

// threads of a block (the CPU stand-in builds it small)
#ifndef K7_THREADS
#define K7_THREADS 256
#endif
// output rows a block copies
#ifndef K7_ROWS
#define K7_ROWS 2
#endif

__device__ __forceinline__ bool k7_less(int p1, int s1, int i1, int p2,
                                        int s2, int i2) {
    return p1 < p2 || (p1 == p2 && (s1 < s2 || (s1 == s2 && i1 < i2)));
}

// Rank the n candidates (cp, cs) of this block's island by counting and
// copy the source rows `src_row[i]` (a row of `from[src_buf[i]]`) of
// those ranked in [o0, o1) to out rows `out0 + rank`; `vec`: the width
// in ints the rows move in.
__device__ __forceinline__ void k7_rank_and_copy(
    const int* cp, const int* cs, const int* src_buf, const int* src_row,
    int* dst, int n, int o0, int o1, const TTRows* from, TTRowsOut out,
    size_t out0, int E, int vec) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = cp[i], s = cs[i];
        int rank = 0;
        for (int j = 0; j < n; ++j)
            rank += k7_less(cp[j], cs[j], j, p, s, i) ? 1 : 0;
        if (rank >= o0 && rank < o1) dst[rank - o0] = i;
    }
    __syncthreads();
    TT_PROF(1);
    tt_copy_rows(dst, o1 - o0, src_buf, src_row, from, out, out0 + o0, E,
                 vec);
    TT_PROF(2);
    TT_PROF_BARRIER();
    TT_PROF(3);
}

__global__ void __launch_bounds__(K7_THREADS) survivors_kernel(
    TTRows a, TTRows b, TTRowsOut out, int na, int nb, int keep, int E,
    int vec) {
    extern __shared__ int k7_smem[];
    const int n = na + nb;
    const int per = (keep + K7_ROWS - 1) / K7_ROWS;
    const int l = blockIdx.x / per, o0 = (blockIdx.x % per) * K7_ROWS;
    const int o1 = min(keep, o0 + K7_ROWS);
    TT_PROF_START();
    int* cp = k7_smem;          // (n,) penalty
    int* cs = cp + n;           // (n,) scv
    int* buf = cs + n;          // (n,) 0 parents / 1 children
    int* row = buf + n;         // (n,) row in that buffer
    int* dst = row + n;         // (K7_ROWS,) candidate of each output row
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        bool par = i < na;
        int r = par ? l * na + i : l * nb + (i - na);
        buf[i] = par ? 0 : 1;
        row[i] = r;
        cp[i] = par ? a.pen[r] : b.pen[r];
        cs[i] = par ? a.scv[r] : b.scv[r];
    }
    __syncthreads();
    TT_PROF(0);
    TTRows from[2] = {a, b};
    k7_rank_and_copy(cp, cs, buf, row, dst, n, o0, o1, from, out,
                     (size_t)l * keep, E, vec);
}

// the reported best (jsonl.reported_best) in int32, wrapping
__device__ __forceinline__ int k7_reported(int hcv, int scv) {
    return hcv == 0 ? scv
                    : (int)((unsigned)hcv * 1000000u + (unsigned)scv);
}

__global__ void __launch_bounds__(K7_THREADS) migrate_kernel(
    TTRows in, TTRowsOut out, int* __restrict__ gain, int L, int pop, int E,
    int vec) {
    extern __shared__ int k7_smem[];
    const int per = (pop + K7_ROWS - 1) / K7_ROWS;
    const int l = blockIdx.x / per, o0 = (blockIdx.x % per) * K7_ROWS;
    const int o1 = min(pop, o0 + K7_ROWS);
    TT_PROF_START();
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
    TT_PROF(0);
    k7_rank_and_copy(cp, cs, buf, row, dst, pop, o0, o1, &in, out,
                     (size_t)l * pop, E, vec);
    if (gain && o0 == 0 && threadIdx.x == 0) {
        const int b = l * pop, a = row[dst[0]];
        const int d = (int)((unsigned)k7_reported(in.hcv[b], in.scv[b])
                            - (unsigned)k7_reported(in.hcv[a], in.scv[a]));
        gain[l] = d > 0 ? d : 0;
    }
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
    size_t smem = sizeof(int) * (4 * (size_t)(na + nb) + K7_ROWS);
    cudaError_t err = tt_set_smem(survivors_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const void* rows[6] = {a_slots, a_rooms, b_slots, b_rooms, out_slots,
                           out_rooms};
    TTRows a = {a_slots, a_rooms, a_pen, a_hcv, a_scv};
    TTRows b = {b_slots, b_rooms, b_pen, b_hcv, b_scv};
    TTRowsOut out = {out_slots, out_rooms, out_pen, out_hcv, out_scv};
    const int grid = L * ((keep + K7_ROWS - 1) / K7_ROWS);
    survivors_kernel<<<grid, K7_THREADS, smem, (cudaStream_t)stream>>>(
        a, b, out, na, nb, keep, E, tt_rows_vec(E, rows, 6));
    return (int)cudaGetLastError();
}

extern "C" int tt_migrate(
    const int* slots, const int* rooms, const int* pen, const int* hcv,
    const int* scv, int* out_slots, int* out_rooms, int* out_pen,
    int* out_hcv, int* out_scv, int* gain, int L, int pop, int E,
    void* stream) {
    if (L <= 0 || pop < 3 || E <= 0) return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * (4 * (size_t)pop + K7_ROWS);
    cudaError_t err = tt_set_smem(migrate_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const void* rows[4] = {slots, rooms, out_slots, out_rooms};
    TTRows in = {slots, rooms, pen, hcv, scv};
    TTRowsOut out = {out_slots, out_rooms, out_pen, out_hcv, out_scv};
    const int grid = L * ((pop + K7_ROWS - 1) / K7_ROWS);
    migrate_kernel<<<grid, K7_THREADS, smem, (cudaStream_t)stream>>>(
        in, out, gain, L, pop, E, tt_rows_vec(E, rows, 4));
    return (int)cudaGetLastError();
}
