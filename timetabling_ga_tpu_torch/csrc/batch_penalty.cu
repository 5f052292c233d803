// K2: full fitness of a population: (penalty, hcv, scv) per individual.
//
// Replaces timetabling_ga_tpu/ops/fitness.py:235 `batch_penalty` (with
// `compute_hcv` :57, `attendance_matrix` :95, `scv_from_attendance`
// :106, `anchor_cost` :152), which XLA runs as vmapped one-hot
// contractions: occupancy X @ Y^T, correlation X^T C X and attendance
// A = attends @ X^T, all in float32 over exact small integers.
//
// Bound on this card: bytes, and far below them latency. One individual
// reads 2*E int32 genes; the problem data (conflict bitsets, CSR lists)
// is shared by the whole population and stays in L2. The work is
// E*ceil(E/32) popcounts plus one pass over the attendance list.
//
// Design: one CTA per individual, everything in shared memory and int32:
//   room clashes   a (T, R) histogram; sum n(n-1)/2
//   correlations   each live event's conflict-bitset row ANDed with its
//                  slot's live-event bitset, popcounted; minus the
//                  diagonal, halved ((full - diag)/2 as in compute_hcv)
//   unsuitable     gathered from `possible`, masked by the live flag
//   scv            each student's 64-bit attended-slot mask built from
//                  its event list; per day, run-of-3 and single-class
//                  counts are bit operations; last slots weigh
//                  student_count
//   penalty        scv if hcv == 0 else 1e6 + hcv, plus the anchor term
#include "common.cuh"

#define K2_THREADS 256

__global__ void batch_penalty_kernel(
    const int* __restrict__ slots, const int* __restrict__ rooms,
    const uint8_t* __restrict__ possible, const int* __restrict__ live,
    const int* __restrict__ student_count,
    const uint32_t* __restrict__ conflict_bits,
    const int* __restrict__ stu_ptr, const int* __restrict__ stu_ev,
    const int* __restrict__ anchor_slots, const int* __restrict__ anchor_w,
    int* __restrict__ pen, int* __restrict__ hcv, int* __restrict__ scv,
    int E, int R, int S, int T, int spd, int W, int diag) {
    extern __shared__ int smem[];
    int* sl = smem;                                    // (E,)
    int* occ = sl + E;                                 // (T, R)
    uint32_t* sbits = (uint32_t*)(occ + T * R);        // (T, W)
    int* scratch = (int*)(sbits + T * W);              // (warps,)
    int p = blockIdx.x;
    const int* s_p = slots + (size_t)p * E;
    const int* r_p = rooms + (size_t)p * E;
    for (int i = threadIdx.x; i < T * R; i += blockDim.x) occ[i] = 0;
    for (int i = threadIdx.x; i < T * W; i += blockDim.x) sbits[i] = 0u;
    for (int i = threadIdx.x; i < E; i += blockDim.x) sl[i] = s_p[i];
    __syncthreads();

    int unsuit = 0, last = 0, anchor = 0;
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        int t = sl[e];
        int r = r_p[e];
        if (live[e]) {
            atomicAdd(&occ[t * R + r], 1);
            atomicOr(&sbits[t * W + (e >> 5)], 1u << (e & 31));
            unsuit += possible[e * R + r] ? 0 : 1;
        }
        if (t % spd == spd - 1) last += student_count[e];
        anchor += anchor_w[e] * (t != anchor_slots[e] ? 1 : 0);
    }
    __syncthreads();

    int pair2 = 0, corr = 0, soft = 0;
    for (int i = threadIdx.x; i < T * R; i += blockDim.x) {
        int n = occ[i];
        pair2 += n * (n - 1);
    }
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        if (!live[e]) continue;
        const uint32_t* row = conflict_bits + (size_t)e * W;
        const uint32_t* slot_row = sbits + sl[e] * W;
        for (int w = 0; w < W; ++w) corr += __popc(row[w] & slot_row[w]);
    }
    int D = T / spd;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        uint64_t mask = 0ull;
        for (int k = stu_ptr[s]; k < stu_ptr[s + 1]; ++k)
            mask |= 1ull << sl[stu_ev[k]];
        for (int d = 0; d < D; ++d) soft += tt_day_scv(tt_day_bits(mask, d, spd));
    }

    pair2 = tt_block_sum(pair2, scratch);
    corr = tt_block_sum(corr, scratch);
    unsuit = tt_block_sum(unsuit, scratch);
    last = tt_block_sum(last, scratch);
    soft = tt_block_sum(soft, scratch);
    anchor = tt_block_sum(anchor, scratch);
    if (threadIdx.x == 0) {
        // compute_hcv: (sum n(n-1) * 0.5 + (full - diag) * 0.5) -> int32
        int h = (pair2 + corr - diag) / 2 + unsuit;
        int sc = last + soft;
        hcv[p] = h;
        scv[p] = sc;
        pen[p] = (h == 0 ? sc : TT_INFEASIBLE_OFFSET + h) + anchor;
    }
}

extern "C" int tt_batch_penalty(
    const int* slots, const int* rooms, const uint8_t* possible,
    const int* live, const int* student_count, const uint32_t* conflict_bits,
    const int* stu_ptr, const int* stu_ev, const int* anchor_slots,
    const int* anchor_w, int* pen, int* hcv, int* scv, int P, int E, int R,
    int S, int T, int spd, int W, int diag, void* stream) {
    if (T > 64 || spd > 32 || P <= 0) return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(int) * ((size_t)E + (size_t)T * R + (size_t)T * W
                                 + K2_THREADS / 32);
    cudaError_t err = tt_set_smem(batch_penalty_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    batch_penalty_kernel<<<P, K2_THREADS, smem, (cudaStream_t)stream>>>(
        slots, rooms, possible, live, student_count, conflict_bits, stu_ptr,
        stu_ev, anchor_slots, anchor_w, pen, hcv, scv, E, R, S, T, spd, W,
        diag);
    return (int)cudaGetLastError();
}
