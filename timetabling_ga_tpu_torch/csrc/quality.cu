// K14: the quality telemetry's device block (`--quality`), two entries.
//
// Replaces the quality half of timetabling_ga_tpu/ops/ga.py:221-302
// `generation(with_quality=True)` (the crossover and mutation attempts
// and wins, summed with the sweep's accepted-move counts) and
// parallel/islands.py:495 `_div_stats` (with :537 `_div_rows` and :478
// `_hamming_stride`): per island, the min-shifted float32 moments of
// penalty and scv and a coprime-stride Hamming sample of the slots. XLA
// ran them as a dozen small reductions fused into the island runner; the
// port's plain versions are as many torch launches.
//
// Bound on this card: bytes, by a little. Each entry reads a few KB an
// island (its flags, scores and, for div_stats, min(pop, HAMMING_PAIRS)
// pairs of slot rows) and does about as many integer operations; both
// bounds sit orders below a launch's own latency (~2-3 us), its floor.
//
// Design: one block of K14_THREADS an island.
//   quality_ops, once a generation: each thread takes rows i = tid, tid +
//     K14_THREADS, ... of its island and counts do_x, do_x & win, do_m,
//     do_m & win (win: the child's penalty after its local search below
//     its base parent's, tournament A's winner, K6's out_parent) and,
//     when given, the row's K5 Move1/Move2/Move3 accepts; block sums of
//     the seven ints (tt_block_sum) are added by thread 0 into the (L, 7)
//     accumulator, which stays on the card for the dispatch.
//   div_stats, once a dispatch: min and max of the float32 penalties and
//     scvs by block reduction (exact in any order); then the shifted
//     values c = x - min (float32, exact subtraction rounding as XLA's)
//     summed, and their float32 squares summed, in double, so each sum
//     is exact while it stays below 2^53 and the float32 mean
//     fdiv_rn(float(sum c), n) equals XLA's whenever its float32 sum is
//     exact (an integer sum below 2^24), within a relative 1e-6 of it
//     otherwise; var = max(mean(c*c) - mean_c^2, 0) in float32. The
//     Hamming sample: pairs i < k of rows i and (i + stride) mod pop
//     (`stride` from the wrapper, _hamming_stride), each differing
//     event weighted by its event_mask value, the weights summed in
//     double (exact: 0/1 weights, counts far below 2^53), then one
//     float32 division by the float32 product k * live, as XLA computes
//     it. Thread 0 writes the nine float32 values' bits.
//     Its lane form (the serve lanes, JAX's vmap of _div_stats over the
//     lanes' problems): `mask_stride` E, and block l reads its own lane's
//     mask row at event_mask + l * E for `live` and `diff`; 0 shares one
//     (E,) mask among the islands.
#include "common.cuh"

#ifndef K14_THREADS
#define K14_THREADS 256
#endif
#define K14_WARPS (K14_THREADS / 32)
#define K14_N_OPS 7
#define K14_N_DIV 9
// the reduction scratch, dynamic shared memory: a double and a float a warp
#define K14_SMEM (K14_WARPS * (sizeof(double) + sizeof(float)))

__global__ void __launch_bounds__(K14_THREADS) quality_ops_kernel(
    const uint8_t* __restrict__ do_x, const uint8_t* __restrict__ do_m,
    const int* __restrict__ parent, const int* __restrict__ child_pen,
    const int* __restrict__ parent_pen, const int* __restrict__ sweep_ops,
    int* __restrict__ acc, int pop) {
    extern __shared__ __align__(16) unsigned char k14_smem[];
    int* scratch = (int*)k14_smem;           // an int a warp
    const int l = blockIdx.x;
    int n[K14_N_OPS] = {0, 0, 0, 0, 0, 0, 0};
    for (int i = threadIdx.x; i < pop; i += K14_THREADS) {
        const int c = l * pop + i;
        const int win = child_pen[c] < parent_pen[parent[c]] ? 1 : 0;
        const int x = do_x[c] ? 1 : 0, m = do_m[c] ? 1 : 0;
        n[0] += x;
        n[1] += x & win;
        n[2] += m;
        n[3] += m & win;
        if (sweep_ops)
            for (int k = 0; k < 3; ++k) n[4 + k] += sweep_ops[c * 3 + k];
    }
    for (int k = 0; k < K14_N_OPS; ++k) {
        const int total = tt_block_sum(n[k], scratch);
        if (threadIdx.x == 0) acc[l * K14_N_OPS + k] += total;
    }
}

// block-wide min (is_max = false) or max of v; `red` holds a float a warp
__device__ __forceinline__ float k14_extreme(float v, bool is_max,
                                             float* red) {
    for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(TT_FULL_MASK, v, off);
        v = is_max ? fmaxf(v, o) : fminf(v, o);
    }
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < K14_WARPS; ++w)
        r = is_max ? fmaxf(r, red[w]) : fminf(r, red[w]);
    return r;
}

__device__ __forceinline__ double k14_sum(double v, double* red) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(TT_FULL_MASK, v, off);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    double r = 0.0;
    for (int w = 0; w < K14_WARPS; ++w) r += red[w];
    return r;
}

// mean, var, min, max of the float32 values of x[0..n) (ints), as
// JAX's min-shifted formula, into out[0..4) as float32 bits (thread 0)
__device__ __forceinline__ void k14_moments(const int* x, int n, int* out,
                                            float* fred, double* dred) {
    float mn = __int_as_float(0x7f800000), mx = __int_as_float(0xff800000);
    for (int i = threadIdx.x; i < n; i += K14_THREADS) {
        const float v = (float)x[i];
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
    }
    mn = k14_extreme(mn, false, fred);
    mx = k14_extreme(mx, true, fred);
    double s = 0.0, s2 = 0.0;
    for (int i = threadIdx.x; i < n; i += K14_THREADS) {
        const float c = __fsub_rn((float)x[i], mn);
        s += (double)c;
        s2 += (double)__fmul_rn(c, c);
    }
    s = k14_sum(s, dred);
    s2 = k14_sum(s2, dred);
    if (threadIdx.x == 0) {
        const float cnt = (float)n;
        const float mean_c = __fdiv_rn((float)s, cnt);
        const float var = fmaxf(
            __fsub_rn(__fdiv_rn((float)s2, cnt), __fmul_rn(mean_c, mean_c)),
            0.0f);
        out[0] = __float_as_int(__fadd_rn(mn, mean_c));
        out[1] = __float_as_int(var);
        out[2] = __float_as_int(mn);
        out[3] = __float_as_int(mx);
    }
}

__global__ void __launch_bounds__(K14_THREADS) div_stats_kernel(
    const int* __restrict__ pen, const int* __restrict__ scv,
    const int* __restrict__ slots, const float* __restrict__ event_mask,
    int* __restrict__ out, int pop, int E, int k_pairs, int stride,
    int mask_stride) {
    extern __shared__ __align__(16) unsigned char k14_smem[];
    double* dred = (double*)k14_smem;        // a double a warp
    float* fred = (float*)(dred + K14_WARPS);  // a float a warp
    const int l = blockIdx.x;
    event_mask += (size_t)l * mask_stride;   // this lane's row, or the one
    int* o = out + (size_t)l * K14_N_DIV;
    k14_moments(pen + (size_t)l * pop, pop, o, fred, dred);
    k14_moments(scv + (size_t)l * pop, pop, o + 4, fred, dred);
    if (stride == 0) {
        if (threadIdx.x == 0) o[8] = __float_as_int(0.0f);
        return;
    }
    double diff = 0.0, live = 0.0;
    for (int e = threadIdx.x; e < E; e += K14_THREADS)
        live += (double)event_mask[e];
    const int* rows = slots + (size_t)l * pop * E;
    for (int j = threadIdx.x; j < k_pairs * E; j += K14_THREADS) {
        const int i = j / E, e = j % E;
        const int i2 = (i + stride) % pop;
        if (rows[(size_t)i * E + e] != rows[(size_t)i2 * E + e])
            diff += (double)event_mask[e];
    }
    diff = k14_sum(diff, dred);
    live = k14_sum(live, dred);
    if (threadIdx.x == 0) {
        const float lv = fmaxf((float)live, 1.0f);
        o[8] = __float_as_int(
            __fdiv_rn((float)diff, __fmul_rn((float)k_pairs, lv)));
    }
}

extern "C" int tt_quality_ops(const uint8_t* do_x, const uint8_t* do_m,
                              const int* parent, const int* child_pen,
                              const int* parent_pen, const int* sweep_ops,
                              int* acc, int L, int pop, void* stream) {
    if (L <= 0 || pop <= 0) return (int)cudaErrorInvalidValue;
    quality_ops_kernel<<<L, K14_THREADS, K14_SMEM, (cudaStream_t)stream>>>(
        do_x, do_m, parent, child_pen, parent_pen, sweep_ops, acc, pop);
    return (int)cudaGetLastError();
}

extern "C" int tt_div_stats(const int* pen, const int* scv, const int* slots,
                            const float* event_mask, int* out, int L,
                            int pop, int E, int k_pairs, int stride,
                            int mask_stride, void* stream) {
    if (L <= 0 || pop <= 0 || E <= 0 || k_pairs < 0 || k_pairs > pop
        || stride < 0 || stride >= pop
        || (mask_stride != 0 && mask_stride != E))
        return (int)cudaErrorInvalidValue;
    div_stats_kernel<<<L, K14_THREADS, K14_SMEM, (cudaStream_t)stream>>>(
        pen, scv, slots, event_mask, out, pop, E, k_pairs, stride,
        mask_stride);
    return (int)cudaGetLastError();
}
