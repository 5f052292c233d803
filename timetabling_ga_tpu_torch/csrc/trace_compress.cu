// K13: the trace compression of `--trace-mode deltas|stats` (JAX
// timetabling_ga_tpu/parallel/islands.py:595 _compress_trace, with
// :435 _reported_f32 and :445 _moment_rows).
//
// compress_trace: one warp an island walks its (T, 2) per-generation
// (hcv, scv) best trace in chunks of 32 rows. A chunk's rows become
// 64-bit keys (hcv << 32 | scv: lexicographic order, both >= 0); a
// shuffle scan gives each row the minimum of the rows before it, joined
// with the carry of the chunks before (from the sentinel (2^31-1,
// 2^31-1)); a row below that minimum is a strict improvement (ties are
// not). Pass 1 counts the improvements with ballots and __popc; pass 2
// repeats the scan and stores the last K of them as (gen, hcv, scv) rows
// at their rank minus max(count - K, 0) (on overflow the earliest are
// dropped), the unused rows as sentinels, then the count. In stats mode
// pass 1 also takes the reported values (scv once feasible, else
// hcv * 1e6 + scv, in float32 without contraction) into per-lane sums
// of the values and of their float32 squares in double, and their min
// and max; a warp reduction, then lane 0 writes the mean, the variance
// clamped at 0, min and max as float32 bits.
//
// moment_rows: the same four moments of (L, n) reported values, a warp a
// row, written as (4, L) (the polish and LAHC stats rows).
//
// The sums' order differs from XLA's and the plain version's; the double
// accumulation keeps the mean within a relative 1e-6 of theirs.
#include "common.cuh"

#define K13_SENTINEL 2147483647

// per-lane moment accumulators of reported values
struct TTMoments {
    double sum, sum2;
    float mn, mx;
};

__device__ __forceinline__ float tt_reported_f32(int h, int s) {
    float fs = (float)s;
    return h == 0 ? fs : __fadd_rn(__fmul_rn((float)h, 1e6f), fs);
}

__device__ __forceinline__ void tt_moments_add(TTMoments& m, float r) {
    m.sum += (double)r;
    m.sum2 += (double)__fmul_rn(r, r);
    m.mn = fminf(m.mn, r);
    m.mx = fmaxf(m.mx, r);
}

// Warp-reduce the lanes' moments and, on lane 0, write mean, var, min,
// max of `n` values to out[0], out[stride], out[2 stride], out[3 stride].
__device__ __forceinline__ void tt_moments_store(TTMoments m, int n,
                                                 int* out, int stride) {
    const int lane = threadIdx.x & 31;
    for (int off = 16; off > 0; off >>= 1) {
        m.sum += __shfl_xor_sync(TT_FULL_MASK, m.sum, off);
        m.sum2 += __shfl_xor_sync(TT_FULL_MASK, m.sum2, off);
        m.mn = fminf(m.mn, __shfl_xor_sync(TT_FULL_MASK, m.mn, off));
        m.mx = fmaxf(m.mx, __shfl_xor_sync(TT_FULL_MASK, m.mx, off));
    }
    if (lane == 0) {
        const float cnt = (float)(n > 1 ? n : 1);
        const float mean = __fdiv_rn((float)m.sum, cnt);
        const float var = fmaxf(
            __fsub_rn(__fdiv_rn((float)m.sum2, cnt), __fmul_rn(mean, mean)),
            0.0f);
        out[0] = __float_as_int(mean);
        out[stride] = __float_as_int(var);
        out[2 * stride] = __float_as_int(m.mn);
        out[3 * stride] = __float_as_int(m.mx);
    }
}

__device__ __forceinline__ TTMoments tt_moments_empty() {
    TTMoments m;
    m.sum = 0.0;
    m.sum2 = 0.0;
    m.mn = __int_as_float(0x7f800000);   // +inf
    m.mx = __int_as_float(0xff800000);   // -inf
    return m;
}

// One chunk's scan: whether this lane's row is a strict improvement over
// every row before it (from `carry`), and the carry after the chunk.
__device__ __forceinline__ bool tt_improves(long long key, long long& carry) {
    const int lane = threadIdx.x & 31;
    long long incl = key;
    for (int d = 1; d < 32; d <<= 1) {
        long long o = __shfl_up_sync(TT_FULL_MASK, incl, d);
        if (lane >= d) incl = o < incl ? o : incl;
    }
    long long before = __shfl_up_sync(TT_FULL_MASK, incl, 1);
    before = lane == 0 ? carry : (before < carry ? before : carry);
    const long long last = __shfl_sync(TT_FULL_MASK, incl, 31);
    carry = last < carry ? last : carry;
    return key < before;
}

__global__ void __launch_bounds__(32) compress_trace_kernel(
    const int* __restrict__ trace, int* __restrict__ out, int T, int K,
    int stats) {
    const int isl = blockIdx.x;
    const int lane = threadIdx.x;
    const int W = 3 * K + 1 + (stats ? 4 : 0);
    const int* tr = trace + (size_t)isl * T * 2;
    int* o = out + (size_t)isl * W;
    const long long sent = ((long long)K13_SENTINEL << 32) | K13_SENTINEL;
    const long long none = 0x7fffffffffffffffLL;
    TTMoments m = tt_moments_empty();
    long long carry = sent;
    int count = 0;
    for (int c = 0; c < T; c += 32) {
        const int t = c + lane;
        long long key = none;
        if (t < T) {
            const int2 hs = reinterpret_cast<const int2*>(tr)[t];
            key = ((long long)hs.x << 32) | (unsigned)hs.y;
            if (stats) tt_moments_add(m, tt_reported_f32(hs.x, hs.y));
        }
        count += __popc(__ballot_sync(TT_FULL_MASK, tt_improves(key, carry)));
    }
    const int skip = count > K ? count - K : 0;
    const int kept = count - skip;
    for (int j = kept * 3 + lane; j < 3 * K; j += 32) o[j] = K13_SENTINEL;
    carry = sent;
    int base = 0;
    for (int c = 0; c < T && base < count; c += 32) {
        const int t = c + lane;
        long long key = none;
        int2 hs = {0, 0};
        if (t < T) {
            hs = reinterpret_cast<const int2*>(tr)[t];
            key = ((long long)hs.x << 32) | (unsigned)hs.y;
        }
        const bool imp = tt_improves(key, carry);
        const unsigned ball = __ballot_sync(TT_FULL_MASK, imp);
        const int slot = base + __popc(ball & ((1u << lane) - 1u)) - skip;
        if (imp && slot >= 0) {
            o[3 * slot] = t;
            o[3 * slot + 1] = hs.x;
            o[3 * slot + 2] = hs.y;
        }
        base += __popc(ball);
    }
    if (lane == 0) o[3 * K] = count;
    if (stats) tt_moments_store(m, T, o + 3 * K + 1, 1);
}

__global__ void __launch_bounds__(32) moment_rows_kernel(
    const int* __restrict__ hcv, const int* __restrict__ scv,
    int* __restrict__ out, int L, int n) {
    const int row = blockIdx.x;
    TTMoments m = tt_moments_empty();
    for (int i = threadIdx.x; i < n; i += 32)
        tt_moments_add(m, tt_reported_f32(hcv[(size_t)row * n + i],
                                          scv[(size_t)row * n + i]));
    tt_moments_store(m, n, out + row, L);
}

extern "C" int tt_compress_trace(const int* trace, int* out, int L, int T,
                                 int K, int stats, void* stream) {
    if (L <= 0 || T <= 0 || K <= 0 || K > T)
        return (int)cudaErrorInvalidValue;
    compress_trace_kernel<<<L, 32, 0, (cudaStream_t)stream>>>(
        trace, out, T, K, stats);
    return (int)cudaGetLastError();
}

extern "C" int tt_moment_rows(const int* hcv, const int* scv, int* out,
                              int L, int n, void* stream) {
    if (L <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    moment_rows_kernel<<<L, 32, 0, (cudaStream_t)stream>>>(hcv, scv, out,
                                                           L, n);
    return (int)cudaGetLastError();
}
