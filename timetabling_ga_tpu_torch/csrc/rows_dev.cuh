// Row copies of the selection kernels: K7 (survivors.cu, truncation and
// migration) and K11 (nsga.cu, the NSGA-II survivors). A block copies
// the output rows it owns, the rows' words spread over all of its
// threads at once: 16-byte loads and stores when every row moves as int4,
// 8-byte ones as int2 (comp05s's E = 350), 4-byte ones otherwise
// (`tt_rows_vec`).
#pragma once

#include "common.cuh"

// a population's rows: (P, E) slots and rooms, (P,) penalty terms
struct TTRows {
    const int* slots; const int* rooms;
    const int* pen; const int* hcv; const int* scv;
};

struct TTRowsOut {
    int* slots; int* rooms; int* pen; int* hcv; int* scv;
};

// Output row out0 + o, o < nr, is candidate dst[o]: row src_row[dst[o]]
// of from[src_buf[dst[o]]]. Its penalty terms (a thread a row), slots and
// rooms as words of T (int4, int2 or int; row o's slots are item o * 2 *
// nw + [0, nw), its rooms the next nw). A thread loads its terms and up
// to four words before it stores any, so that the loads are in flight
// together.
template <class T>
__device__ __forceinline__ void tt_copy_rows_as(const int* dst, int nr,
                                                const int* src_buf,
                                                const int* src_row,
                                                const TTRows* from,
                                                TTRowsOut out, size_t out0,
                                                int E) {
    constexpr int U = 4;
    const int nw = E / (int)(sizeof(T) / sizeof(int));
    const int n_items = nr * 2 * nw, nt = blockDim.x;
    const bool terms = (int)threadIdx.x < nr;
    int pen = 0, hcv = 0, scv = 0;
    if (terms) {
        const int i = dst[threadIdx.x];
        const TTRows& f = from[src_buf[i]];
        const size_t r = (size_t)src_row[i];
        pen = f.pen[r];
        hcv = f.hcv[r];
        scv = f.scv[r];
    }
    for (int it0 = threadIdx.x; it0 < n_items; it0 += U * nt) {
        T v[U];
        T* to[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int it = it0 + u * nt;
            to[u] = nullptr;
            if (it < n_items) {
                const int o = it / (2 * nw), q = it - o * 2 * nw;
                const int i = dst[o], rooms = q >= nw;
                const int w = rooms ? q - nw : q;
                const TTRows& f = from[src_buf[i]];
                const int* src =
                    (rooms ? f.rooms : f.slots) + (size_t)src_row[i] * E;
                v[u] = ((const T*)src)[w];
                to[u] = (T*)((rooms ? out.rooms : out.slots)
                             + (out0 + o) * E) + w;
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (to[u]) *to[u] = v[u];
    }
    if (terms) {
        const size_t o = out0 + threadIdx.x;
        out.pen[o] = pen;
        out.hcv[o] = hcv;
        out.scv[o] = scv;
    }
}

// `vec`: the words' width in ints (tt_rows_vec)
__device__ __forceinline__ void tt_copy_rows(const int* dst, int nr,
                                             const int* src_buf,
                                             const int* src_row,
                                             const TTRows* from,
                                             TTRowsOut out, size_t out0,
                                             int E, int vec) {
    if (vec == 4)
        tt_copy_rows_as<int4>(dst, nr, src_buf, src_row, from, out, out0, E);
    else if (vec == 2)
        tt_copy_rows_as<int2>(dst, nr, src_buf, src_row, from, out, out0, E);
    else
        tt_copy_rows_as<int>(dst, nr, src_buf, src_row, from, out, out0, E);
}

// The widest word, in ints, that rows of E int32 at every pointer move
// as: 4 (int4), 2 (int2) or 1
static int tt_rows_vec(int E, const void* const* ptrs, int n) {
    int vec = 4;
    for (; vec > 1; vec /= 2) {
        bool ok = E % vec == 0;
        for (int i = 0; i < n; ++i)
            if (ptrs[i] && ((uintptr_t)ptrs[i] & (4u * vec - 1u)) != 0)
                ok = false;
        if (ok) break;
    }
    return vec;
}
