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
// E*ceil(E/32) popcounts plus one pass over the attendance list. The
// phase counters of the previous design (one 256-thread CTA an
// individual; k5_phases) put a launch at ~14,000 cycles, in chains of
// dependent L2 round trips: the students' CSR walk 27%, the correlation
// rows 20%, the per-event loads 19%, six block reductions 19%.
//
// Design: a thread-block cluster of CS CTAs (K2_THREADS each) an
// individual, launched with cudaLaunchKernelEx (CS 1, 2, 4 or 8; the
// wrapper picks it, ops/fitness.py penalty_cluster). Every CTA stages,
// in one round trip of cp.async copies (all in flight at once), the whole
// row, the live flags, its slice of the students' CSR (students split by
// entries, the boundaries computed on the host, ProblemArrays.stu_split)
// and the conflict rows of its events into shared memory, and builds the
// (T, R) live occupancy and the live slot bitsets there with
// shared-memory atomics. Rank c then scores its share with
// penalty_dev.cuh's body: a CS-th of the occupancy cells, of the events
// (unsuitable rooms, last slot, anchor; their correlation rows) and of
// the students (a group of lanes a student on the staged CSR). Its four
// sums are reduced in one pass; each rank stores them into rank 0's
// shared memory (distributed shared memory) between the two halves of
// the cluster's one barrier (its first arrive came at the start, so the
// stores find every CTA running), and rank 0 writes the individual's
// three terms. A
// CSR slice and rows too large for shared memory are read from global
// memory instead. Integer-exact: equal to the plain version
// (ops/fitness.py) bit for bit. Where the (T, R) occupancy does not fit
// (past ~1,250 rooms at E = 400; the wrapper's stage flag, decided from
// the sizes), the GLOB instance keeps each CTA's in a global scratch row
// and the grid's clusters stride over the individuals, so the scratch is
// sized by the card, not by P.
#include <cooperative_groups.h>

#include "penalty_dev.cuh"

namespace cg = cooperative_groups;

// The two halves of a cluster barrier: every thread of the cluster
// arrives (releasing its shared-memory writes, unless `relaxed`: the
// first arrive, at the start, has none to release), then waits
// (acquiring the others'). A CTA may write another's shared memory only
// after a wait whose arrive every CTA made after it started.
template <bool relaxed>
__device__ __forceinline__ void k2_cluster_arrive(cg::cluster_group& cl) {
#ifdef __CUDA_ARCH__
    if (relaxed)
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" :::
                     "memory");
    else
        asm volatile("barrier.cluster.arrive.release.aligned;\n" :::
                     "memory");
#else
    cl.barrier_arrive();
#endif
}

__device__ __forceinline__ void k2_cluster_wait(cg::cluster_group& cl) {
#ifdef __CUDA_ARCH__
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#else
    cl.barrier_wait();
#endif
}

// threads of a CTA (the CPU stand-in builds it small)
#ifndef K2_THREADS
#define K2_THREADS 256
#endif
// the largest cluster (ops/fitness.py K2_MAX_CLUSTER)
#define K2_MAX_CLUSTER 8
// the most shared memory a CTA stages its CSR slice and conflict rows in
// (the CPU stand-in builds it 0, to run the global-memory path)
#ifndef K2_STAGE_LIMIT
#define K2_STAGE_LIMIT TT_SMEM_LIMIT
#endif

struct K2Args {
    TTPenaltyProblem pp;
    const int* slots; const int* rooms;
    int* pen; int* hcv; int* scv;
    int CS, staged;
    // individuals, and the GLOB instance's occupancy rows (T R ints a CTA)
    int P;
    int* occ_g;
    // rank c's students [s_lo[c], s_lo[c + 1]) and their CSR entries
    // [k_lo[c], k_lo[c + 1])
    int s_lo[K2_MAX_CLUSTER + 1], k_lo[K2_MAX_CLUSTER + 1];
    // shared-memory offsets (ints): rm, live, occ, slot_ev, red, then the
    // staged ptr, ev and conflict rows
    int o_rm, o_live, o_occ, o_bits, o_red, o_ptr, o_ev, o_rows;
};

template <bool GLOB>
__global__ void __launch_bounds__(K2_THREADS) batch_penalty_kernel(K2Args A) {
    extern __shared__ __align__(16) int k2_smem[];
    cg::cluster_group cl = cg::this_cluster();
    const TTPenaltyProblem& pp = A.pp;
    const int E = pp.E, R = pp.R, T = pp.T;
    const int CS = A.CS, rank = CS > 1 ? (int)cl.block_rank() : 0;
    const int tid = threadIdx.x;
    int* sl = k2_smem;                                  // (E,)
    int* rm = k2_smem + A.o_rm;                         // (E,)
    int* live = k2_smem + A.o_live;                     // (E,)
    int* occ = GLOB ? A.occ_g + (size_t)blockIdx.x * T * R
                    : k2_smem + A.o_occ;                // (T, R)
    uint32_t* slot_ev = (uint32_t*)(k2_smem + A.o_bits);  // (T, W)
    int* red = k2_smem + A.o_red;             // warps x 4, then 4 a rank
    TT_PROF_START();
    // individual p, the whole cluster; `first`: the cluster's first
    auto indiv = [&](const int p, const bool first) {
    // the first half of the barrier before rank 0's inbox is written
    // (after an individual before, a release: rank 0's reads of its
    // inbox come before any CTA's next store there)
    if (CS > 1) {
        if (first) k2_cluster_arrive<true>(cl);
        else k2_cluster_arrive<false>(cl);
    }

    // ---- one round trip: the row, the live flags, the rank's CSR slice
    // and its events' conflict rows
    const int s0 = A.s_lo[rank], s1 = A.s_lo[rank + 1];
    const int k0 = A.k_lo[rank], k1 = A.k_lo[rank + 1];
    const int e0 = rank * E / CS, e1 = (rank + 1) * E / CS;
    tt_async_ints(sl, A.slots + (size_t)p * E, E);
    tt_async_ints(rm, A.rooms + (size_t)p * E, E);
    tt_async_ints(live, pp.live, E);
    const int* ptr = pp.stu_ptr + s0;
    const int* ev = pp.stu_ev + k0;
    const uint32_t* rows = pp.conflict_bits + (size_t)e0 * pp.W;
    if (A.staged) {
        int* sp = k2_smem + A.o_ptr;
        int* se = k2_smem + A.o_ev;
        int* sr = k2_smem + A.o_rows;
        tt_async_ints(sp, ptr, s1 - s0 + 1);
        tt_async_ints(se, ev, k1 - k0);
        tt_async_ints(sr, (const int*)rows, (e1 - e0) * pp.W);
        ptr = sp;
        ev = se;
        rows = (const uint32_t*)sr;
    }
    for (int i = tid; i < T * R; i += blockDim.x) occ[i] = 0;
    for (int i = tid; i < T * pp.W; i += blockDim.x) slot_ev[i] = 0u;
    tt_async_wait();
    __syncthreads();
    TT_PROF(0);
    // ---- the live occupancy and slot bitsets of the whole row
    for (int e = tid; e < E; e += blockDim.x)
        if (live[e]) {
            atomicAdd(&occ[sl[e] * R + rm[e]], 1);
            atomicOr(&slot_ev[sl[e] * pp.W + (e >> 5)], 1u << (e & 31));
        }
    __syncthreads();
    TT_PROF(1);

    // ---- this rank's share
    TTPenAcc a = tt_pen_zero();
    const int nc = T * R;
    tt_pen_cells(occ, rank * nc / CS, (rank + 1) * nc / CS, a);
    tt_pen_events(pp, sl, rm, e0, e1, a);
    TT_PROF(2);
    tt_pen_corr(pp, sl, rows, live, slot_ev, nullptr, e0, e1, a);
    TT_PROF(3);
    tt_pen_students_csr(pp, sl, ptr, ev, s0, s1, a);
    TT_PROF(4);
    TT_PROF_BARRIER();
    TT_PROF(5);
    a = tt_pen_block_reduce(a, red);
    TT_PROF(6);

    // ---- the cluster's sums, on rank 0
    if (CS == 1) {
        if (tid == 0) tt_pen_finish(pp, a, A.pen + p, A.hcv + p, A.scv + p);
        TT_PROF(7);
        return;
    }
    // rank 0's inbox: 4 ints a rank
    int* inbox = red + 4 * ((blockDim.x + 31) >> 5);
    k2_cluster_wait(cl);
    if (tid == 0) {
        int* o = cl.map_shared_rank(inbox, 0u) + 4 * rank;
        o[0] = a.h2;
        o[1] = a.unsuit;
        o[2] = a.scv;
        o[3] = a.anchor;
    }
    TT_PROF(7);
    k2_cluster_arrive<false>(cl);
    k2_cluster_wait(cl);
    TT_PROF(8);
    if (rank == 0 && tid < 32) {
        TTPenAcc c = tt_pen_zero();
        if (tid < CS) {
            c.h2 = inbox[4 * tid];
            c.unsuit = inbox[4 * tid + 1];
            c.scv = inbox[4 * tid + 2];
            c.anchor = inbox[4 * tid + 3];
        }
        c.h2 = tt_warp_sum(c.h2);
        c.unsuit = tt_warp_sum(c.unsuit);
        c.scv = tt_warp_sum(c.scv);
        c.anchor = tt_warp_sum(c.anchor);
        if (tid == 0) tt_pen_finish(pp, c, A.pen + p, A.hcv + p, A.scv + p);
    }
    TT_PROF(9);
    };
    if (!GLOB) {
        // a cluster an individual
        indiv(blockIdx.x / CS, true);
        return;
    }
    // the clusters stride over the individuals (a block barrier keeps an
    // individual's staged rows and occupancy until every thread is done)
    for (int p = blockIdx.x / CS; p < A.P; p += gridDim.x / CS) {
        indiv(p, p == (int)blockIdx.x / CS);
        __syncthreads();
    }
}

extern "C" int tt_batch_penalty(
    const int* slots, const int* rooms, const uint8_t* possible,
    const int* live, const int* student_count, const uint32_t* conflict_bits,
    const int* stu_ptr, const int* stu_ev, const int* anchor_slots,
    const int* anchor_w, const int* stu_split, int* pen, int* hcv, int* scv,
    int* occ_g, int P, int E, int R, int S, int T, int spd, int W,
    int diag, int cluster, int stage, int grid, void* stream) {
    // stage bit 0: the occupancy staged; else occ_g holds a T R row for
    // each CTA of the `grid` clusters
    const bool glob = !(stage & 1);
    if (T > 64 || spd > 32 || P <= 0 || E <= 0 || cluster < 1
        || cluster > K2_MAX_CLUSTER || (cluster & (cluster - 1)) != 0
        || (glob && (!occ_g || grid <= 0)))
        return (int)cudaErrorInvalidValue;
    K2Args A;
    A.pp = {possible, live, student_count, conflict_bits, stu_ptr, stu_ev,
            anchor_slots, anchor_w, E, R, S, T, spd, W, diag};
    A.slots = slots; A.rooms = rooms;
    A.pen = pen; A.hcv = hcv; A.scv = scv;
    A.CS = cluster;
    A.P = P;
    A.occ_g = glob ? occ_g : nullptr;
    // stu_split (host memory) holds, for cluster sizes 1, 2, 4, 8 in turn,
    // the CS + 1 student boundaries and then the CS + 1 entry boundaries
    int off = 0;
    for (int c = 1; c < cluster; c *= 2) off += 2 * (c + 1);
    for (int c = 0; c <= cluster; ++c) {
        A.s_lo[c] = stu_split[off + c];
        A.k_lo[c] = stu_split[off + cluster + 1 + c];
    }
    int max_students = 0, max_slice = 0;
    for (int c = 0; c < cluster; ++c) {
        const int ns = A.s_lo[c + 1] - A.s_lo[c];
        const int nk = A.k_lo[c + 1] - A.k_lo[c];
        max_students = ns > max_students ? ns : max_students;
        max_slice = nk > max_slice ? nk : max_slice;
    }
    // int offsets, each region 16-byte aligned
    auto up = [](int x) { return (x + 3) & ~3; };
    const int n_red = 4 * ((K2_THREADS + 31) / 32) + 4 * K2_MAX_CLUSTER;
    const int max_events = (E + cluster - 1) / cluster;
    A.o_rm = up(E);
    A.o_live = A.o_rm + up(E);
    A.o_occ = A.o_live + up(E);
    A.o_bits = A.o_occ + (glob ? 0 : up(T * R));
    A.o_red = A.o_bits + up(T * W);
    A.o_ptr = A.o_red + up(n_red);
    A.o_ev = A.o_ptr + up(max_students + 1);
    A.o_rows = A.o_ev + up(max_slice);
    size_t staged = sizeof(int) * ((size_t)A.o_rows + (size_t)max_events * W);
    A.staged = staged <= K2_STAGE_LIMIT ? 1 : 0;
    size_t smem = A.staged ? staged : sizeof(int) * (size_t)A.o_ptr;
    if (smem > TT_SMEM_LIMIT) return (int)cudaErrorLaunchOutOfResources;
    const auto kernel = glob ? batch_penalty_kernel<true>
                             : batch_penalty_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((glob ? grid : P) * cluster, 1, 1);
    cfg.blockDim = dim3(K2_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cluster > 1) {
        // a cluster the card cannot place is refused, never shrunk
        int n_clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (n_clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    }
    err = cudaLaunchKernelEx(&cfg, kernel, A);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
