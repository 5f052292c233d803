// Device bodies of the greedy room choice and of moves that re-room,
// shared by K1 (assign_rooms.cu), K6 (breed.cu), K8 (random_ls.cu), K10
// (lahc.cu) and K12 (full_eval_ls.cu).
//
// A room choice runs on the 32 lanes of one warp, one lane per room
// (R <= 32), with the individual's slots, rooms and (T, R) occupancy in
// shared memory; lane 0 writes, and a __syncwarp() after each write
// makes it visible to the warp's next step. The greedy matching runs on
// a whole block, a warp per slot (tt_match_rooms_block). The room key
// stays in lockstep with ops/rooms.py `_room_key` (timetabling_ga_tpu/
// ops/rooms.py:68): (occ + unsuit) * 2^13 + unsuit * 2^12 + cap_rank +
// dead, the argmin taking the first room on ties.
#pragma once

#include "common.cuh"

struct TTRoomProblem {
    const uint8_t* possible;  // (E, R)
    const int* cap_rank;      // (R,)
    const int* dead;          // (R,) dead-room key penalty
    const int* live;          // (E,) occupancy weight: 1 live, 0 padded
    int E, R, T;
};

// The part of a lane's room key that depends on its room alone.
__device__ __forceinline__ int tt_room_rank(const TTRoomProblem& rp,
                                            int lane) {
    return lane < rp.R ? rp.cap_rank[lane] + rp.dead[lane] : 0;
}

// choose_room: the room of event `e` on occupancy row `occ_row` (R
// counts); every lane returns it. `rank` is tt_room_rank of the lane.
__device__ __forceinline__ int tt_choose_room_warp(const TTRoomProblem& rp,
                                                   const int* occ_row,
                                                   int e, int lane,
                                                   int rank) {
    int key = 0x7fffffff;
    if (lane < rp.R) {
        int unsuit = rp.possible[e * rp.R + lane] ? 0 : 1;
        key = (occ_row[lane] + unsuit) * TT_W_COST + unsuit * TT_W_UNSUIT
              + rank;
    }
    return tt_warp_argmin(key, lane);
}

// K1's body (rooms.py:108 assign_rooms), run by the whole block, slot by
// slot. An event's room key reads only its own slot's occupancy row
// (`_room_key`, rooms.py:68), so the matching splits exactly into T
// independent chains, one per slot, each running that slot's events in
// the order of the matching order `ord` (argsort of the suitable-room
// counts, stable). Warp w owns slots w, w + n_warps, ...; for each, it
// walks `ord` in chunks of 32 with a ballot of the events in that slot
// (`so[i]` = the slot of event ord[i]) and takes their rooms in order,
// one lane per room. `occ` (T x R) comes in zeroed and leaves as the
// occupancy of (slots, rooms_out); padded events choose a room but
// occupy nothing. The caller syncs before (so and occ ready) and after.
__device__ __forceinline__ void tt_match_rooms_block(const TTRoomProblem& rp,
                                                     const int* ord,
                                                     const int* so,
                                                     int* occ,
                                                     int* rooms_out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int rank = tt_room_rank(rp, lane);
    for (int t = warp; t < rp.T; t += n_warps) {
        int* row = occ + t * rp.R;
        for (int k = 0; k < rp.E; k += 32) {
            const int i = k + lane;
            unsigned hit =
                __ballot_sync(TT_FULL_MASK, i < rp.E && so[i] == t);
            while (hit) {
                const int e = ord[k + __ffs(hit) - 1];
                hit &= hit - 1;
                const int r = tt_choose_room_warp(rp, row, e, lane, rank);
                if (lane == 0) {
                    rooms_out[e] = r;
                    row[r] += rp.live[e];
                }
                __syncwarp();
            }
        }
    }
}

// The occupancy (T x R) of (sl, rm), counted by the warp into `occ`.
__device__ __forceinline__ void tt_occupancy_warp(const TTRoomProblem& rp,
                                                  const int* sl,
                                                  const int* rm, int* occ,
                                                  int lane) {
    for (int i = lane; i < rp.T * rp.R; i += 32) occ[i] = 0;
    __syncwarp();
    for (int e = lane; e < rp.E; e += 32)
        if (rp.live[e]) atomicAdd(&occ[sl[e] * rp.R + rm[e]], 1);
    __syncwarp();
}

// sample_move's events (moves.py:128): the indices of the 3 largest of
// the E uniforms `u`, largest first, ties to the lower index (lax.top_k's
// order, and the plain version's stable descending sort). Every lane
// returns them.
__device__ __forceinline__ void tt_top3_warp(const float* u, int E, int lane,
                                             int ev[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float bv = -3.402823466e38f;
        int bi = 0x7fffffff;
        for (int e = lane; e < E; e += 32) {
            bool taken = false;
            for (int q = 0; q < k; ++q) taken |= ev[q] == e;
            float v = u[e];
            if (!taken && (v > bv || (v == bv && e < bi))) {
                bv = v;
                bi = e;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            float v2 = __shfl_xor_sync(TT_FULL_MASK, bv, off);
            int i2 = __shfl_xor_sync(TT_FULL_MASK, bi, off);
            if (v2 > bv || (v2 == bv && i2 < bi)) {
                bv = v2;
                bi = i2;
            }
        }
        ev[k] = bi;
    }
}

// sample_move's padded 3-relocation (moves.py:131-144) of events `ev`:
// Move1 sends ev[0] to slot t, Move2 swaps ev[0] and ev[1], Move3 is the
// 3-cycle ev[0] -> slot of ev[1] -> slot of ev[2] -> slot of ev[0];
// inactive entries keep their slot.
__device__ __forceinline__ void tt_sample_move(const int* sl, int mtype,
                                               int t, const int ev[3],
                                               int ns[3], int on[3]) {
    int c0 = sl[ev[0]], c1 = sl[ev[1]], c2 = sl[ev[2]];
    if (mtype == 0) {
        ns[0] = t; ns[1] = c1; ns[2] = c2;
        on[0] = 1; on[1] = 0; on[2] = 0;
    } else if (mtype == 1) {
        ns[0] = c1; ns[1] = c0; ns[2] = c2;
        on[0] = 1; on[1] = 1; on[2] = 0;
    } else {
        ns[0] = c1; ns[1] = c2; ns[2] = c0;
        on[0] = 1; on[1] = 1; on[2] = 1;
    }
}

// B7's apply_relocation (moves.py:149): the active live events leave
// their occupancy cells, then each entry in order takes its new slot and
// a room chosen on the row as updated so far (an inactive entry keeps its
// room). sl, rm and occ are updated in place.
__device__ __forceinline__ void tt_relocate_warp(const TTRoomProblem& rp,
                                                 int* sl, int* rm, int* occ,
                                                 const int ev[3],
                                                 const int ns[3],
                                                 const int on[3], int lane,
                                                 int rank) {
    const int R = rp.R;
    int os[3], orr[3], act[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        os[m] = sl[ev[m]];
        orr[m] = rm[ev[m]];
        act[m] = on[m] * rp.live[ev[m]];
    }
    __syncwarp();
    if (lane == 0)
        for (int m = 0; m < 3; ++m) occ[os[m] * R + orr[m]] -= act[m];
    __syncwarp();
    for (int m = 0; m < 3; ++m) {
        int rc = tt_choose_room_warp(rp, occ + ns[m] * R, ev[m], lane, rank);
        int rn = on[m] ? rc : orr[m];
        if (lane == 0) {
            occ[ns[m] * R + rn] += act[m];
            sl[ev[m]] = ns[m];
            rm[ev[m]] = rn;
        }
        __syncwarp();
    }
}

// ---- B10c: the parallel room matcher (rooms.py:154 augment_rooms, :304
// parallel_assign_rooms), run by K6 on each crossover child under
// --rooms-mode parallel and by K9 (parallel_rooms.cu) on whole rows.
//
// The warp's 32 lanes stride over the events; every phase reads what the
// previous one wrote after a __syncwarp(). (slot, room) cells live in
// (T, R+1) grids, column R the "unmatched" dump. Every bid is a
// scatter-min of event indices and every park count a scatter-add, both
// independent of order, so shared-memory atomicMin / atomicAdd give
// exactly the JAX scatters' result.

#define TT_BIG (1 << 20)

// parallel_assign_rooms's start (rooms.py:320-322): the suitable room of
// least capacity rank, ignoring occupancy; room 0 when none is suitable.
__device__ __forceinline__ int tt_best_fit_room(const TTRoomProblem& rp,
                                                int e) {
    int best = TT_BIG, br = 0;
    for (int r = 0; r < rp.R; ++r) {
        int k = rp.possible[e * rp.R + r] ? rp.cap_rank[r] : TT_BIG;
        if (k < best) {
            best = k;
            br = r;
        }
    }
    return br;
}

// event e's best-fit suitable room among the free cells of its slot's
// owner row `own` (R+1 entries, E = free), or -1 when there is none
__device__ __forceinline__ int tt_free_room(const TTRoomProblem& rp,
                                            const int* own, int e) {
    int best = TT_BIG, br = -1;
    for (int r = 0; r < rp.R; ++r)
        if (rp.possible[e * rp.R + r] && own[r] == rp.E
            && rp.cap_rank[r] < best) {
            best = rp.cap_rank[r];
            br = r;
        }
    return br;
}

// park choice (rooms.py:282-286): K1's room key on the matched occupancy
// row `occ` (R+1 entries, column R excluded)
__device__ __forceinline__ int tt_park_room(const TTRoomProblem& rp,
                                            const int* occ, int e) {
    int best = 0x7fffffff, br = 0;
    for (int r = 0; r < rp.R; ++r) {
        int unsuit = rp.possible[e * rp.R + r] ? 0 : 1;
        int key = (occ[r] + unsuit) * TT_W_COST + unsuit * TT_W_UNSUIT
                  + rp.cap_rank[r] + rp.dead[r];
        if (key < best) {
            best = key;
            br = r;
        }
    }
    return br;
}

// ints of scratch tt_parallel_rooms_warp takes: mrooms, two per-event
// arrays and three (T, R+1) grids
__host__ __device__ __forceinline__ int tt_parallel_rooms_ints(int E, int R,
                                                              int T) {
    return 3 * E + 3 * T * (R + 1);
}

__device__ __forceinline__ void tt_fill_warp(int* x, int n, int v,
                                             int lane) {
    for (int i = lane; i < n; i += 32) x[i] = v;
}

// the matched owner grid (rooms.py:211 matched_grid): the least event
// index per (slot, mrooms) cell, E where none
__device__ __forceinline__ void tt_matched_grid_warp(const TTRoomProblem& rp,
                                                     const int* sl,
                                                     const int* mr, int* grid,
                                                     int lane) {
    const int C = rp.R + 1;
    tt_fill_warp(grid, rp.T * C, rp.E, lane);
    __syncwarp();
    for (int e = lane; e < rp.E; e += 32)
        atomicMin(&grid[sl[e] * C + mr[e]], e);
    __syncwarp();
}

// augment_rooms (rooms.py:154) of one individual: `rm` holds the
// incoming rooms (all < R) and leaves as the result. n_rounds rounds of
// length-1 then length-3 augments, two park bid rounds, then the
// stragglers' fallback; padded events bid in the augment rounds as every
// event does, enter the park phase parked, and keep their incoming room.
__device__ void tt_parallel_rooms_warp(const TTRoomProblem& rp,
                                       const int* sl, int* rm, int* scratch,
                                       int n_rounds, int lane) {
    const int E = rp.E, R = rp.R, C = R + 1, G = rp.T * C;
    int* mr = scratch;          // matched room, R when unmatched
    int* cand = mr + E;         // this phase's room choice, -1 none
    int* fc = cand + E;         // relocation room / parked flag
    int* grid = fc + E;         // owners, then the park occupancy
    int* bid = grid + G;
    int* bid2 = bid + G;
    // owner0: the least event index in each incoming (slot, room) cell;
    // an event is matched when it owns its cell and the room suits it
    tt_fill_warp(grid, G, E, lane);
    __syncwarp();
    for (int e = lane; e < E; e += 32) atomicMin(&grid[sl[e] * C + rm[e]], e);
    __syncwarp();
    for (int e = lane; e < E; e += 32) {
        const int r = rm[e];
        mr[e] = (grid[sl[e] * C + r] == e && rp.possible[e * R + r]) ? r : R;
    }
    __syncwarp();
    for (int round = 0; round < n_rounds; ++round) {
        // ---- stage 1: an unmatched event grabs its best free room
        tt_fill_warp(bid, G, E, lane);
        tt_matched_grid_warp(rp, sl, mr, grid, lane);
        for (int e = lane; e < E; e += 32) {
            int c = -1;
            if (mr[e] == R) {
                c = tt_free_room(rp, grid + sl[e] * C, e);
                if (c >= 0) atomicMin(&bid[sl[e] * C + c], e);
            }
            cand[e] = c;
        }
        __syncwarp();
        for (int e = lane; e < E; e += 32) {
            const int c = cand[e];
            if (c >= 0 && bid[sl[e] * C + c] == e) mr[e] = c;
        }
        __syncwarp();
        // ---- stage 2: e takes an owned room r whose owner f moves on to
        // its own best free room r' of the slot; both claims bid
        tt_fill_warp(bid, G, E, lane);
        tt_fill_warp(bid2, G, E, lane);
        tt_matched_grid_warp(rp, sl, mr, grid, lane);
        for (int e = lane; e < E; e += 32)
            fc[e] = mr[e] < R ? tt_free_room(rp, grid + sl[e] * C, e) : -1;
        __syncwarp();
        for (int e = lane; e < E; e += 32) {
            int c = -1;
            if (mr[e] == R) {
                const int* own = grid + sl[e] * C;
                int best = TT_BIG;
                for (int r = 0; r < R; ++r) {
                    const int f = own[r];
                    if (rp.possible[e * R + r] && f != E && fc[f] >= 0
                        && rp.cap_rank[r] < best) {
                        best = rp.cap_rank[r];
                        c = r;
                    }
                }
                if (c >= 0) atomicMin(&bid[sl[e] * C + c], e);
            }
            cand[e] = c;
        }
        __syncwarp();
        // winners' evicted owners bid for their relocation rooms
        for (int e = lane; e < E; e += 32) {
            const int c = cand[e];
            if (c < 0) continue;
            const int cell = sl[e] * C + c;
            if (bid[cell] == e) {
                const int f = grid[cell];
                atomicMin(&bid2[sl[e] * C + fc[f]], f);
            } else {
                cand[e] = -1;
            }
        }
        __syncwarp();
        // the non-colliding augments: f -> r', e -> r (e is unmatched and
        // f matched, so the two writes never touch one event)
        for (int e = lane; e < E; e += 32) {
            const int c = cand[e];
            if (c < 0) continue;
            const int f = grid[sl[e] * C + c];
            const int fr = fc[f];
            if (bid2[sl[e] * C + fr] == f) {
                mr[f] = fr;
                mr[e] = c;
            }
        }
        __syncwarp();
    }
    // ---- park the unmatched at least marginal cost, two bid rounds
    tt_fill_warp(grid, G, 0, lane);
    __syncwarp();
    for (int e = lane; e < E; e += 32) {
        if (mr[e] < R) atomicAdd(&grid[sl[e] * C + mr[e]], 1);
        fc[e] = (mr[e] < R || !rp.live[e]) ? 1 : 0;
    }
    __syncwarp();
    for (int pr = 0; pr < 2; ++pr) {
        tt_fill_warp(bid, G, E, lane);
        __syncwarp();
        for (int e = lane; e < E; e += 32) {
            if (fc[e]) continue;
            const int p = tt_park_room(rp, grid + sl[e] * C, e);
            cand[e] = p;
            atomicMin(&bid[sl[e] * C + p], e);
        }
        __syncwarp();
        for (int e = lane; e < E; e += 32) {
            if (fc[e] || bid[sl[e] * C + cand[e]] != e) continue;
            atomicAdd(&grid[sl[e] * C + cand[e]], 1);
            mr[e] = cand[e];
            fc[e] = 1;
        }
        __syncwarp();
    }
    // stragglers take the current argmin; padded events keep their room
    for (int e = lane; e < E; e += 32)
        if (rp.live[e])
            rm[e] = fc[e] ? mr[e] : tt_park_room(rp, grid + sl[e] * C, e);
    __syncwarp();
}
