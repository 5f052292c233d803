// Device bodies of the greedy room choice and of moves that re-room,
// shared by K1 (assign_rooms.cu), K6 (breed.cu), K8 (random_ls.cu), K10
// (lahc.cu) and K12 (full_eval_ls.cu).
//
// A room choice runs on the 32 lanes of one warp, lane l holding rooms
// l, l + 32, ... (any R < 4096), with the individual's slots, rooms and
// (T, R) occupancy in shared memory; each lane takes the least (key,
// room) of its rooms, then a shuffle reduction the warp's, ties to the
// lower room. Lane 0 writes, and a __syncwarp() after each write makes it
// visible to the warp's next step. The greedy matching runs on a whole
// block, a warp per slot (tt_match_rooms_block). The room key stays in
// lockstep with ops/rooms.py `_room_key` (timetabling_ga_tpu/
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

// The part of room r's key that depends on the room alone.
__device__ __forceinline__ int tt_room_part(const TTRoomProblem& rp, int r) {
    return rp.cap_rank[r] + rp.dead[r];
}

// tt_room_part of the lane's first room, kept in a register (0 past R);
// the rooms from 32 on are read as they come.
__device__ __forceinline__ int tt_room_rank(const TTRoomProblem& rp,
                                            int lane) {
    return lane < rp.R ? tt_room_part(rp, lane) : 0;
}

// The key of room r for event e on occupancy row `occ_row`.
__device__ __forceinline__ int tt_room_key(const TTRoomProblem& rp,
                                           const int* occ_row, int e, int r,
                                           int part) {
    const int unsuit = rp.possible[e * rp.R + r] ? 0 : 1;
    return (occ_row[r] + unsuit) * TT_W_COST + unsuit * TT_W_UNSUIT + part;
}

// choose_room: the room of event `e` on occupancy row `occ_row` (R
// counts); every lane returns it. `rank` is tt_room_rank of the lane.
// WIDE takes the lane's rooms past the first 32 too.
template <bool WIDE>
__device__ __forceinline__ int tt_choose_room_r(const TTRoomProblem& rp,
                                                const int* occ_row, int e,
                                                int lane, int rank) {
    int key = 0x7fffffff, best = lane;
    if (lane < rp.R) key = tt_room_key(rp, occ_row, e, lane, rank);
    // the lane's rooms in increasing order: strict keeps the lowest
    for (int r = lane + 32; WIDE && r < rp.R; r += 32) {
        const int k = tt_room_key(rp, occ_row, e, r, tt_room_part(rp, r));
        if (k < key) {
            key = k;
            best = r;
        }
    }
    return tt_warp_argmin(key, best);
}

// tt_choose_room_r on any R < 4096: at R <= 32 one room a lane, the code
// of before.
__device__ __forceinline__ int tt_choose_room_warp(const TTRoomProblem& rp,
                                                   const int* occ_row,
                                                   int e, int lane,
                                                   int rank) {
    return tt_wide_rooms(rp.R)
               ? tt_choose_room_r<true>(rp, occ_row, e, lane, rank)
               : tt_choose_room_r<false>(rp, occ_row, e, lane, rank);
}

// K1's body (rooms.py:108 assign_rooms), run by the whole block, slot by
// slot. An event's room key reads only its own slot's occupancy row
// (`_room_key`, rooms.py:68), so the matching splits exactly into T
// independent chains, one per slot, each running that slot's events in
// the order of the matching order `ord` (argsort of the suitable-room
// counts, stable). Warp w owns slots w, w + n_warps, ...; for each, it
// walks `ord` in chunks of 32 with a ballot of the events in that slot
// (`so[i]` = the slot of event ord[i]) and takes their rooms in order,
// each lane over its rooms (tt_choose_room_warp). `occ` (T x R) comes
// in zeroed and leaves as the occupancy of (slots, rooms_out); padded
// events choose a room but occupy nothing. The caller syncs before (so
// and occ ready) and after.
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
// Every step of augment_rooms is local to a slot: bids are scatter-mins
// over (slot, room) cells, and owners, free rooms and the park occupancy
// are read in the event's own slot row. So the matcher splits exactly
// into T independent problems, and the block's warps stride over the
// slots, one warp a slot (as tt_match_rooms_block). The block first
// buckets the events by slot, each slot's in increasing event index (a
// stable counting sort, tt_bucket_by_slot); a warp then works on its
// slot's events 32 at a time, lane = event, with the slot's rank rows
// (owner, evictor, park keys, room) in shared memory and lane l
// answering for ranks l, l + 32, .... Rooms are bits in capacity-rank
// order, NW = ceil(R / 32) words: each event's suitability words (bit k
// of word j: the room of capacity rank 32j + k suits it,
// ProblemArrays.suit_rank), and the warp's words of vacant ranks, of
// movable ones and of the ranks a stage has bid for. So "the free
// suitable room of least capacity rank" is the first word of suit & free
// with a bit set, and its lowest bit (__ffs). Every bid goes to the least
// event index among the events that chose the same rank: within a chunk
// the lowest lane of the rank's __match_any_sync peers, across chunks
// the first chunk, through the bid-for words, which take each chunk's
// ranks. Bids within a stage are simultaneous: every choice of a stage
// is made on the state the stage started from.

// the rank-ordered rooms of a problem
struct TTRankRooms {
    const uint32_t* suit;  // (E, nw) bit k of word j: rank 32j + k suits
    const int* room_of;    // (R,) the room of capacity rank k
    int nw;                // words an event, ceil(R / 32)
};

// The least rank whose bit is set in both of the nw-word masks s and m,
// -1 when none is.
__device__ __forceinline__ int tt_first_rank(const uint32_t* s,
                                             const uint32_t* m, int nw) {
    for (int w = 0; w < nw; ++w) {
        const uint32_t x = s[w] & m[w];
        if (x) return 32 * w + __ffs(x) - 1;
    }
    return -1;
}

// bit k of the nw-word mask m
__device__ __forceinline__ bool tt_rank_bit(const uint32_t* m, int k) {
    return (m[k >> 5] >> (k & 31)) & 1u;
}

// parallel_assign_rooms's start (rooms.py:320-322): the suitable room of
// least capacity rank, ignoring occupancy; room 0 when none is suitable.
__device__ __forceinline__ int tt_best_fit_room(const TTRankRooms& rr,
                                                int e) {
    const uint32_t* s = rr.suit + (size_t)e * rr.nw;
    for (int w = 0; w < rr.nw; ++w)
        if (s[w]) return rr.room_of[32 * w + __ffs(s[w]) - 1];
    return 0;
}

// ints of one warp's rank rows: owners, evictors, the two park keys and
// the rooms (32 NW each), then the vacant, movable and bid-for words
__host__ __device__ __forceinline__ int tt_rank_row_ints(int R) {
    const int nw = (R + 31) / 32;
    return 5 * 32 * nw + 3 * nw;
}

// ints of scratch tt_parallel_rooms_block takes in a block of n_warps
// warps: each event's matched rank, suitability words (NW; unless `su`
// is false: they are read from the problem's) and live flag, the events
// bucketed by slot with each slot's start (T + 1) and each chunk of 32
// events' per-slot counts, and a warp's rank rows (unless `rows` is
// false: they are in a global scratch row)
__host__ __device__ __forceinline__ int tt_parallel_rooms_ints(
    int E, int R, int T, int n_warps, bool su = true, bool rows = true) {
    return (3 + (su ? (R + 31) / 32 : 0)) * E + T + 1 + (E + 31) / 32 * T
           + (rows ? tt_rank_row_ints(R) * n_warps : 0);
}

// The events of (E,) slots `sl` bucketed by slot into `lst`, each
// slot's in increasing event index from lst[start[t]] to
// lst[start[t + 1]] (a stable counting sort on the whole block, T <= 64):
// a warp a chunk of 32 events counts each slot's events in it and each
// event's place among them (__match_any_sync, once a chunk), warp 0 takes
// the running sums over the chunks and the slots, and every event writes
// itself. `cnt` holds ceil(E / 32) x T counts, `loc` E ints of scratch.
__device__ __forceinline__ void tt_bucket_by_slot(const int* sl, int E,
                                                  int T, int* lst,
                                                  int* start, int* cnt,
                                                  int* loc) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5, C = (E + 31) / 32;
    for (int c = warp; c < C; c += n_warps) {
        const int e = 32 * c + lane;
        const int s = e < E ? sl[e] : T + lane;
        const unsigned peers = __match_any_sync(TT_FULL_MASK, s);
        for (int t = lane; t < T; t += 32) cnt[c * T + t] = 0;
        __syncwarp();
        if (e < E) {
            loc[e] = __popc(peers & ((1u << lane) - 1u));
            if (__ffs(peers) - 1 == lane) cnt[c * T + s] = __popc(peers);
        }
    }
    __syncthreads();
    if (warp == 0) {
        // lane: slots lane and lane + 32; chunk counts -> offsets
        int tot[2] = {0, 0};
        for (int h = 0; h < 2; ++h) {
            const int t = lane + 32 * h;
            for (int c = 0; t < T && c < C; ++c) {
                const int v = cnt[c * T + t];
                cnt[c * T + t] = tot[h];
                tot[h] += v;
            }
        }
        // exclusive sums over the slots
        int carry = 0;
        for (int h = 0; h < 2; ++h) {
            int x = tot[h];
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(TT_FULL_MASK, x, off);
                if (lane >= off) x += y;
            }
            const int t = lane + 32 * h;
            if (t <= T) start[t] = carry + x - tot[h];
            carry += __shfl_sync(TT_FULL_MASK, x, 31);
        }
        if (lane == 0 && T == 64) start[64] = carry;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        const int s = sl[e];
        lst[start[s] + cnt[(e >> 5) * T + s] + loc[e]] = e;
    }
}

// Clear the nw-word mask m (the warp; it syncs after).
__device__ __forceinline__ void tt_clear_words(uint32_t* m, int nw,
                                               int lane) {
    for (int w = lane; w < nw; w += 32) m[w] = 0u;
    __syncwarp();
}

// One bid of each lane of a chunk (`bid`: it bids for rank k): whether it
// wins, being the least event of the chunk's bidders for k (lanes hold
// the slot's events in increasing order: the lowest lane of the rank's
// peers) with no bid for k from an earlier chunk (`claimed`, the
// bid-for words, which take this chunk's ranks).
__device__ __forceinline__ bool tt_bid_wins(bool bid, int k,
                                            uint32_t* claimed, int lane) {
    const unsigned peers = __match_any_sync(TT_FULL_MASK, bid ? k : -1);
    const bool first = bid && __ffs(peers) - 1 == lane;
    const bool win = first && !tt_rank_bit(claimed, k);
    __syncwarp();
    if (first) atomicOr(&claimed[k >> 5], 1u << (k & 31));
    __syncwarp();
    return win;
}

// The park choice (rooms.py:282-286) of an event with suitability words
// `suit`: the rank of least K1 room key, `ks[k]` where rank k suits it
// and `ku[k]` where it does not (the keys on the slot's current
// occupancy), ties to the lower room index `rk[k]` as jnp.argmin over
// rooms takes them.
__device__ __forceinline__ int tt_park_rank(const uint32_t* suit,
                                            const int* ks, const int* ku,
                                            const int* rk, int R) {
    int best = 0x7fffffff, best_room = 0x7fffffff, best_k = 0;
    for (int k = 0; k < R; ++k) {
        const int key = tt_rank_bit(suit, k) ? ks[k] : ku[k];
        if (key < best || (key == best && rk[k] < best_room)) {
            best = key;
            best_room = rk[k];
            best_k = k;
        }
    }
    return best_k;
}

// The ranks k < R with no owner, as the nw words `vac` (the warp; it
// syncs after).
__device__ __forceinline__ void tt_vacant_words(const int* own, int R,
                                                int nw, uint32_t* vac,
                                                int lane) {
    for (int w = 0; w < nw; ++w) {
        const int k = 32 * w + lane;
        const unsigned b = __ballot_sync(TT_FULL_MASK, k < R && own[k] < 0);
        if (lane == 0) vac[w] = b;
    }
    __syncwarp();
}

// augment_rooms (rooms.py:154) of slot t of one individual, on one warp:
// `rm` holds the incoming rooms (all < R) and leaves with the result for
// the slot's events; `mr` (E) takes their matched ranks (-1 unmatched,
// -2 a padded event parked unmatched), `lst` (n) lists them in
// increasing order; `su` (E x NW) and `lv` (E) are the events'
// suitability words and live flags. The warp's rank rows `own`
// (tt_rank_row_ints) hold the owner of each rank (-1 none), stage 2's
// evictors, the park keys of each rank when it suits and when not, and
// rank k's room `rk[k]`, then the vacant, movable and bid-for words;
// stage 2 keeps each owner's best free rank in the second park row and
// the least owner bidding for each free rank in the first. With
// `occ_out` (T x R), the slot's row of the result's occupancy is
// written there. n_rounds rounds of length-1 then length-3 augments, two
// park bid rounds, then the stragglers' fallback; padded events bid in
// the augment rounds as every event does, enter the park phase parked,
// and keep their incoming room.
__device__ __forceinline__ void tt_parallel_rooms_slot(
    const TTRoomProblem& rp, const int* sl, int* rm, int* mr,
    const uint32_t* su, const int* lv, const int* lst, int n, int* own,
    int t, int n_rounds, int lane, int* occ_out) {
    const int R = rp.R, nw = (R + 31) / 32, Rp = 32 * nw;
    int *evict = own + Rp, *ks = evict + Rp, *ku = ks + Rp, *rk = ku + Rp;
    uint32_t* vac = (uint32_t*)(rk + Rp);
    uint32_t* mov = vac + nw;
    uint32_t* claimed = mov + nw;
    if (n == 0) {
        // an empty slot: nothing to match, its occupancy row zero
        if (occ_out)
            for (int r = lane; r < R; r += 32) occ_out[t * R + r] = 0;
        __syncwarp();
        return;
    }
    for (int k = lane; k < Rp; k += 32) own[k] = -1;
    tt_clear_words(claimed, nw, lane);
    // owner0: the least event of each incoming (slot, room) cell; it is
    // matched when the room suits it
    for (int c = 0; c < n; c += 32) {
        const bool act = c + lane < n;
        const int e = act ? lst[c + lane] : 0;
        const int k = act ? rp.cap_rank[rm[e]] : 0;
        const bool m = tt_bid_wins(act, k, claimed, lane)
                       && tt_rank_bit(su + (size_t)e * nw, k);
        if (act) mr[e] = m ? k : -1;
        if (m) own[k] = e;
    }
    __syncwarp();
    for (int round = 0; round < n_rounds; ++round) {
        // ---- stage 1: an unmatched event grabs its best free room
        tt_vacant_words(own, R, nw, vac, lane);
        tt_clear_words(claimed, nw, lane);
        unsigned any = 0, grabbed = 0;
        for (int c = 0; c < n; c += 32) {
            const bool act = c + lane < n && mr[lst[c + lane]] == -1;
            any |= __ballot_sync(TT_FULL_MASK, act);
            const int e = act ? lst[c + lane] : 0;
            const int k = act ? tt_first_rank(su + (size_t)e * nw, vac, nw)
                              : -1;
            grabbed |= __ballot_sync(TT_FULL_MASK, k >= 0);
            if (tt_bid_wins(k >= 0, k, claimed, lane)) {
                mr[e] = k;
                own[k] = e;
            }
        }
        // nothing unmatched: every later stage is a no-op
        if (!any) break;
        __syncwarp();
        // ---- stage 2: e takes an owned room k whose owner f moves on to
        // its own best free room fr of the slot; both claims bid
        tt_vacant_words(own, R, nw, vac, lane);
        for (int w = 0; w < nw; ++w) {
            const int k = 32 * w + lane;
            const int o = k < R ? own[k] : -1;
            const int fr =
                o >= 0 ? tt_first_rank(su + (size_t)o * nw, vac, nw) : -1;
            ku[k] = fr;
            ks[k] = 0x7fffffff;
            const unsigned b = __ballot_sync(TT_FULL_MASK, fr >= 0);
            if (lane == 0) mov[w] = b;
        }
        tt_clear_words(claimed, nw, lane);
        for (int c = 0; c < n; c += 32) {
            const bool act = c + lane < n && mr[lst[c + lane]] == -1;
            const int e = act ? lst[c + lane] : 0;
            const int k = act ? tt_first_rank(su + (size_t)e * nw, mov, nw)
                              : -1;
            if (tt_bid_wins(k >= 0, k, claimed, lane)) evict[k] = e;
        }
        __syncwarp();
        // every rank bid for has its winner; its owner bids for fr, the
        // least owner of each fr winning it
        for (int k = lane; k < R; k += 32)
            if (tt_rank_bit(claimed, k)) atomicMin(&ks[ku[k]], own[k]);
        __syncwarp();
        // the non-colliding augments: f -> fr, e -> k (e unmatched, f
        // matched; fr free, k owned, so no rank is both written and read)
        bool moves = false;
        for (int k = lane; k < R; k += 32) {
            if (!tt_rank_bit(claimed, k)) continue;
            const int o = own[k], fr = ku[k], by = evict[k];
            if (ks[fr] != o) continue;
            moves = true;
            mr[o] = fr;
            mr[by] = k;
            own[fr] = o;
            own[k] = by;
        }
        __syncwarp();
        // a round that changed nothing repeats itself: the rest are no-ops
        if (!grabbed && !__ballot_sync(TT_FULL_MASK, moves)) break;
    }
    TT_PROF(2);
    // ---- park the unmatched at least marginal cost, two bid rounds
    for (int c = lane; c < n; c += 32) {
        const int e = lst[c];
        if (mr[e] == -1 && !lv[e]) mr[e] = -2;
    }
    // rank k's park keys on the slot's occupancy (1 where owned)
    for (int k = lane; k < R; k += 32) {
        const int occ = own[k] >= 0 ? 1 : 0;
        const int base = k + rp.dead[rk[k]];
        ks[k] = occ * TT_W_COST + base;
        ku[k] = (occ + 1) * TT_W_COST + TT_W_UNSUIT + base;
    }
    __syncwarp();
    for (int pr = 0; pr < 2; ++pr) {
        tt_clear_words(claimed, nw, lane);
        for (int c = 0; c < n; c += 32) {
            const bool act = c + lane < n && mr[lst[c + lane]] == -1;
            const int e = act ? lst[c + lane] : 0;
            const int k =
                act ? tt_park_rank(su + (size_t)e * nw, ks, ku, rk, R) : 0;
            if (tt_bid_wins(act, k, claimed, lane)) mr[e] = k;
        }
        __syncwarp();
        // each rank bid for took one winner
        for (int k = lane; k < R; k += 32)
            if (tt_rank_bit(claimed, k)) {
                ks[k] += TT_W_COST;
                ku[k] += TT_W_COST;
            }
        __syncwarp();
    }
    // stragglers take the current argmin; padded events keep their room
    if (occ_out)
        for (int r = lane; r < R; r += 32) occ_out[t * R + r] = 0;
    __syncwarp();
    for (int c = lane; c < n; c += 32) {
        const int e = lst[c];
        if (!lv[e]) continue;
        const int k = mr[e] >= 0
                          ? mr[e]
                          : tt_park_rank(su + (size_t)e * nw, ks, ku, rk, R);
        rm[e] = rk[k];
        if (occ_out) atomicAdd(&occ_out[t * R + rk[k]], 1);
    }
    __syncwarp();
    TT_PROF(3);
}

// augment_rooms of one individual on the whole block, a warp a slot:
// `sl` and `rm` (E each, `rm` the incoming rooms, all < R, and the
// result) in shared memory, `scratch` tt_parallel_rooms_ints(E, R, T,
// warps, !su_glob, !rows_g) ints; with `occ` (T x R), the result's
// occupancy is written there. Where they do not fit in shared memory
// (ops/rooms.py parallel_rooms_stage), `su_glob` reads the events'
// suitability words from the problem's (rr.suit) in place of a staged
// copy, and `rows_g` holds the warps' rank rows (a block's global
// scratch row, tt_rank_row_ints(R) ints a warp); the callers' staged
// instances pass the defaults, which compile to the code without them.
// The caller syncs before and after.
__device__ __forceinline__ void tt_parallel_rooms_block(
    const TTRoomProblem& rp, const TTRankRooms& rr, const int* sl, int* rm,
    int* scratch, int n_rounds, int* occ, bool su_glob = false,
    int* rows_g = nullptr) {
    const int E = rp.E, R = rp.R, T = rp.T, nw = rr.nw;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int* mr = scratch;
    uint32_t* su_s = (uint32_t*)(mr + E);
    const uint32_t* su = su_glob ? rr.suit : su_s;
    int* lv = (int*)(su_s + (su_glob ? 0 : (size_t)E * nw));
    int* lst = lv + E;
    int* start = lst + E;
    int* cnt = start + T + 1;
    int* own = (rows_g ? rows_g : cnt + (E + 31) / 32 * T)
               + tt_rank_row_ints(R) * warp;
    if (!su_glob)
        for (int i = threadIdx.x; i < E * nw; i += blockDim.x)
            su_s[i] = rr.suit[i];
    for (int e = threadIdx.x; e < E; e += blockDim.x) lv[e] = rp.live[e];
    // the warp's rank-to-room row
    for (int k = lane; k < R; k += 32) own[4 * 32 * nw + k] = rr.room_of[k];
    // `mr` is the bucketing's scratch until the slots' matchings start
    tt_bucket_by_slot(sl, E, T, lst, start, cnt, mr);
    __syncthreads();
    TT_PROF(1);
    for (int t = warp; t < T; t += n_warps)
        tt_parallel_rooms_slot(rp, sl, rm, mr, su, lv, lst + start[t],
                               start[t + 1] - start[t], own, t, n_rounds,
                               lane, occ);
}
