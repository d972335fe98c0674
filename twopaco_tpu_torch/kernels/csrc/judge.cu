// Judge + compact: junction decision per k-mer group of the sorted round,
// rank ids, and compaction of the junction table and the occurrences.
//
// Replaces twopaco_tpu/passes/sortpipe.py:453 judge_compact_fused (helpers
// twopaco_tpu/ops/segments.py:85 _fwd_chunk, :105 _bwd_chunk, :155
// _cumsum_chunk) and, by the second entry tp_judge_records, sortpipe.py:375
// judge_records: the same group math, no compaction, one (keep_first, keep,
// id) per record, for the distributed step (parallel/sortshard.py).
//
// Over records sorted by k-mer words (sentinel rows last, one group), a
// group is a run of equal words. From its real rows (payload bit 17) a
// group has the OR of its ACGT extension bits (in at bits 0-3, out at bits
// 8-11), its N-in and N-out counts (clamped at 0x7FFF when read, the same
// >= 2 decisions as the saturating counters of ops/segments.py:132) and
// its size. A group is a junction iff its first row is real and (indeg >
// 1 or outdeg > 1) and (no abundance check, or size <= abundance); ranks
// are 1-based in k-mer order, negated on the reverse strand (bit 16);
// occurrences are compacted in record order. Counts: n_groups (real
// groups), n_junc, n_occ, n_real (real rows) and the most real rows of
// one group.
//
// Bound: bytes moved, the words and payload read twice and the outputs
// written once. Design: two launches, no scan of n values, no n-sized
// scratch or memset. A group's state combines associatively as a
// segmented reduction (JSeg: the state of the rows before the span's first
// group start, the state since its last start, the junction groups closed
// inside with their rows, the span's real rows and its largest closed
// group), so
//   K1 (k_judge_scan): a block takes the next tile of J_TILE records from
//      an atomic counter, stages its start bits (rows compared with the row
//      before, coalesced) and payloads in shared memory, each thread folds
//      its J_ITEMS rows in registers and the block combines the threads'
//      segments by shuffles; the tile's segment is published, and its
//      prefix (every record before the tile's end) by a decoupled look-back
//      whose warp combines 32 earlier tiles at a time; the tile's prefix
//      gives the rank of the group that closes at its first start;
//   K2 (k_judge_write): each tile again, the threads' exclusive prefixes
//      by the same block combine; a group closed inside the tile is
//      decided by the thread where it ends, which writes its rank to a
//      shared slot of its start row; the tile's leading group and the
//      group open at its end take the rank of the first start after them
//      (found by a warp walking forward over the tiles' segments); every
//      row reads its group's rank and the outputs are written coalesced,
//      the kept rows' offsets from the previous tile's prefix and a warp
//      scan of the tile's ballots.
// The look-back's flags (common.cuh tp_status) carry a per-call epoch, so
// the scratch, kept across calls (kernels/build.py lookback_scratch, its
// own for the judge), needs no clearing; K2 resets the tile counter. Sentinel
// rows add to a group's row count only, in registers.
#include "common.cuh"

namespace {

constexpr int J_ITEMS = 8;                    // records a thread
constexpr int J_TILE = TP_THREADS * J_ITEMS;  // records a tile
constexpr uint32_t SAT = 0x7fffu;
constexpr int J_COUNTS = 5;                   // n_groups, n_junc, n_occ, n_real, group max

// The state of (part of) a group: ACGT extension bits, N-in and N-out
// counts and size of its real rows, and its rows
struct JSt {
    uint32_t bits, nin, nout, size, rows;
};

__device__ __forceinline__ JSt st_add(const JSt& a, const JSt& b) {
    return JSt{a.bits | b.bits, a.nin + b.nin, a.nout + b.nout, a.size + b.size,
               a.rows + b.rows};
}

__device__ __forceinline__ JSt row_st(uint32_t p) {
    JSt s{0u, 0u, 0u, 0u, 1u};
    if (p & TP_REAL) {
        const uint32_t in = p & 0xffu, out = (p >> 8) & 0xffu;
        s.bits = (in < 4 ? 1u << in : 0u) | (out < 4 ? 1u << (out + 8) : 0u);
        s.nin = in == 4;
        s.nout = out == 4;
        s.size = 1u;
    }
    return s;
}

struct JParams {
    int check;
    unsigned long long ab;
};

__device__ __forceinline__ bool junction(const JSt& s, uint32_t real, const JParams& p) {
    const int indeg = __popc(s.bits & 0xfu) + (int)min(s.nin, SAT);
    const int outdeg = __popc((s.bits >> 8) & 0xfu) + (int)min(s.nout, SAT);
    return real && (indeg > 1 || outdeg > 1) &&
           (!p.check || (unsigned long long)s.size <= p.ab);
}

// A span of rows: has (a group starts inside), lead (the rows before the
// first start), tail (the rows from the last start on), treal (the last
// start row is real), tstart (its index in the tile), junc and occ (the
// junction groups that start and end inside, and their rows), groups (the
// real group starts), real (the real rows), gmax (the most real rows of a
// group that starts and ends inside)
struct __align__(16) JSeg {
    uint32_t has;
    JSt lead, tail;
    uint32_t treal, tstart, junc, occ, groups, real, gmax;
};

// The span a then b
__device__ __forceinline__ JSeg seg_cat(JSeg a, const JSeg& b, const JParams& p) {
    if (!b.has) {
        if (a.has) a.tail = st_add(a.tail, b.lead);
        else a.lead = st_add(a.lead, b.lead);
        a.real += b.real;
        return a;
    }
    JSeg r = b;
    r.real = a.real + b.real;
    if (!a.has) {
        r.lead = st_add(a.lead, b.lead);
        return r;
    }
    const JSt closed = st_add(a.tail, b.lead);
    const bool j = junction(closed, a.treal, p);
    r.lead = a.lead;
    r.junc = a.junc + b.junc + j;
    r.occ = a.occ + b.occ + (j ? closed.rows : 0u);
    r.groups = a.groups + b.groups;
    r.gmax = max(max(a.gmax, b.gmax), closed.size);
    return r;
}

// The span s then one row (start: its words differ from the row before)
__device__ __forceinline__ void seg_row(JSeg& s, bool start, uint32_t pay, uint32_t li,
                                        const JParams& p) {
    const JSt x = row_st(pay);
    s.real += x.size;
    if (start) {
        if (s.has) {
            const bool j = junction(s.tail, s.treal, p);
            s.junc += j;
            s.occ += j ? s.tail.rows : 0u;
            s.gmax = max(s.gmax, s.tail.size);
        }
        s.has = 1u;
        s.tail = x;
        s.treal = (pay >> 17) & 1u;
        s.tstart = li;
        s.groups += s.treal;
    } else if (s.has) {
        s.tail = st_add(s.tail, x);
    } else {
        s.lead = st_add(s.lead, x);
    }
}

template <class F>
__device__ __forceinline__ JSt st_map(const JSt& s, F f) {
    return JSt{f(s.bits), f(s.nin), f(s.nout), f(s.size), f(s.rows)};
}

// f applied to each of the 18 words of s
template <class F>
__device__ __forceinline__ JSeg seg_map(const JSeg& s, F f) {
    JSeg r;
    r.has = f(s.has);
    r.lead = st_map(s.lead, f);
    r.tail = st_map(s.tail, f);
    r.treal = f(s.treal);
    r.tstart = f(s.tstart);
    r.junc = f(s.junc);
    r.occ = f(s.occ);
    r.groups = f(s.groups);
    r.real = f(s.real);
    r.gmax = f(s.gmax);
    return r;
}

// The threads' spans in thread order: -> the exclusive prefix of x, incl
// the inclusive one (the last thread's: the block's). Every thread calls;
// s_warp holds a JSeg a warp.
__device__ __forceinline__ JSeg block_seg_scan(const JSeg& x, JSeg* s_warp, const JParams& p,
                                               JSeg& incl) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    JSeg in = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const JSeg y = seg_map(in, [o](uint32_t v) { return __shfl_up_sync(0xffffffffu, v, o); });
        if (lane >= o) in = seg_cat(y, in, p);
    }
    JSeg ex = seg_map(in, [](uint32_t v) { return __shfl_up_sync(0xffffffffu, v, 1); });
    if (lane == 0) ex = JSeg{};
    if (lane == 31) s_warp[warp] = in;
    __syncthreads();
    JSeg wp{};
    for (int u = 0; u < warp; ++u) wp = seg_cat(wp, s_warp[u], p);
    __syncthreads();
    incl = seg_cat(wp, in, p);
    return seg_cat(wp, ex, p);
}

struct JudgeArgs {
    const uint32_t* words;
    const uint32_t* pay;
    const long long* pos;
    size_t n;
    int w;
    JParams prm;
    size_t tiles;
    uint32_t epoch;
    uint32_t* tile_ctr;
    uint64_t* flags;  // [tiles]: the look-back's status of each tile
    JSeg* agg;        // [tiles]: each tile's segment (tiles 1 ..)
    JSeg* incl;       // [tiles]: the segment of every record up to each tile's end
    uint32_t* rk;     // [tiles + 1]: rank of the group closing at tile v's first start (v = tiles: the last group), or 0
    long long* counts;
    // judge_compact
    uint32_t* table;
    long long* occ_pos;
    int32_t* occ_id;
    // judge_records
    uint8_t* keep_first;
    uint8_t* keep;
    int32_t* ids;
};

// A segment another block published (read from L2, past the L1)
__device__ __forceinline__ JSeg load_seg_cg(const JSeg* src) {
    JSeg s;
    static_assert(sizeof(JSeg) % sizeof(uint4) == 0, "a segment is whole 16-byte words");
    const uint4* p = (const uint4*)src;
    uint4* q = (uint4*)&s;
#pragma unroll
    for (int u = 0; u < (int)(sizeof(JSeg) / sizeof(uint4)); ++u) q[u] = __ldcg(p + u);
    return s;
}

// The tile's start bits (bit l % 32 of word l / 32: row l differs from the
// row before) and payloads (0 past n) in shared memory, consecutive threads
// on consecutive rows, every load of a thread issued before the compares
// (W: the words a row, 0 for w > 4 read in a loop)
template <int W>
__device__ __forceinline__ void stage_tile(const JudgeArgs& a, size_t t0, int tn,
                                           uint32_t* s_start, uint32_t* s_pay) {
    constexpr int WR = W > 0 ? W : 1;
    uint32_t cur[J_ITEMS][WR], prev[J_ITEMS][WR], p[J_ITEMS];
#pragma unroll
    for (int s = 0; s < J_ITEMS; ++s) {
        const int l = threadIdx.x + s * TP_THREADS;
        const size_t i = t0 + l;
        p[s] = l < tn ? a.pay[i] : 0u;
#pragma unroll
        for (int m = 0; m < WR; ++m) {
            cur[s][m] = W > 0 && l < tn ? a.words[i * W + m] : 0u;
            prev[s][m] = W > 0 && l < tn && i > 0 ? a.words[(i - 1) * W + m] : 0u;
        }
    }
#pragma unroll
    for (int s = 0; s < J_ITEMS; ++s) {
        const int l = threadIdx.x + s * TP_THREADS;
        const size_t i = t0 + l;
        uint32_t diff = i == 0;
        if (W > 0) {
#pragma unroll
            for (int m = 0; m < WR; ++m) diff |= cur[s][m] ^ prev[s][m];
        } else if (l < tn && i > 0) {
            const uint32_t* r = a.words + i * a.w;
            for (int m = 0; m < a.w; ++m) diff |= r[m] ^ r[m - a.w];
        }
        const unsigned b = __ballot_sync(0xffffffffu, l < tn && diff != 0);
        if ((threadIdx.x & 31) == 0) s_start[l >> 5] = b;
        s_pay[l] = p[s];
    }
    __syncthreads();
}

// A thread's J_ITEMS rows of the staged tile: start bits, payloads, and
// its span
__device__ __forceinline__ JSeg thread_rows(const uint32_t* s_start, const uint32_t* s_pay,
                                            int tn, const JParams& p, uint32_t& starts,
                                            uint32_t* pays) {
    const int l0 = threadIdx.x * J_ITEMS;
    starts = (s_start[l0 >> 5] >> (l0 & 31)) & ((1u << J_ITEMS) - 1u);
    const uint4* q = (const uint4*)(s_pay + l0);
#pragma unroll
    for (int u = 0; u < J_ITEMS / 4; ++u) {
        const uint4 v = q[u];
        pays[4 * u] = v.x, pays[4 * u + 1] = v.y, pays[4 * u + 2] = v.z, pays[4 * u + 3] = v.w;
    }
    JSeg s{};
#pragma unroll
    for (int j = 0; j < J_ITEMS; ++j)
        if (l0 + j < tn) seg_row(s, (starts >> j) & 1u, pays[j], l0 + j, p);
    return s;
}

// Warp 0: the tile's prefix by a decoupled look-back. Lane 0 publishes the
// tile's segment agg (tile 0: its prefix at once), lane l waits for tile
// top - l of a window of 32 earlier tiles and reads its prefix or its
// segment; the window combines up to the nearest prefix, else moves back
// 32 tiles (tile 0 always publishes its prefix). Lane 0 then publishes
// the prefix, the rank of the group that closes at the tile's first start
// and, in the last tile, the counts.
__device__ __forceinline__ void tile_lookback(const JudgeArgs& a, size_t tile, const JSeg& agg) {
    const int lane = threadIdx.x;
    JSeg excl{};
    if (tile > 0) {
        if (lane == 0) {
            a.agg[tile] = agg;
            __threadfence();
            tp_store_relaxed(a.flags + tile, tp_status(TP_ST_AGG, 0u, a.epoch));
        }
        for (long long top = (long long)tile - 1;; top -= 32) {
            const long long t = top - lane;
            JSeg x{};
            bool inc = false;
            if (t >= 0) {
                uint64_t v;
                do {
                    v = tp_load_relaxed(a.flags + t);
                } while (!tp_status_ready(v, a.epoch));
                inc = (v & TP_ST_INCL) != 0;
                __threadfence();
                x = load_seg_cg(inc ? a.incl + t : a.agg + t);
            }
            const unsigned ib = __ballot_sync(0xffffffffu, inc);
            const int stop = ib ? __ffs(ib) - 1 : 31;
            if (lane > stop) x = JSeg{};
            // lane 0: the window's tiles in order (higher lanes are earlier)
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const JSeg y =
                    seg_map(x, [o](uint32_t v) { return __shfl_down_sync(0xffffffffu, v, o); });
                if (lane + o < 32) x = seg_cat(y, x, a.prm);
            }
            if (lane == 0) excl = seg_cat(x, excl, a.prm);
            if (ib) break;
        }
    }
    if (lane != 0) return;
    const JSeg inc = seg_cat(excl, agg, a.prm);
    a.incl[tile] = inc;
    __threadfence();
    tp_store_relaxed(a.flags + tile, tp_status(TP_ST_INCL, 0u, a.epoch));
    a.rk[tile] = tile > 0 && agg.has &&
                         junction(st_add(excl.tail, agg.lead), excl.treal, a.prm)
                     ? excl.junc + 1
                     : 0u;
    if (tile == a.tiles - 1) {  // the last group closes at the end
        const bool j = junction(inc.tail, inc.treal, a.prm);
        a.rk[a.tiles] = j ? inc.junc + 1 : 0u;
        a.counts[0] = inc.groups;
        a.counts[1] = inc.junc + j;
        a.counts[2] = (long long)inc.occ + (j ? inc.tail.rows : 0u);
        a.counts[3] = inc.real;
        a.counts[4] = max(inc.gmax, inc.tail.size);
    }
}

template <int W>
__global__ void __launch_bounds__(TP_THREADS) k_judge_scan(JudgeArgs a) {
    __shared__ uint32_t s_start[J_TILE / 32];
    __shared__ __align__(16) uint32_t s_pay[J_TILE];
    __shared__ JSeg s_warp[TP_WARPS];
    __shared__ JSeg s_agg;
    __shared__ uint32_t s_tile;
    if (threadIdx.x == 0) s_tile = atomicAdd(a.tile_ctr, 1u);
    __syncthreads();
    const size_t tile = s_tile;
    const size_t t0 = tile * J_TILE;
    const int tn = a.n - t0 < (size_t)J_TILE ? (int)(a.n - t0) : J_TILE;
    stage_tile<W>(a, t0, tn, s_start, s_pay);
    uint32_t starts, pays[J_ITEMS];
    const JSeg s = thread_rows(s_start, s_pay, tn, a.prm, starts, pays);
    JSeg incl;
    block_seg_scan(s, s_warp, a.prm, incl);
    if (threadIdx.x == TP_THREADS - 1) s_agg = incl;
    __syncthreads();
    if (threadIdx.x < 32) tile_lookback(a, tile, s_agg);
}

template <bool COMPACT, int W>
__global__ void __launch_bounds__(TP_THREADS) k_judge_write(JudgeArgs a) {
    __shared__ uint32_t s_start[J_TILE / 32];
    __shared__ __align__(16) uint32_t s_pay[J_TILE];
    __shared__ uint32_t s_rank[J_TILE];  // by a group's start row in the tile
    __shared__ __align__(16) uint32_t s_r[J_TILE];  // by row: its group's rank
    __shared__ uint32_t s_kb[J_TILE / 32], s_go[J_TILE / 32];
    __shared__ JSeg s_warp[TP_WARPS];
    __shared__ uint32_t s_info[4];  // rank base, occurrence base, leading and trailing ranks
    const size_t tile = blockIdx.x;
    const size_t t0 = tile * J_TILE;
    const int tn = a.n - t0 < (size_t)J_TILE ? (int)(a.n - t0) : J_TILE;
    const int tid = threadIdx.x, lane = tid & 31;
    if (tile == 0 && tid == 0) *a.tile_ctr = 0;  // for the next call's K1
    stage_tile<W>(a, t0, tn, s_start, s_pay);
    uint32_t starts, pays[J_ITEMS];
    const JSeg s = thread_rows(s_start, s_pay, tn, a.prm, starts, pays);
    JSeg incl;
    const JSeg ex = block_seg_scan(s, s_warp, a.prm, incl);
    const bool tile_has = __syncthreads_or(incl.has && tid == TP_THREADS - 1);
    if (tid < 32) {
        // v: the first tile after this one with a group start (tiles: none)
        size_t v = a.tiles;
        for (size_t u0 = tile + 1; u0 < a.tiles; u0 += 32) {
            const size_t u = u0 + lane;
            const unsigned b = __ballot_sync(0xffffffffu, u < a.tiles && a.agg[u].has);
            if (b) {
                v = u0 + __ffs(b) - 1;
                break;
            }
        }
        if (lane == 0) {
            const uint32_t r_trail = a.rk[v];
            const uint32_t r_lead = tile_has ? a.rk[tile] : r_trail;
            const JSeg pre = tile > 0 ? a.incl[tile - 1] : JSeg{};
            s_info[0] = pre.junc + (r_lead != 0 && tile_has);
            s_info[1] = pre.occ + (r_lead != 0 ? pre.tail.rows : 0u);
            s_info[2] = r_lead;
            s_info[3] = r_trail;
        }
    }
    __syncthreads();
    // the thread's rows: each group's start row, and the rank of each
    // group closed here (after the leading group's, if a junction)
    const uint32_t rbase = s_info[0], r_lead = s_info[2], r_trail = s_info[3];
    const int l0 = tid * J_ITEMS;
    int open = ex.has ? (int)ex.tstart : -1;
    JSt st = ex.tail;
    uint32_t real = ex.treal, jb = ex.junc;
    int gs[J_ITEMS];
#pragma unroll
    for (int j = 0; j < J_ITEMS; ++j) {
        if (l0 + j < tn) {
            if ((starts >> j) & 1u) {
                if (open >= 0) {
                    const bool jj = junction(st, real, a.prm);
                    s_rank[open] = jj ? rbase + jb + 1 : 0u;
                    jb += jj;
                }
                open = l0 + j;
                st = row_st(pays[j]);
                real = (pays[j] >> 17) & 1u;
            } else {
                st = st_add(st, row_st(pays[j]));
            }
            if (l0 + j == tn - 1 && open >= 0) s_rank[open] = r_trail;
        }
        gs[j] = open;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < J_ITEMS; ++j)
        s_r[l0 + j] = l0 + j < tn ? (gs[j] < 0 ? r_lead : s_rank[gs[j]]) : 0u;
    __syncthreads();
    // the outputs, consecutive threads on consecutive rows
    if (COMPACT) {
        for (int l = tid; l < J_TILE; l += TP_THREADS) {
            const unsigned b = __ballot_sync(0xffffffffu, s_r[l] != 0);
            if (lane == 0) s_kb[l >> 5] = b;
        }
        __syncthreads();
        if (tid < 32) {  // exclusive offsets of the 64 groups of 32 rows
            static_assert(J_TILE == 64 * 32, "two row groups a lane");
            const uint32_t c0 = __popc(s_kb[2 * lane]), c1 = __popc(s_kb[2 * lane + 1]);
            uint32_t x = c0 + c1;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
                if (lane >= o) x += y;
            }
            s_go[2 * lane] = x - c0 - c1;
            s_go[2 * lane + 1] = x - c1;
        }
        __syncthreads();
        const uint32_t obase = s_info[1];
        for (int l = tid; l < tn; l += TP_THREADS) {
            const uint32_t r = s_r[l];
            if (r == 0) continue;
            const size_t i = t0 + l;
            const uint32_t o =
                obase + s_go[l >> 5] + __popc(s_kb[l >> 5] & ((1u << (l & 31)) - 1u));
            a.occ_pos[o] = a.pos[i];
            a.occ_id[o] = (s_pay[l] >> 16) & 1u ? -(int32_t)r : (int32_t)r;
            if ((s_start[l >> 5] >> (l & 31)) & 1u)
                for (int m = 0; m < a.w; ++m)
                    a.table[(size_t)(r - 1) * a.w + m] = a.words[i * a.w + m];
        }
    } else {
        for (int l = tid; l < tn; l += TP_THREADS) {
            const uint32_t r = s_r[l];
            const size_t i = t0 + l;
            a.keep_first[i] = ((s_start[l >> 5] >> (l & 31)) & 1u) && r != 0;
            a.keep[i] = r != 0;
            a.ids[i] = (s_pay[l] >> 16) & 1u ? -(int32_t)r : (int32_t)r;
        }
    }
}

template <int W>
cudaError_t launch(const JudgeArgs& a, bool compact, cudaStream_t st) {
    k_judge_scan<W><<<(unsigned)a.tiles, TP_THREADS, 0, st>>>(a);
    TP_LAUNCH_CHECK();
    if (compact)
        k_judge_write<true, W><<<(unsigned)a.tiles, TP_THREADS, 0, st>>>(a);
    else
        k_judge_write<false, W><<<(unsigned)a.tiles, TP_THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

size_t judge_tiles(size_t n) { return (n + J_TILE - 1) / J_TILE; }

// Scratch of cap tiles (cap even): the tile counter (16 bytes), the flags,
// the segments, the prefixes and the ranks
size_t judge_scratch(size_t cap) { return 16 + cap * (8 + 2 * sizeof(JSeg)) + (cap + 1) * 4; }

cudaError_t judge(JudgeArgs& a, bool compact, void* scratch, size_t scratch_bytes,
                  uint32_t epoch, cudaStream_t st) {
    if (a.n >= (1ull << 31) || a.w < 1 || scratch == nullptr || epoch > TP_EPOCH_MASK)
        return cudaErrorInvalidValue;
    if (a.n == 0) return cudaMemsetAsync(a.counts, 0, J_COUNTS * sizeof(long long), st);
    a.tiles = judge_tiles(a.n);
    // the layout follows the scratch's size, so that a kept scratch is read
    // the same way by every call
    size_t cap = scratch_bytes > 20 ? (scratch_bytes - 20) / (8 + 2 * sizeof(JSeg) + 4) : 0;
    cap &= ~(size_t)1;
    if (cap < a.tiles) return cudaErrorInvalidValue;
    a.epoch = epoch;
    a.tile_ctr = (uint32_t*)scratch;
    a.flags = (uint64_t*)((char*)scratch + 16);
    a.agg = (JSeg*)(a.flags + cap);
    a.incl = a.agg + cap;
    a.rk = (uint32_t*)(a.incl + cap);
    switch (a.w) {
        case 1: return launch<1>(a, compact, st);
        case 2: return launch<2>(a, compact, st);
        case 3: return launch<3>(a, compact, st);
        case 4: return launch<4>(a, compact, st);
        default: return launch<0>(a, compact, st);
    }
}

JudgeArgs judge_args(const void* words, const void* pay, size_t n, int w, int check_abundance,
                     unsigned long long abundance, void* counts) {
    JudgeArgs a{};
    a.words = (const uint32_t*)words;
    a.pay = (const uint32_t*)pay;
    a.n = n;
    a.w = w;
    a.prm = JParams{check_abundance, abundance};
    a.counts = (long long*)counts;
    return a;
}

}  // namespace

// Scratch bytes of a judge call over n records (both entries): zeroed
// before its first call and kept across calls, each call with another
// epoch (< 2^30) than the one before; the calls on one scratch run in
// stream order
extern "C" size_t tp_judge_scratch_bytes(size_t n) {
    return judge_scratch((judge_tiles(n) + 1) & ~(size_t)1);
}

// n < 2^31 sorted records. Outputs: the junction table (n_junc rows of w
// words), occ_pos (int64) and occ_id (int32) of the n_occ kept rows in
// record order; counts: n_groups, n_junc, n_occ, n_real (the real rows)
// and the most real rows of one group (int64, 5 of them). Every output
// holds n rows or more.
extern "C" int tp_judge_compact(const void* words, const void* pay, const void* pos, size_t n,
                                int w, int check_abundance, unsigned long long abundance,
                                void* scratch, size_t scratch_bytes, uint32_t epoch, void* table,
                                void* occ_pos, void* occ_id, void* counts, void* stream) {
    JudgeArgs a = judge_args(words, pay, n, w, check_abundance, abundance, counts);
    a.pos = (const long long*)pos;
    a.table = (uint32_t*)table;
    a.occ_pos = (long long*)occ_pos;
    a.occ_id = (int32_t*)occ_id;
    return (int)judge(a, true, scratch, scratch_bytes, epoch, (cudaStream_t)stream);
}

// Outputs per record: keep_first, keep (u8), ids (int32); counts as
// tp_judge_compact's.
extern "C" int tp_judge_records(const void* words, const void* pay, size_t n, int w,
                                int check_abundance, unsigned long long abundance,
                                void* scratch, size_t scratch_bytes, uint32_t epoch,
                                void* keep_first, void* keep, void* ids, void* counts,
                                void* stream) {
    JudgeArgs a = judge_args(words, pay, n, w, check_abundance, abundance, counts);
    a.keep_first = (uint8_t*)keep_first;
    a.keep = (uint8_t*)keep;
    a.ids = (int32_t*)ids;
    return (int)judge(a, false, scratch, scratch_bytes, epoch, (cudaStream_t)stream);
}
