// The hash-sharded Bloom filter of the dist-bloom engine: owner bucketing of
// a shard's fill and mark indices, the local fill and probe of the slots a
// shard receives, and the candidate decision from the hits sent back.
//
// Replaces twopaco_tpu/parallel/sharded.py:112 _bucket (over the indices of
// twopaco_tpu/passes/kernels.py:130 fill_indices and :273 mark_indices),
// :143 _local_fill, :149 _local_probe, and :155 _unbucket with the rest of
// :181 _mark_shard_fn (kernels.py:315 mark_decide, :336 pack_mask).
//
// A filter of 2^f global slots is sharded over D shards: global slot i lives
// on shard i mod D at local slot i div D. Per batch a shard
//   tp_shard_bucket       computes the 4q (fill) or 8q (mark) indices of
//                         each position of its rows, in the flat (row,
//                         position, edge, hash) order, and buckets them by
//                         owner into (D, cap) u64 send slots of local slots,
//                         each owner's in that order (stable); unused slots
//                         hold all-ones, the indices past cap are dropped
//                         and counted. In mark mode it also writes each
//                         probe's send slot owner*cap + rank (all-ones where
//                         the probe is not sent), edge-hash major: probe j
//                         of position t at j * B*P + t;
// and, after the exchange (the mesh's all_to_all),
//   tp_shard_fill_apply   sets the received local slots in its shard;
//   tp_shard_probe        reads them: one u8 hit a slot (all-ones: 0);
// both read each received row only up to its first unsent slot (a row is
// a prefix of sent slots, then all-ones: the bucketing writes each owner's
// in rank order);
// and, after the hits come back along the same slots,
//   tp_shard_mark_finish  gathers each position's 8q hits through its send
//                         slots, ANDs each edge's q, decides (the vertex
//                         hash and prev and next from the upload form) and
//                         packs the candidate mask MSB first, adding the
//                         count to an int64.
//
// Bound: bytes. The bucketing reads the upload form and writes the send
// slots (and the probe slots); the fill and probe touch one byte or u32
// word a received slot at random over a shard of up to 2 GiB.
//
// The bucketing is one sweep (the scheme of sort.cu's k_onesweep). A
// block takes the next tile of consecutive positions (256, fewer as q
// grows, down to one) from an atomic counter, so it only waits on tiles
// that started; the stages of a tile, barrier to barrier:
// - hash: a thread takes a run of RUN positions of one row, hashes the
//   first window from scratch and rolls the strand hashes one char at a
//   time, hf' = rotl(hf, 1) ^ rotl(T[out], k) ^ T[in] and its mirror for
//   hr (N reads as code 0, as the from-scratch hash reads it). The char
//   tables and their rotations sit in shared memory, never indexed out of
//   the parameter space at run time. Each position leaves its strand
//   hashes and its gate (the edges it inserts or probes) in shared memory;
// - indices: a thread a (position, edge) computes the edge's hashes once
//   and its q indices into shared memory, in the flat order;
// - rank, offsets and publish, stage, look-back: common.cuh's one-sweep
//   owner bucketing (shared with route.cu), the local slots staged in
//   shared memory owner-major;
// - write: consecutive threads store consecutive send slots of each owner's
//   run of the tile (ranks past cap dropped), and in mark mode each probe's
//   send slot, coalesced along the positions.
// Hashing runs on a quarter of the block and, like the ranking, is bound by
// issue and latency, not bytes; the mark mode's write stage by its stores.
// A tail kernel (common.cuh tp_owner_tail) writes the unsent slots of every
// owner's row, adds the indices past cap to the overflow and resets the
// tile counter: the status words carry a per-call epoch, so the scratch,
// shared with route.cu's, lives across calls with no memset. Indices
// travel as u32 while f < 32 and as u64 from f = 32; owners and local
// slots come from a multiply-shift divisor while an index is below 2^31.
//
// The probe: a block a PROBE_CHUNK-slot chunk of a row, as the fill. A
// chunk that starts unsent writes zeros and reads nothing more; otherwise
// consecutive threads load consecutive slots, each thread issues all its
// filter reads, then stores its hits. Its time is the filter's random
// reads. One slot a lane keeps a warp's read on 32 consecutive slots, so
// a slot the batch probes twice a few slots apart (an edge from both of
// its vertices) is one request; 4 slots a lane (16-byte loads) spread it
// over 128 slots and measured slower.
//
// The mark finish: one launch a call. A thread takes a run of positions of
// one row (the Bloom round kernels' rule, common.cuh tp_bloom_grid: 8,
// halved while the call's threads would not give every SM 1024, so 1 at a
// dist-bloom shard's 64 rows of 2048), rolls the strand hashes of table 1
// along it with the char tables in shared memory (no table in a stack
// frame), and keeps the window's last N. For a position in the round with
// prev and next ACGT it loads the first probe slots of its six needed
// edges together (coalesced along the positions), then their hits
// together, then slot j only of the edges still alive, as bloom_mark.cu
// reads its filter: a few dependent round trips a position instead of up
// to 6q pairs one after another. Its bytes: the probe slots it reads, the
// upload form, a hit a read slot and the mask.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr uint64_t SENT = ~0ull;  // an index that is not sent / empty slot
constexpr uint32_t NOT_SENT = 0xffffffffu;
constexpr int FILL_CHUNK = 4096;   // received slots a fill block
constexpr int PROBE_CHUNK = 4096;  // received slots a probe block
constexpr int TAIL_CHUNK = 4096;   // send slots a block of the tail
constexpr int PROBE_ITEMS = PROBE_CHUNK / TP_THREADS;  // slots a thread
constexpr int RUN = 4;             // positions a hashing thread rolls over
constexpr int TILE_MAX = 256;      // positions a bucketing tile, at most
// dynamic shared memory a bucketing block: two blocks an SM where they
// fit, one at most
constexpr size_t SMEM_TARGET = 112 * 1024;
constexpr size_t SMEM_MAX = 226 * 1024;

// The bucketing's tile: tpos positions (a power of two), per indices a
// position, items = per * tpos rounded up to the block's warps, wi a warp
struct Geo {
    int per, tpos, items, wi;
    size_t smem;
};

// Shared bytes of a tile: the flat indices and the staged local slots
// (w64: u64, else u32), the u16 in-tile ranks, the strand hashes (4
// tables, hf and hr) and gate word of each position, per owner the tile's
// total, offset in the tile (D + 1) and offset in the send row, and the
// warps' u16 owner counters.
size_t geo_smem(int tpos, int per, int D, bool w64) {
    const size_t items = ((size_t)tpos * per + TP_THREADS - 1) / TP_THREADS * TP_THREADS;
    return items * (2 * (w64 ? 8 : 4) + 2) + (size_t)tpos * 9 * 4 +
           (size_t)(3 * D + 1) * 4 + (size_t)TP_WARPS * D * 2;
}

// The largest tile (TILE_MAX halved while over SMEM_TARGET, down to one
// position); false when even one position exceeds SMEM_MAX
bool plan_geo(int D, int q, int f, int mark, Geo& g) {
    g.per = (mark ? 8 : 4) * q;
    const bool w64 = f >= 32;
    g.tpos = TILE_MAX;
    while (g.tpos > 1 && geo_smem(g.tpos, g.per, D, w64) > SMEM_TARGET)
        g.tpos /= 2;
    g.smem = geo_smem(g.tpos, g.per, D, w64);
    g.items = (g.tpos * g.per + TP_THREADS - 1) / TP_THREADS * TP_THREADS;
    g.wi = g.items / TP_WARPS;
    return g.smem <= SMEM_MAX && g.items < 65536;
}

size_t bucket_tiles(size_t n_pos, int tpos) {
    return std::max<size_t>((n_pos + tpos - 1) / tpos, 1);
}

// Scratch: the tile counter (8 bytes), then the status words (tiles x D u64)
size_t bucket_scratch(size_t n_pos, int D, const Geo& g) {
    return 8 + bucket_tiles(n_pos, g.tpos) * (size_t)D * 8;
}

// floor(x / d) for x < 2^31 as (x * m) >> s, m = ceil(2^(31+l) / d), l =
// ceil(log2 d), m < 2^32 (Granlund and Montgomery 1994): a runtime
// divisor without the division's instruction sequence
struct Div31 {
    uint32_t m;
    int s;
};

Div31 make_div31(uint32_t d) {
    int l = 0;
    while ((1ull << l) < d) ++l;
    return {(uint32_t)(((1ull << (31 + l)) + d - 1) / d), 31 + l};
}

__device__ __forceinline__ uint32_t div31(uint32_t x, Div31 v) {
    return (uint32_t)(((uint64_t)x * v.m) >> v.s);
}

struct BucketArgs {
    const uint32_t* packed;
    const uint32_t* nmask;
    const int32_t* valid;
    int B, P, k, RW, NW;
    uint32_t low, high;
    uint32_t tab[16];  // TABLE_1 .. TABLE_4, 4 words each
    int q, f, D, cap;
    Geo g;
    int tpos_log2;
    Div31 by_d;  // index div D
    uint64_t* send;
    uint32_t* probe_slot;  // mark mode
    uint64_t* status;
    uint32_t* tile_ctr;
    uint32_t epoch;
};

// Owner (x mod D) and local slot (x div D) of a global index
template <bool W64>
__device__ __forceinline__ uint32_t split_index(
    typename std::conditional<W64, uint64_t, uint32_t>::type x, int D, Div31 by_d,
    uint64_t& local) {
    if (W64 && (uint64_t)x >> 31) {
        local = (uint64_t)x / (uint64_t)D;
        return (uint32_t)((uint64_t)x - local * (uint64_t)D);
    }
    const uint32_t l = div31((uint32_t)x, by_d);
    local = l;
    return (uint32_t)x - l * (uint32_t)D;
}

template <bool W64>
__device__ __forceinline__ uint32_t owner_of(
    typename std::conditional<W64, uint64_t, uint32_t>::type x, int D, Div31 by_d) {
    uint64_t local;
    return split_index<W64>(x, D, by_d, local);
}

template <bool MARK, bool W64>
__global__ void __launch_bounds__(TP_THREADS) k_shard_bucket(BucketArgs a) {
    using Idx = typename std::conditional<W64, uint64_t, uint32_t>::type;
    constexpr Idx NONE = (Idx)~(Idx)0;
    extern __shared__ __align__(16) unsigned char s_mem[];
    const int D = a.D;
    const int tpos = a.g.tpos;
    const int per = a.g.per;
    const int items = a.g.items;
    Idx* s_flat = (Idx*)s_mem;                     // [items] flat order
    Idx* s_om = s_flat + items;                    // [items] owner-major
    uint32_t* s_h = (uint32_t*)(s_om + items);     // [8][tpos] hf_u, hr_u
    uint32_t* s_gate = s_h + 8 * tpos;             // [tpos]
    uint32_t* s_tot = s_gate + tpos;               // [D]
    uint32_t* s_tex = s_tot + D;                   // [D + 1]
    uint32_t* s_dst = s_tex + D + 1;               // [D]
    uint16_t* s_rank = (uint16_t*)(s_dst + D);     // [items]
    uint16_t* s_wc = s_rank + items;               // [TP_WARPS][D]
    __shared__ uint32_t s_T[16], s_Tk[16], s_Tk1[16];
    __shared__ uint32_t s_scan[TP_WARPS];
    __shared__ uint32_t s_tile;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) {
        s_tile = atomicAdd(a.tile_ctr, 1u);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            const uint32_t t = a.tab[u];
            s_T[u] = t;
            s_Tk[u] = tp_rotl32(t, (uint32_t)a.k);
            s_Tk1[u] = tp_rotl32(t, (uint32_t)(a.k - 1));
        }
    }
    for (int i = tid; i < TP_WARPS * D; i += TP_THREADS) s_wc[i] = 0;
    __syncthreads();
    const size_t tile = s_tile;
    const long long n = (long long)a.B * a.P;
    const long long t0 = (long long)tile * tpos;
    const int tpn = (int)max(0ll, min((long long)tpos, n - t0));  // positions
    const int nt = a.f > 32 ? 4 : 2;
    const int k = a.k;

    // hash: runs of RUN positions, rolled; each position's hashes and gate
    // (bit e: edge e inserted or probed; fill: bits 8-9 the out-edge's char)
    if (tid * RUN < tpos) {
        uint32_t hf[4], hr[4];
        for (int s = 0; s < RUN && tid * RUN + s < tpos; ++s) {
            const int p = tid * RUN + s;
            uint32_t gate = 0;
            if (p < tpn) {
                const long long t = t0 + p;
                const int b = (int)(t / a.P);
                const int i = (int)(t - (long long)b * a.P);
                const TpRow row{a.packed + (size_t)b * a.RW, a.nmask + (size_t)b * a.NW};
                if (s == 0 || i == 0) tp_window_hashes(row, i + 1, k, nt, s_T, hf, hr);
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (u < nt) {
                        s_h[(2 * u) * tpos + p] = hf[u];
                        s_h[(2 * u + 1) * tpos + p] = hr[u];
                    }
                const uint32_t hv = hf[0] + hr[0];
                // on to position i + 1: the next of the run, and V_next
                tp_roll_hashes(row, i + 1, k, nt, s_T, s_Tk, s_Tk1, hf, hr);
                if (tp_position_ok(row, i, k, a.valid[b])) {
                    const bool in_v = hv >= a.low && hv <= a.high;
                    if (MARK) {
                        gate = in_v ? 0xffu : 0u;
                    } else {
                        const uint32_t hvn = hf[0] + hr[0];
                        const bool in_n = row.definite(i + 2, i + k + 1) &&
                                          hvn >= a.low && hvn <= a.high;
                        if (in_v || in_n) {
                            const uint32_t prev = row.ext(i);
                            const uint32_t next = row.ext(i + k + 1);
                            // bloom_fill.cu's edges: out V·next (V·A when next is N),
                            // dummies V·T when next is N, A·V and T·V when prev is N
                            gate = 1u | (next >= 4 ? 2u : 0u) | (prev >= 4 ? 12u : 0u) |
                                   ((next < 4 ? next : 0u) << 8);
                        }
                    }
                }
            }
            s_gate[p] = gate;
        }
    }
    __syncthreads();

    // indices: a thread a (position, edge) computes the edge's hashes once
    // and its q indices, into s_flat in the flat order
    constexpr int EDGES = MARK ? 8 : 4;
    for (int pe = tid; pe < tpos * EDGES; pe += TP_THREADS) {
        const int p = pe / EDGES;
        const int e = pe % EDGES;
        Idx* dst = s_flat + p * per + e * a.q;
        const uint32_t gate = s_gate[p];  // 0 past the batch's positions
        if (!((gate >> e) & 1u)) {
            for (int j = 0; j < a.q; ++j) dst[j] = NONE;
            continue;
        }
        // common.cuh tp_edge_hash: mark edges 0-3 in c·V, 4-7 out V·c;
        // fill edge 0 out V·next, 1 out V·T, 2 in A·V, 3 in T·V
        const bool out = MARK ? e >= 4 : e < 2;
        const uint32_t c = MARK ? (uint32_t)(e & 3) : (e == 0 ? gate >> 8 : (e == 2 ? 0u : 3u));
        uint32_t eh[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (u < nt) {
                const uint32_t hf = s_h[(2 * u) * tpos + p];
                const uint32_t hr = s_h[(2 * u + 1) * tpos + p];
                eh[u] = tp_edge_hash(hf, hr, s_T, s_Tk, u, out, c);
            }
        for (int j = 0; j < a.q; ++j) dst[j] = (Idx)tp_km_index(eh, (uint32_t)j, a.f);
    }
    for (int it = tpos * per + tid; it < items; it += TP_THREADS) s_flat[it] = NONE;
    __syncthreads();

    // rank, per-owner offsets in the tile, publish (common.cuh)
    tp_warp_rank(D, a.g.wi, [&](int it) {
        const Idx x = s_flat[it];
        return x == NONE ? (uint32_t)D : owner_of<W64>(x, D, a.by_d);
    }, s_rank, s_wc);
    __syncthreads();
    tp_tile_offsets(D, tile, a.epoch, s_wc, s_tot, s_tex, s_scan, a.status);

    // stage the local slots owner-major; s_rank becomes the in-tile rank
    const int w0 = warp * a.g.wi;
#pragma unroll 4
    for (int sl = 0; sl < a.g.wi; sl += 32) {
        const int it = w0 + sl + lane;
        const Idx x = s_flat[it];
        if (x == NONE) continue;
        uint64_t local;
        const uint32_t o = split_index<W64>(x, D, a.by_d, local);
        const uint32_t r = s_wc[warp * D + o] + s_rank[it];
        s_rank[it] = (uint16_t)r;
        s_om[s_tex[o] + r] = (Idx)local;
    }

    tp_owner_lookback(D, tile, a.epoch, s_tot, s_dst, a.status);
    __syncthreads();

    // each owner's run of the tile: consecutive threads, consecutive slots
    const uint32_t cap = (uint32_t)a.cap;
    const uint32_t staged = s_tex[D];
#pragma unroll 4
    for (uint32_t t = tid; t < staged; t += TP_THREADS) {
        const int lo = tp_run_owner(s_tex, D, t);
        const uint32_t g = s_dst[lo] + (t - s_tex[lo]);
        if (g < cap) a.send[(size_t)lo * cap + g] = (uint64_t)s_om[t];
    }
    if (MARK) {
        // probe j of position p: consecutive threads, consecutive positions
#pragma unroll 4
        for (int x = tid; x < per * tpos; x += TP_THREADS) {
            const int j = x >> a.tpos_log2;
            const int p = x & (tpos - 1);
            if (p >= tpn) continue;
            const int it = p * per + j;
            const Idx v = s_flat[it];
            uint32_t slot = NOT_SENT;
            if (v != NONE) {
                const uint32_t o = owner_of<W64>(v, D, a.by_d);
                const uint32_t r = s_dst[o] + s_rank[it];
                if (r < cap) slot = o * cap + r;
            }
            a.probe_slot[(size_t)j * n + t0 + p] = slot;
        }
    }
}

// The unsent slots of every owner's row, and the indices past cap; the
// tile counter back to 0 for the next call
__global__ void k_shard_tail(const uint64_t* __restrict__ last, size_t cap,
                             uint64_t* __restrict__ send,
                             unsigned long long* __restrict__ overflow,
                             uint32_t* __restrict__ tile_ctr) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *tile_ctr = 0;
    tp_owner_tail(last, cap, TAIL_CHUNK, overflow, [&](size_t j) { send[j] = SENT; });
}

// Set slot s, storing only when it is not set yet: in a run over related
// genomes most slots were set by an earlier batch, and reading a random
// sector costs less than its read-modify-write (dist-bloom -f 30 on the
// slice: 25.6 -> 17.4 ms over the fill's 492 launches, H100)
__device__ __forceinline__ void set_slot(void* filt, int layout, uint64_t s) {
    if (layout == TP_LAYOUT_BYTE) {
        uint8_t* b = (uint8_t*)filt + s;
        if (*b == 0) *b = 1;
    } else {
        uint32_t* w = (uint32_t*)filt + (s >> 5);
        const uint32_t bit = 1u << (s & 31);
        if (!(*w & bit)) atomicOr(w, bit);
    }
}

// Block (chunk, row) of the received (D, cap) block sets the sent slots of
// its FILL_CHUNK slots of row blockIdx.y. A row is a prefix of sent slots,
// then SENT (the bucketing writes each owner's in rank order): a chunk
// that starts unsent is unsent to the row's end, and a thread stops at its
// first SENT. VEC: 16-byte loads (row starts 16-byte aligned, cap even),
// all of a thread's loads in flight before its stores.
template <bool VEC>
__global__ void k_shard_fill_apply(const uint64_t* __restrict__ recv,
                                   size_t cap, int layout, void* filt) {
    const uint64_t* row = recv + (size_t)blockIdx.y * cap;
    const size_t c0 = (size_t)blockIdx.x * FILL_CHUNK;
    if (row[c0] == SENT) return;
    const size_t len = cap - c0 < FILL_CHUNK ? cap - c0 : FILL_CHUNK;
    if (VEC) {
        constexpr int PAIRS = FILL_CHUNK / (2 * TP_THREADS);
        const ulonglong2* r2 = reinterpret_cast<const ulonglong2*>(row + c0);
        ulonglong2 v[PAIRS];
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            const size_t t = (size_t)q * TP_THREADS + threadIdx.x;
            v[q] = 2 * t < len ? r2[t] : make_ulonglong2(SENT, SENT);
        }
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            if (v[q].x == SENT) return;
            set_slot(filt, layout, v[q].x);
            if (v[q].y == SENT) return;
            set_slot(filt, layout, v[q].y);
        }
    } else {
        constexpr int ITEMS = FILL_CHUNK / TP_THREADS;
        uint64_t v[ITEMS];
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
            const size_t t = (size_t)q * TP_THREADS + threadIdx.x;
            v[q] = t < len ? row[c0 + t] : SENT;
        }
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
            if (v[q] == SENT) return;
            set_slot(filt, layout, v[q]);
        }
    }
}

__device__ __forceinline__ uint32_t probe_slot_hit(const void* filt,
                                                   int layout, uint64_t s) {
    if (s == SENT) return 0;
    if (layout == TP_LAYOUT_BYTE) return ((const uint8_t*)filt)[s] != 0;
    return (((const uint32_t*)filt)[s >> 5] >> (s & 31)) & 1u;
}

// Block (chunk, row): the hits of PROBE_CHUNK slots of row blockIdx.y of
// the received (D, cap) block. A chunk that starts unsent writes zeros.
// Consecutive threads take consecutive slots, PROBE_ITEMS a thread: all its
// 8-byte loads in flight before its filter reads, and those before its
// byte stores. A warp's filter read then covers 32 consecutive slots, so a
// slot probed again a few slots later (an edge probed from both of its
// vertices) joins the same request.
__global__ void k_shard_probe(const uint64_t* __restrict__ recv, size_t cap,
                              int layout, const void* __restrict__ filt,
                              uint8_t* __restrict__ hits) {
    const uint64_t* row = recv + (size_t)blockIdx.y * cap;
    uint8_t* out = hits + (size_t)blockIdx.y * cap;
    const size_t c0 = (size_t)blockIdx.x * PROBE_CHUNK;
    const size_t len = cap - c0 < PROBE_CHUNK ? cap - c0 : PROBE_CHUNK;
    if (row[c0] == SENT) {
        for (size_t t = threadIdx.x; t < len; t += TP_THREADS) out[c0 + t] = 0;
        return;
    }
    uint64_t v[PROBE_ITEMS];
#pragma unroll
    for (int q = 0; q < PROBE_ITEMS; ++q) {
        const size_t t = (size_t)q * TP_THREADS + threadIdx.x;
        v[q] = t < len ? row[c0 + t] : SENT;
    }
    uint32_t h[PROBE_ITEMS];
#pragma unroll
    for (int q = 0; q < PROBE_ITEMS; ++q) h[q] = probe_slot_hit(filt, layout, v[q]);
#pragma unroll
    for (int q = 0; q < PROBE_ITEMS; ++q) {
        const size_t t = (size_t)q * TP_THREADS + threadIdx.x;
        if (t < len) out[c0 + t] = (uint8_t)h[q];
    }
}

// The mark finish's arguments: the batch (B*P = n positions), table 1 of
// the char tables, the probe slots and the hits sent back
struct FinishArgs {
    const uint8_t* back;
    const uint32_t* probe_slot;
    const uint32_t* packed;
    const uint32_t* nmask;
    const int32_t* valid;
    long long n;
    int P, k, RW, NW, q, run;
    uint32_t low, high;
    uint32_t tab[4];  // TABLE_1: the vertex hash
    uint8_t* mask;
    unsigned long long* count;
};

// One of the needed edges (bit e of need: probe rows e*q .. e*q + q-1)
// hits at position t: slot j of every edge whose probes 0 .. j-1 hit, for
// j = 0, 1, ...: the probe slots of those edges loaded together (coalesced
// along t), then their hits together, so that no load waits on another
// edge's and a later probe is read only while its edge can still hit. A
// probe not sent (NOT_SENT) reads as a miss.
__device__ __forceinline__ bool any_probe_hits(const uint32_t* __restrict__ probe_slot,
                                               const uint8_t* __restrict__ back, long long n,
                                               int q, unsigned need, long long t) {
    unsigned alive = need;
    for (int j = 0; j < q && alive; ++j) {
        uint32_t s[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
            s[e] = (alive >> e) & 1u ? __ldg(probe_slot + (size_t)(e * q + j) * n + t) : NOT_SENT;
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = s[e] != NOT_SENT ? __ldg(back + s[e]) : 0u;
        unsigned set = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) set |= (h[e] != 0 ? 1u : 0u) << e;
        alive = set;
    }
    return alive != 0;
}

// A thread a run of `run` positions of one row (P % 8 == 0), the strand
// hashes of table 1 rolled along it with the char tables in shared memory
// and the window's last N kept, as bloom_mark.cu's. A position in the round
// (a record, vertex hash in [low, high]) is a candidate when prev or next
// is N, or when one of its six edges c·V (c != prev) and V·c (c != next)
// hits: kernels.py:315 mark_decide, as bloom_mark.cu decides it. The run's
// decisions are packed by common.cuh tp_pack_runs.
__global__ void __launch_bounds__(TP_THREADS) k_shard_mark_finish(FinishArgs a) {
    __shared__ uint32_t s_T[4], s_Tk[4], s_Tk1[4];
    // thread 0 at fixed indices: an index into the parameters that depends
    // on the thread would copy them to a stack frame
    if (threadIdx.x == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const uint32_t t = a.tab[c];
            s_T[c] = t;
            s_Tk[c] = tp_rotl32(t, (uint32_t)a.k);
            s_Tk1[c] = tp_rotl32(t, (uint32_t)(a.k - 1));
        }
    }
    __syncthreads();
    const long long x0 = ((long long)blockIdx.x * TP_THREADS + threadIdx.x) * a.run;
    const bool live = x0 < a.n;  // every lane packs, live or not
    unsigned bits = 0;           // bit s: position x0 + s is a candidate
    if (live) {
        const int k = a.k;
        const int r = (int)(x0 / a.P);
        const int i0 = (int)(x0 - (long long)r * a.P);
        const int end = min(i0 + a.run, (int)a.valid[r]);
        const TpRow row{a.packed + (size_t)r * a.RW, a.nmask + (size_t)r * a.NW};
        uint32_t hf[4], hr[4];
        int last_n = 0;
        if (i0 < end) {
            tp_window_hashes(row, i0 + 1, k, 1, s_T, hf, hr);
            last_n = tp_last_n(row, i0 + 1, i0 + k);  // up to V's last char
        }
        for (int i = i0; i < end; ++i) {
            const uint32_t next = row.ext(i + k + 1);
            const uint32_t hv = hf[0] + hr[0];
            if (last_n < i + 1 && hv >= a.low && hv <= a.high) {
                const uint32_t prev = row.ext(i);
                bool cand = prev >= 4 || next >= 4;
                if (!cand)
                    cand = any_probe_hits(a.probe_slot, a.back, a.n, a.q,
                                          (0xfu & ~(1u << prev)) | (0xf0u & ~(16u << next)),
                                          x0 + (i - i0));
                bits |= (unsigned)cand << (i - i0);
            }
            if (next >= 4) last_n = i + k + 1;
            if (i + 1 < end) tp_roll_hashes(row, i + 1, k, 1, s_T, s_Tk, s_Tk1, hf, hr);
        }
    }
    tp_pack_runs(bits, a.run, x0, live, a.mask, a.count);
}

template <bool MARK, bool W64>
cudaError_t launch_bucket(const BucketArgs& a, size_t tiles, cudaStream_t st) {
    // once a device: all of the SM's unified memory as shared memory, so
    // that blocks of a tile's size fit side by side (the default carveout
    // may not), and up to SMEM_MAX dynamic shared bytes a block
    static std::atomic<uint64_t> ready{0};
    const cudaError_t e = tp_once_per_device(ready, [] {
        const cudaError_t e1 = cudaFuncSetAttribute(
            k_shard_bucket<MARK, W64>, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
        if (e1 != cudaSuccess) return e1;
        return cudaFuncSetAttribute(k_shard_bucket<MARK, W64>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    });
    if (e != cudaSuccess) return e;
    k_shard_bucket<MARK, W64><<<(unsigned)tiles, TP_THREADS, a.g.smem, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Bytes of tp_shard_bucket's scratch for n_pos positions (0: D, q and f
// need more shared memory than a block has)
extern "C" size_t tp_shard_scratch_bytes(size_t n_pos, int D, int q, int f,
                                         int mark) {
    Geo g;
    if (D < 1 || q < 1 || !plan_geo(D, q, f, mark, g)) return 0;
    return bucket_scratch(n_pos, D, g);
}

// Bucket one batch's fill (mark = 0) or mark (mark = 1) indices by owner.
// The batch: B rows of the upload form (packed, nmask, valid; RW, NW words a
// row), P positions a row, the round [low, high]; tabs, q, f as
// tp_bloom_fill (f > 32: 64-bit indices). Scratch: scratch_bytes >=
// tp_shard_scratch_bytes(B*P, D, q, f, mark), zeroed before its first call
// and kept across calls, each call with another epoch (< 2^30) than the one
// before, as tp_route_records' (the two may share one). Outputs: send
// (D, cap) u64; probe_slot ((8q, B*P) u32 in mark mode, null in fill
// mode); overflow (one int64, added to).
extern "C" int tp_shard_bucket(const void* packed, const void* nmask,
                               const void* valid, int B, int P, int k, int RW,
                               int NW, uint32_t low, uint32_t high,
                               const uint32_t* tabs, int q, int f, int mark,
                               int D, int cap, void* scratch,
                               size_t scratch_bytes, uint32_t epoch, void* send,
                               void* probe_slot, void* overflow,
                               void* stream) {
    Geo g;
    if (D < 1 || D > TP_ROUTE_MAX || cap < 1 || q < 1 || k < 1 || epoch > TP_EPOCH_MASK ||
        (mark && probe_slot == nullptr) || !plan_geo(D, q, f, mark, g))
        return (int)cudaErrorInvalidValue;
    const size_t n_pos = (size_t)B * P;
    const size_t need = bucket_scratch(n_pos, D, g);
    if (scratch == nullptr || scratch_bytes < need) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t tiles = bucket_tiles(n_pos, g.tpos);
    BucketArgs a{};
    a.packed = (const uint32_t*)packed;
    a.nmask = (const uint32_t*)nmask;
    a.valid = (const int32_t*)valid;
    a.B = B, a.P = P, a.k = k, a.RW = RW, a.NW = NW;
    a.low = low, a.high = high;
    for (int u = 0; u < 16; ++u) a.tab[u] = tabs[u];
    a.q = q, a.f = f, a.D = D, a.cap = cap;
    a.g = g;
    while ((1 << a.tpos_log2) < g.tpos) ++a.tpos_log2;
    a.by_d = make_div31((uint32_t)D);
    a.send = (uint64_t*)send;
    a.probe_slot = (uint32_t*)probe_slot;
    a.tile_ctr = (uint32_t*)scratch;
    a.status = (uint64_t*)((char*)scratch + 8);
    a.epoch = epoch;
    const bool w64 = f >= 32;
    const cudaError_t e = mark ? (w64 ? launch_bucket<true, true>(a, tiles, st)
                                      : launch_bucket<true, false>(a, tiles, st))
                               : (w64 ? launch_bucket<false, true>(a, tiles, st)
                                      : launch_bucket<false, false>(a, tiles, st));
    if (e != cudaSuccess) return (int)e;
    k_shard_tail<<<dim3(tp_blocks((size_t)cap, TAIL_CHUNK), (unsigned)D), TP_THREADS, 0,
                   st>>>(a.status + (tiles - 1) * D, (size_t)cap, (uint64_t*)send,
                         (unsigned long long*)overflow, a.tile_ctr);
    return (int)cudaGetLastError();
}

// Set the received local slots recv ((D, cap) u64: row d from shard d, a
// prefix of sent slots, then all-ones) in the shard filt: layout 0 byte
// (u8 slots), 1 bit (u32 words).
extern "C" int tp_shard_fill_apply(const void* recv, size_t rows, size_t cap,
                                   int layout, void* filt, void* stream) {
    if (rows == 0 || cap == 0) return 0;
    if (rows > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(tp_blocks(cap, FILL_CHUNK), (unsigned)rows);
    const cudaStream_t st = (cudaStream_t)stream;
    const uint64_t* r = (const uint64_t*)recv;
    if ((uintptr_t)recv % 16 == 0 && cap % 2 == 0)
        k_shard_fill_apply<true><<<grid, TP_THREADS, 0, st>>>(r, cap, layout, filt);
    else
        k_shard_fill_apply<false><<<grid, TP_THREADS, 0, st>>>(r, cap, layout, filt);
    return (int)cudaGetLastError();
}

// hits (rows * cap u8): 1 where the received local slot of recv ((rows,
// cap) u64, each row a prefix of sent slots, then all-ones) is set in the
// shard filt (layout as tp_shard_fill_apply's), 0 where it is all-ones.
extern "C" int tp_shard_probe(const void* recv, size_t rows, size_t cap,
                              int layout, const void* filt, void* hits,
                              void* stream) {
    if (rows == 0 || cap == 0) return 0;
    if (rows > 65535) return (int)cudaErrorInvalidValue;
    k_shard_probe<<<dim3(tp_blocks(cap, PROBE_CHUNK), (unsigned)rows), TP_THREADS, 0,
                    (cudaStream_t)stream>>>((const uint64_t*)recv, cap, layout, filt,
                                            (uint8_t*)hits);
    return (int)cudaGetLastError();
}

// The candidate mask of a batch from the hits sent back: back (D*cap u8,
// indexed by the probe slots of tp_shard_bucket's mark mode), probe_slot
// ((8q, B*P) u32), the batch and round as tp_shard_bucket's (tabs: table 1
// is read). A thread rolls along the Bloom round kernels' run for the
// batch (tp_bloom_run(B*P, 1)). Outputs: mask (B*P/8 u8, P % 8 == 0),
// count (one int64, added to). One launch.
extern "C" int tp_shard_mark_finish(const void* back, const void* probe_slot,
                                    const void* packed, const void* nmask,
                                    const void* valid, int B, int P, int k,
                                    int RW, int NW, uint32_t low,
                                    uint32_t high, const uint32_t* tabs, int q,
                                    void* mask, void* count, void* stream) {
    const long long n = (long long)B * P;
    if (n == 0) return 0;
    if (P % 8 != 0 || q < 1 || k < 1)
        return (int)cudaErrorInvalidValue;
    FinishArgs a{};
    a.back = (const uint8_t*)back;
    a.probe_slot = (const uint32_t*)probe_slot;
    a.packed = (const uint32_t*)packed;
    a.nmask = (const uint32_t*)nmask;
    a.valid = (const int32_t*)valid;
    a.n = n, a.P = P, a.k = k, a.RW = RW, a.NW = NW, a.q = q;
    a.low = low, a.high = high;
    for (int c = 0; c < 4; ++c) a.tab[c] = tabs[c];
    a.mask = (uint8_t*)mask;
    a.count = (unsigned long long*)count;
    dim3 grid;
    const cudaError_t e = tp_bloom_grid(n, 1, a.run, grid);
    if (e != cudaSuccess) return (int)e;
    k_shard_mark_finish<<<grid.x, TP_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
