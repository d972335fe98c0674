// Shared declarations of the port's CUDA kernels (built for sm_90a).
//
// Every exported entry point has a plain C interface (bound with ctypes),
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launches (0 = success).
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define TP_LAUNCH_CHECK()                          \
    do {                                           \
        cudaError_t tp_err_ = cudaGetLastError();  \
        if (tp_err_ != cudaSuccess) return tp_err_; \
    } while (0)

constexpr int TP_THREADS = 256;
constexpr int TP_WARPS = TP_THREADS / 32;

inline unsigned tp_blocks(size_t n, size_t per_block) {
    return (unsigned)((n + per_block - 1) / per_block);
}

// Inclusive prefix sum of n u32 values (in may equal out). scratch holds
// tp_scan_scratch_words(n) u32 words. Used by the judge (group ids, ranks,
// compaction offsets), the round partition (block offsets) and the
// stream compaction.
cudaError_t tp_scan_inclusive_u32(const uint32_t* in, uint32_t* out,
                                  size_t n, uint32_t* scratch,
                                  cudaStream_t stream);

extern "C" size_t tp_scan_scratch_words(size_t n);

// Stable LSD radix sort of n u64 keys by bits [lo, hi) (sort.cu) over
// tp_radix_passes(lo, hi) digit passes that alternate between key and
// key_alt: the result is in key after an even count, in key_alt after an
// odd one. scratch: tp_sort_scratch_bytes(n, passes) bytes or more. Used
// by the occurrence sort (occ_pack.cu).
cudaError_t tp_radix_sort_u64(uint64_t* key, uint64_t* key_alt, size_t n,
                              int lo, int hi, void* scratch,
                              size_t scratch_bytes, cudaStream_t st);

int tp_radix_passes(int lo, int hi);

extern "C" size_t tp_sort_scratch_bytes(size_t n, int passes);

// ---- the per-position record, shared by every kernel that reads the
// upload form of a window batch (records.cu, partition.cu, histogram.cu
// and the Bloom engine's bloom_*.cu)
//
// Upload form (ops/pack.py pack_codes_host): 2-bit chars packed
// little-first (char j at bits 2*(j%16) of word j/16) plus an N bitmask
// (bit j%32 of word j/32). Position i of a row is the vertex of chars
// i+1 .. i+k; prev = char i, next = char i+k+1.
namespace {

constexpr uint32_t TP_REAL = 1u << 17;  // payload bit of a real record

struct TpTab {
    uint32_t t[4];
};

__device__ __forceinline__ uint32_t tp_rotl32(uint32_t x, uint32_t s) {
    return __funnelshift_l(x, x, s);  // shift amount taken mod 32
}

// The status words of a decoupled look-back (sort.cu's digit passes,
// the owner bucketing below): relaxed loads and stores at device scope,
// each word read and written whole.
__device__ __forceinline__ uint64_t tp_load_relaxed(const uint64_t* p) {
    uint64_t v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

__device__ __forceinline__ void tp_store_relaxed(uint64_t* p, uint64_t v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

// Exclusive prefix of v over the block's threads, and the block's total
// (s_warp: a shared word a warp; every thread of the block calls)
__device__ __forceinline__ uint32_t tp_block_excl_scan(uint32_t v, uint32_t* s_warp,
                                                       uint32_t& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    uint32_t off = 0;
    total = 0;
    for (int u = 0; u < (int)(blockDim.x >> 5); ++u) {
        if (u < warp) off += s_warp[u];
        total += s_warp[u];
    }
    __syncthreads();
    return off + x - v;
}

__device__ __forceinline__ uint32_t tp_block_excl_scan(uint32_t v, uint32_t* s_warp) {
    uint32_t total;
    return tp_block_excl_scan(v, s_warp, total);
}

struct TpRow {
    const uint32_t* packed;
    const uint32_t* nmask;

    __device__ __forceinline__ uint32_t code(int j) const {
        return (packed[j >> 4] >> (2 * (j & 15))) & 3u;  // N reads as 0
    }
    __device__ __forceinline__ bool is_n(int j) const {
        return (nmask[j >> 5] >> (j & 31)) & 1u;
    }
    __device__ __forceinline__ uint32_t ext(int j) const {
        return is_n(j) ? 4u : code(j);
    }
    // word m of the forward k-mer starting at char s
    __device__ __forceinline__ uint32_t fw_word(int s, int k, int m) const {
        uint32_t x = 0;
        for (int q = 0; q < 16; ++q) {
            const int t = 16 * m + q;
            if (t >= k) break;
            x |= code(s + t) << (30 - 2 * q);
        }
        return x;
    }
    // word m of its reverse complement: rc char t = 3 - char (s+k-1-t)
    __device__ __forceinline__ uint32_t rc_word(int s, int k, int m) const {
        uint32_t x = 0;
        for (int q = 0; q < 16; ++q) {
            const int t = 16 * m + q;
            if (t >= k) break;
            x |= (3u - code(s + k - 1 - t)) << (30 - 2 * q);
        }
        return x;
    }
    // no N among chars [lo, hi]
    __device__ __forceinline__ bool definite(int lo, int hi) const {
        for (int wi = lo >> 5; wi <= (hi >> 5); ++wi) {
            const int a = max(lo - 32 * wi, 0);
            const int z = min(hi - 32 * wi, 31);
            const int len = z - a + 1;
            const uint32_t sel =
                (len == 32 ? 0xffffffffu : ((1u << len) - 1u)) << a;
            if (nmask[wi] & sel) return false;
        }
        return true;
    }
};

__device__ __forceinline__ uint32_t tp_comp4(uint32_t c) {
    return c < 4 ? 3u - c : 4u;
}

// Forward and reverse-complement Buzhash of the k-char window starting at
// char s (N hashes as code 0):
//     hf = XOR_j rotl(T[c_{s+j}], k-1-j),  hr = XOR_j rotl(T[3-c_{s+j}], j)
__device__ __forceinline__ void tp_strand_hashes(const TpRow& row, int s,
                                                 int k, const TpTab& tab,
                                                 uint32_t& hf, uint32_t& hr) {
    hf = 0;
    hr = 0;
    for (int j = 0; j < k; ++j) {
        const uint32_t c = row.code(s + j);
        hf ^= tp_rotl32(tab.t[c], (uint32_t)(k - 1 - j));
        hr ^= tp_rotl32(tab.t[3u - c], (uint32_t)j);
    }
}

// Vertex hash of position i: hf + hr of its k-char window, mod 2^32 (the
// same for both strands)
__device__ __forceinline__ uint32_t tp_vertex_hash(const TpRow& row, int i,
                                                   int k, const TpTab& tab) {
    uint32_t hf, hr;
    tp_strand_hashes(row, i + 1, k, tab, hf, hr);
    return hf + hr;
}

// Position i has a record at all: inside the row's valid count and no N
// in its window
__device__ __forceinline__ bool tp_position_ok(const TpRow& row, int i, int k,
                                               int valid) {
    return i < valid && row.definite(i + 1, i + k);
}

// The canonical record of position i (whose window holds no N): writes
// its w canonical (lexicographic min of the two strands) k-mer words,
// MSB-first and left-aligned, to wout and returns its payload in | out<<8 |
// is_rc<<16 | real<<17 (in/out in canonical orientation; N = 4 stays N
// under complement). The canonical strand is chosen by comparing words as
// they are generated, so no per-thread word arrays are kept for any k.
__device__ __forceinline__ uint32_t tp_canonical_record(
    const TpRow& row, int i, int k, int w, uint32_t* __restrict__ wout) {
    const int s = i + 1;
    bool is_rc = false;
    for (int m = 0; m < w; ++m) {
        const uint32_t f = row.fw_word(s, k, m);
        const uint32_t r = row.rc_word(s, k, m);
        if (f != r) {
            is_rc = r < f;
            break;
        }
    }
    for (int m = 0; m < w; ++m)
        wout[m] = is_rc ? row.rc_word(s, k, m) : row.fw_word(s, k, m);
    const uint32_t prev = row.ext(i);
    const uint32_t next = row.ext(i + k + 1);
    const uint32_t in = is_rc ? tp_comp4(next) : prev;
    const uint32_t out = is_rc ? tp_comp4(prev) : next;
    return in | (out << 8) | ((uint32_t)is_rc << 16) | TP_REAL;
}

// The sort record of position i: tp_canonical_record when the position
// has a record (tp_position_ok) and its vertex hash lies in [low, high];
// else all-ones sentinel words and payload 0, so it sorts after every
// k-mer. *hv receives the vertex hash.
__device__ __forceinline__ uint32_t tp_build_record(
    const TpRow& row, int i, int k, int w, int valid, uint32_t low,
    uint32_t high, const TpTab& tab, uint32_t* __restrict__ wout,
    uint32_t* hv) {
    const uint32_t h = tp_vertex_hash(row, i, k, tab);
    *hv = h;
    if (!(tp_position_ok(row, i, k, valid) && h >= low && h <= high)) {
        for (int m = 0; m < w; ++m) wout[m] = 0xffffffffu;
        return 0u;
    }
    return tp_canonical_record(row, i, k, w, wout);
}

// ---- the Bloom engine's hashes (ops/buzhash.py out_edge_sym, in_edge_sym,
// probe_indices_from_sym), shared by bloom_fill.cu and bloom_mark.cu

// The four char tables (TABLE_1 .. TABLE_4): tables 1-2 give 32-bit probe
// indices, all four 64-bit ones (f > 32)
struct TpTabs {
    TpTab t[4];
};

// Strand-symmetric hash of the out-edge W·c from W's strand hashes:
//     (rotl(hf, 1) ^ T[c]) + (rotl(T[3-c], k) ^ hr)
__device__ __forceinline__ uint32_t tp_out_edge(uint32_t hf, uint32_t hr,
                                                const TpTab& t, uint32_t c,
                                                int k) {
    return (tp_rotl32(hf, 1u) ^ t.t[c]) +
           (tp_rotl32(t.t[3u - c], (uint32_t)k) ^ hr);
}

// ... and of the in-edge c·W: (rotl(T[c], k) ^ hf) + (rotl(hr, 1) ^ T[3-c])
__device__ __forceinline__ uint32_t tp_in_edge(uint32_t hf, uint32_t hr,
                                               const TpTab& t, uint32_t c,
                                               int k) {
    return (tp_rotl32(t.t[c], (uint32_t)k) ^ hf) +
           (tp_rotl32(hr, 1u) ^ t.t[3u - c]);
}

// Edge hashes e[t] of the out-edge (out) or in-edge with char c under
// the first nt (2 or 4) tables, from the vertex's strand hashes
__device__ __forceinline__ void tp_edge_hashes(const uint32_t* hf,
                                               const uint32_t* hr,
                                               const TpTabs& tabs, int nt,
                                               bool out, uint32_t c, int k,
                                               uint32_t* e) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
        if (t < nt)
            e[t] = out ? tp_out_edge(hf[t], hr[t], tabs.t[t], c, k)
                       : tp_in_edge(hf[t], hr[t], tabs.t[t], c, k);
}

// Kirsch-Mitzenmacher index j of an edge, mod 2^f: f <= 32 from the u32
// pair (e0, e1), f > 32 (f <= 63) from H1 = e2 << 32 | e0 and H2 = e3 << 32
// | e1 as one 64-bit multiply-add; the step H2 is made odd. The block
// layout's in-block bits are the f = 8 indices.
__device__ __forceinline__ uint64_t tp_km_index(const uint32_t* e,
                                                uint32_t j, int f) {
    if (f <= 32) {
        const uint32_t h = e[0] + j * (e[1] | 1u);
        return f == 32 ? h : (h & ((1u << f) - 1u));
    }
    const uint64_t h1 = ((uint64_t)e[2] << 32) | e[0];
    const uint64_t h2 = ((uint64_t)e[3] << 32) | e[1] | 1ull;
    return (h1 + (uint64_t)j * h2) & ((1ull << f) - 1ull);
}

// The Bloom layouts (ops/bloom.py)
constexpr int TP_LAYOUT_BYTE = 0;
constexpr int TP_LAYOUT_BIT = 1;
constexpr int TP_LAYOUT_BLOCK = 2;
constexpr int TP_BLOCK_WORDS = 8;  // a block: 256 bits

// ---- the Bloom passes' view of a position, shared by bloom_fill.cu,
// bloom_mark.cu and bloom_shard.cu

// Fill (twopaco_tpu kernels.py:130 fill_indices, :179 fill_indices_block):
// a position with a record (tp_position_ok) gets the strand hashes of its
// vertex V under the first nt tables, the vertex hashes of V and of V_next
// (the next position's vertex), whether each counts for the round [low,
// high] (V_next only when its window holds no N), and its prev and next
// chars (4 = N).
struct TpFillPos {
    uint32_t hf[4], hr[4];
    uint32_t hv, hvn, prev, next;
    bool in_v, in_n;
};

__device__ __forceinline__ bool tp_fill_position(const TpRow& row, int i,
                                                 int k, int valid,
                                                 uint32_t low, uint32_t high,
                                                 const TpTabs& tabs, int nt,
                                                 TpFillPos& p) {
    if (!tp_position_ok(row, i, k, valid)) return false;
#pragma unroll
    for (int u = 0; u < 4; ++u)
        if (u < nt)
            tp_strand_hashes(row, i + 1, k, tabs.t[u], p.hf[u], p.hr[u]);
    p.hv = p.hf[0] + p.hr[0];
    p.hvn = tp_vertex_hash(row, i + 1, k, tabs.t[0]);
    p.in_v = p.hv >= low && p.hv <= high;
    p.in_n = row.definite(i + 2, i + k + 1) && p.hvn >= low && p.hvn <= high;
    p.prev = row.ext(i);
    p.next = row.ext(i + k + 1);
    return true;
}

// The byte and bit layouts' edges of a position in the round: slot 0 the
// out-edge V·next (V·A when next is N), 1 the dummy V·T when next is N, 2
// and 3 the dummy in-edges A·V and T·V when prev is N. -> bit e set when
// slot e is inserted.
__device__ __forceinline__ unsigned tp_fill_slots(const TpFillPos& p) {
    return 1u | (p.next >= 4 ? 2u : 0u) | (p.prev >= 4 ? 12u : 0u);
}

// Edge hashes of fill slot e under the first nt tables
__device__ __forceinline__ void tp_fill_edge(const TpFillPos& p,
                                             const TpTabs& tabs, int nt,
                                             int e, int k, uint32_t* eh) {
    const uint32_t c = e == 0 ? (p.next < 4 ? p.next : 0u) : (e == 2 ? 0u : 3u);
    tp_edge_hashes(p.hf, p.hr, tabs, nt, e < 2, c, k, eh);
}

// Mark (twopaco_tpu kernels.py:273 mark_indices): true for a position with
// a record whose vertex hash lies in [low, high] (mark_decide's `base`);
// hf, hr get the strand hashes of the first nt tables (nt >= 1).
__device__ __forceinline__ bool tp_mark_position(const TpRow& row, int i,
                                                 int k, int valid,
                                                 uint32_t low, uint32_t high,
                                                 const TpTabs& tabs, int nt,
                                                 uint32_t* hf, uint32_t* hr) {
    if (!tp_position_ok(row, i, k, valid)) return false;
#pragma unroll
    for (int u = 0; u < 4; ++u)
        if (u < nt) tp_strand_hashes(row, i + 1, k, tabs.t[u], hf[u], hr[u]);
    const uint32_t hv = hf[0] + hr[0];
    return hv >= low && hv <= high;
}

// The candidate decision of a vertex in the round (kernels.py:315
// mark_decide, the reference's CandidateCheckingWorker):
//     in  = 2 [prev is N] + sum_c ([c == prev] or hit(0, c))  > 1, or
//     out = 2 [next is N] + sum_c ([c == next] or hit(1, c))  > 1
// over c in ACGT; hit(side, c) is the Bloom hit of the in-edge c·V (side
// 0) or the out-edge V·c (side 1), asked only while it can change the
// answer.
template <class Hit>
__device__ __forceinline__ bool tp_mark_decide(uint32_t prev, uint32_t next,
                                               Hit hit) {
    for (int side = 0; side < 2; ++side) {
        const uint32_t own = side ? next : prev;
        int cnt = own >= 4 ? 2 : 0;
        for (uint32_t c = 0; c < 4 && cnt <= 1; ++c)
            cnt += c == own ? 1 : (int)hit(side, c);
        if (cnt > 1) return true;
    }
    return false;
}

// A warp's 32 decisions into the packed mask (kernels.py:336 pack_mask: 8
// positions a byte, MSB first) and their count added to *count. Every lane
// of the warp calls it; lane l holds position t (t >= n: none), and the
// block's threads are consecutive positions from a multiple of 32.
__device__ __forceinline__ void tp_pack_candidates(
    bool cand, long long t, long long n, uint8_t* __restrict__ mask,
    unsigned long long* __restrict__ count) {
    const unsigned ballot = __ballot_sync(0xffffffffu, cand);
    const int lane = threadIdx.x & 31;
    if (t < n && (lane & 7) == 0)
        mask[t >> 3] = (uint8_t)(__brev((ballot >> lane) & 0xffu) >> 24);
    if (lane == 0 && ballot)
        atomicAdd(count, (unsigned long long)__popc(ballot));
}

// ---- one-sweep stable owner bucketing (bloom_shard.cu tp_shard_bucket,
// route.cu tp_route_records): the items of a call, each owned by one of D
// shards or by none, go to (D, cap) send slots, each owner's in item order.
// A block takes the next tile of items from an atomic counter (so it only
// waits on tiles that started); then, barrier to barrier:
// - rank (tp_warp_rank): each warp ranks its contiguous part of the tile by
//   owner, stably: up to 32 owners a ballot an owner with lane d counting
//   owner d's, more (up to TP_ROUTE_MAX) match masks and u16 counters in
//   shared memory (the match path alone at D=4 took the slice's fill
//   bucketing from 17.9 to 25.3 ms, H100);
// - offsets (tp_tile_offsets): per owner the lower warps' counts and the
//   tile's total, the owners' runs in the tile, the totals published to u64
//   status words (value | flag);
// - the caller stages its items owner-major in shared memory;
// - look-back (tp_owner_lookback): a warp an owner reads the status words
//   of 32 earlier tiles at a time, back to the nearest inclusive prefix,
//   and publishes its own;
// - the caller stores each owner's run of the tile coalesced
//   (tp_run_owner: the owner of a staged slot), ranks past cap dropped;
// and a tail kernel (tp_owner_tail) clears each owner's slots past its
// count and counts the items past cap, from the last tile's prefixes.
// A status word is value (32 bits) | flag (2 bits) | epoch (30 bits); a
// word of another epoch reads as unpublished, so a scratch whose words
// carry each call's epoch needs no clearing between calls: the callers'
// tail kernels reset the tile counter, and both callers' wrappers share
// one scratch a (device, stream) (kernels/build.py lookback_scratch).

constexpr int TP_ROUTE_MAX = 4096;          // owners a call may bucket to
constexpr uint64_t TP_ST_AGG = 1ull << 32;   // the tile's own count
constexpr uint64_t TP_ST_INCL = 2ull << 32;  // ... the prefix over tiles 0 .. t
constexpr uint32_t TP_EPOCH_MASK = (1u << 30) - 1;

__device__ __forceinline__ uint64_t tp_status(uint64_t flag, uint32_t value,
                                              uint32_t epoch) {
    return flag | value | ((uint64_t)epoch << 34);
}

__device__ __forceinline__ bool tp_status_ready(uint64_t v, uint32_t epoch) {
    return ((v >> 32) & 3u) != 0 && (uint32_t)(v >> 34) == epoch;
}

// Stable in-warp ranks of a tile's items by owner: warp w takes items
// [w * wi, (w + 1) * wi) (wi a multiple of 32), 32 at a time, and lane l
// calls owner(it) once for its item it (>= D: none). s_rank[it] gets the
// item's rank among its warp's items of that owner, s_wc[w * D + d] the
// warp's count of owner d (u16, zeroed by the caller).
template <class Owner>
__device__ __forceinline__ void tp_warp_rank(int D, int wi, Owner owner,
                                             uint16_t* s_rank, uint16_t* s_wc) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int w0 = warp * wi;
    const unsigned lower = (1u << lane) - 1u;
    if (D <= 32) {
        uint32_t cnt = 0;  // lane d: the warp's owner-d items so far
        for (int sl = 0; sl < wi; sl += 32) {
            const int it = w0 + sl + lane;
            const uint32_t o = owner(it);
            unsigned peers = 0, mine = 0;
            for (int d = 0; d < D; ++d) {
                const unsigned b = __ballot_sync(0xffffffffu, o == (uint32_t)d);
                if (o == (uint32_t)d) peers = b;
                if (lane == d) mine = __popc(b);
            }
            const uint32_t before = __shfl_sync(0xffffffffu, cnt, o < (uint32_t)D ? o : 0);
            cnt += mine;
            s_rank[it] = (uint16_t)(before + __popc(peers & lower));
        }
        if (lane < D) s_wc[warp * D + lane] = (uint16_t)cnt;
    } else {
        uint16_t* wc = s_wc + warp * D;
        for (int sl = 0; sl < wi; sl += 32) {
            const int it = w0 + sl + lane;
            const uint32_t o = owner(it);
            const bool live = o < (uint32_t)D;
            // dead lanes get distinct non-owner keys and are never counted
            const unsigned peers = __match_any_sync(0xffffffffu, live ? o : (uint32_t)D + lane);
            uint32_t before = 0;
            if (live) before = wc[o];
            __syncwarp();
            if (live && (peers & lower) == 0) wc[o] = (uint16_t)(before + __popc(peers));
            __syncwarp();
            s_rank[it] = (uint16_t)(before + __popc(peers & lower));
        }
    }
}

// After tp_warp_rank and a barrier: s_wc[v * D + o] becomes owner o's count
// in the warps below v (in place), s_tot[o] the tile's count, s_tex[o] the
// offset of owner o's run in the tile (s_tex[D]: the tile's owned items);
// the totals are published as tile `tile`'s status (tile 0: its inclusive
// prefix). Every thread calls; ends with a barrier.
__device__ __forceinline__ void tp_tile_offsets(int D, size_t tile, uint32_t epoch,
                                                uint16_t* s_wc, uint32_t* s_tot,
                                                uint32_t* s_tex, uint32_t* s_scan,
                                                uint64_t* status) {
    const int nw = blockDim.x >> 5;
    for (int o = threadIdx.x; o < D; o += blockDim.x) {
        uint32_t c = 0;
        for (int v = 0; v < nw; ++v) {
            const uint32_t w = s_wc[v * D + o];
            s_wc[v * D + o] = (uint16_t)c;
            c += w;
        }
        s_tot[o] = c;
    }
    __syncthreads();
    uint32_t carry = 0;
    for (int o0 = 0; o0 < D; o0 += blockDim.x) {
        const int o = o0 + threadIdx.x;
        uint32_t total;
        const uint32_t ex = tp_block_excl_scan(o < D ? s_tot[o] : 0u, s_scan, total);
        if (o < D) s_tex[o] = carry + ex;
        carry += total;
    }
    if (threadIdx.x == 0) s_tex[D] = carry;
    for (int o = threadIdx.x; o < D; o += blockDim.x)
        tp_store_relaxed(status + tile * D + o,
                         tp_status(tile == 0 ? TP_ST_INCL : TP_ST_AGG, s_tot[o], epoch));
    __syncthreads();
}

// A warp an owner: s_dst[o] = owner o's items in the tiles before `tile`,
// and the tile's inclusive prefix published. Lane l reads the status of
// tile (tile - 1 - l) of a window of 32 earlier tiles; the window sums up
// to the nearest inclusive prefix, or moves 32 tiles back (tile 0 is
// always inclusive, so no window passes it). Every thread calls; the
// caller synchronises before reading s_dst.
__device__ __forceinline__ void tp_owner_lookback(int D, size_t tile, uint32_t epoch,
                                                  const uint32_t* s_tot, uint32_t* s_dst,
                                                  uint64_t* status) {
    const int lane = threadIdx.x & 31;
    for (int o = threadIdx.x >> 5; o < D; o += blockDim.x >> 5) {
        uint32_t excl = 0;
        if (tile != 0) {
            for (long long top = (long long)tile - 1;; top -= 32) {
                const long long t = top - lane;
                uint64_t v = 0;
                if (t >= 0) {
                    do {
                        v = tp_load_relaxed(status + (size_t)t * D + o);
                    } while (!tp_status_ready(v, epoch));
                }
                const unsigned incl = __ballot_sync(0xffffffffu, (v & TP_ST_INCL) != 0);
                const int stop = incl ? __ffs(incl) - 1 : 31;
                excl += __reduce_add_sync(0xffffffffu, lane <= stop ? (uint32_t)v : 0u);
                if (incl) break;
            }
            if (lane == 0)
                tp_store_relaxed(status + tile * D + o,
                                 tp_status(TP_ST_INCL, excl + s_tot[o], epoch));
        }
        if (lane == 0) s_dst[o] = excl;
    }
}

// The owner whose run of the tile holds staged slot t (t < s_tex[D]): the
// last owner whose run starts at or before t
__device__ __forceinline__ int tp_run_owner(const uint32_t* s_tex, int D, uint32_t t) {
    int lo = 0, hi = D - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_tex[mid] <= t) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

// Block (chunk, owner d) of a tail kernel over (D, cap) send slots:
// clear(j) for every slot j = d * cap + c of owner d's row from its count
// (the value of the last tile's status word last[d]) to cap, `chunk` slots
// a block (a chunk below the count exits at once); block (0, d) adds owner
// d's items past cap to *overflow.
template <class Clear>
__device__ __forceinline__ void tp_owner_tail(const uint64_t* __restrict__ last,
                                              size_t cap, size_t chunk,
                                              unsigned long long* __restrict__ overflow,
                                              Clear clear) {
    const size_t d = blockIdx.y;
    const size_t tot = (uint32_t)last[d];
    if (blockIdx.x == 0 && threadIdx.x == 0 && tot > cap)
        atomicAdd(overflow, (unsigned long long)(tot - cap));
    const size_t c0 = (size_t)blockIdx.x * chunk;
    const size_t end = cap - c0 < chunk ? cap : c0 + chunk;
    for (size_t j = (tot > c0 ? tot : c0) + threadIdx.x; j < end; j += blockDim.x)
        clear(d * cap + j);
}

// ---- rolled strand hashes (bloom_shard.cu's bucketing, histogram.cu): the
// char tables T[4u + c] of tables u < nt in shared memory, never indexed out
// of the parameter space at run time

// Strand hashes of the k-char window at char s under the first nt tables
// (tp_strand_hashes; N reads as code 0)
__device__ __forceinline__ void tp_window_hashes(const TpRow& row, int s, int k,
                                                 int nt, const uint32_t* T,
                                                 uint32_t* hf, uint32_t* hr) {
#pragma unroll
    for (int u = 0; u < 4; ++u) hf[u] = hr[u] = 0;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
        const uint32_t c = row.code(s + j);
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (u < nt) {
                hf[u] ^= tp_rotl32(T[4 * u + c], (uint32_t)(k - 1 - j));
                hr[u] ^= tp_rotl32(T[4 * u + 3 - c], (uint32_t)j);
            }
    }
}

// ... rolled from the window at char s to the one at s + 1 (Tk: T rotated
// by k, Tk1: by k - 1): hf' = rotl(hf, 1) ^ rotl(T[out], k) ^ T[in] and
// its mirror for hr
__device__ __forceinline__ void tp_roll_hashes(const TpRow& row, int s, int k,
                                               int nt, const uint32_t* T,
                                               const uint32_t* Tk,
                                               const uint32_t* Tk1,
                                               uint32_t* hf, uint32_t* hr) {
    const uint32_t co = row.code(s);
    const uint32_t ci = row.code(s + k);
#pragma unroll
    for (int u = 0; u < 4; ++u)
        if (u < nt) {
            hf[u] = tp_rotl32(hf[u], 1u) ^ Tk[4 * u + co] ^ T[4 * u + ci];
            hr[u] = tp_rotl32(hr[u] ^ T[4 * u + 3 - co], 31u) ^ Tk1[4 * u + 3 - ci];
        }
}

// set() once a device and process (bit d of `ready` for devices 0 .. 63;
// past them every call): kernel attributes
template <class Set>
inline cudaError_t tp_once_per_device(std::atomic<uint64_t>& ready, Set set) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const uint64_t bit = dev < 64 ? 1ull << dev : 0;
    if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
    e = set();
    if (e == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
    return e;
}

}  // namespace
