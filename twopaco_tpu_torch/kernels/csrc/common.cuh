// Shared declarations of the port's CUDA kernels (built for sm_90a).
//
// Every exported entry point has a plain C interface (bound with ctypes),
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launches (0 = success).
#pragma once

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
// compaction offsets), the round partition (block offsets), the stream
// compaction and route.cu's owner bucketing.
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
// bloom_shard.cu's bucketing): relaxed loads and stores at device scope,
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

// ---- stable owner bucketing (route.cu): n elements, each owned by one of
// D shards or by none, go to (D, cap) send slots, each owner's in element
// order. Per-tile owner counts (tp_tile_owner_counts) are scanned
// owner-major (tp_scan_inclusive_u32) and a stable scatter
// (tp_stable_scatter) ranks each element; slots past an owner's count are
// cleared and the elements past cap counted (tp_route_finish). A tile is
// TP_ROUTE_TILE elements (a block); tp_route_count_words (route.cu) sizes
// the count table. TP_ROUTE_MAX also bounds bloom_shard.cu's owners.

constexpr int TP_ROUTE_ROUNDS = 16;
constexpr int TP_ROUTE_TILE = TP_THREADS * TP_ROUTE_ROUNDS;
constexpr int TP_ROUTE_MAX = 4096;  // shards a call may route to

// counts[d * nt + tile] = elements of tile blockIdx.x owned by shard d;
// owner_of(i) >= D: no owner. Dynamic shared memory: D u32.
template <class OwnerOf>
__device__ __forceinline__ void tp_tile_owner_counts(
    size_t n, int D, uint32_t* __restrict__ counts, size_t nt,
    OwnerOf owner_of) {
    extern __shared__ uint32_t tp_hist[];
    for (int d = threadIdx.x; d < D; d += TP_THREADS) tp_hist[d] = 0;
    __syncthreads();
    const size_t base = (size_t)blockIdx.x * TP_ROUTE_TILE;
    for (int j = threadIdx.x; j < TP_ROUTE_TILE; j += TP_THREADS) {
        const size_t i = base + j;
        if (i < n) {
            const uint32_t d = owner_of(i);
            if (d < (uint32_t)D) atomicAdd(&tp_hist[d], 1u);
        }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += TP_THREADS)
        counts[(size_t)d * nt + blockIdx.x] = tp_hist[d];
}

// Stable scatter of tile blockIdx.x: the tile is walked in rounds of
// TP_THREADS consecutive elements; an element's rank among its owner's is
// the owner's running base for the tile, plus the owner's counts in lower
// warps of the round, plus its rank among equal owners in its own warp
// (match masks). put(i, d, rank) gets every owned element (a rank may
// reach past cap: put drops it). Dynamic shared memory: (1 + TP_WARPS) * D
// u32.
template <class OwnerOf, class Put>
__device__ __forceinline__ void tp_stable_scatter(
    size_t n, int D, const uint32_t* __restrict__ counts,
    const uint32_t* __restrict__ incl, size_t nt, OwnerOf owner_of, Put put) {
    extern __shared__ uint32_t tp_rank[];
    uint32_t* s_base = tp_rank;      // [D]
    uint32_t* s_wc = tp_rank + D;    // [TP_WARPS][D]
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int d = tid; d < D; d += TP_THREADS) {
        const size_t first = (size_t)d * nt;
        const size_t slot = first + blockIdx.x;
        // offset of this tile's first element among owner d's elements
        s_base[d] = (incl[slot] - counts[slot]) - (incl[first] - counts[first]);
        for (int v = 0; v < TP_WARPS; ++v) s_wc[v * D + d] = 0;
    }
    __syncthreads();
    const size_t base = (size_t)blockIdx.x * TP_ROUTE_TILE;
    for (int r = 0; r < TP_ROUTE_ROUNDS; ++r) {
        const size_t i = base + (size_t)r * TP_THREADS + tid;
        const uint32_t oi = i < n ? owner_of(i) : (uint32_t)D;
        const bool live = oi < (uint32_t)D;
        // dead lanes get distinct non-owner values and never write
        const uint32_t d = live ? oi : (uint32_t)D + lane;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const unsigned lower = peers & ((1u << lane) - 1u);
        if (live && lower == 0) s_wc[warp * D + d] = __popc(peers);
        __syncthreads();
        if (live) {
            uint32_t dst = s_base[d] + __popc(lower);
            for (int v = 0; v < warp; ++v) dst += s_wc[v * D + d];
            put(i, d, dst);
        }
        __syncthreads();
        for (int dd = tid; dd < D; dd += TP_THREADS) {
            uint32_t tot = 0;
            for (int v = 0; v < TP_WARPS; ++v) {
                tot += s_wc[v * D + dd];
                s_wc[v * D + dd] = 0;
            }
            s_base[dd] += tot;
        }
        __syncthreads();
    }
}

__device__ __forceinline__ uint32_t tp_owner_total(const uint32_t* counts,
                                                   const uint32_t* incl,
                                                   size_t nt, int d) {
    const size_t first = (size_t)d * nt;
    return incl[first + nt - 1] - (incl[first] - counts[first]);
}

// Thread t: clear(t) for every send slot t = d * cap + j past owner d's
// count, and the elements of owner t past cap added to *overflow. Launch
// over max(D * cap, D) threads.
template <class Clear>
__device__ __forceinline__ void tp_route_finish(
    const uint32_t* __restrict__ counts, const uint32_t* __restrict__ incl,
    size_t nt, int D, int cap, unsigned long long* __restrict__ overflow,
    Clear clear) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < (size_t)D) {
        const uint32_t tot = tp_owner_total(counts, incl, nt, (int)t);
        if (tot > (uint32_t)cap)
            atomicAdd(overflow, (unsigned long long)(tot - (uint32_t)cap));
    }
    if (t >= (size_t)D * cap) return;
    const int d = (int)(t / cap);
    if (t - (size_t)d * cap >= tp_owner_total(counts, incl, nt, d)) clear(t);
}

}  // namespace
