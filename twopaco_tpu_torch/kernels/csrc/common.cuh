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
// tp_scan_scratch_words(n) u32 words. Used by the radix sort (digit
// offsets), the judge (group ids, ranks, compaction offsets), the round
// partition (block offsets) and the stream compaction.
cudaError_t tp_scan_inclusive_u32(const uint32_t* in, uint32_t* out,
                                  size_t n, uint32_t* scratch,
                                  cudaStream_t stream);

extern "C" size_t tp_scan_scratch_words(size_t n);

// Stable LSD radix sort of n u64 keys by bits [lo, hi), in place in key
// (sort.cu; key_alt: n u64 of scratch; counts and incl:
// tp_sort_count_words(n) u32 each; scratch: tp_scan_scratch_words of that).
// Used by the occurrence sort (occ_pack.cu).
cudaError_t tp_radix_sort_u64(uint64_t* key, uint64_t* key_alt, size_t n,
                              int lo, int hi, uint32_t* counts,
                              uint32_t* incl, uint32_t* scratch,
                              cudaStream_t st);

extern "C" size_t tp_sort_count_words(size_t n);

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

}  // namespace
