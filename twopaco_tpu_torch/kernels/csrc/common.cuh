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

// ---- the per-position record, shared by every kernel that reads the
// upload form of a window batch (records.cu, partition.cu, histogram.cu)
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

// Vertex hash of position i: forward + reverse-complement Buzhash of the
// k-char window, mod 2^32 (the same for both strands; N hashes as code 0)
__device__ __forceinline__ uint32_t tp_vertex_hash(const TpRow& row, int i,
                                                   int k, const TpTab& tab) {
    const int s = i + 1;
    uint32_t hf = 0, hr = 0;
    for (int j = 0; j < k; ++j) {
        const uint32_t c = row.code(s + j);
        hf ^= tp_rotl32(tab.t[c], (uint32_t)(k - 1 - j));
        hr ^= tp_rotl32(tab.t[3u - c], (uint32_t)j);
    }
    return hf + hr;
}

// Position i has a record at all: inside the row's valid count and no N
// in its window
__device__ __forceinline__ bool tp_position_ok(const TpRow& row, int i, int k,
                                               int valid) {
    return i < valid && row.definite(i + 1, i + k);
}

// The record of position i: writes its w canonical (lexicographic min of
// the two strands) k-mer words, MSB-first and left-aligned, to wout and
// returns its payload in | out<<8 | is_rc<<16 | real<<17 (in/out in
// canonical orientation; N = 4 stays N under complement). A position
// that has no record (tp_position_ok false) or whose vertex hash lies
// outside [low, high] gets all-ones sentinel words and payload 0, so it
// sorts after every k-mer. *hv receives the vertex hash.
//
// The canonical strand is chosen by comparing words as they are
// generated, so no per-thread word arrays are kept for any k.
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

}  // namespace
