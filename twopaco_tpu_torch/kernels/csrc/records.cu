// Record build: one sort record per vertex position of a window batch.
//
// Replaces twopaco_tpu/passes/sortpipe.py:143 build_sort_records (body
// :103 _batch_records over ops/pack.py and ops/buzhash.py) and the
// whole-batch append into the round buffer (:326 append_records): the
// kernel writes each record straight into the round buffer.
//
// Per position i of row b (vertex = chars i+1 .. i+k of the row slab,
// prev = char i, next = char i+k+1):
//   words   canonical (lexicographic min of the two strands) 2-bit k-mer,
//           MSB-first, left-aligned, w = ceil(k/16) u32 words
//   payload in | out<<8 | is_rc<<16 | real<<17 (in/out in canonical
//           orientation; N = 4 stays N under complement)
//   hv      forward + reverse-complement Buzhash of the k-char window,
//           mod 2^32; the record is real iff i < valid[b], the window has
//           no N, and low <= hv <= high
//   pos     pos_base + b*P + i (int64)
// Rows that are not real become all-ones sentinel words with payload 0,
// so they sort after every k-mer.
//
// Input: the upload form of ops/pack.py pack_codes_host, 2-bit chars
// packed little-first (char j at bits 2*(j%16) of word j/16) plus an N
// bitmask (bit j%32 of word j/32).
//
// Bound: per-thread integer work (about 4k char extractions and k
// rotates) over an input of 0.28 bytes a position and an output of
// 4w + 12 bytes a position; the reads hit L1 because neighbouring
// threads share packed words. Design: one thread per position computes
// everything directly from the packed row, with no scan and no
// intermediate arrays in device memory; the canonical strand is chosen by
// comparing words as they are generated, so no per-thread word arrays are
// kept for any k.
#include "common.cuh"

namespace {

struct Tab {
    uint32_t t[4];
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, uint32_t s) {
    return __funnelshift_l(x, x, s);  // shift amount taken mod 32
}

struct Row {
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

__device__ __forceinline__ uint32_t comp4(uint32_t c) {
    return c < 4 ? 3u - c : 4u;
}

__global__ void k_build_records(const uint32_t* __restrict__ packed,
                                const uint32_t* __restrict__ nmask,
                                const int32_t* __restrict__ valid, int B,
                                int P, int k, int w, int RW, int NW,
                                long long pos_base, uint32_t low,
                                uint32_t high, Tab tab,
                                uint32_t* __restrict__ out_words,
                                uint32_t* __restrict__ out_pay,
                                long long* __restrict__ out_pos) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * P) return;
    const int b = (int)(t / P);
    const int i = (int)(t - (long long)b * P);
    const Row row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
    const int s = i + 1;  // first char of the vertex

    uint32_t hf = 0, hr = 0;
    for (int j = 0; j < k; ++j) {
        const uint32_t c = row.code(s + j);
        hf ^= rotl32(tab.t[c], (uint32_t)(k - 1 - j));
        hr ^= rotl32(tab.t[3u - c], (uint32_t)j);
    }
    const uint32_t hv = hf + hr;
    const bool ok = i < valid[b] && row.definite(s, s + k - 1) &&
                    hv >= low && hv <= high;

    uint32_t* wout = out_words + (size_t)t * w;
    out_pos[t] = pos_base + t;
    if (!ok) {
        for (int m = 0; m < w; ++m) wout[m] = 0xffffffffu;
        out_pay[t] = 0u;
        return;
    }
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
    const uint32_t in = is_rc ? comp4(next) : prev;
    const uint32_t out = is_rc ? comp4(prev) : next;
    out_pay[t] = in | (out << 8) | ((uint32_t)is_rc << 16) | (1u << 17);
}

}  // namespace

extern "C" int tp_build_records(const void* packed, const void* nmask,
                                const void* valid, int B, int P, int k,
                                int RW, int NW, long long pos_base,
                                uint32_t low, uint32_t high, uint32_t t0,
                                uint32_t t1, uint32_t t2, uint32_t t3,
                                void* out_words, void* out_pay,
                                void* out_pos, void* stream) {
    const long long n = (long long)B * P;
    if (n == 0) return 0;
    const int w = (k + 15) / 16;
    const Tab tab{{t0, t1, t2, t3}};
    k_build_records<<<tp_blocks((size_t)n, TP_THREADS), TP_THREADS, 0,
                      (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask,
        (const int32_t*)valid, B, P, k, w, RW, NW, pos_base, low, high, tab,
        (uint32_t*)out_words, (uint32_t*)out_pay, (long long*)out_pos);
    return (int)cudaGetLastError();
}
