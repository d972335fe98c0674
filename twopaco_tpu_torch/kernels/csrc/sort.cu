// Round sort: stable LSD radix sort of the records by their w k-mer
// words, carrying payload and position.
//
// Replaces twopaco_tpu/passes/sortpipe.py:365 sort_records (a lax.sort
// on the w key words, num_keys=w).
//
// Keys: for w <= 2 (k <= 31) one u64, w0<<32 | w1, sorted over its 32w
// bits; for w > 2, one 32-bit pass group per word from the last word to
// the first, each over the permutation the previous words left (LSD over
// words). The all-ones sentinel rows sort last as unsigned keys. Each
// 8-bit digit pass is: per-tile digit histograms (shared-memory atomics),
// the shared scan (scan.cu) over the digit-major count table, and a
// stable scatter of (key, index); the record columns are gathered once
// through the final permutation.
//
// Bound: bytes moved. Each digit pass reads and writes 12 bytes of
// (key, index) per record; w = 2 takes 8 passes, about 200 bytes a record
// with the gather. Design: ranks inside a tile come from warp match
// masks (__match_any_sync) plus per-warp digit counts in shared memory,
// so the scatter is stable without a sort inside the tile. Onesweep-style
// chained scans and wider digits would cut the passes; that is later
// work.
#include "common.cuh"

namespace {

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int RADIX_ROUNDS = 16;
constexpr int RADIX_TILE = TP_THREADS * RADIX_ROUNDS;
constexpr int RADIX_WARPS = TP_THREADS / 32;
static_assert(TP_THREADS == RADIX, "one thread per digit in the tile");

__global__ void k_make_key(const uint32_t* __restrict__ words, size_t n,
                           int w, uint64_t* __restrict__ key,
                           uint32_t* __restrict__ idx) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    key[i] = w == 1 ? (uint64_t)words[i]
                    : ((uint64_t)words[2 * i] << 32) | words[2 * i + 1];
    idx[i] = (uint32_t)i;
}

__global__ void k_iota(uint32_t* __restrict__ idx, size_t n) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) idx[i] = (uint32_t)i;
}

// key = word j of the record at permutation slot i
__global__ void k_word_key(const uint32_t* __restrict__ words,
                           const uint32_t* __restrict__ idx, size_t n, int w,
                           int j, uint64_t* __restrict__ key) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) key[i] = words[(size_t)idx[i] * w + j];
}

// counts[d * nt + tile] = records of the tile whose digit is d
__global__ void k_radix_hist(const uint64_t* __restrict__ key, size_t n,
                             int shift, uint32_t* __restrict__ counts,
                             size_t nt) {
    __shared__ uint32_t h[RADIX];
    h[threadIdx.x] = 0;
    __syncthreads();
    const size_t base = (size_t)blockIdx.x * RADIX_TILE;
    for (int j = threadIdx.x; j < RADIX_TILE; j += TP_THREADS) {
        const size_t i = base + j;
        if (i < n) atomicAdd(&h[(key[i] >> shift) & (RADIX - 1)], 1u);
    }
    __syncthreads();
    counts[(size_t)threadIdx.x * nt + blockIdx.x] = h[threadIdx.x];
}

// Stable scatter: the tile is walked in rounds of TP_THREADS consecutive
// records; a record's destination is its digit's running base for the
// tile, plus the counts of that digit in lower warps of the round, plus
// its rank among equal digits in its own warp.
__global__ void k_radix_scatter(const uint64_t* __restrict__ key_in,
                                const uint32_t* __restrict__ idx_in,
                                uint64_t* __restrict__ key_out,
                                uint32_t* __restrict__ idx_out, size_t n,
                                int shift,
                                const uint32_t* __restrict__ counts,
                                const uint32_t* __restrict__ incl,
                                size_t nt) {
    __shared__ uint32_t s_base[RADIX];
    __shared__ uint32_t s_wc[RADIX_WARPS][RADIX];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t slot = (size_t)tid * nt + blockIdx.x;
    s_base[tid] = incl[slot] - counts[slot];
    for (int v = 0; v < RADIX_WARPS; ++v) s_wc[v][tid] = 0;
    __syncthreads();
    const size_t base = (size_t)blockIdx.x * RADIX_TILE;
    for (int r = 0; r < RADIX_ROUNDS; ++r) {
        const size_t i = base + (size_t)r * TP_THREADS + tid;
        const bool live = i < n;
        const uint64_t kk = live ? key_in[i] : 0;
        // dead lanes get distinct non-digit values and never write
        const uint32_t d =
            live ? (uint32_t)((kk >> shift) & (RADIX - 1)) : RADIX + lane;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const unsigned lower = peers & ((1u << lane) - 1u);
        if (live && lower == 0) s_wc[warp][d] = __popc(peers);
        __syncthreads();
        if (live) {
            uint32_t dst = s_base[d] + __popc(lower);
            for (int v = 0; v < warp; ++v) dst += s_wc[v][d];
            key_out[dst] = kk;
            idx_out[dst] = idx_in[i];
        }
        __syncthreads();
        uint32_t tot = 0;
        for (int v = 0; v < RADIX_WARPS; ++v) {
            tot += s_wc[v][tid];
            s_wc[v][tid] = 0;
        }
        s_base[tid] += tot;
        __syncthreads();
    }
}

__global__ void k_gather(const uint32_t* __restrict__ words,
                         const uint32_t* __restrict__ pay,
                         const long long* __restrict__ pos,
                         const uint32_t* __restrict__ idx, size_t n, int w,
                         uint32_t* __restrict__ out_words,
                         uint32_t* __restrict__ out_pay,
                         long long* __restrict__ out_pos) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t src = idx[i];
    for (int j = 0; j < w; ++j) out_words[i * w + j] = words[src * w + j];
    out_pay[i] = pay[src];
    out_pos[i] = pos[src];
}

struct Bufs {
    uint64_t* key;
    uint64_t* key_alt;
    uint32_t* idx;
    uint32_t* idx_alt;
    uint32_t* counts;
    uint32_t* incl;
    uint32_t* scratch;
};

// Digit passes over bits [0, bits) of key; an even pass count leaves the
// result in (key, idx).
cudaError_t radix_passes(Bufs& b, size_t n, int bits, cudaStream_t st) {
    const size_t nt = (n + RADIX_TILE - 1) / RADIX_TILE;
    for (int shift = 0; shift < bits; shift += RADIX_BITS) {
        k_radix_hist<<<(unsigned)nt, TP_THREADS, 0, st>>>(b.key, n, shift,
                                                         b.counts, nt);
        TP_LAUNCH_CHECK();
        const cudaError_t e = tp_scan_inclusive_u32(
            b.counts, b.incl, (size_t)RADIX * nt, b.scratch, st);
        if (e != cudaSuccess) return e;
        k_radix_scatter<<<(unsigned)nt, TP_THREADS, 0, st>>>(
            b.key, b.idx, b.key_alt, b.idx_alt, n, shift, b.counts, b.incl,
            nt);
        TP_LAUNCH_CHECK();
        uint64_t* tk = b.key;
        b.key = b.key_alt;
        b.key_alt = tk;
        uint32_t* ti = b.idx;
        b.idx = b.idx_alt;
        b.idx_alt = ti;
    }
    return cudaSuccess;
}

}  // namespace

// Scratch (all sized by the caller): key, key_alt (n u64); idx, idx_alt
// (n u32); counts, incl (256 * ceil(n / 4096) u32); scan scratch
// (tp_scan_scratch_words(256 * ceil(n / 4096)) u32).
extern "C" size_t tp_sort_count_words(size_t n) {
    return (size_t)RADIX * ((n + RADIX_TILE - 1) / RADIX_TILE);
}

extern "C" int tp_sort_records(const void* words, const void* pay,
                               const void* pos, size_t n, int w, void* key,
                               void* key_alt, void* idx, void* idx_alt,
                               void* counts, void* incl, void* scratch,
                               void* out_words, void* out_pay, void* out_pos,
                               void* stream) {
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned nb = tp_blocks(n, TP_THREADS);
    Bufs b{(uint64_t*)key,     (uint64_t*)key_alt, (uint32_t*)idx,
           (uint32_t*)idx_alt, (uint32_t*)counts,  (uint32_t*)incl,
           (uint32_t*)scratch};
    const uint32_t* wd = (const uint32_t*)words;
    if (w <= 2) {
        k_make_key<<<nb, TP_THREADS, 0, st>>>(wd, n, w, b.key, b.idx);
        TP_LAUNCH_CHECK();
        const cudaError_t e = radix_passes(b, n, 32 * w, st);
        if (e != cudaSuccess) return (int)e;
    } else {
        k_iota<<<nb, TP_THREADS, 0, st>>>(b.idx, n);
        TP_LAUNCH_CHECK();
        for (int j = w - 1; j >= 0; --j) {
            k_word_key<<<nb, TP_THREADS, 0, st>>>(wd, b.idx, n, w, j, b.key);
            TP_LAUNCH_CHECK();
            const cudaError_t e = radix_passes(b, n, 32, st);
            if (e != cudaSuccess) return (int)e;
        }
    }
    k_gather<<<nb, TP_THREADS, 0, st>>>(
        wd, (const uint32_t*)pay, (const long long*)pos, b.idx, n, w,
        (uint32_t*)out_words, (uint32_t*)out_pay, (long long*)out_pos);
    return (int)cudaGetLastError();
}
