// Vertex-hash histogram: 2^16 bins of the hash of every position that has
// a record, over the leading rows of a window batch.
//
// Replaces twopaco_tpu/passes/kernels.py:582 histogram_vertex_hashes (the
// step of twopaco_tpu/passes/sortpipe.py:282 _histogram_scan for one
// batch): bin = hv >> 16 of each position inside its row's valid count
// whose window holds no N (common.cuh tp_vertex_hash, tp_position_ok).
// The caller passes the leading max(B // stride, 1) rows for a strided
// sample. Counts are added to hist, so one buffer sums a run's batches.
//
// Bound: the hash (k rotates a position) and the bin updates. Design: the
// bins are privatised per block in shared memory as u16 pairs (2^16 u32
// bins would be 256 KB, more than a block may have; 2^16 u16 bins are
// 128 KB), safe because a block counts at most HIST_CHUNK < 2^16
// positions; then each block adds its nonzero bins to global memory with
// atomics. Only one such block fits an SM, so a block has 1024 threads
// (32 warps to hide the latency of the hash's table reads) and the chunk
// is small enough to spread a strided batch over many SMs (16 blocks at
// stride 4, 64 at stride 1 for 256 rows of 2048) while the 2^15-word
// zeroing and flush stay a minor share of a block's work.
//
// The second entry, tp_word0_histogram, replaces
// twopaco_tpu/parallel/distpipe.py:102 word0_histogram: the same positions,
// binned by the top 16 bits of their canonical k-mer's first word, which
// is min(forward word0, reverse-complement word0) (the two strands' words
// differ first at word 0 unless their word 0 is equal, when either is the
// canonical one). It measures the mass the dist engine's routing bounds
// split evenly.
#include "common.cuh"

namespace {

constexpr int HIST_BINS = 1 << 16;
constexpr int HIST_THREADS = 1024;
constexpr int HIST_CHUNK = 8192;  // positions a block counts (< 2^16)
constexpr size_t HIST_SMEM = HIST_BINS / 2 * sizeof(uint32_t);

template <bool WORD0>
__global__ void __launch_bounds__(HIST_THREADS)
    k_histogram(const uint32_t* __restrict__ packed,
                const uint32_t* __restrict__ nmask,
                const int32_t* __restrict__ valid, int rows, int P, int k,
                int RW, int NW, TpTab tab, uint32_t* __restrict__ hist) {
    extern __shared__ uint32_t bins[];  // bin j in half j & 1 of word j / 2
    for (int j = threadIdx.x; j < HIST_BINS / 2; j += HIST_THREADS) bins[j] = 0;
    __syncthreads();
    const long long n = (long long)rows * P;
    const long long base = (long long)blockIdx.x * HIST_CHUNK;
    for (int j = threadIdx.x; j < HIST_CHUNK; j += HIST_THREADS) {
        const long long t = base + j;
        if (t >= n) break;
        const int b = (int)(t / P);
        const int i = (int)(t - (long long)b * P);
        const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
        if (!tp_position_ok(row, i, k, valid[b])) continue;
        const uint32_t bin =
            WORD0 ? min(row.fw_word(i + 1, k, 0), row.rc_word(i + 1, k, 0)) >> 16
                  : tp_vertex_hash(row, i, k, tab) >> 16;
        atomicAdd(&bins[bin >> 1], 1u << (16 * (bin & 1)));
    }
    __syncthreads();
    for (int j = threadIdx.x; j < HIST_BINS / 2; j += HIST_THREADS) {
        const uint32_t v = bins[j];
        if (v & 0xffffu) atomicAdd(&hist[2 * j], v & 0xffffu);
        if (v >> 16) atomicAdd(&hist[2 * j + 1], v >> 16);
    }
}

template <bool WORD0>
int launch_histogram(const void* packed, const void* nmask, const void* valid,
                     int rows, int P, int k, int RW, int NW, TpTab tab,
                     void* hist, void* stream) {
    const long long n = (long long)rows * P;
    if (n == 0) return 0;
    cudaError_t e = cudaFuncSetAttribute(
        k_histogram<WORD0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)HIST_SMEM);
    if (e != cudaSuccess) return (int)e;
    k_histogram<WORD0><<<tp_blocks((size_t)n, HIST_CHUNK), HIST_THREADS,
                         HIST_SMEM, (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask,
        (const int32_t*)valid, rows, P, k, RW, NW, tab, (uint32_t*)hist);
    return (int)cudaGetLastError();
}

}  // namespace

// hist: 2^16 u32 counts, added to (the caller zeroes it once a run).
extern "C" int tp_histogram(const void* packed, const void* nmask,
                            const void* valid, int rows, int P, int k, int RW,
                            int NW, uint32_t t0, uint32_t t1, uint32_t t2,
                            uint32_t t3, void* hist, void* stream) {
    return launch_histogram<false>(packed, nmask, valid, rows, P, k, RW, NW,
                                   TpTab{{t0, t1, t2, t3}}, hist, stream);
}

extern "C" int tp_word0_histogram(const void* packed, const void* nmask,
                                  const void* valid, int rows, int P, int k,
                                  int RW, int NW, void* hist, void* stream) {
    return launch_histogram<true>(packed, nmask, valid, rows, P, k, RW, NW,
                                  TpTab{{0, 0, 0, 0}}, hist, stream);
}
