// Position histograms in 2^16 bins over a list of resident window batches,
// one launch a call.
//
// tp_histogram_batches with word0 = 0 replaces
// twopaco_tpu/passes/kernels.py:582 histogram_vertex_hashes summed over a
// run's batches (twopaco_tpu/passes/sortpipe.py:282 _histogram_scan): bin =
// hv >> 16 of each position inside its row's valid count whose window holds
// no N (its strand hashes' sum, common.cuh tp_position_ok), over each batch's
// leading rows (the caller passes max(B // stride, 1) of them for a strided
// sample). With word0 = 1 it replaces twopaco_tpu/parallel/distpipe.py:102
// word0_histogram summed over a shard's batches: the same positions, binned
// by the top 16 bits of their canonical k-mer's first word, which is
// min(forward word0, reverse-complement word0) (the two strands' words
// differ first at word 0 unless their word 0 is equal, when either is the
// canonical one): the mass the dist engine's routing bounds split evenly.
// Counts are added to hist, so one buffer sums calls.
//
// Bound: the bin updates and, per position, a few chars of the upload form.
// Design: the positions of all the batches, concatenated, are split into
// one contiguous span a block; a thread takes runs of RUN consecutive
// positions and rolls its state along a run (word0: shift in one char a
// strand; vertex hash: common.cuh tp_roll_hashes, tables in shared memory)
// from a from-scratch window at the run's first position and at each row
// start. Bins are privatised per block in shared memory as u16 pairs (2^16
// u32 bins would be 256 KB, more than a block may have; 2^16 u16 bins are
// 128 KB, so one block fits an SM and it has 1024 threads to hide the
// latency of the char reads); a block adds its nonzero bins to global
// memory with atomics and zeroes them again after every SEG < 2^16 of its
// positions, so no bin passes 65,535 (an all-A genome puts every position
// in one bin). The block count comes from the size of the call: one block
// per MIN_SPAN positions, at most one an SM. A one-batch call of a shard's
// 131,072 positions so runs 8 blocks, not a card's worth of 128 KB zeroing
// and flushing (that fixed cost made a quarter batch cost as much as a
// whole one before), and a shard's 123 resident batches run one persistent
// block an SM, each zeroing and flushing once a SEG.
#include "common.cuh"

namespace {

constexpr int HIST_BINS = 1 << 16;
constexpr int HIST_THREADS = 1024;
constexpr int RUN = 4;                              // positions a thread rolls over
constexpr int STEP = HIST_THREADS * RUN;            // positions a block round
constexpr long long SEG = 15LL * STEP;              // positions between flushes (< 2^16)
constexpr long long MIN_SPAN = 4LL * STEP;          // positions a block, at least
constexpr size_t HIST_SMEM = HIST_BINS / 2 * sizeof(uint32_t);

// One batch of a call (8 words, the wrapper's int64 table row): its upload
// form, its first position in the call's concatenation, and rows of P
// positions (RW, NW words a row)
struct HistBatch {
    const uint32_t* packed;
    const uint32_t* nmask;
    const int32_t* valid;
    long long start, rows, RW, NW, pad;
};

struct HistArgs {
    const HistBatch* table;  // nb batches on the device
    int nb, P, k;
    long long n;  // positions of the call
    uint32_t tab[4];
    uint32_t* hist;
};

// A thread's batch, its fields in registers
struct Cur {
    const uint32_t* packed;
    const uint32_t* nmask;
    const int32_t* valid;
    long long start, end;
    int rows, RW, NW;
};

__device__ __forceinline__ Cur hist_batch(const HistArgs& a, int b) {
    const HistBatch& t = a.table[b];
    Cur c;
    c.packed = t.packed;
    c.nmask = t.nmask;
    c.valid = t.valid;
    c.start = t.start;
    c.rows = (int)t.rows;
    c.RW = (int)t.RW;
    c.NW = (int)t.NW;
    c.end = c.start + (long long)c.rows * a.P;
    return c;
}

__device__ __forceinline__ void flush_bins(uint32_t* bins, uint32_t* __restrict__ hist) {
    for (int j = threadIdx.x; j < HIST_BINS / 2; j += HIST_THREADS) {
        const uint32_t v = bins[j];
        if (v & 0xffffu) atomicAdd(&hist[2 * j], v & 0xffffu);
        if (v >> 16) atomicAdd(&hist[2 * j + 1], v >> 16);
        bins[j] = 0;
    }
}

template <bool WORD0>
__global__ void __launch_bounds__(HIST_THREADS) k_histogram(HistArgs a) {
    extern __shared__ uint32_t bins[];  // bin j in half j & 1 of word j / 2
    __shared__ uint32_t s_T[4], s_Tk[4], s_Tk1[4];
    const int tid = threadIdx.x;
    const int P = a.P, k = a.k;
    if (tid == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            s_T[u] = a.tab[u];
            s_Tk[u] = tp_rotl32(a.tab[u], (uint32_t)k);
            s_Tk1[u] = tp_rotl32(a.tab[u], (uint32_t)(k - 1));
        }
    }
    for (int j = tid; j < HIST_BINS / 2; j += HIST_THREADS) bins[j] = 0;
    __syncthreads();
    // this block's span, a multiple of RUN
    const long long per = ((a.n + gridDim.x - 1) / gridDim.x + RUN - 1) / RUN * RUN;
    const long long beg = (long long)blockIdx.x * per;
    const long long end = beg + per < a.n ? beg + per : a.n;
    // word0: L = min(k, 16) chars a word; the rc word keeps its top 2L bits
    const int L = k < 16 ? k : 16;
    const uint32_t keep = L == 16 ? 0xffffffffu : ~((1u << (32 - 2 * L)) - 1u);
    int b = 0;  // the batch of this thread's run (runs only move forward)
    Cur cur = hist_batch(a, 0);
    for (long long seg = beg; seg < end; seg += SEG) {
        const long long seg_end = seg + SEG < end ? seg + SEG : end;
        for (long long r0 = seg + (long long)tid * RUN; r0 < seg_end; r0 += STEP) {
            while (r0 >= cur.end) cur = hist_batch(a, ++b);
            const uint32_t local = (uint32_t)(r0 - cur.start);
            int r = (int)(local / (uint32_t)P);
            int i = (int)(local - (uint32_t)r * (uint32_t)P);
            uint32_t x0 = 0, x1 = 0;  // word0: fw, rc; vertex hash: hf, hr
            for (int s = 0; s < RUN && r0 + s < seg_end; ++s) {
                if (s > 0 && ++i == P) {  // the next row, or the next batch
                    i = 0;
                    if (++r == cur.rows) {
                        do cur = hist_batch(a, ++b); while (cur.rows == 0);
                        r = 0;
                    }
                }
                const TpRow row{cur.packed + (size_t)r * cur.RW, cur.nmask + (size_t)r * cur.NW};
                const bool fresh = s == 0 || i == 0;
                if (WORD0) {
                    if (fresh) {
                        x0 = row.fw_word(i + 1, k, 0);
                        x1 = row.rc_word(i + 1, k, 0);
                    } else {  // chars i + 1 .. i + L, and their reverse complement
                        x0 = (x0 << 2) | (row.code(i + L) << (32 - 2 * L));
                        x1 = ((x1 >> 2) | ((3u - row.code(i + k)) << 30)) & keep;
                    }
                } else {
                    uint32_t hf[4] = {x0, 0, 0, 0}, hr[4] = {x1, 0, 0, 0};
                    if (fresh) tp_window_hashes(row, i + 1, k, 1, s_T, hf, hr);
                    else tp_roll_hashes(row, i, k, 1, s_T, s_Tk, s_Tk1, hf, hr);
                    x0 = hf[0], x1 = hr[0];
                }
                if (!tp_position_ok(row, i, k, cur.valid[r])) continue;
                const uint32_t bin = (WORD0 ? min(x0, x1) : x0 + x1) >> 16;
                atomicAdd(&bins[bin >> 1], 1u << (16 * (bin & 1)));
            }
        }
        __syncthreads();
        flush_bins(bins, a.hist);
        __syncthreads();
    }
}

}  // namespace

// The histogram of nb batches in one launch. table: nb rows of 8 int64 on
// the device, (packed, nmask, valid pointers, start, rows, RW, NW, 0), the
// starts the running sum of rows * P and n the total (rows * P < 2^32 a
// batch); word0: 1 the word0 bins, 0 the vertex-hash bins of TABLE_1 (t0
// .. t3); hist: 2^16 u32 counts, added to (the caller zeroes it once a run).
extern "C" int tp_histogram_batches(const void* table, int nb, long long n, int P, int k,
                                    int word0, uint32_t t0, uint32_t t1, uint32_t t2,
                                    uint32_t t3, void* hist, void* stream) {
    if (n == 0) return 0;
    if (n < 0 || nb < 1 || table == nullptr || P < 1 || k < 1)
        return (int)cudaErrorInvalidValue;
    static std::atomic<uint64_t> ready{0};
    cudaError_t e = tp_once_per_device(ready, [] {
        const cudaError_t e1 = cudaFuncSetAttribute(
            k_histogram<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)HIST_SMEM);
        if (e1 != cudaSuccess) return e1;
        return cudaFuncSetAttribute(k_histogram<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)HIST_SMEM);
    });
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    HistArgs a{};
    a.table = (const HistBatch*)table;
    a.nb = nb, a.P = P, a.k = k, a.n = n;
    a.tab[0] = t0, a.tab[1] = t1, a.tab[2] = t2, a.tab[3] = t3;
    a.hist = (uint32_t*)hist;
    const long long want = (n + MIN_SPAN - 1) / MIN_SPAN;
    const unsigned blocks = (unsigned)(want < sms ? want : sms);
    const cudaStream_t st = (cudaStream_t)stream;
    if (word0)
        k_histogram<true><<<blocks, HIST_THREADS, HIST_SMEM, st>>>(a);
    else
        k_histogram<false><<<blocks, HIST_THREADS, HIST_SMEM, st>>>(a);
    return (int)cudaGetLastError();
}
