// Round partition: build one window batch's records and split them by
// round into fixed-cap blocks.
//
// Replaces twopaco_tpu/passes/sortpipe.py:166 build_and_partition (the
// step of :306 _partition_scan for one batch).
//
// The round of a record is the first entry of `highs` (non-decreasing
// inclusive interval upper bounds) at or above its vertex hash, which is
// searchsorted(highs, hv, side="left"); positions without a record, or
// whose hash lies outside [low, high], belong to no round. Round p's
// records go to block p of the batch in in-batch order (stable), each slot
// holding the w canonical words, the payload with the real bit, and the
// u32 in-batch offset; slots past the round's count are sentinels (words
// all-ones, payload 0, offset 0). counts[p] is the round's true count:
// above part_cap the block overflowed (records past the cap are dropped)
// and the caller re-splits.
//
// Bound: the record computation (as in records.cu) and about 40 bytes a
// position of scratch traffic. Design: the TPU version sorts (part, iota)
// because its scatters are slow; here it is the radix sort's stable
// counting pass done once: the records go to a batch scratch (one thread
// per position, common.cuh tp_build_record), per-tile round counts
// (shared-memory atomics) are scanned round-major by the shared scan, and
// a scatter ranks equal rounds inside a warp with match masks and across
// warps with per-warp counts in shared memory, so the order is exactly
// the in-batch order.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int PART_ROUNDS = 16;
constexpr int PART_TILE = TP_THREADS * PART_ROUNDS;
constexpr int PART_MAX = 4096;  // rounds a call may split into

__global__ void k_part_records(const uint32_t* __restrict__ packed,
                               const uint32_t* __restrict__ nmask,
                               const int32_t* __restrict__ valid, int B,
                               int P, int k, int w, int RW, int NW,
                               uint32_t low, uint32_t high, TpTab tab,
                               const uint32_t* __restrict__ highs,
                               int n_parts, uint32_t* __restrict__ tmp_words,
                               uint32_t* __restrict__ tmp_pay,
                               uint32_t* __restrict__ part) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * P) return;
    const int b = (int)(t / P);
    const int i = (int)(t - (long long)b * P);
    const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
    uint32_t hv;
    const uint32_t pay = tp_build_record(row, i, k, w, valid[b], low, high,
                                         tab, tmp_words + (size_t)t * w, &hv);
    int p = n_parts;
    if (pay & TP_REAL) {
        int lo = 0;
        p = n_parts;
        while (lo < p) {  // first highs entry >= hv
            const int mid = (lo + p) >> 1;
            if (highs[mid] < hv)
                lo = mid + 1;
            else
                p = mid;
        }
    }
    tmp_pay[t] = pay;
    part[t] = (uint32_t)p;
}

// counts[p * nt + tile] = records of the tile in round p
__global__ void k_part_hist(const uint32_t* __restrict__ part, size_t n,
                            int n_parts, uint32_t* __restrict__ counts,
                            size_t nt) {
    extern __shared__ uint32_t h[];
    for (int p = threadIdx.x; p < n_parts; p += TP_THREADS) h[p] = 0;
    __syncthreads();
    const size_t base = (size_t)blockIdx.x * PART_TILE;
    for (int j = threadIdx.x; j < PART_TILE; j += TP_THREADS) {
        const size_t i = base + j;
        if (i < n) {
            const uint32_t p = part[i];
            if (p < (uint32_t)n_parts) atomicAdd(&h[p], 1u);
        }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n_parts; p += TP_THREADS)
        counts[(size_t)p * nt + blockIdx.x] = h[p];
}

// Stable scatter into the blocks: the tile is walked in rounds of
// TP_THREADS consecutive positions; a record's slot is its round's running
// base for the tile, plus the counts of its round in lower warps of the
// walk round, plus its rank among equal rounds in its own warp.
__global__ void k_part_scatter(const uint32_t* __restrict__ part,
                               const uint32_t* __restrict__ tmp_words,
                               const uint32_t* __restrict__ tmp_pay,
                               size_t n, int w, int n_parts, int cap,
                               const uint32_t* __restrict__ counts,
                               const uint32_t* __restrict__ incl, size_t nt,
                               uint32_t* __restrict__ blk_w,
                               uint32_t* __restrict__ blk_pay,
                               uint32_t* __restrict__ blk_off) {
    extern __shared__ uint32_t sm[];
    uint32_t* s_base = sm;            // [n_parts]
    uint32_t* s_wc = sm + n_parts;    // [TP_WARPS][n_parts]
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int p = tid; p < n_parts; p += TP_THREADS) {
        const size_t first = (size_t)p * nt;
        const size_t slot = first + blockIdx.x;
        // offset of this tile's first record inside round p's block
        s_base[p] = (incl[slot] - counts[slot]) - (incl[first] - counts[first]);
        for (int v = 0; v < TP_WARPS; ++v) s_wc[v * n_parts + p] = 0;
    }
    __syncthreads();
    const size_t base = (size_t)blockIdx.x * PART_TILE;
    for (int r = 0; r < PART_ROUNDS; ++r) {
        const size_t i = base + (size_t)r * TP_THREADS + tid;
        const uint32_t pi = i < n ? part[i] : (uint32_t)n_parts;
        const bool live = pi < (uint32_t)n_parts;
        // dead lanes get distinct non-round values and never write
        const uint32_t d = live ? pi : (uint32_t)n_parts + lane;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const unsigned lower = peers & ((1u << lane) - 1u);
        if (live && lower == 0) s_wc[warp * n_parts + d] = __popc(peers);
        __syncthreads();
        if (live) {
            uint32_t dst = s_base[d] + __popc(lower);
            for (int v = 0; v < warp; ++v) dst += s_wc[v * n_parts + d];
            if (dst < (uint32_t)cap) {
                const size_t o = (size_t)d * cap + dst;
                for (int m = 0; m < w; ++m)
                    blk_w[o * w + m] = tmp_words[i * w + m];
                blk_pay[o] = tmp_pay[i];
                blk_off[o] = (uint32_t)i;
            }
        }
        __syncthreads();
        for (int p = tid; p < n_parts; p += TP_THREADS) {
            uint32_t tot = 0;
            for (int v = 0; v < TP_WARPS; ++v) {
                tot += s_wc[v * n_parts + p];
                s_wc[v * n_parts + p] = 0;
            }
            s_base[p] += tot;
        }
        __syncthreads();
    }
}

__device__ __forceinline__ uint32_t part_total(const uint32_t* counts,
                                               const uint32_t* incl,
                                               size_t nt, int p) {
    const size_t first = (size_t)p * nt;
    return incl[first + nt - 1] - (incl[first] - counts[first]);
}

// The rounds' true counts, and sentinels in every slot past a count
__global__ void k_part_finish(const uint32_t* __restrict__ counts,
                              const uint32_t* __restrict__ incl, size_t nt,
                              int n_parts, int cap, int w,
                              int32_t* __restrict__ counts_out,
                              uint32_t* __restrict__ blk_w,
                              uint32_t* __restrict__ blk_pay,
                              uint32_t* __restrict__ blk_off) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < (size_t)n_parts)
        counts_out[t] = (int32_t)part_total(counts, incl, nt, (int)t);
    if (t >= (size_t)n_parts * cap) return;
    const int p = (int)(t / cap);
    if (t - (size_t)p * cap >= part_total(counts, incl, nt, p)) {
        for (int m = 0; m < w; ++m) blk_w[t * w + m] = 0xffffffffu;
        blk_pay[t] = 0u;
        blk_off[t] = 0u;
    }
}

}  // namespace

// Words of the per-tile round count table (and of its scan) for a batch
// of n positions split into n_parts rounds.
extern "C" size_t tp_partition_count_words(size_t n, int n_parts) {
    return (size_t)n_parts * ((n + PART_TILE - 1) / PART_TILE);
}

extern "C" int tp_partition_max_parts() { return PART_MAX; }

// Scratch (sized by the caller): tmp_words (B*P*w u32), tmp_pay and part
// (B*P u32), counts and incl (tp_partition_count_words u32), the scan
// scratch (tp_scan_scratch_words of that). Outputs: blocks (n_parts, cap,
// w) words, (n_parts, cap) payload and offsets, (n_parts,) int32 counts.
extern "C" int tp_partition_records(
    const void* packed, const void* nmask, const void* valid, int B, int P,
    int k, int RW, int NW, uint32_t low, uint32_t high, uint32_t t0,
    uint32_t t1, uint32_t t2, uint32_t t3, const void* highs, int n_parts,
    int cap, void* tmp_words, void* tmp_pay, void* part, void* counts,
    void* incl, void* scratch, void* blk_w, void* blk_pay, void* blk_off,
    void* counts_out, void* stream) {
    const size_t n = (size_t)B * P;
    if (n == 0 || n_parts < 1 || n_parts > PART_MAX || cap < 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int w = (k + 15) / 16;
    const size_t nt = (n + PART_TILE - 1) / PART_TILE;
    uint32_t* bw = (uint32_t*)blk_w;
    uint32_t* bp = (uint32_t*)blk_pay;
    uint32_t* bo = (uint32_t*)blk_off;
    uint32_t* cnt = (uint32_t*)counts;
    uint32_t* inc = (uint32_t*)incl;
    const TpTab tab{{t0, t1, t2, t3}};
    k_part_records<<<tp_blocks(n, TP_THREADS), TP_THREADS, 0, st>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask,
        (const int32_t*)valid, B, P, k, w, RW, NW, low, high, tab,
        (const uint32_t*)highs, n_parts, (uint32_t*)tmp_words,
        (uint32_t*)tmp_pay, (uint32_t*)part);
    TP_LAUNCH_CHECK();
    k_part_hist<<<(unsigned)nt, TP_THREADS, n_parts * sizeof(uint32_t), st>>>(
        (const uint32_t*)part, n, n_parts, cnt, nt);
    TP_LAUNCH_CHECK();
    cudaError_t e = tp_scan_inclusive_u32(cnt, inc, (size_t)n_parts * nt,
                                          (uint32_t*)scratch, st);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = (size_t)(1 + TP_WARPS) * n_parts * sizeof(uint32_t);
    e = cudaFuncSetAttribute(k_part_scatter,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    k_part_scatter<<<(unsigned)nt, TP_THREADS, smem, st>>>(
        (const uint32_t*)part, (const uint32_t*)tmp_words,
        (const uint32_t*)tmp_pay, n, w, n_parts, cap, cnt, inc, nt, bw, bp,
        bo);
    TP_LAUNCH_CHECK();
    const size_t slots = std::max((size_t)n_parts * cap, (size_t)n_parts);
    k_part_finish<<<tp_blocks(slots, TP_THREADS), TP_THREADS, 0, st>>>(
        cnt, inc, nt, n_parts, cap, w, (int32_t*)counts_out, bw, bp, bo);
    return (int)cudaGetLastError();
}
