// Record routing: bucket one shard's records by the shard that owns their
// k-mer range, into the (D, cap) send slots of the all_to_all exchange.
//
// Replaces twopaco_tpu/parallel/sortshard.py:52 _route_records (the route of
// sharded_sort_step, reused by the dist engine's append,
// twopaco_tpu/parallel/distpipe.py:173).
//
// Owner of a real record (payload bit 17): without bounds (word0 * D) >> 32,
// a uniform split of word0 space; with bounds (D - 1 ascending u32) the
// number of bounds strictly below word0, i.e. searchsorted(side='left'),
// compared unsigned. Records that are not real go to no shard. Owner d's
// records fill its slots [d][0, cap) in record order (stable); records past
// cap are dropped and added to *overflow (int64 on the device, summed over
// calls); slots past a count hold all-ones words, payload 0, position 0.
//
// Bound: bytes moved, about 3 passes over the records plus the send
// buffers. Design: partition.cu's stable counting pass with shards in place
// of rounds: owners to a scratch array, per-tile owner counts (shared-memory
// atomics) scanned owner-major by the shared scan (scan.cu), and a scatter
// that ranks equal owners inside a warp with match masks and across warps
// with per-warp counts in shared memory, so each owner's slots keep the
// record order exactly (the bucketing helpers of common.cuh).
#include <algorithm>

#include "common.cuh"

namespace {

__global__ void k_route_owner(const uint32_t* __restrict__ words,
                              const uint32_t* __restrict__ pay, size_t n,
                              int w, int D, const uint32_t* __restrict__ bounds,
                              uint32_t* __restrict__ owner) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t o = (uint32_t)D;
    if (pay[i] & TP_REAL) {
        const uint32_t w0 = words[i * w];
        if (bounds == nullptr) {
            o = (uint32_t)(((uint64_t)w0 * (uint64_t)D) >> 32);
        } else {
            int lo = 0, hi = D - 1;
            while (lo < hi) {  // first bound >= w0
                const int mid = (lo + hi) >> 1;
                if (bounds[mid] < w0)
                    lo = mid + 1;
                else
                    hi = mid;
            }
            o = (uint32_t)lo;
        }
    }
    owner[i] = o;
}

// counts[d * nt + tile] = records of the tile owned by shard d
__global__ void k_route_hist(const uint32_t* __restrict__ owner, size_t n,
                             int D, uint32_t* __restrict__ counts, size_t nt) {
    tp_tile_owner_counts(n, D, counts, nt, [&](size_t i) { return owner[i]; });
}

// Stable scatter into the send slots (common.cuh tp_stable_scatter)
__global__ void k_route_scatter(const uint32_t* __restrict__ owner,
                                const uint32_t* __restrict__ words,
                                const uint32_t* __restrict__ pay,
                                const long long* __restrict__ pos, size_t n,
                                int w, int D, int cap,
                                const uint32_t* __restrict__ counts,
                                const uint32_t* __restrict__ incl, size_t nt,
                                uint32_t* __restrict__ send_w,
                                uint32_t* __restrict__ send_pay,
                                long long* __restrict__ send_pos) {
    tp_stable_scatter(
        n, D, counts, incl, nt, [&](size_t i) { return owner[i]; },
        [&](size_t i, uint32_t d, uint32_t dst) {
            if (dst >= (uint32_t)cap) return;
            const size_t o = (size_t)d * cap + dst;
            for (int m = 0; m < w; ++m) send_w[o * w + m] = words[i * w + m];
            send_pay[o] = pay[i];
            send_pos[o] = pos[i];
        });
}

// Sentinels in every slot past an owner's count, and the records dropped
// past cap added to *overflow
__global__ void k_route_finish(const uint32_t* __restrict__ counts,
                               const uint32_t* __restrict__ incl, size_t nt,
                               int D, int cap, int w,
                               uint32_t* __restrict__ send_w,
                               uint32_t* __restrict__ send_pay,
                               long long* __restrict__ send_pos,
                               unsigned long long* __restrict__ overflow) {
    tp_route_finish(counts, incl, nt, D, cap, overflow, [&](size_t t) {
        for (int m = 0; m < w; ++m) send_w[t * w + m] = 0xffffffffu;
        send_pay[t] = 0u;
        send_pos[t] = 0;
    });
}

}  // namespace

// Words of the per-tile owner count table (and of its scan) for n records
// routed to D shards.
extern "C" size_t tp_route_count_words(size_t n, int D) {
    return (size_t)D * std::max<size_t>((n + TP_ROUTE_TILE - 1) / TP_ROUTE_TILE, 1);
}

extern "C" int tp_route_max_shards() { return TP_ROUTE_MAX; }

// bounds: D - 1 u32, or null for the uniform split. Scratch (sized by the
// caller): owner (n u32), counts and incl (tp_route_count_words u32), the
// scan scratch (tp_scan_scratch_words of that). Outputs: send words (D,
// cap, w), payload and positions (D, cap); overflow (one int64, added to).
extern "C" int tp_route_records(const void* words, const void* pay,
                                const void* pos, size_t n, int w, int D,
                                const void* bounds, int cap, void* owner,
                                void* counts, void* incl, void* scratch,
                                void* send_w, void* send_pay, void* send_pos,
                                void* overflow, void* stream) {
    if (D < 1 || D > TP_ROUTE_MAX || cap < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    // an empty batch still owns tile 0 (all zero counts): every slot sentinel
    const size_t nt = std::max<size_t>((n + TP_ROUTE_TILE - 1) / TP_ROUTE_TILE, 1);
    uint32_t* own = (uint32_t*)owner;
    uint32_t* cnt = (uint32_t*)counts;
    uint32_t* inc = (uint32_t*)incl;
    uint32_t* sw = (uint32_t*)send_w;
    uint32_t* sp = (uint32_t*)send_pay;
    long long* so = (long long*)send_pos;
    if (n > 0) {
        k_route_owner<<<tp_blocks(n, TP_THREADS), TP_THREADS, 0, st>>>(
            (const uint32_t*)words, (const uint32_t*)pay, n, w, D,
            (const uint32_t*)bounds, own);
        TP_LAUNCH_CHECK();
    }
    k_route_hist<<<(unsigned)nt, TP_THREADS, D * sizeof(uint32_t), st>>>(
        own, n, D, cnt, nt);
    TP_LAUNCH_CHECK();
    cudaError_t e = tp_scan_inclusive_u32(cnt, inc, (size_t)D * nt,
                                          (uint32_t*)scratch, st);
    if (e != cudaSuccess) return (int)e;
    if (n > 0) {
        const size_t smem = (size_t)(1 + TP_WARPS) * D * sizeof(uint32_t);
        e = cudaFuncSetAttribute(k_route_scatter,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
        k_route_scatter<<<(unsigned)nt, TP_THREADS, smem, st>>>(
            own, (const uint32_t*)words, (const uint32_t*)pay,
            (const long long*)pos, n, w, D, cap, cnt, inc, nt, sw, sp, so);
        TP_LAUNCH_CHECK();
    }
    const size_t slots = std::max((size_t)D * cap, (size_t)D);
    k_route_finish<<<tp_blocks(slots, TP_THREADS), TP_THREADS, 0, st>>>(
        cnt, inc, nt, D, cap, w, sw, sp, so, (unsigned long long*)overflow);
    return (int)cudaGetLastError();
}
