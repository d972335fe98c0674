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
// record order exactly.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int ROUTE_ROUNDS = 16;
constexpr int ROUTE_TILE = TP_THREADS * ROUTE_ROUNDS;
constexpr int ROUTE_MAX = 4096;  // shards a call may route to

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
    extern __shared__ uint32_t h[];
    for (int d = threadIdx.x; d < D; d += TP_THREADS) h[d] = 0;
    __syncthreads();
    const size_t base = (size_t)blockIdx.x * ROUTE_TILE;
    for (int j = threadIdx.x; j < ROUTE_TILE; j += TP_THREADS) {
        const size_t i = base + j;
        if (i < n) {
            const uint32_t d = owner[i];
            if (d < (uint32_t)D) atomicAdd(&h[d], 1u);
        }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += TP_THREADS)
        counts[(size_t)d * nt + blockIdx.x] = h[d];
}

// Stable scatter into the send slots: the tile is walked in rounds of
// TP_THREADS consecutive records; a record's slot is its owner's running
// base for the tile, plus the counts of its owner in lower warps of the
// walk round, plus its rank among equal owners in its own warp.
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
    extern __shared__ uint32_t sm[];
    uint32_t* s_base = sm;      // [D]
    uint32_t* s_wc = sm + D;    // [TP_WARPS][D]
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int d = tid; d < D; d += TP_THREADS) {
        const size_t first = (size_t)d * nt;
        const size_t slot = first + blockIdx.x;
        // offset of this tile's first record among owner d's records
        s_base[d] = (incl[slot] - counts[slot]) - (incl[first] - counts[first]);
        for (int v = 0; v < TP_WARPS; ++v) s_wc[v * D + d] = 0;
    }
    __syncthreads();
    const size_t base = (size_t)blockIdx.x * ROUTE_TILE;
    for (int r = 0; r < ROUTE_ROUNDS; ++r) {
        const size_t i = base + (size_t)r * TP_THREADS + tid;
        const uint32_t oi = i < n ? owner[i] : (uint32_t)D;
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
            if (dst < (uint32_t)cap) {
                const size_t o = (size_t)d * cap + dst;
                for (int m = 0; m < w; ++m) send_w[o * w + m] = words[i * w + m];
                send_pay[o] = pay[i];
                send_pos[o] = pos[i];
            }
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

__device__ __forceinline__ uint32_t owner_total(const uint32_t* counts,
                                                const uint32_t* incl,
                                                size_t nt, int d) {
    const size_t first = (size_t)d * nt;
    return incl[first + nt - 1] - (incl[first] - counts[first]);
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
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < (size_t)D) {
        const uint32_t tot = owner_total(counts, incl, nt, (int)t);
        if (tot > (uint32_t)cap)
            atomicAdd(overflow, (unsigned long long)(tot - (uint32_t)cap));
    }
    if (t >= (size_t)D * cap) return;
    const int d = (int)(t / cap);
    if (t - (size_t)d * cap >= owner_total(counts, incl, nt, d)) {
        for (int m = 0; m < w; ++m) send_w[t * w + m] = 0xffffffffu;
        send_pay[t] = 0u;
        send_pos[t] = 0;
    }
}

}  // namespace

// Words of the per-tile owner count table (and of its scan) for n records
// routed to D shards.
extern "C" size_t tp_route_count_words(size_t n, int D) {
    return (size_t)D * std::max<size_t>((n + ROUTE_TILE - 1) / ROUTE_TILE, 1);
}

extern "C" int tp_route_max_shards() { return ROUTE_MAX; }

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
    if (D < 1 || D > ROUTE_MAX || cap < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    // an empty batch still owns tile 0 (all zero counts): every slot sentinel
    const size_t nt = std::max<size_t>((n + ROUTE_TILE - 1) / ROUTE_TILE, 1);
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
