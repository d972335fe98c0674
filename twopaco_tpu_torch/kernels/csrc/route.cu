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
// Bound: bytes moved, the records read once and the send slots written
// once. A call of the dist engines' append holds one shard's batch (131,072
// records at the slice), so launches and latency set its time, not bytes.
// Design: common.cuh's one-sweep owner bucketing, two launches a call. A
// block takes the next tile of ROUTE_TILE records (256 tiles at the slice,
// so the call fills the card) from an atomic counter, computes each
// record's owner in registers (the bounds held in shared memory), ranks the
// owners stably in the tile, takes each owner's prefix over the earlier
// tiles by a decoupled look-back, stages the tile's record indices in
// shared memory owner-major and stores each owner's run coalesced
// (consecutive threads, consecutive words of the send rows; the records are
// re-read through the staged indices from the L1 lines the rank stage
// brought in). The tail kernel writes the sentinels past each owner's count,
// adds the overflow and resets the tile counter for the next call. The
// look-back's status words carry a per-call epoch (the wrapper's), so the
// scratch lives across calls with no memset between them.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int ROUTE_ITEMS = 2;                        // records a thread
constexpr int ROUTE_TILE = TP_THREADS * ROUTE_ITEMS;  // records a tile
constexpr int ROUTE_WI = ROUTE_TILE / TP_WARPS;       // records a warp ranks
constexpr int TAIL_CHUNK = 4096;                      // send slots a tail block
constexpr uint32_t NO_SLOT = 0xffffffffu;

struct RouteArgs {
    const uint32_t* words;
    const uint32_t* pay;
    const long long* pos;
    size_t n;
    int w, D;
    uint32_t cap;
    const uint32_t* bounds;  // null: the uniform split
    uint32_t* send_w;
    uint32_t* send_pay;
    long long* send_pos;
    uint64_t* status;  // tiles x D
    uint32_t* tile_ctr;
    uint32_t epoch;
};

// Dynamic shared bytes of a block: per record its send slot (u32), rank,
// owner and staged index (u16); per owner its count, run offset (D + 1) and
// prefix (u32), the bounds, and the warps' u16 owner counters
size_t route_smem(int D) {
    return (size_t)ROUTE_TILE * (4 + 3 * 2) + (size_t)(3 * D + 1 + std::max(D - 1, 1)) * 4 +
           (size_t)TP_WARPS * D * 2;
}

size_t route_tiles(size_t n) {
    return std::max<size_t>((n + ROUTE_TILE - 1) / ROUTE_TILE, 1);
}

// Scratch: the tile counter (8 bytes), then the status words (tiles x D)
size_t route_scratch(size_t n, int D) { return 8 + route_tiles(n) * (size_t)D * 8; }

__global__ void __launch_bounds__(TP_THREADS) k_route(RouteArgs a) {
    extern __shared__ __align__(16) unsigned char s_mem[];
    const int D = a.D;
    uint32_t* s_slot = (uint32_t*)s_mem;         // [ROUTE_TILE]
    uint32_t* s_tot = s_slot + ROUTE_TILE;       // [D]
    uint32_t* s_tex = s_tot + D;                 // [D + 1]
    uint32_t* s_dst = s_tex + D + 1;             // [D]
    uint32_t* s_bnd = s_dst + D;                 // [max(D - 1, 1)]
    uint16_t* s_rank = (uint16_t*)(s_bnd + max(D - 1, 1));  // [ROUTE_TILE]
    uint16_t* s_own = s_rank + ROUTE_TILE;       // [ROUTE_TILE]
    uint16_t* s_perm = s_own + ROUTE_TILE;       // [ROUTE_TILE] owner-major
    uint16_t* s_wc = s_perm + ROUTE_TILE;        // [TP_WARPS][D]
    __shared__ uint32_t s_scan[TP_WARPS];
    __shared__ uint32_t s_tile;
    const int tid = threadIdx.x;
    if (tid == 0) s_tile = atomicAdd(a.tile_ctr, 1u);
    for (int i = tid; i < TP_WARPS * D; i += TP_THREADS) s_wc[i] = 0;
    if (a.bounds != nullptr)
        for (int i = tid; i < D - 1; i += TP_THREADS) s_bnd[i] = a.bounds[i];
    __syncthreads();
    const size_t tile = s_tile;
    const size_t t0 = tile * ROUTE_TILE;
    const size_t left = a.n > t0 ? a.n - t0 : 0;
    const int tn = left < (size_t)ROUTE_TILE ? (int)left : ROUTE_TILE;  // records
    const bool uniform = a.bounds == nullptr;
    const int w = a.w;

    // rank: each record's owner in registers (kept in s_own for the stage)
    tp_warp_rank(D, ROUTE_WI, [&](int it) {
        uint32_t o = (uint32_t)D;
        if (it < tn) {
            const size_t i = t0 + it;
            if (a.pay[i] & TP_REAL) {
                const uint32_t w0 = a.words[i * w];
                if (uniform) {
                    o = (uint32_t)(((uint64_t)w0 * (uint64_t)D) >> 32);
                } else {
                    int lo = 0, hi = D - 1;  // the first bound >= w0
                    while (lo < hi) {
                        const int mid = (lo + hi) >> 1;
                        if (s_bnd[mid] < w0) lo = mid + 1;
                        else hi = mid;
                    }
                    o = (uint32_t)lo;
                }
            }
        }
        s_own[it] = (uint16_t)o;
        return o;
    }, s_rank, s_wc);
    __syncthreads();
    tp_tile_offsets(D, tile, a.epoch, s_wc, s_tot, s_tex, s_scan, a.status);

    // stage each owned record's index in the tile, owner-major
    const int warp = tid >> 5;
    for (int sl = 0; sl < ROUTE_WI; sl += 32) {
        const int it = warp * ROUTE_WI + sl + (tid & 31);
        const uint32_t o = s_own[it];
        if (o < (uint32_t)D) s_perm[s_tex[o] + s_wc[warp * D + o] + s_rank[it]] = (uint16_t)it;
    }
    tp_owner_lookback(D, tile, a.epoch, s_tot, s_dst, a.status);
    __syncthreads();

    // each staged record's send slot (NO_SLOT past cap)
    const uint32_t staged = s_tex[D];
    for (uint32_t t = tid; t < staged; t += TP_THREADS) {
        const int o = tp_run_owner(s_tex, D, t);
        const uint32_t g = s_dst[o] + (t - s_tex[o]);
        s_slot[t] = g < a.cap ? (uint32_t)o * a.cap + g : NO_SLOT;
    }
    __syncthreads();
    // consecutive threads, consecutive words of each run
    for (uint32_t x = tid; x < staged * (uint32_t)w; x += TP_THREADS) {
        const uint32_t t = x / (uint32_t)w;
        const uint32_t m = x - t * (uint32_t)w;
        const uint32_t s = s_slot[t];
        if (s != NO_SLOT) a.send_w[(size_t)s * w + m] = a.words[(t0 + s_perm[t]) * w + m];
    }
    for (uint32_t t = tid; t < staged; t += TP_THREADS) {
        const uint32_t s = s_slot[t];
        if (s == NO_SLOT) continue;
        const size_t i = t0 + s_perm[t];
        a.send_pay[s] = a.pay[i];
        a.send_pos[s] = a.pos[i];
    }
}

// Sentinels past each owner's count, the records past cap added to
// *overflow; the tile counter back to 0 for the next call
__global__ void k_route_tail(const uint64_t* __restrict__ last, size_t cap, int w,
                             uint32_t* __restrict__ send_w,
                             uint32_t* __restrict__ send_pay,
                             long long* __restrict__ send_pos,
                             unsigned long long* __restrict__ overflow,
                             uint32_t* __restrict__ tile_ctr) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *tile_ctr = 0;
    tp_owner_tail(last, cap, TAIL_CHUNK, overflow, [&](size_t j) {
        for (int m = 0; m < w; ++m) send_w[j * w + m] = 0xffffffffu;
        send_pay[j] = 0u;
        send_pos[j] = 0;
    });
}

}  // namespace

extern "C" int tp_route_max_shards() { return TP_ROUTE_MAX; }

// Records a look-back tile: the scratch of n records to D shards is 8 +
// max(ceil(n / tile), 1) * D * 8 bytes
extern "C" int tp_route_tile() { return ROUTE_TILE; }

// bounds: D - 1 u32, or null for the uniform split. scratch: scratch_bytes
// >= 8 + tiles * D * 8 (tp_route_tile), zeroed before its first call and
// kept across calls, each call with another epoch (< 2^30) than the one
// before; the calls on one scratch run in stream order. Outputs: send words
// (D, cap, w), payload and positions (D, cap) (every slot written); overflow
// (one int64, added to).
extern "C" int tp_route_records(const void* words, const void* pay, const void* pos,
                                size_t n, int w, int D, const void* bounds, int cap,
                                void* scratch, size_t scratch_bytes, uint32_t epoch,
                                void* send_w, void* send_pay, void* send_pos,
                                void* overflow, void* stream) {
    if (D < 1 || D > TP_ROUTE_MAX || cap < 1 || w < 1 || epoch > TP_EPOCH_MASK ||
        scratch == nullptr || scratch_bytes < route_scratch(n, D) ||
        (size_t)D * (size_t)cap >= NO_SLOT)
        return (int)cudaErrorInvalidValue;
    static std::atomic<uint64_t> ready{0};
    cudaError_t e = tp_once_per_device(ready, [] {
        return cudaFuncSetAttribute(k_route, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)route_smem(TP_ROUTE_MAX));
    });
    if (e != cudaSuccess) return (int)e;
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t tiles = route_tiles(n);
    RouteArgs a{};
    a.words = (const uint32_t*)words;
    a.pay = (const uint32_t*)pay;
    a.pos = (const long long*)pos;
    a.n = n, a.w = w, a.D = D, a.cap = (uint32_t)cap;
    a.bounds = (const uint32_t*)bounds;
    a.send_w = (uint32_t*)send_w;
    a.send_pay = (uint32_t*)send_pay;
    a.send_pos = (long long*)send_pos;
    a.tile_ctr = (uint32_t*)scratch;
    a.status = (uint64_t*)((char*)scratch + 8);
    a.epoch = epoch;
    // an empty call still runs tile 0 (zero counts): every slot a sentinel
    k_route<<<(unsigned)tiles, TP_THREADS, route_smem(D), st>>>(a);
    TP_LAUNCH_CHECK();
    k_route_tail<<<dim3(tp_blocks((size_t)cap, TAIL_CHUNK), (unsigned)D), TP_THREADS, 0, st>>>(
        a.status + (tiles - 1) * D, (size_t)cap, w, a.send_w, a.send_pay, a.send_pos,
        (unsigned long long*)overflow, a.tile_ctr);
    return (int)cudaGetLastError();
}
