// Stream compaction: append one batch's in-round records to the round
// buffer at a running offset kept on the device, two launches a call.
//
// Replaces twopaco_tpu/passes/sortpipe.py:338 compact_batch_records and
// the append step of :624 _stream_round_scan (:648-668).
//
// The batch's n records (record build gated to the round's hash interval:
// the real ones are in the round, the rest are sentinels) are partitioned
// stably, real rows first, and all n rows are written at
// off_c = min(off, lim), lim = buf_slots - n; then
//     over |= off + cnt > lim,   off = off_c + cnt
// where cnt is the batch's real count. state = (off, over) as two int64
// on the device, so batches need no host sync between them; the host reads
// the flag once a round. The clamped write keeps every store inside the
// buffer when the round overflows (its results are then discarded).
//
// Bound: bytes moved, the batch's records read once and written once. A
// call of the dist append holds one shard's received block (hundreds of
// thousands of records at the slice, in L2 after the exchange), so
// latency sets its time. Design: no scan and no scratch of flags.
// k_compact_real takes tiles of CMP_TILE records from an atomic counter. A
// warp takes 128 consecutive rows of its tile, a lane every 32nd of them,
// and loads all of its rows into registers at once (loads issued before
// any store, since a store may alias a later load and loads between
// stores go one at a time); it ranks its real rows by ballots, and the
// tile publishes its count and takes its prefix over the earlier tiles by
// common.cuh's block-wide look-back, which reads 256 earlier tiles' status
// words at a time (one round trip for calls of up to 256 tiles), then stores the real
// rows from the registers at off_c + prefix + rank (the real rows of a
// warp's 32 consecutive rows land on consecutive buffer rows).
// k_compact_rest, a block a tile, loads the same rows with the tile's
// prefix and the call's
// real count cnt from the status words the sweep left (no second scan),
// ranks the tile's other rows by ballots and stores them at off_c + cnt +
// (i - real rows before i). Every tile of the sweep takes off_c from the
// state, which no block of the sweep writes; tile 0 keeps it in the
// scratch for the second launch, whose first block then updates the state
// and resets the tile counter. The status words carry a per-call epoch in
// a scratch kept across calls (kernels/build.py lookback_scratch), so
// nothing is cleared between calls.
#include "common.cuh"

namespace {

constexpr int CMP_ITEMS = 4;                      // records a thread
constexpr int CMP_TILE = TP_THREADS * CMP_ITEMS;  // records a tile
constexpr int CMP_WI = CMP_TILE / TP_WARPS;       // records a warp (32 CMP_ITEMS)
constexpr int W_MAX = 4;                          // widest row held in registers

struct CompactArgs {
    const uint32_t* words;
    const uint32_t* pay;
    const long long* pos;
    size_t n, tiles;
    int w;
    long long lim;
    long long* state;
    uint32_t* buf_w;
    uint32_t* buf_pay;
    long long* buf_pos;
    uint32_t* tile_ctr;
    long long* off_c;  // min(off, lim), for the second launch
    uint64_t* status;  // a word a tile
    uint32_t epoch;
};

// A lane's CMP_ITEMS rows of a tile: item j is row t0 + w0 + 32 j + lane
// (w0: the warp's first), so each load of the warp is coalesced. load()
// issues every load of the lane's rows at once, before any store (a store
// may alias a later load, so loads between stores go one at a time); W: the
// row's words (0: a.w, copied by store() word by word).
template <int W>
struct Rows {
    static constexpr int WR = W > 0 ? W : 1;
    uint32_t wv[CMP_ITEMS][WR], pv[CMP_ITEMS];
    long long qv[CMP_ITEMS];

    __device__ __forceinline__ uint32_t load(const CompactArgs& a, size_t r0, int tn, int lane) {
        uint32_t real = 0;  // bit j: item j is a row of the batch and real
#pragma unroll
        for (int j = 0; j < CMP_ITEMS; ++j) {
            const int it = 32 * j + lane;
            pv[j] = 0;
            if (it < tn) {
                const size_t i = r0 + it;
                pv[j] = a.pay[i];
                qv[j] = a.pos[i];
                if constexpr (W > 0) {
#pragma unroll
                    for (int m = 0; m < W; ++m) wv[j][m] = a.words[i * W + m];
                }
            }
        }
#pragma unroll
        for (int j = 0; j < CMP_ITEMS; ++j)
            if (pv[j] & TP_REAL) real |= 1u << j;
        return real;
    }
    // item j (a bit of `which`) of row r0 + 32 j + lane to buffer row dst0 +
    // rank[j]
    __device__ __forceinline__ void store(const CompactArgs& a, size_t r0, int lane,
                                          uint32_t which, const uint32_t* rank, size_t dst0) {
#pragma unroll
        for (int j = 0; j < CMP_ITEMS; ++j) {
            if (!((which >> j) & 1u)) continue;
            const size_t d = dst0 + rank[j];
            if constexpr (W > 0) {
#pragma unroll
                for (int m = 0; m < W; ++m) a.buf_w[d * W + m] = wv[j][m];
            } else {
                const size_t i = r0 + 32 * j + lane;
                for (int m = 0; m < a.w; ++m) a.buf_w[d * a.w + m] = a.words[i * a.w + m];
            }
            a.buf_pay[d] = pv[j];
            a.buf_pos[d] = qv[j];
        }
    }
};

// The lane's ranks among its warp's items whose bit is set in `which`
// (items in the order j, lane), and the warp's count of them
__device__ __forceinline__ uint32_t warp_ranks(uint32_t which, int lane, uint32_t* rank) {
    const unsigned lower = (1u << lane) - 1u;
    uint32_t before = 0;
#pragma unroll
    for (int j = 0; j < CMP_ITEMS; ++j) {
        const unsigned b = __ballot_sync(0xffffffffu, (which >> j) & 1u);
        rank[j] = before + __popc(b & lower);
        before += __popc(b);
    }
    return before;
}

// The warp counts s_wc -> (the lane's warp's rows below it, the tile's)
__device__ __forceinline__ uint32_t warps_below(const uint32_t* s_wc, int warp, uint32_t& tile) {
    uint32_t below = 0;
    tile = 0;
#pragma unroll
    for (int v = 0; v < TP_WARPS; ++v) {
        below += v < warp ? s_wc[v] : 0u;
        tile += s_wc[v];
    }
    return below;
}

template <int W>
__global__ void __launch_bounds__(TP_THREADS) k_compact_real(CompactArgs a) {
    __shared__ uint32_t s_wc[TP_WARPS], s_scan[TP_WARPS];
    __shared__ uint32_t s_tile;
    __shared__ int s_stop;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(a.tile_ctr, 1u);
    __syncthreads();
    const size_t tile = s_tile;
    const size_t t0 = tile * CMP_TILE;
    const int tn = a.n - t0 < (size_t)CMP_TILE ? (int)(a.n - t0) : CMP_TILE;
    const long long off = a.state[0];

    // the lane's rows in registers; the real ones ranked in the warp
    Rows<W> rows;
    const int w0 = warp * CMP_WI;
    const uint32_t real = rows.load(a, t0 + w0, tn - w0, lane);
    uint32_t rank[CMP_ITEMS];
    const uint32_t cnt = warp_ranks(real, lane, rank);
    if (lane == 0) s_wc[warp] = cnt;
    __syncthreads();
    // the tile's count published, its prefix over the earlier tiles
    uint32_t own;
    const uint32_t below = warps_below(s_wc, warp, own);
    const uint32_t excl = tp_block_lookback(a.status, a.epoch, tile, own, s_scan, &s_stop);
    const long long off_c = min(off, a.lim);
    if (tile == 0 && tid == 0) *a.off_c = off_c;
    rows.store(a, t0 + w0, lane, real, rank, (size_t)off_c + excl + below);
}

template <int W>
__global__ void __launch_bounds__(TP_THREADS) k_compact_rest(CompactArgs a) {
    __shared__ uint32_t s_wc[TP_WARPS];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t tile = blockIdx.x;
    const size_t t0 = tile * CMP_TILE;
    const int tn = a.n - t0 < (size_t)CMP_TILE ? (int)(a.n - t0) : CMP_TILE;
    // the inclusive prefixes the sweep published (real rows before the
    // tile, and in the call) and off_c, loaded beside the rows
    const uint32_t before = tile > 0 ? (uint32_t)a.status[tile - 1] : 0u;
    const uint32_t cnt = (uint32_t)a.status[a.tiles - 1];
    const long long off_c = *a.off_c;
    Rows<W> rows;
    const int w0 = warp * CMP_WI;
    const int left = tn - w0;
    uint32_t other = ~rows.load(a, t0 + w0, left, lane);
    if (left < CMP_WI)  // items past the batch are not rows
        for (int j = 0; j < CMP_ITEMS; ++j)
            if (32 * j + lane >= left) other &= ~(1u << j);
    other &= (1u << CMP_ITEMS) - 1u;
    uint32_t rank[CMP_ITEMS];
    const uint32_t c = warp_ranks(other, lane, rank);
    if (lane == 0) s_wc[warp] = c;
    __syncthreads();
    uint32_t tile_others;
    const uint32_t below = warps_below(s_wc, warp, tile_others);
    rows.store(a, t0 + w0, lane, other, rank,
               (size_t)off_c + cnt + (t0 - before) + below);
    if (tile == 0 && tid == 0) {
        if (a.state[0] + (long long)cnt > a.lim) a.state[1] = 1;
        a.state[0] = off_c + cnt;
        *a.tile_ctr = 0;
    }
}

template <int W>
cudaError_t launch(const CompactArgs& a, cudaStream_t st) {
    k_compact_real<W><<<(unsigned)a.tiles, TP_THREADS, 0, st>>>(a);
    TP_LAUNCH_CHECK();
    k_compact_rest<W><<<(unsigned)a.tiles, TP_THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Records a look-back tile: the scratch of n records is 16 + ceil(n /
// tile) * 8 bytes
extern "C" int tp_compact_tile() { return CMP_TILE; }

// scratch: scratch_bytes (tp_compact_tile) zeroed before its first call and
// kept across calls, each call with another epoch (< 2^30) than the one
// before; the calls on one scratch run in stream order. n == 0 launches
// nothing.
extern "C" int tp_compact_append(const void* words, const void* pay, const void* pos,
                                 size_t n, int w, void* buf_w, void* buf_pay, void* buf_pos,
                                 long long lim, void* state, void* scratch,
                                 size_t scratch_bytes, uint32_t epoch, void* stream) {
    if (n == 0) return 0;
    const size_t tiles = (n + CMP_TILE - 1) / CMP_TILE;
    if (lim < 0 || w < 1 || n >= (1ull << 32) || epoch > TP_EPOCH_MASK || scratch == nullptr ||
        scratch_bytes < 16 + tiles * 8)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    CompactArgs a{};
    a.words = (const uint32_t*)words;
    a.pay = (const uint32_t*)pay;
    a.pos = (const long long*)pos;
    a.n = n, a.tiles = tiles, a.w = w, a.lim = lim;
    a.state = (long long*)state;
    a.buf_w = (uint32_t*)buf_w;
    a.buf_pay = (uint32_t*)buf_pay;
    a.buf_pos = (long long*)buf_pos;
    a.tile_ctr = (uint32_t*)scratch;
    a.off_c = (long long*)((char*)scratch + 8);
    a.status = (uint64_t*)((char*)scratch + 16);
    a.epoch = epoch;
    switch (w) {
        case 1: return (int)launch<1>(a, st);
        case 2: return (int)launch<2>(a, st);
        case 3: return (int)launch<3>(a, st);
        case W_MAX: return (int)launch<W_MAX>(a, st);
        default: return (int)launch<0>(a, st);
    }
}
