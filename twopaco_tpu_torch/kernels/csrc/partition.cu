// Round partition: build the records of a list of window batches and split
// each batch's by round into fixed-cap blocks, in one launch and a tail.
//
// Replaces twopaco_tpu/passes/sortpipe.py:166 build_and_partition and its
// scan over the batches, :306 _partition_scan.
//
// The round of a record is the first entry of `highs` (non-decreasing
// inclusive interval upper bounds) at or above its vertex hash, which is
// searchsorted(highs, hv, side="left"); positions without a record, or
// whose hash lies outside [low, high], belong to no round. Batch b's round
// p records go to block (b, p) in in-batch order (stable), each slot
// holding the w canonical words, the payload with the real bit, and the
// u32 in-batch offset; slots past the round's count are sentinels (words
// all-ones, payload 0, offset 0). counts[b][p] is the round's true count:
// above the cap the block overflowed (records past the cap are dropped)
// and the caller re-splits.
//
// Bound: the record computation (as in records.cu), the upload read once
// and the blocks written once (16 bytes a slot at w = 2). Design: common.cuh's
// one-sweep owner bucketing with the round as the owner, over the tiles of
// every batch of the call (tile t of batch b is tile b * tiles + t of the
// call, so a tile waits only on tiles of its batch that started before
// it). A block takes the next tile from an atomic counter; builds the
// tile's records into shared memory (w <= 4: a thread rolls a run of 8
// positions, common.cuh tp_roll_records, shared with records.cu; w > 4: a
// thread builds one position from scratch) with each record's round by a
// binary search of `highs` in shared memory; ranks the rounds stably in the
// tile (ballots up to 32 rounds, match masks above); takes each round's
// prefix over the batch's earlier tiles by a decoupled look-back; and
// stores each round's run of the tile coalesced into block (b, round),
// ranks past the cap dropped. The tail kernel writes every (batch, round)'s
// true count, the sentinels past it, and resets the tile counter. No
// record scratch, no scan, no memset: the look-back's status words (tiles x
// rounds u64 a batch) carry a per-call epoch in a scratch kept across calls
// (kernels/build.py lookback_scratch). They grow with batches x tiles x
// rounds, so the wrapper (passes/partition.py partition_scan) sizes its
// calls: a call takes as many batches as keep them within its budget (all
// of the slice's 123 batches at 4 rounds, 8 at 4096), every call the same
// two launches.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int PART_MAX = TP_ROUTE_MAX;  // rounds a call may split into
constexpr int PART_RUN = 8;             // positions a thread rolls along (w <= 4)
constexpr int W_ROLL = 4;               // widest rolled k-mer, words
constexpr int TAIL_CHUNK = 4096;        // block slots a tail block
constexpr uint32_t NO_SLOT = 0xffffffffu;

// positions a tile: a run a thread rolled (W > 0), one from scratch (W = 0)
__host__ __device__ constexpr int part_tile(int W) {
    return TP_THREADS * (W > 0 ? PART_RUN : 1);
}

struct PartArgs {
    const TpBatch* table;  // the call's batches
    int P, k, D, cap;
    uint32_t low, high;
    uint32_t tab[4];
    const uint32_t* highs;
    long long tiles;  // tiles a batch
    uint32_t* blk_w;
    uint32_t* blk_pay;
    uint32_t* blk_off;
    uint64_t* status;  // (batch, tile) x D
    uint32_t* tile_ctr;
    uint32_t epoch;
};

// Dynamic shared bytes of a block: the tile's staged words (skewed when
// rolled) and payloads, per record its block slot (u32) and its round, rank
// and staged index (u16); per round its bound, count, prefix and run offset
// in the tile (D + 1) (u32); the warps' u16 round counters
size_t part_smem(int W, int w, int D) {
    const size_t tile = part_tile(W);
    const size_t words = W > 0 ? tile * W + tile * W / 32 : tile * w;
    return (words + tile + tile / 32 + tile) * 4 + tile * 3 * 2 + (size_t)(4 * D + 1) * 4 +
           (size_t)TP_WARPS * D * 2;
}

// The round of vertex hash h: the first of the D bounds at or above it (D:
// above them all, no round)
__device__ __forceinline__ uint32_t round_of(const uint32_t* s_hi, int D, uint32_t h) {
    int lo = 0, hi = D;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_hi[mid] < h) lo = mid + 1;
        else hi = mid;
    }
    return (uint32_t)lo;
}

// W: the rolled width, or 0 for w > 4
template <int W>
__global__ void __launch_bounds__(TP_THREADS) k_partition(PartArgs a) {
    constexpr int TILE = part_tile(W);
    constexpr int WI = TILE / TP_WARPS;  // records a warp ranks
    extern __shared__ __align__(16) unsigned char s_mem[];
    const int D = a.D, P = a.P, k = a.k;
    const int w = W > 0 ? W : (k + 15) / 16;
    uint32_t* s_w = (uint32_t*)s_mem;  // staged words, position-major
    uint32_t* s_p = s_w + (W > 0 ? TILE * W + TILE * W / 32 : TILE * w);  // payloads
    uint32_t* s_slot = s_p + TILE + TILE / 32;  // [TILE] block slot of a staged record
    uint32_t* s_hi = s_slot + TILE;             // [D] the rounds' bounds
    uint32_t* s_tot = s_hi + D;                 // [D]
    uint32_t* s_dst = s_tot + D;                // [D]
    uint32_t* s_tex = s_dst + D;                // [D + 1]
    uint16_t* s_own = (uint16_t*)(s_tex + D + 1);  // [TILE] round (D: none)
    uint16_t* s_rank = s_own + TILE;               // [TILE]
    uint16_t* s_perm = s_rank + TILE;              // [TILE] round-major
    uint16_t* s_wc = s_perm + TILE;                // [TP_WARPS][D]
    __shared__ uint32_t s_T[4], s_Tk[4], s_Tk1[4];
    __shared__ uint32_t s_scan[TP_WARPS];
    __shared__ uint32_t s_tile;
    const int tid = threadIdx.x;
    if (tid == 0) {
        s_tile = atomicAdd(a.tile_ctr, 1u);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const uint32_t t = a.tab[c];
            s_T[c] = t;
            s_Tk[c] = tp_rotl32(t, (uint32_t)k);
            s_Tk1[c] = tp_rotl32(t, (uint32_t)(k - 1));
        }
    }
    for (int i = tid; i < TP_WARPS * D; i += TP_THREADS) s_wc[i] = 0;
    for (int i = tid; i < D; i += TP_THREADS) s_hi[i] = a.highs[i];
    __syncthreads();
    const long long b = s_tile / a.tiles;
    const long long tile = s_tile - b * a.tiles;
    const TpBatch* bt = a.table + b;
    const long long t0 = tile * TILE;
    const long long left = bt->rows * P - t0;
    const int tn = left <= 0 ? 0 : (left < TILE ? (int)left : TILE);  // positions

    // the tile's records, each with its round
    if constexpr (W > 0) {
        const int l0 = tid * PART_RUN;
        const int steps = min(max(tn - l0, 0), PART_RUN);
        if (steps > 0)
            tp_roll_records<W>(bt->packed, bt->nmask, bt->valid, bt->RW, bt->NW, P, k, t0 + l0,
                               steps, s_T, s_Tk, s_Tk1,
                               [&](int s, bool ok, uint32_t h, bool is_rc,
                                   const TpWindow<W>& win, uint32_t pay) {
                                   const int l = l0 + s;
#pragma unroll
                                   for (int m = 0; m < W; ++m)
                                       s_w[tp_skew(l * W + m)] = is_rc ? win.rc[m] : win.fw[m];
                                   s_p[tp_skew(l)] = pay;
                                   s_own[l] = (uint16_t)(ok && h >= a.low && h <= a.high
                                                             ? round_of(s_hi, D, h)
                                                             : (uint32_t)D);
                               });
        for (int s = steps; s < PART_RUN; ++s) s_own[l0 + s] = (uint16_t)D;
    } else {
        uint32_t o = D;
        if (tid < tn) {
            const long long x = t0 + tid;
            const int r = (int)(x / P), i = (int)(x - (long long)r * P);
            const TpRow row{bt->packed + (size_t)r * bt->RW, bt->nmask + (size_t)r * bt->NW};
            uint32_t hf[4], hr[4];
            tp_window_hashes(row, i + 1, k, 1, s_T, hf, hr);
            const uint32_t h = hf[0] + hr[0];
            if (tp_position_ok(row, i, k, bt->valid[r]) && h >= a.low && h <= a.high) {
                s_p[tid] = tp_canonical_record(row, i, k, w, s_w + (size_t)tid * w);
                o = round_of(s_hi, D, h);
            }
        }
        s_own[tid] = (uint16_t)o;
    }
    __syncthreads();

    // rank, per-round offsets in the tile, publish (common.cuh)
    tp_warp_rank(D, WI, [&](int it) { return (uint32_t)s_own[it]; }, s_rank, s_wc);
    __syncthreads();
    uint64_t* status = a.status + (size_t)b * a.tiles * D;  // batch b's
    tp_tile_offsets(D, (size_t)tile, a.epoch, s_wc, s_tot, s_tex, s_scan, status);

    // stage each record's index in the tile, round-major
    const int warp = tid >> 5;
    for (int sl = 0; sl < WI; sl += 32) {
        const int it = warp * WI + sl + (tid & 31);
        const uint32_t o = s_own[it];
        if (o < (uint32_t)D) s_perm[s_tex[o] + s_wc[warp * D + o] + s_rank[it]] = (uint16_t)it;
    }
    tp_owner_lookback(D, (size_t)tile, a.epoch, s_tot, s_dst, status);
    __syncthreads();

    // each staged record's slot in its batch's blocks (NO_SLOT past the cap)
    const uint32_t staged = s_tex[D];
    for (uint32_t t = tid; t < staged; t += TP_THREADS) {
        const int o = tp_run_owner(s_tex, D, t);
        const uint32_t g = s_dst[o] + (t - s_tex[o]);
        s_slot[t] = g < (uint32_t)a.cap ? (uint32_t)o * (uint32_t)a.cap + g : NO_SLOT;
    }
    __syncthreads();
    // consecutive threads, consecutive words of each round's run
    const size_t base = (size_t)b * D * a.cap;
    for (uint32_t x = tid; x < staged * (uint32_t)w; x += TP_THREADS) {
        const uint32_t t = x / (uint32_t)w;
        const uint32_t m = x - t * (uint32_t)w;
        const uint32_t s = s_slot[t];
        if (s == NO_SLOT) continue;
        const int src = s_perm[t] * w + m;
        a.blk_w[(base + s) * w + m] = s_w[W > 0 ? tp_skew(src) : src];
    }
    for (uint32_t t = tid; t < staged; t += TP_THREADS) {
        const uint32_t s = s_slot[t];
        if (s == NO_SLOT) continue;
        const int l = s_perm[t];
        a.blk_pay[base + s] = s_p[W > 0 ? tp_skew(l) : l];
        a.blk_off[base + s] = (uint32_t)(t0 + l);
    }
}

// Block (chunk, round d, batch b): the true count of (b, d), sentinels past
// it (common.cuh tp_owner_tail over batch b's blocks); the tile counter back
// to 0 for the next call
__global__ void k_part_tail(const uint64_t* __restrict__ status, long long tiles, int D,
                            size_t cap, int w, int32_t* __restrict__ counts,
                            uint32_t* __restrict__ blk_w, uint32_t* __restrict__ blk_pay,
                            uint32_t* __restrict__ blk_off, uint32_t* __restrict__ tile_ctr) {
    const size_t b = blockIdx.z;
    if (blockIdx.x == 0 && blockIdx.y == 0 && b == 0 && threadIdx.x == 0) *tile_ctr = 0;
    const uint64_t* last = status + (b * tiles + tiles - 1) * D;
    if (blockIdx.x == 0 && threadIdx.x == 0)
        counts[b * D + blockIdx.y] = (int32_t)(uint32_t)last[blockIdx.y];
    const size_t base = b * D * cap;
    tp_owner_tail(last, cap, TAIL_CHUNK, nullptr, [&](size_t j) {
        for (int m = 0; m < w; ++m) blk_w[(base + j) * w + m] = 0xffffffffu;
        blk_pay[base + j] = 0u;
        blk_off[base + j] = 0u;
    });
}

template <int W>
cudaError_t launch(const PartArgs& a, unsigned blocks, size_t smem, cudaStream_t st) {
    k_partition<W><<<blocks, TP_THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

// The largest dynamic shared memory of each instantiation, once a device
template <int W>
cudaError_t allow_smem(int optin) {
    cudaFuncAttributes fa{};
    cudaError_t e = cudaFuncGetAttributes(&fa, k_partition<W>);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(k_partition<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin - (int)fa.sharedSizeBytes);
}

}  // namespace

extern "C" int tp_partition_max_parts() { return PART_MAX; }

// Positions a look-back tile at k: the scratch of a call over nb batches of
// at most max_pos positions into n_parts rounds is 8 + nb * ceil(max_pos /
// tile) * n_parts * 8 bytes
extern "C" int tp_partition_tile(int k) { return part_tile((k + 15) / 16 <= W_ROLL ? 1 : 0); }

// The partition of nb batches in one launch and a tail. table: nb rows of 7
// int64 on the device (packed, nmask, valid pointers, rows, RW, NW, unused);
// max_pos: the most positions (rows * P) of a batch; highs: n_parts u32 on
// the device. scratch: scratch_bytes (tp_partition_tile) zeroed before its
// first call and kept across calls, each call with another epoch (< 2^30)
// than the one before; the calls on one scratch run in stream order.
// Outputs: blocks (nb, n_parts, cap, w) words, (nb, n_parts, cap) payload
// and offsets (every slot written), (nb, n_parts) int32 true counts.
extern "C" int tp_partition_records(const void* table, int nb, long long max_pos, int P, int k,
                                    uint32_t low, uint32_t high, uint32_t t0, uint32_t t1,
                                    uint32_t t2, uint32_t t3, const void* highs, int n_parts,
                                    int cap, void* scratch, size_t scratch_bytes, uint32_t epoch,
                                    void* blk_w, void* blk_pay, void* blk_off, void* counts,
                                    void* stream) {
    const int w = (k + 15) / 16;
    const int W = w <= W_ROLL ? w : 0;
    const long long tiles = max_pos > 0 ? (max_pos + part_tile(W) - 1) / part_tile(W) : 0;
    if (table == nullptr || nb < 1 || nb > 65535 || max_pos < 1 || P < 1 || k < 1 ||
        n_parts < 1 || n_parts > PART_MAX || cap < 0 ||
        (size_t)n_parts * (size_t)cap >= NO_SLOT || epoch > TP_EPOCH_MASK ||
        scratch == nullptr || tiles * nb >= (1ll << 31) ||
        scratch_bytes < 8 + (size_t)(tiles * nb) * (size_t)n_parts * 8)
        return (int)cudaErrorInvalidValue;
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    static std::atomic<uint64_t> ready{0};
    e = tp_once_per_device(ready, [optin] {
        cudaError_t r = allow_smem<0>(optin);
        if (r == cudaSuccess) r = allow_smem<1>(optin);
        if (r == cudaSuccess) r = allow_smem<2>(optin);
        if (r == cudaSuccess) r = allow_smem<3>(optin);
        if (r == cudaSuccess) r = allow_smem<W_ROLL>(optin);
        return r;
    });
    if (e != cudaSuccess) return (int)e;
    const size_t smem = part_smem(W, w, n_parts);
    if (smem + 1024 > (size_t)optin) return (int)cudaErrorInvalidValue;  // k too large
    const cudaStream_t st = (cudaStream_t)stream;
    PartArgs a{};
    a.table = (const TpBatch*)table;
    a.P = P, a.k = k, a.D = n_parts, a.cap = cap;
    a.low = low, a.high = high;
    a.tab[0] = t0, a.tab[1] = t1, a.tab[2] = t2, a.tab[3] = t3;
    a.highs = (const uint32_t*)highs;
    a.tiles = tiles;
    a.blk_w = (uint32_t*)blk_w;
    a.blk_pay = (uint32_t*)blk_pay;
    a.blk_off = (uint32_t*)blk_off;
    a.tile_ctr = (uint32_t*)scratch;
    a.status = (uint64_t*)((char*)scratch + 8);
    a.epoch = epoch;
    const unsigned blocks = (unsigned)(tiles * nb);
    switch (W) {
        case 1: e = launch<1>(a, blocks, smem, st); break;
        case 2: e = launch<2>(a, blocks, smem, st); break;
        case 3: e = launch<3>(a, blocks, smem, st); break;
        case W_ROLL: e = launch<W_ROLL>(a, blocks, smem, st); break;
        default: e = launch<0>(a, blocks, smem, st); break;
    }
    if (e != cudaSuccess) return (int)e;
    const dim3 tail(std::max(tp_blocks((size_t)cap, TAIL_CHUNK), 1u), (unsigned)n_parts,
                    (unsigned)nb);
    k_part_tail<<<tail, TP_THREADS, 0, st>>>(a.status, tiles, n_parts, (size_t)cap, w,
                                            (int32_t*)counts, a.blk_w, a.blk_pay, a.blk_off,
                                            a.tile_ctr);
    return (int)cudaGetLastError();
}
