// Bloom lookup: the junction ids of the candidate positions of a run's
// window batches (pass 4 of the Bloom engine), one launch and a tail a
// call.
//
// Replaces twopaco_tpu/passes/kernels.py:506 pass4_lookup (a sort to
// compact the candidates, a fixed-step vectorised lower bound, a second
// sort to compact the hits), over a device table of batches.
//
// Candidates: the positions t = row*P + col of a batch whose bit is set in
// its mask (the OR of every round's), inside the row's valid count, with
// no N in their window. Each candidate's canonical k-mer is searched in
// the sorted (J, w) junction table (u32 words compared as unsigned,
// lexicographically); a hit gets id +(rank+1) when the forward strand is
// canonical, else -(rank+1). Output: a u64 key a hit (held in an int64),
// key = pos << id_bits | (id + 2^(id_bits-1)) with pos the hit's global
// position (the batch's base + t): the layout of passes/occ.py, which the
// emit (passes/emit.py) takes. The keys come out batch by batch and
// ascending in each, so ascending over the call when the bases ascend; at
// most cap of them; the number of hits (int64, which may exceed cap: the
// caller checks); slots past it hold PAD_KEY (u64 max).
//
// Bound: bytes, the masks and the candidates' windows read, the keys written
// (8 bytes a hit), and the distinct 32-byte sectors of the junction table
// that the searches touch. Design: no scan and no n-sized scratch. A block
// takes the next tile of LK_TILE positions from an atomic counter (tile t of
// batch b is call tile b * tiles + t, as in partition.cu, so a look-back
// reads only earlier tiles of the call); a thread reads the mask bytes of
// LK_PER consecutive positions, tests its set bits (valid count, N) and the
// block ranks the candidates by a prefix over the threads into shared memory,
// in position order. Then a thread a candidate (dense, LK_TILE / TP_THREADS
// rounds at most): its canonical key built in registers from scratch (16
// chars a word from two packed words by a funnel shift; the forward word
// bit-reversed, the reverse complement's complemented in place), a lower bound
// over the table, and the hits ranked by ballots into the same shared memory
// (in place: a hit's rank never passes its candidate's index). common.cuh's
// block-wide look-back gives the tile's offset in the call's output; the
// hits' keys are stored coalesced, one 8-byte store a hit. The last tile
// writes the count; the tail fills the slots past it and resets the tile
// counter. The status words carry a per-call epoch in a scratch kept across
// calls (kernels/build.py lookback_scratch, "lookup").
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int LK_PER = 16;                     // positions a thread (2 mask bytes)
constexpr int LK_TILE = TP_THREADS * LK_PER;   // positions a tile
constexpr int TAIL_CHUNK = 4096;               // output slots a tail block
constexpr long long PAD_KEY = -1;              // u64 max: the unused slots

struct LookupArgs {
    const TpBatch* table;     // a row's out_off: its mask's bytes from `mask`
    const long long* bases;   // batch b's first global position
    const uint8_t* mask;
    int P, k, w;
    long long tiles;          // tiles a batch
    long long n_tiles;        // tiles of the call
    const uint32_t* jt;       // the (J, w) junction table
    long long J, cap;
    int id_bits;
    long long* out_keys;
    long long* count;
    uint32_t* tile_ctr;
    uint64_t* status;         // a word a call tile
    uint32_t epoch;
};

// Table row `row` against the key: -1 below it, 0 equal, 1 above (the
// row's first W words loaded together)
template <int W>
__device__ __forceinline__ int cmp_row(const uint32_t* jt, long long row, int w,
                                       const uint32_t* key, const uint32_t* packed, int RW, int s,
                                       int k, bool is_rc) {
    const uint32_t* tr = jt + row * w;
    uint32_t v[W];
#pragma unroll
    for (int m = 0; m < W; ++m) v[m] = __ldg(tr + m);
    int c = 0;
#pragma unroll
    for (int m = 0; m < W; ++m)
        if (c == 0 && v[m] != key[m]) c = v[m] < key[m] ? -1 : 1;
    for (int m = W; c == 0 && m < w; ++m) {
        const uint32_t a = __ldg(tr + m);
        const uint32_t b = tp_key_word(packed, RW, s, k, m, is_rc);
        if (a != b) c = a < b ? -1 : 1;
    }
    return c;
}

// W: the key words held in registers, min(w, 4) (below 4 the key's words
// are known at compile time)
template <int W>
__global__ void __launch_bounds__(TP_THREADS) k_lookup(LookupArgs a) {
    __shared__ uint16_t s_pos[LK_TILE];  // the tile's candidates, then its hits
    __shared__ int32_t s_id[LK_TILE];    // the hits' ids
    __shared__ uint32_t s_scan[TP_WARPS];
    __shared__ uint32_t s_tile;
    __shared__ int s_stop;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(a.tile_ctr, 1u);
    __syncthreads();
    const size_t tile = s_tile;
    const int b = (int)(tile / (size_t)a.tiles);
    const long long t0 = (long long)(tile - (size_t)b * a.tiles) * LK_TILE;
    const TpBatch* bt = a.table + b;
    const long long n_b = bt->rows * a.P;
    const int P = a.P, k = a.k, w = W < 4 ? W : a.w;

    // the thread's candidates: bit q for position x0 + q
    const long long x0 = t0 + (long long)tid * LK_PER;
    uint32_t cand = 0;
    if (x0 < n_b) {
        const uint8_t* m = a.mask + bt->out_off + (x0 >> 3);
        // n_b and x0 are multiples of 8: the second byte lies in the batch
        // or wholly past it
        const uint32_t two = ((uint32_t)m[0] << 24) | (x0 + 8 < n_b ? (uint32_t)m[1] << 16 : 0u);
        for (uint32_t v = __brev(two); v; v &= v - 1) {  // position x0 + q at bit q
            const int q = __ffs(v) - 1;
            const long long x = x0 + q;
            const int r = (int)(x / P);
            const int i = (int)(x - (long long)r * P);
            const TpRow row{bt->packed + (size_t)r * bt->RW, bt->nmask + (size_t)r * bt->NW};
            if (tp_position_ok(row, i, k, bt->valid[r])) cand |= 1u << q;
        }
    }
    uint32_t n_cand;
    uint32_t c_off = tp_block_excl_scan((uint32_t)__popc(cand), s_scan, n_cand);
    for (uint32_t v = cand; v; v &= v - 1) s_pos[c_off++] = (uint16_t)(tid * LK_PER + __ffs(v) - 1);
    __syncthreads();

    // a thread a candidate: key, lower bound, the hits ranked into s_pos
    // and s_id in candidate order
    uint32_t hits = 0;
    for (uint32_t c0 = 0; c0 < n_cand; c0 += TP_THREADS) {
        const uint32_t c = c0 + tid;
        bool hit = false;
        int32_t id = 0;
        uint16_t lp = 0;
        if (c < n_cand) {
            lp = s_pos[c];
            const long long x = t0 + lp;
            const int r = (int)(x / P);
            const int s = (int)(x - (long long)r * P) + 1;  // the window's first char
            const uint32_t* packed = bt->packed + (size_t)r * bt->RW;
            const int RW = (int)bt->RW;
            uint32_t key[W];
            bool is_rc;
            tp_canonical_key<W>(packed, RW, s, k, w, key, is_rc);
            long long lo = 0, hi = a.J;  // the first row >= key
            while (lo < hi) {
                const long long mid = lo + ((hi - lo) >> 1);
                if (cmp_row<W>(a.jt, mid, w, key, packed, RW, s, k, is_rc) < 0)
                    lo = mid + 1;
                else
                    hi = mid;
            }
            hit = lo < a.J && cmp_row<W>(a.jt, lo, w, key, packed, RW, s, k, is_rc) == 0;
            id = is_rc ? -(int32_t)(lo + 1) : (int32_t)(lo + 1);
        }
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) s_scan[warp] = __popc(bal);
        __syncthreads();  // every read of this round's candidates is done
        uint32_t below = 0, round = 0;
#pragma unroll
        for (int u = 0; u < TP_WARPS; ++u) {
            below += u < warp ? s_scan[u] : 0u;
            round += s_scan[u];
        }
        if (hit) {
            const uint32_t d = hits + below + __popc(bal & ((1u << lane) - 1u));
            s_pos[d] = lp;  // d <= c: no candidate still to be read
            s_id[d] = id;
        }
        hits += round;
        __syncthreads();
    }

    // the tile's offset in the call's output; the hits stored coalesced
    const uint32_t excl = tp_block_lookback(a.status, a.epoch, tile, hits, s_scan, &s_stop);
    if (tile + 1 == (size_t)a.n_tiles && tid == 0) *a.count = (long long)excl + hits;
    const long long base = a.bases[b] + t0;
    const long long bias = 1ll << (a.id_bits - 1);
    for (uint32_t j = tid; j < hits; j += TP_THREADS) {
        const long long d = (long long)excl + j;
        if (d < a.cap)
            a.out_keys[d] = (long long)(((unsigned long long)(base + s_pos[j]) << a.id_bits) |
                                        (unsigned long long)(s_id[j] + bias));
    }
}

// The slots from the count to cap, and the tile counter back to 0 for the
// next call
__global__ void k_lookup_tail(LookupArgs a) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *a.tile_ctr = 0;
    const long long cnt = *a.count;
    const long long c0 = (long long)blockIdx.x * TAIL_CHUNK;
    const long long end = min(c0 + TAIL_CHUNK, a.cap);
    for (long long j = max(cnt, c0) + threadIdx.x; j < end; j += TP_THREADS)
        a.out_keys[j] = PAD_KEY;
}

template <int W>
cudaError_t launch(const LookupArgs& a, cudaStream_t st) {
    k_lookup<W><<<(unsigned)a.n_tiles, TP_THREADS, 0, st>>>(a);
    TP_LAUNCH_CHECK();
    k_lookup_tail<<<(unsigned)std::max<long long>(1, (a.cap + TAIL_CHUNK - 1) / TAIL_CHUNK),
                    TP_THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Positions a look-back tile: the scratch of a call is 8 + nb * max(1,
// ceil(max_pos / tile)) * 8 bytes
extern "C" int tp_lookup_tile() { return LK_TILE; }

// The hits of nb batches in one launch and a tail. table: nb TpBatch rows
// (out_off: the byte offset of the batch's (rows, P/8) mask from mask);
// bases: nb int64; max_pos: the most positions of a batch (< 2^31 in all);
// jt: (J, w) u32 sorted, 1 <= J < 2^31 - 1; cap >= 0; id_bits in [2, 62]
// with J < 2^(id_bits-1) and every global position below 2^(64-id_bits)
// (the caller checks the positions); out_keys (cap int64), count (one
// int64). scratch: scratch_bytes
// (tp_lookup_tile) zeroed before its first call and kept across calls,
// each call with another epoch (< 2^30) than the one before.
extern "C" int tp_bloom_lookup(const void* table, const void* bases, int nb, long long max_pos,
                               int P, int k, const void* mask, const void* jt, long long J,
                               long long cap, int id_bits, void* out_keys, void* count,
                               void* scratch, size_t scratch_bytes, uint32_t epoch,
                               void* stream) {
    const long long tiles = std::max<long long>(1, (max_pos + LK_TILE - 1) / LK_TILE);
    if (table == nullptr || nb < 1 || max_pos < 0 || (long long)nb * max_pos >= (1ll << 31) ||
        P < 8 || P % 8 != 0 || k < 1 || J < 1 || J >= (1ll << 31) - 1 || cap < 0 ||
        id_bits < 2 || id_bits > 62 || J >= (1ll << (id_bits - 1)) ||
        epoch > TP_EPOCH_MASK || scratch == nullptr ||
        scratch_bytes < (size_t)(8 + nb * tiles * 8))
        return (int)cudaErrorInvalidValue;
    LookupArgs a{};
    a.table = (const TpBatch*)table;
    a.bases = (const long long*)bases;
    a.mask = (const uint8_t*)mask;
    a.P = P, a.k = k, a.w = (k + 15) / 16;
    a.tiles = tiles;
    a.n_tiles = nb * tiles;
    a.jt = (const uint32_t*)jt;
    a.J = J, a.cap = cap;
    a.id_bits = id_bits;
    a.out_keys = (long long*)out_keys;
    a.count = (long long*)count;
    a.tile_ctr = (uint32_t*)scratch;
    a.status = (uint64_t*)((char*)scratch + 8);
    a.epoch = epoch;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (a.w) {
        case 1: return (int)launch<1>(a, st);
        case 2: return (int)launch<2>(a, st);
        case 3: return (int)launch<3>(a, st);
        default: return (int)launch<4>(a, st);
    }
}
