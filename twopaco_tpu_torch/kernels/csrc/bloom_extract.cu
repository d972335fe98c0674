// Bloom extract: the candidate records of a round's marked window batches,
// appended to the round's verify buffer, one launch and a tail a call.
//
// Replaces twopaco_tpu/passes/kernels.py:420 extract_records (a nonzero
// over the mask into a pow2 capacity bucket, then gathers of the canonical
// words and the in/out extensions), over a device table of batches.
//
// Every marked position t = row*P + col of batch b (batches in table
// order, positions in flat order) becomes the sort record of common.cuh
// tp_canonical_record (canonical words, payload in | out<<8 | is_rc<<16 |
// real<<17) with position bases[b] + t, written at
//     dst = off + (marked positions of the call before it)
// where state = (off, overflow) are two int64 on the device; then off +=
// the call's count. Calls appended in order fill the round buffer in the
// JAX package's record order, with no host sync between them. A record
// whose dst falls past the buffer's S slots is dropped and sets the
// overflow flag.
//
// Bound: bytes, the masks and the marked positions' windows read once and
// the records written (the records are most of it: a few percent of the
// positions are marked, and a record is 4w + 12 bytes). Design: no scan
// and no n-sized scratch. A block takes the next tile of EX_TILE positions
// from an atomic counter (tile t of batch b is call tile b * tiles + t, as
// in bloom_lookup.cu, so a look-back reads only earlier tiles of the
// call); a thread reads the mask bytes of EX_PER consecutive positions and
// the block ranks the set bits by a prefix over the threads into shared
// memory, in position order. common.cuh's block-wide look-back gives the
// tile's offset in the call at once (the count is known before any record
// is built), then a thread a marked position builds its record in
// registers from the upload words (common.cuh tp_canonical_key: 16 chars
// a word from two packed words by a funnel shift; words past the fourth
// built as stored) and stores it: consecutive threads, consecutive slots.
// Every block reads off, so the tail, which runs after them all, adds the
// call's count (the last tile's inclusive prefix) to off, sets the
// overflow flag and resets the tile counter. The status words carry a
// per-call epoch in a scratch kept across calls (kernels/build.py
// lookback_scratch, "extract").
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int EX_PER = 32;                    // positions a thread (4 mask bytes)
constexpr int EX_TILE = TP_THREADS * EX_PER;  // positions a tile

struct ExtractArgs {
    const TpBatch* table;     // a row's out_off: its mask's bytes from `mask`
    const long long* bases;   // batch b's first global position
    const uint8_t* mask;
    int P, k, w;
    long long tiles;          // tiles a batch
    long long n_tiles;        // tiles of the call
    uint32_t* out_w;          // the (S, w) buffer words
    uint32_t* out_pay;
    long long* out_pos;
    long long S;
    long long* state;         // (off, overflow)
    uint32_t* tile_ctr;
    uint64_t* status;         // a word a call tile
    uint32_t epoch;
};

// W: the key words held in registers, min(w, 4) (below 4 the record's
// words are known at compile time)
template <int W>
__global__ void __launch_bounds__(TP_THREADS) k_extract(ExtractArgs a) {
    __shared__ uint16_t s_pos[EX_TILE];  // the tile's marked positions
    __shared__ uint32_t s_scan[TP_WARPS];
    __shared__ uint32_t s_tile;
    __shared__ long long s_off;
    __shared__ int s_stop;
    const int tid = threadIdx.x;
    if (tid == 0) {
        s_tile = atomicAdd(a.tile_ctr, 1u);
        s_off = a.state[0];
    }
    __syncthreads();
    const size_t tile = s_tile;
    const int b = (int)(tile / (size_t)a.tiles);
    const long long t0 = (long long)(tile - (size_t)b * a.tiles) * EX_TILE;
    const TpBatch* bt = a.table + b;
    const long long n_b = bt->rows * a.P;

    // the thread's marked positions: bit q for position x0 + q
    const long long x0 = t0 + (long long)tid * EX_PER;
    uint32_t bits = 0;
    if (x0 < n_b) {
        const uint8_t* m = a.mask + bt->out_off + (x0 >> 3);
        // n_b and x0 are multiples of 8: a byte lies in the batch or wholly
        // past it; byte j to bits 31-8j .. 24-8j, then reversed
        uint32_t be = 0;
#pragma unroll
        for (int j = 0; j < EX_PER / 8; ++j)
            if (x0 + 8 * j < n_b) be |= (uint32_t)m[j] << (24 - 8 * j);
        bits = __brev(be);
    }
    uint32_t n_mark;
    uint32_t c_off = tp_block_excl_scan((uint32_t)__popc(bits), s_scan, n_mark);
    for (uint32_t v = bits; v; v &= v - 1)
        s_pos[c_off++] = (uint16_t)(tid * EX_PER + __ffs(v) - 1);
    // the tile's offset in the call (ends with a barrier: s_pos is written)
    const uint32_t excl = tp_block_lookback(a.status, a.epoch, tile, n_mark, s_scan, &s_stop);

    // a thread a marked position: its record built in registers and stored
    const int P = a.P, k = a.k, w = W < 4 ? W : a.w;
    const long long d0 = s_off + excl;
    const long long base = a.bases[b] + t0;
    const int RW = (int)bt->RW;
    for (uint32_t c = tid; c < n_mark; c += TP_THREADS) {
        const long long d = d0 + c;
        if (d >= a.S) break;  // and every later one of the thread
        const int lp = s_pos[c];
        const long long x = t0 + lp;
        const int r = (int)(x / P);
        const int i = (int)(x - (long long)r * P);
        const uint32_t* packed = bt->packed + (size_t)r * RW;
        uint32_t key[W];
        bool is_rc;
        tp_canonical_key<W>(packed, RW, i + 1, k, w, key, is_rc);
        uint32_t* dw = a.out_w + (size_t)d * w;
#pragma unroll
        for (int m = 0; m < W; ++m) dw[m] = key[m];
        for (int m = W; m < w; ++m) dw[m] = tp_key_word(packed, RW, i + 1, k, m, is_rc);
        const TpRow row{packed, bt->nmask + (size_t)r * bt->NW};
        const uint32_t prev = row.ext(i);
        const uint32_t next = row.ext(i + k + 1);
        const uint32_t in = is_rc ? tp_comp4(next) : prev;
        const uint32_t out = is_rc ? tp_comp4(prev) : next;
        a.out_pay[d] = in | (out << 8) | ((uint32_t)is_rc << 16) | TP_REAL;
        a.out_pos[d] = base + lp;
    }
}

// After k_extract: the call's count (the last tile's inclusive prefix)
// added to off, the overflow flag set when the records passed S, and the
// tile counter back to 0 for the next call
__global__ void k_extract_tail(ExtractArgs a) {
    const long long end = a.state[0] + (uint32_t)a.status[a.n_tiles - 1];
    a.state[0] = end;
    if (end > a.S) a.state[1] = 1;
    *a.tile_ctr = 0;
}

template <int W>
cudaError_t launch(const ExtractArgs& a, cudaStream_t st) {
    k_extract<W><<<(unsigned)a.n_tiles, TP_THREADS, 0, st>>>(a);
    TP_LAUNCH_CHECK();
    k_extract_tail<<<1, 1, 0, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Positions a look-back tile: the scratch of a call is 8 + nb * max(1,
// ceil(max_pos / tile)) * 8 bytes
extern "C" int tp_extract_tile() { return EX_TILE; }

// The records of nb batches' marked positions in one launch and a tail.
// table: nb TpBatch rows (out_off: the byte offset of the batch's (rows,
// P/8) mask from mask; valid is not read); bases: nb int64; max_pos: the
// most positions of a batch (< 2^31 in all); the buffer: out_w (S, w) u32,
// out_pay (S,) u32, out_pos (S,) int64, S >= 0; state: int64 (off,
// overflow), off >= 0. scratch: scratch_bytes (tp_extract_tile) zeroed
// before its first call and kept across calls, each call with another
// epoch (< 2^30) than the one before.
extern "C" int tp_bloom_extract(const void* table, const void* bases, int nb, long long max_pos,
                                int P, int k, const void* mask, void* out_w, void* out_pay,
                                void* out_pos, long long S, void* state, void* scratch,
                                size_t scratch_bytes, uint32_t epoch, void* stream) {
    const long long tiles = std::max<long long>(1, (max_pos + EX_TILE - 1) / EX_TILE);
    if (table == nullptr || nb < 1 || max_pos < 0 || (long long)nb * max_pos >= (1ll << 31) ||
        P < 8 || P % 8 != 0 || k < 1 || S < 0 || epoch > TP_EPOCH_MASK || scratch == nullptr ||
        scratch_bytes < (size_t)(8 + nb * tiles * 8))
        return (int)cudaErrorInvalidValue;
    ExtractArgs a{};
    a.table = (const TpBatch*)table;
    a.bases = (const long long*)bases;
    a.mask = (const uint8_t*)mask;
    a.P = P, a.k = k, a.w = (k + 15) / 16;
    a.tiles = tiles;
    a.n_tiles = nb * tiles;
    a.out_w = (uint32_t*)out_w;
    a.out_pay = (uint32_t*)out_pay;
    a.out_pos = (long long*)out_pos;
    a.S = S;
    a.state = (long long*)state;
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
