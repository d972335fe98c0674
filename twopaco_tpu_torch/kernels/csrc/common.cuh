// Shared declarations of the port's CUDA kernels (built for sm_90a).
//
// Every exported entry point has a plain C interface (bound with ctypes),
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launches (0 = success).
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define TP_LAUNCH_CHECK()                          \
    do {                                           \
        cudaError_t tp_err_ = cudaGetLastError();  \
        if (tp_err_ != cudaSuccess) return tp_err_; \
    } while (0)

constexpr int TP_THREADS = 256;
constexpr int TP_WARPS = TP_THREADS / 32;

inline unsigned tp_blocks(size_t n, size_t per_block) {
    return (unsigned)((n + per_block - 1) / per_block);
}

// Stable LSD radix sort of n u64 keys by bits [lo, hi) (sort.cu) over
// tp_radix_passes(lo, hi) digit passes that alternate between key and
// key_alt: the result is in key after an even count, in key_alt after an
// odd one. scratch: tp_sort_scratch_bytes(n, passes) bytes or more. Used
// by the occurrence sort (occ_pack.cu).
cudaError_t tp_radix_sort_u64(uint64_t* key, uint64_t* key_alt, size_t n,
                              int lo, int hi, void* scratch,
                              size_t scratch_bytes, cudaStream_t st);

int tp_radix_passes(int lo, int hi);

extern "C" size_t tp_sort_scratch_bytes(size_t n, int passes);

// ---- the per-position record, shared by every kernel that reads the
// upload form of a window batch (records.cu, partition.cu, histogram.cu
// and the Bloom engine's bloom_*.cu)
//
// Upload form (ops/pack.py pack_codes_host): 2-bit chars packed
// little-first (char j at bits 2*(j%16) of word j/16) plus an N bitmask
// (bit j%32 of word j/32). Position i of a row is the vertex of chars
// i+1 .. i+k; prev = char i, next = char i+k+1.
namespace {

constexpr uint32_t TP_REAL = 1u << 17;  // payload bit of a real record

// One batch of a call over a device table of batches (7 int64, the
// wrapper's table row): its upload form, rows of P positions (RW, NW words
// a row), and where its packed mask goes in the Bloom mark's output (bytes;
// the Bloom fill and the round partition ignore it)
struct TpBatch {
    const uint32_t* packed;
    const uint32_t* nmask;
    const int32_t* valid;
    long long rows, RW, NW, out_off;
};

__device__ __forceinline__ uint32_t tp_rotl32(uint32_t x, uint32_t s) {
    return __funnelshift_l(x, x, s);  // shift amount taken mod 32
}

// The status words of a decoupled look-back (sort.cu's digit passes,
// the owner bucketing below, judge.cu's tile prefixes): relaxed loads and
// stores at device scope, each word read and written whole.
__device__ __forceinline__ uint64_t tp_load_relaxed(const uint64_t* p) {
    uint64_t v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

__device__ __forceinline__ void tp_store_relaxed(uint64_t* p, uint64_t v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

// Exclusive prefix of v over the block's threads, and the block's total
// (s_warp: a shared word a warp; every thread of the block calls)
__device__ __forceinline__ uint32_t tp_block_excl_scan(uint32_t v, uint32_t* s_warp,
                                                       uint32_t& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    uint32_t off = 0;
    total = 0;
    for (int u = 0; u < (int)(blockDim.x >> 5); ++u) {
        if (u < warp) off += s_warp[u];
        total += s_warp[u];
    }
    __syncthreads();
    return off + x - v;
}

__device__ __forceinline__ uint32_t tp_block_excl_scan(uint32_t v, uint32_t* s_warp) {
    uint32_t total;
    return tp_block_excl_scan(v, s_warp, total);
}

struct TpRow {
    const uint32_t* packed;
    const uint32_t* nmask;

    __device__ __forceinline__ uint32_t code(int j) const {
        return (packed[j >> 4] >> (2 * (j & 15))) & 3u;  // N reads as 0
    }
    __device__ __forceinline__ bool is_n(int j) const {
        return (nmask[j >> 5] >> (j & 31)) & 1u;
    }
    __device__ __forceinline__ uint32_t ext(int j) const {
        return is_n(j) ? 4u : code(j);
    }
    // word m of the forward k-mer starting at char s
    __device__ __forceinline__ uint32_t fw_word(int s, int k, int m) const {
        uint32_t x = 0;
        for (int q = 0; q < 16; ++q) {
            const int t = 16 * m + q;
            if (t >= k) break;
            x |= code(s + t) << (30 - 2 * q);
        }
        return x;
    }
    // word m of its reverse complement: rc char t = 3 - char (s+k-1-t)
    __device__ __forceinline__ uint32_t rc_word(int s, int k, int m) const {
        uint32_t x = 0;
        for (int q = 0; q < 16; ++q) {
            const int t = 16 * m + q;
            if (t >= k) break;
            x |= (3u - code(s + k - 1 - t)) << (30 - 2 * q);
        }
        return x;
    }
    // no N among chars [lo, hi]
    __device__ __forceinline__ bool definite(int lo, int hi) const {
        for (int wi = lo >> 5; wi <= (hi >> 5); ++wi) {
            const int a = max(lo - 32 * wi, 0);
            const int z = min(hi - 32 * wi, 31);
            const int len = z - a + 1;
            const uint32_t sel =
                (len == 32 ? 0xffffffffu : ((1u << len) - 1u)) << a;
            if (nmask[wi] & sel) return false;
        }
        return true;
    }
};

__device__ __forceinline__ uint32_t tp_comp4(uint32_t c) {
    return c < 4 ? 3u - c : 4u;
}

// Position i has a record at all: inside the row's valid count and no N
// in its window
__device__ __forceinline__ bool tp_position_ok(const TpRow& row, int i, int k,
                                               int valid) {
    return i < valid && row.definite(i + 1, i + k);
}

// The canonical record of position i (whose window holds no N): writes
// its w canonical (lexicographic min of the two strands) k-mer words,
// MSB-first and left-aligned, to wout and returns its payload in | out<<8 |
// is_rc<<16 | real<<17 (in/out in canonical orientation; N = 4 stays N
// under complement). The canonical strand is chosen by comparing words as
// they are generated, so no per-thread word arrays are kept for any k.
__device__ __forceinline__ uint32_t tp_canonical_record(
    const TpRow& row, int i, int k, int w, uint32_t* __restrict__ wout) {
    const int s = i + 1;
    bool is_rc = false;
    for (int m = 0; m < w; ++m) {
        const uint32_t f = row.fw_word(s, k, m);
        const uint32_t r = row.rc_word(s, k, m);
        if (f != r) {
            is_rc = r < f;
            break;
        }
    }
    for (int m = 0; m < w; ++m)
        wout[m] = is_rc ? row.rc_word(s, k, m) : row.fw_word(s, k, m);
    const uint32_t prev = row.ext(i);
    const uint32_t next = row.ext(i + k + 1);
    const uint32_t in = is_rc ? tp_comp4(next) : prev;
    const uint32_t out = is_rc ? tp_comp4(prev) : next;
    return in | (out << 8) | ((uint32_t)is_rc << 16) | TP_REAL;
}

// ---- a window's canonical k-mer from its upload words, 16 chars a word
// (bloom_lookup.cu's keys, bloom_extract.cu's records)

// 16 chars of a row from char p (p >= -15), little-first (char p + q at
// bits 2q); chars before the row and past its words read as 0
__device__ __forceinline__ uint32_t tp_chars16(const uint32_t* packed, int RW, int p) {
    const int wi = p >> 4;  // floor
    const uint32_t lo = wi >= 0 ? packed[wi] : 0u;
    const uint32_t hi = wi + 1 < RW ? packed[wi + 1] : 0u;
    return __funnelshift_r(lo, hi, 2 * (p & 15));
}

// The 2-bit chars of v in reverse order (char q to char 15 - q)
__device__ __forceinline__ uint32_t tp_rev2(uint32_t v) {
    const uint32_t x = __brev(v);
    return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// Word m of the forward k-mer at char s (MSB-first, left-aligned, chars
// past k zero) or of its reverse complement (rc char t = 3 - char s+k-1-t:
// the 16 chars ending at s+k-1-16m, complemented, already in MSB-first
// order); N chars read as 0, as in tp_canonical_record
__device__ __forceinline__ uint32_t tp_key_word(const uint32_t* packed, int RW, int s, int k,
                                                int m, bool rc) {
    const int left = k - 16 * m;  // chars of the k-mer in this word, if below 16
    const uint32_t keep = left >= 16 ? 0xffffffffu : 0xffffffffu << (32 - 2 * left);
    return (rc ? ~tp_chars16(packed, RW, s + k - 16 - 16 * m)
               : tp_rev2(tp_chars16(packed, RW, s + 16 * m))) & keep;
}

// The canonical k-mer of the window at char s (the lexicographic min of the
// strands; a palindrome is forward): its first W words into key, words W ..
// w-1 left to tp_key_word; is_rc: the reverse complement is canonical
template <int W>
__device__ __forceinline__ void tp_canonical_key(const uint32_t* packed, int RW, int s, int k,
                                                 int w, uint32_t* key, bool& is_rc) {
    uint32_t fw[W], rc[W];
#pragma unroll
    for (int m = 0; m < W; ++m) {
        fw[m] = tp_key_word(packed, RW, s, k, m, false);
        rc[m] = tp_key_word(packed, RW, s, k, m, true);
    }
    bool done = false;
    is_rc = false;
#pragma unroll
    for (int m = 0; m < W; ++m)
        if (!done && fw[m] != rc[m]) {
            is_rc = rc[m] < fw[m];
            done = true;
        }
    for (int m = W; !done && m < w; ++m) {
        const uint32_t f = tp_key_word(packed, RW, s, k, m, false);
        const uint32_t r = tp_key_word(packed, RW, s, k, m, true);
        if (f != r) {
            is_rc = r < f;
            done = true;
        }
    }
#pragma unroll
    for (int m = 0; m < W; ++m) key[m] = is_rc ? rc[m] : fw[m];
}

// ---- the Bloom engine's hashes (ops/buzhash.py probe_indices_from_sym),
// shared by bloom_fill.cu, bloom_mark.cu and bloom_shard.cu

// Kirsch-Mitzenmacher index j of an edge, mod 2^f: f <= 32 from the u32
// pair (e0, e1), f > 32 (f <= 63) from H1 = e2 << 32 | e0 and H2 = e3 << 32
// | e1 as one 64-bit multiply-add; the step H2 is made odd. The block
// layout's in-block bits are the f = 8 indices.
__device__ __forceinline__ uint64_t tp_km_index(const uint32_t* e,
                                                uint32_t j, int f) {
    if (f <= 32) {
        const uint32_t h = e[0] + j * (e[1] | 1u);
        return f == 32 ? h : (h & ((1u << f) - 1u));
    }
    const uint64_t h1 = ((uint64_t)e[2] << 32) | e[0];
    const uint64_t h2 = ((uint64_t)e[3] << 32) | e[1] | 1ull;
    return (h1 + (uint64_t)j * h2) & ((1ull << f) - 1ull);
}

// The Bloom layouts (ops/bloom.py)
constexpr int TP_LAYOUT_BYTE = 0;
constexpr int TP_LAYOUT_BIT = 1;
constexpr int TP_LAYOUT_BLOCK = 2;
constexpr int TP_BLOCK_WORDS = 8;  // a block: 256 bits

// A warp's candidate decisions into the packed mask (kernels.py:336
// pack_mask: 8 positions a byte, MSB first) and their count added to
// *count, one atomic a warp. Every lane of the warp calls it; lane l holds
// the decisions of a run of `run` (1, 2, 4 or 8) positions from x0 (bit s:
// position x0 + s), the warp's runs consecutive from a multiple of 8;
// live: the run lies in the batch (else bits is 0 and nothing is written).
// The 8 / run lanes of a byte OR their parts together by shuffles, and the
// first of them writes it.
__device__ __forceinline__ void tp_pack_runs(unsigned bits, int run, long long x0, bool live,
                                             uint8_t* __restrict__ mask,
                                             unsigned long long* __restrict__ count) {
    unsigned byte = (__brev(bits) >> 24) >> (x0 & 7);  // position x at bit 7 - (x & 7)
    for (int o = 1; o < 8 / run; o <<= 1) byte |= __shfl_xor_sync(0xffffffffu, byte, o);
    if (live && (x0 & 7) == 0) mask[x0 >> 3] = (uint8_t)byte;
    const unsigned c = __reduce_add_sync(0xffffffffu, (unsigned)__popc(bits));
    if ((threadIdx.x & 31) == 0 && c) atomicAdd(count, (unsigned long long)c);
}

// ---- one-sweep stable owner bucketing (bloom_shard.cu tp_shard_bucket,
// route.cu tp_route_records, partition.cu tp_partition_records with the
// round as the owner, and compact.cu tp_compact_append with one owner, the
// real rows): the items of a call, each owned by one of D shards or by
// none, go to (D, cap) send slots, each owner's in item order.
// A block takes the next tile of items from an atomic counter (so it only
// waits on tiles that started); then, barrier to barrier:
// - rank (tp_warp_rank): each warp ranks its contiguous part of the tile by
//   owner, stably: up to 32 owners a ballot an owner with lane d counting
//   owner d's, more (up to TP_ROUTE_MAX) match masks and u16 counters in
//   shared memory (the match path alone at D=4 took the slice's fill
//   bucketing from 17.9 to 25.3 ms, H100);
// - offsets (tp_tile_offsets): per owner the lower warps' counts and the
//   tile's total, the owners' runs in the tile, the totals published to u64
//   status words (value | flag);
// - the caller stages its items owner-major in shared memory;
// - look-back (tp_owner_lookback): a warp an owner reads the status words
//   of 32 earlier tiles at a time, back to the nearest inclusive prefix,
//   and publishes its own;
// - the caller stores each owner's run of the tile coalesced
//   (tp_run_owner: the owner of a staged slot), ranks past cap dropped;
// and a tail kernel (tp_owner_tail) clears each owner's slots past its
// count and counts the items past cap, from the last tile's prefixes.
// A status word is value (32 bits) | flag (2 bits) | epoch (30 bits); a
// word of another epoch reads as unpublished, so a scratch whose words
// carry each call's epoch needs no clearing between calls: the callers'
// last kernels reset the tile counter, and the wrappers keep one scratch a
// (device, stream, name) (kernels/build.py lookback_scratch; the route and
// the shard bucketing share theirs).

constexpr int TP_ROUTE_MAX = 4096;          // owners a call may bucket to
constexpr uint64_t TP_ST_AGG = 1ull << 32;   // the tile's own count
constexpr uint64_t TP_ST_INCL = 2ull << 32;  // ... the prefix over tiles 0 .. t
constexpr uint32_t TP_EPOCH_MASK = (1u << 30) - 1;

__device__ __forceinline__ uint64_t tp_status(uint64_t flag, uint32_t value,
                                              uint32_t epoch) {
    return flag | value | ((uint64_t)epoch << 34);
}

__device__ __forceinline__ bool tp_status_ready(uint64_t v, uint32_t epoch) {
    return ((v >> 32) & 3u) != 0 && (uint32_t)(v >> 34) == epoch;
}

// Stable in-warp ranks of a tile's items by owner: warp w takes items
// [w * wi, (w + 1) * wi) (wi a multiple of 32), 32 at a time, and lane l
// calls owner(it) once for its item it (>= D: none). s_rank[it] gets the
// item's rank among its warp's items of that owner, s_wc[w * D + d] the
// warp's count of owner d (u16, zeroed by the caller).
template <class Owner>
__device__ __forceinline__ void tp_warp_rank(int D, int wi, Owner owner,
                                             uint16_t* s_rank, uint16_t* s_wc) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int w0 = warp * wi;
    const unsigned lower = (1u << lane) - 1u;
    if (D <= 32) {
        uint32_t cnt = 0;  // lane d: the warp's owner-d items so far
        for (int sl = 0; sl < wi; sl += 32) {
            const int it = w0 + sl + lane;
            const uint32_t o = owner(it);
            unsigned peers = 0, mine = 0;
            for (int d = 0; d < D; ++d) {
                const unsigned b = __ballot_sync(0xffffffffu, o == (uint32_t)d);
                if (o == (uint32_t)d) peers = b;
                if (lane == d) mine = __popc(b);
            }
            const uint32_t before = __shfl_sync(0xffffffffu, cnt, o < (uint32_t)D ? o : 0);
            cnt += mine;
            s_rank[it] = (uint16_t)(before + __popc(peers & lower));
        }
        if (lane < D) s_wc[warp * D + lane] = (uint16_t)cnt;
    } else {
        uint16_t* wc = s_wc + warp * D;
        for (int sl = 0; sl < wi; sl += 32) {
            const int it = w0 + sl + lane;
            const uint32_t o = owner(it);
            const bool live = o < (uint32_t)D;
            // dead lanes get distinct non-owner keys and are never counted
            const unsigned peers = __match_any_sync(0xffffffffu, live ? o : (uint32_t)D + lane);
            uint32_t before = 0;
            if (live) before = wc[o];
            __syncwarp();
            if (live && (peers & lower) == 0) wc[o] = (uint16_t)(before + __popc(peers));
            __syncwarp();
            s_rank[it] = (uint16_t)(before + __popc(peers & lower));
        }
    }
}

// After tp_warp_rank and a barrier: s_wc[v * D + o] becomes owner o's count
// in the warps below v (in place), s_tot[o] the tile's count, s_tex[o] the
// offset of owner o's run in the tile (s_tex[D]: the tile's owned items);
// the totals are published as tile `tile`'s status (tile 0: its inclusive
// prefix). Every thread calls; ends with a barrier.
__device__ __forceinline__ void tp_tile_offsets(int D, size_t tile, uint32_t epoch,
                                                uint16_t* s_wc, uint32_t* s_tot,
                                                uint32_t* s_tex, uint32_t* s_scan,
                                                uint64_t* status) {
    const int nw = blockDim.x >> 5;
    for (int o = threadIdx.x; o < D; o += blockDim.x) {
        uint32_t c = 0;
        for (int v = 0; v < nw; ++v) {
            const uint32_t w = s_wc[v * D + o];
            s_wc[v * D + o] = (uint16_t)c;
            c += w;
        }
        s_tot[o] = c;
    }
    __syncthreads();
    uint32_t carry = 0;
    for (int o0 = 0; o0 < D; o0 += blockDim.x) {
        const int o = o0 + threadIdx.x;
        uint32_t total;
        const uint32_t ex = tp_block_excl_scan(o < D ? s_tot[o] : 0u, s_scan, total);
        if (o < D) s_tex[o] = carry + ex;
        carry += total;
    }
    if (threadIdx.x == 0) s_tex[D] = carry;
    for (int o = threadIdx.x; o < D; o += blockDim.x)
        tp_store_relaxed(status + tile * D + o,
                         tp_status(tile == 0 ? TP_ST_INCL : TP_ST_AGG, s_tot[o], epoch));
    __syncthreads();
}

// A warp an owner: s_dst[o] = owner o's items in the tiles before `tile`,
// and the tile's inclusive prefix published. Lane l reads the status of
// tile (tile - 1 - l) of a window of 32 earlier tiles; the window sums up
// to the nearest inclusive prefix, or moves 32 tiles back (tile 0 is
// always inclusive, so no window passes it). Every thread calls; the
// caller synchronises before reading s_dst.
__device__ __forceinline__ void tp_owner_lookback(int D, size_t tile, uint32_t epoch,
                                                  const uint32_t* s_tot, uint32_t* s_dst,
                                                  uint64_t* status) {
    const int lane = threadIdx.x & 31;
    for (int o = threadIdx.x >> 5; o < D; o += blockDim.x >> 5) {
        uint32_t excl = 0;
        if (tile != 0) {
            for (long long top = (long long)tile - 1;; top -= 32) {
                const long long t = top - lane;
                uint64_t v = 0;
                if (t >= 0) {
                    do {
                        v = tp_load_relaxed(status + (size_t)t * D + o);
                    } while (!tp_status_ready(v, epoch));
                }
                const unsigned incl = __ballot_sync(0xffffffffu, (v & TP_ST_INCL) != 0);
                const int stop = incl ? __ffs(incl) - 1 : 31;
                excl += __reduce_add_sync(0xffffffffu, lane <= stop ? (uint32_t)v : 0u);
                if (incl) break;
            }
            if (lane == 0)
                tp_store_relaxed(status + tile * D + o,
                                 tp_status(TP_ST_INCL, excl + s_tot[o], epoch));
        }
        if (lane == 0) s_dst[o] = excl;
    }
}

// One owner, a block-wide look-back (compact.cu's real rows, bloom_lookup.cu's
// hits): the tile's count own is published first (tile 0: as its inclusive
// prefix); then thread j reads the status word of tile top - j, TP_THREADS
// earlier tiles a round trip, and the block sums back to the nearest
// inclusive prefix. -> the count of the tiles before `tile`; the tile's
// inclusive prefix published. Every thread calls; ends with a barrier.
__device__ __forceinline__ uint32_t tp_block_lookback(uint64_t* status, uint32_t epoch,
                                                      size_t tile, uint32_t own,
                                                      uint32_t* s_scan, int* s_stop) {
    if (threadIdx.x == 0)
        tp_store_relaxed(status + tile, tp_status(tile == 0 ? TP_ST_INCL : TP_ST_AGG, own, epoch));
    uint32_t excl = 0;
    for (long long top = (long long)tile - 1; top >= 0; top -= TP_THREADS) {
        const long long t = top - threadIdx.x;
        uint64_t v = 0;
        if (t >= 0) {
            do {
                v = tp_load_relaxed(status + t);
            } while (!tp_status_ready(v, epoch));
        }
        if (threadIdx.x == 0) *s_stop = TP_THREADS;
        __syncthreads();
        if (v & TP_ST_INCL) atomicMin(s_stop, (int)threadIdx.x);
        __syncthreads();
        const int stop = *s_stop;
        uint32_t sum;
        tp_block_excl_scan((int)threadIdx.x <= stop ? (uint32_t)v : 0u, s_scan, sum);
        excl += sum;
        if (stop < TP_THREADS) break;
    }
    if (tile > 0 && threadIdx.x == 0)
        tp_store_relaxed(status + tile, tp_status(TP_ST_INCL, excl + own, epoch));
    __syncthreads();
    return excl;
}

// The owner whose run of the tile holds staged slot t (t < s_tex[D]): the
// last owner whose run starts at or before t
__device__ __forceinline__ int tp_run_owner(const uint32_t* s_tex, int D, uint32_t t) {
    int lo = 0, hi = D - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_tex[mid] <= t) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

// Block (chunk, owner d) of a tail kernel over (D, cap) send slots:
// clear(j) for every slot j = d * cap + c of owner d's row from its count
// (the value of the last tile's status word last[d]) to cap, `chunk` slots
// a block (a chunk below the count exits at once); block (0, d) adds owner
// d's items past cap to *overflow (null: not counted).
template <class Clear>
__device__ __forceinline__ void tp_owner_tail(const uint64_t* __restrict__ last,
                                              size_t cap, size_t chunk,
                                              unsigned long long* __restrict__ overflow,
                                              Clear clear) {
    const size_t d = blockIdx.y;
    const size_t tot = (uint32_t)last[d];
    if (overflow != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && tot > cap)
        atomicAdd(overflow, (unsigned long long)(tot - cap));
    const size_t c0 = (size_t)blockIdx.x * chunk;
    const size_t end = cap - c0 < chunk ? cap : c0 + chunk;
    for (size_t j = (tot > c0 ? tot : c0) + threadIdx.x; j < end; j += blockDim.x)
        clear(d * cap + j);
}

// ---- rolled strand hashes (bloom_shard.cu's bucketing and mark finish,
// histogram.cu, the Bloom fill and mark): the char tables T[4u + c] of
// tables u < nt in shared memory, never indexed out of the parameter space
// at run time

// Forward and reverse-complement Buzhash of the k-char window at char s
// under the first nt tables (N hashes as code 0):
//     hf = XOR_j rotl(T[c_{s+j}], k-1-j),  hr = XOR_j rotl(T[3-c_{s+j}], j)
__device__ __forceinline__ void tp_window_hashes(const TpRow& row, int s, int k,
                                                 int nt, const uint32_t* T,
                                                 uint32_t* hf, uint32_t* hr) {
#pragma unroll
    for (int u = 0; u < 4; ++u) hf[u] = hr[u] = 0;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
        const uint32_t c = row.code(s + j);
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (u < nt) {
                hf[u] ^= tp_rotl32(T[4 * u + c], (uint32_t)(k - 1 - j));
                hr[u] ^= tp_rotl32(T[4 * u + 3 - c], (uint32_t)j);
            }
    }
}

// ... rolled from the window at char s to the one at s + 1 (Tk: T rotated
// by k, Tk1: by k - 1): hf' = rotl(hf, 1) ^ rotl(T[out], k) ^ T[in] and
// its mirror for hr
__device__ __forceinline__ void tp_roll_hashes(const TpRow& row, int s, int k,
                                               int nt, const uint32_t* T,
                                               const uint32_t* Tk,
                                               const uint32_t* Tk1,
                                               uint32_t* hf, uint32_t* hr) {
    const uint32_t co = row.code(s);
    const uint32_t ci = row.code(s + k);
#pragma unroll
    for (int u = 0; u < 4; ++u)
        if (u < nt) {
            hf[u] = tp_rotl32(hf[u], 1u) ^ Tk[4 * u + co] ^ T[4 * u + ci];
            hr[u] = tp_rotl32(hr[u] ^ T[4 * u + 3 - co], 31u) ^ Tk1[4 * u + 3 - ci];
        }
}

// The highest N char among chars [lo, hi] of a row, or lo - 1 when none
__device__ __forceinline__ int tp_last_n(const TpRow& row, int lo, int hi) {
    for (int wi = hi >> 5; wi >= (lo >> 5); --wi) {
        const int a = max(lo - 32 * wi, 0);
        const int z = min(hi - 32 * wi, 31);
        const int len = z - a + 1;
        const uint32_t m = row.nmask[wi] & ((len == 32 ? 0xffffffffu : ((1u << len) - 1u)) << a);
        if (m) return 32 * wi + 31 - __clz(m);
    }
    return lo - 1;
}

// Strand-symmetric hash under table u of the out-edge V·c (out) or the
// in-edge c·V from V's strand hashes (ops/buzhash.py out_edge_sym,
// in_edge_sym; Tk: T rotated by k):
//     out (rotl(hf, 1) ^ T[c]) + (rotl(T[3-c], k) ^ hr),
//     in  (rotl(T[c], k) ^ hf) + (rotl(hr, 1) ^ T[3-c])
__device__ __forceinline__ uint32_t tp_edge_hash(uint32_t hf, uint32_t hr, const uint32_t* T,
                                                 const uint32_t* Tk, int u, bool out,
                                                 uint32_t c) {
    return out ? (tp_rotl32(hf, 1u) ^ T[4 * u + c]) + (Tk[4 * u + 3 - c] ^ hr)
               : (Tk[4 * u + c] ^ hf) + (tp_rotl32(hr, 1u) ^ T[4 * u + 3 - c]);
}

// ---- the Bloom engine's round kernels (bloom_fill.cu, bloom_mark.cu): one
// launch over a device table of batches (TpBatch rows)

// Positions a thread of a Bloom round kernel rolls along, at most
constexpr int TP_BLOOM_RUN = 8;

// The grid of a Bloom round kernel: (tiles, nb) blocks of TP_THREADS
// threads, tile x of batch y its TP_THREADS * run positions from x * tile,
// a thread `run` consecutive positions of one row (P % 8 == 0, so no run
// crosses a row). run: 8, halved (down to 1) while the call's threads
// would not give every SM 1024, so that a one-batch call still fills the
// card with loads in flight.
inline cudaError_t tp_bloom_grid(long long max_pos, int nb, int& run, dim3& grid) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    long long tiles = 0;
    for (run = TP_BLOOM_RUN;; run >>= 1) {
        tiles = (max_pos + TP_THREADS * run - 1) / (TP_THREADS * run);
        if (run == 1 || tiles * nb * TP_THREADS >= 1024ll * sms) break;
    }
    if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
    grid = dim3((unsigned)tiles, (unsigned)nb);
    return cudaSuccess;
}

// ---- cp.async (sm_80 on): a global -> shared copy that bypasses the
// registers; a thread's copies complete at tp_cp_async_wait_all (merge.cu
// stages its runs' windows with them)
template <int BYTES>
__device__ __forceinline__ void tp_cp_async(void* smem, const void* gmem) {
    static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(gmem), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void tp_cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// set() once a device and process (bit d of `ready` for devices 0 .. 63;
// past them every call): kernel attributes
template <class Set>
inline cudaError_t tp_once_per_device(std::atomic<uint64_t>& ready, Set set) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const uint64_t bit = dev < 64 ? 1ull << dev : 0;
    if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
    e = set();
    if (e == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
    return e;
}

// ---- the rolled record build (records.cu, partition.cu): for w = W <= 4
// (k <= 64) a thread takes a run of consecutive positions and rolls along
// them

// Shared-memory index of word x of a tile's staged records: skewed, so that
// stride-W * run stores hit distinct banks
__device__ __forceinline__ int tp_skew(int x) { return x + (x >> 5); }

// The k-mer words of a window as it rolls: fw MSB-first and left-aligned
// (char j of the window at bits 30 - 2*(j % 16) of word j / 16), rc its
// reverse complement in the same layout
template <int W>
struct TpWindow {
    uint32_t fw[W], rc[W];

    __device__ __forceinline__ void clear() {
#pragma unroll
        for (int m = 0; m < W; ++m) fw[m] = rc[m] = 0;
    }
    // c enters the window as its last char: fw shifts left (its first char
    // leaves), c goes to char k - 1 (word wl, shift sl); rc shifts right,
    // 3 - c goes to char 0, and the char pushed to char k is cleared (word
    // wk, mask mk; wk == W: none)
    __device__ __forceinline__ void push(uint32_t c, int wl, int sl, int wk, uint32_t mk) {
#pragma unroll
        for (int m = 0; m < W; ++m) {
            fw[m] = (fw[m] << 2) | (m + 1 < W ? fw[m + 1] >> 30 : 0u);
            if (m == wl) fw[m] |= c << sl;
        }
#pragma unroll
        for (int m = W - 1; m >= 0; --m) {
            rc[m] = (rc[m] >> 2) | (m > 0 ? rc[m - 1] << 30 : 0u);
            if (m == wk) rc[m] &= mk;
        }
        rc[0] |= (3u - c) << 30;
    }
    __device__ __forceinline__ bool rc_smaller() const {
        bool is_rc = false, done = false;
#pragma unroll
        for (int m = 0; m < W; ++m)
            if (!done && fw[m] != rc[m]) {
                is_rc = rc[m] < fw[m];
                done = true;
            }
        return is_rc;
    }
};

// The records of `steps` consecutive positions of a batch (rows of P
// positions: row r's upload form at packed + r * RW, nmask + r * NW) from
// flat position x0, rolled: the forward and reverse-complement words shift
// 2 bits a step in registers, the vertex hash rolls with the char tables
// in shared memory (s_T; s_Tk, s_Tk1: rotated by k, k - 1), the window's N
// test keeps the index of its last N, and each step reads two chars, prev
// (the char that leaves the window) and next (the char that enters it at
// the following step); a window is built from scratch at the run's first
// position and at each row start. Step s calls
//     emit(s, ok, h, is_rc, win, pay)
// ok: position x0 + s has a record (tp_position_ok); h: its vertex hash;
// win: its window, is_rc: the reverse complement is its canonical strand;
// pay: its record's payload with the real bit (meaningful when ok).
template <int W, class Emit>
__device__ __forceinline__ void tp_roll_records(const uint32_t* packed, const uint32_t* nmask,
                                                const int32_t* valid, long long RW,
                                                long long NW, int P, int k, long long x0,
                                                int steps, const uint32_t* s_T,
                                                const uint32_t* s_Tk, const uint32_t* s_Tk1,
                                                Emit emit) {
    const int wl = (k - 1) >> 4, sl = 30 - 2 * ((k - 1) & 15);
    const int wk = k >> 4;  // == W when char k lies past the words
    const uint32_t mk = ~(3u << (30 - 2 * (k & 15)));
    int r = (int)(x0 / P), i = (int)(x0 - (long long)r * P);
    TpWindow<W> win;
    uint32_t hf = 0, hr = 0, nx = 0;
    int last_n = -1;  // the window's last N char, or below it
    for (int s = 0; s < steps; ++s) {
        if (s > 0 && ++i == P) {
            i = 0;
            ++r;
        }
        const TpRow row{packed + (size_t)r * RW, nmask + (size_t)r * NW};
        const uint32_t pv = row.ext(i);
        if (s == 0 || i == 0) {  // chars i+1 .. i+k from scratch
            win.clear();
            hf = hr = 0;
            last_n = -1;
            for (int j = i + 1; j <= i + k; ++j) {
                const uint32_t c = row.code(j);
                if (row.is_n(j)) last_n = j;
                win.push(c, wl, sl, wk, mk);
                hf = tp_rotl32(hf, 1u) ^ s_T[c];
                hr = tp_rotl32(hr, 31u) ^ s_Tk1[3u - c];
            }
        } else {  // char i leaves, char i+k (the last step's next) enters
            const uint32_t co = pv < 4 ? pv : 0u;
            const uint32_t ci = nx < 4 ? nx : 0u;
            if (nx >= 4) last_n = i + k;
            win.push(ci, wl, sl, wk, mk);
            hf = tp_rotl32(hf, 1u) ^ s_Tk[co] ^ s_T[ci];
            hr = tp_rotl32(hr ^ s_T[3u - co], 31u) ^ s_Tk1[3u - ci];
        }
        nx = row.ext(i + k + 1);
        const bool is_rc = win.rc_smaller();
        const uint32_t in = is_rc ? tp_comp4(nx) : pv;
        const uint32_t out = is_rc ? tp_comp4(pv) : nx;
        emit(s, i < valid[r] && last_n <= i, hf + hr, is_rc, win,
             in | (out << 8) | ((uint32_t)is_rc << 16) | TP_REAL);
    }
}

}  // namespace
