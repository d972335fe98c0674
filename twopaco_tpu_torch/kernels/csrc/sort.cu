// Round sort: stable LSD radix sort of the records by the leading key_bits
// bits of their w k-mer words, carrying payload and position.
//
// Replaces twopaco_tpu/passes/sortpipe.py:365 sort_records (a lax.sort
// on the w key words, num_keys=w).
//
// Only the k-mer's bits are sorted (callers pass key_bits = 2k). A
// record's words hold its canonical k-mer MSB-first and left-aligned
// (common.cuh tp_canonical_record, used by records.cu, assemble.cu's
// blocks and bloom_extract.cu: char t at bits 30 - 2(t % 16) of word
// t / 16), so the 32w - 2k bits below the k-mer are zero in every real
// record and the order by the top 2k bits is the order by the whole
// words. The all-ones sentinel rows still sort last and apart: no
// canonical k-mer has its top 2k bits all ones (all ones is T...T, whose
// reverse complement A...A is smaller), so none ties with a sentinel
// under the cut. Other inputs (random words in the tests) are ordered by
// their top key_bits bits alone, stably; sort_records_plain masks the
// same bits, so the two agree on any input.
//
// Keys: for w <= 2 (k <= 31) one u64, w0 << 32 | w1 (w0 for w = 1),
// whose digits cover bits [32w - key_bits, 32w); for w > 2 one group of
// digit passes a word, from the last word to the first (LSD over words),
// the last word's only over its leading key_bits - 32(w-1) bits. 8-bit
// digits from the low end of each range: k = 25 takes 7 passes (8 over
// the whole u64), k = 101 takes 6 * 4 + 2 = 26.
//
// Design (Onesweep, Adinets and Merrill 2022). Blocks run in no order, so
// the cross-tile prefix is a decoupled look-back:
// - one upfront histogram kernel reads the keys once and counts the 256
//   digits of every pass in block-private shared-memory bins, flushed by
//   global atomics. A word's digits do not depend on the permutation, so
//   every pass's histogram (every word's, for w > 2) comes from the input
//   order. Each pass kernel takes its digit bases, the exclusive scan of
//   its 256 bins, at its start: no scan launch and no count table;
// - one kernel a digit pass. A block takes the next tile number from an
//   atomic counter (so it only ever waits on tiles that already started),
//   loads SORT_ITEMS keys a thread into registers and ranks them stably
//   inside the tile with warp match masks and warp-private digit counters
//   in shared memory (tile order: warp, key slot, lane). It publishes its
//   per-digit counts to a status array, then one thread a digit looks
//   back over the earlier tiles until an inclusive prefix and publishes
//   its own. Status words are u64: value (32 bits: m < 2^32) | flag (2
//   bits: the tile's count, or the inclusive prefix) | pass tag (30 bits),
//   so the array is zeroed once a call and no pass needs a memset. A digit
//   absent from the whole pass needs no look-back;
// - coalesced scatter: the tile's keys and values go to shared memory in
//   digit order, then consecutive threads write consecutive addresses of
//   each digit run, in place of one partial-sector store a record.
// What travels with the keys. For w <= 2 the whole record: the key is the
// record's words, and the payload (u32) and position (u64) are carried
// through every pass, so the last pass writes the sorted columns directly
// and there is no gather. A gather after the passes reads a 32-byte sector
// for each of a record's three 4-8 byte columns at random (8.1 ms of a
// 34.7 ms sort of the slice's 64.5 M records with one, H100), more than
// the 8 more sequential bytes a record and pass cost.
// For w > 2 the words do not fit a key: a word group's first pass reads
// word j through the permutation, a u32 index travels with the key, the
// last pass of a group writes only the permutation, and the record
// columns are gathered once at the end.
//
// Bound: bytes moved. At k = 25 (w = 2): the histogram reads 8 bytes a
// record, each of the 7 passes reads and writes 20 (key, payload,
// position): 288 bytes a record.
//
// tp_radix_sort_u64 runs the same passes over a bit range of bare u64
// keys (no index) for occ_pack.cu.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_ITEMS = 12;                      // keys a thread
constexpr int SORT_TILE = TP_THREADS * SORT_ITEMS;  // sort.py SORT_TILE
constexpr int WARP_KEYS = 32 * SORT_ITEMS;
constexpr int HIST_PASSES = 16;    // passes one histogram block counts
constexpr int HIST_BLOCKS = 1024;  // histogram blocks (grid-stride)
constexpr int MAX_PASSES = 4 * 64;  // w <= 64 (k <= 1023)
static_assert(TP_THREADS == RADIX, "one thread a digit");

constexpr uint32_t ST_AGG = 1;   // status flag: the tile's own count
constexpr uint32_t ST_INCL = 2;  // ... the prefix over tiles 0 .. t

__device__ __forceinline__ uint64_t st_word(uint32_t tag, uint32_t flag,
                                            uint32_t v) {
    return ((uint64_t)tag << 34) | ((uint64_t)flag << 32) | v;
}

// Where keys come from: bare u64 keys (SRC_KEYS), the two words of a w = 2
// record as w0 << 32 | w1 (SRC_PAIR: one 8-byte load, rows 8-byte
// aligned), or word j of a record of w words (SRC_WORD: w = 1, or a word
// group of w > 2)
constexpr int SRC_KEYS = 0;
constexpr int SRC_PAIR = 1;
constexpr int SRC_WORD = 2;

struct KeySrc {
    const uint64_t* keys;
    const uint32_t* words;
    int w;
};

template <int SRC>
__device__ __forceinline__ uint64_t load_key(const KeySrc& s, size_t r, int j) {
    if (SRC == SRC_KEYS) return s.keys[r];
    if (SRC == SRC_PAIR) {
        const uint2 v = reinterpret_cast<const uint2*>(s.words)[r];
        return ((uint64_t)v.x << 32) | v.y;
    }
    return s.words[r * (size_t)s.w + j];
}

// A call's digit passes in order: the key word j and the digit's shift
struct Plan {
    int n;
    uint16_t d[MAX_PASSES];  // j << 8 | shift

    __host__ __device__ int j(int p) const { return d[p] >> 8; }
    __host__ __device__ int shift(int p) const { return d[p] & 255; }
    void add(int j, int lo, int hi) {
        for (int s = lo; s < hi; s += RADIX_BITS)
            d[n++] = (uint16_t)((j << 8) | s);
    }
};

// The passes of a records sort (sort.py n_passes); false: out of range
bool plan_records(int w, int key_bits, Plan& pl) {
    pl.n = 0;
    if (w < 1 || w > 64 || key_bits < 1 || key_bits > 32 * w) return false;
    if (w <= 2) {
        pl.add(0, 32 * w - key_bits, 32 * w);
        return true;
    }
    for (int j = w - 1; j >= 0; --j)
        if (key_bits > 32 * j) pl.add(j, 32 - std::min(32, key_bits - 32 * j), 32);
    return true;
}

size_t sort_tiles(size_t n) { return (n + SORT_TILE - 1) / SORT_TILE; }

// Scratch: the status array (256 u64 a tile), the histograms (256 u32 a
// pass), the tile counters (one u32 a pass), in that order
size_t scratch_size(size_t n, int passes) {
    return sort_tiles(n) * RADIX * 8 + (size_t)passes * RADIX * 4 +
           ((size_t)passes * 4 + 7) / 8 * 8;
}

struct Scratch {
    uint64_t* status;
    uint32_t* hist;
    uint32_t* tiles;
};

// Lays out and zeroes the scratch; cudaErrorInvalidValue when it is short
cudaError_t take_scratch(void* scratch, size_t bytes, size_t n, int passes,
                         cudaStream_t st, Scratch& s) {
    const size_t need = scratch_size(n, passes);
    if (scratch == nullptr || bytes < need) return cudaErrorInvalidValue;
    char* p = (char*)scratch;
    s.status = (uint64_t*)p;
    s.hist = (uint32_t*)(p + sort_tiles(n) * RADIX * 8);
    s.tiles = s.hist + (size_t)passes * RADIX;
    return cudaMemsetAsync(scratch, 0, need, st);
}

// hist[p][d] += keys of digit d in pass p, for the passes of blockIdx.y's
// chunk of HIST_PASSES
template <int SRC>
__global__ void k_digit_hist(KeySrc src, size_t n, Plan pl,
                             uint32_t* __restrict__ hist) {
    __shared__ uint32_t h[HIST_PASSES][RADIX];
    __shared__ uint16_t s_d[HIST_PASSES];
    const int p0 = blockIdx.y * HIST_PASSES;
    const int np = min(HIST_PASSES, pl.n - p0);
    if ((int)threadIdx.x < np) s_d[threadIdx.x] = pl.d[p0 + threadIdx.x];
    for (int q = 0; q < HIST_PASSES; ++q) h[q][threadIdx.x] = 0;
    __syncthreads();
    const size_t stride = (size_t)gridDim.x * TP_THREADS;
    for (size_t i = (size_t)blockIdx.x * TP_THREADS + threadIdx.x; i < n;
         i += stride) {
        int jk = -1;
        uint64_t key = 0;
        for (int q = 0; q < np; ++q) {
            const int j = s_d[q] >> 8;
            if (j != jk) {
                key = load_key<SRC>(src, i, j);
                jk = j;
            }
            atomicAdd(&h[q][(key >> (s_d[q] & 255)) & (RADIX - 1)], 1u);
        }
    }
    __syncthreads();
    for (int q = 0; q < np; ++q) {
        const uint32_t c = h[q][threadIdx.x];
        if (c) atomicAdd(&hist[(size_t)(p0 + q) * RADIX + threadIdx.x], c);
    }
}

// What a digit pass carries beside its keys
constexpr int CARRY_NONE = 0;    // bare keys (tp_radix_sort_u64)
constexpr int CARRY_INDEX = 1;   // a: the record's index (w > 2)
constexpr int CARRY_RECORD = 2;  // a: payload, b: position (w <= 2)

template <int MODE>
constexpr size_t stage_bytes() {
    return (size_t)SORT_TILE *
           (8 + (MODE != CARRY_NONE ? 4 : 0) + (MODE == CARRY_RECORD ? 8 : 0));
}

struct PassArgs {
    KeySrc src;  // the keys: load_key<SRC>(src, r, j) of record r (i, or
    int j, shift;  // for INDEX's SRC_WORD r = a_in[i] when a_in is set)
    const uint32_t* a_in;
    const uint64_t* b_in;
    void* key_out;  // null: keys not written (a word group's last pass)
    int key_words;  // 0: u64 keys; 1, 2: the records' (n, key_words) words
    uint32_t* a_out;
    uint64_t* b_out;
    size_t n;
    const uint32_t* hist;  // the pass's 256 digit counts
    uint64_t* status;      // sort_tiles(n) x 256
    uint32_t* tile_ctr;
    uint32_t tag;  // the pass's number in the call
};

template <int MODE, int SRC>
__global__ void __launch_bounds__(TP_THREADS, 3) k_onesweep(PassArgs a) {
    // the tile staged in digit order: keys, then b (RECORD), then a
    extern __shared__ __align__(16) unsigned char s_stage[];
    uint64_t* s_key = (uint64_t*)s_stage;
    uint64_t* s_b = s_key + SORT_TILE;
    uint32_t* s_a = (uint32_t*)(s_key + (MODE == CARRY_RECORD ? 2 : 1) * SORT_TILE);
    __shared__ uint32_t s_wc[TP_WARPS][RADIX];  // counts, then prefixes
    __shared__ uint32_t s_tex[RADIX];  // the digit's first slot in the tile
    __shared__ uint32_t s_dst[RADIX];  // ... and in the output
    __shared__ uint32_t s_scan[TP_WARPS];
    __shared__ uint32_t s_tile;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(a.tile_ctr, 1u);
    for (int v = 0; v < TP_WARPS; ++v) s_wc[v][tid] = 0;
    __syncthreads();
    const size_t tile = s_tile;
    const size_t base = tile * SORT_TILE + (size_t)warp * WARP_KEYS + lane;
    constexpr bool src_index = MODE == CARRY_INDEX && SRC == SRC_WORD;

    uint64_t kk[SORT_ITEMS];
    uint32_t rk[SORT_ITEMS];  // rank in the warp's digit, then tile slot
    uint32_t rr[SORT_ITEMS];  // src_index: the record
#pragma unroll
    for (int it = 0; it < SORT_ITEMS; ++it) {
        const size_t i = base + (size_t)it * 32;
        kk[it] = 0;
        rr[it] = 0;
        if (i >= a.n) continue;
        if (src_index) {
            rr[it] = a.a_in != nullptr ? a.a_in[i] : (uint32_t)i;
            kk[it] = load_key<SRC>(a.src, rr[it], a.j);
        } else {
            kk[it] = load_key<SRC>(a.src, i, a.j);
        }
    }
    // stable ranks within the warp's digit: keys of lower slots, then of
    // lower lanes of the same slot
    const unsigned lower_lanes = (1u << lane) - 1u;
#pragma unroll
    for (int it = 0; it < SORT_ITEMS; ++it) {
        const bool live = base + (size_t)it * 32 < a.n;
        // dead lanes share a non-digit and are never counted or written
        const uint32_t d =
            live ? (uint32_t)(kk[it] >> a.shift) & (RADIX - 1) : RADIX;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        uint32_t before = 0;
        if (live) before = s_wc[warp][d];
        __syncwarp();
        if (live && (peers & lower_lanes) == 0)
            s_wc[warp][d] = before + __popc(peers);
        __syncwarp();
        rk[it] = before + __popc(peers & lower_lanes);
    }
    __syncthreads();

    // thread tid is digit tid: the lower warps' counts, the tile's count
    uint32_t cnt = 0;
    for (int v = 0; v < TP_WARPS; ++v) {
        const uint32_t c = s_wc[v][tid];
        s_wc[v][tid] = cnt;
        cnt += c;
    }
    const uint32_t total = a.hist[tid];
    const bool alone = tile == 0 || total == 0;  // no look-back needed
    uint64_t* mine = a.status + tile * RADIX + tid;
    tp_store_relaxed(mine, st_word(a.tag, alone ? ST_INCL : ST_AGG, cnt));
    const uint32_t tex = tp_block_excl_scan(cnt, s_scan);
    const uint32_t gbase = tp_block_excl_scan(total, s_scan);
    s_tex[tid] = tex;
    __syncthreads();

    // the tile in digit order into shared memory: keys (and src_index's
    // records) from registers, then the carried values from global memory
#pragma unroll
    for (int it = 0; it < SORT_ITEMS; ++it) {
        if (base + (size_t)it * 32 >= a.n) continue;
        const uint32_t d = (uint32_t)(kk[it] >> a.shift) & (RADIX - 1);
        rk[it] += s_tex[d] + s_wc[warp][d];
        s_key[rk[it]] = kk[it];
        if (src_index) s_a[rk[it]] = rr[it];
    }
    if (MODE != CARRY_NONE && !src_index) {
        uint32_t va[SORT_ITEMS];
#pragma unroll
        for (int it = 0; it < SORT_ITEMS; ++it) {
            const size_t i = base + (size_t)it * 32;
            va[it] = i < a.n ? a.a_in[i] : 0;
        }
#pragma unroll
        for (int it = 0; it < SORT_ITEMS; ++it)
            if (base + (size_t)it * 32 < a.n) s_a[rk[it]] = va[it];
    }
    if (MODE == CARRY_RECORD) {
        uint64_t vb[SORT_ITEMS];
#pragma unroll
        for (int it = 0; it < SORT_ITEMS; ++it) {
            const size_t i = base + (size_t)it * 32;
            vb[it] = i < a.n ? a.b_in[i] : 0;
        }
#pragma unroll
        for (int it = 0; it < SORT_ITEMS; ++it)
            if (base + (size_t)it * 32 < a.n) s_b[rk[it]] = vb[it];
    }

    // decoupled look-back: the digit's keys in tiles 0 .. tile-1
    uint32_t excl = 0;
    if (!alone) {
        for (size_t t = tile - 1;; --t) {
            const uint64_t* p = a.status + t * RADIX + tid;
            uint64_t s;
            uint32_t flag;
            do {
                s = tp_load_relaxed(p);
                flag = (uint32_t)(s >> 32) & 3u;
            } while ((uint32_t)(s >> 34) != a.tag || flag == 0);
            excl += (uint32_t)s;
            if (flag == ST_INCL) break;
        }
        tp_store_relaxed(mine, st_word(a.tag, ST_INCL, excl + cnt));
    }
    s_dst[tid] = gbase + excl;
    __syncthreads();

    // consecutive threads write consecutive slots of each digit's run
    const size_t left = a.n - tile * SORT_TILE;
    const uint32_t tile_n = left < SORT_TILE ? (uint32_t)left : SORT_TILE;
    for (uint32_t t = tid; t < tile_n; t += TP_THREADS) {
        const uint64_t key = s_key[t];
        const uint32_t d = (uint32_t)(key >> a.shift) & (RADIX - 1);
        const size_t dst = (size_t)s_dst[d] + (t - s_tex[d]);
        if (a.key_out != nullptr) {
            if (a.key_words == 0)
                ((uint64_t*)a.key_out)[dst] = key;
            else if (a.key_words == 2)  // words w0 = key >> 32, w1 = key
                ((uint64_t*)a.key_out)[dst] = (key << 32) | (key >> 32);
            else
                ((uint32_t*)a.key_out)[dst] = (uint32_t)key;
        }
        if (MODE != CARRY_NONE) a.a_out[dst] = s_a[t];
        if (MODE == CARRY_RECORD) a.b_out[dst] = s_b[t];
    }
}

__global__ void k_gather(const uint32_t* __restrict__ words,
                         const uint32_t* __restrict__ pay,
                         const long long* __restrict__ pos,
                         const uint32_t* __restrict__ idx, size_t n, int w,
                         uint32_t* __restrict__ out_words,
                         uint32_t* __restrict__ out_pay,
                         long long* __restrict__ out_pos) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t src = idx[i];
    for (int j = 0; j < w; ++j) out_words[i * w + j] = words[src * w + j];
    out_pay[i] = pay[src];
    out_pos[i] = pos[src];
}

template <int SRC>
cudaError_t launch_hist(const KeySrc& src, size_t n, const Plan& pl,
                        uint32_t* hist, cudaStream_t st) {
    const dim3 grid(std::min<unsigned>(tp_blocks(n, TP_THREADS), HIST_BLOCKS),
                    (unsigned)((pl.n + HIST_PASSES - 1) / HIST_PASSES));
    k_digit_hist<SRC><<<grid, TP_THREADS, 0, st>>>(src, n, pl, hist);
    return cudaGetLastError();
}

template <int MODE, int SRC>
cudaError_t launch_pass(PassArgs& a, const Scratch& s, int p,
                        cudaStream_t st) {
    a.hist = s.hist + (size_t)p * RADIX;
    a.status = s.status;
    a.tile_ctr = s.tiles + p;
    a.tag = (uint32_t)p;
    constexpr size_t smem = stage_bytes<MODE>();
    const cudaError_t e = cudaFuncSetAttribute(
        k_onesweep<MODE, SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    k_onesweep<MODE, SRC><<<(unsigned)sort_tiles(a.n), TP_THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" size_t tp_sort_scratch_bytes(size_t n, int passes) {
    return scratch_size(n, passes);
}

int tp_radix_passes(int lo, int hi) {
    return hi > lo ? (hi - lo + RADIX_BITS - 1) / RADIX_BITS : 0;
}

// Stable sort of n u64 keys by bits [lo, hi) (0 <= lo <= hi <= 64) over
// tp_radix_passes(lo, hi) passes, alternating between key and key_alt:
// the result is in key after an even count, in key_alt after an odd one.
cudaError_t tp_radix_sort_u64(uint64_t* key, uint64_t* key_alt, size_t n,
                              int lo, int hi, void* scratch,
                              size_t scratch_bytes, cudaStream_t st) {
    if (lo < 0 || hi > 64 || lo > hi) return cudaErrorInvalidValue;
    Plan pl;
    pl.n = 0;
    pl.add(0, lo, hi);
    if (n == 0 || pl.n == 0) return cudaSuccess;
    Scratch s;
    cudaError_t e = take_scratch(scratch, scratch_bytes, n, pl.n, st, s);
    if (e != cudaSuccess) return e;
    e = launch_hist<SRC_KEYS>(KeySrc{key, nullptr, 0}, n, pl, s.hist, st);
    if (e != cudaSuccess) return e;
    uint64_t* buf[2] = {key, key_alt};
    for (int p = 0; p < pl.n; ++p) {
        PassArgs a{};
        a.src.keys = buf[p & 1];
        a.shift = pl.shift(p);
        a.key_out = buf[(p & 1) ^ 1];
        a.n = n;
        e = launch_pass<CARRY_NONE, SRC_KEYS>(a, s, p, st);
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

// Sort n records (words (n, w) u32, pay u32, pos int64) by the leading
// key_bits bits of their words (1 <= key_bits <= 32w, w <= 64) into
// (out_words, out_pay, out_pos). Scratch (sized by the caller, sort.py
// work_bytes): key, key_alt (n u64); for w <= 2 va, va_alt (n u32) and vb,
// vb_alt (n u64), the payloads and positions carried through the passes;
// for w > 2 va, va_alt hold the permutation (vb unused, may be null); and
// scratch of scratch_bytes >= tp_sort_scratch_bytes(n, passes) bytes.
extern "C" int tp_sort_records(const void* words, const void* pay,
                               const void* pos, size_t n, int w, int key_bits,
                               void* key, void* key_alt, void* va,
                               void* va_alt, void* vb, void* vb_alt,
                               void* scratch, size_t scratch_bytes,
                               void* out_words, void* out_pay, void* out_pos,
                               void* stream) {
    Plan pl;
    if (!plan_records(w, key_bits, pl)) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    Scratch s;
    cudaError_t e = take_scratch(scratch, scratch_bytes, n, pl.n, st, s);
    if (e != cudaSuccess) return (int)e;
    const uint32_t* wd = (const uint32_t*)words;
    if (w == 2 && (uintptr_t)wd % 8 != 0) return (int)cudaErrorInvalidValue;
    const KeySrc src{nullptr, wd, w};
    e = w == 2 ? launch_hist<SRC_PAIR>(src, n, pl, s.hist, st)
               : launch_hist<SRC_WORD>(src, n, pl, s.hist, st);
    if (e != cudaSuccess) return (int)e;
    uint64_t* kb[2] = {(uint64_t*)key, (uint64_t*)key_alt};
    uint32_t* ab[2] = {(uint32_t*)va, (uint32_t*)va_alt};
    uint64_t* bb[2] = {(uint64_t*)vb, (uint64_t*)vb_alt};
    if (w <= 2) {
        // the whole record travels: the key is its words
        for (int p = 0; p < pl.n; ++p) {
            const bool last = p + 1 == pl.n;
            const int o = p & 1;  // the buffers this pass writes
            PassArgs a{};
            a.src = p == 0 ? src : KeySrc{kb[o ^ 1], nullptr, 0};
            a.shift = pl.shift(p);
            a.a_in = p == 0 ? (const uint32_t*)pay : ab[o ^ 1];
            a.b_in = p == 0 ? (const uint64_t*)pos : bb[o ^ 1];
            a.key_out = last ? out_words : (void*)kb[o];
            a.key_words = last ? w : 0;
            a.a_out = last ? (uint32_t*)out_pay : ab[o];
            a.b_out = last ? (uint64_t*)out_pos : bb[o];
            a.n = n;
            e = p > 0 ? launch_pass<CARRY_RECORD, SRC_KEYS>(a, s, p, st)
                : w == 2 ? launch_pass<CARRY_RECORD, SRC_PAIR>(a, s, p, st)
                         : launch_pass<CARRY_RECORD, SRC_WORD>(a, s, p, st);
            if (e != cudaSuccess) return (int)e;
        }
        return 0;
    }
    uint64_t* keys = nullptr;        // the word group's keys so far
    const uint32_t* perm = nullptr;  // the permutation so far (null: none)
    for (int p = 0; p < pl.n; ++p) {
        const bool first = p == 0 || pl.j(p) != pl.j(p - 1);
        const bool last = p + 1 == pl.n || pl.j(p + 1) != pl.j(p);
        PassArgs a{};
        a.src = first ? src : KeySrc{keys, nullptr, 0};
        a.j = pl.j(p);
        a.shift = pl.shift(p);
        a.a_in = perm;
        uint64_t* kout = keys == kb[0] ? kb[1] : kb[0];
        a.key_out = last ? nullptr : kout;
        a.a_out = perm == ab[0] ? ab[1] : ab[0];
        a.n = n;
        e = first ? launch_pass<CARRY_INDEX, SRC_WORD>(a, s, p, st)
                  : launch_pass<CARRY_INDEX, SRC_KEYS>(a, s, p, st);
        if (e != cudaSuccess) return (int)e;
        keys = last ? nullptr : kout;
        perm = a.a_out;
    }
    k_gather<<<tp_blocks(n, TP_THREADS), TP_THREADS, 0, st>>>(
        wd, (const uint32_t*)pay, (const long long*)pos, perm, n, w,
        (uint32_t*)out_words, (uint32_t*)out_pay, (long long*)out_pos);
    return (int)cudaGetLastError();
}
