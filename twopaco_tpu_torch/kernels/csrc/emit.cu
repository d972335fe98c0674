// Emit: the junction list's 12-byte records built on the card from a
// packed merge's position-sorted occurrence keys.
//
// Replaces no TPU kernel: the JAX package fetches the keys and its host
// emit (twopaco_tpu/passes/pipeline.py:462, with ChunkWriter) decodes and
// assembles the records, walking ~127 M keys at the benchmark's size.
// Here the keys never leave the card:
//
//   tp_emit_check  one launch: the keys' faults counted (id 0, |id| past
//                  the table, a position outside its row's valid
//                  positions, keys not ascending), the lower bound of each
//                  of the host's query positions (the stubs' presence test
//                  and the rows' occurrence counts) and the keys at a few
//                  indices (the chunks' edges);
//   tp_emit_chunk  one launch a chunk: occurrences [i0, i1) written as
//                  records into the chunk's slots [s0, s1), with the
//                  host's gap records (stubs, separators) in the same range.
//
// key = flat << id_bits | (signed id + 2^(id_bits-1)), flat = row * P +
// col. Record slot of occurrence i: i + rows[row].base, where the host sets
// base = the row's sequence id (the separators before it) + the stubs at or
// before the row's first position; the record is (pos u32 = rows[row].pos
// + col, id i64). No scan: each occurrence's place is closed-form.
//
// Bound: bytes moved. The check reads each key once (8 B) and writes a few
// words; a chunk reads 8 B and writes 12 B an occurrence: the benchmark's
// ~127.3 M occurrences, 2.55 GB, ~0.76 ms at 3.35 TB/s.
// Design: the check is a grid-stride pass with coalesced 8-byte loads and
// one block reduction of four counters (atomics once a block); its query
// blocks run beside it (a binary search a thread). A chunk block takes
// 2048 occurrences with coalesced key loads, stages their records (and
// the gap records among them) in shared memory at the output's 16-byte
// phase, and stores the span with aligned 16-byte stores (4-byte stores at
// its two ends), so the 12-byte records leave in whole sectors. A block's
// span is [slot of its first occurrence's predecessor + 1, slot of its last
// + 1): the blocks of a chunk tile its slots exactly. A span wider than
// the stage (many stubs or separators between two occurrences) is written
// with 4-byte stores instead.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int EMIT_TILE = 2048;  // occurrences a chunk block
constexpr int EMIT_CAP = EMIT_TILE + 128;  // record slots a block stages
constexpr int EMIT_CHECK_PER_THREAD = 8;  // keys a check thread, a sweep

struct KeyLayout {
    int id_bits;
    int P;
    int p_shift;  // log2 P, or -1 when P is not a power of two

    __device__ __forceinline__ unsigned long long flat(unsigned long long key) const {
        return key >> id_bits;
    }
    __device__ __forceinline__ long long id(unsigned long long key) const {
        const unsigned long long mask = (1ull << id_bits) - 1ull;
        return (long long)(key & mask) - (1ll << (id_bits - 1));
    }
    __device__ __forceinline__ void row_col(unsigned long long f, long long& row,
                                            long long& col) const {
        if (p_shift >= 0) {
            row = (long long)(f >> p_shift);
            col = (long long)(f & (unsigned long long)(P - 1));
        } else {
            row = (long long)(f / (unsigned long long)P);
            col = (long long)f - row * P;
        }
    }
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// the first index of keys[0, n) whose key is >= want (keys ascending)
__device__ __forceinline__ long long lower_bound_u64(const unsigned long long* keys,
                                                     long long n, unsigned long long want) {
    long long lo = 0, hi = n;
    while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (__ldg(keys + mid) < want) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ long long lower_bound_i64(const long long* v, long long n,
                                                     long long want) {
    long long lo = 0, hi = n;
    while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (__ldg(v + mid) < want) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(TP_THREADS) k_emit_check(
    const unsigned long long* __restrict__ keys, long long n, KeyLayout lay,
    long long n_table, const int32_t* __restrict__ valid, long long n_rows,
    const long long* __restrict__ queries, long long nq, long long* __restrict__ lower,
    long long* __restrict__ hit, const long long* __restrict__ at, long long na,
    long long* __restrict__ at_keys, unsigned long long* __restrict__ faults, int check_blocks) {
    if ((int)blockIdx.x >= check_blocks) {
        const long long t = (long long)(blockIdx.x - check_blocks) * blockDim.x + threadIdx.x;
        if (t < nq) {
            const unsigned long long q = (unsigned long long)queries[t];
            const long long lo = lower_bound_u64(keys, n, q << lay.id_bits);
            lower[t] = lo;
            hit[t] = lo < n && lay.flat(keys[lo]) == q;
        } else if (t < nq + na) {
            const long long i = at[t - nq];
            at_keys[t - nq] = i >= 0 && i < n ? (long long)keys[i] : 0ll;
        }
        return;
    }
    long long past = 0, zero = 0, pos = 0, order = 0;
    const long long stride = (long long)check_blocks * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const unsigned long long key = keys[i];
        const long long id = lay.id(key);
        past += llabs(id) > n_table;
        zero += id == 0;
        long long row, col;
        lay.row_col(lay.flat(key), row, col);
        pos += row >= n_rows || col >= (long long)__ldg(valid + row);
        order += i + 1 < n && keys[i + 1] <= key;
    }
    __shared__ long long part[4][TP_WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    past = warp_sum(past);
    zero = warp_sum(zero);
    pos = warp_sum(pos);
    order = warp_sum(order);
    if (lane == 0) {
        part[0][warp] = past;
        part[1][warp] = zero;
        part[2][warp] = pos;
        part[3][warp] = order;
    }
    __syncthreads();
    if (threadIdx.x < 4) {
        long long s = 0;
#pragma unroll
        for (int w = 0; w < TP_WARPS; ++w) s += part[threadIdx.x][w];
        if (s) atomicAdd(faults + threadIdx.x, (unsigned long long)s);
    }
}

// occurrence i's slot and its record's three words
__device__ __forceinline__ long long occ_record(unsigned long long key, long long i,
                                                const long long* __restrict__ rows,
                                                const KeyLayout& lay, uint32_t w[3]) {
    long long row, col;
    lay.row_col(lay.flat(key), row, col);
    const long long id = lay.id(key);
    w[0] = (uint32_t)__ldg(rows + 2 * row + 1) + (uint32_t)col;
    w[1] = (uint32_t)(unsigned long long)id;
    w[2] = (uint32_t)((unsigned long long)id >> 32);
    return i + __ldg(rows + 2 * row);
}

__device__ __forceinline__ long long occ_slot(unsigned long long key, long long i,
                                              const long long* __restrict__ rows,
                                              const KeyLayout& lay) {
    long long row, col;
    lay.row_col(lay.flat(key), row, col);
    return i + __ldg(rows + 2 * row);
}

// the block's occurrences [a, e) and its gap records from g0 (slots
// below hi), each record at dst + 3 * (slot - origin)
__device__ __forceinline__ void place_records(
    const unsigned long long* __restrict__ keys, long long a, long long e,
    const long long* __restrict__ rows, const long long* __restrict__ gap_slots,
    const uint32_t* __restrict__ gap_recs, long long n_gaps, long long g0, long long hi,
    const KeyLayout& lay, uint32_t* dst, long long origin) {
    for (long long i = a + threadIdx.x; i < e; i += blockDim.x) {
        uint32_t w[3];
        uint32_t* d = dst + 3 * (occ_record(keys[i], i, rows, lay, w) - origin);
        d[0] = w[0];
        d[1] = w[1];
        d[2] = w[2];
    }
    for (long long g = g0 + threadIdx.x; g < n_gaps; g += blockDim.x) {
        const long long slot = __ldg(gap_slots + g);
        if (slot >= hi) break;
        uint32_t* d = dst + 3 * (slot - origin);
        d[0] = __ldg(gap_recs + 3 * g);
        d[1] = __ldg(gap_recs + 3 * g + 1);
        d[2] = __ldg(gap_recs + 3 * g + 2);
    }
}

__global__ void __launch_bounds__(TP_THREADS) k_emit_chunk(
    const unsigned long long* __restrict__ keys, long long i0, long long i1, long long s0,
    long long s1, const long long* __restrict__ rows, const long long* __restrict__ gap_slots,
    const uint32_t* __restrict__ gap_recs, long long n_gaps, KeyLayout lay,
    uint32_t* __restrict__ out) {
    __shared__ __align__(16) uint32_t stage[3 * EMIT_CAP + 4];
    __shared__ long long s_lo, s_hi, s_gap;
    const long long a = i0 + (long long)blockIdx.x * EMIT_TILE;
    const long long e = min(a + (long long)EMIT_TILE, i1);
    if (threadIdx.x == 0) {
        const long long lo = a > i0 ? occ_slot(keys[a - 1], a - 1, rows, lay) + 1 : s0;
        s_lo = lo;
        s_hi = e < i1 ? occ_slot(keys[e - 1], e - 1, rows, lay) + 1 : s1;
        s_gap = lower_bound_i64(gap_slots, n_gaps, lo);
    }
    __syncthreads();
    const long long lo = s_lo, hi = s_hi;
    const bool staged = hi - lo <= EMIT_CAP;
    const long long w0 = 3 * (lo - s0), w1 = 3 * (hi - s0);  // the span's words
    const int shift = (int)(w0 & 3);  // stage word shift + j is output word w0 + j
    // each call inlined on its own pointer: global stores, or shared ones
    if (!staged) {
        place_records(keys, a, e, rows, gap_slots, gap_recs, n_gaps, s_gap, hi, lay, out, s0);
        return;
    }
    place_records(keys, a, e, rows, gap_slots, gap_recs, n_gaps, s_gap, hi, lay,
                  stage + shift, lo);
    __syncthreads();
    // words [w0, a4) and [b4, w1) one at a time, [a4, b4) 16 bytes a store
    const long long a4 = (w0 + 3) & ~3ll;
    const long long head_end = min(a4, w1);
    const long long b4 = max(a4, w1 & ~3ll);
    const int t = threadIdx.x;
    if (t < head_end - w0) out[w0 + t] = stage[shift + t];
    const long long tail0 = max(head_end, b4);
    if (t < w1 - tail0) out[tail0 + t] = stage[shift + (tail0 - w0) + t];
    for (long long q = a4 + 4ll * t; q < b4; q += 4ll * blockDim.x)
        *reinterpret_cast<uint4*>(out + q) =
            *reinterpret_cast<const uint4*>(stage + shift + (q - w0));
}

int log2_exact(int P) {
    return P > 0 && (P & (P - 1)) == 0 ? __builtin_ctz((unsigned)P) : -1;
}

bool layout_ok(int id_bits, int P) { return id_bits >= 2 && id_bits <= 62 && P >= 1; }

}  // namespace

// keys: n u64 (ascending unless faulty); valid: n_rows int32, the rows'
// valid positions; queries: nq int64 flat positions, lower/hit: nq int64
// out; at: na int64 key indices, at_keys: na int64 out (0 past the keys);
// faults: 4 u64 (|id| past n_table, id 0, position outside its row's
// valid positions, a key not above its predecessor), zeroed by the caller.
extern "C" int tp_emit_check(const void* keys, long long n, int id_bits, long long n_table,
                             int P, const void* valid, long long n_rows, const void* queries,
                             long long nq, void* lower, void* hit, const void* at,
                             long long na, void* at_keys, void* faults, void* stream) {
    if (!layout_ok(id_bits, P) || n < 0 || nq < 0 || na < 0 || n_rows < 0)
        return (int)cudaErrorInvalidValue;
    const KeyLayout lay{id_bits, P, log2_exact(P)};
    const int check_blocks = n > 0 ? (int)std::min<size_t>(
        tp_blocks((size_t)n, (size_t)TP_THREADS * EMIT_CHECK_PER_THREAD), 132 * 16) : 0;
    const unsigned blocks = (unsigned)check_blocks + tp_blocks((size_t)(nq + na), TP_THREADS);
    if (blocks == 0) return 0;
    k_emit_check<<<blocks, TP_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)keys, n, lay, n_table, (const int32_t*)valid, n_rows,
        (const long long*)queries, nq, (long long*)lower, (long long*)hit,
        (const long long*)at, na, (long long*)at_keys, (unsigned long long*)faults,
        check_blocks);
    return (int)cudaGetLastError();
}

// One chunk: occurrences [i0, i1) of keys and the gap records (n_gaps
// slots int64 ascending, 3 u32 words each) with a slot in [s0, s1), as
// records into out (3 * (s1 - s0) u32 words, 16-byte aligned). rows:
// n_rows x 2 int64 (slot base, position base).
extern "C" int tp_emit_chunk(const void* keys, long long i0, long long i1, long long s0,
                             long long s1, const void* rows, const void* gap_slots,
                             const void* gap_recs, long long n_gaps, int P, int id_bits,
                             void* out, void* stream) {
    if (!layout_ok(id_bits, P) || i0 < 0 || i1 < i0 || s1 < s0 || n_gaps < 0 ||
        (uintptr_t)out % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (s1 == s0) return 0;
    const KeyLayout lay{id_bits, P, log2_exact(P)};
    const unsigned blocks = std::max(1u, tp_blocks((size_t)(i1 - i0), EMIT_TILE));
    k_emit_chunk<<<blocks, TP_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)keys, i0, i1, s0, s1, (const long long*)rows,
        (const long long*)gap_slots, (const uint32_t*)gap_recs, n_gaps, lay, (uint32_t*)out);
    return (int)cudaGetLastError();
}
