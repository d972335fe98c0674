// Bloom fill: insert the canonical edges of every vertex position of a
// round's window batches into the filter (pass 1 of the Bloom engine), one
// launch a call.
//
// Replaces twopaco_tpu/passes/kernels.py:257 pass1_fill: the indices of
// :130 fill_indices (byte, bit) and :179 fill_indices_block (block), set
// by ops/bloom.py:89 fill and :165 fill_blocks.
//
// Position i of row r of a batch (vertex V, chars i+1 .. i+k) inserts,
// when it lies inside the row's valid count and V holds no N:
//   byte, bit (gated on V's or V_next's vertex hash in [low, high], V_next
//   counting only when its window holds no N):
//     the out-edge V·next (V·A when next is N), and the dummy edges V·T
//     when next is N, A·V and T·V when prev is N; each edge sets its q
//     Kirsch-Mitzenmacher slots (tables 1-2, or 1-4 when f > 32);
//   block (256-bit block keyed by the low f-8 bits of a vertex hash, q
//   in-block bits from the edge hashes of tables 1-2):
//     V·next (or V·A) into block(V) when V is in [low, high], and into
//     block(V_next) when next is ACGT and V_next is in [low, high]; the
//     dummy edges as above into block(V) when V is in [low, high].
//
// Bound: the filter's traffic, each distinct 32-byte sector that the
// inserts touch read once and written once (at most the whole filter, up to
// 4 GiB), and the upload form; the hashes are a few dozen integer
// operations a position. Design: block (x, y) takes tile x of batch y (row
// y of the batch table); a thread rolls along a run of up to 8 consecutive
// positions of one row: the strand hashes of the run's first window from
// scratch, then one char a step with the char tables in shared memory, so
// V_next's vertex hash is the next step's; the window's last N is kept, so
// the N tests are compares. An insert first loads every slot (or block) it
// sets, all q loads of an edge in flight together, and then stores only
// where a slot reads clear (byte store, or atomicOr of the bit); in a run
// over related genomes most edges are already in the filter, and a read of
// a random sector costs less than its read-modify-write. The block layout
// ORs a position's bits for block(V) in registers, with the real edge that
// the position before sent to the same block (its V_next is this V), and
// reads the block once and atomicOrs only the words that change. OR is
// idempotent and order-free, and a bit once set stays set, so a slot that
// reads set is set: the filter is bit-identical to the JAX package's
// whatever the schedule.
#include "common.cuh"

namespace {

constexpr int QCHUNK = 8;  // slots of an edge loaded together

struct FillArgs {
    const TpBatch* table;  // the call's batches
    int P, k, run, q, f;
    uint32_t low, high;
    uint32_t tab[16];  // TABLE_1 .. TABLE_4, 4 words each
    void* filt;
};

// The q slots of edge hashes e (byte or bit layout): QCHUNK loads in
// flight, then a store only where a slot reads clear
template <int LAYOUT>
__device__ __forceinline__ void insert_edge(void* filt, const uint32_t* e, int q, int f) {
    for (int j0 = 0; j0 < q; j0 += QCHUNK) {
        uint64_t s[QCHUNK];
        uint32_t v[QCHUNK];
#pragma unroll
        for (int u = 0; u < QCHUNK; ++u)
            if (j0 + u < q) {
                s[u] = tp_km_index(e, (uint32_t)(j0 + u), f);
                v[u] = LAYOUT == TP_LAYOUT_BYTE ? (uint32_t)__ldcg((const uint8_t*)filt + s[u])
                                                : __ldcg((const uint32_t*)filt + (s[u] >> 5));
            }
#pragma unroll
        for (int u = 0; u < QCHUNK; ++u)
            if (j0 + u < q) {
                if constexpr (LAYOUT == TP_LAYOUT_BYTE) {
                    if (v[u] == 0) ((uint8_t*)filt)[s[u]] = 1;
                } else {
                    const uint32_t bit = 1u << (s[u] & 31);
                    if (!(v[u] & bit)) atomicOr((uint32_t*)filt + (s[u] >> 5), bit);
                }
            }
    }
}

// OR the q in-block bits of edge hashes e (the f = 8 indices) into a
// block's words m, in registers (each word chosen by a compare, never by an
// index into a thread's array, which would put it on the stack)
__device__ __forceinline__ void block_bits(uint32_t* m, const uint32_t* e, int q) {
    for (int j = 0; j < q; ++j) {
        const uint32_t b = (uint32_t)tp_km_index(e, (uint32_t)j, 8);
#pragma unroll
        for (int w = 0; w < TP_BLOCK_WORDS; ++w) m[w] |= (b >> 5) == (uint32_t)w ? 1u << (b & 31) : 0u;
    }
}

// Set the bits m of block `block`: one read of its 32 bytes, then an
// atomicOr of each word that gains a bit
__device__ __forceinline__ void flush_block(uint32_t* filt, uint32_t block, const uint32_t* m) {
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < TP_BLOCK_WORDS; ++w) any |= m[w];
    if (!any) return;
    uint32_t* blk = filt + (size_t)block * TP_BLOCK_WORDS;
    const uint4 lo = __ldcg((const uint4*)blk);
    const uint4 hi = __ldcg((const uint4*)blk + 1);
    const uint32_t old[TP_BLOCK_WORDS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int w = 0; w < TP_BLOCK_WORDS; ++w)
        if (m[w] & ~old[w]) atomicOr(blk + w, m[w]);
}

// Edge hashes of fill edge e (0: out V·c0, 1: out V·T, 2: in A·V, 3: in
// T·V) under the first NT tables
template <int NT>
__device__ __forceinline__ void fill_edge(const uint32_t* hf, const uint32_t* hr,
                                          const uint32_t* T, const uint32_t* Tk, int e,
                                          uint32_t c0, uint32_t* eh) {
    const uint32_t c = e == 0 ? c0 : (e == 2 ? 0u : 3u);
#pragma unroll
    for (int u = 0; u < 4; ++u) eh[u] = u < NT ? tp_edge_hash(hf[u], hr[u], T, Tk, u, e < 2, c) : 0u;
}

// LAYOUT byte (f <= 32) with NT = 2 tables, bit with NT = 2 or 4 (f > 32),
// or block with NT = 2
template <int LAYOUT, int NT>
__global__ void __launch_bounds__(TP_THREADS) k_bloom_fill(FillArgs a) {
    __shared__ uint32_t s_T[16], s_Tk[16], s_Tk1[16];
    const TpBatch bt = a.table[blockIdx.y];
    const long long n_b = bt.rows * a.P;
    const long long t0 = (long long)blockIdx.x * TP_THREADS * a.run;
    if (t0 >= n_b) return;  // the whole block: this batch has fewer tiles
    // thread 0 at fixed indices: an index into the parameters that
    // depends on the thread would copy them to a stack frame
    if (threadIdx.x == 0) {
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            const uint32_t t = a.tab[u];
            s_T[u] = t;
            s_Tk[u] = tp_rotl32(t, (uint32_t)a.k);
            s_Tk1[u] = tp_rotl32(t, (uint32_t)(a.k - 1));
        }
    }
    __syncthreads();
    const long long x0 = t0 + (long long)threadIdx.x * a.run;
    if (x0 >= n_b) return;
    const int k = a.k;
    const int r = (int)(x0 / a.P);
    const int i0 = (int)(x0 - (long long)r * a.P);
    const int end = min(i0 + a.run, (int)bt.valid[r]);
    if (i0 >= end) return;
    const TpRow row{bt.packed + (size_t)r * bt.RW, bt.nmask + (size_t)r * bt.NW};
    uint32_t hf[4], hr[4];
    tp_window_hashes(row, i0 + 1, k, NT, s_T, hf, hr);
    int last_n = tp_last_n(row, i0 + 1, i0 + k);  // up to V's last char
    const uint32_t bmask = LAYOUT == TP_LAYOUT_BLOCK ? (1u << (a.f - 8)) - 1u : 0u;
    uint32_t carry[TP_BLOCK_WORDS] = {};  // block: the last position's bits for this V
    uint32_t carry_block = 0;
    for (int i = i0; i < end; ++i) {
        const uint32_t prev = row.ext(i);
        const uint32_t next = row.ext(i + k + 1);
        const bool ok = last_n < i + 1;  // V holds no N
        const uint32_t hv = hf[0] + hr[0];
        uint32_t nf[4], nr[4];  // V_next
#pragma unroll
        for (int u = 0; u < 4; ++u) nf[u] = hf[u], nr[u] = hr[u];
        tp_roll_hashes(row, i + 1, k, NT, s_T, s_Tk, s_Tk1, nf, nr);
        const uint32_t hvn = nf[0] + nr[0];
        const bool in_v = ok && hv >= a.low && hv <= a.high;
        const bool in_n = ok && next < 4 && hvn >= a.low && hvn <= a.high;  // V_next holds no N
        const uint32_t c0 = next < 4 ? next : 0u;
        uint32_t eh[4];
        if constexpr (LAYOUT == TP_LAYOUT_BLOCK) {
            uint32_t m[TP_BLOCK_WORDS], sent[TP_BLOCK_WORDS] = {};
#pragma unroll
            for (int w = 0; w < TP_BLOCK_WORDS; ++w) m[w] = carry[w];
            if (in_v || in_n) {
                fill_edge<NT>(hf, hr, s_T, s_Tk, 0, c0, eh);
                if (in_v) block_bits(m, eh, a.q);
                if (in_n) block_bits(sent, eh, a.q);
            }
            if (in_v) {
                const unsigned dummies = (next >= 4 ? 2u : 0u) | (prev >= 4 ? 12u : 0u);
                for (int e = 1; e < 4; ++e)
                    if ((dummies >> e) & 1u) {
                        fill_edge<NT>(hf, hr, s_T, s_Tk, e, c0, eh);
                        block_bits(m, eh, a.q);
                    }
            }
            flush_block((uint32_t*)a.filt, hv & bmask, m);
#pragma unroll
            for (int w = 0; w < TP_BLOCK_WORDS; ++w) carry[w] = sent[w];
            carry_block = hvn & bmask;
        } else if (in_v || in_n) {
            const unsigned slots = 1u | (next >= 4 ? 2u : 0u) | (prev >= 4 ? 12u : 0u);
            for (int e = 0; e < 4; ++e)
                if ((slots >> e) & 1u) {
                    fill_edge<NT>(hf, hr, s_T, s_Tk, e, c0, eh);
                    insert_edge<LAYOUT>(a.filt, eh, a.q, a.f);
                }
        }
        if (next >= 4) last_n = i + k + 1;
#pragma unroll
        for (int u = 0; u < 4; ++u) hf[u] = nf[u], hr[u] = nr[u];
    }
    if constexpr (LAYOUT == TP_LAYOUT_BLOCK) flush_block((uint32_t*)a.filt, carry_block, carry);
}

template <int LAYOUT, int NT>
cudaError_t launch(const FillArgs& a, dim3 grid, cudaStream_t st) {
    k_bloom_fill<LAYOUT, NT><<<grid, TP_THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// The fill of nb batches in one launch. table: nb rows of 7 int64 on the
// device (packed, nmask, valid pointers, rows, RW, NW, out_off (unused)).
// max_pos: the most positions (rows * P) of a batch (P % 8 == 0). tabs:
// the 16 u32 of TABLE_1 .. TABLE_4 (host memory). layout: 0 byte (filt 2^f
// u8), 1 bit (2^(f-5) u32), 2 block (2^(f-5) u32, f >= 8).
extern "C" int tp_bloom_fill(const void* table, int nb, long long max_pos, int P, int k,
                             uint32_t low, uint32_t high, const uint32_t* tabs, int q, int f,
                             int layout, void* filt, void* stream) {
    if (max_pos == 0) return 0;
    if (table == nullptr || nb < 1 || nb > 65535 || max_pos < 0 || P < 8 || P % 8 != 0 ||
        k < 1 || q < 1 || layout < TP_LAYOUT_BYTE || layout > TP_LAYOUT_BLOCK ||
        (layout == TP_LAYOUT_BYTE && f > 32) || (layout == TP_LAYOUT_BLOCK && (f < 8 || f > 39)) ||
        f < 1 || f > 63)
        return (int)cudaErrorInvalidValue;
    FillArgs a{};
    a.table = (const TpBatch*)table;
    a.P = P, a.k = k, a.q = q, a.f = f, a.low = low, a.high = high, a.filt = filt;
    for (int u = 0; u < 16; ++u) a.tab[u] = tabs[u];
    dim3 grid;
    const cudaError_t e = tp_bloom_grid(max_pos, nb, a.run, grid);
    if (e != cudaSuccess) return (int)e;
    const cudaStream_t st = (cudaStream_t)stream;
    if (layout == TP_LAYOUT_BLOCK) return (int)launch<TP_LAYOUT_BLOCK, 2>(a, grid, st);
    if (layout == TP_LAYOUT_BYTE) return (int)launch<TP_LAYOUT_BYTE, 2>(a, grid, st);
    // f > 32: 64-bit indices from tables 1-4
    return (int)(f > 32 ? launch<TP_LAYOUT_BIT, 4>(a, grid, st)
                        : launch<TP_LAYOUT_BIT, 2>(a, grid, st));
}

// The run (positions a thread) that tp_bloom_fill and tp_bloom_mark take
// for nb batches of at most max_pos positions on the current device, or -1
// on an error (the card tests size their inputs by it)
extern "C" int tp_bloom_run(long long max_pos, int nb) {
    int run = 0;
    dim3 grid;
    return tp_bloom_grid(max_pos, nb, run, grid) == cudaSuccess ? run : -1;
}
