// Bloom mark: the candidate masks of a round's window batches (pass 2 of
// the Bloom engine), one launch a call.
//
// Replaces twopaco_tpu/passes/kernels.py:400 pass2_mark: the probes of
// :273 mark_indices (byte, bit; ops/bloom.py:261 probe_all) and :357
// mark_indices_block (block; ops/bloom.py:195 probe_blocks), the decision
// of :315 mark_decide and the packing of :336 pack_mask.
//
// Position i of row r of a batch (vertex V) is a candidate when it lies
// inside the row's valid count, V holds no N, V's vertex hash is in [low,
// high], and
//     in  = 2 [prev is N] + sum_c ([c == prev] or hit(c·V))  > 1, or
//     out = 2 [next is N] + sum_c ([c == next] or hit(V·c))  > 1
// over c in ACGT (the reference's CandidateCheckingWorker). hit(edge): all
// q slots of the edge are set (byte, bit), or all q in-block bits of the
// edge in block(V) (block). So a position in the round is a candidate when
// prev or next is N, or when one of the six edges c·V (c != prev) and V·c
// (c != next) hits.
//
// Output: each batch's mask packed 8 positions a byte, MSB first
// (np.unpackbits order), (rows, P/8) u8 at its offset of the output, and
// its number of candidates added to its int64 of the count vector.
//
// Bound: the filter's traffic, each distinct 32-byte sector that the
// decisions read once: the first slot of each of the six edges of a
// position in the round and the later slots of an edge whose earlier ones
// are set (byte, bit), or V's block (block), at most the whole filter; the
// upload form read and the masks written. Design: as bloom_fill.cu's, block (x,
// y) takes tile x of batch y, and a thread rolls the strand hashes along a
// run of up to 8 positions of one row with the char tables in shared
// memory and keeps the window's last N. A position starts the loads of the
// first slots of all six edges together, then the second slots of the
// edges whose first is set, together, and so on: a slot is read only while
// its edge can still hit, and no read waits on another edge's. The block
// layout reads V's 32-byte block once for all six, into the thread's
// column of shared memory, where each in-block bit is one load (no select
// over 8 registers). The decision is
// mark_decide's (extra reads have no side effect). A thread's run of
// decisions is packed by common.cuh tp_pack_runs: a byte a run of 8 (its
// lanes OR a byte together for shorter runs), and one atomic a warp into
// the batch's count.
#include "common.cuh"

namespace {

struct MarkArgs {
    const TpBatch* table;  // the call's batches
    int P, k, run, q, f;
    uint32_t low, high;
    uint32_t tab[16];  // TABLE_1 .. TABLE_4, 4 words each
    const void* filt;
    uint8_t* mask;                // batch b's at its out_off
    unsigned long long* count;    // batch b's at count[b]
};

template <int LAYOUT>
__device__ __forceinline__ bool slot_set(const void* filt, uint64_t s) {
    if constexpr (LAYOUT == TP_LAYOUT_BYTE) return __ldcg((const uint8_t*)filt + s) != 0;
    return (__ldcg((const uint32_t*)filt + (s >> 5)) >> (s & 31)) & 1u;
}

// Edge hashes of mark edge e (0-3: in c·V, 4-7: out V·c, c = e & 3) under
// the first NT tables
template <int NT>
__device__ __forceinline__ void mark_edge(const uint32_t* hf, const uint32_t* hr,
                                          const uint32_t* T, const uint32_t* Tk, int e,
                                          uint32_t* eh) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
        eh[u] = u < NT ? tp_edge_hash(hf[u], hr[u], T, Tk, u, e >= 4, (uint32_t)(e & 3)) : 0u;
}

// One of the needed edges (bit e of need) hits (byte, bit): slot j of
// every edge whose slots 0 .. j-1 are set, loaded together, for j = 0, 1,
// ..., so that a later slot is read only while its edge can still hit
template <int LAYOUT, int NT>
__device__ __forceinline__ bool any_edge_hits(const void* filt, const uint32_t* hf,
                                              const uint32_t* hr, const uint32_t* T,
                                              const uint32_t* Tk, unsigned need, int q, int f) {
    unsigned alive = need;
    for (int j = 0; j < q && alive; ++j) {
        unsigned set = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e)
            if ((alive >> e) & 1u) {
                uint32_t eh[4];
                mark_edge<NT>(hf, hr, T, Tk, e, eh);
                set |= (unsigned)slot_set<LAYOUT>(filt, tp_km_index(eh, (uint32_t)j, f)) << e;
            }
        alive = set;
    }
    return alive != 0;
}

// ... block layout: all q in-block bits of a needed edge set in V's block,
// which the thread keeps in its column of s_blk (word w at w * TP_THREADS
// + its thread index: a lane's word is in its own bank, whatever w)
template <int NT>
__device__ __forceinline__ bool any_edge_hits_block(const uint32_t* s_blk, const uint32_t* hf,
                                                    const uint32_t* hr, const uint32_t* T,
                                                    const uint32_t* Tk, unsigned need, int q) {
    for (int e = 0; e < 8; ++e) {
        if (!((need >> e) & 1u)) continue;
        uint32_t eh[4];
        mark_edge<NT>(hf, hr, T, Tk, e, eh);
        bool all = true;
        for (int j = 0; j < q && all; ++j) {
            const uint32_t b = (uint32_t)tp_km_index(eh, (uint32_t)j, 8);
            all = (s_blk[(b >> 5) * TP_THREADS + threadIdx.x] >> (b & 31)) & 1u;
        }
        if (all) return true;
    }
    return false;
}

// LAYOUT byte (f <= 32) with NT = 2 tables, bit with NT = 2 or 4 (f > 32),
// or block with NT = 2
template <int LAYOUT, int NT>
__global__ void __launch_bounds__(TP_THREADS) k_bloom_mark(MarkArgs a) {
    __shared__ uint32_t s_T[16], s_Tk[16], s_Tk1[16];
    // block layout: each thread's copy of its position's block
    __shared__ uint32_t s_blk[LAYOUT == TP_LAYOUT_BLOCK ? TP_BLOCK_WORDS * TP_THREADS : 1];
    // the batch row's fields are read where used (a copy of the row kept
    // across the loop spilled to the stack)
    const TpBatch* bt = a.table + blockIdx.y;
    const long long n_b = bt->rows * a.P;
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
    const bool live = x0 < n_b;  // every lane packs, live or not
    unsigned bits = 0;           // bit s: position x0 + s is a candidate
    if (live) {
        const int k = a.k;
        const int r = (int)(x0 / a.P);
        const int i0 = (int)(x0 - (long long)r * a.P);
        const int end = min(i0 + a.run, (int)bt->valid[r]);
        const TpRow row{bt->packed + (size_t)r * bt->RW, bt->nmask + (size_t)r * bt->NW};
        uint32_t hf[4], hr[4];
        int last_n = 0;
        if (i0 < end) {
            tp_window_hashes(row, i0 + 1, k, NT, s_T, hf, hr);
            last_n = tp_last_n(row, i0 + 1, i0 + k);  // up to V's last char
        }
        for (int i = i0; i < end; ++i) {
            const uint32_t next = row.ext(i + k + 1);
            const uint32_t hv = hf[0] + hr[0];
            if (last_n < i + 1 && hv >= a.low && hv <= a.high) {
                const uint32_t prev = row.ext(i);
                bool cand = prev >= 4 || next >= 4;
                if (!cand) {
                    const unsigned need = (0xfu & ~(1u << prev)) | (0xf0u & ~(16u << next));
                    if constexpr (LAYOUT == TP_LAYOUT_BLOCK) {
                        const uint32_t* p = (const uint32_t*)a.filt +
                                            (size_t)(hv & ((1u << (a.f - 8)) - 1u)) * TP_BLOCK_WORDS;
                        const uint4 lo = __ldcg((const uint4*)p);
                        const uint4 hi = __ldcg((const uint4*)p + 1);
                        const uint32_t blk[TP_BLOCK_WORDS] = {lo.x, lo.y, lo.z, lo.w,
                                                              hi.x, hi.y, hi.z, hi.w};
#pragma unroll
                        for (int w = 0; w < TP_BLOCK_WORDS; ++w)
                            s_blk[w * TP_THREADS + threadIdx.x] = blk[w];
                        cand = any_edge_hits_block<NT>(s_blk, hf, hr, s_T, s_Tk, need, a.q);
                    } else {
                        cand = any_edge_hits<LAYOUT, NT>(a.filt, hf, hr, s_T, s_Tk, need, a.q,
                                                         a.f);
                    }
                }
                bits |= (unsigned)cand << (i - i0);
            }
            if (next >= 4) last_n = i + k + 1;
            if (i + 1 < end) tp_roll_hashes(row, i + 1, k, NT, s_T, s_Tk, s_Tk1, hf, hr);
        }
    }
    tp_pack_runs(bits, a.run, x0, live, a.mask + bt->out_off, a.count + blockIdx.y);
}

template <int LAYOUT, int NT>
cudaError_t launch(const MarkArgs& a, dim3 grid, cudaStream_t st) {
    k_bloom_mark<LAYOUT, NT><<<grid, TP_THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// The masks of nb batches in one launch. table, nb, max_pos, tabs,
// layout, filt as tp_bloom_fill's; a table row's out_off is the byte
// offset of the batch's packed (rows, P/8) mask in `mask`. count: nb
// int64, batch b's candidates added to count[b] (the caller zeroes them).
extern "C" int tp_bloom_mark(const void* table, int nb, long long max_pos, int P, int k,
                             uint32_t low, uint32_t high, const uint32_t* tabs, int q, int f,
                             int layout, const void* filt, void* mask, void* count,
                             void* stream) {
    if (max_pos == 0) return 0;
    if (table == nullptr || nb < 1 || nb > 65535 || max_pos < 0 || P < 8 || P % 8 != 0 ||
        k < 1 || q < 1 || layout < TP_LAYOUT_BYTE || layout > TP_LAYOUT_BLOCK ||
        (layout == TP_LAYOUT_BYTE && f > 32) || (layout == TP_LAYOUT_BLOCK && (f < 8 || f > 39)) ||
        f < 1 || f > 63)
        return (int)cudaErrorInvalidValue;
    MarkArgs a{};
    a.table = (const TpBatch*)table;
    a.P = P, a.k = k, a.q = q, a.f = f, a.low = low, a.high = high, a.filt = filt;
    a.mask = (uint8_t*)mask;
    a.count = (unsigned long long*)count;
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
