// Bloom mark: the candidate mask of a window batch (pass 2 of the Bloom
// engine).
//
// Replaces twopaco_tpu/passes/kernels.py:400 pass2_mark: the probes of
// :273 mark_indices (byte, bit; ops/bloom.py:261 probe_all) and :357
// mark_indices_block (block; ops/bloom.py:195 probe_blocks), the decision
// of :315 mark_decide and the packing of :336 pack_mask.
//
// Position i of row b (vertex V) is a candidate when it lies inside the
// row's valid count, V holds no N, V's vertex hash is in [low, high], and
//     in  = 2 [prev is N] + sum_c ([c == prev] or hit(c·V))  > 1, or
//     out = 2 [next is N] + sum_c ([c == next] or hit(V·c))  > 1
// over c in ACGT (the reference's CandidateCheckingWorker). hit(edge): all
// q slots of the edge are set (byte, bit), or all q in-block bits of the
// edge in block(V) (block).
//
// Output: the mask packed 8 positions a byte, MSB first (np.unpackbits
// order), (B, P/8) u8, and the number of candidates added to an int64.
//
// Bound: up to 8q random reads a position over the whole filter (byte,
// bit), or 8q reads of one 32-byte block (block). Design: one thread per
// position, hashes in registers, each edge's probes stop at the first
// clear slot and each side's loop at a count of 2 (the decision only asks
// "> 1"); a warp's 32 decisions are gathered with one ballot, so a lane of
// every 8 writes its byte and lane 0 adds the warp's count (the decision and
// the packing are common.cuh's, shared with bloom_shard.cu).
#include "common.cuh"

namespace {

__device__ __forceinline__ bool probe_slots(const void* filt, int layout,
                                            const uint32_t* e, int q, int f) {
    for (int j = 0; j < q; ++j) {
        const uint64_t s = tp_km_index(e, (uint32_t)j, f);
        const bool set =
            layout == TP_LAYOUT_BYTE
                ? ((const uint8_t*)filt)[s] != 0
                : ((((const uint32_t*)filt)[s >> 5] >> (s & 31)) & 1u) != 0;
        if (!set) return false;
    }
    return true;
}

__device__ __forceinline__ bool probe_block(const uint32_t* blk,
                                            const uint32_t* e, int q) {
    for (int j = 0; j < q; ++j) {
        const uint32_t b = (uint32_t)tp_km_index(e, (uint32_t)j, 8);
        if (!((blk[b >> 5] >> (b & 31)) & 1u)) return false;
    }
    return true;
}

__global__ void k_bloom_mark(const uint32_t* __restrict__ packed,
                             const uint32_t* __restrict__ nmask,
                             const int32_t* __restrict__ valid, int B, int P,
                             int k, int RW, int NW, uint32_t low,
                             uint32_t high, TpTabs tabs, int q, int f,
                             int layout, const void* __restrict__ filt,
                             uint8_t* __restrict__ mask,
                             unsigned long long* __restrict__ count) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long n = (long long)B * P;
    bool cand = false;
    if (t < n) {
        const int b = (int)(t / P);
        const int i = (int)(t - (long long)b * P);
        const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
        const int nt = (layout != TP_LAYOUT_BLOCK && f > 32) ? 4 : 2;
        uint32_t hf[4], hr[4];
        if (tp_mark_position(row, i, k, valid[b], low, high, tabs, nt, hf, hr)) {
            const uint32_t hv = hf[0] + hr[0];
            const uint32_t* blk =
                layout == TP_LAYOUT_BLOCK
                    ? (const uint32_t*)filt +
                          (size_t)(hv & ((1u << (f - 8)) - 1u)) * TP_BLOCK_WORDS
                    : nullptr;
            uint32_t e[4];
            cand = tp_mark_decide(row.ext(i), row.ext(i + k + 1),
                                  [&](int side, uint32_t c) {
                tp_edge_hashes(hf, hr, tabs, nt, side == 1, c, k, e);
                return layout == TP_LAYOUT_BLOCK
                           ? probe_block(blk, e, q)
                           : probe_slots(filt, layout, e, q, f);
            });
        }
    }
    tp_pack_candidates(cand, t, n, mask, count);
}

}  // namespace

// mask: (B*P/8) u8 (P % 8 == 0); count: one int64, added to (the caller
// zeroes it). tabs, layout, filt as tp_bloom_fill.
extern "C" int tp_bloom_mark(const void* packed, const void* nmask,
                             const void* valid, int B, int P, int k, int RW,
                             int NW, uint32_t low, uint32_t high,
                             const uint32_t* tabs, int q, int f, int layout,
                             const void* filt, void* mask, void* count,
                             void* stream) {
    const long long n = (long long)B * P;
    if (n == 0) return 0;
    if (P % 8 != 0) return (int)cudaErrorInvalidValue;
    TpTabs tt;
    for (int u = 0; u < 4; ++u)
        for (int c = 0; c < 4; ++c) tt.t[u].t[c] = tabs[4 * u + c];
    k_bloom_mark<<<tp_blocks((size_t)n, TP_THREADS), TP_THREADS, 0,
                   (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask,
        (const int32_t*)valid, B, P, k, RW, NW, low, high, tt, q, f, layout,
        filt, (uint8_t*)mask, (unsigned long long*)count);
    return (int)cudaGetLastError();
}
