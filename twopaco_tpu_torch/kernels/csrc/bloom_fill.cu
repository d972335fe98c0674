// Bloom fill: insert the canonical edges of every vertex position of a
// window batch into the filter (pass 1 of the Bloom engine).
//
// Replaces twopaco_tpu/passes/kernels.py:257 pass1_fill: the indices of
// :130 fill_indices (byte, bit) and :179 fill_indices_block (block), set
// by ops/bloom.py:89 fill and :165 fill_blocks.
//
// Position i of row b (vertex V, chars i+1 .. i+k) inserts, when it lies
// inside the row's valid count and V holds no N:
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
// Bound: random single-byte stores or atomicOr on u32 words spread over
// the whole filter (up to 2 GiB at f = 34), about 4q a position; the
// hashes (2 or 4 tables of k rotates) are register work. Design: one
// thread per position hashes its window straight from the 2-bit upload
// form and writes its slots. A byte slot is only ever set to 1 and OR is
// order-free, so the filter is bit-identical to the JAX package's
// whatever the schedule; there is no sort of the indices (the TPU's
// scatter workaround) and no intermediate index array.
#include "common.cuh"

namespace {

// Set the q slots of edge hashes e (byte or bit layout)
__device__ __forceinline__ void set_slots(void* filt, int layout,
                                          const uint32_t* e, int q, int f) {
    for (int j = 0; j < q; ++j) {
        const uint64_t s = tp_km_index(e, (uint32_t)j, f);
        if (layout == TP_LAYOUT_BYTE)
            ((uint8_t*)filt)[s] = 1;
        else
            atomicOr((uint32_t*)filt + (s >> 5), 1u << (s & 31));
    }
}

// Set the q in-block bits of edge hashes e in block `block`
__device__ __forceinline__ void set_block(uint32_t* filt, uint32_t block,
                                          const uint32_t* e, int q) {
    uint32_t* blk = filt + (size_t)block * TP_BLOCK_WORDS;
    for (int j = 0; j < q; ++j) {
        const uint32_t b = (uint32_t)tp_km_index(e, (uint32_t)j, 8);
        atomicOr(blk + (b >> 5), 1u << (b & 31));
    }
}

__global__ void k_bloom_fill(const uint32_t* __restrict__ packed,
                             const uint32_t* __restrict__ nmask,
                             const int32_t* __restrict__ valid, int B, int P,
                             int k, int RW, int NW, uint32_t low,
                             uint32_t high, TpTabs tabs, int q, int f,
                             int layout, void* filt) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * P) return;
    const int b = (int)(t / P);
    const int i = (int)(t - (long long)b * P);
    const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
    const int nt = (layout != TP_LAYOUT_BLOCK && f > 32) ? 4 : 2;
    TpFillPos p;
    if (!tp_fill_position(row, i, k, valid[b], low, high, tabs, nt, p)) return;
    uint32_t e[4];
    if (layout == TP_LAYOUT_BLOCK) {
        uint32_t* fw = (uint32_t*)filt;
        const uint32_t bmask = (1u << (f - 8)) - 1u;
        tp_fill_edge(p, tabs, 2, 0, k, e);
        if (p.in_v) set_block(fw, p.hv & bmask, e, q);
        if (p.in_n && p.next < 4) set_block(fw, p.hvn & bmask, e, q);
        if (!p.in_v) return;
        const unsigned dummies = tp_fill_slots(p) & ~1u;
        for (int s = 1; s < 4; ++s) {
            if (!((dummies >> s) & 1u)) continue;
            tp_fill_edge(p, tabs, 2, s, k, e);
            set_block(fw, p.hv & bmask, e, q);
        }
        return;
    }
    if (!(p.in_v || p.in_n)) return;
    const unsigned slots = tp_fill_slots(p);
    for (int s = 0; s < 4; ++s) {
        if (!((slots >> s) & 1u)) continue;
        tp_fill_edge(p, tabs, nt, s, k, e);
        set_slots(filt, layout, e, q, f);
    }
}

}  // namespace

// tabs: the 16 u32 of TABLE_1 .. TABLE_4 (host memory). layout: 0 byte
// (filt 2^f u8), 1 bit (2^(f-5) u32), 2 block (2^(f-5) u32, f >= 8).
extern "C" int tp_bloom_fill(const void* packed, const void* nmask,
                             const void* valid, int B, int P, int k, int RW,
                             int NW, uint32_t low, uint32_t high,
                             const uint32_t* tabs, int q, int f, int layout,
                             void* filt, void* stream) {
    const long long n = (long long)B * P;
    if (n == 0) return 0;
    TpTabs tt;
    for (int u = 0; u < 4; ++u)
        for (int c = 0; c < 4; ++c) tt.t[u].t[c] = tabs[4 * u + c];
    k_bloom_fill<<<tp_blocks((size_t)n, TP_THREADS), TP_THREADS, 0,
                   (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask,
        (const int32_t*)valid, B, P, k, RW, NW, low, high, tt, q, f, layout,
        filt);
    return (int)cudaGetLastError();
}
