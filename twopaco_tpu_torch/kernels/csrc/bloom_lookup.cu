// Bloom lookup: the junction ids of a window batch's candidate positions
// (pass 4 of the Bloom engine).
//
// Replaces twopaco_tpu/passes/kernels.py:506 pass4_lookup (a sort to
// compact the candidates, a fixed-step vectorised lower bound, a second
// sort to compact the hits).
//
// Candidates: the positions t = b*P + i whose bit is set in the mask (the
// OR of every round's), inside the row's valid count, with no N in their
// window. Each candidate's canonical k-mer is searched in the sorted (J, w)
// junction table (u32 words compared as unsigned, lexicographically); a
// hit gets id +(rank+1) when the forward strand is canonical, else
// -(rank+1). Output: the hits' flat positions (int32) and ids (int32) in
// ascending position order, at most cap of them, and the number of hits
// (int64, which may exceed cap: the caller checks).
//
// Bound: the search, log2(J) dependent reads of the table a candidate
// (a few percent of the positions). Design: both compactions run on the
// shared scan (scan.cu): the candidates are compacted first, with their
// canonical keys, so the search threads are dense; the hits are compacted
// second, which keeps the candidates' ascending order.
#include "common.cuh"

namespace {

__global__ void k_lookup_flags(const uint32_t* __restrict__ packed,
                               const uint32_t* __restrict__ nmask,
                               const int32_t* __restrict__ valid,
                               const uint8_t* __restrict__ mask, int P, int k,
                               int RW, int NW, size_t n,
                               uint32_t* __restrict__ flags) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const int b = (int)(t / P);
    const int i = (int)(t - (size_t)b * P);
    const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
    flags[t] = ((mask[t >> 3] >> (7 - (t & 7))) & 1u) &&
               tp_position_ok(row, i, k, valid[b]);
}

__global__ void k_lookup_keys(const uint32_t* __restrict__ packed,
                              const uint32_t* __restrict__ nmask, int P,
                              int k, int w, int RW, int NW,
                              const uint32_t* __restrict__ flags,
                              const uint32_t* __restrict__ incl, size_t n,
                              int32_t* __restrict__ cand_pos,
                              uint32_t* __restrict__ keys,
                              uint32_t* __restrict__ cand_rc) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n || !flags[t]) return;
    const size_t c = incl[t] - 1;
    const int b = (int)(t / P);
    const int i = (int)(t - (size_t)b * P);
    const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
    cand_pos[c] = (int32_t)t;
    cand_rc[c] = (tp_canonical_record(row, i, k, w, keys + c * w) >> 16) & 1u;
}

__device__ __forceinline__ bool row_less(const uint32_t* a, const uint32_t* b,
                                         int w) {
    for (int m = 0; m < w; ++m)
        if (a[m] != b[m]) return a[m] < b[m];
    return false;
}

__global__ void k_lookup_search(const uint32_t* __restrict__ keys,
                                const uint32_t* __restrict__ cand_rc,
                                const uint32_t* __restrict__ incl, size_t n,
                                const uint32_t* __restrict__ table,
                                long long J, int w,
                                uint32_t* __restrict__ found,
                                int32_t* __restrict__ ids) {
    const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n) return;
    if (c >= incl[n - 1]) {  // past the last candidate
        found[c] = 0;
        return;
    }
    const uint32_t* key = keys + c * w;
    long long lo = 0, hi = J;  // lower bound: first row >= key
    while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (row_less(table + mid * w, key, w))
            lo = mid + 1;
        else
            hi = mid;
    }
    const bool hit = lo < J && !row_less(key, table + lo * w, w);
    found[c] = hit;
    ids[c] = cand_rc[c] ? -(int32_t)(lo + 1) : (int32_t)(lo + 1);
}

__global__ void k_lookup_scatter(const uint32_t* __restrict__ found,
                                 const uint32_t* __restrict__ incl, size_t n,
                                 const int32_t* __restrict__ cand_pos,
                                 const int32_t* __restrict__ ids,
                                 long long cap, int32_t* __restrict__ out_pos,
                                 int32_t* __restrict__ out_ids) {
    const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n || !found[c]) return;
    const long long d = (long long)incl[c] - 1;
    if (d >= cap) return;
    out_pos[d] = cand_pos[c];
    out_ids[d] = ids[c];
}

__global__ void k_lookup_count(const uint32_t* __restrict__ incl, size_t n,
                               long long* __restrict__ count) {
    count[0] = incl[n - 1];
}

}  // namespace

// table: (J, w) u32 sorted, J >= 1; out_pos, out_ids: cap int32 each;
// count: one int64. Scratch (sized by the caller), n = B*P: flags, incl_a,
// incl_b, cand_rc (n u32 each), cand_pos, ids (n int32 each), keys (n*w
// u32), the scan scratch (tp_scan_scratch_words(n) u32).
extern "C" int tp_bloom_lookup(const void* packed, const void* nmask,
                               const void* valid, int B, int P, int k, int RW,
                               int NW, const void* mask, const void* table,
                               long long J, long long cap, void* out_pos,
                               void* out_ids, void* count, void* flags,
                               void* incl_a, void* incl_b, void* cand_rc,
                               void* cand_pos, void* ids, void* keys,
                               void* scratch, void* stream) {
    const size_t n = (size_t)B * P;
    if (n == 0 || J < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned nb = tp_blocks(n, TP_THREADS);
    const int w = (k + 15) / 16;
    uint32_t* fl = (uint32_t*)flags;
    uint32_t* ia = (uint32_t*)incl_a;
    uint32_t* ib = (uint32_t*)incl_b;
    k_lookup_flags<<<nb, TP_THREADS, 0, st>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask,
        (const int32_t*)valid, (const uint8_t*)mask, P, k, RW, NW, n, fl);
    TP_LAUNCH_CHECK();
    cudaError_t e = tp_scan_inclusive_u32(fl, ia, n, (uint32_t*)scratch, st);
    if (e != cudaSuccess) return (int)e;
    k_lookup_keys<<<nb, TP_THREADS, 0, st>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask, P, k, w, RW, NW, fl,
        ia, n, (int32_t*)cand_pos, (uint32_t*)keys, (uint32_t*)cand_rc);
    TP_LAUNCH_CHECK();
    // the candidate flags are spent: the hit flags take their place
    k_lookup_search<<<nb, TP_THREADS, 0, st>>>(
        (const uint32_t*)keys, (const uint32_t*)cand_rc, ia, n,
        (const uint32_t*)table, J, w, fl, (int32_t*)ids);
    TP_LAUNCH_CHECK();
    e = tp_scan_inclusive_u32(fl, ib, n, (uint32_t*)scratch, st);
    if (e != cudaSuccess) return (int)e;
    k_lookup_scatter<<<nb, TP_THREADS, 0, st>>>(
        fl, ib, n, (const int32_t*)cand_pos, (const int32_t*)ids, cap,
        (int32_t*)out_pos, (int32_t*)out_ids);
    TP_LAUNCH_CHECK();
    k_lookup_count<<<1, 1, 0, st>>>(ib, n, (long long*)count);
    return (int)cudaGetLastError();
}
