// Judge + compact: junction decision per k-mer group of the sorted round,
// rank ids, and compaction of the junction table and the occurrences.
//
// Replaces twopaco_tpu/passes/sortpipe.py:453 judge_compact_fused (helpers
// twopaco_tpu/ops/segments.py:85 _fwd_chunk, :105 _bwd_chunk, :155
// _cumsum_chunk) and, by the second entry tp_judge_records, sortpipe.py:375
// judge_records: the same group math, no compaction, one (keep_first, keep,
// id) per record, for the distributed step (parallel/sortshard.py).
//
// Over records sorted by k-mer words (sentinel rows last, one group):
//   1. group starts (words differ from the previous row) and, by the
//      shared scan, each row's group index;
//   2. per group, from its real rows: atomicOr of the 8 ACGT extension
//      bits (in at bits 0-3, out at bits 8-11), atomicAdd of the N-in and
//      N-out counts and of the group size; the counts are clamped at
//      0x7FFF when read, the same >= 2 decisions as the saturating
//      counters of ops/segments.py:132;
//   3. a group is a junction iff (indeg > 1 or outdeg > 1) and it is real
//      and (no abundance check, or size <= abundance);
//   4. the scan of junction group starts gives ranks: junction rows go to
//      the table in k-mer order, id = +rank or -rank by strand;
//   5. the scan of kept rows gives the compacted (pos, id) occurrences in
//      record order, plus n_groups (real groups), n_junc, n_occ.
//
// Bound: bytes moved, about a dozen u32 passes over the round plus the
// record columns read twice. Design: the TPU's scatter-free two-scan
// segmented reductions become atomics into per-group slots (groups are
// small and contiguous, so contention is low, and sentinel rows skip the
// atomics); every compaction offset comes from the same u32 scan the
// radix sort uses.
#include "common.cuh"

namespace {

__device__ __forceinline__ bool is_real(uint32_t p) { return (p >> 17) & 1u; }

__global__ void k_group_start(const uint32_t* __restrict__ words, size_t n,
                              int w, uint32_t* __restrict__ ng) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t start = i == 0;
    for (int j = 0; j < w && !start; ++j)
        start = words[i * w + j] != words[(i - 1) * w + j];
    ng[i] = start;
}

struct Acc {
    uint32_t* bits;
    uint32_t* n_in;
    uint32_t* n_out;
    uint32_t* size;
    uint32_t* grank;
};

__global__ void k_accumulate(const uint32_t* __restrict__ pay,
                             const uint32_t* __restrict__ gsc, size_t n,
                             int check_abundance, Acc acc) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t p = pay[i];
    if (!is_real(p)) return;
    const uint32_t g = gsc[i] - 1;
    const uint32_t in = p & 0xffu;
    const uint32_t out = (p >> 8) & 0xffu;
    const uint32_t bits =
        (in < 4 ? 1u << in : 0u) | (out < 4 ? 1u << (out + 8) : 0u);
    if (bits) atomicOr(&acc.bits[g], bits);
    if (in == 4) atomicAdd(&acc.n_in[g], 1u);
    if (out == 4) atomicAdd(&acc.n_out[g], 1u);
    if (check_abundance) atomicAdd(&acc.size[g], 1u);
}

__global__ void k_keep_first(const uint32_t* __restrict__ ng,
                             const uint32_t* __restrict__ pay,
                             const uint32_t* __restrict__ gsc, size_t n,
                             int check_abundance,
                             unsigned long long abundance, Acc acc,
                             uint32_t* __restrict__ kf) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t keep = 0;
    if (ng[i] && is_real(pay[i])) {
        const uint32_t g = gsc[i] - 1;
        const uint32_t bits = acc.bits[g];
        const int indeg =
            __popc(bits & 0xfu) + (int)min(acc.n_in[g], 0x7fffu);
        const int outdeg =
            __popc((bits >> 8) & 0xfu) + (int)min(acc.n_out[g], 0x7fffu);
        keep = (indeg > 1 || outdeg > 1) &&
               (!check_abundance ||
                (unsigned long long)acc.size[g] <= abundance);
    }
    kf[i] = keep;
}

__global__ void k_table(const uint32_t* __restrict__ words,
                        const uint32_t* __restrict__ kf,
                        const uint32_t* __restrict__ rank,
                        const uint32_t* __restrict__ gsc, size_t n, int w,
                        uint32_t* __restrict__ grank,
                        uint32_t* __restrict__ table) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !kf[i]) return;
    const uint32_t r = rank[i];
    grank[gsc[i] - 1] = r;
    for (int j = 0; j < w; ++j)
        table[(size_t)(r - 1) * w + j] = words[i * w + j];
}

__global__ void k_occ_flag(const uint32_t* __restrict__ gsc,
                           const uint32_t* __restrict__ grank, size_t n,
                           uint32_t* __restrict__ of) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) of[i] = grank[gsc[i] - 1] != 0;
}

__global__ void k_occ_write(const uint32_t* __restrict__ pay,
                            const long long* __restrict__ pos,
                            const uint32_t* __restrict__ gsc,
                            const uint32_t* __restrict__ grank,
                            const uint32_t* __restrict__ of,
                            const uint32_t* __restrict__ occ_ofs, size_t n,
                            long long* __restrict__ occ_pos,
                            int32_t* __restrict__ occ_id) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !of[i]) return;
    const size_t o = occ_ofs[i] - 1;
    const int32_t r = (int32_t)grank[gsc[i] - 1];
    occ_pos[o] = pos[i];
    occ_id[o] = ((pay[i] >> 16) & 1u) ? -r : r;
}

// *dst = src[n - 1] (the total of an inclusive scan)
__global__ void k_last(const uint32_t* __restrict__ src, size_t n,
                       long long* __restrict__ dst) {
    *dst = src[n - 1];
}

// real groups: sentinel rows, if any, are the last group
__global__ void k_n_groups(const uint32_t* __restrict__ gsc,
                           const uint32_t* __restrict__ pay, size_t n,
                           long long* __restrict__ dst) {
    *dst = (long long)gsc[n - 1] - (is_real(pay[n - 1]) ? 0 : 1);
}

// grank[g] = rank of junction group g (its start row's rank)
__global__ void k_grank(const uint32_t* __restrict__ kf,
                        const uint32_t* __restrict__ rank,
                        const uint32_t* __restrict__ gsc, size_t n,
                        uint32_t* __restrict__ grank) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n && kf[i]) grank[gsc[i] - 1] = rank[i];
}

// Per record: keep_first (a junction group's first row), keep (a row of a
// junction group), id = +-rank by strand or 0; of = keep as u32 for the
// occurrence count
__global__ void k_record_ids(const uint32_t* __restrict__ pay,
                             const uint32_t* __restrict__ gsc,
                             const uint32_t* __restrict__ grank,
                             const uint32_t* __restrict__ kf, size_t n,
                             uint8_t* __restrict__ keep_first,
                             uint8_t* __restrict__ keep,
                             int32_t* __restrict__ ids,
                             uint32_t* __restrict__ of) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int32_t r = (int32_t)grank[gsc[i] - 1];
    keep_first[i] = kf[i] != 0;
    keep[i] = r != 0;
    ids[i] = ((pay[i] >> 16) & 1u) ? -r : r;
    of[i] = r != 0;
}

// Steps 1-4 of the header, shared by both entries: ng, gsc, the group
// accumulators, kf and the rank scan, and n_groups, n_junc in cnt[0..1].
cudaError_t judge_groups(const uint32_t* wd, const uint32_t* py, size_t n,
                         int w, int check_abundance,
                         unsigned long long abundance, uint32_t* ng,
                         uint32_t* gsc, uint32_t* kf, uint32_t* rank, Acc acc,
                         uint32_t* sc, long long* cnt, cudaStream_t st) {
    const unsigned nb = tp_blocks(n, TP_THREADS);
    cudaError_t e = cudaMemsetAsync(acc.bits, 0, 5 * n * sizeof(uint32_t), st);
    if (e != cudaSuccess) return e;
    k_group_start<<<nb, TP_THREADS, 0, st>>>(wd, n, w, ng);
    TP_LAUNCH_CHECK();
    e = tp_scan_inclusive_u32(ng, gsc, n, sc, st);
    if (e != cudaSuccess) return e;
    k_accumulate<<<nb, TP_THREADS, 0, st>>>(py, gsc, n, check_abundance, acc);
    TP_LAUNCH_CHECK();
    k_keep_first<<<nb, TP_THREADS, 0, st>>>(ng, py, gsc, n, check_abundance,
                                            abundance, acc, kf);
    TP_LAUNCH_CHECK();
    e = tp_scan_inclusive_u32(kf, rank, n, sc, st);
    if (e != cudaSuccess) return e;
    k_n_groups<<<1, 1, 0, st>>>(gsc, py, n, cnt);
    TP_LAUNCH_CHECK();
    k_last<<<1, 1, 0, st>>>(rank, n, cnt + 1);
    TP_LAUNCH_CHECK();
    return cudaSuccess;
}

}  // namespace

// Scratch (sized by the caller): 9 * n u32 words plus the scan scratch
// (tp_scan_scratch_words(n) u32).
extern "C" int tp_judge_compact(const void* words, const void* pay,
                                const void* pos, size_t n, int w,
                                int check_abundance,
                                unsigned long long abundance, void* work,
                                void* scratch, void* table, void* occ_pos,
                                void* occ_id, void* counts, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    long long* cnt = (long long*)counts;
    if (n == 0) return (int)cudaMemsetAsync(cnt, 0, 3 * sizeof(long long), st);
    const unsigned nb = tp_blocks(n, TP_THREADS);
    const uint32_t* wd = (const uint32_t*)words;
    const uint32_t* py = (const uint32_t*)pay;
    uint32_t* sc = (uint32_t*)scratch;
    uint32_t* wk = (uint32_t*)work;
    uint32_t* ng = wk;            // group starts, later kept-row flags
    uint32_t* gsc = wk + n;       // inclusive scan of group starts
    uint32_t* kf = wk + 2 * n;    // junction group starts
    uint32_t* rank = wk + 3 * n;  // inclusive scan of kf, later occ offsets
    Acc acc{wk + 4 * n, wk + 5 * n, wk + 6 * n, wk + 7 * n, wk + 8 * n};

    cudaError_t e = judge_groups(wd, py, n, w, check_abundance, abundance, ng,
                                 gsc, kf, rank, acc, sc, cnt, st);
    if (e != cudaSuccess) return (int)e;
    k_table<<<nb, TP_THREADS, 0, st>>>(wd, kf, rank, gsc, n, w, acc.grank,
                                       (uint32_t*)table);
    TP_LAUNCH_CHECK();
    uint32_t* of = ng;
    uint32_t* occ_ofs = rank;
    k_occ_flag<<<nb, TP_THREADS, 0, st>>>(gsc, acc.grank, n, of);
    TP_LAUNCH_CHECK();
    e = tp_scan_inclusive_u32(of, occ_ofs, n, sc, st);
    if (e != cudaSuccess) return (int)e;
    k_occ_write<<<nb, TP_THREADS, 0, st>>>(py, (const long long*)pos, gsc,
                                           acc.grank, of, occ_ofs, n,
                                           (long long*)occ_pos,
                                           (int32_t*)occ_id);
    TP_LAUNCH_CHECK();
    k_last<<<1, 1, 0, st>>>(occ_ofs, n, cnt + 2);
    return (int)cudaGetLastError();
}

// Scratch as tp_judge_compact's. Outputs per record: keep_first, keep (u8),
// ids (int32); counts: n_groups, n_junc, n_occ (int64).
extern "C" int tp_judge_records(const void* words, const void* pay, size_t n,
                                int w, int check_abundance,
                                unsigned long long abundance, void* work,
                                void* scratch, void* keep_first, void* keep,
                                void* ids, void* counts, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    long long* cnt = (long long*)counts;
    if (n == 0) return (int)cudaMemsetAsync(cnt, 0, 3 * sizeof(long long), st);
    const unsigned nb = tp_blocks(n, TP_THREADS);
    const uint32_t* py = (const uint32_t*)pay;
    uint32_t* sc = (uint32_t*)scratch;
    uint32_t* wk = (uint32_t*)work;
    uint32_t* ng = wk;
    uint32_t* gsc = wk + n;
    uint32_t* kf = wk + 2 * n;
    uint32_t* rank = wk + 3 * n;  // later the occurrence count's scan
    Acc acc{wk + 4 * n, wk + 5 * n, wk + 6 * n, wk + 7 * n, wk + 8 * n};
    cudaError_t e = judge_groups((const uint32_t*)words, py, n, w,
                                 check_abundance, abundance, ng, gsc, kf,
                                 rank, acc, sc, cnt, st);
    if (e != cudaSuccess) return (int)e;
    k_grank<<<nb, TP_THREADS, 0, st>>>(kf, rank, gsc, n, acc.grank);
    TP_LAUNCH_CHECK();
    uint32_t* of = ng;
    k_record_ids<<<nb, TP_THREADS, 0, st>>>(py, gsc, acc.grank, kf, n,
                                            (uint8_t*)keep_first,
                                            (uint8_t*)keep, (int32_t*)ids, of);
    TP_LAUNCH_CHECK();
    e = tp_scan_inclusive_u32(of, rank, n, sc, st);
    if (e != cudaSuccess) return (int)e;
    k_last<<<1, 1, 0, st>>>(rank, n, cnt + 2);
    return (int)cudaGetLastError();
}
