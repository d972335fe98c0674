// The packed merge on the card: N keyed entries (rounds, or a round's
// shards) into the global junction table and one position-sorted key
// buffer (passes/merge.py).
//
// Replaces the host merge of twopaco_tpu/passes/sortpipe.py:1539-1655
// merge_rounds_packed (numpy argsort of the tables, remap of every id, a
// sort of the keys), which runs on the host because of the TPU's slow D2H
// link. The tables' sort is sort.cu's (tp_sort_records, the row index as
// the position column): its sorted words are the global table and its
// sorted positions the order. Then:
// - k_merge_inv: inv[order[i]] = i, and a count of sorted rows equal to
//   the row before them (a k-mer in two entries: the caller raises);
// - k_merge_remap: each key (pos << id_bits | id + bias, id = +-(1-based
//   row of its entry's table)) gets its global id, +-(inv[row_ofs[e] +
//   |id| - 1] + 1), its entry e found by a binary search of the runs' key
//   offsets; ids of 0 and ids past their entry's table (or past inv) are
//   counted (the key is kept as it was), as occ_pack.cu counts its bad occurrences;
//   then sort.cu's digit passes sort the keys by their position bits
//   [id_bits, 64) alone: a flat position holds one occurrence, so that is
//   the order of the whole keys.
//
// Bound: bytes moved. inv: the sorted words and the order read, inv
// written (4w + 12 bytes a row); remap: a key read and written and one
// random 32-byte inv sector a key; the digit passes as occ_pack.cu's (8
// bytes read and written a key a pass, 4 passes for 32 position bits).
// Design: a thread a row, a thread a key; the entry offsets (N + 1 a row of
// two) stay in L1 through the search; the remap writes the buffer its
// first digit pass reads, as occ_pack.cu builds its keys.
#include <utility>

#include "common.cuh"

namespace {

__global__ void k_merge_inv(const uint32_t* __restrict__ words,
                            const long long* __restrict__ order, size_t m, int w,
                            int32_t* __restrict__ inv,
                            unsigned long long* __restrict__ dup) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    inv[order[i]] = (int32_t)i;
    if (i == 0) return;
    const uint32_t* a = words + i * w;
    bool same = true;
    for (int j = 0; j < w; ++j) same &= a[j] == a[j - w];
    if (same) atomicAdd(dup, 1ull);
}

// keys_in and keys_out may be one buffer (a thread reads, then writes,
// its own key)
__global__ void k_merge_remap(const uint64_t* keys_in, size_t n,
                              const long long* __restrict__ key_ofs,
                              const long long* __restrict__ row_ofs, int n_entries,
                              const int32_t* __restrict__ inv, long long n_inv,
                              int id_bits, uint64_t* keys_out,
                              unsigned long long* __restrict__ faults) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    // the entry whose run holds key i: the last e with key_ofs[e] <= i
    int lo = 0, hi = n_entries - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(key_ofs + mid) <= (long long)i) lo = mid;
        else hi = mid - 1;
    }
    const uint64_t key = keys_in[i];
    const uint64_t mask = (1ull << id_bits) - 1ull;
    const long long bias = 1ll << (id_bits - 1);
    const long long id = (long long)(key & mask) - bias;
    const long long mag = id < 0 ? -id : id;
    const long long r0 = __ldg(row_ofs + lo);
    uint64_t out = key;
    if (id == 0) {
        atomicAdd(faults, 1ull);
    } else if (mag > __ldg(row_ofs + lo + 1) - r0 || r0 + mag > n_inv) {
        atomicAdd(faults + 1, 1ull);
    } else {
        const long long g = (long long)inv[r0 + mag - 1] + 1;
        out = (key & ~mask) | (uint64_t)((id < 0 ? -g : g) + bias);
    }
    keys_out[i] = out;
}

}  // namespace

// words (m, w) u32 sorted, order (m,) int64 a permutation -> inv (m,)
// int32; dup (one int64) added to.
extern "C" int tp_merge_inv(const void* words, const void* order, size_t m, int w,
                            void* inv, void* dup, void* stream) {
    if (w < 1) return (int)cudaErrorInvalidValue;
    if (m == 0) return 0;
    k_merge_inv<<<tp_blocks(m, TP_THREADS), TP_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const long long*)order, m, w, (int32_t*)inv,
        (unsigned long long*)dup);
    return (int)cudaGetLastError();
}

// keys (n u64): the entries' position-sorted runs, rewritten and sorted in
// place; entries: 2 x (n_entries + 1) int64, the runs' key offsets, then
// the entries' table row offsets (into inv, n_inv rows). Scratch (sized by
// the caller): keys_alt (n u64), scratch of scratch_bytes >=
// tp_sort_scratch_bytes(n, passes) bytes for the passes over [id_bits,
// 64). faults: two int64 (ids 0, ids past their table), added to.
extern "C" int tp_merge_remap(void* keys, size_t n, const void* entries, int n_entries,
                              const void* inv, long long n_inv, int id_bits,
                              void* keys_alt, void* scratch, size_t scratch_bytes,
                              void* faults, void* stream) {
    if (id_bits < 2 || id_bits > 62 || n_entries < 1 || n_inv < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    uint64_t* k0 = (uint64_t*)keys;
    uint64_t* k1 = (uint64_t*)keys_alt;
    if (tp_radix_passes(id_bits, 64) & 1) std::swap(k0, k1);
    const long long* ofs = (const long long*)entries;
    k_merge_remap<<<tp_blocks(n, TP_THREADS), TP_THREADS, 0, st>>>(
        (const uint64_t*)keys, n, ofs, ofs + n_entries + 1, n_entries,
        (const int32_t*)inv, n_inv, id_bits, k0, (unsigned long long*)faults);
    TP_LAUNCH_CHECK();
    return (int)tp_radix_sort_u64(k0, k1, n, id_bits, 64, scratch, scratch_bytes, st);
}
