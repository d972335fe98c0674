// Bloom extract: the candidate records of a marked window batch, appended
// to the round's verify buffer.
//
// Replaces twopaco_tpu/passes/kernels.py:420 extract_records (a nonzero
// over the mask into a pow2 capacity bucket, then gathers of the canonical
// words and the in/out extensions).
//
// Every marked position t = b*P + i (flat order) becomes the sort record of
// common.cuh tp_canonical_record (canonical words, payload in | out<<8 |
// is_rc<<16 | real<<17) with position pos_base + t, written at
//     dst = off + (marked positions before t)
// where state = (off, overflow) are two int64 on the device; then off +=
// the batch's count. Batches appended in order fill the round buffer in
// the JAX package's record order, with no host sync between batches. A
// record whose dst falls past the buffer's S slots is dropped and sets the
// overflow flag.
//
// Bound: a pass over the mask, the shared scan (scan.cu) and the record
// writes of the marked positions (a few percent of them). Design: flags
// from the packed mask, the inclusive scan for ranks, and a scatter in
// which each marked position builds its own record from the upload form.
#include "common.cuh"

namespace {

__global__ void k_mask_flags(const uint8_t* __restrict__ mask, size_t n,
                             uint32_t* __restrict__ flags) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) flags[t] = (mask[t >> 3] >> (7 - (t & 7))) & 1u;
}

__global__ void k_extract_scatter(const uint32_t* __restrict__ packed,
                                  const uint32_t* __restrict__ nmask, int P,
                                  int k, int w, int RW, int NW,
                                  const uint32_t* __restrict__ flags,
                                  const uint32_t* __restrict__ incl, size_t n,
                                  long long pos_base, long long S,
                                  long long* __restrict__ state,
                                  uint32_t* __restrict__ out_w,
                                  uint32_t* __restrict__ out_pay,
                                  long long* __restrict__ out_pos) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n || !flags[t]) return;
    const long long dst = state[0] + (long long)incl[t] - 1;
    if (dst >= S) {
        state[1] = 1;
        return;
    }
    const int b = (int)(t / P);
    const int i = (int)(t - (size_t)b * P);
    const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
    out_pay[dst] = tp_canonical_record(row, i, k, w, out_w + (size_t)dst * w);
    out_pos[dst] = pos_base + (long long)t;
}

__global__ void k_extract_state(const uint32_t* __restrict__ incl, size_t n,
                                long long* __restrict__ state) {
    state[0] += incl[n - 1];
}

}  // namespace

// mask: (B*P/8) u8 (kernels.py pack_mask order); the buffer (out_w (S, w),
// out_pay (S,), out_pos (S,)); state: int64 (off, overflow). Scratch (sized
// by the caller): flags and incl (B*P u32 each), the scan scratch
// (tp_scan_scratch_words(B*P) u32).
extern "C" int tp_bloom_extract(const void* packed, const void* nmask, int B,
                                int P, int k, int RW, int NW, const void* mask,
                                long long pos_base, void* out_w, void* out_pay,
                                void* out_pos, long long S, void* state,
                                void* flags, void* incl, void* scratch,
                                void* stream) {
    const size_t n = (size_t)B * P;
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned nb = tp_blocks(n, TP_THREADS);
    uint32_t* fl = (uint32_t*)flags;
    uint32_t* inc = (uint32_t*)incl;
    k_mask_flags<<<nb, TP_THREADS, 0, st>>>((const uint8_t*)mask, n, fl);
    TP_LAUNCH_CHECK();
    const cudaError_t e =
        tp_scan_inclusive_u32(fl, inc, n, (uint32_t*)scratch, st);
    if (e != cudaSuccess) return (int)e;
    k_extract_scatter<<<nb, TP_THREADS, 0, st>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask, P, k, (k + 15) / 16,
        RW, NW, fl, inc, n, pos_base, S, (long long*)state, (uint32_t*)out_w,
        (uint32_t*)out_pay, (long long*)out_pos);
    TP_LAUNCH_CHECK();
    k_extract_state<<<1, 1, 0, st>>>(inc, n, (long long*)state);
    return (int)cudaGetLastError();
}
