// Stream compaction: append one batch's in-round records to the round
// buffer at a running offset kept on the device.
//
// Replaces twopaco_tpu/passes/sortpipe.py:338 compact_batch_records and
// the append step of :624 _stream_round_scan (:648-668).
//
// The batch's n records (record build gated to the round's hash interval:
// the real ones are in the round, the rest are sentinels) are partitioned
// stably, real rows first, and all n rows are written at
// off_c = min(off, lim), lim = buf_slots - n; then
//     over |= off + cnt > lim,   off = off_c + cnt
// where cnt is the batch's real count. state = (off, over) as two int64
// on the device, so batches need no host sync between them; the host reads
// the flag once a round. The clamped write keeps every store inside the
// buffer when the round overflows (its results are then discarded).
//
// Bound: bytes moved, about 3 passes over the batch's records. Design:
// real flags, the shared scan (scan.cu) for ranks, and a scatter in
// which a real row goes to off_c + rank and a sentinel row to
// off_c + cnt + (i - rank), so the order of both is kept.
#include "common.cuh"

namespace {

__global__ void k_real_flags(const uint32_t* __restrict__ pay, size_t n,
                             uint32_t* __restrict__ flags) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) flags[i] = (pay[i] & TP_REAL) ? 1u : 0u;
}

__global__ void k_compact_scatter(const uint32_t* __restrict__ words,
                                  const uint32_t* __restrict__ pay,
                                  const long long* __restrict__ pos,
                                  const uint32_t* __restrict__ incl, size_t n,
                                  int w, long long lim,
                                  const long long* __restrict__ state,
                                  uint32_t* __restrict__ buf_w,
                                  uint32_t* __restrict__ buf_pay,
                                  long long* __restrict__ buf_pos) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long off_c = min(state[0], lim);
    const uint32_t cnt = incl[n - 1];
    const uint32_t rank = incl[i];  // real rows in [0, i]
    const bool real = pay[i] & TP_REAL;
    const size_t dst = (size_t)off_c +
                       (real ? (size_t)rank - 1 : (size_t)cnt + (i - rank));
    for (int m = 0; m < w; ++m) buf_w[dst * w + m] = words[i * w + m];
    buf_pay[dst] = pay[i];
    buf_pos[dst] = pos[i];
}

__global__ void k_compact_state(const uint32_t* __restrict__ incl, size_t n,
                                long long lim, long long* __restrict__ state) {
    const long long cnt = incl[n - 1];
    const long long off = state[0];
    if (off + cnt > lim) state[1] = 1;
    state[0] = min(off, lim) + cnt;
}

}  // namespace

// Scratch (sized by the caller): flags and incl (n u32 each), the scan
// scratch (tp_scan_scratch_words(n) u32).
extern "C" int tp_compact_append(const void* words, const void* pay,
                                 const void* pos, size_t n, int w,
                                 void* buf_w, void* buf_pay, void* buf_pos,
                                 long long lim, void* state, void* flags,
                                 void* incl, void* scratch, void* stream) {
    if (n == 0) return 0;
    if (lim < 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned nb = tp_blocks(n, TP_THREADS);
    uint32_t* fl = (uint32_t*)flags;
    uint32_t* inc = (uint32_t*)incl;
    long long* s = (long long*)state;
    k_real_flags<<<nb, TP_THREADS, 0, st>>>((const uint32_t*)pay, n, fl);
    TP_LAUNCH_CHECK();
    const cudaError_t e =
        tp_scan_inclusive_u32(fl, inc, n, (uint32_t*)scratch, st);
    if (e != cudaSuccess) return (int)e;
    k_compact_scatter<<<nb, TP_THREADS, 0, st>>>(
        (const uint32_t*)words, (const uint32_t*)pay, (const long long*)pos,
        inc, n, w, lim, s, (uint32_t*)buf_w, (uint32_t*)buf_pay,
        (long long*)buf_pos);
    TP_LAUNCH_CHECK();
    k_compact_state<<<1, 1, 0, st>>>(inc, n, lim, s);
    return (int)cudaGetLastError();
}
