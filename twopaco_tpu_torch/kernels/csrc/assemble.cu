// Round assembly: gather round r's fixed-cap blocks of every batch into
// one sort buffer padded with sentinels, rebuilding the flat positions.
//
// Replaces twopaco_tpu/passes/sortpipe.py:237 assemble_round.
//
// Blocks are (nb, n_parts, cap) slots (partition.cu); slot j of batch b's
// block r goes to buffer row b*cap + j, with pos = bases[b] + offset
// (int64: the TPU's (hi, lo) u32 pair is one int64 here). Rows from
// nb*cap to buf_slots are sentinels (words all-ones, payload 0, pos 0).
//
// Bound: bytes moved, 4w + 8 read and 4w + 12 written a row. Design: one
// thread per buffer row, a plain gather: consecutive threads read
// consecutive slots of one block and write consecutive rows.
#include "common.cuh"

namespace {

__global__ void k_assemble(const uint32_t* __restrict__ blk_w,
                           const uint32_t* __restrict__ blk_pay,
                           const uint32_t* __restrict__ blk_off,
                           const long long* __restrict__ bases, int nb,
                           int n_parts, int cap, int w, int r,
                           size_t buf_slots, uint32_t* __restrict__ out_w,
                           uint32_t* __restrict__ out_pay,
                           long long* __restrict__ out_pos) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= buf_slots) return;
    if (i >= (size_t)nb * cap) {
        for (int m = 0; m < w; ++m) out_w[i * w + m] = 0xffffffffu;
        out_pay[i] = 0u;
        out_pos[i] = 0;
        return;
    }
    const size_t b = i / cap;
    const size_t src = (b * n_parts + r) * cap + (i - b * cap);
    for (int m = 0; m < w; ++m) out_w[i * w + m] = blk_w[src * w + m];
    out_pay[i] = blk_pay[src];
    out_pos[i] = bases[b] + (long long)blk_off[src];
}

}  // namespace

extern "C" int tp_assemble_round(const void* blk_w, const void* blk_pay,
                                 const void* blk_off, const void* bases,
                                 int nb, int n_parts, int cap, int w, int r,
                                 size_t buf_slots, void* out_w, void* out_pay,
                                 void* out_pos, void* stream) {
    if (buf_slots == 0) return 0;
    if (r < 0 || r >= n_parts || buf_slots < (size_t)nb * cap)
        return (int)cudaErrorInvalidValue;
    k_assemble<<<tp_blocks(buf_slots, TP_THREADS), TP_THREADS, 0,
                 (cudaStream_t)stream>>>(
        (const uint32_t*)blk_w, (const uint32_t*)blk_pay,
        (const uint32_t*)blk_off, (const long long*)bases, nb, n_parts, cap,
        w, r, buf_slots, (uint32_t*)out_w, (uint32_t*)out_pay,
        (long long*)out_pos);
    return (int)cudaGetLastError();
}
