// Record build: one sort record per vertex position of a window batch.
//
// Replaces twopaco_tpu/passes/sortpipe.py:143 build_sort_records (body
// :103 _batch_records over ops/pack.py and ops/buzhash.py) and the
// whole-batch append into the round buffer (:326 append_records): the
// kernel writes each record straight into the round buffer.
//
// Per position i of row b: the record of common.cuh tp_build_record
// (canonical words, payload, vertex-hash gate [low, high]) and
// pos = pos_base + b*P + i (int64). With a candidate mask `gate` (the
// dist-bloom engine's, twopaco_tpu/parallel/distpipe.py:168: (B, P/8) u8,
// MSB first), a position whose bit is 0 gets the sentinel record (all-ones
// words, payload 0) whatever it holds.
//
// Bound: per-thread integer work (about 4k char extractions and k
// rotates) over an input of 0.28 bytes a position and an output of
// 4w + 12 bytes a position; the reads hit L1 because neighbouring
// threads share packed words. Design: one thread per position computes
// everything directly from the packed row, with no scan and no
// intermediate arrays in device memory.
#include "common.cuh"

namespace {

__global__ void k_build_records(const uint32_t* __restrict__ packed,
                                const uint32_t* __restrict__ nmask,
                                const int32_t* __restrict__ valid, int B,
                                int P, int k, int w, int RW, int NW,
                                long long pos_base, uint32_t low,
                                uint32_t high, TpTab tab,
                                const uint8_t* __restrict__ gate,
                                uint32_t* __restrict__ out_words,
                                uint32_t* __restrict__ out_pay,
                                long long* __restrict__ out_pos) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * P) return;
    const int b = (int)(t / P);
    const int i = (int)(t - (long long)b * P);
    const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
    uint32_t* wout = out_words + (size_t)t * w;
    if (gate != nullptr && !((gate[t >> 3] >> (7 - (t & 7))) & 1u)) {
        for (int m = 0; m < w; ++m) wout[m] = 0xffffffffu;
        out_pay[t] = 0u;
    } else {
        uint32_t hv;
        out_pay[t] = tp_build_record(row, i, k, w, valid[b], low, high, tab,
                                     wout, &hv);
    }
    out_pos[t] = pos_base + t;
}

}  // namespace

// gate: the packed candidate mask (B*P/8 u8, P % 8 == 0), or null for none.
extern "C" int tp_build_records(const void* packed, const void* nmask,
                                const void* valid, int B, int P, int k,
                                int RW, int NW, long long pos_base,
                                uint32_t low, uint32_t high, uint32_t t0,
                                uint32_t t1, uint32_t t2, uint32_t t3,
                                const void* gate, void* out_words, void* out_pay,
                                void* out_pos, void* stream) {
    const long long n = (long long)B * P;
    if (n == 0) return 0;
    const int w = (k + 15) / 16;
    const TpTab tab{{t0, t1, t2, t3}};
    k_build_records<<<tp_blocks((size_t)n, TP_THREADS), TP_THREADS, 0,
                      (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const uint32_t*)nmask,
        (const int32_t*)valid, B, P, k, w, RW, NW, pos_base, low, high, tab,
        (const uint8_t*)gate, (uint32_t*)out_words, (uint32_t*)out_pay, (long long*)out_pos);
    return (int)cudaGetLastError();
}
