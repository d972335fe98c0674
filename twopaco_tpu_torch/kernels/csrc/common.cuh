// Shared declarations of the port's CUDA kernels (built for sm_90a).
//
// Every exported entry point has a plain C interface (bound with ctypes),
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launches (0 = success).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define TP_LAUNCH_CHECK()                          \
    do {                                           \
        cudaError_t tp_err_ = cudaGetLastError();  \
        if (tp_err_ != cudaSuccess) return tp_err_; \
    } while (0)

constexpr int TP_THREADS = 256;

inline unsigned tp_blocks(size_t n, size_t per_block) {
    return (unsigned)((n + per_block - 1) / per_block);
}

// Inclusive prefix sum of n u32 values (in may equal out). scratch holds
// tp_scan_scratch_words(n) u32 words. Used by the radix sort (digit
// offsets) and by the judge (group ids, ranks, compaction offsets).
cudaError_t tp_scan_inclusive_u32(const uint32_t* in, uint32_t* out,
                                  size_t n, uint32_t* scratch,
                                  cudaStream_t stream);

extern "C" size_t tp_scan_scratch_words(size_t n);
