// Device-wide inclusive prefix sum of u32 values: the scan shared by the
// radix sort and the judge (JAX counterparts: the cumsums inside
// twopaco_tpu/passes/sortpipe.py judge_compact_fused and
// twopaco_tpu/ops/segments.py _cumsum_chunk).
//
// Bound: bytes moved, about 3 passes over the array (read + write in the
// tile pass, read + write in the add pass). Design: reduce-then-scan over
// tiles of 2048 values (8 per thread, warp shuffles for the block scan),
// the tile totals scanned recursively in the scratch buffer, then one
// pass adding each tile's carry. A single-pass decoupled look-back scan
// would move a third fewer bytes; that is later work.
#include "common.cuh"

namespace {

constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = TP_THREADS * SCAN_ITEMS;
constexpr int SCAN_WARPS = TP_THREADS / 32;

__global__ void k_scan_tiles(const uint32_t* in, uint32_t* out,
                             uint32_t* tile_sums, size_t n) {
    __shared__ uint32_t warp_tot[SCAN_WARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const size_t base =
        (size_t)blockIdx.x * SCAN_TILE + (size_t)threadIdx.x * SCAN_ITEMS;
    uint32_t v[SCAN_ITEMS];
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
        const size_t i = base + j;
        acc += i < n ? in[i] : 0u;
        v[j] = acc;
    }
    uint32_t incl = acc;  // inclusive scan of thread totals in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        uint32_t t = lane < SCAN_WARPS ? warp_tot[lane] : 0u;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(0xffffffffu, t, o);
            if (lane >= o) t += y;
        }
        if (lane < SCAN_WARPS) warp_tot[lane] = t;
    }
    __syncthreads();
    const uint32_t prefix = incl - acc + (warp > 0 ? warp_tot[warp - 1] : 0u);
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
        const size_t i = base + j;
        if (i < n) out[i] = v[j] + prefix;
    }
    if (threadIdx.x == TP_THREADS - 1) tile_sums[blockIdx.x] = prefix + acc;
}

// Tile b (b >= 1) adds the inclusive total of tiles 0..b-1.
__global__ void k_scan_add(uint32_t* out, const uint32_t* tile_incl,
                           size_t n) {
    const size_t b = (size_t)blockIdx.x + 1;
    const uint32_t add = tile_incl[b - 1];
    const size_t base = b * SCAN_TILE;
    for (int j = threadIdx.x; j < SCAN_TILE; j += TP_THREADS) {
        const size_t i = base + j;
        if (i < n) out[i] += add;
    }
}

}  // namespace

extern "C" size_t tp_scan_scratch_words(size_t n) {
    size_t total = 0;
    size_t m = n;
    do {
        m = (m + SCAN_TILE - 1) / SCAN_TILE;
        total += m;
    } while (m > 1);
    return total > 0 ? total : 1;
}

cudaError_t tp_scan_inclusive_u32(const uint32_t* in, uint32_t* out,
                                  size_t n, uint32_t* scratch,
                                  cudaStream_t stream) {
    if (n == 0) return cudaSuccess;
    const size_t nt = (n + SCAN_TILE - 1) / SCAN_TILE;
    k_scan_tiles<<<(unsigned)nt, TP_THREADS, 0, stream>>>(in, out, scratch,
                                                          n);
    TP_LAUNCH_CHECK();
    if (nt > 1) {
        const cudaError_t e =
            tp_scan_inclusive_u32(scratch, scratch, nt, scratch + nt, stream);
        if (e != cudaSuccess) return e;
        k_scan_add<<<(unsigned)(nt - 1), TP_THREADS, 0, stream>>>(
            out, scratch, n);
        TP_LAUNCH_CHECK();
    }
    return cudaSuccess;
}

extern "C" const char* tp_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
