// Upload: every window row of a run packed from the run's staged codes.
//
// Replaces the host packing of twopaco_tpu/passes/sortpipe.py:1048-1056
// (io/windows.py uint8 rows, ops/pack.py pack_codes_host a batch, one
// copy an array), there to shrink the H2D over the TPU's remote link. The
// staged codes (one byte a char, 0..4, every sequence in input order) are
// on the card; this writes the upload form of common.cuh (2-bit chars
// little-first, N bitmask) for every row of a row table (io/windows.py
// window_rows): row r = (off, lo, hi), char j of the row is code off + j
// when that lies in [lo, hi), else N; chars past R are 0 in both outputs
// (ops/pack.py pack_codes_host's padding). A code's two low bits are its
// char and bit 2 its N flag (the encoder's codes 0..4).
//
// Bound: bytes moved: the staged codes read once (1 byte a char) and the
// packed form written once (2.25 bits a char), plus 24 bytes a row of
// table: ~0.027 ms for the slice's 64.5 M chars at 3.35 TB/s.
// Design: one thread per 32 chars of a row (a mask word and two packed
// words). It reads the three aligned 16-byte words that hold its 32 chars
// (only those that overlap [lo, hi): the codes buffer is a whole number of
// 16-byte words, so no read leaves it), moves the chars to its word
// boundary by selects and funnel shifts, forces the chars outside the
// sequence to N and past R to 0, and packs four chars a 32-bit word with
// shifts. Neighbouring threads read neighbouring 32-byte runs; no shared
// memory.
#include "common.cuh"

namespace {

// bits [a, b) of a u32, 0 <= a <= b <= 32
__device__ __forceinline__ uint32_t bit_range(int a, int b) {
    return (uint32_t)(((1ull << b) - 1ull) & ~((1ull << a) - 1ull));
}

// the low 4 bits of m as 0x00 / 0xFF bytes (bit i -> byte i)
__device__ __forceinline__ uint32_t byte_mask(uint32_t m) {
    return ((m & 0xFu) * 0x00204081u & 0x01010101u) * 0xFFu;
}

// the aligned 16-byte word of codes at byte `at`, zeros unless it
// overlaps [lo, hi) (then it lies inside the buffer)
__device__ __forceinline__ uint4 load_word(const uint8_t* codes, long long at,
                                           long long lo, long long hi) {
    if (at + 16 <= lo || at >= hi) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(codes + at));
}

__global__ void k_upload(const uint8_t* __restrict__ codes, long long n_codes,
                         const long long* __restrict__ table, long long n_rows,
                         int R, int RW, int NW, uint32_t* __restrict__ packed,
                         uint32_t* __restrict__ nmask) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_rows * NW) return;
    const long long r = t / NW;
    const int c = (int)(t - r * NW);
    const long long off = table[3 * r];
    const long long lo = max(table[3 * r + 1], 0ll);
    const long long hi = min(table[3 * r + 2], n_codes);
    const long long s = off + 32ll * c;  // the staged index of char 32c
    const int in_row = min(R - 32 * c, 32);
    const int a = (int)min(max(lo - s, 0ll), (long long)in_row);
    const int b = (int)max(min(hi - s, (long long)in_row), (long long)a);
    const uint32_t real = bit_range(a, b);  // chars of the sequence
    const uint32_t inr = bit_range(0, in_row);  // chars of the row
    uint32_t v[8];  // the chunk's 32 codes, 4 a word, char 4q+i in byte i
    if (real == 0u) {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = 0u;
    } else {
        const long long a0 = s & ~15ll;
        const uint4 x0 = load_word(codes, a0, lo, hi);
        const uint4 x1 = load_word(codes, a0 + 16, lo, hi);
        const uint4 x2 = load_word(codes, a0 + 32, lo, hi);
        const uint32_t w[12] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y,
                                x1.z, x1.w, x2.x, x2.y, x2.z, x2.w};
        const int sh = (int)(s - a0);  // 0..15: bytes to drop
        const int ws = sh >> 2;
        const int bs = (sh & 3) * 8;
        uint32_t u[9];
#pragma unroll
        for (int q = 0; q < 9; ++q)
            u[q] = ws == 0 ? w[q] : ws == 1 ? w[q + 1] : ws == 2 ? w[q + 2] : w[q + 3];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = __funnelshift_r(u[q], u[q + 1], bs);
    }
    uint32_t p0 = 0u, p1 = 0u, nm = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const uint32_t mr = byte_mask(real >> (4 * q));
        const uint32_t mi = byte_mask(inr >> (4 * q));
        const uint32_t x = (v[q] & mr) | (0x04040404u & mi & ~mr);
        uint32_t two = x & 0x03030303u;  // a char's 2 bits a byte
        two = (two | (two >> 6)) & 0x000F000Fu;
        two = (two | (two >> 12)) & 0xFFu;
        uint32_t isn = (x >> 2) & 0x01010101u;  // its N flag a byte
        isn = (isn | (isn >> 7)) & 0x00030003u;
        isn = (isn | (isn >> 14)) & 0xFu;
        if (q < 4) p0 |= two << (8 * q);
        else p1 |= two << (8 * (q - 4));
        nm |= isn << (4 * q);
    }
    uint32_t* prow = packed + r * RW;
    prow[2 * c] = p0;
    if (2 * c + 1 < RW) prow[2 * c + 1] = p1;
    nmask[r * NW + c] = nm;
}

}  // namespace

// codes: n_codes uint8 (16-byte aligned, n_codes a multiple of 16); table:
// n_rows x 3 int64 (off, lo, hi); outputs packed (n_rows, ceil(R/16)) and
// nmask (n_rows, ceil(R/32)) u32.
extern "C" int tp_upload_rows(const void* codes, long long n_codes, const void* table,
                              long long n_rows, int R, void* packed, void* nmask,
                              void* stream) {
    if (R < 1 || n_codes < 0 || n_codes % 16 != 0 || (uintptr_t)codes % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (n_rows <= 0) return 0;
    const int RW = (R + 15) / 16, NW = (R + 31) / 32;
    const unsigned long long threads = (unsigned long long)n_rows * NW;
    k_upload<<<tp_blocks(threads, TP_THREADS), TP_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, n_codes, (const long long*)table, n_rows, R, RW, NW,
        (uint32_t*)packed, (uint32_t*)nmask);
    return (int)cudaGetLastError();
}
