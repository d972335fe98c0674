// Record build: one sort record per vertex position of a list of window
// batches, one launch a call.
//
// Replaces twopaco_tpu/passes/sortpipe.py:143 build_sort_records (body
// :103 _batch_records over ops/pack.py and ops/buzhash.py) and the
// whole-batch append into the round buffer (:326 append_records): the
// kernel writes each record straight into the round buffer.
//
// Per position i of row r of a batch: its sort record (common.cuh
// tp_canonical_record's words and payload where the position has a record
// whose vertex hash lies in [low, high], else all-ones words and payload
// 0) at out_off + r*P + i, with pos = pos_base + r*P + i (int64).
// With a candidate mask `gate` (the dist-bloom engine's,
// twopaco_tpu/parallel/distpipe.py:168: (rows, P/8) u8, MSB first), a
// position whose bit is 0 gets the sentinel record (all-ones words,
// payload 0) whatever it holds.
//
// Bound: bytes moved, 0.28 bytes a position read and 4w + 12 written.
// Design: block (x, y) takes tile x of batch y (a row of the batch table,
// or the one batch given by value, so a one-batch call copies no table),
// RUN * TP_THREADS consecutive positions of the batch; RUN (1 to 8) is
// chosen per call so that a one-batch call still fills the card, and is 1
// for w > 4. For w <= 4 (k <= 64) a thread takes RUN consecutive
// positions and rolls along them: the forward and reverse-complement
// words shift 2 bits a step in registers, the vertex hash rolls with the
// char tables in shared memory, the window's N test keeps the index of
// its last N, and each step reads two chars, prev (the char that leaves
// the window) and next (the char that enters it at the following step);
// a window is built from scratch at the run's first position and at each
// row start (common.cuh tp_roll_records, shared with partition.cu). The
// records of a tile are staged in shared memory (a skewed layout, so the
// stride-RUN*w writes hit distinct banks) and stored coalesced. For w > 4
// a thread builds its one position from scratch with the tables in shared
// memory, and writes its words directly.
#include "common.cuh"

namespace {

constexpr int RUN_MAX = 8;
constexpr int TILE_MAX = TP_THREADS * RUN_MAX;  // positions a block, at most
constexpr int W_ROLL = 4;                       // widest rolled k-mer, words

// One batch of a call (9 int64, the wrapper's table row): its upload form,
// its gate (null: none), rows of P positions (RW, NW words a row), the
// position of its first slot and where its records go in the outputs
struct RecBatch {
    const uint32_t* packed;
    const uint32_t* nmask;
    const int32_t* valid;
    const uint8_t* gate;
    long long rows, RW, NW, pos_base, out_off;
};

struct RecArgs {
    const RecBatch* table;  // null: the one batch `one`
    RecBatch one;
    int P, k, run;
    uint32_t low, high;
    uint32_t tab[4];
    uint32_t* out_words;
    uint32_t* out_pay;
    long long* out_pos;
};

__device__ __forceinline__ bool gate_bit(const uint8_t* gate, long long x) {
    return gate == nullptr || ((gate[x >> 3] >> (7 - (x & 7))) & 1u);
}

// w > 4: each of a thread's positions (strided by the block) from scratch,
// its words written directly
__device__ __forceinline__ void records_wide(const RecArgs& a, const RecBatch& bt, long long t0,
                                             int tn, const uint32_t* s_T) {
    const int P = a.P, k = a.k, w = (k + 15) / 16;
    const long long o0 = bt.out_off + t0;
    for (int l = threadIdx.x; l < tn; l += TP_THREADS) {
        const long long x = t0 + l;
        const int r = (int)(x / P), i = (int)(x - (long long)r * P);
        const TpRow row{bt.packed + (size_t)r * bt.RW, bt.nmask + (size_t)r * bt.NW};
        uint32_t hf[4], hr[4];
        tp_window_hashes(row, i + 1, k, 1, s_T, hf, hr);
        const uint32_t h = hf[0] + hr[0];
        uint32_t* wout = a.out_words + (size_t)(o0 + l) * w;
        uint32_t pay = 0;
        if (gate_bit(bt.gate, x) && tp_position_ok(row, i, k, bt.valid[r]) && h >= a.low &&
            h <= a.high)
            pay = tp_canonical_record(row, i, k, w, wout);
        else
            for (int m = 0; m < w; ++m) wout[m] = 0xffffffffu;
        a.out_pay[o0 + l] = pay;
        a.out_pos[o0 + l] = bt.pos_base + x;
    }
}

// w = W <= 4: a thread's run of positions rolled (common.cuh
// tp_roll_records), the tile staged in shared memory and stored coalesced
template <int W>
__device__ __forceinline__ void records_rolled(const RecArgs& a, const RecBatch& bt,
                                               long long t0, int tn, const uint32_t* s_T,
                                               const uint32_t* s_Tk, const uint32_t* s_Tk1,
                                               uint32_t* s_w, uint32_t* s_p) {
    const int run = a.run, tid = threadIdx.x;
    const int l0 = tid * run;
    if (l0 < tn)
        tp_roll_records<W>(bt.packed, bt.nmask, bt.valid, bt.RW, bt.NW, a.P, a.k, t0 + l0,
                           tn - l0 < run ? tn - l0 : run, s_T, s_Tk, s_Tk1,
                           [&](int s, bool ok, uint32_t h, bool is_rc, const TpWindow<W>& win,
                               uint32_t pay) {
                               const int l = l0 + s;
                               ok = ok && h >= a.low && h <= a.high && gate_bit(bt.gate, t0 + l);
#pragma unroll
                               for (int m = 0; m < W; ++m)
                                   s_w[tp_skew(l * W + m)] =
                                       ok ? (is_rc ? win.rc[m] : win.fw[m]) : 0xffffffffu;
                               s_p[tp_skew(l)] = ok ? pay : 0u;
                           });
    __syncthreads();
    const long long o0 = bt.out_off + t0;
    for (int x = tid; x < tn * W; x += TP_THREADS) a.out_words[(size_t)o0 * W + x] = s_w[tp_skew(x)];
    for (int x = tid; x < tn; x += TP_THREADS) {
        a.out_pay[o0 + x] = s_p[tp_skew(x)];
        a.out_pos[o0 + x] = bt.pos_base + t0 + x;
    }
}

// W: the rolled width, or 0 for w > 4
template <int W>
__global__ void __launch_bounds__(TP_THREADS) k_records(RecArgs a) {
    __shared__ uint32_t s_T[4], s_Tk[4], s_Tk1[4];
    const RecBatch bt = a.table != nullptr ? a.table[blockIdx.y] : a.one;
    const long long n_b = bt.rows * a.P;
    const int tile = TP_THREADS * a.run;
    const long long t0 = (long long)blockIdx.x * tile;
    if (t0 >= n_b) return;  // the whole block: this batch has fewer tiles
    if (threadIdx.x < 4) {
        const uint32_t t = a.tab[threadIdx.x];
        s_T[threadIdx.x] = t;
        s_Tk[threadIdx.x] = tp_rotl32(t, (uint32_t)a.k);
        s_Tk1[threadIdx.x] = tp_rotl32(t, (uint32_t)(a.k - 1));
    }
    __syncthreads();
    const int tn = n_b - t0 < tile ? (int)(n_b - t0) : tile;  // positions of the tile
    if constexpr (W == 0) {
        records_wide(a, bt, t0, tn, s_T);
    } else {
        __shared__ uint32_t s_w[TILE_MAX * W + TILE_MAX * W / 32];
        __shared__ uint32_t s_p[TILE_MAX + TILE_MAX / 32];
        records_rolled<W>(a, bt, t0, tn, s_T, s_Tk, s_Tk1, s_w, s_p);
    }
}

template <int W>
cudaError_t launch(const RecArgs& a, dim3 grid, cudaStream_t st) {
    k_records<W><<<grid, TP_THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// The records of nb batches in one launch. table: nb rows of 9 int64 on
// the device (packed, nmask, valid, gate pointers (gate 0: none), rows,
// RW, NW, pos_base, out_off); or null with nb = 1 for the one batch given
// by the scalar arguments, written at offset 0 of the outputs. max_pos:
// the most positions (rows * P) of a batch. Outputs: words (., w) u32,
// payload u32, positions int64.
extern "C" int tp_build_records(const void* table, int nb, long long max_pos,
                                const void* packed, const void* nmask, const void* valid,
                                const void* gate, long long rows, long long RW, long long NW,
                                long long pos_base, int P, int k, uint32_t low, uint32_t high,
                                uint32_t t0, uint32_t t1, uint32_t t2, uint32_t t3,
                                void* out_words, void* out_pay, void* out_pos, void* stream) {
    if (max_pos == 0) return 0;
    if (nb < 1 || nb > 65535 || max_pos < 0 || P < 1 || k < 1 || (table == nullptr && nb != 1))
        return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    RecArgs a{};
    a.table = (const RecBatch*)table;
    a.one = RecBatch{(const uint32_t*)packed, (const uint32_t*)nmask, (const int32_t*)valid,
                     (const uint8_t*)gate, rows, RW, NW, pos_base, 0};
    a.P = P, a.k = k, a.low = low, a.high = high;
    a.tab[0] = t0, a.tab[1] = t1, a.tab[2] = t2, a.tab[3] = t3;
    a.out_words = (uint32_t*)out_words;
    a.out_pay = (uint32_t*)out_pay;
    a.out_pos = (long long*)out_pos;
    // rolled (w <= 4): the longest run that still gives every SM a block;
    // from scratch: one position a thread (a longer run rolls nothing and
    // only cuts the threads that hide the body's latency)
    const int wide = (k + 15) / 16 > W_ROLL;
    long long tiles = 0;
    for (a.run = wide ? 1 : RUN_MAX;; a.run >>= 1) {
        tiles = (max_pos + TP_THREADS * a.run - 1) / (TP_THREADS * a.run);
        if (a.run == 1 || tiles * nb >= sms) break;
    }
    if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, (unsigned)nb);
    const cudaStream_t st = (cudaStream_t)stream;
    switch ((k + 15) / 16) {
        case 1: return (int)launch<1>(a, grid, st);
        case 2: return (int)launch<2>(a, grid, st);
        case 3: return (int)launch<3>(a, grid, st);
        case W_ROLL: return (int)launch<W_ROLL>(a, grid, st);
        default: return (int)launch<0>(a, grid, st);
    }
}

// The message of a CUDA error code that an entry point returned (any
// source's)
extern "C" const char* tp_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
