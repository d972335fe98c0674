// The hash-sharded Bloom filter of the dist-bloom engine: owner bucketing of
// a shard's fill and mark indices, the local fill and probe of the slots a
// shard receives, and the candidate decision from the hits sent back.
//
// Replaces twopaco_tpu/parallel/sharded.py:112 _bucket (over the indices of
// twopaco_tpu/passes/kernels.py:130 fill_indices and :273 mark_indices),
// :143 _local_fill, :149 _local_probe, and :155 _unbucket with the rest of
// :181 _mark_shard_fn (kernels.py:315 mark_decide, :336 pack_mask).
//
// A filter of 2^f global slots is sharded over D shards: global slot i lives
// on shard i mod D at local slot i div D. Per batch a shard
//   tp_shard_bucket       computes the 4q (fill) or 8q (mark) indices of
//                         each position of its rows, in the flat (row,
//                         position, edge, hash) order, and buckets them by
//                         owner into (D, cap) u64 send slots of local slots,
//                         each owner's in that order (stable); unused slots
//                         hold all-ones, the indices past cap are dropped
//                         and counted. In mark mode it also writes each
//                         probe's send slot owner*cap + rank (all-ones where
//                         the probe is not sent), edge-hash major: probe j
//                         of position t at j * B*P + t;
// and, after the exchange (the mesh's all_to_all),
//   tp_shard_fill_apply   sets the received local slots in its shard,
//                         reading each received row only up to its
//                         first unsent slot (rows are prefixes);
//   tp_shard_probe        reads them: one u8 hit a slot (all-ones: 0);
// and, after the hits come back along the same slots,
//   tp_shard_mark_finish  gathers each position's 8q hits through its send
//                         slots, ANDs each edge's q, decides (the vertex
//                         hash and prev and next from the upload form) and
//                         packs the candidate mask MSB first, adding the
//                         count to an int64.
//
// Bound: bytes. The bucketing reads the upload form and writes the send
// slots (and the probe slots); the fill and probe touch one byte or u32
// word a received slot at random over a shard of up to 2 GiB. The fill
// reads only the sent prefix of each received row (under a sixth of the
// slots at the slice's batch): a block a chunk of a row, which exits at
// once when its chunk starts unsent. Design of the bucketing: one
// thread a position, a tile a block of TP_THREADS positions; the hashes and
// indices stay in registers (common.cuh, shared with bloom_fill.cu and
// bloom_mark.cu) and are computed again in each pass, never stored. A count
// pass gives per-tile owner counts, scanned owner-major by scan.cu; the
// scatter pass ranks each index by the exclusive prefix of its thread's
// owner counts over the tile (warp shuffles, then the lower warps' totals)
// and its order among its own thread's indices, so the send slots equal
// the plain version's exactly. Owners go in chunks of SHARD_DC, one
// register counter each (D > SHARD_DC: one more hash pass a chunk). Owner
// and local slot use 32-bit division while the index fits 32 bits (f <= 32)
// and 64-bit past it.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr uint64_t SENT = ~0ull;  // an index that is not sent / empty slot
constexpr uint32_t NOT_SENT = 0xffffffffu;
constexpr int SHARD_DC = 8;  // owners counted in registers a pass
constexpr int FILL_CHUNK = 4096;  // received slots a fill block

__device__ __forceinline__ uint32_t owner_of(uint64_t x, int D) {
    if (x == SENT) return (uint32_t)D;
    return (x >> 32) == 0 ? (uint32_t)x % (uint32_t)D
                          : (uint32_t)(x % (uint64_t)D);
}

__device__ __forceinline__ uint64_t local_of(uint64_t x, int D) {
    return (x >> 32) == 0 ? (uint64_t)((uint32_t)x / (uint32_t)D)
                          : x / (uint64_t)D;
}

// One batch of a shard: B rows of the upload form, P positions a row, the
// round [low, high], q hashes into 2^f slots; mark = 0 fill, 1 mark.
struct ShardBatch {
    const uint32_t* packed;
    const uint32_t* nmask;
    const int32_t* valid;
    int B, P, k, RW, NW;
    uint32_t low, high;
    TpTabs tabs;
    int q, f, mark;

    __device__ __forceinline__ long long n_pos() const {
        return (long long)B * P;
    }

    // visit(j, x) for the per = 4q (fill) or 8q (mark) global indices x of
    // position t = b*P + i in (edge, hash) order j; x = SENT where the
    // index is not inserted or not probed.
    template <class Visit>
    __device__ __forceinline__ void indices(long long t, Visit visit) const {
        const int b = (int)(t / P);
        const int i = (int)(t - (long long)b * P);
        const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
        const int nt = f > 32 ? 4 : 2;
        uint32_t e[4];
        if (mark) {
            uint32_t hf[4], hr[4];
            const bool base = tp_mark_position(row, i, k, valid[b], low, high,
                                               tabs, nt, hf, hr);
            // slots 0..3: in-edges c·V, 4..7: out-edges V·c, c = A, C, G, T
            for (int s = 0; s < 8; ++s) {
                if (base) tp_edge_hashes(hf, hr, tabs, nt, s >= 4, s & 3u, k, e);
                for (int j = 0; j < q; ++j)
                    visit(s * q + j, base ? tp_km_index(e, (uint32_t)j, f) : SENT);
            }
            return;
        }
        TpFillPos p;
        unsigned slots = 0;
        if (tp_fill_position(row, i, k, valid[b], low, high, tabs, nt, p) &&
            (p.in_v || p.in_n))
            slots = tp_fill_slots(p);
        for (int s = 0; s < 4; ++s) {
            const bool on = (slots >> s) & 1u;
            if (on) tp_fill_edge(p, tabs, nt, s, k, e);
            for (int j = 0; j < q; ++j)
                visit(s * q + j, on ? tp_km_index(e, (uint32_t)j, f) : SENT);
        }
    }

    // cnt[c] = indices of position t owned by shard d0 + c (t >= n_pos: 0)
    __device__ __forceinline__ void owner_counts(long long t, int D, int d0,
                                                 uint32_t* cnt) const {
#pragma unroll
        for (int c = 0; c < SHARD_DC; ++c) cnt[c] = 0;
        if (t >= n_pos()) return;
        indices(t, [&](int, uint64_t x) {
            const uint32_t o = owner_of(x, D);
            if (o >= (uint32_t)D) return;
#pragma unroll
            for (int c = 0; c < SHARD_DC; ++c) cnt[c] += o - d0 == (uint32_t)c;
        });
    }
};

// counts[d * nt + tile] = indices of tile blockIdx.x (TP_THREADS positions)
// owned by shard d
__global__ void k_shard_count(ShardBatch bt, int D,
                              uint32_t* __restrict__ counts, size_t nt) {
    __shared__ uint32_t s_w[TP_WARPS][SHARD_DC];
    const long long t = (long long)blockIdx.x * TP_THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int d0 = 0; d0 < D; d0 += SHARD_DC) {
        uint32_t cnt[SHARD_DC];
        bt.owner_counts(t, D, d0, cnt);
#pragma unroll
        for (int c = 0; c < SHARD_DC; ++c) {
            const uint32_t w = __reduce_add_sync(0xffffffffu, cnt[c]);
            if (lane == 0) s_w[warp][c] = w;
        }
        __syncthreads();
        const int c = threadIdx.x;
        if (c < SHARD_DC && d0 + c < D) {
            uint32_t tot = 0;
            for (int v = 0; v < TP_WARPS; ++v) tot += s_w[v][c];
            counts[(size_t)(d0 + c) * nt + blockIdx.x] = tot;
        }
        __syncthreads();
    }
}

// The stable scatter of tile blockIdx.x: an index's rank among its owner's
// is the owner's offset for the tile (the scanned counts), plus the
// owner's indices in lower threads of the tile, plus those before it in
// its own thread. Ranks past cap are dropped (their probe slot NOT_SENT).
__global__ void k_shard_scatter(ShardBatch bt, int D, int cap,
                                const uint32_t* __restrict__ counts,
                                const uint32_t* __restrict__ incl, size_t nt,
                                uint64_t* __restrict__ send,
                                uint32_t* __restrict__ probe_slot) {
    __shared__ uint32_t s_w[TP_WARPS][SHARD_DC];
    __shared__ uint32_t s_base[SHARD_DC];
    const long long n = bt.n_pos();
    const long long t = (long long)blockIdx.x * TP_THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int d0 = 0; d0 < D; d0 += SHARD_DC) {
        const int c0 = threadIdx.x;
        if (c0 < SHARD_DC && d0 + c0 < D) {
            const size_t first = (size_t)(d0 + c0) * nt;
            const size_t slot = first + blockIdx.x;
            // offset of this tile's first index among owner d0 + c0's
            s_base[c0] = (incl[slot] - counts[slot]) - (incl[first] - counts[first]);
        }
        uint32_t cur[SHARD_DC];
        bt.owner_counts(t, D, d0, cur);
#pragma unroll
        for (int c = 0; c < SHARD_DC; ++c) {
            uint32_t x = cur[c];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
                if (lane >= o) x += y;
            }
            if (lane == 31) s_w[warp][c] = x;
            cur[c] = x - cur[c];  // exclusive within the warp
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < SHARD_DC; ++c) {
            uint32_t b = s_base[c];
            for (int v = 0; v < warp; ++v) b += s_w[v][c];
            cur[c] += b;
        }
        if (t < n)
            bt.indices(t, [&](int j, uint64_t x) {
                const uint32_t o = owner_of(x, D);
                uint32_t* ps = probe_slot != nullptr
                                   ? probe_slot + (size_t)j * n + t
                                   : nullptr;
                if (o >= (uint32_t)D) {
                    if (ps != nullptr && d0 == 0) *ps = NOT_SENT;
                    return;
                }
                const uint32_t c = o - (uint32_t)d0;
                if (c >= (uint32_t)SHARD_DC) return;  // another chunk's
                uint32_t r = 0;
#pragma unroll
                for (int cc = 0; cc < SHARD_DC; ++cc)
                    if (c == (uint32_t)cc) r = cur[cc]++;
                const bool sent = r < (uint32_t)cap;
                if (sent) send[(size_t)o * cap + r] = local_of(x, D);
                if (ps != nullptr) *ps = sent ? o * (uint32_t)cap + r : NOT_SENT;
            });
        __syncthreads();
    }
}

__global__ void k_shard_finish(const uint32_t* __restrict__ counts,
                               const uint32_t* __restrict__ incl, size_t nt,
                               int D, int cap, uint64_t* __restrict__ send,
                               unsigned long long* __restrict__ overflow) {
    tp_route_finish(counts, incl, nt, D, cap, overflow,
                    [&](size_t t) { send[t] = SENT; });
}

// Set slot s, storing only when it is not set yet: in a run over related
// genomes most slots were set by an earlier batch, and reading a random
// sector costs less than its read-modify-write (dist-bloom -f 30 on the
// slice: 25.6 -> 17.4 ms over the fill's 492 launches, H100)
__device__ __forceinline__ void set_slot(void* filt, int layout, uint64_t s) {
    if (layout == TP_LAYOUT_BYTE) {
        uint8_t* b = (uint8_t*)filt + s;
        if (*b == 0) *b = 1;
    } else {
        uint32_t* w = (uint32_t*)filt + (s >> 5);
        const uint32_t bit = 1u << (s & 31);
        if (!(*w & bit)) atomicOr(w, bit);
    }
}

// Block (chunk, row) of the received (D, cap) block sets the sent slots of
// its FILL_CHUNK slots of row blockIdx.y. A row is a prefix of sent slots,
// then SENT (the bucketing writes each owner's in rank order): a chunk
// that starts unsent is unsent to the row's end, and a thread stops at its
// first SENT. VEC: 16-byte loads (row starts 16-byte aligned, cap even),
// all of a thread's loads in flight before its stores.
template <bool VEC>
__global__ void k_shard_fill_apply(const uint64_t* __restrict__ recv,
                                   size_t cap, int layout, void* filt) {
    const uint64_t* row = recv + (size_t)blockIdx.y * cap;
    const size_t c0 = (size_t)blockIdx.x * FILL_CHUNK;
    if (row[c0] == SENT) return;
    const size_t len = cap - c0 < FILL_CHUNK ? cap - c0 : FILL_CHUNK;
    if (VEC) {
        constexpr int PAIRS = FILL_CHUNK / (2 * TP_THREADS);
        const ulonglong2* r2 = reinterpret_cast<const ulonglong2*>(row + c0);
        ulonglong2 v[PAIRS];
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            const size_t t = (size_t)q * TP_THREADS + threadIdx.x;
            v[q] = 2 * t < len ? r2[t] : make_ulonglong2(SENT, SENT);
        }
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            if (v[q].x == SENT) return;
            set_slot(filt, layout, v[q].x);
            if (v[q].y == SENT) return;
            set_slot(filt, layout, v[q].y);
        }
    } else {
        constexpr int ITEMS = FILL_CHUNK / TP_THREADS;
        uint64_t v[ITEMS];
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
            const size_t t = (size_t)q * TP_THREADS + threadIdx.x;
            v[q] = t < len ? row[c0 + t] : SENT;
        }
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
            if (v[q] == SENT) return;
            set_slot(filt, layout, v[q]);
        }
    }
}

__global__ void k_shard_probe(const uint64_t* __restrict__ recv, size_t n,
                              int layout, const void* __restrict__ filt,
                              uint8_t* __restrict__ hits) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const uint64_t s = recv[t];
    uint8_t h = 0;
    if (s != SENT)
        h = layout == TP_LAYOUT_BYTE
                ? (((const uint8_t*)filt)[s] != 0)
                : (uint8_t)((((const uint32_t*)filt)[s >> 5] >> (s & 31)) & 1u);
    hits[t] = h;
}

__global__ void k_shard_mark_finish(const uint8_t* __restrict__ back,
                                    const uint32_t* __restrict__ probe_slot,
                                    const uint32_t* __restrict__ packed,
                                    const uint32_t* __restrict__ nmask,
                                    const int32_t* __restrict__ valid, int B,
                                    int P, int k, int RW, int NW,
                                    uint32_t low, uint32_t high, TpTabs tabs,
                                    int q, uint8_t* __restrict__ mask,
                                    unsigned long long* __restrict__ count) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long n = (long long)B * P;
    bool cand = false;
    if (t < n) {
        const int b = (int)(t / P);
        const int i = (int)(t - (long long)b * P);
        const TpRow row{packed + (size_t)b * RW, nmask + (size_t)b * NW};
        uint32_t hf[4], hr[4];
        if (tp_mark_position(row, i, k, valid[b], low, high, tabs, 1, hf, hr)) {
            cand = tp_mark_decide(row.ext(i), row.ext(i + k + 1),
                                  [&](int side, uint32_t c) {
                const int e = (side * 4 + (int)c) * q;
                for (int j = 0; j < q; ++j) {
                    const uint32_t s = probe_slot[(size_t)(e + j) * n + t];
                    if (s == NOT_SENT || !back[s]) return false;
                }
                return true;
            });
        }
    }
    tp_pack_candidates(cand, t, n, mask, count);
}

// tiles of TP_THREADS positions (at least one)
size_t shard_tiles(size_t n_pos) {
    return std::max<size_t>((n_pos + TP_THREADS - 1) / TP_THREADS, 1);
}

TpTabs load_tabs(const uint32_t* tabs) {
    TpTabs tt;
    for (int u = 0; u < 4; ++u)
        for (int c = 0; c < 4; ++c) tt.t[u].t[c] = tabs[4 * u + c];
    return tt;
}

}  // namespace

// u32 words of each of tp_shard_bucket's count tables (counts, incl)
extern "C" size_t tp_shard_count_words(size_t n_pos, int D) {
    return (size_t)D * shard_tiles(n_pos);
}

// Bucket one batch's fill (mark = 0) or mark (mark = 1) indices by owner.
// The batch: B rows of the upload form (packed, nmask, valid; RW, NW words a
// row), P positions a row, the round [low, high]; tabs, q, f as
// tp_bloom_fill (f > 32: 64-bit indices). Scratch (sized by the caller):
// counts and incl (tp_shard_count_words(B*P, D) u32), the scan scratch
// (tp_scan_scratch_words of that). Outputs: send (D, cap) u64; probe_slot
// ((8q, B*P) u32 in mark mode, null in fill mode); overflow (one int64,
// added to).
extern "C" int tp_shard_bucket(const void* packed, const void* nmask,
                               const void* valid, int B, int P, int k, int RW,
                               int NW, uint32_t low, uint32_t high,
                               const uint32_t* tabs, int q, int f, int mark,
                               int D, int cap, void* counts, void* incl,
                               void* scratch, void* send, void* probe_slot,
                               void* overflow, void* stream) {
    if (D < 1 || D > TP_ROUTE_MAX || cap < 1 || q < 1 ||
        (mark && probe_slot == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const ShardBatch bt{(const uint32_t*)packed, (const uint32_t*)nmask,
                        (const int32_t*)valid, B, P, k, RW, NW, low, high,
                        load_tabs(tabs), q, f, mark};
    const size_t nt = shard_tiles((size_t)B * P);
    uint32_t* cnt = (uint32_t*)counts;
    uint32_t* inc = (uint32_t*)incl;
    k_shard_count<<<(unsigned)nt, TP_THREADS, 0, st>>>(bt, D, cnt, nt);
    TP_LAUNCH_CHECK();
    cudaError_t e = tp_scan_inclusive_u32(cnt, inc, (size_t)D * nt,
                                          (uint32_t*)scratch, st);
    if (e != cudaSuccess) return (int)e;
    k_shard_scatter<<<(unsigned)nt, TP_THREADS, 0, st>>>(
        bt, D, cap, cnt, inc, nt, (uint64_t*)send,
        mark ? (uint32_t*)probe_slot : nullptr);
    TP_LAUNCH_CHECK();
    const size_t slots = std::max((size_t)D * cap, (size_t)D);
    k_shard_finish<<<tp_blocks(slots, TP_THREADS), TP_THREADS, 0, st>>>(
        cnt, inc, nt, D, cap, (uint64_t*)send, (unsigned long long*)overflow);
    return (int)cudaGetLastError();
}

// Set the received local slots recv ((D, cap) u64: row d from shard d, a
// prefix of sent slots, then all-ones) in the shard filt: layout 0 byte
// (u8 slots), 1 bit (u32 words).
extern "C" int tp_shard_fill_apply(const void* recv, size_t rows, size_t cap,
                                   int layout, void* filt, void* stream) {
    if (rows == 0 || cap == 0) return 0;
    if (rows > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(tp_blocks(cap, FILL_CHUNK), (unsigned)rows);
    const cudaStream_t st = (cudaStream_t)stream;
    const uint64_t* r = (const uint64_t*)recv;
    if ((uintptr_t)recv % 16 == 0 && cap % 2 == 0)
        k_shard_fill_apply<true><<<grid, TP_THREADS, 0, st>>>(r, cap, layout, filt);
    else
        k_shard_fill_apply<false><<<grid, TP_THREADS, 0, st>>>(r, cap, layout, filt);
    return (int)cudaGetLastError();
}

// hits[t] = 1 where received local slot recv[t] is set in filt (all-ones:
// 0); n u8.
extern "C" int tp_shard_probe(const void* recv, size_t n, int layout,
                              const void* filt, void* hits, void* stream) {
    if (n == 0) return 0;
    k_shard_probe<<<tp_blocks(n, TP_THREADS), TP_THREADS, 0,
                    (cudaStream_t)stream>>>((const uint64_t*)recv, n, layout,
                                            filt, (uint8_t*)hits);
    return (int)cudaGetLastError();
}

// The candidate mask of a batch from the hits sent back: back (D*cap u8,
// indexed by the probe slots of tp_shard_bucket's mark mode), probe_slot
// ((8q, B*P) u32), the batch and round as tp_shard_bucket's. Outputs: mask
// (B*P/8 u8, P % 8 == 0), count (one int64, added to).
extern "C" int tp_shard_mark_finish(const void* back, const void* probe_slot,
                                    const void* packed, const void* nmask,
                                    const void* valid, int B, int P, int k,
                                    int RW, int NW, uint32_t low,
                                    uint32_t high, const uint32_t* tabs, int q,
                                    void* mask, void* count, void* stream) {
    const long long n = (long long)B * P;
    if (n == 0) return 0;
    if (P % 8 != 0 || q < 1) return (int)cudaErrorInvalidValue;
    k_shard_mark_finish<<<tp_blocks((size_t)n, TP_THREADS), TP_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)back, (const uint32_t*)probe_slot,
        (const uint32_t*)packed, (const uint32_t*)nmask,
        (const int32_t*)valid, B, P, k, RW, NW, low, high, load_tabs(tabs), q,
        (uint8_t*)mask, (unsigned long long*)count);
    return (int)cudaGetLastError();
}
