// The packed merge on the card: N keyed entries (rounds, or a round's
// shards) into the global junction table and one position-sorted key
// buffer (passes/merge.py), as merges of sorted runs.
//
// Replaces the host merge of twopaco_tpu/passes/sortpipe.py:1539-1655
// merge_rounds_packed (a numpy argsort of the tables, a remap of every id,
// a sort of the keys), which runs on the host because of the TPU's slow
// D2H link. The entries' tables are sorted, disjoint runs, and their keys
// are runs sorted by position (positions are unique across entries). Both
// are N-way merges of sorted runs:
// - tp_merge_rows: the tables' rows (w words, word 0 first) into the global
//   table; inv[r] = the global row of concatenated row r; rows equal to the
//   row before them counted (a k-mer in two entries: the caller raises);
// - tp_merge_keys: the keys by position (the bits above id_bits), each id
//   rewritten to its global id, +-(inv[row_ofs[e] + |id| - 1] + 1) + bias;
//   ids of 0 and ids past their entry's table (or past inv) counted, their
//   keys kept as they were, as occ_pack.cu counts its bad occurrences.
// The order is the stable merge: equal elements in entry order, as a
// stable sort of the concatenation gives them.
//
// Bound: bytes. Rows: the tables read once, the global table and inv
// written once (8w + 4 bytes a row); keys: each key read and written once,
// and each distinct 32-byte inv sector the ids reach. On the card the keys'
// tiles take ~5x that (PERF.md row 18): each id's inv load moves a 32-byte
// L2 sector (the windows' slack included), the merge levels are bound by
// shared-memory bandwidth, and the split is a chain of dependent loads.
//
// Design: merge path over tiles of output ranks, two launches a round.
// - k_merge_split: every S-th element of each run (a sample) gets its rank
//   in the merge by a binary search of each other run (a lane a run), then
//   writes its run's window at the tile boundaries between its rank and the
//   next sample's: the run's elements ranking before the boundary number
//   within S of the sample's index (L, U).
// - k_merge_tile: a block a tile of `tile` output ranks stages each run's
//   window (the run's elements of the tile and at most 2S more) in shared
//   memory with cp.async, merges the windows in shared memory as a tree of
//   two-way merge paths (log2 N levels, a thread V outputs a level after one
//   diagonal search; keys by value, their ids rewritten where staged, with
//   their inv loads in flight together; rows by their indices), and stores
//   the tile's part of the merged windows coalesced; inv is written at the
//   rows' concatenated indices. A run's faults are counted by the tile whose
//   boundaries' U values bracket them, so each key once.
// Below a window lie only elements that rank before every element of the
// tile, so an element's rank is the windows' lower ends summed plus its
// place in the merged windows (merge.py merge_splits_plain is the split
// arithmetic, held against brute force). More runs than the fan-in (at most
// 32: the split's lanes) merge in rounds of fan-in runs, each round one more
// read and write; a later round's row map is composed into inv.
#include "common.cuh"

namespace {

constexpr int MERGE_V = 7;         // outputs a thread takes at a level (odd: no bank conflicts)
constexpr int MERGE_FAN_MAX = 32;  // runs a group at most: a warp's lanes
constexpr int SPLIT_THREADS = 256;
constexpr int TILE_THREADS = 256;
constexpr int SMEM_MAX = 200 * 1024;  // dynamic shared bytes a tile block
constexpr int STAGED_MAX = 1 << 16;   // staged elements a tile block: 16-bit indices

// The runs of a round: run f is the entries [f * stride, (f + 1) * stride)
// of the n_entries runs at ofs (n_entries + 1 offsets), in groups of fan
// runs, each group merged on its own
struct Runs {
    const long long* ofs;
    int n_entries, n_runs, fan;
    long long stride;

    __device__ __forceinline__ long long start(int f) const {
        const long long e = f * stride;
        return __ldg(ofs + (e < n_entries ? e : n_entries));
    }
};

// Elements are rows of ew u32 words, word 0 first, or u64 keys (ew = 2)
// compared by their bits from `shift` (the position)
template <bool KEYS>
__device__ __forceinline__ int elem_cmp(const uint32_t* a, const uint32_t* b, int ew,
                                        int shift) {
    if constexpr (KEYS) {
        const unsigned long long x = *(const unsigned long long*)a >> shift;
        const unsigned long long y = *(const unsigned long long*)b >> shift;
        return (x > y) - (x < y);
    } else {
        for (int j = 0; j < ew; ++j)
            if (a[j] != b[j]) return a[j] < b[j] ? -1 : 1;
        return 0;
    }
}

// The first index in [lo, hi) of a sorted run whose element does not rank
// before x in the stable merge (below x, or equal and of an earlier run:
// upper); hi if none
template <bool KEYS, class I>
__device__ __forceinline__ I count_before(const uint32_t* run, I lo, I hi, int ew, int shift,
                                          const uint32_t* x, bool upper) {
    while (lo < hi) {
        const I mid = lo + ((hi - lo) >> 1);
        const int c = elem_cmp<KEYS>(run + (size_t)mid * ew, x, ew, shift);
        if (c < 0 || (upper && c == 0)) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

struct SplitArgs {
    const uint32_t* in;  // the round's runs, ew words an element
    int ew, shift;
    Runs runs;
    int S, tile;
    int lanes;       // a power of two >= width, dividing 32
    int width;       // columns of the window table: min(fan, n_runs)
    long long tmax;  // tiles a group at most
    long long* wt;   // [group][tmax + 1 boundaries][width] x (L, U)
};

// A block (x: a chunk of `per` sample slots, y: a group): run l of the
// group has its samples i = 0 .. ceil(len / S) - 1 at slots (start(l) -
// start(0)) / S + l + i; a group of `lanes` lanes a slot, and one more slot
// (the next sample's rank bounds a sample's boundaries).
template <bool KEYS>
__global__ void __launch_bounds__(SPLIT_THREADS) k_merge_split(SplitArgs a) {
    __shared__ long long s_start[MERGE_FAN_MAX + 1];
    __shared__ long long s_rank[SPLIT_THREADS + 1], s_sample[SPLIT_THREADS + 1];
    __shared__ int s_run[SPLIT_THREADS + 1];
    const Runs& R = a.runs;
    const int ew = a.ew;
    const int f0 = blockIdx.y * R.fan;
    const int nf = min(R.fan, R.n_runs - f0);
    if (threadIdx.x <= nf) s_start[threadIdx.x] = R.start(f0 + threadIdx.x);
    __syncthreads();
    const long long gs = s_start[0], size = s_start[nf] - gs;
    const int per = SPLIT_THREADS / a.lanes;
    const long long s0 = (long long)blockIdx.x * per;
    if (s0 > size / a.S + nf) return;  // past the group's slots (the whole block)
    const int lane = threadIdx.x % a.lanes;
    // every lane runs every step (the shuffles take the whole warp)
    for (int q0 = 0; q0 <= per; q0 += per) {
        const int q = q0 + threadIdx.x / a.lanes;
        const long long s = s0 + q;
        int f = 0;  // the last run whose first slot is <= s
        while (f + 1 < nf && (s_start[f + 1] - gs) / a.S + f + 1 <= s) ++f;
        const long long len = s_start[f + 1] - s_start[f];
        const long long i = s - ((s_start[f] - gs) / a.S + f);
        const bool valid = q <= per && i >= 0 && i * a.S < len;
        long long c = 0;
        if (valid) {
            const int h = lane;
            if (h == f) {
                c = i * a.S;
            } else if (h < nf) {
                c = count_before<KEYS, long long>(a.in + (size_t)s_start[h] * ew, 0,
                                                  s_start[h + 1] - s_start[h], ew, a.shift,
                                                  a.in + (size_t)(s_start[f] + i * a.S) * ew,
                                                  h < f);
            }
        }
        for (int o = a.lanes >> 1; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
        if (q <= per && lane == 0) {
            s_rank[q] = c;
            s_sample[q] = valid ? i : -1;
            s_run[q] = f;
        }
    }
    __syncthreads();
    const int q = threadIdx.x;
    if (q >= per || s_sample[q] < 0) return;
    const long long i = s_sample[q], r = s_rank[q];
    const int f = s_run[q];
    const long long ntiles = (size + a.tile - 1) / a.tile;
    const long long len = s_start[f + 1] - s_start[f];
    const bool last = (i + 1) * a.S >= len;
    long long* wt = a.wt + ((size_t)blockIdx.y * (a.tmax + 1) * a.width + f) * 2;
    // boundary t (t * tile, or size for t = ntiles) with rank(sample i) <
    // t * tile <= rank(sample i + 1): L = i * S + 1, U = (i + 1) * S (len
    // after the last sample); before sample 0: L = U = 0
    auto put = [&](long long t_lo, long long t_hi, long long L, long long U) {
        for (long long t = t_lo; t <= t_hi; ++t) {
            wt[t * a.width * 2] = L;
            wt[t * a.width * 2 + 1] = U;
        }
    };
    if (i == 0) put(0, r / a.tile, 0, 0);
    put(r / a.tile + 1, last ? ntiles : s_rank[q + 1] / a.tile, i * a.S + 1,
        last ? len : (i + 1) * a.S);
}

struct TileArgs {
    const uint32_t* in;
    int ew, shift;
    Runs runs;
    int tile, width, wcap;  // wcap: staged elements a block at most
    long long tmax;
    const long long* wt;
    uint32_t* out;
    // rows: inv[index in `in`] = rank in `out`; dup (null: not counted)
    int32_t* inv;
    unsigned long long* dup;
    // keys: ids rewritten through gids where row_ofs is not null (the
    // first round: a run an entry); faults (ids 0, ids past) added to
    const long long* row_ofs;
    const int32_t* gids;
    long long n_gids;
    unsigned long long* faults;
};

// A staged row's index: its run << 16 | its place in the staged windows
__device__ __forceinline__ int staged_at(uint32_t e) { return (int)(e & 0xffffu); }

// The tree of two-way merges of the nf runs at offsets s_ofs of x (in run
// order): runs 2p and 2p + 1 of a level into run p of the next (an odd last
// run copied), ties to the earlier run; a thread MERGE_V outputs after one
// merge path search, the heads of both runs in registers. Ping-pongs
// between x and y; -> the array that holds the merged runs. Every thread of
// the block calls.
template <class T, class Less>
__device__ __forceinline__ T* merge_levels(T* x, T* y, int nf, int* s_ofs, int* s_cofs,
                                           Less less) {
    for (int m = nf; m > 1; m = (m + 1) >> 1) {
        const int np = (m + 1) >> 1;
        if (threadIdx.x == 0) {
            int co = 0;
            for (int p = 0; p < np; ++p) {
                s_cofs[p] = co;
                co += (s_ofs[min(2 * p + 2, m)] - s_ofs[2 * p] + MERGE_V - 1) / MERGE_V;
            }
            s_cofs[np] = co;
        }
        __syncthreads();
        for (int c = threadIdx.x; c < s_cofs[np]; c += TILE_THREADS) {
            int p = 0;
            while (s_cofs[p + 1] <= c) ++p;
            const int o0 = s_ofs[2 * p], o1 = s_ofs[min(2 * p + 1, m)];
            const int la = o1 - o0, lb = s_ofs[min(2 * p + 2, m)] - o1;
            const int d = (c - s_cofs[p]) * MERGE_V;
            int lo = max(0, d - lb), hi = min(d, la);  // a's elements among the first d
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (!less(x[o1 + d - 1 - mid], x[o0 + mid])) lo = mid + 1;
                else hi = mid;
            }
            int i = lo, j = d - lo;
            T ea = i < la ? x[o0 + i] : T(), eb = j < lb ? x[o1 + j] : T();
            const int end = min(d + MERGE_V, la + lb);
            for (int k = d; k < end; ++k) {
                if (i < la && (j >= lb || !less(eb, ea))) {
                    y[o0 + k] = ea;
                    if (++i < la) ea = x[o0 + i];
                } else {
                    y[o0 + k] = eb;
                    if (++j < lb) eb = x[o1 + j];
                }
            }
        }
        __syncthreads();
        if (threadIdx.x == 0)
            for (int p = 0; p <= np; ++p) s_ofs[p] = s_ofs[min(2 * p, m)];
        T* t = x;
        x = y;
        y = t;
        __syncthreads();
    }
    return x;
}

constexpr int REMAP_U = 4;  // keys a thread rewrites at once (their inv loads in flight)

template <bool KEYS>
__global__ void __launch_bounds__(TILE_THREADS) k_merge_tile(TileArgs a) {
    extern __shared__ __align__(16) uint32_t s_mem[];
    __shared__ long long s_start[MERGE_FAN_MAX], s_lo[MERGE_FAN_MAX], s_cut[MERGE_FAN_MAX];
    __shared__ long long s_r0[MERGE_FAN_MAX], s_nrows[MERGE_FAN_MAX];
    __shared__ int s_wofs[MERGE_FAN_MAX + 1], s_ofs[MERGE_FAN_MAX + 1];
    __shared__ int s_cofs[MERGE_FAN_MAX / 2 + 2];
    __shared__ long long s_below;  // the elements below the windows
    __shared__ unsigned long long s_count[2];
    const Runs& R = a.runs;
    const int ew = a.ew;
    const int f0 = blockIdx.y * R.fan;
    const int nf = min(R.fan, R.n_runs - f0);
    const long long gs = R.start(f0);
    const long long size = R.start(f0 + nf) - gs;
    const long long b0 = (long long)blockIdx.x * a.tile;
    // a thread a run: its offsets and its window, loads issued together (a
    // run with no element has no window entries: its loads are not used)
    const int l = threadIdx.x;
    long long st = 0, en = 0, w_lo = 0, w_cut = 0, w_hi = 0, r0 = 0, r1 = 0;
    if (l < nf) {
        const long long* w =
            a.wt + (((size_t)blockIdx.y * (a.tmax + 1) + blockIdx.x) * a.width + l) * 2;
        st = R.start(f0 + l);
        en = R.start(f0 + l + 1);
        w_lo = w[0];
        w_cut = w[1];
        w_hi = w[a.width * 2 + 1];
        if (KEYS && a.row_ofs) {
            r0 = __ldg(a.row_ofs + f0 + l);
            r1 = __ldg(a.row_ofs + f0 + l + 1);
        }
    }
    if (b0 >= size) return;
    const int cnt = (int)min((long long)a.tile, size - b0);
    uint32_t* s_win = s_mem;  // the staged windows; rows: then two index arrays
    if (l < nf) {
        const bool any = en > st;  // [L - 1, U'): the row before the window checks duplicates
        s_start[l] = st;
        s_lo[l] = any ? max(w_lo - 1, 0ll) : 0;
        s_cut[l] = any ? w_cut : 0;
        s_ofs[l] = any ? (int)(w_hi - s_lo[l]) : 0;
        s_r0[l] = r0;
        s_nrows[l] = r1 - r0;
    }
    if (threadIdx.x < 2) s_count[threadIdx.x] = 0;
    __syncthreads();
    if (threadIdx.x == 0) {
        int wo = 0;
        long long below = 0;
        for (int l = 0; l < nf; ++l) {
            const int len = s_ofs[l];
            s_wofs[l] = s_ofs[l] = wo;
            wo += len;
            below += s_lo[l];
        }
        s_wofs[nf] = s_ofs[nf] = wo;
        s_below = below;
        // a split past its bound: never staged out of bounds
        if (wo > a.wcap || b0 - below < 0 || b0 - below + cnt > wo) __trap();
    }
    __syncthreads();
    for (int l = 0; l < nf; ++l) {
        const uint32_t* src = a.in + (size_t)(s_start[l] + s_lo[l]) * ew;
        const int o = s_wofs[l], n = s_wofs[l + 1] - o;
        uint32_t* dst = s_win + (size_t)o * ew;
        if constexpr (KEYS) {
            for (int j = threadIdx.x; j < n; j += TILE_THREADS)
                tp_cp_async<8>(dst + 2 * j, src + 2 * j);
        } else {
            uint32_t* ia = s_win + (size_t)a.wcap * ew;
            for (int j = threadIdx.x; j < n * ew; j += TILE_THREADS)
                tp_cp_async<4>(dst + j, src + j);
            for (int j = threadIdx.x; j < n; j += TILE_THREADS)
                ia[o + j] = (uint32_t)l << 16 | (o + j);
        }
    }
    tp_cp_async_wait_all();
    __syncthreads();

    // the tile: places [b0 - below, + cnt) of the merged windows
    const int base = (int)(b0 - s_below);
    unsigned long long n0 = 0, n1 = 0;  // rows: duplicates; keys: ids 0, ids past
    if constexpr (KEYS) {
        unsigned long long* sk = (unsigned long long*)s_win;
        if (a.row_ofs) {
            // the ids rewritten where they are staged (positions stay); the
            // faults counted for elements [U(b_t), U(b_t+1)) of each run, a
            // partition of the run over the tiles
            const unsigned long long id_mask = (1ull << a.shift) - 1ull;
            const long long bias = 1ll << (a.shift - 1);
            const int n = s_wofs[nf];
            for (int j0 = threadIdx.x; j0 < n; j0 += TILE_THREADS * REMAP_U) {
                int run[REMAP_U];
                long long id[REMAP_U];
                int fault[REMAP_U];  // 0 none, 1 id 0, 2 past its table
                int32_t g[REMAP_U];
#pragma unroll
                for (int u = 0; u < REMAP_U; ++u) {
                    const int j = j0 + u * TILE_THREADS;
                    int l = 0;
                    while (l + 1 < nf && j >= s_wofs[l + 1]) ++l;
                    run[u] = l;
                    id[u] = j < n ? (long long)(sk[j] & id_mask) - bias : 1;
                    const long long mag = id[u] < 0 ? -id[u] : id[u];
                    fault[u] = id[u] == 0 ? 1 : (mag > s_nrows[l] || s_r0[l] + mag > a.n_gids) ? 2 : 0;
                    g[u] = fault[u] ? 0 : __ldg(a.gids + s_r0[l] + mag - 1);
                }
#pragma unroll
                for (int u = 0; u < REMAP_U; ++u) {
                    const int j = j0 + u * TILE_THREADS, l = run[u];
                    if (j >= n) continue;
                    if (fault[u]) {
                        (fault[u] == 1 ? n0 : n1) += s_lo[l] + j - s_wofs[l] >= s_cut[l];
                    } else {
                        const long long gid = (long long)g[u] + 1;
                        sk[j] = (sk[j] & ~id_mask) |
                                (unsigned long long)((id[u] < 0 ? -gid : gid) + bias);
                    }
                }
            }
            __syncthreads();
        }
        const int shift = a.shift;
        const unsigned long long* merged = merge_levels(
            sk, sk + a.wcap, nf, s_ofs, s_cofs,
            [shift](unsigned long long x, unsigned long long y) { return x >> shift < y >> shift; });
        unsigned long long* o = (unsigned long long*)a.out + gs + b0;
        for (int j = threadIdx.x; j < cnt; j += TILE_THREADS) o[j] = merged[base + j];
    } else {
        uint32_t* ia = s_win + (size_t)a.wcap * ew;
        const uint32_t* merged = merge_levels(
            ia, ia + a.wcap, nf, s_ofs, s_cofs, [&](uint32_t x, uint32_t y) {
                return elem_cmp<false>(s_win + staged_at(x) * ew, s_win + staged_at(y) * ew, ew,
                                       0) < 0;
            });
        uint32_t* o = a.out + (size_t)(gs + b0) * ew;
        for (int t = threadIdx.x; t < cnt * ew; t += TILE_THREADS)
            o[t] = s_win[staged_at(merged[base + t / ew]) * ew + t % ew];
        for (int j = threadIdx.x; j < cnt; j += TILE_THREADS) {
            const uint32_t e = merged[base + j];
            const int l = (int)(e >> 16), at = staged_at(e);
            a.inv[s_start[l] + s_lo[l] + at - s_wofs[l]] = (int32_t)(gs + b0 + j);
            // the row before it in the merge (staged: the windows reach one
            // row below the tile)
            if (a.dup && base + j > 0 &&
                elem_cmp<false>(s_win + staged_at(merged[base + j - 1]) * ew, s_win + at * ew,
                                ew, 0) == 0)
                ++n0;
        }
    }
    if (n0) atomicAdd(&s_count[0], n0);
    if (n1) atomicAdd(&s_count[1], n1);
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long* to = KEYS ? a.faults : a.dup;
        if (to && s_count[0]) atomicAdd(to, s_count[0]);
        if (KEYS && to && s_count[1]) atomicAdd(to + 1, s_count[1]);
    }
}

// inv[i] = step[inv[i]]: a later round's row map composed into inv
__global__ void k_merge_compose(int32_t* __restrict__ inv, const int32_t* __restrict__ step,
                                long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) inv[i] = step[inv[i]];
}

struct MergeCall {
    const void* in;
    long long n;
    int ew, shift;
    const long long* ofs;
    int n_entries, fan, tile;
    void* out;
    void* tmp;  // the earlier rounds' output (more than fan entries)
    long long* wt;
    long long wt_len;
    int32_t* inv;
    int32_t* tmp_inv;
    unsigned long long* dup;
    const long long* row_ofs;
    const int32_t* gids;
    long long n_gids;
    unsigned long long* faults;
};

template <bool KEYS>
cudaError_t merge_rounds(const MergeCall& c, cudaStream_t st) {
    static std::atomic<uint64_t> ready{0};
    cudaError_t e = tp_once_per_device(ready, [] {
        return cudaFuncSetAttribute(k_merge_tile<KEYS>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    });
    if (e != cudaSuccess) return e;
    int rounds = 1;
    for (long long s = c.fan; s < c.n_entries; s *= c.fan) ++rounds;
    if (rounds > 1 && (!c.tmp || (!KEYS && !c.tmp_inv))) return cudaErrorInvalidValue;
    const long long tmax = (c.n + c.tile - 1) / c.tile;
    const void* in = c.in;
    long long stride = 1;
    for (int r = 0; r < rounds; ++r, stride *= c.fan) {
        const Runs R{c.ofs, c.n_entries, (int)((c.n_entries + stride - 1) / stride), c.fan,
                     stride};
        const int width = min(c.fan, R.n_runs);
        const int groups = (R.n_runs + c.fan - 1) / c.fan;
        int lanes = 1;
        while (lanes < width) lanes <<= 1;
        const int S = max(1, c.tile / (2 * lanes));
        const int wcap = c.tile + width * 2 * S;
        const size_t smem = (size_t)wcap * (c.ew + 2) * 4;
        if ((long long)groups * (tmax + 1) * width * 2 > c.wt_len || wcap > STAGED_MAX ||
            smem > (size_t)SMEM_MAX)
            return cudaErrorInvalidValue;
        const SplitArgs sa{(const uint32_t*)in, c.ew, c.shift, R, S, c.tile, lanes, width, tmax,
                           c.wt};
        const int per = SPLIT_THREADS / lanes;
        const long long slots = c.n / S + width + 1;  // a group's at most
        k_merge_split<KEYS><<<dim3((unsigned)((slots + per - 1) / per), groups), SPLIT_THREADS,
                              0, st>>>(sa);
        TP_LAUNCH_CHECK();
        void* out = ((rounds - 1 - r) & 1) ? c.tmp : c.out;
        const TileArgs ta{(const uint32_t*)in, c.ew, c.shift, R, c.tile, width, wcap, tmax,
                          c.wt, (uint32_t*)out, r == 0 ? c.inv : c.tmp_inv,
                          r == rounds - 1 ? c.dup : nullptr, r == 0 ? c.row_ofs : nullptr,
                          c.gids, c.n_gids, c.faults};
        k_merge_tile<KEYS><<<dim3((unsigned)tmax, groups), TILE_THREADS, smem, st>>>(ta);
        TP_LAUNCH_CHECK();
        if (!KEYS && r > 0) {
            k_merge_compose<<<tp_blocks(c.n, TP_THREADS), TP_THREADS, 0, st>>>(c.inv, c.tmp_inv,
                                                                               c.n);
            TP_LAUNCH_CHECK();
        }
        in = out;
    }
    return cudaSuccess;
}

}  // namespace

// table (T, w) u32: the entries' sorted tables concatenated, row_ofs
// (n_entries + 1) int64 their offsets -> out (T, w) the stable merge, inv
// (T) int32 the global row of each concatenated row; dup (one int64) added
// to. Scratch: wt (wt_len int64: ceil(n_entries / fan) * (ceil(T / tile) +
// 1) * min(fan, n_entries) * 2), and past fan entries tmp (T, w) u32 and
// tmp_inv (T) int32.
extern "C" int tp_merge_rows(const void* table, long long T, int w, const void* row_ofs,
                             int n_entries, int fan, int tile, void* out, void* inv, void* dup,
                             void* wt, long long wt_len, void* tmp, void* tmp_inv,
                             void* stream) {
    if (w < 1 || n_entries < 1 || fan < 2 ||
        fan > MERGE_FAN_MAX || tile < 1 || T < 0 || T >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    if (T == 0) return 0;
    MergeCall c{};
    c.in = table;
    c.n = T;
    c.ew = w;
    c.ofs = (const long long*)row_ofs;
    c.n_entries = n_entries;
    c.fan = fan;
    c.tile = tile;
    c.out = out;
    c.tmp = tmp;
    c.wt = (long long*)wt;
    c.wt_len = wt_len;
    c.inv = (int32_t*)inv;
    c.tmp_inv = (int32_t*)tmp_inv;
    c.dup = (unsigned long long*)dup;
    return (int)merge_rounds<false>(c, (cudaStream_t)stream);
}

// keys (n u64): the entries' position-sorted runs concatenated; entries: 2 x
// (n_entries + 1) int64, the runs' key offsets, then the entries' table row
// offsets (into inv, n_inv rows, tp_merge_rows's) -> out (n u64) the keys
// with global ids in position order; faults: two int64 (ids 0, ids past
// their table), added to. Scratch: wt as tp_merge_rows's for n keys, and
// past fan entries tmp (n u64).
extern "C" int tp_merge_keys(const void* keys, long long n, const void* entries, int n_entries,
                             const void* inv, long long n_inv, int id_bits, int fan, int tile,
                             void* out, void* faults, void* wt, long long wt_len, void* tmp,
                             void* stream) {
    if (id_bits < 2 || id_bits > 62 || n_entries < 1 || n_inv < 0 || fan < 2 ||
        fan > MERGE_FAN_MAX || tile < 1 || n < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    MergeCall c{};
    c.in = keys;
    c.n = n;
    c.ew = 2;
    c.shift = id_bits;
    c.ofs = (const long long*)entries;
    c.n_entries = n_entries;
    c.fan = fan;
    c.tile = tile;
    c.out = out;
    c.tmp = tmp;
    c.wt = (long long*)wt;
    c.wt_len = wt_len;
    c.row_ofs = (const long long*)entries + n_entries + 1;
    c.gids = (const int32_t*)inv;
    c.n_gids = n_inv;
    c.faults = (unsigned long long*)faults;
    return (int)merge_rounds<true>(c, (cudaStream_t)stream);
}
