// K1: fused per-level admissibility test of the pattern-matching
// executor, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `level_expand_pallas`
// (src/repro/kernels/intersect.py:220, body `_level_expand_body` at :96).
// For every frontier row b and candidate column d:
//
//   ok[b,d] = valid[b,d]
//           ∧ ∀e: cand[b,d] {>,<,!=}[dirs[e]] extra[b,e]
//           ∧ ∀p: cand[b,d] ∈ flat[starts[p,b] : starts[p,b] + min(lens[p,b], window)]
//
// and writes ok as one byte per candidate (mask mode), or its row sum as
// one int32 per row (count mode), where columns d >= neg_from count -1
// (signed mode: the IEP prefix corrections ride along as negatively
// weighted candidates).
//
// This file holds the kernels of three entries.  `level_expand_kernel`
// takes the gathered window (cand, valid) and serves every mode: it is
// K1's reference-shaped entry, which the executor no longer launches.
// `level_rows_kernel` serves count and signed mode, where only the row
// sums are needed: it reads each candidate row from its CSR offset
// itself, so no window, validity mask or concatenated prefix columns
// are ever written to device memory.  The executor's mask levels run
// `level_compact_launch`: level_rows_kernel's counts, a scan of them
// (`level_compact_scan_kernel`) and `level_compact_kernel`, which
// searches again and writes the level's compacted frontier itself.
//
// level_expand_kernel.  One warp per frontier row, lanes striding over
// d (coalesced candidate reads); each valid candidate binary-searches
// each predecessor's sorted CSR row in device memory (mostly L2 hits:
// the graphs' flat arrays fit the 50 MB L2).  The cheap comparisons
// against `extra` run first and a failed predecessor ends the search.
// It is latency-bound: P * ceil(log2 W) dependent loads per candidate.
//
// level_rows_kernel and level_compact_kernel (see the notes above them)
// are the Hopper redesign of count, signed and mask mode.
//
// Contract (checked by the Python wrapper, kernels/ops.py): all arrays
// int32 and contiguous on one device, rows strictly increasing, the
// launch on the caller's stream; the function returns
// cudaGetLastError() so a refused launch surfaces at once.
#include <cuda_runtime.h>
#include <stdint.h>

#define LE_MAX_DIRS 16
#define LE_WARPS_PER_BLOCK 8

struct Dirs {
    int d[LE_MAX_DIRS];
};

// Is x in the sorted row flat[s, s + len)?  Lower-bound binary search.
__device__ __forceinline__ bool in_row(const int* __restrict__ flat,
                                       int s, int len, int x) {
    int lo = s, hi = s + len;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (__ldg(flat + mid) < x) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo < s + len && __ldg(flat + lo) == x;
}

__global__ void __launch_bounds__(LE_WARPS_PER_BLOCK * 32)
level_expand_kernel(const int* __restrict__ cand,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ flat,
                    const int* __restrict__ starts,
                    const int* __restrict__ lens,
                    const int* __restrict__ extra,
                    Dirs dirs, int n_dirs,
                    int B, int D, int P, int window,
                    int count, int neg_from,
                    uint8_t* __restrict__ mask_out,
                    int* __restrict__ count_out) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (long long)blockIdx.x * LE_WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= B) return;                      // the whole warp leaves
    const long long base = row * (long long)D;
    int acc = 0;
    for (int d = lane; d < D; d += 32) {
        const int c = cand[base + d];
        bool ok = valid == nullptr || valid[base + d] != 0;
        for (int e = 0; ok && e < n_dirs; ++e) {
            const int ev = extra[row * n_dirs + e];
            const int dir = dirs.d[e];
            ok = dir > 0 ? (c > ev) : (dir < 0 ? (c < ev) : (c != ev));
        }
        for (int p = 0; ok && p < P; ++p) {
            const long long k = (long long)p * B + row;
            const int len = min(lens[k], window);
            ok = len > 0 && in_row(flat, starts[k], len, c);
        }
        if (count) {
            acc += ok ? (d < neg_from ? 1 : -1) : 0;
        } else {
            mask_out[base + d] = ok ? 1 : 0;
        }
    }
    if (count) {
        for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        }
        if (lane == 0) count_out[row] = acc;
    }
}

extern "C" int level_expand_max_dirs() { return LE_MAX_DIRS; }

// Launches K1 on `stream`.  `valid` and `extra` may be null (no mask /
// no comparisons); `out` is uint8 [B, D] in mask mode and int32 [B] in
// count mode.  Returns cudaGetLastError() (0 = launched).
extern "C" int level_expand_launch(const int* cand, const uint8_t* valid,
                                   const int* flat, const int* starts,
                                   const int* lens, const int* extra,
                                   const int* dirs_host, int n_dirs,
                                   int B, int D, int P, int window,
                                   int count, int neg_from,
                                   void* out, void* stream) {
    if (n_dirs < 0 || n_dirs > LE_MAX_DIRS) return (int)cudaErrorInvalidValue;
    Dirs dirs;
    for (int e = 0; e < LE_MAX_DIRS; ++e) {
        dirs.d[e] = e < n_dirs ? dirs_host[e] : 0;
    }
    const int threads = LE_WARPS_PER_BLOCK * 32;
    const long long blocks =
        ((long long)B + LE_WARPS_PER_BLOCK - 1) / LE_WARPS_PER_BLOCK;
    level_expand_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        cand, valid, flat, starts, lens, extra, dirs, n_dirs,
        B, D, P, window, count, neg_from,
        count ? nullptr : (uint8_t*)out, count ? (int*)out : nullptr);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// level_rows_kernel: K1's count and signed mode, candidates read from
// their CSR row inside the kernel.
//
// For every frontier row b, with the candidates
//   cand = csrc[cstart[b] : cstart[b] + min(clen[b], width)]
// (a strictly increasing CSR row: the flat array, or the per-label array
// at a labeled position) and the Q prefix vertices neg[b, :] (signed
// mode only), it writes
//
//   out[b] = #{cand c admissible} - #{q : neg[b,q] admissible}
//
// where admissible means: in every predecessor row
// flat[starts[p,b] : + min(lens[p,b], window)] and passing every
// comparison against extra[b, :].  This is, bit for bit, the gathered
// window (plus, in signed mode, the prefix columns) through
// level_expand_kernel in count mode with neg_from = width.  The caller
// promises that every candidate lies in row own[b] (it is that row, or
// a labeled subset of it): the candidates are never searched there.
// own[b] = -1 promises nothing.  The prefix vertices are searched in all
// P rows.
//
// What bounds it.  The least traffic is the per-row inputs (cstart,
// clen, starts/lens, own, extra, neg: 4 B each) and the output (4 B a
// row), plus one read of each distinct CSR row the launch touches; at
// the executor's shapes frontier rows share their rows (a dispatch holds
// one or a few roots), so the distinct rows are a few MB and the
// per-row inputs dominate: well under 0.1 ms.  The compares (a search of
// each candidate in each other row) are of the same order at 67 TFLOP/s.
// Either way the bound is far below what dependent loads cost:
// level_expand_kernel spends 3-10x its (larger) bound on P * ceil(log2 W)
// L2 round trips per candidate (W = 1,917 on wiki-vote-syn: up to 11
// steps a row).
//
// Design, against that latency:
//  * Restrictions become a range.  The candidate row is sorted, so the
//    `>` and `<` comparisons cut it to one range [lo, hi), found with
//    one cooperative search per comparison; `!=` is tested per
//    candidate.
//  * The own row is skipped (one of P searches always hits: at P = 2,
//    the shorter half of the work).
//  * The other rows are staged in shared memory.  cp.async copies a row
//    (16-byte copies for the aligned body, 4-byte ones for the unaligned
//    head and tail; the buffer keeps the source's alignment mod 16
//    bytes), and every candidate binary-searches it there.  Rows longer
//    than a tile are staged in tiles; a candidate is searched only in the
//    one tile that holds its lower bound (as membership.cu does), so it
//    is found at most once.  When a row's candidates take several
//    chunks, each chunk stages only the part of a row between its first
//    and last candidate value (two cooperative searches).
//  * Copies overlap searches.  Each group walks a stream of tiles over
//    its frontier rows (grid-stride), double-buffered: the next tile's
//    row offsets, searches and copies are issued before this tile is
//    waited for and searched, across predecessor rows and frontier rows
//    alike.
//  * Prefix columns (signed mode) are one lane's binary search per
//    (column, row) pair in device memory, the P pairs of a column side
//    by side; a column counts when all of its P lanes hit.
//  * Cooperative searches cut dependent loads: S lanes probe S evenly
//    spaced entries and a ballot narrows the range S-fold, so a row of
//    1,917 entries takes 3 dependent loads with S = 32 (4 with S = 8),
//    not 11.
//  * Lanes stay busy.  A group of G threads takes a frontier row and its
//    candidates in chunks of SLOTS * G (lane j holds candidates j, j + G,
//    ...; a 32-bit mask per lane records which are still admissible).
//    G follows the bucket width, the largest candidate count a row can
//    have (a static rule, level_rows_group): 8 lanes up to 128
//    candidates, a warp up to 4,096, a block of 256 beyond.
//  * No atomics: a group's count is reduced with shuffles (and, for a
//    whole block, across warps in shared memory) and written once.
//  * Search, not merge.  A warp-cooperative merge of the candidate row
//    with a staged row costs (n + L) / G steps per lane against
//    (n / G) * log2(L) for the search; on the main path (n <= 128
//    candidates against rows of hundreds of entries) the two are within
//    a factor of two, and the search needs no second staged row, so
//    only the search is implemented.
//
// Shared memory: each group owns two buffers of `tile` = tile_per_lane *
// G int32 (+ 4 for the alignment shift).  The candidates are read into
// registers from device memory (coalesced): staging them too doubled
// the shared memory of a group and cost more in occupancy than it saved
// (chip_smoke.py's sweep, the signed launch of 524,288 rows at width 128,
// 8 lanes, 24 int32 per lane: 1.31 ms with the candidates staged, 0.89
// without, on NVIDIA H100 80GB HBM3, 700.00 W).
// ---------------------------------------------------------------------
#define LR_MAX_PREDS 16
#define LR_SLOTS 16                 // candidates per thread per chunk
#define LR_WARP_GROUP_THREADS 256   // block size when G <= 32

struct RowsArgs {
    const int* csrc;      // candidate source array
    const int* cstart;    // [B]
    const int* clen;      // [B]
    const int* flat;      // predecessor rows' flat array
    const int* starts;    // [P, B]
    const int* lens;      // [P, B]
    const int* own;       // [B] or null (= -1 everywhere)
    const int* extra;     // [B, E] or null
    const int* neg;       // [B, Q] or null
    int* out;             // [B]
    // mask-and-compact only (level_compact_kernel), else null / 0:
    const long long* base;  // [B + 1] first position of each row's pairs
    const int* rows;      // [B] frontier row index written to `parent`
    int* parent;          // [C + 1]
    int* newcol;          // [C + 1]
    long long C;          // capacity: positions >= C are dropped
    Dirs dirs;
    int n_dirs, B, P, Q, width, window, tile;
};

// ---- PTX helpers (cp.async: Ampere's asynchronous copy, on sm_90a) ---
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// ---- end of PTX helpers ----------------------------------------------

// A group of G threads: G <= 32 lanes of one warp, or the whole block.
template <int G>
struct Group {
    static constexpr bool kBlock = G > 32;
    static constexpr int S = kBlock ? 32 : G;   // lanes searching together
    int rank;          // thread's index in the group, 0 .. G-1
    int srank;         // index among the S searching lanes
    unsigned smask;    // ballot mask of those lanes

    __device__ Group() {
        const int lane = threadIdx.x & 31;
        rank = kBlock ? (int)threadIdx.x : (lane & (G - 1));
        srank = kBlock ? lane : rank;
        smask = (S == 32) ? 0xffffffffu
                          : (((1u << S) - 1u) << (lane & ~(S - 1)));
    }
    __device__ __forceinline__ void sync() const {
        if (kBlock) {
            __syncthreads();
        } else {
            __syncwarp(smask);
        }
    }
    // How many of the S searching lanes hold `pred`.
    __device__ __forceinline__ int count(bool pred) const {
        return __popc(__ballot_sync(smask, pred) & smask);
    }
    // `pred` of the S searching lanes, bit i = lane srank i.
    __device__ __forceinline__ unsigned ballot(bool pred) const {
        return (__ballot_sync(smask, pred) & smask)
               >> ((threadIdx.x & 31) & ~(S - 1));
    }
};

// First index i in [lo, hi) of the sorted a[] with a[i] > x (le) or
// a[i] >= x (!le); hi if there is none.  The S lanes probe the last
// entry of S equal segments; the ones below x are counted by a ballot,
// which names the segment holding the answer.  Every searching lane
// returns the same value.
template <int S>
__device__ int coop_search(const int* __restrict__ a, int lo, int hi,
                           int x, bool le, int srank, unsigned smask) {
    while (hi - lo > S) {
        const int s = (hi - lo + S - 1) / S;
        const int v = __ldg(a + min(lo + (srank + 1) * s - 1, hi - 1));
        const int k = __popc(__ballot_sync(smask, le ? v <= x : v < x)
                             & smask);
        const int nlo = min(lo + k * s, hi);
        hi = k < S ? min(lo + (k + 1) * s - 1, hi - 1) : hi;
        lo = nlo;
    }
    bool below = false;
    if (srank < hi - lo) {
        const int v = __ldg(a + lo + srank);
        below = le ? v <= x : v < x;
    }
    return lo + __popc(__ballot_sync(smask, below) & smask);
}

// Is x in the sorted row a[0, len)?  One lane's binary search.
__device__ __forceinline__ bool lane_member(const int* __restrict__ a,
                                            int len, int x) {
    int lo = 0, hi = len;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(a + mid) < x) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo < len && __ldg(a + lo) == x;
}

__device__ __forceinline__ bool passes(const RowsArgs& a, long long b,
                                       int c) {
    for (int e = 0; e < a.n_dirs; ++e) {
        const int ev = a.extra[b * a.n_dirs + e];
        const int dir = a.dirs.d[e];
        if (!(dir > 0 ? c > ev : (dir < 0 ? c < ev : c != ev))) {
            return false;
        }
    }
    return true;
}

// Flags of a tile of the stream.
enum {
    T_CHUNK_FIRST = 1,    // first tile of a candidate chunk: load it
    T_CHUNK_LAST = 2,     // last tile of the chunk: add its survivors
    T_ROW_LAST = 4,       // last tile of frontier row b: write out[b]
    T_PRED = 8,           // part of a predecessor row (else no row)
    T_PRED_FIRST = 16,    // first tile of that part
    T_PRED_LAST = 32,     // last tile of that part
};

struct Tile {
    int b;                // frontier row
    int c0, c1;           // the chunk's candidates, csrc[c0 .. c1)
    int neg_hits;         // admissible prefix vertices of row b
    long long off;        // staged entries flat[off .. off + n)
    int n;
    int flags;
};

// Walks one group's frontier rows and produces its stream of tiles.
// All of its state is the same in every thread of the group.
template <int G>
struct Cursor {
    static constexpr int kChunk = LR_SLOTS * G;
    const RowsArgs& a;
    Group<G> g;
    long long b;          // current frontier row
    long long step;       // rows between this group's rows
    int rhi;              // end of row b's candidate range
    bool chunked;         // row b has more than one chunk
    int c0, c1;           // current chunk
    int own;              // own[b]
    int neg_hits;
    int k;                // current predecessor (P: none left)
    long long off, end;   // rest of predecessor k's part
    int pending;          // T_CHUNK_FIRST for the chunk's first tile
    bool pred_first;      // the next tile of k is its part's first
    bool in_row;          // row b still has chunks or tiles to emit

    __device__ Cursor(const RowsArgs& args, long long first, long long stride)
        : a(args), g(), b(first - stride), step(stride), rhi(0), c0(0),
          c1(0), chunked(false), own(-1), neg_hits(0), k(0), off(0),
          end(0), pending(0), pred_first(false), in_row(false) {}

    __device__ int next_pred(int p) const {
        ++p;
        if (p == own) ++p;
        return p < a.P ? p : a.P;
    }

    // Row b's candidate range after the > / < comparisons, and its
    // admissible prefix vertices.
    __device__ void begin_row() {
        const int* csrc = a.csrc;
        int lo = a.cstart[b];
        int hi = lo + max(min(a.clen[b], a.width), 0);
        // The emit pass skips a row with no survivor, or whose pairs all
        // land at or past C: it has nothing to write.
        if (a.base != nullptr && (a.base[b] >= a.C
                                  || a.base[b + 1] == a.base[b])) {
            hi = lo;
        }
        for (int e = 0; e < a.n_dirs; ++e) {
            const int dir = a.dirs.d[e];
            if (dir == 0 || lo >= hi) continue;
            const int ev = a.extra[b * a.n_dirs + e];
            if (dir > 0) {
                lo = coop_search<Group<G>::S>(csrc, lo, hi, ev, true,
                                              g.srank, g.smask);
            } else {
                hi = coop_search<Group<G>::S>(csrc, lo, hi, ev, false,
                                              g.srank, g.smask);
            }
        }
        rhi = max(hi, lo);
        chunked = rhi - lo > kChunk;
        c0 = c1 = lo;
        const int o = a.own == nullptr ? -1 : a.own[b];
        own = (o >= 0 && o < a.P) ? o : -1;
        neg_hits = 0;
        if (a.Q == 0) return;
        // Prefix columns.  With P <= S, lane l searches column q0 + l / P
        // in row l % P, so a column's P searches run side by side, and
        // the column's first lane counts it when all of them hit; else
        // each lane takes one column and searches its rows in turn.
        constexpr int S = Group<G>::S;
        for (int q0 = 0; q0 < a.Q;) {
            const int per = a.P <= S ? S / a.P : S;
            const int ql = a.P <= S ? g.srank / a.P : g.srank;
            const int q = q0 + ql;
            bool in = false;
            if (ql < per && q < a.Q) {
                const int x = a.neg[b * a.Q + q];
                in = passes(a, b, x);
                for (int p = a.P <= S ? g.srank % a.P : 0;
                     in && p < (a.P <= S ? g.srank % a.P + 1 : a.P); ++p) {
                    const long long i = (long long)p * a.B + b;
                    const int len = min(a.lens[i], a.window);
                    in = len > 0 && lane_member(a.flat + a.starts[i], len, x);
                }
            }
            bool counts = in;
            if (a.P <= S) {                        // every lane ballots
                const unsigned all = (1u << a.P) - 1u;
                const unsigned hits = g.ballot(in) >> (ql * a.P);
                counts = g.srank % a.P == 0 && (hits & all) == all;
            }
            neg_hits += g.count(counts);
            q0 += per;
        }
    }

    // The part of predecessor k's row that can hold this chunk's values:
    // all of it when it fits one tile or the row has one chunk (cutting
    // such a row costs two dependent searches before its first copy and
    // saves little: a row's candidates span most of the vertex ids),
    // else the entries between the chunk's first and last candidate.
    __device__ void begin_pred() {
        const long long i = (long long)k * a.B + b;
        const int* row = a.flat + a.starts[i];
        const int len = max(min(a.lens[i], a.window), 0);
        int s0 = 0, s1 = len;
        if (len > a.tile && chunked) {
            const int vfirst = __ldg(a.csrc + c0);
            const int vlast = __ldg(a.csrc + c1 - 1);
            s0 = coop_search<Group<G>::S>(row, 0, len, vfirst, false,
                                          g.srank, g.smask);
            s1 = coop_search<Group<G>::S>(row, s0, len, vlast, true,
                                          g.srank, g.smask);
        }
        off = (long long)a.starts[i] + s0;
        end = (long long)a.starts[i] + s1;
    }

    // The next tile of the stream; false once the group's rows are done.
    __device__ bool next(Tile& t) {
        for (;;) {
            if (k < a.P && off < end) {            // a tile of row k
                const int n = (int)min((long long)a.tile, end - off);
                t.flags = pending | T_PRED | (pred_first ? T_PRED_FIRST : 0);
                t.off = off;
                t.n = n;
                off += n;
                pred_first = false;
                if (off == end) {
                    t.flags |= T_PRED_LAST;
                    if (next_pred(k) == a.P) t.flags |= T_CHUNK_LAST;
                }
                break;
            }
            if (k < a.P && in_row && c0 < c1) {    // predecessor k done
                k = next_pred(k);
                if (k < a.P) {
                    begin_pred();
                    pred_first = true;
                    if (off == end) {              // no hit possible
                        t.flags = pending | T_PRED | T_PRED_FIRST
                                  | T_PRED_LAST | T_CHUNK_LAST;
                        t.n = 0;
                        t.off = off;
                        k = a.P;                   // the chunk is dead
                        break;
                    }
                    continue;
                }
            }
            if (in_row && c1 < rhi) {              // the next chunk
                c0 = c1;
                c1 = min(c0 + kChunk, rhi);
                pending = T_CHUNK_FIRST;
                k = -1;
                off = end = 0;
                if (next_pred(-1) == a.P) {        // no row to search
                    t.flags = pending | T_CHUNK_LAST;
                    t.n = 0;
                    t.off = 0;
                    k = a.P;
                    break;
                }
                continue;
            }
            if (in_row) {                          // row b done
                in_row = false;
                continue;
            }
            b += step;                             // the next row
            if (b >= a.B) return false;
            begin_row();
            in_row = true;
            k = a.P;
            off = end = 0;
            if (c0 == rhi) {                       // no candidate
                t.flags = T_CHUNK_FIRST | T_CHUNK_LAST;
                t.n = 0;
                t.off = 0;
                in_row = false;
                t.flags |= T_ROW_LAST;
                t.b = (int)b;
                t.c0 = t.c1 = c0;
                t.neg_hits = neg_hits;
                pending = 0;
                return true;
            }
        }
        // a tile of the current chunk
        if ((t.flags & T_CHUNK_LAST) && c1 >= rhi) t.flags |= T_ROW_LAST;
        t.b = (int)b;
        t.c0 = c0;
        t.c1 = c1;
        t.neg_hits = neg_hits;
        pending = 0;
        return true;
    }
};

// Copies src[0, n) into shared memory with cp.async, entry i landing at
// dst[r + i], r = the source's offset mod 16 bytes in int32, so the
// 16-byte copies of the body are aligned on both sides (4-byte copies
// take the unaligned head and tail).
template <int G>
__device__ __forceinline__ void copy_row(int* dst, const int* src, int n,
                                        int rank) {
    const int r = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    const int head = min((4 - r) & 3, n);
    dst += r;
    for (int i = rank; i < head; i += G) cp_async4(dst + i, src + i);
    const int nv = (n - head) >> 2;
    for (int v = rank; v < nv; v += G) {
        cp_async16(dst + head + 4 * v, src + head + 4 * v);
    }
    for (int i = head + 4 * nv + rank; i < n; i += G) {
        cp_async4(dst + i, src + i);
    }
}

// Starts the copy of tile t's entries into buf (all G threads; one
// commit group per thread per tile, empty or not).
template <int G>
__device__ __forceinline__ void stage(int* buf, const RowsArgs& a,
                                      const Tile& t, int rank) {
    if (t.n > 0) copy_row<G>(buf, a.flat + t.off, t.n, rank);
    cp_async_commit();
}

// Writes the survivors of one chunk in column order at pos, pos + 1, ...
// (those at or past C are dropped) and advances pos past all of them.
// Lane j holds candidates j, j + G, ... of the chunk, so column order is
// (slot, lane): a survivor's rank is the chunk's survivors in earlier
// slots plus, in its own slot, those of lower lanes — a ballot per slot
// and a popcount.  A block group (G > 32) adds the counts of the warps
// before its own, from shared memory.  Called by the whole group.
template <int G>
__device__ __forceinline__ void emit_chunk(const RowsArgs& a,
                                           const Group<G>& g,
                                           const int (&cand)[LR_SLOTS],
                                           unsigned alive, int prow,
                                           long long& pos, int* wcnt) {
    constexpr int kWarps = G > 32 ? G / 32 : 1;
    const int w = G > 32 ? (int)threadIdx.x >> 5 : 0;
    if (G > 32) {
#pragma unroll
        for (int s = 0; s < LR_SLOTS; ++s) {
            const unsigned m = __ballot_sync(0xffffffffu, (alive >> s) & 1u);
            if ((threadIdx.x & 31) == 0) wcnt[s * kWarps + w] = __popc(m);
        }
        __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < LR_SLOTS; ++s) {
        const bool bit = (alive >> s) & 1u;
        const unsigned m = g.ballot(bit);      // the S lanes, bit i = srank i
        int before = 0, total = __popc(m);
        if (G > 32) {
            total = 0;
            for (int v = 0; v < kWarps; ++v) {
                const int c = wcnt[s * kWarps + v];
                total += c;
                before += v < w ? c : 0;
            }
        }
        const long long p =
            pos + before + __popc(m & ((1u << g.srank) - 1u));
        if (bit && p < a.C) {
            a.parent[p] = prow;
            a.newcol[p] = cand[s];
        }
        pos += total;
    }
}

// The body of level_rows_kernel (kEmit false: out[b] = the row's count)
// and of level_compact_kernel (kEmit true: the row's survivors written
// at base[b], base[b] + 1, ...).  Both passes of the mask-and-compact
// entry run this one body on the same inputs, so they make the same
// admissibility decision for every candidate, bit for bit.
template <int G, bool kEmit>
__device__ __forceinline__ void rows_body(const RowsArgs& a) {
    extern __shared__ __align__(16) int lr_smem[];
    __shared__ int warp_sums[G > 32 ? G / 32 : 1];
    __shared__ int wcnt[kEmit && G > 32 ? LR_SLOTS * (G / 32) : 1];
    constexpr int kGroups = G > 32 ? 1 : LR_WARP_GROUP_THREADS / G;
    const int gib = G > 32 ? 0 : (int)threadIdx.x / G;   // group in block
    const int buf_ints = a.tile + 4;
    int* bufs = lr_smem + (long long)gib * 2 * buf_ints;
    Cursor<G> cur(a, (long long)blockIdx.x * kGroups + gib,
                  (long long)gridDim.x * kGroups);
    const int rank = cur.g.rank;

    int cand[LR_SLOTS];
    unsigned alive = 0, found = 0;
    int acc = 0;
    int prev_last = 0;     // last entry of the previous tile of a part
    int emit_b = -1;       // emit pass: the row emit_pos belongs to
    long long emit_pos = 0;
    Tile t, nt;
    int parity = 0;
    bool have = cur.next(t);
    if (have) stage<G>(bufs, a, t, rank);
    while (have) {
        const bool have_next = cur.next(nt);
        if (have_next) stage<G>(bufs + (parity ^ 1) * buf_ints, a, nt, rank);
        if (have_next) {
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        cur.g.sync();

        const long long b = t.b;
        if (t.flags & T_CHUNK_FIRST) {             // this chunk's candidates
            alive = 0;
#pragma unroll
            for (int s = 0; s < LR_SLOTS; ++s) {
                const int i = t.c0 + rank + s * G;
                cand[s] = 0;
                if (i < t.c1) {
                    const int c = __ldg(a.csrc + i);
                    cand[s] = c;
                    bool ok = true;
                    for (int e = 0; ok && e < a.n_dirs; ++e) {
                        if (a.dirs.d[e] == 0) {
                            ok = c != a.extra[b * a.n_dirs + e];
                        }
                    }
                    if (ok) alive |= 1u << s;
                }
            }
        }
        if (t.flags & T_PRED) {
            if (t.flags & T_PRED_FIRST) found = 0;
            if (t.n > 0) {
                const int* row = bufs + parity * buf_ints
                                 + ((reinterpret_cast<uintptr_t>(
                                         a.flat + t.off) >> 2) & 3);
                const int n = t.n;
                const int last = row[n - 1];
                const bool lo_open = (t.flags & T_PRED_FIRST) != 0;
                const bool hi_open = (t.flags & T_PRED_LAST) != 0;
#pragma unroll
                for (int s = 0; s < LR_SLOTS; ++s) {
                    const int c = cand[s];
                    if (((alive >> s) & 1u)
                        && (lo_open || c > prev_last)
                        && (hi_open || c <= last)) {
                        int lo = 0, hi = n;
                        while (lo < hi) {
                            const int mid = (lo + hi) >> 1;
                            if (row[mid] < c) {
                                lo = mid + 1;
                            } else {
                                hi = mid;
                            }
                        }
                        if (lo < n && row[lo] == c) found |= 1u << s;
                    }
                }
                prev_last = last;
            }
            if (t.flags & T_PRED_LAST) alive &= found;
        }
        if constexpr (kEmit) {
            if (t.flags & T_CHUNK_LAST) {
                if (t.b != emit_b) {               // the row's first chunk
                    emit_b = t.b;
                    emit_pos = a.base[b];
                }
                emit_chunk<G>(a, cur.g, cand, alive, a.rows[b], emit_pos,
                              wcnt);
            }
        } else {
            if (t.flags & T_CHUNK_LAST) acc += __popc(alive);
            if (t.flags & T_ROW_LAST) {            // reduce, write, reset
                int sum = acc;
                if (G > 32) {
                    for (int o = 16; o > 0; o >>= 1) {
                        sum += __shfl_xor_sync(0xffffffffu, sum, o);
                    }
                    if ((threadIdx.x & 31) == 0) {
                        warp_sums[threadIdx.x >> 5] = sum;
                    }
                    __syncthreads();
                    if (threadIdx.x == 0) {
                        int total = 0;
                        for (int w = 0; w < (G > 32 ? G / 32 : 1); ++w) {
                            total += warp_sums[w];
                        }
                        a.out[b] = total - t.neg_hits;
                    }
                } else {
                    for (int o = G / 2; o > 0; o >>= 1) {
                        sum += __shfl_xor_sync(cur.g.smask, sum, o);
                    }
                    if (rank == 0) a.out[b] = sum - t.neg_hits;
                }
                acc = 0;
            }
        }
        cur.g.sync();          // buffer `parity` is free for the next stage
        t = nt;
        have = have_next;
        parity ^= 1;
    }
}

template <int G>
__global__ void __launch_bounds__(G > 32 ? G : LR_WARP_GROUP_THREADS)
level_rows_kernel(const __grid_constant__ RowsArgs a) {
    rows_body<G, false>(a);
}

// ---------------------------------------------------------------------
// K1's mask mode with the level's stream compaction: level_compact_launch.
//
// Replaces, on the executor's mask levels, the TPU kernel
// `level_expand_pallas` in mask mode (src/repro/kernels/intersect.py:220)
// together with the reference's compaction after it
// (src/repro/core/executor.py:390-398): for every frontier row b, the
// admissible candidates of csrc[cstart[b] : + min(clen[b], width)] (as
// level_rows_kernel decides them) are written, in column order, as the
// pairs (rows[b], candidate) to parent / newcol at positions
// offset + excl[b] + k, where excl is the exclusive prefix sum of the
// rows' survivor counts; positions at or past C are dropped, and offset
// advances by the total, dropped pairs included.  Order is (row, column)
// and no position comes from an atomic, so the next level's frontier is
// the reference's and a count stays deterministic.  Positions are int64:
// offset accumulates across slices and buckets and may pass 2^31 before
// the executor escalates the capacity.
//
// Three launches on one stream:
//  1. level_rows_kernel in count mode, as it stands: the row counts.
//  2. level_compact_scan_kernel, one block: base[b] = offset + excl[b]
//     for b in [0, B] (base[B] = offset + total), then offset = base[B].
//     It scans B int32, not B x width entries.
//  3. level_compact_kernel: the same tile stream and searches as pass 1,
//     then each chunk's survivors ranked by a ballot per slot and
//     written (emit_chunk).  A row with no survivor, or whose base is at
//     or past C, is skipped without a search.
//
// What bounds it: the per-row inputs (cstart, clen, starts/lens, own,
// extra, rows: 4 B each), the distinct CSR rows the launch reads, and
// 8 B per pair written; the compares are of the same order as count
// mode's.  What it removes: the gathered [B, width] window, its validity
// mask, the [B, width] byte mask, the int64 scan and `where` over all
// B x width entries and two scatters of B x width pairs (every
// non-survivor into the sentinel slot C): at 65,536 x 1,024 that is
// ~2.3 GB of traffic against a few MB.  The price is a second search of
// the surviving rows' candidates (pass 3 repeats pass 1's).
// ---------------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(G > 32 ? G : LR_WARP_GROUP_THREADS)
level_compact_kernel(const __grid_constant__ RowsArgs a) {
    rows_body<G, true>(a);
}

#define CS_THREADS 1024
#define CS_PER 16                   // counts per thread per round

// base[b] = *offset + cnt[0] + ... + cnt[b-1] for b in [0, B], then
// *offset = base[B].  One block: offset is read before and written after
// every other access, so the running total needs no atomics.
__global__ void __launch_bounds__(CS_THREADS)
level_compact_scan_kernel(const int* __restrict__ cnt, int B,
                          long long* __restrict__ offset,
                          long long* __restrict__ base) {
    __shared__ long long warp_tot[CS_THREADS / 32];
    __shared__ long long run;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) run = *offset;
    __syncthreads();
    for (long long r0 = 0; r0 < B; r0 += (long long)CS_THREADS * CS_PER) {
        const long long i0 = r0 + (long long)threadIdx.x * CS_PER;
        int v[CS_PER];
        if (i0 + CS_PER <= B) {                // 16-byte aligned: i0 % 16 == 0
            const int4* src = reinterpret_cast<const int4*>(cnt + i0);
#pragma unroll
            for (int k = 0; k < CS_PER / 4; ++k) {
                const int4 q = src[k];
                v[4 * k] = q.x;
                v[4 * k + 1] = q.y;
                v[4 * k + 2] = q.z;
                v[4 * k + 3] = q.w;
            }
        } else {
#pragma unroll
            for (int k = 0; k < CS_PER; ++k) {
                v[k] = i0 + k < B ? cnt[i0 + k] : 0;
            }
        }
        long long sum = 0;
#pragma unroll
        for (int k = 0; k < CS_PER; ++k) sum += v[k];
        long long x = sum;                     // inclusive scan in the warp
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) warp_tot[warp] = x;
        __syncthreads();
        if (warp == 0) {                       // scan the warps' totals
            long long t = warp_tot[lane];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const long long y = __shfl_up_sync(0xffffffffu, t, o);
                if (lane >= o) t += y;
            }
            warp_tot[lane] = t;
        }
        __syncthreads();
        long long e = run + (warp ? warp_tot[warp - 1] : 0) + x - sum;
#pragma unroll
        for (int k = 0; k < CS_PER; ++k) {
            if (i0 + k < B) base[i0 + k] = e;
            e += v[k];
        }
        __syncthreads();                       // every read of run is done
        if (threadIdx.x == 0) run += warp_tot[CS_THREADS / 32 - 1];
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        base[B] = run;
        *offset = run;
    }
}

static int g_num_sms = 0;

template <int G, bool kEmit>
static int launch_rows(const RowsArgs& a, int max_blocks,
                       cudaStream_t stream) {
    constexpr int threads = G > 32 ? G : LR_WARP_GROUP_THREADS;
    constexpr int groups = G > 32 ? 1 : LR_WARP_GROUP_THREADS / G;
    void (*kernel)(const RowsArgs) = level_rows_kernel<G>;
    if (kEmit) kernel = level_compact_kernel<G>;
    const size_t smem = (size_t)groups * 2 * (a.tile + 4) * sizeof(int);
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (g_num_sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount,
                               dev);
    }
    // One wave of resident blocks, each group walking several rows (its
    // tile stream overlaps copies across them); fewer when B is small.
    long long blocks = ((long long)a.B + groups - 1) / groups;
    long long resident = (long long)max(per_sm, 1) * max(g_num_sms, 1);
    if (blocks > resident) blocks = resident;
    if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool kEmit>
static int launch_group(const RowsArgs& a, int group, int max_blocks,
                        cudaStream_t s) {
    switch (group) {
        case 8: return launch_rows<8, kEmit>(a, max_blocks, s);
        case 32: return launch_rows<32, kEmit>(a, max_blocks, s);
        case 256: return launch_rows<256, kEmit>(a, max_blocks, s);
        default: return (int)cudaErrorInvalidValue;
    }
}


extern "C" int level_rows_max_preds() { return LR_MAX_PREDS; }

// The group size the static rule gives a bucket of `width` candidates:
// 8 lanes up to 128 candidates (one chunk), a warp up to 4,096 (chunks of
// 512), a block of 256 beyond.  Measured with chip_smoke.k1_rows_sweep
// on the wiki-vote-syn P1 root-slice launches (NVIDIA H100 80GB HBM3,
// 700.00 W; 16-32 int32 staged per lane): at width 128 (signed, 524,288
// rows) 8 lanes took 0.84-1.09 ms, a warp 1.09-1.13, a block of 256
// 6.7-8.0; at width 1,024 (65,536 rows) a warp took 0.22-0.24 ms
// (count) and 0.39-0.44 (signed), 8 lanes 0.24-0.27 and 0.69-0.81, a
// block of 256 0.63-0.73 and 1.02-1.22.  Blocks are kept for rows past
// the widths measured, where a warp's chunks would number in the tens.
extern "C" int level_rows_group(int width) {
    if (width <= 8 * LR_SLOTS) return 8;
    if (width <= 4096) return 32;
    return 256;
}

// The group size of both passes of level_compact_launch: a warp up to
// 4,096 candidates, a block of 256 beyond.  Measured with
// chip_smoke.compact_sweep on the largest mask launches of the
// wiki-vote-syn P1 graphpi count (NVIDIA H100 80GB HBM3, 700.00 W; 32
// int32 staged per lane).  At width 1,024 (65,536 rows) a warp wins
// outright: 0.62 ms against 1.28 (8 lanes) and 2.24 (256), every pair
// written.  At width 128 (524,288 rows) it depends on the pairs
// written: with all 8.8M a warp took 2.66 ms, 8 lanes 3.02; as the
// launch ran in the count (a dispatch that overflowed, 1.0M written)
// 2.02 against 1.91; 8 lanes for the row counts and a warp for the emit
// pass, 2.68 and 2.04, won neither.  Over the root-slice profile
// (phase 4: 127 mask launches of all sizes) the emit kernel took
// 4.40-4.43 ms with a warp in three calls against 5.59 with 8 lanes in
// one; the slice's whole device time varies more between calls than
// that.  The warp is the rule: it wins wherever the emit pass does its
// work, writing pairs, and loses ~5% where a launch writes few.
extern "C" int level_compact_group(int width) {
    return width <= 4096 ? 32 : 256;
}

static bool rows_args(RowsArgs& a, const int* csrc, const int* cstart,
                      const int* clen, const int* flat, const int* starts,
                      const int* lens, const int* own, const int* extra,
                      const int* neg, const int* dirs_host, int n_dirs,
                      int B, int P, int Q, int width, int window, int& group,
                      int tile_per_lane) {
    if (n_dirs < 0 || n_dirs > LE_MAX_DIRS || P < 1 || P > LR_MAX_PREDS
        || Q < 0 || B < 1 || width < 0 || tile_per_lane < 1
        || tile_per_lane > 64) {
        return false;
    }
    a.csrc = csrc;
    a.cstart = cstart;
    a.clen = clen;
    a.flat = flat;
    a.starts = starts;
    a.lens = lens;
    a.own = own;
    a.extra = n_dirs ? extra : nullptr;
    a.neg = Q ? neg : nullptr;
    a.out = nullptr;
    a.base = nullptr;
    a.rows = nullptr;
    a.parent = nullptr;
    a.newcol = nullptr;
    a.C = 0;
    for (int e = 0; e < LE_MAX_DIRS; ++e) {
        a.dirs.d[e] = e < n_dirs ? dirs_host[e] : 0;
    }
    a.n_dirs = n_dirs;
    a.B = B;
    a.P = P;
    a.Q = Q;
    a.width = width;
    a.window = window;
    if (group == 0) group = level_rows_group(width);
    a.tile = tile_per_lane * group;
    return true;
}

// Launches level_rows_kernel on `stream`; `out` is int32 [B].  `own`,
// `extra` and `neg` may be null (none / no comparisons / count mode).
// `group` = 0 takes level_rows_group(width), else 8, 32 or 256;
// each group stages `tile_per_lane * group` int32 per buffer;
// `max_blocks` > 0 caps the grid (tests: many rows per group).
// Returns a CUDA error code (0 = launched).
extern "C" int level_rows_launch(const int* csrc, const int* cstart,
                                 const int* clen, const int* flat,
                                 const int* starts, const int* lens,
                                 const int* own, const int* extra,
                                 const int* neg, const int* dirs_host,
                                 int n_dirs, int B, int P, int Q, int width,
                                 int window, int group, int tile_per_lane,
                                 int max_blocks, void* out, void* stream) {
    RowsArgs a;
    if (!rows_args(a, csrc, cstart, clen, flat, starts, lens, own, extra,
                   neg, dirs_host, n_dirs, B, P, Q, width, window, group,
                   tile_per_lane)) {
        return (int)cudaErrorInvalidValue;
    }
    a.out = (int*)out;
    return launch_group<false>(a, group, max_blocks, (cudaStream_t)stream);
}

// Launches K1's mask-and-compact passes on `stream` (see the note above
// level_compact_kernel): the inputs of level_rows_launch without `neg`,
// plus `rows` int32 [B], the running `offset` (an int64 on the device,
// advanced by the total), the capacity C and the int32 [C + 1] outputs
// `parent` and `newcol`; `cnt` int32 [B] and `base` int64 [B + 1] are
// the caller's scratch.  `group`, `tile_per_lane` and `max_blocks` shape
// both search passes as in level_rows_launch, except that `group` = 0
// takes level_compact_group(width).  `launched` (host) receives the
// number of the three kernels launched, in order.  Returns a CUDA error
// code (0 = all three launched).
extern "C" int level_compact_launch(const int* csrc, const int* cstart,
                                    const int* clen, const int* flat,
                                    const int* starts, const int* lens,
                                    const int* own, const int* extra,
                                    const int* dirs_host, int n_dirs, int B,
                                    int P, int width, int window,
                                    const int* rows, long long* offset,
                                    long long C, int* cnt, long long* base,
                                    int* parent, int* newcol, int group,
                                    int tile_per_lane, int max_blocks,
                                    void* stream, int* launched) {
    RowsArgs a;
    *launched = 0;
    if (group == 0) group = level_compact_group(width);
    if (C < 0 || !rows_args(a, csrc, cstart, clen, flat, starts, lens, own,
                            extra, nullptr, dirs_host, n_dirs, B, P, 0,
                            width, window, group, tile_per_lane)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    a.out = cnt;
    int err = launch_group<false>(a, group, max_blocks, s);
    if (err != 0) return err;
    *launched = 1;
    level_compact_scan_kernel<<<1, CS_THREADS, 0, s>>>(cnt, B, offset, base);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    *launched = 2;
    a.out = nullptr;
    a.base = base;
    a.rows = rows;
    a.parent = parent;
    a.newcol = newcol;
    a.C = C;
    err = launch_group<true>(a, group, max_blocks, s);
    if (err == 0) *launched = 3;
    return err;
}
