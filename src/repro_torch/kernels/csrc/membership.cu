// K2 and K3: sorted-row membership and intersection count, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels `membership_pallas` (K2,
// src/repro/kernels/intersect.py:307, body `_membership_body` at :54)
// and `intersect_count_pallas` (K3, intersect.py:338, body `_count_body`
// at :69).  For every row b and candidate column d:
//
//   K2 (mask mode):  mask[b,d] = c ∈ nbr[b, 0:n_b]              (1 byte)
//   K3 (count mode): cnt[b]    = #{d : c ∈ nbr[b, 0:n_b]}       (int32)
//
// where c = cand[b,d] if valid[b,d] (or no validity mask is given) and
// CAND_PAD = -1 otherwise, and n_b = clamp(nbr_len[b], 0, L) (or L).
// Each row's valid prefix is non-decreasing.  Duplicate candidates count
// separately, as in the reference.  This is the reference's ragged
// contract (invalid candidates replaced by -1, positions past n_b padded
// with INT32_MAX) on the domain cand ∈ [-1, INT32_MAX), read inside the
// kernel: the wrapper makes no padded copy.
//
// What bounds it.  The least traffic is one read of cand and nbr (4 B
// per entry), of nbr_len (4 B a row) and valid (1 B a candidate) where
// given, and the output (1 B a candidate, or 4 B a row): a memory-bound
// pass at 3.35 TB/s.  The compares, about log2(L) a candidate, are two
// orders below that on the cores; but each is a dependent shared-memory
// load, so the search has to issue few instructions and meet no bank
// conflicts to stay under the copies.
//
// Design (`membership_padded_kernel`).
//  * A persistent grid walks the rows: a warp per row for rows up to
//    MB_WARP_MAX_L entries (8 warps a block, each on its own rows, as
//    many as shared memory allows), a block of 256 threads per row
//    beyond (`membership_group`).  A row longer than `tile` is cut into
//    tiles; each (row, tile) is an item.
//  * Each group double-buffers its items in shared memory: while it
//    searches item i, cp.async copies item i + 1 into the other buffer,
//    4 bytes an entry, and each chunk's search runs while the next
//    chunk's candidates (or the next item's first) load into registers.
//    One group barrier per item.
//  * Entry i of a tile sits at slot(i) = i + (i >> 5) + (i >> 10): one
//    pad word per 32 entries and one more per 1,024.  A power-of-two
//    search probes pos + step - 1 with pos a multiple of 2·step, so on a
//    linear row every lane's probe of the first steps falls in one bank
//    (up to 16-way conflicts at L = 1,024).  Under the padding the
//    probes of each of the first six steps fall in distinct banks up to
//    n = 4,096.  Padding rather than an XOR swizzle keeps the map
//    additive: pos's bits and step - 1's are disjoint, so
//    slot(pos + step - 1) = slot(pos) + slot(step - 1) and
//    slot(pos + step) = slot(pos) + slot(step).  A search step is one
//    shared load at a constant offset from a running address, a compare
//    and a predicated add.
//  * The tile of n entries is searched as a virtual array of
//    top = pow2ceil(n) entries, positions [n, top) holding INT32_MAX
//    sentinels: log2(top) fixed steps (all lanes alike, no divergence)
//    find the lower bound clamped to top - 1, and one last load tells
//    whether it holds c.  The steps are unrolled for each log2(top),
//    picked by one uniform branch a chunk, so a step is one load at an
//    immediate offset, a compare and a predicated add, with no branch.
//    Each thread advances Q searches together (Q = 8 for a warp per row
//    where D >= 256, else 4): Q independent loads in flight a step.
//  * A thread takes its Q consecutive candidates with 16-byte loads and
//    writes their mask bytes with 32-bit stores when D % 4 == 0 and the
//    pointers allow it; otherwise (`VEC` false) it takes Q candidates a
//    group apart with 4-byte loads and byte stores.  The launcher
//    chooses by the pointers and D.
//  * A candidate is searched in the one tile that holds its lower bound:
//    tile t takes c when c > (last entry of tile t-1) and, unless t is
//    the row's last tile, c <= (last entry of tile t).  The previous
//    tile's last entry is kept in a register from that tile's search,
//    so nothing past the valid prefix is read.  A row with n_b = 0 is
//    one empty item whose candidates all miss.
//  * Count mode sums each thread's hits and reduces across the warp with
//    shuffles; a block group adds its warps' sums in shared memory one
//    item later (after the next barrier), so a row costs no extra
//    barrier and no atomics.
//
// The first version, `membership_linear_kernel`, stays for side-by-side
// timing (`membership_linear_launch`): a block per row, the row copied
// into a linear shared tile of at most 4,096 int32 between two barriers,
// a branching binary search per candidate, inputs padded by the caller.
//
// Contract (checked by the Python wrapper, kernels/membership.py and
// kernels/ops.py): cand [B, D] and nbr [B, L] int32, contiguous, on one
// device, valid prefixes non-decreasing, B, D, L >= 1; nbr_len int32 [B]
// and valid uint8 [B, D] or null; the launch on the caller's stream; each
// function returns cudaGetLastError() so a refused launch surfaces at
// once.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MB_THREADS 256
#define MB_MAX_TILE 16384          // int32 entries of a tile (2^MB_MAX_LOG)
#define MB_MAX_LOG 14
#define MB_WARP_MAX_L 1024
#define MB_CAND_PAD (-1)

// ---- PTX helpers (cp.async: Ampere's asynchronous copy, on sm_90a) ---
__device__ __forceinline__ void cp_async4(unsigned dst, const int* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
template <int OFF>
__device__ __forceinline__ int lds(unsigned addr) {
    int v;
    asm volatile("ld.shared.b32 %0, [%1+%2];\n"
                 : "=r"(v) : "r"(addr), "n"(OFF) : "memory");
    return v;
}
// ---- end of PTX helpers ----------------------------------------------

// Shared slot of tile entry i (see the design notes).
__host__ __device__ constexpr int mb_slot(int i) {
    return i + (i >> 5) + (i >> 10);
}

__host__ __device__ inline int mb_pow2ceil(int n) {
    int t = 1;
    while (t < n) t <<= 1;
    return t;
}

struct MbArgs {
    const int* cand;        // [B, D]
    const int* nbr;         // [B, L]
    const int* nbr_len;     // [B] or null
    const uint8_t* valid;   // [B, D] or null
    uint8_t* mask;          // [B, D] (mask mode)
    int* count;             // [B] (count mode)
    int B, D, L, tile;
    int buf_words;          // one tile buffer: slot(top_max - 1) + 1, rounded
};

// One (row, tile) of a group's walk; n_b is the row's valid length, T
// its number of tiles.
struct Item {
    long long b;
    int t, T, n_b;
};

__device__ __forceinline__ int valid_len(const MbArgs& a, long long b) {
    if (a.nbr_len == nullptr) return a.L;
    return min(max(__ldg(a.nbr_len + b), 0), a.L);
}

__device__ __forceinline__ int tiles_of(int n_b, int tile) {
    return n_b == 0 ? 1 : (n_b + tile - 1) / tile;
}

// A group's rows b0, b0 + stride, ...; each row's tiles in order.  The
// next row's valid length is read one row ahead.
struct Walk {
    long long stride;
    int ahead;              // valid length of row cur.b + stride
    __device__ __forceinline__ bool start(const MbArgs& a, long long b0,
                                          Item& it) {
        if (b0 >= a.B) return false;
        it.b = b0;
        it.t = 0;
        it.n_b = valid_len(a, b0);
        it.T = tiles_of(it.n_b, a.tile);
        ahead = b0 + stride < a.B ? valid_len(a, b0 + stride) : 0;
        return true;
    }
    __device__ __forceinline__ bool next(const MbArgs& a, const Item& cur,
                                         Item& it) {
        it = cur;
        if (cur.t + 1 < cur.T) {
            it.t = cur.t + 1;
            return true;
        }
        it.b = cur.b + stride;
        if (it.b >= a.B) return false;
        it.t = 0;
        it.n_b = ahead;
        it.T = tiles_of(it.n_b, a.tile);
        ahead = it.b + stride < a.B ? valid_len(a, it.b + stride) : 0;
        return true;
    }
};

__device__ __forceinline__ int tile_n(const MbArgs& a, const Item& it) {
    return min(a.tile, it.n_b - it.t * a.tile);        // >= 0
}

// Starts the copy of item `it` into the buffer at shared address `buf`:
// entry i at slot(i) by 4-byte cp.async, INT32_MAX at the slots of
// [n, top).  One commit group per thread per item.
template <int G>
__device__ __forceinline__ void stage(unsigned buf, const MbArgs& a,
                                      const Item& it, int rank) {
    const int n = tile_n(a, it);
    const int top = mb_pow2ceil(max(n, 1));
    const int* src = a.nbr + it.b * (long long)a.L + (long long)it.t * a.tile;
    for (int i = rank; i < n; i += G) {
        cp_async4(buf + 4u * (unsigned)mb_slot(i), src + i);
    }
    for (int i = n + rank; i < top; i += G) {
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(buf + 4u * (unsigned)mb_slot(i)), "r"(INT_MAX)
                     : "memory");
    }
    cp_async_commit();
}

// The searches of Q candidates: the steps of 2^K, 2^(K-1), ..., 1, each
// a shared load at a constant offset from the running address p[s]
// (slot(pos) of candidate s), a compare and a predicated add; no branch.
template <int K, int Q>
struct Steps {
    static __device__ __forceinline__ void run(unsigned (&p)[Q],
                                               const int (&c)[Q]) {
        constexpr int kImm = 4 * mb_slot((1 << K) - 1);
        constexpr unsigned kInc = 4u * (unsigned)mb_slot(1 << K);
        int v[Q];
#pragma unroll
        for (int s = 0; s < Q; ++s) v[s] = lds<kImm>(p[s]);
#pragma unroll
        for (int s = 0; s < Q; ++s) p[s] += v[s] < c[s] ? kInc : 0u;
        Steps<K - 1, Q>::run(p, c);
    }
};
template <int Q>
struct Steps<-1, Q> {
    static __device__ __forceinline__ void run(unsigned (&)[Q],
                                               const int (&)[Q]) {}
};

// The search of a tile of `top` slots (a power of two): log2(top)
// steps, the unrolled body picked by one uniform branch a chunk.
template <int Q>
__device__ __forceinline__ void search_tile(unsigned (&p)[Q],
                                            const int (&c)[Q], int top) {
    switch (31 - __clz(top)) {
        case 0: break;
        case 1: Steps<0, Q>::run(p, c); break;
        case 2: Steps<1, Q>::run(p, c); break;
        case 3: Steps<2, Q>::run(p, c); break;
        case 4: Steps<3, Q>::run(p, c); break;
        case 5: Steps<4, Q>::run(p, c); break;
        case 6: Steps<5, Q>::run(p, c); break;
        case 7: Steps<6, Q>::run(p, c); break;
        case 8: Steps<7, Q>::run(p, c); break;
        case 9: Steps<8, Q>::run(p, c); break;
        case 10: Steps<9, Q>::run(p, c); break;
        case 11: Steps<10, Q>::run(p, c); break;
        case 12: Steps<11, Q>::run(p, c); break;
        case 13: Steps<12, Q>::run(p, c); break;
        default: Steps<MB_MAX_LOG - 1, Q>::run(p, c); break;
    }
}

// This thread's Q candidates of chunk j of row b: c (invalid ones
// replaced by CAND_PAD) and a bit per candidate inside the row.  VEC:
// columns j·QG + Q·rank .. + Q-1 (16-byte loads); else j·QG + rank + s·G.
template <bool VEC, int G, int Q>
__device__ __forceinline__ unsigned load_cands(const MbArgs& a, long long b,
                                               int j, int rank,
                                               int (&c)[Q]) {
    const long long row = b * (long long)a.D;
    unsigned in = 0;
    if (VEC) {
        const int d0 = j * Q * G + Q * rank;
        if (d0 < a.D) {            // D % 4 == 0: all of a quad or none
#pragma unroll
            for (int q = 0; q < Q / 4; ++q) {
                if (d0 + 4 * q < a.D) {
                    const int4 v = __ldg(reinterpret_cast<const int4*>(
                        a.cand + row + d0 + 4 * q));
                    c[4 * q] = v.x; c[4 * q + 1] = v.y;
                    c[4 * q + 2] = v.z; c[4 * q + 3] = v.w;
                    in |= 0xfu << (4 * q);
                    if (a.valid != nullptr) {
                        const unsigned ok = __ldg(reinterpret_cast<
                            const unsigned*>(a.valid + row + d0 + 4 * q));
#pragma unroll
                        for (int s = 0; s < 4; ++s) {
                            if (((ok >> (8 * s)) & 0xffu) == 0) {
                                c[4 * q + s] = MB_CAND_PAD;
                            }
                        }
                    }
                } else {
#pragma unroll
                    for (int s = 0; s < 4; ++s) c[4 * q + s] = 0;
                }
            }
        }
    } else {
#pragma unroll
        for (int s = 0; s < Q; ++s) {
            const int d = j * Q * G + rank + s * G;
            c[s] = 0;
            if (d < a.D) {
                c[s] = __ldg(a.cand + row + d);
                if (a.valid != nullptr && __ldg(a.valid + row + d) == 0) {
                    c[s] = MB_CAND_PAD;
                }
                in |= 1u << s;
            }
        }
    }
    return in;
}

template <bool COUNT, bool VEC, int G, int Q>
__global__ void __launch_bounds__(MB_THREADS, 1)
membership_padded_kernel(const MbArgs a) {
    extern __shared__ __align__(16) int mb_smem[];
    __shared__ int wsum[2][MB_THREADS / 32];
    const int rank = G == 32 ? (int)(threadIdx.x & 31) : (int)threadIdx.x;
    const int groups = (int)blockDim.x / G;
    const int gib = G == 32 ? (int)(threadIdx.x >> 5) : 0;
    const unsigned buf_bytes = 4u * (unsigned)a.buf_words;
    const unsigned bufs = (unsigned)__cvta_generic_to_shared(mb_smem)
                          + 2u * buf_bytes * (unsigned)gib;
    const int n_chunks = (a.D + Q * G - 1) / (Q * G);
    auto sync = [] {
        if (G == 32) {
            __syncwarp();
        } else {
            __syncthreads();
        }
    };

    Walk walk;
    walk.stride = (long long)gridDim.x * groups;
    Item cur, nxt;
    bool have = walk.start(a, (long long)blockIdx.x * groups + gib, cur);
    int nc[Q];                     // the next chunk's candidates
    unsigned nin = 0;
    if (have) {
        stage<G>(bufs, a, cur, rank);
        nin = load_cands<VEC, G, Q>(a, cur.b, 0, rank, nc);
    }
    int parity = 0, prev_last = 0, acc = 0;
    int row_par = 0;               // block groups: wsum half of the row
    long long pend_b = -1;         // block groups: row whose sum is due
    while (have) {
        cp_async_wait_all();
        sync();                    // this item's tile is in; the other
                                   // buffer's last search is done
        if (COUNT && G > 32 && pend_b >= 0) {
            if (threadIdx.x == 0) {
                int total = 0;
#pragma unroll
                for (int w = 0; w < MB_THREADS / 32; ++w) {
                    total += wsum[row_par ^ 1][w];
                }
                a.count[pend_b] = total;
            }
            pend_b = -1;
        }
        const bool have_next = walk.next(a, cur, nxt);
        const unsigned buf = bufs + (unsigned)parity * buf_bytes;
        if (have_next) stage<G>(bufs + (unsigned)(parity ^ 1) * buf_bytes,
                                a, nxt, rank);

        const int n = tile_n(a, cur);
        const int top = mb_pow2ceil(max(n, 1));
        const bool first = cur.t == 0, last_tile = cur.t == cur.T - 1;
        const int last = n > 0 ? lds<0>(buf + 4u * (unsigned)mb_slot(n - 1))
                               : 0;
        const long long row = cur.b * (long long)a.D;
        for (int j = 0; j < n_chunks; ++j) {
            int c[Q];
#pragma unroll
            for (int s = 0; s < Q; ++s) c[s] = nc[s];
            const unsigned in = nin;
            if (j + 1 < n_chunks) {
                nin = load_cands<VEC, G, Q>(a, cur.b, j + 1, rank, nc);
            } else if (have_next) {
                nin = load_cands<VEC, G, Q>(a, nxt.b, 0, rank, nc);
            }
            if (in == 0) continue;
            unsigned p[Q];
#pragma unroll
            for (int s = 0; s < Q; ++s) p[s] = buf;
            search_tile<Q>(p, c, top);
            unsigned hit = 0, own = 0;
#pragma unroll
            for (int s = 0; s < Q; ++s) {
                hit |= (lds<0>(p[s]) == c[s] ? 1u : 0u) << s;
                own |= ((first || c[s] > prev_last)
                        && (last_tile || c[s] <= last) ? 1u : 0u) << s;
            }
            own &= in;
            if (COUNT) {
                acc += __popc(hit & own);
            } else if (VEC) {
                uint8_t* out = a.mask + row + j * Q * G + Q * rank;
#pragma unroll
                for (int q = 0; q < Q / 4; ++q) {
                    const unsigned h = hit >> (4 * q), o = own >> (4 * q);
                    if ((o & 0xfu) == 0xfu) {
                        *reinterpret_cast<unsigned*>(out + 4 * q) =
                            (h & 1u) | ((h & 2u) << 7) | ((h & 4u) << 14)
                            | ((h & 8u) << 21);
                    } else {
#pragma unroll
                        for (int s = 0; s < 4; ++s) {
                            if ((o >> s) & 1u) out[4 * q + s] = (h >> s) & 1u;
                        }
                    }
                }
            } else {
#pragma unroll
                for (int s = 0; s < Q; ++s) {
                    if ((own >> s) & 1u) {
                        a.mask[row + j * Q * G + rank + s * G] =
                            (hit >> s) & 1u;
                    }
                }
            }
        }
        prev_last = last;
        if (COUNT && last_tile) {
            int s = acc;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                s += __shfl_xor_sync(0xffffffffu, s, off);
            }
            if (G == 32) {
                if (rank == 0) a.count[cur.b] = s;
            } else {
                if ((threadIdx.x & 31) == 0) wsum[row_par][threadIdx.x >> 5] = s;
                pend_b = cur.b;
                row_par ^= 1;
            }
            acc = 0;
        }
        cur = nxt;
        have = have_next;
        parity ^= 1;
    }
    if (COUNT && G > 32 && pend_b >= 0) {
        __syncthreads();
        if (threadIdx.x == 0) {
            int total = 0;
#pragma unroll
            for (int w = 0; w < MB_THREADS / 32; ++w) {
                total += wsum[row_par ^ 1][w];
            }
            a.count[pend_b] = total;
        }
    }
}

static int g_num_sms = 0, g_smem_optin = 0;

template <bool COUNT, bool VEC, int G, int Q>
static int launch_padded(const MbArgs& a, cudaStream_t stream) {
    void (*kernel)(const MbArgs) = membership_padded_kernel<COUNT, VEC, G, Q>;
    if (g_num_sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount,
                               dev);
        cudaDeviceGetAttribute(&g_smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    const size_t smem_max = (size_t)g_smem_optin - attr.sharedSizeBytes;
    const size_t per_group = (size_t)2 * a.buf_words * sizeof(int);
    if (per_group > smem_max) return (int)cudaErrorInvalidValue;
    int groups = 1;
    if (G == 32) {
        groups = (int)min(smem_max / per_group, (size_t)(MB_THREADS / 32));
    }
    const int threads = G == 32 ? 32 * groups : G;
    const size_t smem = per_group * (size_t)groups;
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
    // one wave of resident blocks, each group walking several rows
    long long blocks = ((long long)a.B + groups - 1) / groups;
    const long long resident = (long long)max(per_sm, 1) * max(g_num_sms, 1);
    if (blocks > resident) blocks = resident;
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// A warp per row takes 8 candidates a thread (8 searches in flight)
// where D fills a chunk of 256, else 4; a block per row 4, so that a
// chunk of 1,024 candidates is one pass.
template <bool COUNT>
static int launch_group(const MbArgs& a, bool vec, int group,
                        cudaStream_t s) {
    if (group == 32 && a.D >= 8 * 32) {
        return vec ? launch_padded<COUNT, true, 32, 8>(a, s)
                   : launch_padded<COUNT, false, 32, 8>(a, s);
    }
    if (group == 32) {
        return vec ? launch_padded<COUNT, true, 32, 4>(a, s)
                   : launch_padded<COUNT, false, 32, 4>(a, s);
    }
    return vec ? launch_padded<COUNT, true, MB_THREADS, 4>(a, s)
               : launch_padded<COUNT, false, MB_THREADS, 4>(a, s);
}

extern "C" int membership_max_tile() { return MB_MAX_TILE; }

// The static rule: a warp per row up to MB_WARP_MAX_L entries, a block
// of MB_THREADS beyond (on an H100 a warp per row was faster at 1,000
// and 1,024 entries, a block at 4,000 and 4,096: PERF.md).
extern "C" int membership_group(int L) {
    return L <= MB_WARP_MAX_L ? 32 : MB_THREADS;
}

// Launches K2 (count = 0; out is uint8 [B, D]) or K3 (count = 1; out is
// int32 [B]) on `stream`: rows searched in tiles of `tile` int32
// (1 .. MB_MAX_TILE); nbr_len (int32 [B]) and valid (uint8 [B, D]) may
// be null.  `group` 0 takes membership_group(L); 32 or MB_THREADS force
// a warp or a block per row (the result never depends on it).  Returns
// cudaGetLastError() (0 = launched).
extern "C" int membership_launch(const int* cand, const int* nbr,
                                 const int* nbr_len, const uint8_t* valid,
                                 int B, int D, int L, int tile, int count,
                                 int group, void* out, void* stream) {
    if (B < 1 || D < 1 || L < 1 || tile < 1 || tile > MB_MAX_TILE) {
        return (int)cudaErrorInvalidValue;
    }
    if (group == 0) group = membership_group(L);
    if (group != 32 && group != MB_THREADS) {
        return (int)cudaErrorInvalidValue;
    }
    const int top_max = mb_pow2ceil(min(tile, L));
    MbArgs a;
    a.cand = cand;
    a.nbr = nbr;
    a.nbr_len = nbr_len;
    a.valid = valid;
    a.mask = count ? nullptr : (uint8_t*)out;
    a.count = count ? (int*)out : nullptr;
    a.B = B;
    a.D = D;
    a.L = L;
    a.tile = tile;
    a.buf_words = (mb_slot(top_max - 1) + 1 + 3) & ~3;
    // 16-byte candidate loads, 4-byte validity loads and mask stores
    const bool vec = D % 4 == 0 && (uintptr_t)cand % 16 == 0
                     && (uintptr_t)valid % 4 == 0
                     && (count || (uintptr_t)out % 4 == 0);
    cudaStream_t s = (cudaStream_t)stream;
    return count ? launch_group<true>(a, vec, group, s)
                 : launch_group<false>(a, vec, group, s);
}

// ---------------------------------------------------- the first version
#define MB_LINEAR_THREADS 256
#define MB_LINEAR_MAX_TILE 4096

template <bool COUNT>
__global__ void __launch_bounds__(MB_LINEAR_THREADS)
membership_linear_kernel(const int* __restrict__ cand,
                         const int* __restrict__ nbr,
                         int D, int L, int tile,
                         uint8_t* __restrict__ mask_out,
                         int* __restrict__ count_out) {
    extern __shared__ int row_tile[];
    __shared__ int warp_sums[MB_LINEAR_THREADS / 32];
    const long long b = blockIdx.x;
    const int* row = nbr + b * (long long)L;
    const int* crow = cand + b * (long long)D;
    const int n_tiles = (L + tile - 1) / tile;
    int acc = 0;
    for (int t = 0; t < n_tiles; ++t) {
        const int t0 = t * tile;
        const int n = min(tile, L - t0);
        __syncthreads();                     // the previous tile is done
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            row_tile[i] = row[t0 + i];
        }
        __syncthreads();
        // c belongs to this tile iff prev_last < c <= last (the first
        // tile has no lower end, the last tile no upper end)
        const bool first = t == 0, last_tile = t == n_tiles - 1;
        const int prev_last = first ? 0 : __ldg(row + t0 - 1);
        const int last = row_tile[n - 1];
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
            const int c = crow[d];
            if ((!first && c <= prev_last) || (!last_tile && c > last)) {
                continue;
            }
            int lo = 0, hi = n;              // lower bound of c in the tile
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (row_tile[mid] < c) {
                    lo = mid + 1;
                } else {
                    hi = mid;
                }
            }
            const bool hit = lo < n && row_tile[lo] == c;
            if (COUNT) {
                acc += hit ? 1 : 0;
            } else {
                mask_out[b * (long long)D + d] = hit ? 1 : 0;
            }
        }
    }
    if (COUNT) {
        for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        }
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        if (lane == 0) warp_sums[warp] = acc;
        __syncthreads();
        if (threadIdx.x == 0) {
            int total = 0;
            for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) {
                total += warp_sums[w];
            }
            count_out[b] = total;
        }
    }
}

extern "C" int membership_linear_max_tile() { return MB_LINEAR_MAX_TILE; }

// The first version, on inputs the caller has padded (invalid candidates
// -1, positions past a row's valid length INT32_MAX): one block per row,
// rows searched in linear shared tiles of `tile` int32
// (1 .. MB_LINEAR_MAX_TILE).  Returns cudaGetLastError().
extern "C" int membership_linear_launch(const int* cand, const int* nbr,
                                        int B, int D, int L, int tile,
                                        int count, void* out, void* stream) {
    if (B < 1 || D < 1 || L < 1 || tile < 1 || tile > MB_LINEAR_MAX_TILE) {
        return (int)cudaErrorInvalidValue;
    }
    const int smem_tile = min(tile, L);
    // every candidate column gets a thread where D allows, whole warps
    const int threads = min(MB_LINEAR_THREADS, (D + 31) / 32 * 32);
    const size_t smem = (size_t)smem_tile * sizeof(int);
    cudaStream_t s = (cudaStream_t)stream;
    if (count) {
        membership_linear_kernel<true><<<(unsigned)B, threads, smem, s>>>(
            cand, nbr, D, L, smem_tile, nullptr, (int*)out);
    } else {
        membership_linear_kernel<false><<<(unsigned)B, threads, smem, s>>>(
            cand, nbr, D, L, smem_tile, (uint8_t*)out, nullptr);
    }
    return (int)cudaGetLastError();
}
