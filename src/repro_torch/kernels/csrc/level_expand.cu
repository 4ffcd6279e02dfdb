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
// Design.  The TPU kernel broadcast-compares VMEM blocks of the
// candidate row against DMA'd neighbour blocks.  On Hopper the simple,
// correct shape is a binary search per candidate in each predecessor's
// sorted CSR row: one warp per frontier row, lanes striding over d, so
// the 32 lanes of a warp read consecutive candidates (coalesced) and the
// per-row offsets are broadcast loads.  A search costs
// P * ceil(log2 W) dependent loads that mostly hit L2 (the whole flat
// CSR array of the graphs this runs on fits in the 50 MB L2), and no
// shared memory.  The cheap comparisons against `extra` run first and a
// failed predecessor ends the search for that candidate.
//
// What bounds it.  The least traffic is one read of cand (4 B) and
// valid (1 B) per candidate, one read of each predecessor row, and the
// output (1 B per candidate, or 4 B per row): at the executor's shapes
// that is a memory-bound pass at 3.35 TB/s.  This first version is
// latency-bound instead, on the dependent loads of the searches; staging
// rows in shared memory or a merge-path intersection is later work.
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
