// K2 and K3: sorted-row membership and intersection count, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels `membership_pallas` (K2,
// src/repro/kernels/intersect.py:307, body `_membership_body` at :54)
// and `intersect_count_pallas` (K3, intersect.py:338, body `_count_body`
// at :69).  For every row b and candidate column d:
//
//   K2 (mask mode):  mask[b,d] = cand[b,d] ∈ nbr[b, 0:L]     (1 byte)
//   K3 (count mode): cnt[b]    = #{d : cand[b,d] ∈ nbr[b, 0:L]}   (int32)
//
// over stacked dense rows nbr [B, L], each non-decreasing (the wrapper,
// kernels/ops.py, has already replaced invalid candidates by -1 and the
// positions past a row's valid length by INT32_MAX).  Duplicate
// candidates count separately, as in the reference.
//
// Design.  The TPU kernel broadcast-compares [block_b, block_d] candidate
// blocks against [block_b, block_l] neighbour blocks in VMEM, an
// O(D·L) compare cube per row.  Here every candidate of row b reads the
// same row, so one thread block takes one row: its threads copy the row
// into shared memory in coalesced tiles of at most `tile` int32 (16 KB at
// the default 4,096), then each thread binary-searches its candidates
// (d = threadIdx.x, + blockDim.x, ...) in the shared tile.  A candidate c
// is searched in exactly one tile, the one that holds the first entry
// ≥ c: tile t takes c when c > (last entry of tile t-1) and, unless t is
// the last tile, c ≤ (last entry of tile t).  So a candidate is found at
// most once, the mask is written once per candidate, and rows longer
// than a tile cost one extra pass over the candidates per tile.  Count
// mode sums each thread's hits, reduces across the warp with shuffles and
// across warps in shared memory, and one thread writes the row's count:
// one block per row, so no atomics.
//
// What bounds it.  The least traffic is one read of cand and nbr (4 B
// each per entry) and the output (1 B per candidate, or 4 B per row):
// a memory-bound pass at 3.35 TB/s.  The compares, ceil(log2(L+1)) per
// candidate, are two orders below that on the cores.  This first version
// reads each row once from device memory and searches it in shared
// memory; the searches' bank conflicts, not the copies, are what it
// spends beyond the bound.  TMA row copies and wider tiles are later
// work.
//
// Contract (checked by the Python wrapper): cand [B, D] and nbr [B, L]
// int32, contiguous, on one device, rows non-decreasing, L >= 1; the
// launch on the caller's stream; the function returns
// cudaGetLastError() so a refused launch surfaces at once.
#include <cuda_runtime.h>
#include <stdint.h>

#define MB_MAX_THREADS 256
#define MB_MAX_TILE 4096

template <bool COUNT>
__global__ void __launch_bounds__(MB_MAX_THREADS)
membership_kernel(const int* __restrict__ cand,
                  const int* __restrict__ nbr,
                  int D, int L, int tile,
                  uint8_t* __restrict__ mask_out,
                  int* __restrict__ count_out) {
    extern __shared__ int row_tile[];
    __shared__ int warp_sums[MB_MAX_THREADS / 32];
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

extern "C" int membership_max_tile() { return MB_MAX_TILE; }

// Launches K2 (count = 0; out is uint8 [B, D]) or K3 (count = 1; out is
// int32 [B]) on `stream`, one block per row, rows searched in shared
// tiles of `tile` int32 (1 .. MB_MAX_TILE).  Returns cudaGetLastError()
// (0 = launched).
extern "C" int membership_launch(const int* cand, const int* nbr,
                                 int B, int D, int L, int tile, int count,
                                 void* out, void* stream) {
    if (B < 1 || D < 1 || L < 1 || tile < 1 || tile > MB_MAX_TILE) {
        return (int)cudaErrorInvalidValue;
    }
    const int smem_tile = min(tile, L);
    // every candidate column gets a thread where D allows, whole warps
    const int threads = min(MB_MAX_THREADS, (D + 31) / 32 * 32);
    const size_t smem = (size_t)smem_tile * sizeof(int);
    cudaStream_t s = (cudaStream_t)stream;
    if (count) {
        membership_kernel<true><<<(unsigned)B, threads, smem, s>>>(
            cand, nbr, D, L, smem_tile, nullptr, (int*)out);
    } else {
        membership_kernel<false><<<(unsigned)B, threads, smem, s>>>(
            cand, nbr, D, L, smem_tile, (uint8_t*)out, nullptr);
    }
    return (int)cudaGetLastError();
}
