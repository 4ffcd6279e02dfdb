// Kernel K4: forward attention with an online softmax (flash attention).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the TPU kernel, body `_flash_body`).  Same function:
//
//   o[bh, i, :] = softmax_j(scale * q[bh, i, :] . k[bh / G, j, :]) v[bh / G, j, :]
//
// with q and k widened to fp32 before the dot, scale = 1/sqrt(hd) unless
// given, masked scores (causal: j > i) set to NEG_INF = -1e30 (a finite
// value, as in the reference), a running max m, sum l and accumulator
// acc in fp32 rescaled by exp(m_prev - m_new) at every key tile, and
// o = acc / max(l, 1e-30) cast to q's dtype.  Key tiles wholly above
// the causal diagonal are skipped.  G = BH / BK query rows share one
// K/V row (zero-copy grouped-query attention: no per-head copy).
//
// Layout: q, o [BH, Sq, hd]; k, v [BK, Sk, hd]; contiguous; float32 or
// bfloat16; any Sq, Sk >= 1 (ragged tiles are bounds-checked); hd <= 128.
//
// Design for Hopper (simple and right; not yet fast).  The TPU kernel
// used 512 x 512 blocks sized for many megabytes of VMEM; here one
// thread block of 256 threads owns one tile of 64 query rows of one
// (batch, head) row and walks the key axis in tiles of 64 rows.  The Q
// tile and each K tile are staged in shared memory transposed and
// widened to fp32 ([hd][65]: the odd stride keeps both the transposing
// stores and the reads free of bank conflicts), V row-major in fp32.
// Thread (ty, tx) of a 16 x 16 layout holds a 4 x 4 block of scores
// (rows 4ty..4ty+3, columns tx + 16j) in registers, so the 16 threads
// of one row group are 16 lanes of one warp and the row max and row sum
// of the online softmax are warp shuffles; the probabilities go through
// shared memory once to feed P.V, whose 4 x hd/16 accumulator block
// stays in registers for the whole key loop.  All arithmetic is scalar
// fp32 FMA (the reference's fp32 dots); no tensor cores.
//
// What bounds it on this card: at the serving shape (BH = 64, S = 2048,
// hd = 128, causal) the work is ~6.9e10 FLOP against ~0.1 GB of q, k, v
// and o, so the least time is set by operations at the tensor-core
// rate.  This kernel instead runs on the fp32 cores and is limited by
// shared-memory reads (about one per two FMAs), so it is expected to
// sit far above that bound; wgmma on bf16 tiles fed by TMA, with the
// softmax overlapped, is the later work that closes the gap.
//
// C interface (bound with ctypes): flash_attention_launch returns the
// CUDA error of the launch (0 on success); it does not synchronise and
// allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BKV = 64;          // key rows per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int STRIDE = 65;       // row stride (floats) of the transposed tiles and P
constexpr int MAX_HD = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) { *p = __float2bfloat16_rn(x); }

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * HDP * STRIDE + BKV * HDP + BQ * STRIDE);
}

// HDP: hd rounded up to 16, 32, 64 or 128; columns hd..HDP-1 are zeros.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          int Sq, int Sk, int hd, int group, int causal, float sm_scale) {
  extern __shared__ float smem[];
  float* Qt = smem;                  // [HDP][STRIDE]: Qt[d][r]
  float* Kt = Qt + HDP * STRIDE;     // [HDP][STRIDE]: Kt[d][c]
  float* Vs = Kt + HDP * STRIDE;     // [BKV][HDP]
  float* Ps = Vs + BKV * HDP;        // [BQ][STRIDE]: probabilities

  constexpr int CPT = HDP / 16;      // output columns per thread
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // the heaviest causal tiles (last query rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t bh = blockIdx.y;
  const int64_t kv = bh / group;
  const T* qb = q + bh * Sq * hd;
  const T* kb = k + kv * Sk * hd;
  const T* vb = v + kv * Sk * hd;
  T* ob = o + bh * Sq * hd;

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    float x = 0.f;
    if (q0 + r < Sq && d < hd) x = widen(qb[(int64_t)(q0 + r) * hd + d]);
    Qt[d * STRIDE + r] = x;
  }

  float acc[4][CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (Sk + BKV - 1) / BKV;
  if (causal) {
    // skip key tiles wholly above the diagonal (first key > last query)
    const int last_tile = (q0 + BQ - 1) / BKV + 1;
    n_kt = n_kt < last_tile ? n_kt : last_tile;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();               // the previous tile's reads are done
    for (int i = tid; i < BKV * HDP; i += THREADS) {
      const int c = i / HDP, d = i % HDP;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk && d < hd) {
        const int64_t off = (int64_t)(k0 + c) * hd + d;
        kx = widen(kb[off]);
        vx = widen(vb[off]);
      }
      Kt[d * STRIDE + c] = kx;
      Vs[c * HDP + d] = vx;
    }
    __syncthreads();

    // scores: s[i][j] = q[4ty + i] . k[tx + 16j], fp32
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qt[d * STRIDE + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Kt[d * STRIDE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // online softmax over this tile, one row group per 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < Sk && (!causal || row >= col);
        s[i][j] = keep ? s[i][j] * sm_scale : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty * 4 + i) * STRIDE + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc[i][c] += sum_j p[4ty + i][j] * v[j][tx + 16c]
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float p[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * STRIDE + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[j * HDP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) narrow(acc[i][c] / li, &ob[(int64_t)row * hd + col]);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int hd, int group, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd<T, HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, hd, group,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                int BH, int Sq, int Sk, int hd, int group, int causal,
                float sm_scale, cudaStream_t s) {
  if (hd <= 16) return launch<T, 16>(q, k, v, o, BH, Sq, Sk, hd, group, causal, sm_scale, s);
  if (hd <= 32) return launch<T, 32>(q, k, v, o, BH, Sq, Sk, hd, group, causal, sm_scale, s);
  if (hd <= 64) return launch<T, 64>(q, k, v, o, BH, Sq, Sk, hd, group, causal, sm_scale, s);
  return launch<T, 128>(q, k, v, o, BH, Sq, Sk, hd, group, causal, sm_scale, s);
}

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return MAX_HD; }

// dtype: 0 = float32, 1 = bfloat16.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int BH, int BK, int Sq, int Sk, int hd,
                           int causal, float sm_scale, int dtype,
                           void* stream) {
  if (BH <= 0 || BK <= 0 || BH % BK != 0 || BH > 65535 || Sq <= 0 ||
      Sk <= 0 || hd <= 0 || hd > MAX_HD)
    return (int)cudaErrorInvalidValue;
  const int group = BH / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, BH, Sq, Sk, hd, group, causal, sm_scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, hd, group, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
