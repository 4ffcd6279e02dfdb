// Kernel K4: forward attention with an online softmax (flash attention).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the TPU kernel, body `_flash_body`).  Same function:
//
//   o[bh, i, :] = softmax_j(scale * q[bh, i, :] . k[bh / G, j, :]) v[bh / G, j, :]
//
// with the dots accumulated in fp32, scale = 1/sqrt(hd) unless given,
// masked scores (causal: j > i; and j >= Sk) set to NEG_INF = -1e30 (a
// finite value, as in the reference), a running max m, sum l and
// accumulator acc in fp32 rescaled at every key tile, and
// o = acc / max(l, 1e-30) cast to q's dtype.  Key tiles wholly above the
// causal diagonal are neither loaded nor computed.  G = BH / BK query
// rows share one K/V row (zero-copy grouped-query attention).
//
// Layout: q, o [BH, Sq, hd]; k, v [BK, Sk, hd]; contiguous; float32 or
// bfloat16; any Sq, Sk >= 1; hd <= 128.
//
// Two kernels, picked by a static rule on dtype and head dim
// (`flash_attention_variant`, never by trying one and falling back):
//
//  * `wgmma::flash_fwd` for bfloat16 with hd % 8 == 0 (the serving
//    path).  What bounds it: at the serving shape (BH = 64, S = 2048,
//    hd = 128, causal) the work is ~6.9e10 FLOP against ~0.1 GB of q, k,
//    v and o, so the least time is set by operations at the bf16
//    tensor-core rate.  The design feeds the tensor cores from a ring of
//    shared-memory tiles that TMA fills while they work:
//      - one block of three warpgroups owns BQ = 128 query rows of one
//        (batch, head) row.  Warpgroup 0 is the producer: one thread
//        issues every TMA load and the warpgroup gives its registers up
//        (setmaxnreg).  Warpgroups 1 and 2 each own 64 query rows;
//      - the Q tile is loaded once; K and V tiles of BKV = 128 keys go
//        through a 2-stage ring (Q 32 KB + 2 x 64 KB at hd 128).  Each
//        stage has `full` barriers for K and for V, which count the TMA's
//        bytes, and `empty` barriers for K and for V, on which every
//        consumer warp arrives once the wgmma reading the tile has
//        retired; K is released after S = Q.K^T, V after P.V, so the next
//        tiles' loads start a whole key tile before they are needed;
//      - S = Q.K^T is wgmma m64n128k16 with Q and K read from shared
//        memory, both K-major (hd contiguous: K needs no transposed
//        copy), 128-byte swizzle in the tensor maps and the descriptors;
//      - the online softmax runs on the accumulator fragment in
//        registers: a row lives on the four threads of a quad, so its max
//        is two shuffles; scores are scaled by scale * log2(e) and
//        exponentiated with ex2; the per-thread row sums are reduced
//        across the quad once, at the end;
//      - O += P.V is wgmma with P as the A operand from registers: P is
//        rounded to bf16 and the m64n128k16 accumulator layout of S is
//        the register-A layout of four k16 steps, so P never goes through
//        shared memory.  V is the B operand read MN-major (hd
//        contiguous), in its own layout;
//      - in the loop, the wgmma of S for key tile j and of P.V for tile
//        j - 1 are issued together; the softmax of tile j overlaps the
//        P.V of tile j - 1, and O is rescaled only after that P.V has
//        retired;
//      - the mask is applied only on tiles that the diagonal or the end
//        of the keys crosses; the heaviest causal query tiles are
//        scheduled first; a 3-D tensor map per tensor keeps a ragged
//        tile's rows past Sk (and columns past hd) zero instead of the
//        next head's;
//      - no split along the key axis and no atomics: each output tile is
//        written once by one block, and two launches on the same inputs
//        give the same bits.
//    The numerics differ from the reference's fp32 products in two
//    places: q, k and v are bf16 already, and P is rounded to bf16 before
//    P.V (about 2^-9 relative per term).  kernels/ref.py's
//    `flash_attention_tiled_ref` repeats this arithmetic tile by tile.
//
//  * `scalar::flash_fwd` (the first port of K4) for float32, whose
//    reference tolerance of 2e-5 rules out bf16 and TF32 tensor-core
//    products, and for hd % 8 != 0, where a TMA row stride would not be a
//    multiple of 16 bytes.  One thread block of 256 threads owns 64
//    query rows and walks the keys in tiles of 64, staged in shared
//    memory transposed and widened to fp32; every dot is a scalar fp32
//    FMA, bounded by shared-memory reads far above the tensor-core bound.
//    Its bf16 instantiation is also kept callable (variant 0) so that
//    chip_smoke.py can time it beside the wgmma kernel.
//
// C interface (bound with ctypes): flash_attention_launch returns the
// CUDA error of the launch (0 on success); it does not synchronise and
// allocates nothing.  The tensor maps are encoded on the host once per
// launch, through cuTensorMapEncodeTiled fetched with
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_HD = 128;
constexpr float NEG_INF = -1e30f;

namespace scalar {

constexpr int BQ = 64;           // query rows per block
constexpr int BKV = 64;          // key rows per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int STRIDE = 65;       // row stride (floats) of the transposed tiles and P

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

}  // namespace scalar

namespace wgmma {

using namespace hopper;

constexpr int BQ = 128;           // query rows per block, 64 per consumer
constexpr int BKV = 128;          // keys per tile
constexpr int STAGES = 2;         // K/V ring depth
constexpr int THREADS = 384;      // producer + two consumer warpgroups
constexpr int BOX_COLS = 64;      // bf16 columns of one 128-byte row
constexpr int ROW_BYTES = 128;
constexpr int Q_BOX = BQ * ROW_BYTES;     // one 64-column box of Q
constexpr int KV_BOX = BKV * ROW_BYTES;   // one 64-column box of K or V
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory from a 1,024-byte aligned base: the Q tile, then K
// stages, then V stages, each [NB boxes][rows][128 B] swizzled as TMA
// writes it, then the barriers.
template <int HDP>
struct Smem {
  static constexpr int NB = HDP / BOX_COLS;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;          // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 4 * STAGES;  // q, full_k, full_v, empty_k, empty_v
  static constexpr size_t BYTES = BAR_OFF + 8 * N_BARS + 1024;  // + alignment slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x BKV] = Q[64 rows of this warpgroup] . K_tile^T, hd / 16 steps;
// step kk reads 16 columns of box kk / 4 at byte 32 * (kk % 4) of its rows.
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&s)[BKV / 2], uint32_t q_base,
                                         uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_m64n128k16_ss(s, desc_sw128(q_base + (kk / 4) * Q_BOX + col, 16, 1024),
                        desc_sw128(k_base + (kk / 4) * KV_BOX + col, 16, 1024),
                        kk > 0);
  }
}

__device__ __forceinline__ void pv_step(float (&o)[64], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint64_t desc_v) {
  wgmma_m64n128k16_rs_mn(o, a0, a1, a2, a3, desc_v);
}

__device__ __forceinline__ void pv_step(float (&o)[32], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint64_t desc_v) {
  wgmma_m64n64k16_rs_mn(o, a0, a1, a2, a3, desc_v);
}

// O[64 x HDP] += P[64 x BKV] . V_tile: step t reads keys 16t .. 16t + 15
// (two 8-row atoms, 1,024 bytes apart); along hd the 64-column boxes are
// KV_BOX bytes apart.
template <int HDP>
__device__ __forceinline__ void issue_pv(float (&o)[HDP / 2],
                                         const uint32_t (&p)[BKV / 4],
                                         uint32_t v_base) {
#pragma unroll
  for (int t = 0; t < BKV / 16; ++t)
    pv_step(o, p[4 * t], p[4 * t + 1], p[4 * t + 2], p[4 * t + 3],
            desc_sw128(v_base + t * 16 * ROW_BYTES, KV_BOX, 1024));
}

// One key tile of the online softmax on the S fragment (see hopper.cuh
// for the map): scores scaled to log2 units, masked to NEG_INF, the new
// row maxima m0/m1 (rows row0 and row0 + 8), the rescale factors a0/a1
// of the old state, the probabilities written back into s, and this
// thread's share of the row sums l0/l1.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1,
                                             float scale_log2, int k0,
                                             int col_lane, int row0, int Sk,
                                             int causal) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    float x = s[i] * scale_log2;
    if (MASK) {
      const int col = k0 + 8 * (i >> 2) + col_lane + (i & 1);
      const int row = row0 + ((i & 2) ? 8 : 0);
      if (col >= Sk || (causal && col > row)) x = NEG_INF;
    }
    s[i] = x;
    if (i & 2) mx1 = fmaxf(mx1, x);
    else mx0 = fmaxf(mx0, x);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  a0 = ex2(m0 - mn0);
  a1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    const float p = ex2(s[i] - ((i & 2) ? mn1 : mn0));
    s[i] = p;
    if (i & 2) r1 += p;
    else r0 += p;
  }
  l0 = l0 * a0 + r0;
  l1 = l1 * a1 + r1;
}

// The mask is applied only where the tile crosses the end of the keys or
// the diagonal of this warpgroup's rows (first_row .. first_row + 63).
__device__ __forceinline__ void softmax(float (&s)[BKV / 2], float& m0,
                                        float& m1, float& l0, float& l1,
                                        float& a0, float& a1, float scale_log2,
                                        int k0, int col_lane, int row0,
                                        int first_row, int Sk, int causal) {
  if (k0 + BKV > Sk || (causal && k0 + BKV - 1 > first_row))
    softmax_tile<true>(s, m0, m1, l0, l1, a0, a1, scale_log2, k0, col_lane,
                       row0, Sk, causal);
  else
    softmax_tile<false>(s, m0, m1, l0, l1, a0, a1, scale_log2, k0, col_lane,
                        row0, Sk, causal);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          __nv_bfloat16* __restrict__ o, int Sq, int Sk, int hd, int group,
          int causal, float scale_log2) {
  using L = Smem<HDP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int bh = blockIdx.x;
  // the heaviest causal query tiles (the last rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int n_kt = (Sk + BKV - 1) / BKV;
  if (causal) {
    // key tiles wholly above the diagonal (first key > last query row)
    // are never loaded
    const int last_tile = (q0 + BQ - 1) / BKV + 1;
    n_kt = n_kt < last_tile ? n_kt : last_tile;
  }

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], CONSUMER_WARPS);
      mbar_init(&empty_v[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // One if/else for the whole kernel: the roles never reconverge, so the
  // compiler can give each its own register budget.
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int kv = bh / group;
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(full_q, L::Q_BYTES);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
        tma_load_3d(smem + b * Q_BOX, &tm_q, full_q, b * BOX_COLS, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        // the tile that used this stage before (j - STAGES) was released
        const uint32_t parity = ((j / STAGES) - 1) & 1;
        uint8_t* kd = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* vd = smem + L::V_OFF + s * L::KV_BYTES;
        if (j >= STAGES) mbar_wait(&empty_k[s], parity);
        mbar_arrive_expect_tx(&full_k[s], L::KV_BYTES);
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
          tma_load_3d(kd + b * KV_BOX, &tm_k, &full_k[s], b * BOX_COLS, j * BKV, kv);
        if (j >= STAGES) mbar_wait(&empty_v[s], parity);
        mbar_arrive_expect_tx(&full_v[s], L::KV_BYTES);
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
          tma_load_3d(vd + b * KV_BOX, &tm_v, &full_v[s], b * BOX_COLS, j * BKV, kv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t & 31;
    const int row0 = q0 + 64 * cw + 16 * (t >> 5) + (lane >> 2);
    const int col_lane = 2 * (lane & 3);
    const int first_row = q0 + 64 * cw;
    const uint32_t q_base = smem_u32(smem) + 64 * cw * ROW_BYTES;
    const uint32_t k_base = smem_u32(smem + L::K_OFF);
    const uint32_t v_base = smem_u32(smem + L::V_OFF);

    float s[BKV / 2];
    float acc[HDP / 2];
    uint32_t p[BKV / 4];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, a0, a1;

    // key tile 0: S, softmax, P (nothing to rescale yet)
    mbar_wait(full_q, 0);
    mbar_wait(&full_k[0], 0);
    wgmma_fence();
    issue_qk<HDP>(s, q_base, k_base);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&empty_k[0]);
    softmax(s, m0, m1, l0, l1, a0, a1, scale_log2, 0, col_lane, row0,
            first_row, Sk, causal);
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    for (int j = 1; j < n_kt; ++j) {
      const int st = j % STAGES, sp = (j - 1) % STAGES;
      mbar_wait(&full_k[st], (j / STAGES) & 1);
      fence_regs(s);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      issue_qk<HDP>(s, q_base, k_base + st * L::KV_BYTES);    // S_j
      wgmma_commit();
      mbar_wait(&full_v[sp], ((j - 1) / STAGES) & 1);
      issue_pv<HDP>(acc, p, v_base + sp * L::KV_BYTES);       // O += P_{j-1} V_{j-1}
      wgmma_commit();
      wgmma_wait<1>();                                         // S_j done
      fence_regs(s);
      if (lane == 0) mbar_arrive(&empty_k[st]);
      softmax(s, m0, m1, l0, l1, a0, a1, scale_log2, j * BKV, col_lane, row0,
              first_row, Sk, causal);
      wgmma_wait<0>();                                         // P.V done
      fence_regs(acc);
      fence_regs(p);
      if (lane == 0) mbar_arrive(&empty_v[sp]);
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }
    const int sl = (n_kt - 1) % STAGES;
    mbar_wait(&full_v[sl], ((n_kt - 1) / STAGES) & 1);
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
    issue_pv<HDP>(acc, p, v_base + sl * L::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // o = acc / max(l, 1e-30): the row sums are reduced across the quad
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + (int64_t)bh * Sq * hd;
#pragma unroll
    for (int i = 0; i < HDP / 2; i += 2) {
      const int row = row0 + ((i & 2) ? 8 : 0);
      const int col = 8 * (i >> 2) + col_lane;
      const float d = (i & 2) ? d1 : d0;
      if (row < Sq && col < hd)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * hd + col) =
            __floats2bfloat162_rn(acc[i] / d, acc[i + 1] / d);
    }
  }
}

// cuTensorMapEncodeTiled of the CUDA driver API, fetched once through the runtime
// (so the library does not link libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D map over a contiguous bf16 [batch, rows, cols] tensor, boxes of
// 64 columns x box_rows rows x 1, 128-byte swizzle; out-of-range elements
// load as zeros.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int cols,
            int rows, int batch, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {BOX_COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int BK, int Sq, int Sk, int hd, int group, int causal,
           float sm_scale, cudaStream_t stream) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return (int)cudaErrorMisalignedAddress;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!encode(enc, &tq, q, hd, Sq, BH, BQ) ||
      !encode(enc, &tk, k, hd, Sk, BK, BKV) ||
      !encode(enc, &tv, v, hd, Sk, BK, BKV))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Smem<HDP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd<HDP><<<dim3(BH, n_qt), THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, hd, group, causal,
      sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace wgmma

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return MAX_HD; }

// The static rule: 1 (the wgmma kernel) for bfloat16 with hd % 8 == 0,
// else 0 (the scalar kernel: float32, or a head dim whose rows are not a
// multiple of 16 bytes).  dtype: 0 = float32, 1 = bfloat16.
int flash_attention_variant(int dtype, int hd) {
  return dtype == 1 && hd % 8 == 0 ? 1 : 0;
}

// variant: -1 = by flash_attention_variant; 0 = the scalar kernel (any
// dtype); 1 = the wgmma kernel (bfloat16, hd % 8 == 0, 16-byte aligned
// pointers).  A variant that does not take the inputs is refused.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int BH, int BK, int Sq, int Sk, int hd,
                           int causal, float sm_scale, int dtype, int variant,
                           void* stream) {
  if (BH <= 0 || BK <= 0 || BH % BK != 0 || Sq <= 0 || Sk <= 0 || hd <= 0 ||
      hd > MAX_HD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (variant < 0) variant = flash_attention_variant(dtype, hd);
  const int group = BH / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (flash_attention_variant(dtype, hd) != 1) return (int)cudaErrorInvalidValue;
    if (hd <= 64)
      return wgmma::launch<64>(q, k, v, o, BH, BK, Sq, Sk, hd, group, causal, sm_scale, s);
    return wgmma::launch<128>(q, k, v, o, BH, BK, Sq, Sk, hd, group, causal, sm_scale, s);
  }
  if (variant != 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return scalar::dispatch_hd<float>(q, k, v, o, BH, Sq, Sk, hd, group, causal, sm_scale, s);
  return scalar::dispatch_hd<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, hd, group, causal, sm_scale, s);
}

}  // extern "C"
