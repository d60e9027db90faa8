// Fused LoRA projection: y = x @ W + s * round_T(x @ A) @ B, one pass over x.
//
// Replaces: clip_lora_match_tpu/ops/lora_matmul.py (lora_matmul: _kernel).
// Contract kept: x (M, K), W (K, N), A (K, r), B (r, N), all of one type T
//   (fp32 or bf16), row-major and contiguous; base and rank-r products
//   accumulate in fp32; after K is exhausted the rank-r partial is rounded to
//   T (the TPU kernel's ab_acc.astype(x.dtype)), multiplied by B in fp32,
//   scaled by s and added; the sum is stored as T. The bias is added by the
//   caller, as in nn/layers.linear. Ragged M, N and K are masked here.
// What bounds it on the H100: at the seeker's shapes (M = 50 or 64 rows per
//   request, K = N = 768 or 512) bytes and launch latency; at batch shapes
//   (M = 4,800 or 16,384) operations: 2*M*N*K + 2*M*r*(K + N) FLOPs.
// Design: shared-memory tiled GEMMs, 64 x 64 output tile per block. The same
//   x tile that feeds the base product also feeds the block's (64 x r)
//   rank-r accumulator, so x is read once for both.
//   - bf16: tensor cores through WMMA (16 x 16 x 16 bf16 fragments, fp32
//     accumulators), 4 warps each owning a 32 x 32 quarter of the tile, K in
//     steps of 32; A is zero-padded to 16 or 32 columns, so the rank-r
//     product is one fragment product per step for r <= 16 (the serving
//     path's r = 8) and two for r <= 32; the epilogue applies B as a 16- or
//     32-deep fragment product and adds it to the base accumulators element
//     by element (same fragment layout).
//   - fp32: CUDA-core FMA, 256 threads, 4 x 4 outputs each.
//   Neither uses wgmma/TMA yet: that is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256, R_MAX = 32;
constexpr int XA_PER_THREAD = BM * R_MAX / THREADS;  // 8

// ---- fp32 CUDA-core path ---------------------------------------------------

__global__ void __launch_bounds__(THREADS) lora_matmul_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ y, int M, int N, int K, int r,
    float scaling) {
  __shared__ float xs[BK][BM + 4];     // x tile, transposed
  __shared__ float ws[BK][BN];         // W tile
  __shared__ float as_[BK][R_MAX];     // A tile
  __shared__ float xa[BM][R_MAX + 1];  // rank-r partial (rounding to fp32 is exact)
  __shared__ float bs[R_MAX][BN];      // B tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4] = {};
  float xacc[XA_PER_THREAD] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int t = 0; t < BM * BK / THREADS; ++t) {
      const int idx = tid + t * THREADS;
      const int row = idx / BK, col = idx % BK;
      const int gm = m0 + row, gk = k0 + col;
      xs[col][row] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < BK * BN / THREADS; ++t) {
      const int idx = tid + t * THREADS;
      const int row = idx / BN, col = idx % BN;
      const int gk = k0 + row, gn = n0 + col;
      ws[row][col] = (gk < K && gn < N) ? w[(long long)gk * N + gn] : 0.f;
    }
    for (int idx = tid; idx < BK * r; idx += THREADS) {
      const int row = idx / r, c = idx % r;
      const int gk = k0 + row;
      as_[row][c] = gk < K ? a[(long long)gk * r + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
#pragma unroll
    for (int t = 0; t < XA_PER_THREAD; ++t) {
      const int e = tid + t * THREADS;
      if (e < BM * r) {
        const int row = e / r, c = e % r;
        float s = xacc[t];
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) s = fmaf(xs[kk][row], as_[kk][c], s);
        xacc[t] = s;
      }
    }
    __syncthreads();
  }

  // epilogue: apply B to the rank-r partial, scale, add, store
#pragma unroll
  for (int t = 0; t < XA_PER_THREAD; ++t) {
    const int e = tid + t * THREADS;
    if (e < BM * r) xa[e / r][e % r] = xacc[t];
  }
  for (int idx = tid; idx < r * BN; idx += THREADS) {
    const int c = idx / BN, col = idx % BN;
    const int gn = n0 + col;
    bs[c][col] = gn < N ? b[(long long)c * N + gn] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int gm = m0 + row;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const int gn = n0 + col;
      if (gn >= N) continue;
      float delta = 0.f;
      for (int c = 0; c < r; ++c) delta = fmaf(xa[row][c], bs[c][col], delta);
      y[(long long)gm * N + gn] = acc[i][j] + scaling * delta;
    }
  }
}


// ---- bf16 tensor-core path ---------------------------------------------------

namespace wm = nvcuda::wmma;
constexpr int TBK = 32, TTHREADS = 128;
constexpr int XS_LD = TBK + 8, WS_LD = BN + 8, CS_LD = BN + 4;
using bf16 = __nv_bfloat16;

// rows x cols bf16 tile from a row-major (R, C) matrix at (r0, c0), zero
// outside; 16-byte loads where the 8-element chunk lies inside and aligns
// (a contiguous view may start at any element, so the base is checked too)
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int R, int C,
                                          int r0, int c0) {
  constexpr int CHUNKS = ROWS * COLS / 8;
  const bool vec_ok = (C % 8) == 0 && (reinterpret_cast<uintptr_t>(src) % 16) == 0;
  for (int ch = threadIdx.x; ch < CHUNKS; ch += TTHREADS) {
    const int row = ch / (COLS / 8), col = (ch % (COLS / 8)) * 8;
    const int gr = r0 + row, gc = c0 + col;
    bf16* d = dst + row * ld + col;
    if (gr < R && vec_ok && gc + 8 <= C) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (long long)gr * C + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < R && gc + e < C) ? src[(long long)gr * C + gc + e] : __float2bfloat16(0.f);
    }
  }
}

// NF rank fragments: A and B are zero-padded to RP = 16 * NF (NF = 1 for
// r <= 16, the serving path's r = 8; NF = 2 for r <= 32)
template <int NF>
__global__ void __launch_bounds__(TTHREADS) lora_matmul_wmma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ a,
    const bf16* __restrict__ b, bf16* __restrict__ y, int M, int N, int K, int r,
    float scaling) {
  constexpr int RP = 16 * NF, AS_LD = RP + 8, XA_LD = RP + 4;
  __shared__ __align__(32) bf16 xs[BM * XS_LD];
  __shared__ __align__(32) bf16 ws[TBK * WS_LD];
  __shared__ __align__(32) bf16 as_[TBK * AS_LD];
  __shared__ __align__(32) bf16 xab[BM * AS_LD];  // rounded rank-r partial
  __shared__ __align__(32) bf16 bs[RP * WS_LD];
  __shared__ __align__(32) float cs[BM * CS_LD];   // output staging / xa fp32

  const int warp = threadIdx.x / 32;
  const int wm_row = (warp / 2) * 32, wn_col = (warp % 2) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][2], xa[NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);
#pragma unroll
  for (int f = 0; f < NF; ++f) wm::fill_fragment(xa[f], 0.f);

  for (int k0 = 0; k0 < K; k0 += TBK) {
    load_tile<BM, TBK>(xs, XS_LD, x, M, K, m0, k0);
    load_tile<TBK, BN>(ws, WS_LD, w, K, N, k0, n0);
    for (int idx = threadIdx.x; idx < TBK * RP; idx += TTHREADS) {
      const int row = idx / RP, c = idx % RP, gk = k0 + row;
      as_[row * AS_LD + c] = (gk < K && c < r) ? a[(long long)gk * r + c] : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa[2], fx;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb[2], fA;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wm::load_matrix_sync(fa[i], xs + (wm_row + 16 * i) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wm::load_matrix_sync(fb[j], ws + kk * WS_LD + wn_col + 16 * j, WS_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wm::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      // warp w accumulates rows 16w..16w+15 of the block's rank-r partial
      wm::load_matrix_sync(fx, xs + (16 * warp) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wm::load_matrix_sync(fA, as_ + kk * AS_LD + 16 * f, AS_LD);
        wm::mma_sync(xa[f], fx, fA, xa[f]);
      }
    }
    __syncthreads();
  }

  // epilogue: round x@A to bf16, apply B (zero rows past r), scale, add
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wm::store_matrix_sync(cs + (16 * warp) * XA_LD + 16 * f, xa[f], XA_LD, wm::mem_row_major);
  for (int idx = threadIdx.x; idx < RP * BN; idx += TTHREADS) {
    const int c = idx / BN, col = idx % BN, gn = n0 + col;
    bs[c * WS_LD + col] = (c < r && gn < N) ? b[(long long)c * N + gn] : __float2bfloat16(0.f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * RP; idx += TTHREADS) {
    const int row = idx / RP, c = idx % RP;
    xab[row * AS_LD + c] = __float2bfloat16(cs[row * XA_LD + c]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fxa[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      wm::load_matrix_sync(fxa[f], xab + (wm_row + 16 * i) * AS_LD + 16 * f, AS_LD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fB;
      wm::fragment<wm::accumulator, 16, 16, 16, float> delta;
      wm::fill_fragment(delta, 0.f);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wm::load_matrix_sync(fB, bs + (16 * f) * WS_LD + wn_col + 16 * j, WS_LD);
        wm::mma_sync(delta, fxa[f], fB, delta);
      }
#pragma unroll
      for (int t = 0; t < delta.num_elements; ++t)
        acc[i][j].x[t] = acc[i][j].x[t] + scaling * delta.x[t];
    }
  }
  __syncthreads();  // cs is reused as the output staging tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wm::store_matrix_sync(cs + (wm_row + 16 * i) * CS_LD + wn_col + 16 * j, acc[i][j],
                            CS_LD, wm::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += TTHREADS) {
    const int row = idx / BN, col = idx % BN, gm = m0 + row, gn = n0 + col;
    if (gm < M && gn < N) y[(long long)gm * N + gn] = __float2bfloat16(cs[row * CS_LD + col]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 1 <= r <= 32.
extern "C" int lora_matmul_fwd(const void* x, const void* w, const void* a,
                               const void* b, void* y, int M, int N, int K,
                               int r, float scaling, int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || r < 1 || r > R_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == 0) {
    lora_matmul_f32_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(y), M, N, K, r, scaling);
  } else if (dtype == 1) {
    auto kernel = r <= 16 ? lora_matmul_wmma_kernel<1> : lora_matmul_wmma_kernel<2>;
    kernel<<<grid, TTHREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(a),
        static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N, K, r, scaling);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
