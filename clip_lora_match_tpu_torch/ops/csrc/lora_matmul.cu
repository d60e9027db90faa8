// Fused LoRA projection: y = x @ W + s * round_T(x @ A) @ B, one pass over x.
//
// Replaces: clip_lora_match_tpu/ops/lora_matmul.py (lora_matmul: _kernel).
// Contract kept: x (M, K), W (K, N), A (K, r), B (r, N), all of one type T
//   (fp32 or bf16); x, W and B row-major and contiguous, A passed as its
//   transpose A^T (r, K), row-major (the serving copy stores A that way, so
//   the wrapper hands over a view); base and rank-r products accumulate in
//   fp32; after K is exhausted the rank-r partial is rounded to T (the TPU
//   kernel's ab_acc.astype(x.dtype)), multiplied by B in fp32, scaled by s and
//   added; the sum is stored as T. The bias is added by the caller, as in
//   nn/layers.linear. Ragged M, N and K are masked here. 1 <= r <= 64.
//   With `groups` G > 1, column n of the (M, N) product is stored at
//   [n / (N/G)][m][n % (N/G)] of a (G, M, N/G) output: the q, k and v
//   projections of one attention layer run as one launch on [Wq | Wk | Wv],
//   [Aq | Ak | Av] and blockdiag(Bq, Bk, Bv) (the zero blocks add exact
//   zeros) and come out as three contiguous (M, N/G) slabs.
// What bounds it on the H100: at a request (M = 50 to 577 rows, K = 512 to
//   1024, N = 512 to 3072) the bytes of W and the latency of the K loop: at
//   M = 50 to 64 even 64 x 64 output tiles leave most of the 132 SMs idle
//   (the 4-stage ring keeps their loads in flight; splitting K to fill the
//   SMs saved under 0.4 us a call and cost a second launch); at batch
//   shapes (M = 4,800 to 18,464) operations, 2*M*N*K + 2*M*r*(K + N)
//   FLOPs, at the tensor cores' bf16 rate if the tiles are large enough for
//   L2 to feed them.
// Three bodies; the wrapper's plan (ops/lora_matmul.py: plan) picks one.
//   - bf16 main body (lora_matmul_tma_kernel): TMA loads into a ring of 4
//     mbarrier stages, one producer thread, one or two consumer warpgroups
//     (BM = 64 or 128 rows, BN = 64 or 128 columns) issuing wgmma. A
//     64 x 256 accumulator per warpgroup spilled, so tiles stop at 128
//     columns. A stage holds the x K-slice (BM x 64), W's K-slice (64 x BN,
//     the MN-major B operand straight from its row-major tiles) and A^T's
//     K-slice (RP x 64, RP = r rounded up to 16, rows past r zero-filled by
//     TMA). Each x slice feeds both products: wgmma m64n64k16 per 64 output
//     columns for x.W and m64n16k16 per 16 rank columns for x.A. Epilogue:
//     the rank-r accumulator is rounded to bf16 in registers, where its
//     layout is already wgmma's A-fragment layout, and multiplied by B
//     (loaded once by TMA) 64 columns at a time into a separate fp32 delta;
//     the tile is acc + s * delta, stored as bf16.
//   - bf16 second body (lora_matmul_wmma_kernel) for what TMA cannot take (a
//     base off 16 bytes, K or N/G not a multiple of 8): 64 x 64 tiles of
//     WMMA fragments, 4 warps, K in steps of 32, A zero-padded to 16-64
//     columns.
//   - fp32: CUDA-core FMA, 256 threads, 4 x 4 outputs each (no TF32: the
//     contract is fp32 products).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256, R_MAX = 64;
constexpr int XA_PER_THREAD = BM * R_MAX / THREADS;  // 16

// where column n of row m goes: [n / Ns][m][n % Ns] of a (N / Ns, M, Ns) output
__device__ __forceinline__ long long out_at(int m, int n, int M, int Ns) {
  const int g = n / Ns;
  return ((long long)g * M + m) * Ns + (n - g * Ns);
}

// ---- fp32 CUDA-core path ---------------------------------------------------

__global__ void __launch_bounds__(THREADS) lora_matmul_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ at,
    const float* __restrict__ b, float* __restrict__ y, int M, int N, int K, int r, int Ns,
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
      const int c = idx / BK, row = idx % BK;
      const int gk = k0 + row;
      as_[row][c] = gk < K ? at[(long long)c * K + gk] : 0.f;
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
      y[out_at(gm, gn, M, Ns)] = acc[i][j] + scaling * delta;
    }
  }
}


// ---- bf16 second body: WMMA, any shape and alignment ---------------------------

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
// r <= 16, the serving path's r = 8; up to NF = 4 for r <= 64). The rounded
// rank-r partial reuses the x / W / A tiles' shared memory after the K loop.
template <int NF>
__global__ void __launch_bounds__(TTHREADS) lora_matmul_wmma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ at,
    const bf16* __restrict__ b, bf16* __restrict__ y, int M, int N, int K, int r, int Ns,
    float scaling) {
  constexpr int RP = 16 * NF, AS_LD = RP + 8, XA_LD = RP + 4;
  constexpr int XS_ELEMS = BM * XS_LD, WS_ELEMS = TBK * WS_LD, AS_ELEMS = TBK * AS_LD;
  constexpr int LOOP_BYTES = (XS_ELEMS + WS_ELEMS + AS_ELEMS) * 2, XAB_BYTES = BM * AS_LD * 2;
  constexpr int REUSED = LOOP_BYTES > XAB_BYTES ? LOOP_BYTES : XAB_BYTES;
  __shared__ __align__(32) unsigned char smem[REUSED + RP * WS_LD * 2 + BM * CS_LD * 4];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + XS_ELEMS;
  bf16* as_ = ws + WS_ELEMS;
  bf16* xab = reinterpret_cast<bf16*>(smem);  // rounded rank-r partial, after the K loop
  bf16* bs = reinterpret_cast<bf16*>(smem + REUSED);
  float* cs = reinterpret_cast<float*>(smem + REUSED + RP * WS_LD * 2);  // staging / xa fp32

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
      const int c = idx / TBK, row = idx % TBK, gk = k0 + row;
      as_[row * AS_LD + c] = (gk < K && c < r) ? at[(long long)c * K + gk] : __float2bfloat16(0.f);
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
    if (gm < M && gn < N) y[out_at(gm, gn, M, Ns)] = __float2bfloat16(cs[row * CS_LD + col]);
  }
}

// ---- bf16 main body: wgmma + TMA --------------------------------------------

namespace tc {

using namespace hopper;

constexpr int KT = 64;           // K per stage: one 128-byte swizzle row of bf16
constexpr int SMEM_MAX = 232448;  // what a block may use on the H100

// d (64 x 64, fp32) += A (64 x 16) * B (16 x 64), bf16 in shared memory; A K-major, B MN-major
__device__ __forceinline__ void wgmma_m64n64_tB(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 16, fp32) += A (64 x 16) * B (16 x 16), bf16 in shared memory; both K-major
__device__ __forceinline__ void wgmma_m64n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 64, bf16 in
// shared memory, MN-major)
__device__ __forceinline__ void wgmma_m64n64_rA_tB(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BM_, int BN_, int RP_>
struct Cfg {
  static constexpr int WG = BM_ / 64;               // consumer warpgroups, 64 rows each
  // + one producer warp; with two consumer warpgroups a producer warpgroup
  // that gives its registers to them (setmaxnreg), since 9 warps would cap
  // every thread at 168 registers
  static constexpr int THREADS = WG == 1 ? 160 : 128 * (WG + 1);
  static constexpr int X_BYTES = BM_ * KT * 2;      // x slice: BM rows of 128 bytes
  static constexpr int W_BYTES = KT * BN_ * 2;      // W slice: BN / 64 boxes of 64 x 64
  static constexpr int A_BYTES = RP_ * KT * 2;      // A^T slice: RP rows of 128 bytes
  static constexpr int STAGE = X_BYTES + W_BYTES + A_BYTES;
  static constexpr int B_BYTES = RP_ * BN_ * 2;     // B tile: BN / 64 boxes of RP x 64
  static constexpr int FIT = (SMEM_MAX - 1024 - B_BYTES - 128) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE + B_BYTES + 128;
  static_assert(STAGES >= 2, "at least two stages in flight");
};

// grid (column tiles, row tiles): one output tile per block
template <int BM_, int BN_, int RP_>
__global__ void __launch_bounds__(Cfg<BM_, BN_, RP_>::THREADS, 1) lora_matmul_tma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_at, const __grid_constant__ CUtensorMap tm_b,
    bf16* __restrict__ y, int M, int N, int K, int Ns, float scaling) {
  using C = Cfg<BM_, BN_, RP_>;
  constexpr int NJ = BN_ / 64, NF = RP_ / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles want 1024-byte alignment
  const uint32_t b_tile = base + C::STAGES * C::STAGE;
  const uint32_t bars = b_tile + C::B_BYTES;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (C::STAGES + i); };
  const uint32_t b_full = bars + 16 * C::STAGES;

  const int m0 = blockIdx.y * BM_, n0 = blockIdx.x * BN_;
  const int nk = (K + KT - 1) / KT;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), C::WG);  // one release from each consumer warpgroup
    }
    mbar_init(b_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * C::WG) {
    // ---- producer: B once (the epilogue's), then the x / W / A^T ring --------
    if constexpr (C::WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * C::WG) {
      mbar_expect_tx(b_full, C::B_BYTES);
      for (int j = 0; j < NJ; ++j) tma_load(b_tile + j * RP_ * 128, &tm_b, n0 + 64 * j, 0, b_full);
      int i = 0, ph = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait<false>(empty(i), ph ^ 1);
        mbar_expect_tx(full(i), C::STAGE);
        const uint32_t st = base + i * C::STAGE;
        tma_load(st, &tm_x, kt * KT, m0, full(i));
        for (int j = 0; j < NJ; ++j)
          tma_load(st + C::X_BYTES + j * 8192, &tm_w, n0 + 64 * j, kt * KT, full(i));
        tma_load(st + C::X_BYTES + C::W_BYTES, &tm_at, kt * KT, 0, full(i));
        if (++i == C::STAGES) { i = 0; ph ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile -----
  if constexpr (C::WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  float acc[NJ][32];
  float xacc[NF][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 8; ++e) xacc[f][e] = 0.f;

  int i = 0, ph = 0, prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait<false>(full(i), ph);
    const uint32_t st = base + i * C::STAGE;
    const uint32_t xs = st + wg * 8192, ws = st + C::X_BYTES, as = st + C::X_BYTES + C::W_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint64_t da = desc(xs + kk * 32, 16, 1024);
#pragma unroll
      for (int j = 0; j < NJ; ++j) wgmma_m64n64_tB(acc[j], da, desc(ws + j * 8192 + kk * 2048, 8192, 1024));
#pragma unroll
      for (int f = 0; f < NF; ++f) wgmma_m64n16(xacc[f], da, desc(as + f * 2048 + kk * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0 && tid == 0) mbar_arrive(empty(prev));
    prev = i;
    if (++i == C::STAGES) { i = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  if (prev >= 0 && tid == 0) mbar_arrive(empty(prev));

  // acc[j][4 jj + e]: row 16 w + g (+8 for e >= 2), column 64 j + 8 jj + 2 t4 (+1 for odd e);
  // xacc[f][4 jj + e] the same with rank column 16 f + 8 jj + 2 t4
  const int row0 = m0 + 64 * wg + 16 * w + g;

  // round x@A to bf16 (the contract's rounding point). The m64n16
  // accumulator of 16 rank columns is, element for element, the A fragment
  // of one k16 step: {(g, 2t4), (g+8, 2t4), (g, 2t4+8), (g+8, 2t4+8)} pairs.
  uint32_t xf[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __nv_bfloat162 v = __floats2bfloat162_rn(xacc[f][2 * q], xacc[f][2 * q + 1]);
      xf[f][q] = *reinterpret_cast<uint32_t*>(&v);
    }
  mbar_wait<false>(b_full, 0);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float d[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) d[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < NF; ++f)
      wgmma_m64n64_rA_tB(d, xf[f], desc(b_tile + j * RP_ * 128 + f * 2048, RP_ * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = acc[j][e] + scaling * d[e];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = row0 + 8 * hf, n = n0 + 64 * j + 8 * jj + 2 * t4;
        if (m < M && n < N)  // Ns is even here: n and n + 1 land in one group
          *reinterpret_cast<__nv_bfloat162*>(y + out_at(m, n, M, Ns)) =
              __floats2bfloat162_rn(acc[j][4 * jj + 2 * hf], acc[j][4 * jj + 2 * hf + 1]);
      }
}

template <int BM_, int BN_, int RP_>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* at, const bf16* b, bf16* y,
                   int M, int N, int K, int r, int Ns, float scaling, cudaStream_t st) {
  using C = Cfg<BM_, BN_, RP_>;
  if ((long long)M > 65535LL * BM_) return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w, tm_at, tm_b;
  if (!tensor_map(&tm_x, x, K, M, KT, BM_) || !tensor_map(&tm_w, w, N, K, 64, KT) ||
      !tensor_map(&tm_at, at, K, r, KT, RP_) || !tensor_map(&tm_b, b, N, r, 64, RP_))
    return cudaErrorInvalidValue;
  auto kern = lora_matmul_tma_kernel<BM_, BN_, RP_>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((N + BN_ - 1) / BN_, (M + BM_ - 1) / BM_);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(tm_x, tm_w, tm_at, tm_b, y, M, N, K, Ns, scaling);
  return cudaGetLastError();
}

template <int BM_, int BN_>
cudaError_t launch_rp(const bf16* x, const bf16* w, const bf16* at, const bf16* b, bf16* y,
                      int M, int N, int K, int r, int Ns, float scaling, cudaStream_t st) {
  switch ((r + 15) / 16) {
    case 1: return launch<BM_, BN_, 16>(x, w, at, b, y, M, N, K, r, Ns, scaling, st);
    case 2: return launch<BM_, BN_, 32>(x, w, at, b, y, M, N, K, r, Ns, scaling, st);
    case 3: return launch<BM_, BN_, 48>(x, w, at, b, y, M, N, K, r, Ns, scaling, st);
    case 4: return launch<BM_, BN_, 64>(x, w, at, b, y, M, N, K, r, Ns, scaling, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// body: 0 = fp32, 1 = bf16 WMMA (any shape), 2 = bf16 wgmma + TMA (K and N / groups
// multiples of 8, x / W / A^T / B 16-byte aligned). at is A^T (r, K),
// row-major; 1 <= r <= 64; y is (groups, M, N / groups). wgmma: bm x bn tiles
// (128 x 128, 64 x 128 or 64 x 64); the other bodies: 64 x 64.
extern "C" int lora_matmul_fwd(const void* x, const void* w, const void* at, const void* b,
                               void* y, int M, int N, int K, int r, int groups, float scaling,
                               int body, int bm, int bn, void* stream) {
  if (M < 1 || N < 1 || K < 1 || r < 1 || r > R_MAX || groups < 1 || N % groups != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Ns = N / groups;
  if (body == 2) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(at) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
    if (!aligned || K % 8 != 0 || Ns % 8 != 0) return (int)cudaErrorInvalidValue;
    const bf16 *xb = static_cast<const bf16*>(x), *wb = static_cast<const bf16*>(w),
               *ab = static_cast<const bf16*>(at), *bb = static_cast<const bf16*>(b);
    bf16* yb = static_cast<bf16*>(y);
    if (bm == 128 && bn == 128) return (int)tc::launch_rp<128, 128>(xb, wb, ab, bb, yb, M, N, K, r, Ns, scaling, st);
    if (bm == 64 && bn == 128) return (int)tc::launch_rp<64, 128>(xb, wb, ab, bb, yb, M, N, K, r, Ns, scaling, st);
    if (bm == 64 && bn == 64) return (int)tc::launch_rp<64, 64>(xb, wb, ab, bb, yb, M, N, K, r, Ns, scaling, st);
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (body == 0) {
    lora_matmul_f32_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(at),
        static_cast<const float*>(b), static_cast<float*>(y), M, N, K, r, Ns, scaling);
  } else if (body == 1) {
    auto kernel = r <= 16 ? lora_matmul_wmma_kernel<1>
                : r <= 32 ? lora_matmul_wmma_kernel<2>
                : r <= 48 ? lora_matmul_wmma_kernel<3> : lora_matmul_wmma_kernel<4>;
    kernel<<<grid, TTHREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(at),
        static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N, K, r, Ns, scaling);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
