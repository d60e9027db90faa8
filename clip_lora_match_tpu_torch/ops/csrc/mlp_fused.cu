// Fused transformer MLP: y = quick_gelu(x @ W1 + b1) @ W2 + b2, the (M, H)
// hidden kept on chip.
//
// Replaces: clip_lora_match_tpu/ops/mlp_fused.py (mlp_fused: _kernel_resident,
//   _kernel_streamed).
// Contract kept: x (M, K), W1 (K, H), W2 (H, N) of one type T (fp32 or bf16),
//   row-major and contiguous; b1 (H) and b2 (N) in fp32. Both products
//   accumulate in fp32; bias and quick-gelu h * sigmoid(1.702 h) are computed
//   in fp32 and the hidden is rounded to T before fc2 (the TPU kernels'
//   .astype(x_ref.dtype)); b2 is added in fp32 and the sum stored as T. Ragged
//   M, N, K and H are masked here.
// What bounds it on the H100: operations at every CLIP shape on paper,
//   2*M*H*(K + N) FLOPs against (M*K + K*H + H*N + M*N) elements (one L/14
//   layer at M = 577: 9.7 GFLOP over 18 MB, ~540 FLOPs per byte, past the bf16
//   ridge of ~295). In practice the L2 traffic: a 64-row tile must see all of
//   W1 and W2 (16 MB at K = N = 1024), so every weight byte read from L2 feeds
//   64 rows (64 FLOPs per byte); at the tensor cores' rate an SM would need
//   ~64 bytes a cycle from L2, which the L2 cannot give 132 SMs. The kernel is
//   designed against L2 bytes per FLOP and the latency of its rings.
// Three bodies; the wrapper's plan (ops/mlp_fused.py: plan) picks one.
//   - bf16 main body (mlp_fused_tma_kernel), taken by every CLIP shape
//     (K a multiple of 64 up to 1024, N = 256 C for C = 2..4, H a multiple of
//     8, 16-byte aligned x, W1, W2): warpgroup wgmma for both products, TMA
//     loads into mbarrier rings, warp-specialised. A cluster of C CTAs shares
//     one 64-row tile of x; CTA r owns output columns [256 r, 256 r + 256).
//     * x is read once per CTA: its 64 x K tile (128 KB at K = 1024) stays in
//       shared memory, 128-byte swizzled, for the whole hidden sweep.
//     * fc1 is computed once per row tile, not once per column tile: per step
//       of 64 C hidden units, CTA r computes units 64 r .. 64 r + 63 as
//       hidden^T = W1^T x^T (wgmma m64n64k16, W1 as the MN-major A operand
//       straight from its row-major tiles, x the K-major B), adds b1 (loaded
//       before the products) and applies quick-gelu in fp32 in registers,
//       rounds to bf16, writes the 64 x 64 atom into its own shared memory and
//       sends it to the other C - 1 CTAs with one bulk shared-to-shared copy
//       each (DSMEM), which completes on the peer's mbarrier for that atom
//       (4-byte remote stores from every thread were slower when tried).
//     * fc2: each CTA accumulates its 64 x 256 fp32 output tile in registers
//       (wgmma m64n256k16, the hidden atoms as the MN-major A operand, W2's
//       row-major tiles as the MN-major B), and releases each atom as soon as
//       its own products are done, so one CTA's release never waits for a
//       peer's next atom.
//     * roles: warps 0-3 run fc1, warps 4-7 fc2; one thread of warp 8 keeps
//       TMA loads of x (once) and W1's 64 x 64 tiles in flight through a
//       4-deep ring of 8 KB stages, one of warp 9 W2's 32 x 256 tiles through
//       a 2-deep ring of 16 KB stages (16-row stages 4 deep, the same bytes,
//       were slower: fewer, larger stages cost fewer barrier round trips).
//       fc1 of step s + 1 overlaps fc2 of step s on the tensor cores.
//     * what is left: x fills 128 of the 227 KB, so the two rings hold 32 KB
//       each, and each streams only what fits in flight over L2's loaded
//       latency; the single-buffered hidden still makes fc1 wait for every
//       CTA to release its atom. Each cluster reads W1 and W2 once per 64-row
//       tile: ~4.8 GB from L2 at M = 18,464 against the previous version's
//       11.8 GB. Multicasting the weights to a pair of row tiles (clusters
//       of 2 C) halves those bytes, but a stage then waits for both tiles'
//       releases, one of them remote, and it ran slower when tried.
//   - bf16 second body (mlp_fused_wmma_kernel), for shapes and views TMA
//     cannot take (a row stride off 16 bytes, a misaligned base, K or N
//     outside the main body's set): the previous design, a 64 x 512 output
//     tile per block, fc1 chunks of 64 by WMMA fragments through cp.async
//     double buffers (fc1 recomputed per 512-column tile).
//   - fp32: CUDA-core FMA, 32 x 128 output tiles and 32-wide hidden chunks,
//     no split (no TF32: the contract is fp32 products).
//   When the row and column tiles are fewer than the SMs (one L/14-336 image:
//   10 row tiles x 4 CTAs), both bf16 bodies also split the hidden across
//   blocks (grid z): each split stores its fp32 partial sum and a second
//   small kernel adds the splits in order, adds b2 and rounds. Deterministic,
//   no atomics, and still no hidden in device memory.
// The TMA, mbarrier and wgmma helpers and the tensor maps are in hopper.cuh.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float quick_gelu(float v) {
  return v / (1.f + expf(-1.702f * v));
}
// the same with the hardware exp2 and reciprocal (a few ulp in fp32, far
// below the bf16 rounding that follows); for v < -51 the quotient flushes to
// 0, the limit of v sigmoid(1.702 v)
__device__ __forceinline__ float quick_gelu_fast(float v) {
  return __fdividef(v, 1.f + __expf(-1.702f * v));
}

// ---- bf16 second body: WMMA, any shape and alignment ---------------------------

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = 512, BH = 64, BK = 128, THREADS = 512, WARPS = THREADS / 32;
constexpr int XS_LD = BK + 8, W1_LD = BH + 8, HF_LD = BH + 4, HS_LD = BH + 8, W2_LD = BN + 8;
constexpr int XS_ELEMS = BM * XS_LD, W1_ELEMS = BK * W1_LD;
// bytes: 2 x-stages, 2 W1 stages, the fp32 fc1 tile, the bf16 hidden, the W2 chunk
constexpr int SMEM_BYTES = 2 * (XS_ELEMS + W1_ELEMS) * 2 + BM * HF_LD * 4 + BM * HS_LD * 2 +
                           BH * W2_LD * 2;
static_assert(BM * HF_LD >= WARPS * 256, "the epilogue stages one fragment per warp in hf");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ROWS x COLS tile of a row-major (R, C) matrix at (r0, c0) into shared memory
// (row stride ld), zero outside. 8-element chunks that lie inside and align go
// by cp.async; the others by plain loads.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int R, int C,
                                          int r0, int c0, bool vec_ok) {
  constexpr int CHUNKS = ROWS * COLS / 8;
  for (int ch = threadIdx.x; ch < CHUNKS; ch += THREADS) {
    const int row = ch / (COLS / 8), col = (ch % (COLS / 8)) * 8;
    const int gr = r0 + row, gc = c0 + col;
    bf16* d = dst + row * ld + col;
    if (gr < R && vec_ok && gc + 8 <= C) {
      cp_async16(d, src + (long long)gr * C + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < R && gc + e < C) ? src[(long long)gr * C + gc + e] : __float2bfloat16(0.f);
    }
  }
}

// grid (column tiles, row tiles, hidden splits). Split z covers hidden chunks
// [z * cps, (z + 1) * cps). With one split the block adds b2 and stores y;
// with more it stores its fp32 partial sum in part[z] and finalize_kernel
// adds the splits in order.
__global__ void __launch_bounds__(THREADS, 1) mlp_fused_wmma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ y,
    float* __restrict__ part, int M, int K, int H, int N, int cps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);     // [2][BM][XS_LD]
  bf16* w1s = xs + 2 * XS_ELEMS;                    // [2][BK][W1_LD]
  float* hf = reinterpret_cast<float*>(w1s + 2 * W1_ELEMS);  // [BM][HF_LD]
  bf16* hs = reinterpret_cast<bf16*>(hf + BM * HF_LD);        // [BM][HS_LD]
  bf16* w2s = hs + BM * HS_LD;                                 // [BH][W2_LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int h_begin = blockIdx.z * cps * BH, h_end = min(H, h_begin + cps * BH);
  // fc1 tile 64 x 64 = 4 x 4 fragments, one per warp
  const int f1_row = (warp / 4) * 16, f1_col = (warp % 4) * 16;
  // output tile 64 x 512 = 4 x 32 fragments: warp -> rows 32 * (warp / 8)
  // (2 fragments), columns 64 * (warp % 8) (4 fragments)
  const int f2_row = (warp / 8) * 32, f2_col = (warp % 8) * 64;

  const bool x_vec = (K % 8) == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  const bool w1_vec = (H % 8) == 0 && (reinterpret_cast<uintptr_t>(w1) % 16) == 0;
  const bool w2_vec = (N % 8) == 0 && (reinterpret_cast<uintptr_t>(w2) % 16) == 0;
  const int nk = (K + BK - 1) / BK;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wm::fill_fragment(acc[i][j], 0.f);

  for (int h0 = h_begin; h0 < h_end; h0 += BH) {
    // this chunk's W2 rows, and the first K stage of fc1
    load_tile<BH, BN>(w2s, W2_LD, w2, H, N, h0, n0, w2_vec);
    load_tile<BM, BK>(xs, XS_LD, x, M, K, m0, 0, x_vec);
    load_tile<BK, BH>(w1s, W1_LD, w1, K, H, 0, h0, w1_vec);
    cp_async_commit();

    wm::fragment<wm::accumulator, 16, 16, 16, float> h_acc;
    wm::fill_fragment(h_acc, 0.f);
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < nk) {
        const int nxt = cur ^ 1;
        load_tile<BM, BK>(xs + nxt * XS_ELEMS, XS_LD, x, M, K, m0, (kt + 1) * BK, x_vec);
        load_tile<BK, BH>(w1s + nxt * W1_ELEMS, W1_LD, w1, K, H, (kt + 1) * BK, h0, w1_vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* xc = xs + cur * XS_ELEMS;
      const bf16* wc = w1s + cur * W1_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
        wm::load_matrix_sync(fa, xc + f1_row * XS_LD + kk, XS_LD);
        wm::load_matrix_sync(fb, wc + kk * W1_LD + f1_col, W1_LD);
        wm::mma_sync(h_acc, fa, fb, h_acc);
      }
      __syncthreads();  // the stage read here is the next iteration's target
    }

    // bias + quick-gelu in fp32, rounded to bf16; columns past H are zero
    wm::store_matrix_sync(hf + f1_row * HF_LD + f1_col, h_acc, HF_LD, wm::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BH; idx += THREADS) {
      const int r = idx / BH, c = idx % BH, gh = h0 + c;
      const float g = gh < H ? quick_gelu(hf[r * HF_LD + c] + b1[gh]) : 0.f;
      hs[r * HS_LD + c] = __float2bfloat16(g);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BH; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wm::load_matrix_sync(fa[i], hs + (f2_row + 16 * i) * HS_LD + kk, HS_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
        wm::load_matrix_sync(fb, w2s + kk * W2_LD + f2_col + 16 * j, W2_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wm::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();  // hs and w2s are refilled by the next chunk
  }

  // epilogue: each warp stages one fragment at a time in its own 16 x 16
  // slice of hf, then stores y (+ b2, bf16) or its fp32 partial sum
  float* stage = hf + warp * 256;
  float* my_part = gridDim.z > 1 ? part + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wm::store_matrix_sync(stage, acc[i][j], 16, wm::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        const int gm = m0 + f2_row + 16 * i + r, gn = n0 + f2_col + 16 * j + c;
        if (gm < M && gn < N) {
          if (my_part)
            my_part[(long long)gm * N + gn] = stage[e];
          else
            y[(long long)gm * N + gn] = __float2bfloat16(stage[e] + b2[gn]);
        }
      }
      __syncwarp();
    }
  }
}

// y = bf16(sum over splits of part[s] + b2), the splits added in order
__global__ void mlp_fused_finalize_kernel(const float* __restrict__ part,
                                          const float* __restrict__ b2, bf16* __restrict__ y,
                                          int M, int N, int splits) {
  const long long total = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * total + i];
    y[i] = __float2bfloat16(s + b2[i % N]);
  }
}

// ---- fp32 CUDA-core path -----------------------------------------------------

constexpr int FBM = 32, FBN = 128, FBH = 32, FBK = 32, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS) mlp_fused_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ y, int M,
    int K, int H, int N) {
  __shared__ float xs[FBK][FBM + 1];   // x tile, transposed
  __shared__ float w1s[FBK][FBH];
  __shared__ float hs[FBM][FBH + 1];   // the hidden chunk (fp32: rounding is exact)
  __shared__ float w2s[FBH][FBN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  // fc1: thread -> row tid / 8, hidden columns 4 * (tid % 8) + {0..3}
  const int h_row = tid / 8, h_col = (tid % 8) * 4;
  // fc2: thread -> rows {ty, ty + 16}, columns tx + 16 * j
  const int ty = tid / 16, tx = tid % 16;
  float acc[2][8] = {};

  for (int h0 = 0; h0 < H; h0 += FBH) {
    float hv[4] = {};
    for (int k0 = 0; k0 < K; k0 += FBK) {
      for (int idx = tid; idx < FBM * FBK; idx += FTHREADS) {
        const int r = idx / FBK, c = idx % FBK, gm = m0 + r, gk = k0 + c;
        xs[c][r] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
      }
      for (int idx = tid; idx < FBK * FBH; idx += FTHREADS) {
        const int r = idx / FBH, c = idx % FBH, gk = k0 + r, gh = h0 + c;
        w1s[r][c] = (gk < K && gh < H) ? w1[(long long)gk * H + gh] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < FBK; ++kk) {
        const float xv = xs[kk][h_row];
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = fmaf(xv, w1s[kk][h_col + e], hv[e]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gh = h0 + h_col + e;
      hs[h_row][h_col + e] = gh < H ? quick_gelu(hv[e] + b1[gh]) : 0.f;
    }
    for (int idx = tid; idx < FBH * FBN; idx += FTHREADS) {
      const int r = idx / FBN, c = idx % FBN, gh = h0 + r, gn = n0 + c;
      w2s[r][c] = (gh < H && gn < N) ? w2[(long long)gh * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < FBH; ++c) {
      const float a0 = hs[ty][c], a1 = hs[ty + 16][c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = w2s[c][tx + 16 * j];
        acc[0][j] = fmaf(a0, bv, acc[0][j]);
        acc[1][j] = fmaf(a1, bv, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) y[(long long)gm * N + gn] = acc[i][j] + b2[gn];
    }
  }
}

// ---- bf16 main body: wgmma + TMA, x resident, fc1 shared across a cluster ----

namespace wg {

constexpr int TM = 64;       // rows of x per CTA (the wgmma M of fc2, the N of fc1)
constexpr int TN = 256;      // output columns per CTA (fc2's wgmma N)
constexpr int TS = 64;       // hidden units of each step that one CTA computes (fc1's wgmma M)
constexpr int KT = 64;       // K rows per W1 stage
constexpr int HT = 32;       // hidden rows per W2 stage (two k16 steps of fc2)
constexpr int D1 = 4, D2 = 2;              // W1 and W2 ring depths
constexpr int ATOM = 64 * 128;             // 64 rows of 128 bytes (one 128-byte swizzle span)
constexpr int W1_STAGE = TS * KT * 2;      // 8 KB
constexpr int W2_STAGE = HT * TN * 2;      // 16 KB: four 64-column boxes of 4 KB
constexpr int MAX_C = 4, MAX_K = 1024;
constexpr int THREADS = 320;               // warps 0-3 fc1, 4-7 fc2, 8 and 9 producers
constexpr int N_BARS = 2 + 2 * D1 + 2 * D2 + MAX_C;

__host__ __device__ constexpr int smem_bytes(int K, int C) {
  return 1024 + K * 128 + C * ATOM + D1 * W1_STAGE + D2 * W2_STAGE + 8 * N_BARS;
}

using namespace hopper;

// d (64 x 64, fp32) += A (64 x 16) * B (16 x 64), bf16 operands in shared memory;
// A MN-major, B K-major
__device__ __forceinline__ void wgmma_m64n64_tA(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16) * B (16 x 256), bf16 operands in shared memory;
// A MN-major, B MN-major
__device__ __forceinline__ void wgmma_m64n256_tA_tB(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// grid (C, row tiles, hidden splits), cluster (C, 1, 1). CTA `cx` of a
// cluster owns output columns [256 cx, 256 cx + 256) of one 64-row tile.
// Step s of split z covers hidden units [c BH, (c + 1) BH), c = z cps + s,
// BH = 64 C: CTA cx computes units c BH + 64 cx .. + 63 of fc1 (as hidden^T,
// 64 units x 64 rows), writes them, bias + quick-gelu + bf16, to atom cx of its
// own hidden buffer and bulk-copies the atom to the other C - 1 CTAs; every
// CTA then runs fc2 over all C atoms. With one split the CTA adds b2 and
// stores y; with more it stores its fp32 partial sum in part[z] and
// finalize_kernel adds the splits in order.
__global__ void __launch_bounds__(THREADS, 1) mlp_fused_tma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w1,
    const __grid_constant__ CUtensorMap tm_w2, const float* __restrict__ b1,
    const float* __restrict__ b2, bf16* __restrict__ y, float* __restrict__ part, int M, int K,
    int H, int N, int cps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t xs = (raw + 1023) & ~1023u;  // swizzled tiles want 1024-byte alignment
  const int C = gridDim.x;
  const uint32_t hid = xs + K * 128;      // C atoms: hidden^T[unit][row], bf16
  const uint32_t w1s = hid + C * ATOM;    // D1 stages: W1[k][unit], 64 k x 64 units
  const uint32_t w2s = w1s + D1 * W1_STAGE;  // D2 stages: W2[unit][n], HT units x 256 n
  const uint32_t bars = w2s + D2 * W2_STAGE;
  const uint32_t x_full = bars, hid_empty = bars + 8;
  auto w1_full = [&](int i) { return bars + 16 + 8 * i; };
  auto w1_empty = [&](int i) { return bars + 16 + 8 * (D1 + i); };
  auto w2_full = [&](int i) { return bars + 16 + 8 * (2 * D1 + i); };
  auto w2_empty = [&](int i) { return bars + 16 + 8 * (2 * D1 + D2 + i); };
  auto hid_full = [&](int a) { return bars + 16 + 8 * (2 * D1 + 2 * D2 + a); };

  const int cx = (int)cluster_rank();
  const int m0 = blockIdx.y * TM, n0 = cx * TN;
  const int BH = TS * C;
  const int n_chunks = (H + BH - 1) / BH;
  const int c_begin = blockIdx.z * cps;
  const int n_steps = min(n_chunks, c_begin + cps) - c_begin;
  const int nk = K / KT;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    mbar_init(hid_empty, C);  // one release from each CTA's fc2 warpgroup
    for (int i = 0; i < D1; ++i) {
      mbar_init(w1_full(i), 1);
      mbar_init(w1_empty(i), 1);
    }
    for (int i = 0; i < D2; ++i) {
      mbar_init(w2_full(i), 1);
      mbar_init(w2_empty(i), 1);
    }
    // atom cx: one arrival from this CTA's fc1; the others: one from this
    // CTA's fc2 with the bytes of the peer's bulk copy
    for (int a = 0; a < C; ++a) mbar_init(hid_full(a), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every barrier of the cluster is initialised before any remote use

  if (warp == 8) {
    // ---- producer of x (once) and the W1 ring ----------------------------------
    if (threadIdx.x == 256) {
      mbar_expect_tx(x_full, K * 128);
      for (int kb = 0; kb < nk; ++kb) tma_load(xs + kb * ATOM, &tm_x, kb * KT, m0, x_full);
      int i1 = 0, p1 = 0;
      for (int s = 0; s < n_steps; ++s) {
        const int u0 = (c_begin + s) * BH + TS * cx;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait<false>(w1_empty(i1), p1 ^ 1);
          mbar_expect_tx(w1_full(i1), W1_STAGE);
          tma_load(w1s + i1 * W1_STAGE, &tm_w1, u0, kt * KT, w1_full(i1));
          if (++i1 == D1) { i1 = 0; p1 ^= 1; }
        }
      }
    }
  } else if (warp == 9) {
    // ---- producer of the W2 ring (its own thread: the two rings never wait on
    // each other, so fc1 of step s + 1 runs while fc2 of step s waits) --------
    if (threadIdx.x == 288) {
      int i2 = 0, p2 = 0;
      for (int s = 0; s < n_steps; ++s) {
        const int h0 = (c_begin + s) * BH;
        for (int a = 0; a < C; ++a)
          for (int q = 0; q < TS / HT; ++q) {
            mbar_wait<false>(w2_empty(i2), p2 ^ 1);
            mbar_expect_tx(w2_full(i2), W2_STAGE);
            for (int nb = 0; nb < TN / 64; ++nb)
              tma_load(w2s + i2 * W2_STAGE + nb * (HT * 128), &tm_w2, n0 + 64 * nb,
                       h0 + TS * a + HT * q, w2_full(i2));
            if (++i2 == D2) { i2 = 0; p2 ^= 1; }
          }
      }
    }
  } else if (warp < 4) {
    // ---- fc1: hidden^T = W1^T x^T, 64 units x 64 rows a step ----------------
    const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    mbar_wait<false>(x_full, 0);
    int i1 = 0, p1 = 0;
    for (int s = 0; s < n_steps; ++s) {
      const int u0 = (c_begin + s) * BH + TS * cx;
      // this thread's two bias values, loaded before the products so their
      // latency hides behind them; acc[4j + e] is unit 16 w + g (+8 for
      // e >= 2), row 8 j + 2 t4 (+1 for odd e)
      const int u_lo = 16 * warp + g;
      const float bl = u0 + u_lo < H ? b1[u0 + u_lo] : 0.f;
      const float bh = u0 + u_lo + 8 < H ? b1[u0 + u_lo + 8] : 0.f;
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait<false>(w1_full(i1), p1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          wgmma_m64n64_tA(acc, desc(w1s + i1 * W1_STAGE + kk * 2048, ATOM, 1024),
                          desc(xs + kt * ATOM + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0 && tid == 0) mbar_arrive(w1_empty(prev));
        prev = i1;
        if (++i1 == D1) { i1 = 0; p1 ^= 1; }
      }
      wgmma_wait<0>();
      if (prev >= 0 && tid == 0) mbar_arrive(w1_empty(prev));

      // bias + quick-gelu in fp32, rounded to bf16: the contract's rounding point
      uint32_t vals[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(quick_gelu_fast(acc[4 * j] + bl),
                                                  quick_gelu_fast(acc[4 * j + 1] + bl));
        __nv_bfloat162 hi = __floats2bfloat162_rn(quick_gelu_fast(acc[4 * j + 2] + bh),
                                                  quick_gelu_fast(acc[4 * j + 3] + bh));
        vals[2 * j] = *reinterpret_cast<uint32_t*>(&lo);
        vals[2 * j + 1] = *reinterpret_cast<uint32_t*>(&hi);
      }
      // every CTA has released this atom of the previous step
      // (the peers' releases also mean the previous bulk copies have landed)
      mbar_wait<true>(hid_empty, (s & 1) ^ 1);
      const uint32_t atom = hid + cx * ATOM;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // 128-byte swizzle: 16-byte chunk j of unit row u sits at chunk j ^ (u % 8)
        const uint32_t off = atom + u_lo * 128 + ((j ^ (u_lo & 7)) << 4) + 4 * t4;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(off), "r"(vals[2 * j]) : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(off + 1024), "r"(vals[2 * j + 1]) : "memory");
      }
      // visible to the async proxy: this CTA's wgmma and the bulk copies
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (tid == 0) {
        mbar_arrive(hid_full(cx));
        for (int r = 0; r < C; ++r)
          if (r != cx)
            bulk_copy_to_peer(mapa(atom, r), atom, ATOM, mapa(hid_full(cx), r));
      }
    }
  } else {
    // ---- fc2: y[64 rows, 256 columns] += hidden . W2, over every atom --------
    const int tid = threadIdx.x - 128, w = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    float acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.f;
    int i2 = 0, p2 = 0;
    for (int s = 0; s < n_steps; ++s) {
      for (int a = 0; a < C; ++a) {
        // a peer's atom: this arrival carries the bytes its bulk copy brings
        if (a != cx && tid == 0) mbar_expect_tx(hid_full(a), ATOM);
        mbar_wait<true>(hid_full(a), s & 1);
        int prev = -1;
#pragma unroll 1
        for (int q = 0; q < TS / HT; ++q) {
          mbar_wait<false>(w2_full(i2), p2);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HT / 16; ++kk)
            wgmma_m64n256_tA_tB(acc, desc(hid + a * ATOM + (q * (HT / 16) + kk) * 2048, ATOM, 1024),
                                desc(w2s + i2 * W2_STAGE + kk * 2048, HT * 128, 1024));
          wgmma_commit();
          wgmma_wait<1>();  // the previous product is done: release its stage
          if (prev >= 0 && tid == 0) mbar_arrive(w2_empty(prev));
          prev = i2;
          if (++i2 == D2) { i2 = 0; p2 ^= 1; }
        }
        // release the atom as soon as its own products are done: waiting for
        // the next atom's first product would tie this release to a peer's
        // progress and chain the CTAs' steps together
        wgmma_wait<0>();
        if (tid == 0) {
          mbar_arrive(w2_empty(prev));
          mbar_arrive_remote(hid_empty, a);
        }
      }
    }
    // acc[4j + e]: row 16 w + g (+8 for e >= 2), column 8 j + 2 t4 (+1 for odd e)
    const bool split = gridDim.z > 1;
    float* my_part = split ? part + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + 16 * w + g + 8 * hf;
        if (m >= M) continue;
        const float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
        if (split) {
          *reinterpret_cast<float2*>(my_part + (long long)m * N + n) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)m * N + n) =
              __floats2bfloat162_rn(v0 + b2[n], v1 + b2[n + 1]);
        }
      }
    }
  }
  // no CTA leaves while a peer may still write its shared memory or arrive on its barriers
  __syncwarp();
  cluster_sync();
}

}  // namespace wg

}  // namespace

// body: 0 = fp32, 1 = bf16 WMMA (any shape), 2 = bf16 wgmma + TMA (the main
// body: K % 64 == 0, K <= 1024, N = 256 C with 2 <= C <= 4, H % 8 == 0,
// x / W1 / W2 16-byte aligned). b1 and b2 are fp32. bf16: the hidden is cut
// into `splits` ranges of whole chunks (64 units for WMMA, 64 C for wgmma),
// one per block along z; with splits > 1, `part` is fp32 scratch of
// splits * M * N elements. fp32 takes splits == 1.
extern "C" int mlp_fused_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, void* part, int M, int K, int H, int N,
                             int splits, int body, void* stream) {
  if (M < 1 || K < 1 || H < 1 || N < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  if (body == 0) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    mlp_fused_f32_kernel<<<grid, FTHREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1f,
        static_cast<const float*>(w2), b2f, static_cast<float*>(y), M, K, H, N);
    return (int)cudaGetLastError();
  }
  if (body != 1 && body != 2) return (int)cudaErrorInvalidValue;
  const int C = N / wg::TN;
  const int chunk = body == 2 ? wg::TS * C : BH;
  const int n_chunks = (H + chunk - 1) / chunk;
  const int cps = (n_chunks + splits - 1) / splits;  // chunks per split
  if ((n_chunks + cps - 1) / cps != splits || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (body == 2) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                           reinterpret_cast<uintptr_t>(w2)) & 15) == 0;
    if (!aligned || K % wg::KT != 0 || K > wg::MAX_K || N % wg::TN != 0 || C < 2 ||
        C > wg::MAX_C || H % 8 != 0)
      return (int)cudaErrorInvalidValue;
    CUtensorMap tm_x, tm_w1, tm_w2;
    if (!hopper::tensor_map(&tm_x, x, K, M, wg::KT, wg::TM) ||
        !hopper::tensor_map(&tm_w1, w1, H, K, wg::TS, wg::KT) ||
        !hopper::tensor_map(&tm_w2, w2, N, H, 64, wg::HT))
      return (int)cudaErrorInvalidValue;
    const int smem = wg::smem_bytes(K, C);
    err = cudaFuncSetAttribute(wg::mlp_fused_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, (M + wg::TM - 1) / wg::TM, splits);
    cfg.blockDim = dim3(wg::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, wg::mlp_fused_tma_kernel, tm_x, tm_w1, tm_w2, b1f, b2f,
                             static_cast<bf16*>(y), static_cast<float*>(part), M, K, H, N, cps);
  } else {
    err = cudaFuncSetAttribute(mlp_fused_wmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
    mlp_fused_wmma_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1f,
        static_cast<const bf16*>(w2), b2f, static_cast<bf16*>(y), static_cast<float*>(part), M,
        K, H, N, cps);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * N;
  const int blocks = (int)min((total + 255) / 256, 4096LL);
  mlp_fused_finalize_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part), b2f,
                                                    static_cast<bf16*>(y), M, N, splits);
  return (int)cudaGetLastError();
}
