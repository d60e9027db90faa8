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
// What bounds it on the H100: operations at every CLIP shape: 2*M*H*(K + N)
//   FLOPs against (M*K + K*H + H*N + M*N) elements (one L/14 layer at M = 577:
//   9.7 GFLOP over 18 MB, ~540 FLOPs per byte, past the bf16 ridge of ~295).
// Design: neither TPU variant maps onto an SM: `resident` holds both weights
//   (<= 10 MB) in VMEM, and `streamed` an fp32 (bm, N) accumulator per row
//   block, which at N = 1024 does not fit one block's registers at a useful
//   bm. Here a block owns a 64-row tile of x and a 512-column tile of y and
//   loops over the hidden in chunks of 64: per chunk it computes the 64 x 64
//   fc1 tile (x and W1 tiles streamed through shared memory with cp.async,
//   double-buffered over K in steps of 128), adds b1 and applies quick-gelu
//   in fp32, rounds to T in shared memory, and accumulates that chunk's fc2
//   product into the block's 64 x 512 fp32 accumulator, which stays in
//   registers (16 warps, 64 floats a thread). The hidden never reaches device
//   memory; the weights stream through L2. The price: each of the
//   ceil(N / 512) column tiles recomputes fc1 for its rows, so fc1 runs twice
//   at N = 1024 and N = 768 and once at N = 512, and the kernel does
//   2*M*H*(ceil(N/512)*K + N) FLOPs. A block holds the SM alone (161 KB of
//   shared memory); when the row and column tiles are fewer than the SMs (one
//   L/14-336 image: 20 tiles), the hidden is also split across blocks, and a
//   second small kernel adds the splits' fp32 partial sums in order, adds b2
//   and rounds: deterministic, and still no hidden in device memory.
//   - bf16: tensor cores through WMMA (16 x 16 x 16 bf16 fragments, fp32
//     accumulators); each warp owns 1 fragment of the fc1 tile and 2 x 4
//     fragments of the output tile. No wgmma/TMA yet: that is later work.
//   - fp32: CUDA-core FMA with the same loop order at 32 x 128 output tiles
//     and 32-wide hidden chunks, no split (no TF32: the contract is fp32
//     products).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float quick_gelu(float v) {
  return v / (1.f + expf(-1.702f * v));
}

// ---- bf16 tensor-core path ---------------------------------------------------

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; b1 and b2 are fp32. bf16 only: the hidden
// is cut into `splits` ranges of whole 64-chunks, one per block along z; with
// splits > 1, `part` is fp32 scratch of splits * M * N elements. fp32 takes
// splits == 1.
extern "C" int mlp_fused_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, void* part, int M, int K, int H, int N,
                             int splits, int dtype, void* stream) {
  if (M < 1 || K < 1 || H < 1 || N < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  if (dtype == 0) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    mlp_fused_f32_kernel<<<grid, FTHREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1f,
        static_cast<const float*>(w2), b2f, static_cast<float*>(y), M, K, H, N);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int n_chunks = (H + BH - 1) / BH;
  const int cps = (n_chunks + splits - 1) / splits;  // chunks per split
  if ((n_chunks + cps - 1) / cps != splits || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_wmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  mlp_fused_wmma_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1f,
      static_cast<const bf16*>(w2), b2f, static_cast<bf16*>(y), static_cast<float*>(part), M, K,
      H, N, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * N;
  const int blocks = (int)min((total + 255) / 256, 4096LL);
  mlp_fused_finalize_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part), b2f,
                                                    static_cast<bf16*>(y), M, N, splits);
  return (int)cudaGetLastError();
}
