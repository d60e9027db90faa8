// Bin maxima of q . index^T for approximate top-k: the partial reduce of
// XLA's ApproxTopK (the TPU-KNN layout), with no score matrix in memory.
//
// Replaces no pallas_call. The JAX package's approximate selection
//   (clip_lora_match_tpu/retrieval/similarity.py, _approx_topk_jit) is an
//   XLA dot followed by lax.approx_max_k, which on the TPU is XLA's own
//   ApproxTopK op: a partial reduce of the (Q, N) scores into L bins, then
//   an exact top-k over the bins. This kernel is that partial reduce fused
//   with the product; ops/approx_topk.py picks L as XLA does and runs the
//   exact top-k over the (Q, L) result.
// Contract: queries (Q, D) normalized and already cast to the index type
//   (fp32 or bf16; fp32 sums). Row j falls into bin j mod L, so a window of
//   L consecutive rows holds one row of each bin; W = ceil(N / L) windows.
//   Out: maxima (Q, L) fp32 and their row ids (Q, L) int32; among equal
//   scores in a bin, the lowest row. Rows at or past N are in no bin. L is a
//   multiple of 128 and L <= N, so every bin holds a row of window 0.
// What bounds it on the H100: bytes. The index is read once per query
//   block, N*D*4 bytes fp32 (half for bf16), against 2*Q*N*D operations;
//   the (Q, L) output is a few KB a query.
// Design. A block owns a slab of bins and a contiguous range of windows
//   (a split): for each window it reads the slab's rows, one contiguous
//   (bins, D) tile, and folds their scores into a running maximum and row id
//   per (query, bin) in registers; windows are walked in increasing order and
//   only a strictly greater score replaces the best, so the lowest row wins a
//   tie. L is 128-2,560 bins and the card has 132 SMs, so the windows are
//   split over blocks (ops/approx_topk.py binmax_plan sizes the splits to
//   the card) and a second launch merges each (query, bin)'s split maxima in
//   split order (the first of equal maxima: the lowest row again). One split
//   writes the output directly and needs no merge. Two bodies:
//   - cuda_core (Q <= 16, or rows not of whole 64-byte k-chunks): a block of
//     8 warps takes 64 bins and up to 8 queries staged in shared memory (in
//     the index's type); a warp scores one row at a time, each lane loading
//     16-byte vectors of the row, and a reduce-scatter butterfly leaves each
//     query's score in 32/QB lanes (retrieval_tilemax.cu's cuda_core body;
//     the shared helpers are in retrieval_rows.cuh);
//   - mma (Q > 16): a block of 8 warps takes 128 bins, a warp one 16-row
//     mma A fragment per window, and 32 or 64 queries staged once in shared
//     memory; bf16 runs mma.sync m16n8k16, fp32 3xTF32 on m16n8k8, with the
//     fragment map, k permutation and register ring of retrieval_tilemax.cu's
//     mma body. Each lane keeps the running maximum and row of the 4 x NT
//     (row, query) elements of its accumulators, so the fold needs no
//     shuffle and the scores never leave the registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"
#include "retrieval_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CORE_BINS = 64;  // bins of a cuda_core block
constexpr int MMA_BINS = 128;  // bins of an mma block: 8 warps x 16 rows
constexpr int STAGES = 4;      // mma: k-chunks in registers (STAGES - 1 in flight)
constexpr int CHUNK = 64;      // bytes of a row per k-chunk: 4 lanes x 16 B
constexpr int MMA_BODY = 1;

// the windows [w0, w1) of split s of `splits` over W windows
__device__ __forceinline__ void split_range(int s, int splits, int W, int& w0, int& w1) {
  w0 = (int)((long long)s * W / splits);
  w1 = (int)((long long)(s + 1) * W / splits);
}

// ---- the cuda_core body --------------------------------------------------------

template <int MODE, int QB>
__global__ void __launch_bounds__(THREADS) binmax_core_kernel(
    const void* __restrict__ queries, const unsigned char* __restrict__ index,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int N, int D, int L, int W,
    int splits) {
  using M = Mode<MODE>;
  using QS = typename M::QS;
  extern __shared__ __align__(16) unsigned char smem[];
  QS* qs = reinterpret_cast<QS*>(smem);  // QB x D staged queries
  const int q0 = blockIdx.z * QB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < QB * D; i += THREADS) {
    const int r = i / D;
    QS v{};  // zero: query rows past Q
    if (q0 + r < Q) v = static_cast<const QS*>(queries)[(long long)(q0 + r) * D + (i - r * D)];
    qs[i] = v;
  }
  __syncthreads();

  int w0, w1;
  split_range(blockIdx.y, splits, W, w0, w1);
  const int nvec = D / M::PER_VEC;
  const size_t row_bytes = (size_t)D * M::ELEM;
  const int my_q = query_of_lane<QB>(lane);
  const bool writer = lane % (32 / QB) == 0 && q0 + my_q < Q;
  for (int bi = warp; bi < CORE_BINS; bi += WARPS) {
    const int b = blockIdx.x * CORE_BINS + bi;
    float best = -INFINITY;
    int best_id = -1;
    for (int w = w0; w < w1; ++w) {
      const long long n = (long long)w * L + b;
      if (n >= N) break;  // later windows lie further past N
      float acc[QB];
#pragma unroll
      for (int j = 0; j < QB; ++j) acc[j] = 0.f;
      const uint4* row = reinterpret_cast<const uint4*>(index + n * row_bytes);
      for (int v = lane; v < nvec; v += 32) {
        const uint4 raw = __ldg(row + v);
#pragma unroll
        for (int j = 0; j < QB; ++j)
          dot_vec(raw, qs + (size_t)j * D + (size_t)v * M::PER_VEC, acc[j],
                  std::integral_constant<int, MODE>());
      }
      const float s = reduce_scatter<QB>(acc, lane);
      if (s > best) {
        best = s;
        best_id = (int)n;
      }
    }
    if (writer) {
      const long long o = ((long long)blockIdx.y * Q + q0 + my_q) * L + b;
      part_v[o] = best;
      part_i[o] = best_id;
    }
  }
}

// ---- the mma body --------------------------------------------------------------

template <int MODE, int NT>
__global__ void __launch_bounds__(THREADS, 1) binmax_mma_kernel(
    const unsigned char* __restrict__ queries, const unsigned char* __restrict__ index,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int N, int D, int L, int W,
    int splits) {
  constexpr int QB = 8 * NT;
  const int row_bytes = D * Mode<MODE>::ELEM;
  const int ldq = mma_ldq(row_bytes);
  const int nc = row_bytes / CHUNK;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.z * QB;
  const int vecs = row_bytes / 16;
  for (int i = tid; i < QB * vecs; i += THREADS) {
    const int r = i / vecs, v = i - r * vecs;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Q) x = *reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * row_bytes + v * 16);
    *reinterpret_cast<uint4*>(qs + (size_t)r * ldq + v * 16) = x;
  }

  int w0, w1;
  split_range(blockIdx.y, splits, W, w0, w1);
  const int nw = w1 - w0;
  const int total = nw * nc;
  // rows g and g + 8 of this warp's fragment in window 0 of the split
  const long long bin_row = (long long)blockIdx.x * MMA_BINS + warp * 16 + g;
  __syncthreads();

  // a[s][h]: the 16 bytes of row (h * 8 + g) of the warp's fragment at
  // k-chunk bytes [16 t, 16 t + 16)
  uint4 a[STAGES][2];
  int ld_w = 0, ld_c = 0;
  auto load = [&](uint4 (&dst)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)(w0 + ld_w) * L + bin_row + h * 8;
      dst[h] = make_uint4(0u, 0u, 0u, 0u);  // a row past N: zero, and never folded
      if (ld_w < nw && row < N) dst[h] = ld_stream(index + row * row_bytes + ld_c * CHUNK + t * 16);
    }
    if (++ld_c == nc) {
      ld_c = 0;
      ++ld_w;
    }
  };

  float acc[NT][4], best[NT][4];
  int best_id[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0.f;
      best[j][e] = -INFINITY;
      best_id[j][e] = -1;
    }

  // one k-chunk: 2 mma k-steps per query tile (the k permutation of
  // retrieval_tilemax.cu: a lane's 16 bytes of a row and of a query row are
  // the same k)
  auto compute = [&](const uint4 (&src)[2], int c) {
    const unsigned char* qrow = qs + (size_t)g * ldq + c * CHUNK + t * 16;
    const uint32_t a0[4] = {src[0].x, src[1].x, src[0].y, src[1].y};
    const uint32_t a1[4] = {src[0].z, src[1].z, src[0].w, src[1].w};
    if constexpr (MODE == 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 b = *reinterpret_cast<const uint4*>(qrow + (size_t)j * 8 * ldq);
        hopper::mma_bf16(acc[j], a0, b.x, b.y);
        hopper::mma_bf16(acc[j], a1, b.z, b.w);
      }
    } else {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hopper::split(__uint_as_float(a0[e]), ah[0][e], al[0][e]);
        hopper::split(__uint_as_float(a1[e]), ah[1][e], al[1][e]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 b = *reinterpret_cast<const uint4*>(qrow + (size_t)j * 8 * ldq);
        const float bv[4] = {__uint_as_float(b.x), __uint_as_float(b.y), __uint_as_float(b.z),
                             __uint_as_float(b.w)};
        uint32_t bh[4], bl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) hopper::split(bv[e], bh[e], bl[e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hopper::mma_tf32(acc[j], ah[h], bl[2 * h], bl[2 * h + 1]);
          hopper::mma_tf32(acc[j], al[h], bh[2 * h], bh[2 * h + 1]);
          hopper::mma_tf32(acc[j], ah[h], bh[2 * h], bh[2 * h + 1]);
        }
      }
    }
  };

  // the end of a window: fold each (row, query) score into its bin's best.
  // acc[j][0], [1]: row g, queries 8j + 2t, 8j + 2t + 1; [2], [3]: row g + 8
  auto fold = [&](int w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)w * L + bin_row + h * 8;
      if (row < N) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e)
            if (acc[j][e] > best[j][e]) {
              best[j][e] = acc[j][e];
              best_id[j][e] = (int)row;
            }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  };

#pragma unroll
  for (int s = 0; s < STAGES; ++s) load(a[s]);
  int cur_c = 0, cur_w = w0;
  for (int i0 = 0; i0 < total; i0 += STAGES) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      if (i0 + s < total) {  // uniform across the block
        compute(a[s], cur_c);
        load(a[s]);  // the chunk STAGES ahead, into the registers just used
        if (++cur_c == nc) {
          fold(cur_w);
          cur_c = 0;
          ++cur_w;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + 8 * j + 2 * t + (e & 1);
      if (q < Q) {
        const long long o = ((long long)blockIdx.y * Q + q) * L + bin_row + (e >> 1) * 8;
        part_v[o] = best[j][e];
        part_i[o] = best_id[j][e];
      }
    }
}

// ---- the merge of the splits ----------------------------------------------------

__global__ void __launch_bounds__(THREADS) binmax_merge_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_i, float* __restrict__ out_v,
    int* __restrict__ out_i, long long QL, int splits) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= QL) return;
  float best = part_v[i];  // split 0 holds window 0: a real row of every bin
  int id = part_i[i];
  for (int s = 1; s < splits; ++s) {
    const float v = part_v[s * QL + i];
    if (v > best) {
      best = v;
      id = part_i[s * QL + i];
    }
  }
  out_v[i] = best;
  out_i[i] = id;
}

template <int MODE, int QB>
cudaError_t launch_core_qb(const void* q, const void* index, float* pv, int* pi, int Q, int N,
                           int D, int L, int W, int splits, cudaStream_t stream) {
  using QS = typename Mode<MODE>::QS;
  const size_t smem = align16(sizeof(QS) * QB * D);
  auto kern = binmax_core_kernel<MODE, QB>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(L / CORE_BINS, splits, (Q + QB - 1) / QB);
  kern<<<grid, THREADS, smem, stream>>>(q, static_cast<const unsigned char*>(index), pv, pi, Q, N,
                                        D, L, W, splits);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_core(const void* q, const void* index, float* pv, int* pi, int Q, int N, int D,
                        int L, int W, int splits, int qb, cudaStream_t stream) {
  if (qb == 1) return launch_core_qb<MODE, 1>(q, index, pv, pi, Q, N, D, L, W, splits, stream);
  if (qb == 2) return launch_core_qb<MODE, 2>(q, index, pv, pi, Q, N, D, L, W, splits, stream);
  if (qb == 4) return launch_core_qb<MODE, 4>(q, index, pv, pi, Q, N, D, L, W, splits, stream);
  if (qb == 8) return launch_core_qb<MODE, 8>(q, index, pv, pi, Q, N, D, L, W, splits, stream);
  return cudaErrorInvalidValue;
}

template <int MODE, int NT>
cudaError_t launch_mma_nt(const void* q, const void* index, float* pv, int* pi, int Q, int N,
                          int D, int L, int W, int splits, cudaStream_t stream) {
  const int row_bytes = D * Mode<MODE>::ELEM;
  const size_t smem = (size_t)8 * NT * mma_ldq(row_bytes);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kern = binmax_mma_kernel<MODE, NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(L / MMA_BINS, splits, (Q + 8 * NT - 1) / (8 * NT));
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const unsigned char*>(q),
                                        static_cast<const unsigned char*>(index), pv, pi, Q, N, D,
                                        L, W, splits);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mma(const void* q, const void* index, float* pv, int* pi, int Q, int N, int D,
                       int L, int W, int splits, int qb, cudaStream_t stream) {
  if ((D * Mode<MODE>::ELEM) % CHUNK != 0 || L % MMA_BINS != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return cudaErrorInvalidValue;
  if (qb == 32) return launch_mma_nt<MODE, 4>(q, index, pv, pi, Q, N, D, L, W, splits, stream);
  if (qb == 64) return launch_mma_nt<MODE, 8>(q, index, pv, pi, Q, N, D, L, W, splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// queries (Q, D) in the index's type (index_dtype 0 = float32, 1 = bfloat16),
// index (N, D) with 16-byte aligned rows; out_v (Q, L) fp32, out_i (Q, L)
// int32; part_v / part_i (splits, Q, L) scratch, unused when splits == 1.
// body 0 = cuda_core, 1 = mma, with the query block qb of the plan
// (ops/approx_topk.py binmax_plan). L a multiple of 128, L <= N.
extern "C" int binmax_fwd(const void* queries, const void* index, void* out_v, void* out_i,
                          void* part_v, void* part_i, int Q, int N, int D, int L, int index_dtype,
                          int body, int qb, int splits, void* stream) {
  const int per_vec = index_dtype == 0 ? 4 : 8;
  const int W = (int)(((long long)N + L - 1) / L);
  if (Q < 1 || N < 1 || D < 1 || D > 4096 || D % per_vec != 0 || L < 128 || L % 128 != 0 ||
      L > N || splits < 1 || splits > W || splits > 65535 || Q > 65535 * 8 ||
      (index_dtype != 0 && index_dtype != 1) ||
      reinterpret_cast<uintptr_t>(index) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = static_cast<float*>(splits == 1 ? out_v : part_v);
  int* pi = static_cast<int*>(splits == 1 ? out_i : part_i);
  cudaError_t err;
  if (body == MMA_BODY)
    err = index_dtype == 0 ? launch_mma<0>(queries, index, pv, pi, Q, N, D, L, W, splits, qb, st)
                           : launch_mma<1>(queries, index, pv, pi, Q, N, D, L, W, splits, qb, st);
  else if (body == 0)
    err = index_dtype == 0 ? launch_core<0>(queries, index, pv, pi, Q, N, D, L, W, splits, qb, st)
                           : launch_core<1>(queries, index, pv, pi, Q, N, D, L, W, splits, qb, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long QL = (long long)Q * L;
  binmax_merge_kernel<<<(unsigned)((QL + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), QL, splits);
  return (int)cudaGetLastError();
}
