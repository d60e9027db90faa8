// Exact top-k cosine retrieval: query normalization, q . index^T in fp32,
// per-chunk top-k, then a merge into the final sorted (Q, k).
//
// Replaces: clip_lora_match_tpu/ops/retrieval_topk.py (topk_retrieve:
//   _kernel + _extract_topk).
// Contract kept: queries (Q, D) fp32 raw, normalized here as
//   q * rsqrt(sum(q^2) + 1e-12); index (N, D) fp32 or bf16 unit rows, widened
//   to fp32; scores accumulate in fp32; output scores (Q, k) fp32 sorted
//   descending and int32 row ids, ties to the LOWER row id (the TPU kernel's
//   argmax picks the lowest column and its running merge keeps earlier tiles
//   first).
// What bounds it on the H100: bytes. Every index row is read once per block
//   of 8 queries (N*D*4 bytes for fp32, half for bf16); the work is 2*Q*N*D
//   FLOPs, far below the ridge point at the seeker's Q = 1.
// Design: on Hopper blocks run unordered, so there is no running top-k carried
//   across blocks as on the TPU's sequential grid. Pass 1: a block takes 256
//   index rows (a chunk) and 8 queries; its 8 warps score the rows, each lane
//   striding over D; the 8 x 256 scores stay in shared memory; then warp w
//   extracts query w's top-k from the chunk by k rounds of a warp argmax on
//   (score desc, id asc), writing (Q, chunks, k) candidates. Pass 2: one
//   block per query merges the sorted chunk lists by k rounds of a block
//   argmax over the list heads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 8;          // queries per pass-1 block (one warp each)
constexpr int CHUNK = 256;     // index rows per pass-1 block
constexpr int THREADS = 256;
constexpr int PER_LANE = CHUNK / 32;
constexpr float kNegInf = -3.4028234663852886e38f;  // float32 finfo.min
constexpr int kBadId = 0x7fffffff;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// (s1, i1) ranks before (s2, i2): higher score, then lower id
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

template <typename TI>
__global__ void __launch_bounds__(THREADS) topk_chunk_kernel(
    const float* __restrict__ queries, const TI* __restrict__ index,
    float* __restrict__ cand_s, int* __restrict__ cand_i, int Q, int N, int D,
    int k, int num_chunks) {
  extern __shared__ float smem[];
  float* qs = smem;               // QT x D normalized queries
  float* sc = qs + QT * D;        // QT x CHUNK scores
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const long long n0 = (long long)chunk * CHUNK;

  {  // normalize query q0 + warp
    const int q = q0 + warp;
    float ss = 0.f;
    if (q < Q)
      for (int d = lane; d < D; d += 32) {
        const float v = queries[(long long)q * D + d];
        ss = fmaf(v, v, ss);
      }
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss + 1e-12f);
    for (int d = lane; d < D; d += 32)
      qs[warp * D + d] = q < Q ? queries[(long long)q * D + d] * inv : 0.f;
  }
  __syncthreads();

  for (int row = warp; row < CHUNK; row += THREADS / 32) {
    const long long n = n0 + row;
    float part[QT];
#pragma unroll
    for (int t = 0; t < QT; ++t) part[t] = 0.f;
    if (n < N) {
      const TI* ir = index + n * D;
      for (int d = lane; d < D; d += 32) {
        const float v = to_f(ir[d]);
#pragma unroll
        for (int t = 0; t < QT; ++t) part[t] = fmaf(qs[t * D + d], v, part[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < QT; ++t)
      for (int off = 16; off > 0; off >>= 1)
        part[t] += __shfl_xor_sync(0xffffffffu, part[t], off);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < QT; ++t) sc[t * CHUNK + row] = n < N ? part[t] : -INFINITY;
    }
  }
  __syncthreads();

  const int q = q0 + warp;
  if (q >= Q) return;
  float v[PER_LANE];
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) v[t] = sc[warp * CHUNK + lane + 32 * t];
  const long long out = ((long long)q * num_chunks + chunk) * k;
  for (int round = 0; round < k; ++round) {
    float bs = -INFINITY;
    int bi = kBadId;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int id = lane + 32 * t;
      if (better(v[t], id, bs, bi)) { bs = v[t]; bi = id; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (bs == -INFINITY) bi = kBadId;  // chunk has fewer than k live rows
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t)
      if (bi == lane + 32 * t) v[t] = -INFINITY;
    if (lane == 0) {
      cand_s[out + round] = bi == kBadId ? kNegInf : bs;
      cand_i[out + round] = bi == kBadId ? kBadId : (int)(n0 + bi);
    }
  }
}

__global__ void __launch_bounds__(THREADS) topk_merge_kernel(
    const float* __restrict__ cand_s, const int* __restrict__ cand_i,
    float* __restrict__ out_s, int* __restrict__ out_i, int num_chunks, int k) {
  extern __shared__ int head[];  // num_chunks list heads
  __shared__ float ws[THREADS / 32];
  __shared__ int wi[THREADS / 32], wc[THREADS / 32];
  const int q = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base = (long long)q * num_chunks * k;
  for (int c = threadIdx.x; c < num_chunks; c += THREADS) head[c] = 0;
  __syncthreads();
  for (int round = 0; round < k; ++round) {
    float bs = -INFINITY;
    int bi = kBadId, bc = -1;
    for (int c = threadIdx.x; c < num_chunks; c += THREADS) {
      const int h = head[c];
      if (h < k) {
        const float s = cand_s[base + (long long)c * k + h];
        const int i = cand_i[base + (long long)c * k + h];
        if (better(s, i, bs, bi)) { bs = s; bi = i; bc = c; }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (better(os, oi, bs, bi)) { bs = os; bi = oi; bc = oc; }
    }
    if (lane == 0) { ws[warp] = bs; wi[warp] = bi; wc[warp] = bc; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < THREADS / 32; ++w)
        if (better(ws[w], wi[w], bs, bi)) { bs = ws[w]; bi = wi[w]; bc = wc[w]; }
      out_s[(long long)q * k + round] = bs;
      out_i[(long long)q * k + round] = bi;
      if (bc >= 0) head[bc] += 1;
    }
    __syncthreads();
  }
}

template <typename TI>
cudaError_t launch(const float* queries, const void* index, float* cand_s,
                   int* cand_i, float* out_s, int* out_i, int Q, int N, int D,
                   int k, cudaStream_t stream) {
  const int num_chunks = (N + CHUNK - 1) / CHUNK;
  const size_t smem1 = sizeof(float) * ((size_t)QT * D + (size_t)QT * CHUNK);
  auto k1 = topk_chunk_kernel<TI>;
  if (smem1 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err != cudaSuccess) return err;
  }
  dim3 grid1(num_chunks, (Q + QT - 1) / QT);
  k1<<<grid1, THREADS, smem1, stream>>>(
      queries, static_cast<const TI*>(index), cand_s, cand_i, Q, N, D, k, num_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = sizeof(int) * (size_t)num_chunks;
  topk_merge_kernel<<<Q, THREADS, smem2, stream>>>(cand_s, cand_i, out_s, out_i, num_chunks, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int topk_num_chunks(int N) { return (N + CHUNK - 1) / CHUNK; }

// index_dtype: 0 = float32, 1 = bfloat16. 1 <= k <= min(N, 256); D <= 4096;
// cand_s / cand_i hold Q * topk_num_chunks(N) * k entries.
extern "C" int topk_retrieve_fwd(const void* queries, const void* index,
                                 void* cand_s, void* cand_i, void* out_s,
                                 void* out_i, int Q, int N, int D, int k,
                                 int index_dtype, void* stream) {
  if (Q < 1 || N < 1 || D < 1 || D > 4096 || k < 1 || k > CHUNK || k > N ||
      (size_t)topk_num_chunks(N) * sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  float* cs = static_cast<float*>(cand_s);
  int* ci = static_cast<int*>(cand_i);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  if (index_dtype == 0) return (int)launch<float>(q, index, cs, ci, os, oi, Q, N, D, k, st);
  if (index_dtype == 1)
    return (int)launch<__nv_bfloat16>(q, index, cs, ci, os, oi, Q, N, D, k, st);
  return (int)cudaErrorInvalidValue;
}
