// Pass 1 of the two-pass exact top-k: the maximum score of each `tile`-row
// tile of the index, and optionally the maximum of each group of tiles.
//
// Replaces: clip_lora_match_tpu/ops/retrieval_topk.py
//   _tilemax_pallas      (_tilemax_kernel)          -> tilemax_fwd
//   _tilemax_sup_pallas  (_tilemax_sup_kernel)      -> tilemax_sup_fwd
//   _tilemax_sup_q8_pallas (_tilemax_sup_q8_kernel) -> tilemax_sup_q8_fwd
// Contract kept: the query block arrives normalized and already cast to the
//   index type (fp32, bf16, or int8 for the quantized index). Scores
//   accumulate in fp32 (fp32 and bf16 indexes; a bf16 x bf16 product is exact
//   in fp32) or in int32 (int8 x int8 by __dp4a, exact). The int8 score is
//   float(int32 dot) * scale[row]: the per-row index scale applied in fp32
//   after the conversion, the per-query scale NOT applied, so the maxima equal
//   the fp32 rescoring of the candidates bit for bit (D <= 1024 keeps every
//   sum below 2^24). Rows at or past N count as zero rows and score 0, as the
//   JAX package's zero padding to a tile multiple does.
// Layout (the port's own; the TPU kernels' 2,048-row blocks, ragged tail and
//   transposed outputs came from Mosaic's tiling): tile maxima (Q, nt) with
//   nt = ceil(N / tile), group maxima (Q, ng) with ng = ceil(nt / group); the
//   last group covers the tiles that exist.
// What bounds it on the H100: bytes. The index is read once per block of up
//   to 8 queries (N*D*4 bytes fp32, half for bf16, a quarter for int8); the
//   2*Q*N*D operations are far below the ridge point at the seeker's Q = 1.
// Design: a block of 8 warps owns `tpb` consecutive tiles (one group when
//   group maxima are asked for, else 16) and a block of QB queries, staged in
//   shared memory (bf16 and int8 queries in their own type, so that one
//   conflict-free 16-byte shared load meets each 16-byte index vector). A
//   warp walks its tiles row by row: each lane loads 16-byte vectors of the
//   row (coalesced across the warp) and multiplies them with the staged
//   queries; a reduce-scatter butterfly leaves each query's row score in
//   32/QB lanes, which fold it into that query's running tile maximum. The
//   block then takes the group maximum from the tile maxima it holds in
//   shared memory, so the (Q, nt) array is never read back, as on the TPU.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PLAIN_TILES_PER_BLOCK = 16;

// MODE: 0 = fp32 index, 1 = bf16 index, 2 = int8 index by __dp4a
template <int MODE> struct Mode {
  static constexpr int PER_VEC = MODE == 0 ? 4 : (MODE == 1 ? 8 : 16);  // elements per 16 B
  // staged query type: the index's own for bf16 and int8 (one conflict-free
  // 16-byte shared load per index vector), fp32 otherwise
  using QS = typename std::conditional<
      MODE == 1, __nv_bfloat16, typename std::conditional<MODE == 2, int8_t, float>::type>::type;
  using Acc = typename std::conditional<MODE == 2, int, float>::type;
};

__device__ __forceinline__ void dot_vec(const uint4 raw, const float* q, float& acc,
                                        std::integral_constant<int, 0>) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  acc = fmaf(__uint_as_float(raw.x), a.x, acc);
  acc = fmaf(__uint_as_float(raw.y), a.y, acc);
  acc = fmaf(__uint_as_float(raw.z), a.z, acc);
  acc = fmaf(__uint_as_float(raw.w), a.w, acc);
}

// bf16 pair in a 32-bit word -> its two fp32 values (exact: bf16 is the top
// half of an fp32)
__device__ __forceinline__ float lo_bf(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void dot_word_bf(unsigned w, unsigned a, float& acc) {
  acc = fmaf(lo_bf(w), lo_bf(a), acc);
  acc = fmaf(hi_bf(w), hi_bf(a), acc);
}

__device__ __forceinline__ void dot_vec(const uint4 raw, const __nv_bfloat16* q, float& acc,
                                        std::integral_constant<int, 1>) {
  const uint4 a = *reinterpret_cast<const uint4*>(q);
  dot_word_bf(raw.x, a.x, acc);
  dot_word_bf(raw.y, a.y, acc);
  dot_word_bf(raw.z, a.z, acc);
  dot_word_bf(raw.w, a.w, acc);
}

__device__ __forceinline__ void dot_vec(const uint4 raw, const int8_t* q, int& acc,
                                        std::integral_constant<int, 2>) {
  const int4 a = *reinterpret_cast<const int4*>(q);
  acc = __dp4a(static_cast<int>(raw.x), a.x, acc);
  acc = __dp4a(static_cast<int>(raw.y), a.y, acc);
  acc = __dp4a(static_cast<int>(raw.z), a.z, acc);
  acc = __dp4a(static_cast<int>(raw.w), a.w, acc);
}

// Warp sums of QB per-lane partials by a reduce-scatter butterfly: each of the
// first log2(QB) steps trades half of the live sums with the partner lane, so
// QB = 8 takes 4+2+1 shuffles and then 2 for the last offsets (9, where 8
// full butterflies take 40). Lane l ends with the total of query
// query_of_lane<QB>(l); the 32/QB lanes that share a query hold equal totals.
template <int QB, typename Acc>
__device__ __forceinline__ Acc reduce_scatter(Acc (&acc)[QB], int lane) {
#pragma unroll
  for (int c = QB, o = 16; c > 1; c >>= 1, o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < c / 2; ++i) {
      const Acc send = upper ? acc[i] : acc[i + c / 2];
      const Acc keep = upper ? acc[i + c / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  Acc v = acc[0];
#pragma unroll
  for (int o = 16 / QB; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int QB>
__device__ __forceinline__ int query_of_lane(int lane) {
  int q = 0;
#pragma unroll
  for (int c = QB, o = 16; c > 1; c >>= 1, o >>= 1)
    if (lane & o) q += c / 2;
  return q;
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

template <int MODE, int QB>
__global__ void __launch_bounds__(THREADS) tilemax_kernel(
    const void* __restrict__ queries, const void* __restrict__ index,
    const float* __restrict__ scales, float* __restrict__ tmax,
    float* __restrict__ gmax, int Q, int N, int D, int tile, int tpb, int nt, int ng) {
  using M = Mode<MODE>;
  using QS = typename M::QS;
  using Acc = typename M::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  QS* qs = reinterpret_cast<QS*>(smem);  // QB x D staged queries
  float* tile_best = reinterpret_cast<float*>(smem + align16(sizeof(QS) * QB * D));  // QB x tpb
  const int q0 = blockIdx.y * QB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < QB * D; i += THREADS) {
    const int r = i / D;
    const long long src = (long long)(q0 + r) * D + (i - r * D);
    QS v{};  // zero: query rows past Q
    if (q0 + r < Q) {
      if constexpr (MODE == 0) v = static_cast<const float*>(queries)[src];
      else if constexpr (MODE == 1) v = static_cast<const __nv_bfloat16*>(queries)[src];
      else v = static_cast<const int8_t*>(queries)[src];
    }
    qs[i] = v;
  }
  __syncthreads();

  const int nvec = D / M::PER_VEC;
  const size_t row_bytes = (size_t)D * (MODE == 0 ? 4 : (MODE == 1 ? 2 : 1));
  const unsigned char* base = static_cast<const unsigned char*>(index);
  const int tile0 = blockIdx.x * tpb;

  const int my_q = query_of_lane<QB>(lane);  // the query whose sums this lane ends with
  const bool writer = lane % (32 / QB) == 0 && q0 + my_q < Q;
  for (int t = warp; t < tpb; t += WARPS) {
    const int tg = tile0 + t;
    if (tg >= nt) break;
    float best = -INFINITY;
    for (int r = 0; r < tile; ++r) {
      const long long n = (long long)tg * tile + r;
      if (n >= N) {  // a pad row: zero, scores 0 (warp-uniform branch)
        best = fmaxf(best, 0.f);
        continue;
      }
      Acc acc[QB];
#pragma unroll
      for (int j = 0; j < QB; ++j) acc[j] = 0;
      const uint4* row = reinterpret_cast<const uint4*>(base + n * row_bytes);
      for (int v = lane; v < nvec; v += 32) {
        const uint4 raw = __ldg(row + v);
#pragma unroll
        for (int j = 0; j < QB; ++j)
          dot_vec(raw, qs + (size_t)j * D + (size_t)v * M::PER_VEC, acc[j],
                  std::integral_constant<int, MODE>());
      }
      const Acc total = reduce_scatter<QB>(acc, lane);
      const float s = MODE == 2 ? static_cast<float>(total) * scales[n] : static_cast<float>(total);
      best = fmaxf(best, s);
    }
    if (writer) {
      tmax[(long long)(q0 + my_q) * nt + tg] = best;
      if (gmax != nullptr) tile_best[my_q * tpb + t] = best;
    }
  }

  if (gmax == nullptr) return;
  __syncthreads();
  if (threadIdx.x < QB && q0 + (int)threadIdx.x < Q) {
    const int j = threadIdx.x;
    const int live = min(tpb, nt - tile0);
    float g = -INFINITY;
    for (int t = 0; t < live; ++t) g = fmaxf(g, tile_best[j * tpb + t]);
    gmax[(long long)(q0 + j) * ng + blockIdx.x] = g;
  }
}

template <int MODE, int QB>
cudaError_t launch_qb(const void* q, const void* index, const float* scales, float* tmax,
                      float* gmax, int Q, int N, int D, int tile, int tpb,
                      cudaStream_t stream) {
  using QS = typename Mode<MODE>::QS;
  const int nt = (int)(((long long)N + tile - 1) / tile);
  const int ng = (nt + tpb - 1) / tpb;
  const size_t smem = align16(sizeof(QS) * QB * D) + (gmax ? sizeof(float) * QB * tpb : 0);
  auto kern = tilemax_kernel<MODE, QB>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(ng, (Q + QB - 1) / QB);
  kern<<<grid, THREADS, smem, stream>>>(q, index, scales, tmax, gmax, Q, N, D, tile, tpb, nt, ng);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const void* q, const void* index, const float* scales, float* tmax,
                   float* gmax, int Q, int N, int D, int tile, int tpb, cudaStream_t stream) {
  if (Q == 1) return launch_qb<MODE, 1>(q, index, scales, tmax, gmax, Q, N, D, tile, tpb, stream);
  if (Q == 2) return launch_qb<MODE, 2>(q, index, scales, tmax, gmax, Q, N, D, tile, tpb, stream);
  if (Q <= 4) return launch_qb<MODE, 4>(q, index, scales, tmax, gmax, Q, N, D, tile, tpb, stream);
  return launch_qb<MODE, 8>(q, index, scales, tmax, gmax, Q, N, D, tile, tpb, stream);
}

bool bad_shape(int Q, int N, int D, int tile, int tpb, int per_vec) {
  return Q < 1 || N < 1 || D < 1 || D > 4096 || D % per_vec != 0 || tile < 1 ||
         tpb < 1 || tpb > 1024 || Q > 65535 * 8;
}

}  // namespace

// index_dtype: 0 = float32, 1 = bfloat16. queries (Q, D) in the index's type;
// tmax (Q, ceil(N / tile)) fp32. D a multiple of 16 bytes of the index type,
// index rows 16-byte aligned.
extern "C" int tilemax_fwd(const void* queries, const void* index, void* tmax, int Q, int N,
                           int D, int tile, int index_dtype, void* stream) {
  const int per_vec = index_dtype == 0 ? 4 : 8;
  if (bad_shape(Q, N, D, tile, PLAIN_TILES_PER_BLOCK, per_vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(tmax);
  if (index_dtype == 0)
    return (int)launch<0>(queries, index, nullptr, t, nullptr, Q, N, D, tile, PLAIN_TILES_PER_BLOCK, st);
  if (index_dtype == 1)
    return (int)launch<1>(queries, index, nullptr, t, nullptr, Q, N, D, tile, PLAIN_TILES_PER_BLOCK, st);
  return (int)cudaErrorInvalidValue;
}

// As tilemax_fwd, plus gmax (Q, ceil(ceil(N / tile) / group)) fp32.
extern "C" int tilemax_sup_fwd(const void* queries, const void* index, void* tmax, void* gmax,
                               int Q, int N, int D, int tile, int group, int index_dtype,
                               void* stream) {
  const int per_vec = index_dtype == 0 ? 4 : 8;
  if (bad_shape(Q, N, D, tile, group, per_vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(tmax);
  float* g = static_cast<float*>(gmax);
  if (index_dtype == 0) return (int)launch<0>(queries, index, nullptr, t, g, Q, N, D, tile, group, st);
  if (index_dtype == 1) return (int)launch<1>(queries, index, nullptr, t, g, Q, N, D, tile, group, st);
  return (int)cudaErrorInvalidValue;
}

// int8 queries (Q, D) and values (N, D), fp32 scales (N,); the exact int32
// dot by __dp4a (the TPU kernel's MXU operand choice has no counterpart
// here). D a multiple of 16, <= 1024.
extern "C" int tilemax_sup_q8_fwd(const void* queries, const void* values, const void* scales,
                                  void* tmax, void* gmax, int Q, int N, int D, int tile,
                                  int group, void* stream) {
  if (bad_shape(Q, N, D, tile, group, 16) || D > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  float* t = static_cast<float*>(tmax);
  float* g = static_cast<float*>(gmax);
  return (int)launch<2>(queries, values, s, t, g, Q, N, D, tile, group, st);
}
