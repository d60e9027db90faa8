// Device helpers shared by the retrieval kernels that score index rows
// against staged queries (retrieval_tilemax.cu, retrieval_binmax.cu): the
// index types, the 16-byte dot products of the CUDA-core bodies and their
// warp reduce-scatter; the streamed load and the staged query stride of
// retrieval_tilemax.cu's mma body.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

// MODE: 0 = fp32 index, 1 = bf16 index, 2 = int8 index (int32 sums)
template <int MODE> struct Mode {
  static constexpr int PER_VEC = MODE == 0 ? 4 : (MODE == 1 ? 8 : 16);  // elements per 16 B
  static constexpr int ELEM = 16 / PER_VEC;  // bytes per element
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

// a streamed 16-byte load: no L1 allocation, the 256-byte block around it
// prefetched into L2 (the warp reads the rest of those rows next)
__device__ __forceinline__ uint4 ld_stream(const unsigned char* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

constexpr int QPAD = 64;  // see mma_ldq

// a staged query row's stride: 64 mod 128 bytes, so the 8 lanes of a 16-byte
// load phase (2 query rows x 4 lanes) meet 32 distinct banks
__host__ __device__ constexpr int mma_ldq(int row_bytes) { return (row_bytes + 127) / 128 * 128 + QPAD; }

}  // namespace
