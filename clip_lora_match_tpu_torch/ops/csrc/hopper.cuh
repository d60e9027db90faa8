// Hopper building blocks shared by the TMA + wgmma kernels (mlp_fused.cu,
// lora_matmul.cu, retrieval_binmax.cu), the bulk-copy rings of
// retrieval_topk.cu and retrieval_binmax.cu and the mma.sync
// kernels (flash_attention.cu, retrieval_tilemax.cu): mbarriers, TMA and 1-D
// bulk loads, cluster addressing, wgmma shared-memory descriptors and fences,
// the 3xTF32 operand split and the mma.sync products (tf32, bf16, s8), and
// the host side that encodes TMA tensor maps. The shape-specific wgmma
// instructions stay in each kernel's file.
//
// tensor maps: cuTensorMapEncodeTiled is a driver API; it is taken through
// cudaGetDriverEntryPointByVersion, so the build needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace hopper {

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// the shared::cluster address of `addr` (a shared::cta address) in CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive on a barrier of CTA `rank` (releasing this thread's writes to the cluster)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(mapa(bar, rank))
               : "memory");
}
// wait for the phase of parity `parity` to complete; a wait that never ends
// traps (a broken pipeline fails the launch instead of hanging the card)
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t ok;
    if (kCluster)
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (spins == (1u << 26)) __trap();
  }
}
// 2-D TMA load of the box at (c0 inner, c1 outer) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(bar)
      : "memory");
}
// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global memory into this CTA's shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// bulk copy of `bytes` of this CTA's shared memory to a peer's (dst and bar are
// shared::cluster addresses), completing on the peer's barrier
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands take
// sbo = 1024 (the stride of 8-row groups); MN-major operands take lbo = the
// stride of 64-wide MN blocks and sbo = 1024 (the stride of 8-deep K groups).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo for 3xTF32 (a.b = hi.hi + hi.lo + lo.hi): hi is x rounded to
// TF32 (to nearest, ties away from zero) by integer arithmetic, lo = x - hi
// exactly, of which the tensor core reads the TF32 part (|lo| <= 2^-11 |x|,
// so the product keeps ~21 bits). Two integer ops and a subtraction on the
// full-rate pipes: cvt.rna.tf32.f32 runs on a slower one.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8, row) . b (8 x 8, col), TF32 in, fp32 accumulate.
// a[0]: (row g, k t), a[1]: (g + 8, t), a[2]: (g, t + 4), a[3]: (g + 8, t + 4);
// b0: (k t, col g), b1: (t + 4, g); g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8) += a (16 x 16, row) . b (16 x 8, col), bf16 pairs in, fp32
// accumulate. a[0]: (row g, k 2t, 2t + 1), a[1]: (g + 8, 2t..), a[2]: (g,
// 2t + 8..), a[3]: (g + 8, 2t + 8..); b0: (k 2t, 2t + 1, col g), b1: (2t + 8..)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8) += a (16 x 32, row) . b (32 x 8, col), s8 quadruples in, s32
// accumulate (exact; no .satfinite, a sum past 2^31 would wrap). a[0]: (row
// g, k 4t..4t + 3), a[1]: (g + 8, 4t..), a[2]: (g, 4t + 16..), a[3]: (g + 8,
// 4t + 16..); b0: (k 4t..4t + 3, col g), b1: (4t + 16..). In 32-bit words the
// same map as mma_bf16's
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a row-major (outer, inner) matrix of `type` (elements of `elem` bytes),
// boxes of box_outer x box_inner, 128-byte swizzle, zeros outside
bool tensor_map_of(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr, int inner,
                   int outer, int box_inner, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same for a bf16 matrix
bool tensor_map(CUtensorMap* map, const void* ptr, int inner, int outer, int box_inner,
                int box_outer) {
  return tensor_map_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, inner, outer, box_inner,
                       box_outer);
}

}  // namespace hopper
}  // namespace
