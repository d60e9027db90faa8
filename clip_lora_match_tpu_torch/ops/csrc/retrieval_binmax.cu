// Bin maxima of q . index^T for approximate top-k: the partial reduce of
// XLA's ApproxTopK (the TPU-KNN layout), with no score matrix in memory, and
// the exact top-k over the bins fused into the launch after it.
//
// Replaces no pallas_call. The JAX package's approximate selection
//   (clip_lora_match_tpu/retrieval/similarity.py, _approx_topk_jit) is an
//   XLA dot followed by lax.approx_max_k, which on the TPU is XLA's own
//   ApproxTopK op: a partial reduce of the (Q, N) scores into L bins, then
//   an exact top-k over the bins. The bin-max launch is that partial reduce
//   fused with the product; the selection launch (one, or two where a
//   query's bins do not fit one block) is the top-k over the bins.
// Contract: queries (Q, D) normalized and already cast to the index type
//   (fp32 or bf16; fp32 sums). Row j falls into bin j mod L, so a window of
//   L consecutive rows holds one row of each bin; W = ceil(N / L) windows.
//   Bins: maxima (Q, L) fp32 and their row ids (Q, L) int32; among equal
//   scores in a bin, the lowest row. Rows at or past N are in no bin. L is a
//   multiple of 128 and L <= N, so every bin holds a row of window 0.
//   Selection: the top k <= 256 of a query's L bins, descending, ties to the
//   lower id, as scores (Q, k) fp32 and ids (Q, k) int32.
// What bounds it on the H100: bytes. The index is read once per query
//   block, N*D*4 bytes fp32 (half for bf16), against 2*Q*N*D operations: at
//   Q = 64 fp32 the 3xTF32 products (three TF32 tensor-core products at 495
//   TFLOP/s) take ~0.65 of the read. The bins are a few KB a query.
// Design. A block owns a slab of bins (the same `bins` consecutive rows of
//   every window: one contiguous (bins, D) tile a window) and a contiguous
//   range of windows (a split). The grid fills the card once, one block an
//   SM (ops/approx_topk.py binmax_plan picks the slab and the splits), so the
//   query staging and the ring's fill are paid once an SM. A producer warp
//   keeps the index flowing into a shared-memory ring through the TMA unit
//   (96-224 KB an SM) while the consumers score what has landed, so no load
//   waits on a reduce. Windows are walked in increasing order and only a
//   strictly greater score replaces a bin's best, so the lowest row wins a
//   tie; a later launch merges each (query, bin)'s split maxima in split
//   order (the first of equal maxima: the lowest row again). Two bodies:
//   - cuda_core (Q <= 16, or rows not of whole 128-byte slices): 8 consumer
//     warps, up to 8 queries staged in shared memory in the index's type;
//     a ring stage is R whole rows of the slab (one 1-D bulk copy, ~32 KB);
//     a warp scores two rows at a time against every staged query (16-byte
//     shared loads) and a reduce-scatter butterfly leaves each (row, query)
//     sum in 32 / (2 QB) lanes; each bin's running best lives in shared
//     memory, owned by one lane;
//   - wgmma (Q > 16): one or two consumer warpgroups, each a 64-row tile of
//     the slab as wgmma's M; a ring stage is 2-4 128-byte K-slices of the
//     slab's rows (2-D TMA boxes of 64 rows x 128 bytes, 128-byte swizzle).
//     The queries are the N operand (16, 32 or 64 a block), staged once in
//     shared memory in wgmma's swizzled K-major layout with the k order
//     permuted so that each thread's A fragment is two 16-byte shared loads a
//     row; fp32 runs 3xTF32 with A from registers as two tf32 wgmmas a
//     k-step, a_hi . [q_hi | q_lo] (N = 2 NQ) and a_lo . q_hi: the queries
//     are split into hi and lo once, when staged, and each index element
//     once, when loaded. A stage is 2-4 slices (~32 KB); each slice's
//     fragments load while the previous slice's products run, fp32
//     alternates two sets of accumulators between slices, and each stage is
//     summed on the tensor cores (which truncate every addition into their
//     accumulator) and the stages added on the CUDA cores. fp32 queries
//     (hi and lo: 8 bytes an element) fill a block at 32 (16 from D = 768):
//     the query blocks of a batch are blocks of the same slab and split,
//     launched together, so the second reads the windows the first has just
//     brought into L2 (a cluster sharing each slice by TMA multicast was
//     slower: half the streams, so half the bytes in flight). The producer
//     starts the ring with one stage and fills the rest once the queries are
//     staged (filled at once, it queued the query loads behind ~20 MB of
//     index reads: 9 us of staging instead of 5). Each thread keeps the
//     running maximum and row of the (row, query) elements of its
//     accumulator; the scores never leave the registers.
//   Selection (select_kernel): one block of 512 threads per (query, chunk of
//   bins): it merges the bins' split maxima in split order, keys each bin as
//   (score, ~id) in 64 bits (-0 as +0, so equal scores tie as in torch.sort),
//   finds the k-th largest key by a radix select (8 bits a pass over a
//   shared histogram, stopping once the bucket holds exactly what is still
//   needed) and writes the k keys above it ranked by counting. Where a
//   query's bins exceed one block (8,192), the first launch keeps each
//   chunk's best k and a second selects among those candidates.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"
#include "retrieval_rows.cuh"

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take
constexpr int MAX_ROW_BYTES = 4096;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CORE_BODY = 0, MMA_BODY = 1;

// the windows [w0, w1) of split s of `splits` over W windows
__device__ __forceinline__ void split_range(int s, int splits, int W, int& w0, int& w1) {
  w0 = (int)((long long)s * W / splits);
  w1 = (int)((long long)(s + 1) * W / splits);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the cuda_core body --------------------------------------------------------

constexpr int CORE_WARPS = 8;                       // consumers
constexpr int CORE_THREADS = 32 * (CORE_WARPS + 1);  // + the producer warp

// shared memory of the cuda_core body (mirrored by ops/approx_topk.py:
// _core_smem): the ring (S stages of R rows), the staged queries, each
// (query, bin)'s best score and row, the barriers
struct CoreLayout {
  size_t qs, bv, bi, bars, total;
};
__host__ __device__ inline CoreLayout core_layout(int qb, int D, int elem, int bins, int R, int S) {
  CoreLayout c;
  c.qs = (size_t)S * R * D * elem;
  c.bv = c.qs + align16((size_t)qb * D * elem);
  c.bi = c.bv + (size_t)qb * bins * 4;
  c.bars = c.bi + (size_t)qb * bins * 4;
  c.total = c.bars + (size_t)S * 16;
  return c;
}

// grid (L / bins, splits, query blocks of QB)
template <int MODE, int QB>
__global__ void __launch_bounds__(CORE_THREADS, 1) binmax_core_kernel(
    const unsigned char* __restrict__ queries, const unsigned char* __restrict__ index,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int N, int D, int L, int W,
    int splits, int bins, int R, int S) {
  using M = Mode<MODE>;
  using QS = typename M::QS;
  constexpr int P = 2 * QB;  // the (row, query) sums a warp reduces at once
  extern __shared__ __align__(128) unsigned char smem[];
  const int rb = D * M::ELEM;
  const CoreLayout lay = core_layout(QB, D, M::ELEM, bins, R, S);
  const QS* qs = reinterpret_cast<const QS*>(smem + lay.qs);
  float* bv = reinterpret_cast<float*>(smem + lay.bv);
  int* bi = reinterpret_cast<int*>(smem + lay.bi);
  const uint32_t bars = smem_u32(smem + lay.bars);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const int b0 = blockIdx.x * bins, q0 = blockIdx.z * QB;
  int w0, w1;
  split_range(blockIdx.y, splits, W, w0, w1);
  const int spw = bins / R;  // stages a window
  const int total = (w1 - w0) * spw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), CORE_WARPS);  // one release from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CORE_WARPS) {
    // ---- producer: stage it is rows [t R, t R + R) of the slab in window it / spw
    if (lane == 0) {
      for (int it = 0; it < total; ++it) {
        const int s = it % S;
        hopper::mbar_wait<false>(empty(s), ((it / S) & 1) ^ 1);
        const long long row0 = (long long)(w0 + it / spw) * L + b0 + (long long)(it % spw) * R;
        const long long rows = min((long long)R, (long long)N - row0);
        if (rows > 0) {
          const uint32_t bytes = (uint32_t)(rows * rb);
          hopper::mbar_expect_tx(full(s), bytes);
          hopper::bulk_load(smem_u32(smem + (size_t)s * R * rb), index + row0 * rb, bytes, full(s));
        } else {
          hopper::mbar_arrive(full(s));  // every row past N: nothing to bring
        }
      }
    }
  } else {
    // ---- consumers: the queries (zero past Q) and the bins' running best
    const int vecs = rb / 16;
    for (int i = threadIdx.x; i < QB * vecs; i += 32 * CORE_WARPS) {
      const int r = i / vecs;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Q) x = *reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * rb + (size_t)(i - r * vecs) * 16);
      *reinterpret_cast<uint4*>(smem + lay.qs + (size_t)i * 16) = x;
    }
    for (int i = threadIdx.x; i < QB * bins; i += 32 * CORE_WARPS) {
      bv[i] = -INFINITY;
      bi[i] = -1;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * CORE_WARPS) : "memory");
    // this lane's sum after the butterfly: row `my_row` of the pair, query `my_q`
    const int mine = query_of_lane<P>(lane);
    const int my_row = mine / QB, my_q = mine % QB;
    const bool writer = lane % (32 / P) == 0 && q0 + my_q < Q;
    for (int it = 0; it < total; ++it) {
      const int s = it % S, t = it % spw;
      hopper::mbar_wait<false>(full(s), (it / S) & 1);
      const long long rs = (long long)(w0 + it / spw) * L + b0 + (long long)t * R;
      const unsigned char* st = smem + (size_t)s * R * rb;
      // warp w: rows 2w, 2w + 1 of each 16 (a bin's owner is fixed: its row mod 16)
      for (int r = 2 * warp; r < R; r += 2 * CORE_WARPS) {
        if (rs + r >= N) break;  // later rows of the stage lie further past N
        float acc[P];
#pragma unroll
        for (int j = 0; j < P; ++j) acc[j] = 0.f;
        const uint4* x0 = reinterpret_cast<const uint4*>(st + (size_t)r * rb);
        const uint4* x1 = reinterpret_cast<const uint4*>(st + (size_t)(r + 1) * rb);
        for (int v = lane; v < vecs; v += 32) {
          const uint4 a = x0[v], b = x1[v];  // b past N: never folded
#pragma unroll
          for (int j = 0; j < QB; ++j) {
            const QS* qv = qs + (size_t)j * D + (size_t)v * M::PER_VEC;
            dot_vec(a, qv, acc[j], std::integral_constant<int, MODE>());
            dot_vec(b, qv, acc[QB + j], std::integral_constant<int, MODE>());
          }
        }
        const float sc = reduce_scatter<P>(acc, lane);
        const long long n = rs + r + my_row;
        const int o = my_q * bins + t * R + r + my_row;
        if (writer && n < N && sc > bv[o]) {
          bv[o] = sc;
          bi[o] = (int)n;
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * CORE_WARPS) : "memory");
    for (int i = threadIdx.x; i < QB * bins; i += 32 * CORE_WARPS) {
      const int q = i / bins;
      if (q0 + q < Q) {
        const long long o = ((long long)blockIdx.y * Q + q0 + q) * L + b0 + (i - q * bins);
        part_v[o] = bv[i];
        part_i[o] = bi[i];
      }
    }
  }
}

// ---- the wgmma body ---------------------------------------------------------------

constexpr int SLICE = 128;                  // bytes of a row a ring stage: one swizzle row
constexpr int BOX_ROWS = 64;                // rows of a TMA box: one warpgroup's wgmma M
constexpr int BOX_BYTES = BOX_ROWS * SLICE;  // 8 KB

// shared memory of the wgmma body (mirrored by ops/approx_topk.py: _mma_smem):
// 1024 bytes of alignment, the queries (hi and lo for fp32), the ring, the barriers
__host__ __device__ inline size_t mma_smem(int nq, int rb, int terms, int wg, int sps, int S) {
  return 1024 + (size_t)terms * nq * rb + (size_t)S * wg * sps * BOX_BYTES + (size_t)S * 16 + 16;
}

// d (64 x N, fp32) += a (64 x K, registers) . b (K x N, shared memory, K-major,
// 128-byte swizzle); scale_d == 0 starts the sums afresh
#define WG_TAIL_BF16 "p, 1, 1, 0"
#define WG_TAIL_TF32 "p, 1, 1"
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d,
                                          std::integral_constant<int, 1>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, " WG_TAIL_BF16 ";\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d,
                                          std::integral_constant<int, 0>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, " WG_TAIL_TF32 ";\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
#define WG_OUT16(d)                                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),    \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
      "+f"(d[15])
#define WG_OUT32(d)                                                                                  \
  WG_OUT16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),     \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_REGS32                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d,
                                          std::integral_constant<int, 1>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_REGS16 ", {%16, %17, %18, %19}, %20, "
      WG_TAIL_BF16 ";\n}\n"
      : WG_OUT16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d,
                                          std::integral_constant<int, 0>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_REGS16 ", {%16, %17, %18, %19}, %20, "
      WG_TAIL_TF32 ";\n}\n"
      : WG_OUT16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d,
                                          std::integral_constant<int, 1>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32 ", {%32, %33, %34, %35}, %36, "
      WG_TAIL_BF16 ";\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d,
                                          std::integral_constant<int, 0>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_REGS32 ", {%32, %33, %34, %35}, %36, "
      WG_TAIL_TF32 ";\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int MODE, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma N of 16, 32 or 64");
  if constexpr (N == 16) wgmma_n16(d, a, b, scale_d, std::integral_constant<int, MODE>());
  else if constexpr (N == 32) wgmma_n32(d, a, b, scale_d, std::integral_constant<int, MODE>());
  else wgmma_n64(d, a, b, scale_d, std::integral_constant<int, MODE>());
}

// keep a register's value where it is until here (wgmma reads its operands
// and writes its sums asynchronously, until the wait)
__device__ __forceinline__ void hold(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }
__device__ __forceinline__ void hold(float& x) { asm volatile("" : "+f"(x)::"memory"); }

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Stage the queries as wgmma's B operand (query rows, K-major, 128-byte
// swizzle; slice ks of every row in the region at qs + ks * TERMS * NQ *
// 128). The k order is permuted to match the A fragments (see the consumer
// loop): 32-bit word u of the 16 bytes that lane t reads from half c of a
// row's 128-byte slice sits in 16-byte chunk 4c + u, word t, of the query's
// slice. fp32 stores query n's TF32 hi part in row n of the region and its
// lo part in row NQ + n, so that one N = 2 NQ product takes both. Item i is
// vector v = 8 ks + i % 8 of row n = (i / 8) % NQ, ks = i / (8 NQ): a warp's
// lanes take one slice of four rows (whole 128-byte lines of each), whose
// stores land on distinct banks; 16 loads a thread are in flight at once.
template <int MODE, int NQ>
__device__ __forceinline__ void stage_queries(uint32_t qs, const unsigned char* __restrict__ queries,
                                              int q0, int Q, int rb, int tid, int nthreads) {
  constexpr int TERMS = MODE == 0 ? 2 : 1;
  constexpr int BATCH = 16;
  const int all = NQ * (rb / 16);
  for (int i0 = 0; i0 < all; i0 += BATCH * nthreads) {
    uint4 x[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * nthreads + tid;
      const int n = (i / 8) % NQ, v = 8 * (i / (8 * NQ)) + i % 8;
      x[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < all && q0 + n < Q)
        x[j] = *reinterpret_cast<const uint4*>(queries + (size_t)(q0 + n) * rb + (size_t)v * 16);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * nthreads + tid;
      if (i >= all) break;
      const int n = (i / 8) % NQ, ks = i / (8 * NQ), c = (i % 8) / 4, t = i % 4;
      const uint32_t row = qs + (uint32_t)((ks * TERMS * NQ + n) * SLICE);
      const uint32_t w[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t at = row + (uint32_t)((((4 * c + u) ^ (n % 8)) << 4) + 4 * t);
        if constexpr (MODE == 0) {
          uint32_t hi, lo;
          hopper::split(__uint_as_float(w[u]), hi, lo);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(hi) : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + (uint32_t)(NQ * SLICE)), "r"(lo) : "memory");
        } else {
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(w[u]) : "memory");
        }
      }
    }
  }
}

// grid (L / (64 WG), splits, query blocks of NQ). A ring stage is SPS
// K-slices of the slab's 64 WG rows (WG x SPS boxes, ~32 KB).
template <int MODE, int NQ, int WG, int SPS>
__global__ void __launch_bounds__(128 * WG + 32, 1) binmax_mma_kernel(
    const __grid_constant__ CUtensorMap tm, const unsigned char* __restrict__ queries,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int N, int D, int L, int W,
    int splits, int S) {
  constexpr int ELEM = MODE == 0 ? 4 : 2;
  constexpr int TERMS = MODE == 0 ? 2 : 1;
  constexpr int STAGE = WG * SPS * BOX_BYTES;
  constexpr int CONSUMERS = 128 * WG;
  constexpr int NA = NQ / 2;  // accumulator elements a thread
  // fp32: two sets of accumulators taking alternate slices, so that their
  // chains of dependent wgmmas run at once
  constexpr int PSETS = (MODE == 0 && SPS > 1) ? 2 : 1;
  static_assert(MODE == 1 || NQ <= 32, "fp32 takes hi and lo queries in one N = 2 NQ <= 64 product");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzled tiles: 1024-byte aligned
  const int rb = D * ELEM, KS = rb / SLICE, SPW = KS / SPS;  // slices a row, stages a window
  const uint32_t qs = base;
  const uint32_t ring = qs + (uint32_t)(TERMS * NQ * rb);
  const uint32_t bars = ring + (uint32_t)(S * STAGE);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t staged = bars + 16 * S;  // the queries are in
  const int b0 = blockIdx.x * BOX_ROWS * WG, q0 = blockIdx.z * NQ;
  int w0, w1;
  split_range(blockIdx.y, splits, W, w0, w1);
  const int total = (w1 - w0) * SPW;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), WG);  // one release from each warpgroup
    }
    hopper::mbar_init(staged, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {
    // ---- producer: stage it is slices [j0, j0 + SPS) of the slab's rows in
    // window w0 + it / SPW, j0 = (it % SPW) SPS; box (g, j) at (g SPS + j) BOX_BYTES
    if (threadIdx.x == CONSUMERS) {
      for (int it = 0; it < total; ++it) {
        const int s = it % S;
        const uint32_t ph = (it / S) & 1;
        // one stage on its way, then the rest once the queries are staged: the
        // ring's fill would otherwise queue the query loads behind it
        if (it == 1) hopper::mbar_wait<false>(staged, 0);
        hopper::mbar_wait<false>(empty(s), ph ^ 1);
        hopper::mbar_expect_tx(full(s), STAGE);
        const int row0 = (w0 + it / SPW) * L + b0, j0 = (it % SPW) * SPS;
        for (int g = 0; g < WG; ++g)
          for (int j = 0; j < SPS; ++j)
            hopper::tma_load(ring + (uint32_t)(s * STAGE + (g * SPS + j) * BOX_BYTES), &tm, (j0 + j) * (SLICE / ELEM),
                             row0 + BOX_ROWS * g, full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the slab
    const int tid = threadIdx.x % 128, wg = threadIdx.x / 128, wi = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    stage_queries<MODE, NQ>(qs, queries, q0, Q, rb, threadIdx.x, CONSUMERS);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    if (threadIdx.x == 0) hopper::mbar_arrive(staged);

    // part: one stage's sums (the tensor cores'); acc: the window's, added
    // stage by stage on the CUDA cores, rounded to nearest (the tensor cores
    // truncate each addition into their accumulator: 3 D / 8 of them a
    // window in fp32 would cost ~5e-6 at a score of 1)
    // bf16: part2 = a . q (N = NQ). fp32 (3xTF32): part2 = a_hi . [q_hi | q_lo]
    // (N = 2 NQ: columns [0, NQ) a_hi q_hi, [NQ, 2 NQ) a_hi q_lo) and part1 =
    // a_lo . q_hi (N = NQ); element e of part1 and elements e and e + NA of
    // part2 are the same (row, query)
    constexpr int N2 = MODE == 0 ? 2 * NQ : NQ;
    float part2[PSETS][N2 / 2], part1[PSETS][NA], acc[NA], best[NA];
    int bid[NA];
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      acc[e] = 0.f;
      best[e] = -INFINITY;
      bid[e] = -1;
    }
#pragma unroll
    for (int p = 0; p < PSETS; ++p) {
#pragma unroll
      for (int e = 0; e < N2 / 2; ++e) part2[p][e] = 0.f;
#pragma unroll
      for (int e = 0; e < NA; ++e) part1[p][e] = 0.f;
    }
    // this thread's rows of the box: r_lo and r_lo + 8 (both r_lo mod 8 = g)
    const int r_lo = 16 * wi + g;
    const uint32_t off0 = (uint32_t)(r_lo * SLICE), off1 = (uint32_t)((r_lo + 8) * SLICE);
    // A fragments of two slices (x = j & 1): slice j + 2 loads into the
    // registers of slice j once its products are done, while j + 1's run.
    // a[x][kk]: k-step kk = 2c + h of the slice, words (x, y) of half c for
    // h = 0, (z, w) for h = 1; fp32 splits them into ah (TF32 hi) and al (lo)
    uint32_t a[2][4][4], ah[2][4][4], al[2][4][4];
    for (int it = 0; it < total; ++it) {
      const int s = it % S, j0 = (it % SPW) * SPS;
      hopper::mbar_wait<false>(full(s), (it / S) & 1);
#pragma unroll
      for (int j = 0; j < SPS; ++j) {
        const int x = j & 1;
        if (j >= 2) {
          hopper::wgmma_wait<1>();  // slice j - 2's products are done: its registers are free
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (MODE == 1) hold(a[x][kk][e]);
              else {
                hold(ah[x][kk][e]);
                hold(al[x][kk][e]);
              }
            }
        }
        const uint32_t tile = ring + (uint32_t)(s * STAGE + (wg * SPS + j) * BOX_BYTES);
        uint4 xg[2], xh[2];  // half c of the slice: lane t's 16 bytes of rows r_lo, r_lo + 8
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t sw = (uint32_t)(((4 * c + t) ^ g) << 4);
          xg[c] = lds128(tile + off0 + sw);
          xh[c] = lds128(tile + off1 + sw);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          a[x][2 * c][0] = xg[c].x; a[x][2 * c][1] = xh[c].x; a[x][2 * c][2] = xg[c].y; a[x][2 * c][3] = xh[c].y;
          a[x][2 * c + 1][0] = xg[c].z; a[x][2 * c + 1][1] = xh[c].z;
          a[x][2 * c + 1][2] = xg[c].w; a[x][2 * c + 1][3] = xh[c].w;
        }
        const uint32_t qrow = qs + (uint32_t)((j0 + j) * TERMS * NQ * SLICE);
        float (&p2)[N2 / 2] = part2[j % PSETS];
        if constexpr (MODE == 1) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) hold(a[x][kk][e]);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<MODE, N2>(p2, a[x][kk], hopper::desc(qrow + kk * 32, 16, 1024), j >= PSETS || kk > 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              hopper::split(__uint_as_float(a[x][kk][e]), ah[x][kk][e], al[x][kk][e]);
              hold(ah[x][kk][e]);
              hold(al[x][kk][e]);
            }
          float (&p1)[NA] = part1[j % PSETS];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t d = hopper::desc(qrow + kk * 32, 16, 1024);  // rows [0, NQ): hi, [NQ, 2 NQ): lo
            wgmma_rs<MODE, N2>(p2, ah[x][kk], d, j >= PSETS || kk > 0);
            wgmma_rs<MODE, NQ>(p1, al[x][kk], d, j >= PSETS || kk > 0);
          }
        }
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (MODE == 1) hold(a[y][kk][e]);
            else {
              hold(ah[y][kk][e]);
              hold(al[y][kk][e]);
            }
          }
#pragma unroll
      for (int e = 0; e < NA; ++e) {
        float v = 0.f;
#pragma unroll
        for (int p = 0; p < PSETS; ++p) {
          hold(part2[p][e]);
          float t = part2[p][e];
          if constexpr (MODE == 0) {
            hold(part2[p][e + NA]);
            hold(part1[p][e]);
            t = (part2[p][e + NA] + part1[p][e]) + t;  // the small terms first
          }
          v = p == 0 ? t : v + t;
        }
        acc[e] = j0 == 0 ? v : acc[e] + v;
      }
      if (tid == 0) hopper::mbar_arrive(empty(s));  // this warpgroup is done with the stage
      if (j0 + SPS == KS) {
        // the window's sums are whole: fold them. acc[4 jj + e] (as wgmma's
        // accumulator): row r_lo (+8 for e >= 2), query 8 jj + 2 t (+1 for odd e)
        const long long row = (long long)(w0 + it / SPW) * L + b0 + BOX_ROWS * wg + r_lo;
#pragma unroll
        for (int e = 0; e < NA; ++e) {
          const long long n = row + 8 * ((e >> 1) & 1);
          if (n < N && acc[e] > best[e]) {
            best[e] = acc[e];
            bid[e] = (int)n;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      const int q = q0 + 8 * (e / 4) + 2 * t + (e & 1);
      if (q < Q) {
        const long long o = ((long long)blockIdx.y * Q + q) * L + b0 + BOX_ROWS * wg + r_lo + 8 * ((e >> 1) & 1);
        part_v[o] = best[e];
        part_i[o] = bid[e];
      }
    }
  }
}

// ---- the merge of the splits (binmax's bins) --------------------------------------

constexpr int MERGE_THREADS = 256;

__global__ void __launch_bounds__(MERGE_THREADS) binmax_merge_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_i, float* __restrict__ out_v,
    int* __restrict__ out_i, long long QL, int splits) {
  const long long i = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
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

// ---- the selection over the bins -------------------------------------------------

constexpr int SEL_THREADS = 512;
constexpr int SEL_EPT = 16;                        // elements a thread
constexpr int SEL_CAP = SEL_THREADS * SEL_EPT;     // elements a block: 8,192
constexpr int K_MAX = 256;
constexpr int MERGE_BATCH = 8;                     // split maxima loaded at once

// (score desc, id asc) as one unsigned order: the score's bits made monotonic
// (-0 as +0: equal scores tie, as in torch.sort), then ~id
__device__ __forceinline__ unsigned long long sel_key(float v, int id) {
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (uint32_t)~(uint32_t)id;
}

// grid (Q, chunks). Block (q, c) takes elements [c C, c C + C) of query q's
// M: each element's best over `splits` maxima (split s at src + s *
// split_stride; the first strictly greater wins, as the merge kernel does),
// then its top min(k, C) by key, written at out + (q chunks + c) * min(k, C):
// ranked when there is one chunk (the final answer), as found otherwise (the
// candidates of a last launch); a chunk of fewer elements pads (-inf, -1).
__global__ void __launch_bounds__(SEL_THREADS) select_kernel(
    const float* __restrict__ src_v, const int* __restrict__ src_i, long long split_stride,
    int splits, int M, int C, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ unsigned hist[256];
  __shared__ unsigned long long lk[K_MAX];
  __shared__ float lv[K_MAX];
  __shared__ int s_digit, s_slot;
  __shared__ unsigned s_above, s_cnt;
  const int q = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int e0 = c * C, count = min(C, M - e0);
  const int kk = min(k, C), kout = min(kk, count);
  const float* sv = src_v + (long long)q * M + e0;
  const int* si = src_i + (long long)q * M + e0;

  unsigned long long key[SEL_EPT];
  float val[SEL_EPT];
  unsigned valid = 0;
#pragma unroll
  for (int j = 0; j < SEL_EPT; ++j) {
    const int e = j * SEL_THREADS + tid;
    key[j] = 0ull;
    val[j] = 0.f;
    if (e < count) {
      float v = sv[e];
      int id = si[e];
      for (int s0 = 1; s0 < splits; s0 += MERGE_BATCH) {
        float w[MERGE_BATCH];
        int wi[MERGE_BATCH];
#pragma unroll
        for (int u = 0; u < MERGE_BATCH; ++u)
          if (s0 + u < splits) {
            w[u] = sv[(s0 + u) * split_stride + e];
            wi[u] = si[(s0 + u) * split_stride + e];
          }
#pragma unroll
        for (int u = 0; u < MERGE_BATCH; ++u)
          if (s0 + u < splits && w[u] > v) {
            v = w[u];
            id = wi[u];
          }
      }
      if (id >= 0) {  // a pad of a first launch's short chunk is no candidate
        key[j] = sel_key(v, id);
        val[j] = v;
        valid |= 1u << j;
      }
    }
  }

  // radix select of the kout largest keys, 8 bits a pass from the top
  unsigned long long prefix = 0ull, mask = 0ull;
  unsigned need = (unsigned)kout;
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0u;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SEL_EPT; ++j) {
      if (j * SEL_THREADS >= count) break;  // uniform: no slot of this round holds an element
      // one atomic a digit a warp: the first passes put most keys in one bucket
      const bool in = ((valid >> j) & 1u) && (key[j] & mask) == prefix;
      const unsigned d = in ? (unsigned)(key[j] >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(FULL, d);
      if (in && (tid & 31) == __ffs(peers) - 1) atomicAdd(&hist[d], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      unsigned c8 = 0u;  // buckets 8 tid .. 8 tid + 7
#pragma unroll
      for (int b = 0; b < 8; ++b) c8 += hist[8 * tid + b];
      unsigned suf = c8;  // the count in this lane's buckets and every higher one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_down_sync(FULL, suf, o);
        if (tid + o < 32) suf += y;
      }
      const int top = 31 - __clz(__ballot_sync(FULL, suf >= need));
      if (tid == top) {
        unsigned above = suf - c8;
        for (int b = 7; b >= 0; --b) {
          const unsigned h = hist[8 * tid + b];
          if (above + h >= need) {
            s_digit = 8 * tid + b;
            s_above = above;
            s_cnt = h;
            break;
          }
          above += h;
        }
      }
    }
    __syncthreads();
    need -= s_above;
    prefix |= (unsigned long long)s_digit << shift;
    mask |= 255ull << shift;
    if (s_cnt == need) break;  // the bucket holds exactly what is still needed
  }

  // the kout keys at or above the prefix (keys are unique: ids are)
  if (tid == 0) s_slot = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SEL_EPT; ++j)
    if (((valid >> j) & 1u) && (key[j] & mask) >= prefix) {
      const int slot = atomicAdd(&s_slot, 1);
      lk[slot] = key[j];
      lv[slot] = val[j];
    }
  __syncthreads();
  float* ov = out_v + ((long long)q * gridDim.y + c) * kk;
  int* oi = out_i + ((long long)q * gridDim.y + c) * kk;
  const bool ranked = gridDim.y == 1;
  for (int i = tid; i < kk; i += SEL_THREADS) {
    if (i < kout) {
      const unsigned long long me = lk[i];
      int at = i;
      if (ranked) {
        at = 0;
        for (int j = 0; j < kout; ++j) at += lk[j] > me;
      }
      ov[at] = lv[i];
      oi[at] = (int)~(uint32_t)me;
    } else {
      ov[i] = -INFINITY;
      oi[i] = -1;
    }
  }
}

// ---- host side ---------------------------------------------------------------------

template <int MODE, int QB>
cudaError_t launch_core_qb(const void* q, const void* index, float* pv, int* pi, int Q, int N, int D,
                           int L, int W, int splits, int bins, int R, int S, cudaStream_t stream) {
  const size_t smem = core_layout(QB, D, Mode<MODE>::ELEM, bins, R, S).total;
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = binmax_core_kernel<MODE, QB>;
  static cudaError_t set = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (set != cudaSuccess) return set;
  dim3 grid(L / bins, splits, (Q + QB - 1) / QB);
  kern<<<grid, CORE_THREADS, smem, stream>>>(static_cast<const unsigned char*>(q),
                                             static_cast<const unsigned char*>(index), pv, pi, Q, N, D,
                                             L, W, splits, bins, R, S);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_core(const void* q, const void* index, float* pv, int* pi, int Q, int N, int D, int L,
                        int W, int splits, int qb, int bins, int R, int S, cudaStream_t stream) {
  if ((bins != 16 && bins != 32 && bins != 64 && bins != 128) || L % bins != 0 || R < 16 ||
      R % 16 != 0 || bins % R != 0 || S < 1 || (Q + qb - 1) / qb > 65535)
    return cudaErrorInvalidValue;
  switch (qb) {
    case 1: return launch_core_qb<MODE, 1>(q, index, pv, pi, Q, N, D, L, W, splits, bins, R, S, stream);
    case 2: return launch_core_qb<MODE, 2>(q, index, pv, pi, Q, N, D, L, W, splits, bins, R, S, stream);
    case 4: return launch_core_qb<MODE, 4>(q, index, pv, pi, Q, N, D, L, W, splits, bins, R, S, stream);
    case 8: return launch_core_qb<MODE, 8>(q, index, pv, pi, Q, N, D, L, W, splits, bins, R, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE, int NQ, int WG, int SPS>
cudaError_t launch_mma_cfg(const CUtensorMap& tm, const void* q, float* pv, int* pi, int Q, int N, int D,
                           int L, int W, int splits, int S, cudaStream_t stream) {
  const int rb = D * (MODE == 0 ? 4 : 2);
  const size_t smem = mma_smem(NQ, rb, MODE == 0 ? 2 : 1, WG, SPS, S);
  const int qz = (Q + NQ - 1) / NQ;
  if (smem > (size_t)SMEM_MAX || qz > 65535 || (rb / SLICE) % SPS != 0) return cudaErrorInvalidValue;
  auto kern = binmax_mma_kernel<MODE, NQ, WG, SPS>;
  static cudaError_t set = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (set != cudaSuccess) return set;
  kern<<<dim3(L / (BOX_ROWS * WG), splits, qz), 128 * WG + 32, smem, stream>>>(
      tm, static_cast<const unsigned char*>(q), pv, pi, Q, N, D, L, W, splits, S);
  return cudaGetLastError();
}

// bins 64 or 128 (one or two warpgroups), SPS = 4 / warpgroups slices a
// stage, or 1 where the row's slices do not divide by it
template <int MODE, int NQ>
cudaError_t launch_mma_nq(const CUtensorMap& tm, const void* q, float* pv, int* pi, int Q, int N, int D,
                          int L, int W, int splits, int bins, int sps, int S, cudaStream_t stream) {
  if (bins == 64 && sps == 4)
    return launch_mma_cfg<MODE, NQ, 1, 4>(tm, q, pv, pi, Q, N, D, L, W, splits, S, stream);
  if (bins == 64 && sps == 1)
    return launch_mma_cfg<MODE, NQ, 1, 1>(tm, q, pv, pi, Q, N, D, L, W, splits, S, stream);
  if (bins == 128 && sps == 2)
    return launch_mma_cfg<MODE, NQ, 2, 2>(tm, q, pv, pi, Q, N, D, L, W, splits, S, stream);
  if (bins == 128 && sps == 1)
    return launch_mma_cfg<MODE, NQ, 2, 1>(tm, q, pv, pi, Q, N, D, L, W, splits, S, stream);
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t launch_mma(const void* q, const void* index, float* pv, int* pi, int Q, int N, int D, int L,
                       int W, int splits, int qb, int bins, int sps, int S, cudaStream_t stream) {
  constexpr int ELEM = MODE == 0 ? 4 : 2;
  if ((D * ELEM) % SLICE != 0 || L % bins != 0 || S < 1 || reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap tm;
  if (!hopper::tensor_map_of(&tm, MODE == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             ELEM, index, D, N, SLICE / ELEM, BOX_ROWS))
    return cudaErrorInvalidValue;
  switch (qb) {
    case 16: return launch_mma_nq<MODE, 16>(tm, q, pv, pi, Q, N, D, L, W, splits, bins, sps, S, stream);
    case 32: return launch_mma_nq<MODE, 32>(tm, q, pv, pi, Q, N, D, L, W, splits, bins, sps, S, stream);
    case 64:
      if constexpr (MODE == 1)
        return launch_mma_nq<MODE, 64>(tm, q, pv, pi, Q, N, D, L, W, splits, bins, sps, S, stream);
      return cudaErrorInvalidValue;  // fp32 queries: at most 32 a block (hi and lo, N = 2 NQ)
    default: return cudaErrorInvalidValue;
  }
}

// the bin-max launch into (splits, Q, L) partials (out itself when splits == 1)
int binmax_launch(const void* queries, const void* index, float* pv, int* pi, int Q, int N, int D, int L,
                  int index_dtype, int body, int qb, int bins, int splits, int rows, int stages,
                  cudaStream_t st) {
  const int elem = index_dtype == 0 ? 4 : 2;
  const int W = (int)(((long long)N + L - 1) / L);
  if (Q < 1 || N < 1 || D < 1 || (index_dtype != 0 && index_dtype != 1) || (D * elem) % 16 != 0 ||
      D * elem > MAX_ROW_BYTES || L < 128 || L % 128 != 0 || L > N || splits < 1 || splits > W ||
      splits > 65535 || reinterpret_cast<uintptr_t>(index) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(queries) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (body == MMA_BODY)
    err = index_dtype == 0
              ? launch_mma<0>(queries, index, pv, pi, Q, N, D, L, W, splits, qb, bins, rows, stages, st)
              : launch_mma<1>(queries, index, pv, pi, Q, N, D, L, W, splits, qb, bins, rows, stages, st);
  else if (body == CORE_BODY)
    err = index_dtype == 0 ? launch_core<0>(queries, index, pv, pi, Q, N, D, L, W, splits, qb, bins, rows, stages, st)
                           : launch_core<1>(queries, index, pv, pi, Q, N, D, L, W, splits, qb, bins, rows, stages, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

int select_launch(const float* pv, const int* pi, float* out_v, int* out_i, float* cand_v, int* cand_i,
                  int Q, int L, int splits, int k, int chunk, cudaStream_t st) {
  const int chunks = (L + chunk - 1) / chunk;
  if (Q < 1 || L < 1 || k < 1 || k > K_MAX || k > L || splits < 1 || chunk < 1 || chunk > SEL_CAP ||
      chunks > 65535 || (chunks > 1 && (long long)chunks * min(k, chunk) > SEL_CAP))
    return (int)cudaErrorInvalidValue;
  const long long QL = (long long)Q * L;
  if (chunks == 1) {
    select_kernel<<<dim3(Q, 1), SEL_THREADS, 0, st>>>(pv, pi, QL, splits, L, L, k, out_v, out_i);
    return (int)cudaGetLastError();
  }
  const int kk = min(k, chunk), M2 = chunks * kk;
  select_kernel<<<dim3(Q, chunks), SEL_THREADS, 0, st>>>(pv, pi, QL, splits, L, chunk, k, cand_v, cand_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_kernel<<<dim3(Q, 1), SEL_THREADS, 0, st>>>(cand_v, cand_i, 0, 1, M2, M2, k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// queries (Q, D) in the index's type (index_dtype 0 = float32, 1 = bfloat16),
// both 16-byte aligned, rows of a multiple of 16 bytes up to 4,096; out_v
// (Q, L) fp32, out_i (Q, L) int32; part_v / part_i (splits, Q, L) scratch,
// unused when splits == 1. body 0 = cuda_core (qb 1, 2, 4 or 8 queries a
// block, slabs of `bins` 16-128, `rows` a ring stage, `stages` of them), 1 =
// wgmma (qb 16, 32 or 64 queries a block, bins 64 or 128, `rows` 128-byte
// K-slices a stage, `stages` of them), the plan of ops/approx_topk.py
// binmax_plan.
// L a multiple of 128, L <= N; at most 65,535 splits and query blocks.
// With splits > 1 a second launch merges the splits into out.
extern "C" int binmax_fwd(const void* queries, const void* index, void* out_v, void* out_i,
                          void* part_v, void* part_i, int Q, int N, int D, int L, int index_dtype,
                          int body, int qb, int bins, int splits, int rows, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool direct = splits == 1;
  float* pv = static_cast<float*>(direct ? out_v : part_v);
  int* pi = static_cast<int*>(direct ? out_i : part_i);
  const int rc = binmax_launch(queries, index, pv, pi, Q, N, D, L, index_dtype, body, qb, bins, splits,
                               rows, stages, st);
  if (rc != 0 || direct) return rc;
  const long long QL = (long long)Q * L;
  binmax_merge_kernel<<<(unsigned)((QL + MERGE_THREADS - 1) / MERGE_THREADS), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), static_cast<float*>(out_v),
      static_cast<int*>(out_i), QL, splits);
  return (int)cudaGetLastError();
}

// The top k (1 <= k <= 256, k <= L) of each query's L bins, given as
// (splits, Q, L) maxima and ids (merged here in split order): scores (Q, k)
// fp32 descending and ids (Q, k) int32, ties to the lower id. chunk = L takes
// one launch (L <= 8,192); a smaller chunk two, the first writing each
// chunk's best min(k, chunk) into cand_v / cand_i (Q, ceil(L / chunk),
// min(k, chunk)), at most 8,192 a query.
extern "C" int select_fwd(const void* part_v, const void* part_i, void* out_v, void* out_i,
                          void* cand_v, void* cand_i, int Q, int L, int splits, int k, int chunk,
                          void* stream) {
  return select_launch(static_cast<const float*>(part_v), static_cast<const int*>(part_i),
                       static_cast<float*>(out_v), static_cast<int*>(out_i), static_cast<float*>(cand_v),
                       static_cast<int*>(cand_i), Q, L, splits, k, chunk, static_cast<cudaStream_t>(stream));
}

// The approximate search after the query's normalization: the bin-max launch
// into part_v / part_i (splits, Q, L), then the selection (select_fwd) into
// out_v / out_i (Q, k).
extern "C" int approx_fwd(const void* queries, const void* index, void* out_v, void* out_i,
                          void* part_v, void* part_i, void* cand_v, void* cand_i, int Q, int N, int D,
                          int L, int index_dtype, int body, int qb, int bins, int splits, int rows,
                          int stages, int k, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  const int rc = binmax_launch(queries, index, pv, pi, Q, N, D, L, index_dtype, body, qb, bins, splits,
                               rows, stages, st);
  if (rc != 0) return rc;
  return select_launch(pv, pi, static_cast<float*>(out_v), static_cast<int*>(out_i),
                       static_cast<float*>(cand_v), static_cast<int*>(cand_i), Q, L, splits, k, chunk, st);
}
