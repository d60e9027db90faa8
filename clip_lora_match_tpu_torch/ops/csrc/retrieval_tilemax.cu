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
//   in fp32) or in int32 (int8 x int8, exact). The int8 score is
//   float(int32 dot) * scale[row]: the per-row index scale applied in fp32
//   after the conversion, the per-query scale NOT applied, so the maxima equal
//   the fp32 rescoring of the candidates bit for bit (D <= 1024 keeps every
//   sum below 2^24). Rows at or past N count as zero rows and score 0, as the
//   JAX package's zero padding to a tile multiple does.
// Layout (the port's own; the TPU kernels' 2,048-row blocks, ragged tail and
//   transposed outputs came from Mosaic's tiling): tile maxima (Q, nt) with
//   nt = ceil(N / tile), group maxima (Q, ng) with ng = ceil(nt / group); the
//   last group covers the tiles that exist.
// What bounds it on the H100: bytes, once the index is read once per query
//   batch. N*D*4 bytes fp32 (half for bf16, a quarter for int8) against
//   2*Q*N*D operations: at Q = 64 bf16 and int8 products on the tensor cores
//   take a fifth of the byte time, fp32 as 3xTF32 about two thirds.
// Two bodies, chosen by the host's plan (ops/retrieval_topk.py
// tilemax_plan) the same way for all three index types:
// - cuda_core (Q <= 8, or a tile other than 8 and 16, or rows not of whole
//   64-byte k-chunks; int8 by __dp4a): a block of 8 warps owns `tpb`
//   consecutive tiles (one group when group maxima are asked for, else 16)
//   and a block of QB <= 8 queries, staged in shared memory (bf16 and int8
//   queries in their own type, so that one conflict-free 16-byte shared
//   load meets each 16-byte index vector). A warp walks its tiles row by
//   row: each lane loads 16-byte vectors of the row (coalesced across the
//   warp) and multiplies them with the staged queries on the CUDA cores; a
//   reduce-scatter butterfly leaves each query's row score in 32/QB lanes,
//   which fold it into that query's running tile maximum. The block then
//   takes the group maximum from the tile maxima it holds in shared memory,
//   so the (Q, nt) array is never read back, as on the TPU. At Q = 1 this
//   runs at the byte bound; at Q > 8 it would read the index once per 8
//   queries.
// - mma (Q > 8, tile 8 or 16, rows a multiple of 64 bytes): a block of 8
//   warps keeps up to 64 queries in shared memory for its lifetime, so Q <=
//   64 reads the index once. The index takes no shared memory: a warp loads
//   its 16-row fragments (one m16 fragment is one 16-row tile) straight
//   from global memory into mma A fragments, each lane 16 contiguous bytes
//   of a row (4 lanes cover 64 bytes: one k-chunk), and keeps 4 k-chunks of
//   2 fragments in registers, 3 in flight (6 KB a warp, 48 KB an SM). The
//   sum over D does not depend on order, so K is permuted the same way in
//   both operands: the 16 bytes a lane holds feed two mma k-steps, and the
//   query B fragments are read from shared memory as one 16-byte load per
//   (k-chunk, 8 queries), rows padded to a stride of 64 mod 128 bytes so
//   those loads are free of bank conflicts. bf16 runs mma.sync m16n8k16
//   (exact products, fp32 sums); int8 runs m16n8k32 (the same fragment map
//   in 32-bit words, so a k-chunk is 64 values; exact int32 sums, each
//   turned into float(sum) * scale[row] before the round's maxima, with the
//   scales of a lane's rows loaded as the round's first k-chunk is
//   computed); fp32 runs 3xTF32 on m16n8k8 (hopper::split; the lo.lo
//   product dropped, ~2^-22 relative), the index split once per k-chunk for
//   all query tiles, each query fragment split once for both row fragments.
//   A block walks its rows in rounds of 256 (8 warps x 2 fragments); after
//   each round the tile maxima (per query column: the max of a lane's two
//   rows, then xor shuffles over the 8 row groups) go to a double-buffered
//   shared stage, one barrier, and the block writes them out as runs of
//   contiguous tiles per query and folds them into running group maxima (a
//   block owns whole groups). The loads of the next round are issued before
//   that barrier. Row ranges are whole units (256 rows, or the lcm of 256
//   and a group's rows), split evenly over a grid sized to the SMs.

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
constexpr int PLAIN_TILES_PER_BLOCK = 16;

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
  const size_t row_bytes = (size_t)D * M::ELEM;
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

// ---- the mma body ------------------------------------------------------------

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int RF = 2;                          // 16-row fragments a warp holds at once
constexpr int ROUND_ROWS = MMA_WARPS * RF * 16;  // rows of one round of a block
constexpr int STAGES = 4;                      // k-chunks in registers (STAGES - 1 in flight)
constexpr int CHUNK = 64;                      // bytes of a row per k-chunk: 4 lanes x 16 B
constexpr int MMA_BODY = 1;

// the maximum of the first K values over the 8 row groups of a warp (lanes
// that share lane % 4)
template <int K>
__device__ __forceinline__ void xor_max(float (&m)[4]) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < K; ++e) m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], o));
}

// a stage's row stride in floats: tiles per round + 1 (conflict-free columns)
__host__ __device__ constexpr int mma_stage_stride(int tile) { return ROUND_ROWS / tile + 1; }

// shared memory of the mma body: QB staged query rows, then two stages of
// QB x (tiles per round + 1) tile maxima
__host__ __device__ constexpr size_t mma_smem(int QB, int row_bytes, int tile) {
  return (size_t)QB * mma_ldq(row_bytes) + 2 * sizeof(float) * QB * mma_stage_stride(tile);
}

// MODE 0: fp32 index (3xTF32 on m16n8k8); 1: bf16 index (m16n8k16); 2: int8
// index (m16n8k32, scaled by `scales` per row). NT query tiles of 8: QB = 8 *
// NT queries a block (blockIdx.y).
template <int MODE, int NT>
__global__ void __launch_bounds__(MMA_THREADS, 1) tilemax_mma_kernel(
    const unsigned char* __restrict__ queries, const unsigned char* __restrict__ index,
    const float* __restrict__ scales, float* __restrict__ tmax, float* __restrict__ gmax, int Q,
    int N, int D, int tile, int group, int nt, int ng, int unit_rows, long long units) {
  using Acc = typename Mode<MODE>::Acc;
  constexpr int QB = 8 * NT;
  const int row_bytes = D * Mode<MODE>::ELEM;
  const int ldq = mma_ldq(row_bytes);
  const int nc = row_bytes / CHUNK;  // k-chunks per row
  const int tpr = ROUND_ROWS / tile;  // tiles per round: 16 or 32
  const int lds = mma_stage_stride(tile);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;
  float* stage = reinterpret_cast<float*>(smem + (size_t)QB * ldq);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.y * QB;

  // the query block, staged once; rows past Q are zero
  const int vecs = row_bytes / 16;
  for (int i = tid; i < QB * vecs; i += MMA_THREADS) {
    const int r = i / vecs, v = i - r * vecs;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Q) x = *reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * row_bytes + v * 16);
    *reinterpret_cast<uint4*>(qs + (size_t)r * ldq + v * 16) = x;
  }

  // this block's rows: whole units, split evenly over the grid
  const long long u0 = blockIdx.x * units / gridDim.x, u1 = (blockIdx.x + 1) * units / gridDim.x;
  const long long row0 = u0 * unit_rows;
  const long long row_end = min(u1 * unit_rows, (long long)nt * tile);
  const int tile0 = (int)(row0 / tile), tile_end = (int)(row_end / tile);
  const int rounds = (int)((row_end - row0 + ROUND_ROWS - 1) / ROUND_ROWS);
  const int total = rounds * nc;
  __syncthreads();

  // A fragments: a[s][f][h] is the 16 bytes of row (f * 16 + h * 8 + g) of
  // this warp's 32 rows at k-chunk bytes [16 t, 16 t + 16)
  uint4 a[STAGES][RF][2];
  int ld_r = 0, ld_c = 0;
  const long long warp_row = row0 + warp * (RF * 16) + g;
  auto load = [&](uint4 (&dst)[RF][2]) {
    const long long r0 = warp_row + (long long)ld_r * ROUND_ROWS;
#pragma unroll
    for (int f = 0; f < RF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + f * 16 + h * 8;
        dst[f][h] = make_uint4(0u, 0u, 0u, 0u);  // a pad row: zero, scores 0
        if (ld_r < rounds && row < N) dst[f][h] = ld_stream(index + row * row_bytes + ld_c * CHUNK + t * 16);
      }
    if (++ld_c == nc) {
      ld_c = 0;
      ++ld_r;
    }
  };

  Acc acc[RF][NT][4];
#pragma unroll
  for (int f = 0; f < RF; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;

  // int8: the scales of rows g and g + 8 of each fragment of round r, loaded
  // as the round's first k-chunk is computed: nc - 1 chunks ahead of the
  // epilogue, and before the next round's, so one set serves any nc. Rows at
  // or past N (zero fragments, sums 0) read no scale.
  float sc[RF][2];
  auto load_scales = [&](int r) {
    const long long r0 = warp_row + (long long)r * ROUND_ROWS;
#pragma unroll
    for (int f = 0; f < RF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + f * 16 + h * 8;
        sc[f][h] = row < N ? __ldg(scales + row) : 0.f;
      }
  };

  // one k-chunk: 2 mma k-steps per fragment and query tile. The words
  // {x, y, z, w} of a lane's 16 bytes of a row are k-step 0's A columns
  // (2t | 4t | t) and (2t + 8 | 4t + 16 | t + 4) in x and y, k-step 1's in z
  // and w (bf16 | int8 | fp32); the same words of its 16 bytes of a query row
  // are B at the same k.
  auto compute = [&](const uint4 (&src)[RF][2], int c) {
    const unsigned char* qrow = qs + (size_t)g * ldq + c * CHUNK + t * 16;
    if constexpr (MODE != 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 b = *reinterpret_cast<const uint4*>(qrow + (size_t)j * 8 * ldq);
#pragma unroll
        for (int f = 0; f < RF; ++f) {
          const uint32_t a0[4] = {src[f][0].x, src[f][1].x, src[f][0].y, src[f][1].y};
          const uint32_t a1[4] = {src[f][0].z, src[f][1].z, src[f][0].w, src[f][1].w};
          if constexpr (MODE == 1) {
            hopper::mma_bf16(acc[f][j], a0, b.x, b.y);
            hopper::mma_bf16(acc[f][j], a1, b.z, b.w);
          } else {
            hopper::mma_s8(acc[f][j], a0, b.x, b.y);
            hopper::mma_s8(acc[f][j], a1, b.z, b.w);
          }
        }
      }
    } else {
      uint32_t ah[RF][2][4], al[RF][2][4];
#pragma unroll
      for (int f = 0; f < RF; ++f) {
        const uint32_t w[2][4] = {{src[f][0].x, src[f][1].x, src[f][0].y, src[f][1].y},
                                  {src[f][0].z, src[f][1].z, src[f][0].w, src[f][1].w}};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) hopper::split(__uint_as_float(w[h][e]), ah[f][h][e], al[f][h][e]);
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
        for (int f = 0; f < RF; ++f)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            hopper::mma_tf32(acc[f][j], ah[f][h], bl[2 * h], bl[2 * h + 1]);
            hopper::mma_tf32(acc[f][j], al[f][h], bh[2 * h], bh[2 * h + 1]);
            hopper::mma_tf32(acc[f][j], ah[f][h], bh[2 * h], bh[2 * h + 1]);
          }
      }
    }
  };

  float gbest = -INFINITY;  // threads tid < QB: the running maximum of the open group
  // the end of a round: tile maxima to the stage, one barrier, runs to tmax,
  // group maxima folded by one thread per query
  auto epilogue = [&](int r) {
    float* st = stage + (size_t)(r & 1) * QB * lds;
#pragma unroll
    for (int f = 0; f < RF; ++f) {
      const int frag = warp * RF + f;  // fragment of the round
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // c[0], c[1]: row g, query columns 2t, 2t + 1; c[2], c[3]: row g + 8.
        // int8: float(sum) * scale[row], one rounding, as the plain version
        float c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (MODE == 2) c[e] = __int2float_rn(acc[f][j][e]) * sc[f][e >> 1];
          else c[e] = acc[f][j][e];
        }
        float m[4];
        if (tile == 16) {
          m[0] = fmaxf(c[0], c[2]);
          m[1] = fmaxf(c[1], c[3]);
          xor_max<2>(m);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e] = c[e];
          xor_max<4>(m);
        }
        if (g == j) {  // each row group writes one query tile's maxima
          float* col = st + (size_t)(8 * j + 2 * t) * lds;
          if (tile == 16) {
            col[frag] = m[0];
            col[lds + frag] = m[1];
          } else {  // two 8-row tiles per fragment
            col[2 * frag] = m[0];
            col[lds + 2 * frag] = m[1];
            col[2 * frag + 1] = m[2];
            col[lds + 2 * frag + 1] = m[3];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;
      }
    }
    __syncthreads();
    const int tr0 = tile0 + r * tpr;
    for (int i = tid; i < QB * tpr; i += MMA_THREADS) {
      const int q = i / tpr, tt = i - q * tpr;
      if (q0 + q < Q && tr0 + tt < tile_end) tmax[(long long)(q0 + q) * nt + tr0 + tt] = st[q * lds + tt];
    }
    if (gmax != nullptr && tid < QB && q0 + tid < Q) {
      for (int tt = 0; tt < tpr && tr0 + tt < tile_end; ++tt) {
        const int tg = tr0 + tt;
        gbest = fmaxf(gbest, st[tid * lds + tt]);
        if ((tg + 1) % group == 0 || tg + 1 == tile_end) {
          gmax[(long long)(q0 + tid) * ng + tg / group] = gbest;
          gbest = -INFINITY;
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES; ++s) load(a[s]);
  int cur_c = 0, cur_r = 0;
  for (int i0 = 0; i0 < total; i0 += STAGES) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      if (i0 + s < total) {  // uniform across the block
        if constexpr (MODE == 2) {
          if (cur_c == 0) load_scales(cur_r);
        }
        compute(a[s], cur_c);
        load(a[s]);  // the chunk STAGES ahead, into the registers just used
        if (++cur_c == nc) {
          epilogue(cur_r);
          cur_c = 0;
          ++cur_r;
        }
      }
    }
  }
}

template <int MODE, int NT>
cudaError_t launch_mma_nt(const void* q, const void* index, const float* scales, float* tmax,
                          float* gmax, int Q, int N, int D, int tile, int group, int unit_rows,
                          int grid_x, cudaStream_t stream) {
  const int row_bytes = D * Mode<MODE>::ELEM;
  const int nt = (int)(((long long)N + tile - 1) / tile);
  const int ng = gmax ? (nt + group - 1) / group : 1;
  const long long units = ((long long)nt * tile + unit_rows - 1) / unit_rows;
  const size_t smem = mma_smem(8 * NT, row_bytes, tile);
  if (smem > 232448 || grid_x < 1 || grid_x > units) return cudaErrorInvalidValue;
  auto kern = tilemax_mma_kernel<MODE, NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, (Q + 8 * NT - 1) / (8 * NT));
  kern<<<grid, MMA_THREADS, smem, stream>>>(static_cast<const unsigned char*>(q),
                                             static_cast<const unsigned char*>(index), scales, tmax,
                                             gmax, Q, N, D, tile, group, nt, ng, unit_rows, units);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mma(const void* q, const void* index, const float* scales, float* tmax,
                       float* gmax, int Q, int N, int D, int tile, int group, int qb,
                       int unit_rows, int grid_x, cudaStream_t stream) {
  const int row_bytes = D * Mode<MODE>::ELEM;
  // the plan's rules, checked again: tile 8 or 16, rows of whole k-chunks,
  // units of whole rounds and whole groups, a 16-byte aligned query block
  if ((tile != 8 && tile != 16) || row_bytes % CHUNK != 0 || unit_rows < ROUND_ROWS ||
      unit_rows % ROUND_ROWS != 0 || (gmax && unit_rows % (group * tile) != 0) ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || (Q + qb - 1) / qb > 65535)
    return cudaErrorInvalidValue;
  if (qb == 16) return launch_mma_nt<MODE, 2>(q, index, scales, tmax, gmax, Q, N, D, tile, group, unit_rows, grid_x, stream);
  if (qb == 32) return launch_mma_nt<MODE, 4>(q, index, scales, tmax, gmax, Q, N, D, tile, group, unit_rows, grid_x, stream);
  if (qb == 64) return launch_mma_nt<MODE, 8>(q, index, scales, tmax, gmax, Q, N, D, tile, group, unit_rows, grid_x, stream);
  return cudaErrorInvalidValue;
}

bool bad_shape(int Q, int N, int D, int tile, int tpb, int per_vec) {
  return Q < 1 || N < 1 || D < 1 || D > 4096 || D % per_vec != 0 || tile < 1 ||
         tpb < 1 || tpb > 1024 || Q > 65535 * 8;
}

}  // namespace

// index_dtype: 0 = float32, 1 = bfloat16. queries (Q, D) in the index's type;
// tmax (Q, ceil(N / tile)) fp32. D a multiple of 16 bytes of the index type,
// index rows 16-byte aligned. body 0 = cuda_core, 1 = mma with the plan's
// query block qb, unit_rows and grid_x (ops/retrieval_topk.py tilemax_plan);
// cuda_core ignores them.
extern "C" int tilemax_fwd(const void* queries, const void* index, void* tmax, int Q, int N,
                           int D, int tile, int index_dtype, int body, int qb, int unit_rows,
                           int grid_x, void* stream) {
  const int per_vec = index_dtype == 0 ? 4 : 8;
  if (bad_shape(Q, N, D, tile, PLAIN_TILES_PER_BLOCK, per_vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(tmax);
  if (body == MMA_BODY) {
    if (index_dtype == 0) return (int)launch_mma<0>(queries, index, nullptr, t, nullptr, Q, N, D, tile, 1, qb, unit_rows, grid_x, st);
    if (index_dtype == 1) return (int)launch_mma<1>(queries, index, nullptr, t, nullptr, Q, N, D, tile, 1, qb, unit_rows, grid_x, st);
    return (int)cudaErrorInvalidValue;
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (index_dtype == 0)
    return (int)launch<0>(queries, index, nullptr, t, nullptr, Q, N, D, tile, PLAIN_TILES_PER_BLOCK, st);
  if (index_dtype == 1)
    return (int)launch<1>(queries, index, nullptr, t, nullptr, Q, N, D, tile, PLAIN_TILES_PER_BLOCK, st);
  return (int)cudaErrorInvalidValue;
}

// As tilemax_fwd, plus gmax (Q, ceil(ceil(N / tile) / group)) fp32.
extern "C" int tilemax_sup_fwd(const void* queries, const void* index, void* tmax, void* gmax,
                               int Q, int N, int D, int tile, int group, int index_dtype,
                               int body, int qb, int unit_rows, int grid_x, void* stream) {
  const int per_vec = index_dtype == 0 ? 4 : 8;
  if (bad_shape(Q, N, D, tile, group, per_vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(tmax);
  float* g = static_cast<float*>(gmax);
  if (body == MMA_BODY) {
    if (index_dtype == 0) return (int)launch_mma<0>(queries, index, nullptr, t, g, Q, N, D, tile, group, qb, unit_rows, grid_x, st);
    if (index_dtype == 1) return (int)launch_mma<1>(queries, index, nullptr, t, g, Q, N, D, tile, group, qb, unit_rows, grid_x, st);
    return (int)cudaErrorInvalidValue;
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (index_dtype == 0) return (int)launch<0>(queries, index, nullptr, t, g, Q, N, D, tile, group, st);
  if (index_dtype == 1) return (int)launch<1>(queries, index, nullptr, t, g, Q, N, D, tile, group, st);
  return (int)cudaErrorInvalidValue;
}

// As tilemax_sup_fwd over an int8 index: int8 queries (Q, D) and values
// (N, D), fp32 scales (N,); the exact int32 dot (__dp4a on the cuda_core
// body, mma.sync m16n8k32 s8 on the mma body; the TPU kernel's MXU operand
// choice has no counterpart here). D a multiple of 16, <= 1024.
extern "C" int tilemax_sup_q8_fwd(const void* queries, const void* values, const void* scales,
                                  void* tmax, void* gmax, int Q, int N, int D, int tile,
                                  int group, int body, int qb, int unit_rows, int grid_x,
                                  void* stream) {
  if (bad_shape(Q, N, D, tile, group, 16) || D > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  float* t = static_cast<float*>(tmax);
  float* g = static_cast<float*>(gmax);
  if (body == MMA_BODY) return (int)launch_mma<2>(queries, values, s, t, g, Q, N, D, tile, group, qb, unit_rows, grid_x, st);
  if (body != 0) return (int)cudaErrorInvalidValue;
  return (int)launch<2>(queries, values, s, t, g, Q, N, D, tile, group, st);
}
