// Exact top-k cosine retrieval: query normalization, q . index^T in fp32,
// a running top-k per block, then a merge into the final sorted (Q, k).
//
// Replaces: clip_lora_match_tpu/ops/retrieval_topk.py (topk_retrieve:
//   _kernel + _extract_topk).
// Contract kept: queries (Q, D) fp32 raw, normalized here as
//   q * rsqrt(sum(q^2) + 1e-12); index (N, D) fp32 or bf16 unit rows, widened
//   to fp32; scores accumulate in fp32 FMAs on the CUDA cores (no TF32: a
//   rounded product reorders near-ties); output scores (Q, k) fp32 sorted
//   descending and int32 row ids, ties to the LOWER row id (the TPU kernel's
//   argmax picks the lowest column and its running merge keeps earlier tiles
//   first); 1 <= k <= min(N, 256), D <= 4096. Within a call a row's score is
//   computed by the same operations wherever it lies, so equal rows score
//   equal and the order is decided by (score desc, id asc) alone: the result
//   does not depend on the grid, and two calls give the same bits.
//
// What bounds it on the H100: at the seeker's Q <= 8, bytes: the index is
//   read once (N*D*4 bytes for fp32, half for bf16) and the work, 2*Q*N*D
//   FLOPs, is far below the fp32 ridge point (20 FLOP per byte). At Q = 64
//   (search_batch), the fp32 FMAs: 2*64*N*D at 67 TFLOP/s takes longer than
//   one read of the index, provided the index is read once per 64 queries.
//
// Design. Pass 1 (one launch) has a grid sized to the card, not to N: about
//   two blocks per SM (ops/retrieval_topk.py: plan), each walking an equal
//   contiguous range of rows, so there is no wave tail. Three bodies:
//   - rows (Q <= 8): index rows reach shared memory through a ring of 4
//     stages of ~16 KB, each stage one 1-D bulk copy (cp.async.bulk,
//     completing on an mbarrier) of R consecutive rows, issued before the
//     block does anything else, so an SM keeps up to 128 KB of the index in
//     flight. A warp scores whole rows against the live query tile only
//     (QT = 1, 2, 4 or 8: one FMA per element at Q = 1) with 16-byte shared
//     loads, then one shuffle tree per row and query;
//   - tile (Q > 8): a block takes 64 queries; each warp owns 8 of them and
//     each lane 2 rows of a 64-row step, an 8 x 2 block of sums in registers.
//     The query and index K-slices (32 wide) come through a 4-stage cp.async
//     ring, the query slice normalized in place by the threads that copied
//     it. Query loads are warp-wide broadcasts and index loads 16 bytes a
//     lane, so a warp reads about 2 KB of shared memory per 4,096 FMAs. The index
//     is read once per 64 queries;
//   - plain: the rows body (8 queries a block) with scalar loads straight
//     from global memory, for an index whose base or row pitch is not
//     16-byte aligned.
//   Selection is by threshold: each query's running top-k, sorted by (score
//   desc, id asc), lives in shared memory and, while a warp selects, in its
//   registers (entry e in lane e % 32, slot e / 32), its k-th entry the
//   threshold. A ballot finds the candidates that beat it: up to 4 are
//   inserted one by one (a ballot and two shuffles a slot), more are sorted
//   across the warp (bitonic) and merged by rank in one step. Over random
//   unit rows about k * ln(rows / k) of a block's rows beat the threshold.
//   Each block writes one sorted k-list per query.
// Pass 2 (the second launch): one block of 512 threads per query, a thread
//   per block list, each reading its list's first 8 entries in one round.
//   The k-th best of the lists' first m entries (m * lists >= k, about 4k
//   heads where they fit), found by counting ranks, is a lower bound of the
//   final k-th score; only the candidates that rank at or above it are kept
//   (a list is sorted, so the rest of it is read only where all 8 were
//   kept), and counting ranks among them places each in the output. No k
//   rounds of a block-wide argmax; a shared atomic only reserves slots in a
//   buffer whose order the ranks then fix. If the kept candidates overflow
//   the buffer (many exact ties), the warps fold every candidate through
//   their running lists instead.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_QW = 8;       // tile body: queries per warp
constexpr int TILE_QT = 64;      // tile body: queries per block
constexpr int TILE_THREADS = 32 * TILE_QT / TILE_QW;
constexpr int TILE_KS = 32;      // tile body: columns per K-slice
constexpr int TILE_RT = 64;      // tile body: rows per step (2 per lane)
constexpr int TILE_STAGES = 4;
constexpr int MERGE_THREADS = 512;  // pass 2: a thread per block list
constexpr int MERGE_FIRST = 8;      // pass 2: entries of a list read in the first round
constexpr int MERGE_HEADS = 1024;
constexpr int MERGE_CAP = 16 * 256;  // pass 2: survivors ranked in shared memory
constexpr int kBadId = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may take

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// (s1, i1) ranks before (s2, i2): higher score, then lower id
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__host__ __device__ __forceinline__ size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// 1 / |q| of query q as the contract computes it, in every lane of the warp
__device__ __forceinline__ float inv_norm(const float* __restrict__ queries, int q, int Q, int D,
                                          int lane) {
  float ss = 0.f;
  if (q < Q)
    for (int d = lane; d < D; d += 32) {
      const float v = queries[(long long)q * D + d];
      ss = fmaf(v, v, ss);
    }
  return rsqrtf(warp_sum(ss) + 1e-12f);
}

// -- a warp's running top-k ----------------------------------------------------------

// k entries sorted by (score desc, id asc), kept in shared memory (ls, li)
// between uses and in registers while in use: entry e = 32 * t + lane in slot
// t; (ts, ti) is entry k - 1, the threshold, in every lane. Empty entries are
// (-inf, kBadId), which rank after every real candidate.
template <int KT>
struct TopK {
  float s[KT];
  int id[KT];
  float ts;
  int ti;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      s[t] = -INFINITY;
      id[t] = kBadId;
    }
    ts = -INFINITY;
    ti = kBadId;
  }

  __device__ __forceinline__ void threshold(int k) {
    float l_s = s[0];
    int l_i = id[0];
#pragma unroll
    for (int t = 1; t < KT; ++t)
      if (t == (k - 1) / 32) {
        l_s = s[t];
        l_i = id[t];
      }
    ts = __shfl_sync(FULL, l_s, (k - 1) % 32);
    ti = __shfl_sync(FULL, l_i, (k - 1) % 32);
  }

  __device__ __forceinline__ void load(const float* ls, const int* li, int k, int lane) {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int e = 32 * t + lane;
      s[t] = e < k ? ls[e] : -INFINITY;
      id[t] = e < k ? li[e] : kBadId;
    }
    threshold(k);
  }

  __device__ __forceinline__ void store(float* ls, int* li, int k, int lane) const {
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (32 * t + lane < k) {
        ls[32 * t + lane] = s[t];
        li[32 * t + lane] = id[t];
      }
  }

  // insert (cs, ci), the same in every lane, if it ranks among the k
  __device__ __forceinline__ void insert(float cs, int ci, int k, int lane) {
    int p = 0;  // entries that rank before it
#pragma unroll
    for (int t = 0; t < KT; ++t)
      p += __popc(__ballot_sync(FULL, 32 * t + lane < k && better(s[t], id[t], cs, ci)));
    if (p >= k) return;
    float carry_s = 0.f;  // lane 31 of the slot below, before the shift
    int carry_i = 0;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const float up_s = __shfl_up_sync(FULL, s[t], 1);
      const int up_i = __shfl_up_sync(FULL, id[t], 1);
      const float top_s = __shfl_sync(FULL, s[t], 31);
      const int top_i = __shfl_sync(FULL, id[t], 31);
      const int e = 32 * t + lane;
      if (e < k && e > p) {
        s[t] = lane == 0 ? carry_s : up_s;
        id[t] = lane == 0 ? carry_i : up_i;
      } else if (e == p) {
        s[t] = cs;
        id[t] = ci;
      }
      carry_s = top_s;
      carry_i = top_i;
    }
    threshold(k);
  }

  // merge the candidates in `m` (lane bits; (cs, ci) in each lane) at once:
  // sort them across the warp, place list entries and candidates by their
  // ranks in each other, and write the k best through the scratch (ls, li)
  __device__ __forceinline__ void merge(unsigned m, float cs, int ci, int k, int lane, float* ls,
                                        int* li) {
    float bs = (m >> lane) & 1 ? cs : -INFINITY;
    int bi = (m >> lane) & 1 ? ci : kBadId;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)  // bitonic sort, best first
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        const float os = __shfl_xor_sync(FULL, bs, stride);
        const int oi = __shfl_xor_sync(FULL, bi, stride);
        const bool first = ((lane & stride) == 0) == ((lane & size) == 0 || size == 32);
        if (first == better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
      }
    store(ls, li, k, lane);
    __syncwarp();
    // the candidate's place: its lane plus the list entries that rank before it
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (better(ls[mid], li[mid], bs, bi))
        lo = mid + 1;
      else
        hi = mid;
    }
    const int place = lane + lo;
    // each list entry's place: its index plus the candidates that rank before it
    int at[KT];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      int a = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const float ps = __shfl_sync(FULL, bs, a + step - 1);
        const int pi = __shfl_sync(FULL, bi, a + step - 1);
        if (better(ps, pi, s[t], id[t])) a += step;
      }
      a += better(__shfl_sync(FULL, bs, 31), __shfl_sync(FULL, bi, 31), s[t], id[t]) && a == 31;
      at[t] = 32 * t + lane + a;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (32 * t + lane < k && at[t] < k) {
        ls[at[t]] = s[t];
        li[at[t]] = id[t];
      }
    if (place < k) {
      ls[place] = bs;
      li[place] = bi;
    }
    __syncwarp();
    load(ls, li, k, lane);
  }

  // one candidate per lane (where `valid`): those that beat the threshold
  // join the list, one by one when few, else by merge (scratch: ls, li).
  // Returns whether any beat it.
  __device__ __forceinline__ bool offer(bool valid, float cs, int ci, int k, int lane, float* ls,
                                        int* li) {
    unsigned m = __ballot_sync(FULL, valid && better(cs, ci, ts, ti));
    if (m == 0) return false;
    if (__popc(m) > 4) {
      merge(m, cs, ci, k, lane, ls, li);
      return true;
    }
    while (m) {
      const int j = __ffs(m) - 1;
      insert(__shfl_sync(FULL, cs, j), __shfl_sync(FULL, ci, j), k, lane);
      // drop it, and every candidate the raised threshold now excludes
      m &= (m - 1) & __ballot_sync(FULL, valid && better(cs, ci, ts, ti));
    }
    return true;
  }
};

// -- pass 1, rows and plain bodies ----------------------------------------------

struct RowsLayout {
  size_t qs, sc, ls, li, bars, total;
};

// shared memory of the rows body (mirrored by ops/retrieval_topk.py: _rows_smem):
// the ring, the normalized query tile, two score buffers, the k-lists' scratch,
// the barriers
__host__ __device__ __forceinline__ RowsLayout rows_layout(int QT, int D, int k, int R, int S,
                                                           size_t elem, bool bulk) {
  RowsLayout L;
  L.qs = bulk ? round_up((size_t)S * R * D * elem, 128) : 0;
  L.sc = round_up(L.qs + (size_t)QT * D * 4, 16);
  L.ls = L.sc + (size_t)2 * QT * R * 4;
  L.li = L.ls + (size_t)QT * k * 4;
  L.bars = round_up(L.li + (size_t)QT * k * 4, 8);
  L.total = L.bars + (bulk ? (size_t)S * 8 : 0);
  return L;
}

// part[t] += qs[t] . row over this lane's share of D (16-byte loads)
template <int QT>
__device__ __forceinline__ void score_vec(const float* row, const float* qs, int D, int lane,
                                          float* part) {
  const int D4 = D / 4;
  const float4* x4 = reinterpret_cast<const float4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int c = lane; c < D4; c += 32) {
    const float4 x = x4[c];
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const float4 q = q4[t * D4 + c];
      part[t] = fmaf(q.x, x.x, part[t]);
      part[t] = fmaf(q.y, x.y, part[t]);
      part[t] = fmaf(q.z, x.z, part[t]);
      part[t] = fmaf(q.w, x.w, part[t]);
    }
  }
}

template <int QT>
__device__ __forceinline__ void score_vec(const __nv_bfloat16* row, const float* qs, int D,
                                          int lane, float* part) {
  const int D4 = D / 4, D8 = D / 8;
  const uint4* x8 = reinterpret_cast<const uint4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int c = lane; c < D8; c += 32) {
    const uint4 raw = x8[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const float4 q = q4[t * D4 + 2 * c], r = q4[t * D4 + 2 * c + 1];
      part[t] = fmaf(q.x, a.x, part[t]);
      part[t] = fmaf(q.y, a.y, part[t]);
      part[t] = fmaf(q.z, b.x, part[t]);
      part[t] = fmaf(q.w, b.y, part[t]);
      part[t] = fmaf(r.x, e.x, part[t]);
      part[t] = fmaf(r.y, e.y, part[t]);
      part[t] = fmaf(r.z, f.x, part[t]);
      part[t] = fmaf(r.w, f.y, part[t]);
    }
  }
}

template <int QT, typename TI>
__device__ __forceinline__ void score_scalar(const TI* __restrict__ row, const float* qs, int D,
                                             int lane, float* part) {
  for (int d = lane; d < D; d += 32) {
    const float v = to_f(row[d]);
#pragma unroll
    for (int t = 0; t < QT; ++t) part[t] = fmaf(qs[t * D + d], v, part[t]);
  }
}

// stage st of a block's rows into ring slot st % S (thread 0)
template <typename TI>
__device__ __forceinline__ void issue_stage(unsigned char* ring, uint32_t bars, const TI* index,
                                            long long r0, int nrows, int D, int R, int S, int st) {
  const uint32_t bytes = (uint32_t)(min(R, nrows - st * R) * D * (int)sizeof(TI));
  const uint32_t bar = bars + 8 * (st % S);
  hopper::mbar_expect_tx(bar, bytes);
  hopper::bulk_load(smem_addr(ring + (size_t)(st % S) * R * D * sizeof(TI)),
                    index + (r0 + (long long)st * R) * D, bytes, bar);
}

template <typename TI, int QT, int KT, bool kBulk>
__global__ void __launch_bounds__(THREADS) topk_rows_kernel(
    const float* __restrict__ queries, const TI* __restrict__ index, float* __restrict__ cand_s,
    int* __restrict__ cand_i, int Q, int N, int D, int k, int R, int S, int rows_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const RowsLayout L = rows_layout(QT, D, k, R, S, sizeof(TI), kBulk);
  float* qs = reinterpret_cast<float*>(smem + L.qs);  // QT x D normalized queries
  float* sc = reinterpret_cast<float*>(smem + L.sc);  // 2 x QT x R scores
  float* ls = reinterpret_cast<float*>(smem + L.ls) + warp * k;  // warp t's list scratch
  int* li = reinterpret_cast<int*>(smem + L.li) + warp * k;
  const uint32_t bars = smem_addr(smem + L.bars);
  const int q0 = blockIdx.y * QT;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, (long long)N - r0);
  const int nst = (nrows + R - 1) / R;

  if (kBulk && threadIdx.x == 0) {  // the ring starts filling before anything else
    for (int s = 0; s < S; ++s) hopper::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < min(S, nst); ++st) issue_stage(smem, bars, index, r0, nrows, D, R, S, st);
  }
  for (int t = warp; t < QT; t += WARPS) {
    const int q = q0 + t;
    const float inv = inv_norm(queries, q, Q, D, lane);
    for (int d = lane; d < D; d += 32)
      qs[t * D + d] = q < Q ? queries[(long long)q * D + d] * inv : 0.f;
  }
  TopK<KT> list;  // warp t < QT: query q0 + t
  list.init();
  const bool selects = warp < QT && q0 + warp < Q;
  __syncthreads();

  for (int st = 0; st < nst; ++st) {
    const int rows = min(R, nrows - st * R);
    const long long rs = r0 + (long long)st * R;
    float* scb = sc + (st & 1) * QT * R;
    const TI* src;
    if (kBulk) {
      hopper::mbar_wait<false>(bars + 8 * (st % S), (uint32_t)((st / S) & 1));
      src = reinterpret_cast<const TI*>(smem + (size_t)(st % S) * R * D * sizeof(TI));
    } else {
      src = index + rs * D;
    }
    for (int r = warp; r < rows; r += WARPS) {
      float part[QT];
#pragma unroll
      for (int t = 0; t < QT; ++t) part[t] = 0.f;
      if (kBulk)
        score_vec<QT>(src + (size_t)r * D, qs, D, lane, part);
      else
        score_scalar<QT>(src + (size_t)r * D, qs, D, lane, part);
#pragma unroll
      for (int t = 0; t < QT; ++t) part[t] = warp_sum(part[t]);
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < QT; ++t) scb[t * R + r] = part[t];
      }
    }
    __syncthreads();  // scores of stage st are in; its ring slot is free
    if (kBulk && threadIdx.x == 0 && st + S < nst)
      issue_stage(smem, bars, index, r0, nrows, D, R, S, st + S);
    // warp t selects for query t while the others score the next stage (the
    // scores are double-buffered; the next __syncthreads orders the reuse)
    if (selects)
      for (int j0 = 0; j0 < rows; j0 += 32) {
        const int j = j0 + lane;
        list.offer(j < rows, j < rows ? scb[warp * R + j] : 0.f, (int)(rs + j), k, lane, ls, li);
      }
  }
  if (selects) {
    const long long out = ((long long)(q0 + warp) * gridDim.x + blockIdx.x) * k;
    list.store(cand_s + out, cand_i + out, k, lane);
  }
}

// -- pass 1, tile body ----------------------------------------------------------

// shared memory of the tile body (mirrored by ops/retrieval_topk.py: _tile_smem):
// 1/|q| of the tile's queries, their k-lists, then the ring of (query slice,
// index slice)
__host__ __device__ __forceinline__ size_t tile_smem(int k, size_t elem) {
  return round_up((size_t)TILE_QT * 4, 16) + (size_t)TILE_QT * k * 8 +
         (size_t)TILE_STAGES * (TILE_QT * (TILE_KS + 4) * 4 + TILE_RT * (TILE_KS * elem + 16));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 consecutive d of one staged row slice (16-byte aligned), widened to fp32
__device__ __forceinline__ void load8(const float* p, float4& a, float4& b) {
  a = reinterpret_cast<const float4*>(p)[0];
  b = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float4& a, float4& b) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 x = __bfloat1622float2(h[0]), y = __bfloat1622float2(h[1]);
  const float2 z = __bfloat1622float2(h[2]), w = __bfloat1622float2(h[3]);
  a = make_float4(x.x, x.y, y.x, y.y);
  b = make_float4(z.x, z.y, w.x, w.y);
}

__device__ __forceinline__ void fma4(float& acc, const float4& q, const float4& x) {
  acc = fmaf(q.x, x.x, acc);
  acc = fmaf(q.y, x.y, acc);
  acc = fmaf(q.z, x.z, acc);
  acc = fmaf(q.w, x.w, acc);
}

// the tile body's stage `it`: K-slice it % nks of row step it / nks
template <typename TI>
__device__ __forceinline__ void tile_load(unsigned char* ring, const float* queries,
                                          const TI* index, int q0, int Q, int D, long long r0,
                                          int nrows, int nks, int it) {
  constexpr int QP = TILE_KS + 4, VEC = 16 / sizeof(TI), XP = TILE_KS + VEC;
  constexpr int QC = TILE_KS / 4, XC = TILE_KS / VEC;  // 16-byte chunks a row
  constexpr size_t QBYTES = (size_t)TILE_QT * QP * 4;
  constexpr size_t STAGE = QBYTES + (size_t)TILE_RT * XP * sizeof(TI);
  const int step = it / nks, d0 = (it % nks) * TILE_KS;
  const uint32_t base = smem_addr(ring + (it % TILE_STAGES) * STAGE);
  for (int c = threadIdx.x; c < TILE_QT * QC; c += TILE_THREADS) {  // the query slice
    const int qr = c / QC, d = d0 + (c % QC) * 4;
    const bool ok = q0 + qr < Q && d < D;
    cp_async16(base + (uint32_t)((qr * QP + (c % QC) * 4) * 4),
               ok ? queries + (long long)(q0 + qr) * D + d : queries, ok);
  }
  const int rows = min(TILE_RT, nrows - step * TILE_RT);
  const long long rb = r0 + (long long)step * TILE_RT;
  for (int x = threadIdx.x; x < TILE_RT * XC; x += TILE_THREADS) {  // the index slice
    const int r = x / XC, d = d0 + (x % XC) * VEC;
    const bool ok = r < rows && d < D;
    cp_async16(base + (uint32_t)(QBYTES + (r * XP + (x % XC) * VEC) * sizeof(TI)),
               ok ? index + (rb + r) * D + d : index, ok);
  }
}

template <typename TI, int KT>
__global__ void __launch_bounds__(TILE_THREADS, 512 / TILE_THREADS) topk_tile_kernel(
    const float* __restrict__ queries, const TI* __restrict__ index, float* __restrict__ cand_s,
    int* __restrict__ cand_i, int Q, int N, int D, int k, int rows_per_block) {
  constexpr int QW = TILE_QW, QP = TILE_KS + 4, VEC = 16 / sizeof(TI), XP = TILE_KS + VEC;
  constexpr int QC = TILE_KS / 4;
  constexpr size_t QBYTES = (size_t)TILE_QT * QP * 4;
  constexpr size_t STAGE = QBYTES + (size_t)TILE_RT * XP * sizeof(TI);
  extern __shared__ __align__(128) unsigned char smem[];
  float* inv = reinterpret_cast<float*>(smem);
  float* ls = reinterpret_cast<float*>(smem + round_up((size_t)TILE_QT * 4, 16));  // QT x k
  int* li = reinterpret_cast<int*>(ls + TILE_QT * k);
  unsigned char* ring = reinterpret_cast<unsigned char*>(li + TILE_QT * k);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.y * TILE_QT;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, (long long)N - r0);
  const int nks = (D + TILE_KS - 1) / TILE_KS;
  const int total = (nrows + TILE_RT - 1) / TILE_RT * nks;

  for (int it = 0; it < TILE_STAGES - 1; ++it) {
    if (it < total) tile_load<TI>(ring, queries, index, q0, Q, D, r0, nrows, nks, it);
    cp_async_commit();
  }
  for (int i = 0; i < QW; ++i) {  // warp w: queries w * QW + i, their 1/|q| and lists
    const int t = warp * QW + i;
    const float v = inv_norm(queries, q0 + t, Q, D, lane);
    if (lane == 0) inv[t] = v;
    for (int e = lane; e < k; e += 32) {
      ls[t * k + e] = -INFINITY;
      li[t * k + e] = kBadId;
    }
  }
  float acc[QW][2];
#pragma unroll
  for (int i = 0; i < QW; ++i) acc[i][0] = acc[i][1] = 0.f;
  __syncthreads();  // inv

  for (int it = 0; it < total; ++it) {
    cp_async_wait<TILE_STAGES - 2>();  // this thread's copies of stage it are in
    unsigned char* stage = ring + (it % TILE_STAGES) * STAGE;
    for (int c = threadIdx.x; c < TILE_QT * QC; c += TILE_THREADS) {  // normalize what it copied
      float4* p = reinterpret_cast<float4*>(stage + ((c / QC) * QP + (c % QC) * 4) * 4);
      const float f = inv[c / QC];
      float4 v = *p;
      v.x *= f;
      v.y *= f;
      v.z *= f;
      v.w *= f;
      *p = v;
    }
    __syncthreads();  // stage it is complete and normalized; slot (it - 1) is free
    if (it + TILE_STAGES - 1 < total)
      tile_load<TI>(ring, queries, index, q0, Q, D, r0, nrows, nks, it + TILE_STAGES - 1);
    cp_async_commit();
    const float* qs = reinterpret_cast<const float*>(stage) + warp * QW * QP;
    const TI* xs = reinterpret_cast<const TI*>(stage + QBYTES);
#pragma unroll
    for (int kk = 0; kk < TILE_KS; kk += 8) {
      float4 x0a, x0b, x1a, x1b;
      load8(xs + lane * XP + kk, x0a, x0b);
      load8(xs + (lane + 32) * XP + kk, x1a, x1b);
#pragma unroll
      for (int i = 0; i < QW; ++i) {  // the same address in every lane: a broadcast
        const float4 qa = *reinterpret_cast<const float4*>(qs + i * QP + kk);
        const float4 qb = *reinterpret_cast<const float4*>(qs + i * QP + kk + 4);
        fma4(acc[i][0], qa, x0a);
        fma4(acc[i][1], qa, x1a);
        fma4(acc[i][0], qb, x0b);
        fma4(acc[i][1], qb, x1b);
      }
    }
    if (it % nks == nks - 1) {  // the step's scores are complete: select
      const int step = it / nks;
      const int rows = min(TILE_RT, nrows - step * TILE_RT);
      const int rs = (int)(r0 + (long long)step * TILE_RT);
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        const int t = warp * QW + i;
        if (q0 + t < Q) {
          TopK<KT> l;
          l.load(ls + t * k, li + t * k, k, lane);
          l.offer(lane < rows, acc[i][0], rs + lane, k, lane, ls + t * k, li + t * k);
          l.offer(lane + 32 < rows, acc[i][1], rs + lane + 32, k, lane, ls + t * k, li + t * k);
          l.store(ls + t * k, li + t * k, k, lane);
        }
        acc[i][0] = acc[i][1] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();
  for (int i = 0; i < QW; ++i) {  // each warp writes the lists it kept
    const int t = warp * QW + i;
    if (q0 + t < Q) {
      const long long out = ((long long)(q0 + t) * gridDim.x + blockIdx.x) * k;
      for (int e = lane; e < k; e += 32) {
        cand_s[out + e] = ls[t * k + e];
        cand_i[out + e] = li[t * k + e];
      }
    }
  }
}

// -- pass 2: merge each query's block lists ---------------------------------------

template <int KT>
__global__ void __launch_bounds__(MERGE_THREADS) topk_merge_kernel(
    const float* __restrict__ cand_s, const int* __restrict__ cand_i, float* __restrict__ out_s,
    int* __restrict__ out_i, int G, int k) {
  constexpr int U = MERGE_FIRST, MW = MERGE_THREADS / 32;
  __shared__ float hs[MERGE_HEADS];
  __shared__ int hi[MERGE_HEADS];
  __shared__ float vs[MERGE_CAP];
  __shared__ int vi[MERGE_CAP];
  __shared__ float t0s;
  __shared__ int t0i, count;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base = (long long)blockIdx.x * G * k;
  float* os = out_s + (long long)blockIdx.x * k;
  int* oi = out_i + (long long)blockIdx.x * k;
  const float* ls = cand_s + base;
  const int* li = cand_i + base;

  // 1. a lower bound of the k-th score: the k-th best of the lists' first m
  //    entries (at least k candidates rank at or above it); m covers 4k heads
  //    where they fit, for a bound close to the k-th score. Thread c reads
  //    the first U entries of list c in one round.
  const int m = min(min(k, U), max((k + G - 1) / G, min((4 * k + G - 1) / G, MERGE_HEADS / G)));
  const bool bounded = m * G >= k && m * G <= MERGE_HEADS;
  const int own = threadIdx.x;
  float s[U];
  int i[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool ok = own < G && u < k;
    s[u] = ok ? ls[(long long)own * k + u] : -INFINITY;
    i[u] = ok ? li[(long long)own * k + u] : kBadId;
  }
  if (threadIdx.x == 0) {
    t0s = -INFINITY;  // no bound: every candidate is kept
    t0i = kBadId;
    count = 0;
  }
  if (bounded) {
    if (own < G)
      for (int u = 0; u < m; ++u) {
        hs[own * m + u] = s[u];
        hi[own * m + u] = i[u];
      }
    for (int c = own + MERGE_THREADS; c < G; c += MERGE_THREADS)
      for (int u = 0; u < m; ++u) {
        hs[c * m + u] = ls[(long long)c * k + u];
        hi[c * m + u] = li[(long long)c * k + u];
      }
  }
  __syncthreads();
  if (bounded) {
    const int H = G * m;
    for (int h = threadIdx.x; h < H; h += MERGE_THREADS) {
      const float hs_h = hs[h];
      const int hi_h = hi[h];
      int rank = 0;
      for (int j = 0; j < H; ++j) rank += better(hs[j], hi[j], hs_h, hi_h);
      if (rank == k - 1 && hi_h != kBadId) {  // keys are unique but for empty entries
        t0s = hs_h;
        t0i = hi_h;
      }
    }
  }
  __syncthreads();
  // 2. the candidates at or above the bound, in arrival order (one shared
  //    atomic a warp reserves the slots). A list is sorted, so its entries
  //    past U are read only where all U were kept.
  const float bs = t0s;
  const int bi = t0i;
  bool all = own < G;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool keep = i[u] != kBadId && !better(bs, bi, s[u], i[u]);
    all = all && (keep || u >= k);
    const unsigned kept = __ballot_sync(FULL, keep);
    if (kept == 0) continue;
    int first = 0;
    if (lane == 0) first = atomicAdd(&count, __popc(kept));
    const int slot = __shfl_sync(FULL, first, 0) + __popc(kept & ((1u << lane) - 1));
    if (keep && slot < MERGE_CAP) {
      vs[slot] = s[u];
      vi[slot] = i[u];
    }
  }
  auto keep_tail = [&](int c, int e) {  // the rare lists kept past their first U
    for (; e < k; ++e) {
      const float sv = ls[(long long)c * k + e];
      const int iv = li[(long long)c * k + e];
      if (iv == kBadId || better(bs, bi, sv, iv)) break;
      const int slot = atomicAdd(&count, 1);
      if (slot < MERGE_CAP) {
        vs[slot] = sv;
        vi[slot] = iv;
      }
    }
  };
  if (all) keep_tail(own, U);
  for (int c = own + MERGE_THREADS; c < G; c += MERGE_THREADS) keep_tail(c, 0);
  __syncthreads();
  const int c = count;
  if (c <= MERGE_CAP) {
    // 3. each survivor's rank is its place; ranks past k are dropped
    for (int v = threadIdx.x; v < c; v += MERGE_THREADS) {
      const float sv = vs[v];
      const int iv = vi[v];
      int rank = 0;
      for (int j = 0; j < c; ++j) rank += better(vs[j], vi[j], sv, iv);
      if (rank < k) {
        os[rank] = sv;
        oi[rank] = iv;
      }
    }
    return;
  }
  // too many survivors (exact ties): every warp folds a share of the
  // candidates through its list (kept in vs / vi), then warp 0 folds the others'
  const int n = G * k;
  TopK<KT> list;
  list.init();
  __syncthreads();
  for (int f0 = warp * 32; f0 < n; f0 += MERGE_THREADS) {
    const int f = f0 + lane;
    list.offer(f < n, f < n ? ls[f] : 0.f, f < n ? li[f] : kBadId, k, lane, vs + warp * k,
               vi + warp * k);
  }
  list.store(vs + warp * k, vi + warp * k, k, lane);
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < MW; ++w)
    for (int e0 = 0; e0 < k; e0 += 32) {  // sorted: stop at the first chunk that adds nothing
      const int e = e0 + lane;
      if (!list.offer(e < k, e < k ? vs[w * k + e] : 0.f, e < k ? vi[w * k + e] : kBadId, k, lane,
                      vs, vi))
        break;
    }
  list.store(os, oi, k, lane);
}

// -- host side --------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const float* q;
  const void* index;
  float* cs;
  int* ci;
  int Q, N, D, k, R, S, rpb, gx;
  cudaStream_t st;
};

template <typename TI, int QT, int KT, bool kBulk>
cudaError_t run_rows(const Args& a) {
  const size_t smem = rows_layout(QT, a.D, a.k, a.R, a.S, sizeof(TI), kBulk).total;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = topk_rows_kernel<TI, QT, KT, kBulk>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.gx, (a.Q + QT - 1) / QT), THREADS, smem, a.st>>>(
      a.q, static_cast<const TI*>(a.index), a.cs, a.ci, a.Q, a.N, a.D, a.k, a.R, a.S, a.rpb);
  return cudaGetLastError();
}

template <typename TI, int KT>
cudaError_t run_tile(const Args& a) {
  const size_t smem = tile_smem(a.k, sizeof(TI));
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = topk_tile_kernel<TI, KT>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.gx, (a.Q + TILE_QT - 1) / TILE_QT), TILE_THREADS, smem, a.st>>>(
      a.q, static_cast<const TI*>(a.index), a.cs, a.ci, a.Q, a.N, a.D, a.k, a.rpb);
  return cudaGetLastError();
}

template <typename TI, int KT>
cudaError_t run_pass1(const Args& a, int body, int qt, bool aligned) {
  if (body == 0 && aligned && a.S >= 1) {
    switch (qt) {
      case 1: return run_rows<TI, 1, KT, true>(a);
      case 2: return run_rows<TI, 2, KT, true>(a);
      case 4: return run_rows<TI, 4, KT, true>(a);
      case 8: return run_rows<TI, 8, KT, true>(a);
    }
  }
  if (body == 1 && qt == 8) return run_rows<TI, 8, KT, false>(a);
  if (body == 2 && aligned && a.S == TILE_STAGES && qt == TILE_QT) return run_tile<TI, KT>(a);
  return cudaErrorInvalidValue;
}

template <typename TI>
cudaError_t run_pass1_k(const Args& a, int body, int qt) {
  // the tile body copies queries in 16-byte chunks too
  const bool aligned = reinterpret_cast<uintptr_t>(a.index) % 16 == 0 &&
                       ((size_t)a.D * sizeof(TI)) % 16 == 0 &&
                       (body != 2 || (reinterpret_cast<uintptr_t>(a.q) % 16 == 0 && a.D % 4 == 0));
  if (a.k <= 32) return run_pass1<TI, 1>(a, body, qt, aligned);
  if (a.k <= 64) return run_pass1<TI, 2>(a, body, qt, aligned);
  if (a.k <= 128) return run_pass1<TI, 4>(a, body, qt, aligned);
  return run_pass1<TI, 8>(a, body, qt, aligned);
}

cudaError_t run_merge(const Args& a, float* out_s, int* out_i) {
  const dim3 g(a.Q);
  if (a.k <= 32)
    topk_merge_kernel<1><<<g, MERGE_THREADS, 0, a.st>>>(a.cs, a.ci, out_s, out_i, a.gx, a.k);
  else if (a.k <= 64)
    topk_merge_kernel<2><<<g, MERGE_THREADS, 0, a.st>>>(a.cs, a.ci, out_s, out_i, a.gx, a.k);
  else if (a.k <= 128)
    topk_merge_kernel<4><<<g, MERGE_THREADS, 0, a.st>>>(a.cs, a.ci, out_s, out_i, a.gx, a.k);
  else
    topk_merge_kernel<8><<<g, MERGE_THREADS, 0, a.st>>>(a.cs, a.ci, out_s, out_i, a.gx, a.k);
  return cudaGetLastError();
}

}  // namespace

// One call: pass 1 (grid_x blocks of rows_per_block rows x ceil(Q / qt) query
// tiles) and the merge. body: 0 rows (bulk ring), 1 plain, 2 tile; qt the
// query tile (1, 2, 4, 8 for rows; 8 for plain; 64, or 32 when k > 64, for
// tile); rows the rows per stage of the rows and plain bodies; stages the
// ring depth (4 for the tile body). index_dtype: 0 = float32, 1 = bfloat16.
// cand_s / cand_i hold Q * grid_x * k entries. The plan comes from
// ops/retrieval_topk.py: plan; a plan the shape does not fit returns
// cudaErrorInvalidValue.
extern "C" int topk_retrieve_fwd(const void* queries, const void* index, void* cand_s,
                                 void* cand_i, void* out_s, void* out_i, int Q, int N, int D,
                                 int k, int index_dtype, int body, int qt, int rows, int stages,
                                 int rows_per_block, int grid_x, void* stream) {
  if (Q < 1 || N < 1 || D < 1 || D > 4096 || k < 1 || k > 256 || k > N || rows < 1 ||
      rows_per_block < 1 || grid_x < 1 || (long long)rows_per_block * grid_x < N ||
      (long long)rows_per_block * (grid_x - 1) >= N || (long long)grid_x * k > (1 << 30))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(queries), index, static_cast<float*>(cand_s),
         static_cast<int*>(cand_i), Q, N, D, k, rows, stages, rows_per_block, grid_x,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err = index_dtype == 0   ? run_pass1_k<float>(a, body, qt)
                    : index_dtype == 1 ? run_pass1_k<__nv_bfloat16>(a, body, qt)
                                       : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)run_merge(a, static_cast<float*>(out_s), static_cast<int*>(out_i));
}
