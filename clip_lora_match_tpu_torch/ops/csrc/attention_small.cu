// Whole-sequence multi-head attention for CLIP's short sequences (S <= 128).
//
// Replaces: clip_lora_match_tpu/ops/attention_small.py (attention_small:
//   _kernel_packed, _kernel_inkmask, _kernel / _kernel_nomask_adapter).
// Contract kept exactly: q, k, v, o in the (B, S, H*hd) projection layout, no
//   transposes; scores = (q . k) * scale in fp32; the max-free softmax
//   e = exp(min(s, 80)); P (rounded to the input type, as the TPU kernel casts
//   it before its P.V dot) times V in fp32; the result divided by
//   max(sum(e), 1e-30), the sum taken over the unrounded e, so a fully masked
//   row gives zeros. Three mask modes: none; structural (causal and/or per-row
//   key lengths, built in-kernel); an additive fp32 (B|1, 1, S, S) mask.
// What bounds it on the H100: bytes at a batch (q, k, v and o read or written
//   once, B*S*H*hd elements each; 4*S*S*hd FLOPs per (b, h) is far below the
//   ridge at S <= 128). At one request (B = 1, 8-12 heads) the bound is under
//   a microsecond, so the launch and one block's load-then-compute latency set
//   the time: the design keeps that path short and fills more SMs.
// Design: the max-free softmax needs no running max, so a block holds the
//   whole key range of its head in shared memory and makes one pass.
//   - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//     accumulate). q, k and v rows are staged with 16-byte cp.async copies
//     into rows padded to 144 bytes, so ldmatrix's eight row addresses fall
//     in eight distinct bank groups. Per warp and 16 query rows: Q.K^T into
//     fp32 fragments (ldmatrix for K), scale, mask and exp in registers, row
//     sums by a quad shuffle, P packed to bf16 in registers as the A operand
//     of P.V (ldmatrix .trans for V). The score registers are sized by a
//     template bound on the 16-key steps (2, 4, 5 or 8), not by S <= 128.
//     * a request (fewer heads than SMs): a block of 4 warps takes 16 query
//       rows and splits their key steps across the warps, which the max-free
//       softmax allows (partial sums and P.V products just add, through
//       shared memory at the end). Each warp's chain is a quarter as long and
//       four warps stage K and V: 48 blocks at S=50, H=12.
//     * a batch: a block takes the whole head, one warp per 16 rows, so K and
//       V are read once; the output is staged through the warp's own q rows
//       so it leaves in 16-byte stores.
//     wgmma's 64-row minimum would leave most of a 64-row tile empty at
//     S = 50-77, so mma.sync it is.
//   - fp32 (the image tower's residual is fp32; no TF32: the contract is fp32
//     products): a block of 8 warps; thread (warp w, lane l) holds the scores
//     of R rows against keys l, l+32, ... and the outputs of its R rows at
//     head columns 2l, 2l+1: independent register accumulators, no dependent
//     chain longer than hd. R = 2 at a request (16 rows a block, 48 blocks at
//     B=1 S=50 H=12), R = 4 at a batch (32 rows a block: K and V staged half
//     as often). K, V and the q tile are staged with 16-byte cp.async copies
//     (row stride 68 floats: the lanes' 16-byte reads of eight consecutive
//     rows hit eight bank groups); P goes through shared memory once.
//   An unaligned view (a base pointer off 16 bytes) is staged element by
//   element instead. No cross-block state.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int HD = 64;
constexpr int kMaxSeq = 128;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ---- bf16: mma.sync ----------------------------------------------------------

constexpr int LDB = HD + 8;  // bf16 elements per staged row (144 bytes)
constexpr int KSPLIT = 4;    // warps that share 16 query rows at a request
constexpr int LDR = HD + 4;  // fp32 elements per row of a warp's partial output (+ its sum)

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// rows [0, n) of one head (row stride ld elements in global memory) into
// shared rows of LDB elements; rows [n, n_pad) are zero
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, long long ld, int n,
                                           int n_pad, bool vec) {
  for (int c = threadIdx.x; c < n_pad * (HD / 8); c += blockDim.x) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    bf16* d = dst + r * LDB + col;
    if (r >= n) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      cp_async16(d, src + r * ld + col);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = src[r * ld + col + e];
    }
  }
}

// grid (B * H, row tiles); blockDim 32 * warps. KS warps share each 16 query
// rows (1, or KSPLIT at a request): warp w takes rows 16 (w / KS) and the
// 16-key steps i with i % KS == w % KS; the max-free softmax needs no running
// max, so the partial sums and P.V products just add. NKS >= ceil(S / 16)
// bounds the key steps, so the score registers fit the sequence.
template <int KS, int NKS>
__global__ void __launch_bounds__(256) attention_small_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, const int* __restrict__ lengths, const float* __restrict__ mask,
    long long mask_bstride, int S, int H, float scale, int causal, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows_blk = blockDim.x / 2 / KS;  // 16 per row group
  const int row_begin = blockIdx.y * rows_blk;
  const int row_end = min(S, row_begin + rows_blk);
  const int kv_rows = causal ? row_end : S;  // keys any row of this block can see
  const int kv_pad = (kv_rows + 15) & ~15;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kv_pad][LDB]
  bf16* vs = ks + kv_pad * LDB;                  // [kv_pad][LDB]
  bf16* qs = vs + kv_pad * LDB;                  // [rows_blk][LDB], later the output

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long D = (long long)H * HD;
  const long long base = (long long)b * S * D + (long long)h * HD;
  stage_bf16(ks, k + base, D, kv_rows, kv_pad, vec);
  stage_bf16(vs, v + base, D, kv_rows, kv_pad, vec);
  stage_bf16(qs, q + base + row_begin * D, D, row_end - row_begin, rows_blk, vec);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / KS, kp = warp % KS;
  const int row0 = row_begin + rg * 16;
  if (row0 >= S) return;  // whole row groups only: KS > 1 has one, and it is inside
  const int g = lane >> 2, t = lane & 3;
  // keys this warp's rows can see, in 16-key steps (the last may be partial)
  const int kv_w = causal ? min(kv_rows, row0 + 16) : kv_rows;
  const int n_ks = (kv_w + 15) >> 4;

  bf16* qw = qs + rg * 16 * LDB;
  unsigned qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], qw + (lane & 15) * LDB + (lane >> 4) * 8 + 16 * kk);

  // scores: sc[nt] is the 16 x 8 tile of keys 8nt .. 8nt + 7
  float sc[2 * NKS][4];
#pragma unroll
  for (int ks_i = 0; ks_i < NKS; ++ks_i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[2 * ks_i][e] = sc[2 * ks_i + 1][e] = 0.f;
    if (ks_i < n_ks && ks_i % KS == kp) {
      const bf16* kr = ks + (16 * ks_i + (lane & 7) + ((lane >> 4) << 3)) * LDB + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned bk[4];
        ldsm_x4(bk, kr + 16 * kk);
        mma_bf16(sc[2 * ks_i], qa[kk], bk[0], bk[1]);
        mma_bf16(sc[2 * ks_i + 1], qa[kk], bk[2], bk[3]);
      }
    }
  }

  // mask, exp, row sums (fp32); masked keys and keys past S give exactly 0
  const int klen = lengths ? min(lengths[b], S) : S;
  const float* mrow = mask ? mask + (long long)b * mask_bstride : nullptr;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2 * NKS; ++nt) {
    if (nt < 2 * n_ks && (nt / 2) % KS == kp) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r_lo : r_hi;
        const int key = 8 * nt + 2 * t + (e & 1);
        float x = 0.f;
        if (key < klen && !(causal && key > row)) {
          float s = sc[nt][e] * scale;
          if (mrow && row < S) s += mrow[(long long)row * S + key];
          x = expf(fminf(s, 80.f));
        }
        sc[nt][e] = x;
        if (e < 2) sum_lo += x; else sum_hi += x;
      }
    }
  }
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);

  // P (bf16, from registers) . V
  float oc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oc[nt][e] = 0.f;
#pragma unroll
  for (int ks_i = 0; ks_i < NKS; ++ks_i) {
    if (ks_i < n_ks && ks_i % KS == kp) {
      const unsigned pa[4] = {
          pack_bf16(sc[2 * ks_i][0], sc[2 * ks_i][1]), pack_bf16(sc[2 * ks_i][2], sc[2 * ks_i][3]),
          pack_bf16(sc[2 * ks_i + 1][0], sc[2 * ks_i + 1][1]),
          pack_bf16(sc[2 * ks_i + 1][2], sc[2 * ks_i + 1][3])};
      const bf16* vr = vs + (16 * ks_i + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned bv[4];
        ldsm_x4_t(bv, vr + 16 * dp);
        mma_bf16(oc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(oc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  if (KS > 1) {
    // add the warps' partial outputs and sums through shared memory (a region
    // of its own after the q rows), then every thread finishes 8 columns of
    // one row
    float* red = reinterpret_cast<float*>(ks + 2 * kv_pad * LDB + rows_blk * LDB);
    float* part = red + kp * 16 * LDR;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<float2*>(part + g * LDR + 8 * nt + 2 * t) = make_float2(oc[nt][0], oc[nt][1]);
      *reinterpret_cast<float2*>(part + (g + 8) * LDR + 8 * nt + 2 * t) =
          make_float2(oc[nt][2], oc[nt][3]);
    }
    if (t == 0) {
      part[g * LDR + HD] = sum_lo;
      part[(g + 8) * LDR + HD] = sum_hi;
    }
    __syncthreads();
    const int r = threadIdx.x / 8, col = (threadIdx.x % 8) * 8;
    if (r < 16 && row0 + r < S) {
      float acc[8] = {}, sum = 0.f;
#pragma unroll
      for (int w = 0; w < KS; ++w) {
        const float* pr = red + (w * 16 + r) * LDR;
        sum += pr[HD];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += pr[col + e];
      }
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      uint4 pk;
      pk.x = pack_bf16(acc[0] * inv, acc[1] * inv);
      pk.y = pack_bf16(acc[2] * inv, acc[3] * inv);
      pk.z = pack_bf16(acc[4] * inv, acc[5] * inv);
      pk.w = pack_bf16(acc[6] * inv, acc[7] * inv);
      bf16* dst = o + base + (long long)(row0 + r) * D + col;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = pk;
      } else {
        const bf16* src = reinterpret_cast<const bf16*>(&pk);
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      }
    }
    return;
  }

  // divide, stage in this warp's q rows, store 16 bytes a lane
  const float inv_lo = 1.f / fmaxf(sum_lo, 1e-30f), inv_hi = 1.f / fmaxf(sum_hi, 1e-30f);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    *reinterpret_cast<unsigned*>(qw + g * LDB + 8 * nt + 2 * t) =
        pack_bf16(oc[nt][0] * inv_lo, oc[nt][1] * inv_lo);
    *reinterpret_cast<unsigned*>(qw + (g + 8) * LDB + 8 * nt + 2 * t) =
        pack_bf16(oc[nt][2] * inv_hi, oc[nt][3] * inv_hi);
  }
  __syncwarp();
  for (int c = lane; c < 16 * (HD / 8); c += 32) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    if (row0 + r >= S) continue;
    bf16* dst = o + base + (long long)(row0 + r) * D + col;
    const bf16* src = qw + r * LDB + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = src[e];
    }
  }
}

// ---- fp32: CUDA-core register tiles -----------------------------------------

constexpr int F_THREADS = 256;    // 8 warps: warp w takes rows R w .. R w + R - 1
constexpr int LDF = HD + 4;       // fp32 elements per staged row (16-byte aligned)

// rows [0, n) of one head into shared rows of LDF floats
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long ld, int n,
                                          bool vec) {
  for (int c = threadIdx.x; c < n * (HD / 4); c += blockDim.x) {
    const int r = c / (HD / 4), col = (c % (HD / 4)) * 4;
    if (vec) {
      cp_async16(dst + r * LDF + col, src + r * ld + col);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[r * LDF + col + e] = src[r * ld + col + e];
    }
  }
}

template <int R>
struct RowVec;  // R consecutive floats of P, loaded and stored at once
template <>
struct RowVec<2> {
  using T = float2;
};
template <>
struct RowVec<4> {
  using T = float4;
};

// grid (B * H, ceil(S / 8R)); each thread holds R query rows: 2 at a request
// (more blocks), 4 at a batch (K and V staged half as often per row)
template <int R>
__global__ void __launch_bounds__(F_THREADS) attention_small_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, const int* __restrict__ lengths, const float* __restrict__ mask,
    long long mask_bstride, int S, int H, float scale, int causal, int vec) {
  constexpr int ROWS = 8 * R;      // query rows per block
  constexpr int LDP = ROWS + 4;    // P is stored key-major: ps[key][row]
  using PV = typename RowVec<R>::T;
  extern __shared__ __align__(16) float fsm[];
  const int row_begin = blockIdx.y * ROWS;
  const int row_end = min(S, row_begin + ROWS);
  const int kv_rows = causal ? row_end : S;
  float* ks = fsm;                    // [kv_rows][LDF]
  float* vs = ks + kv_rows * LDF;     // [kv_rows][LDF]
  float* qs = vs + kv_rows * LDF;     // [ROWS][LDF]
  float* ps = qs + ROWS * LDF;        // [kv_rows][LDP]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long D = (long long)H * HD;
  const long long base = (long long)b * S * D + (long long)h * HD;
  stage_f32(ks, k + base, D, kv_rows, vec);
  stage_f32(vs, v + base, D, kv_rows, vec);
  stage_f32(qs, q + base + row_begin * D, D, row_end - row_begin, vec);
  cp_async_wait_all();
  __syncthreads();

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ra = row_begin + R * w;  // this thread's rows: ra .. ra + R - 1
  const int n_c = (kv_rows + 31) / 32;
  float s[R][kMaxSeq / 32];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < kMaxSeq / 32; ++c) s[i][c] = 0.f;
  const float* q0 = qs + (R * w) * LDF;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = *reinterpret_cast<const float4*>(q0 + i * LDF + d);
#pragma unroll
    for (int c = 0; c < kMaxSeq / 32; ++c) {
      if (c < n_c) {
        const int j = min(lane + 32 * c, kv_rows - 1);  // past the last key: read, then masked
        const float4 kv = *reinterpret_cast<const float4*>(ks + j * LDF + d);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          s[i][c] = fmaf(a[i].x, kv.x, s[i][c]);
          s[i][c] = fmaf(a[i].y, kv.y, s[i][c]);
          s[i][c] = fmaf(a[i].z, kv.z, s[i][c]);
          s[i][c] = fmaf(a[i].w, kv.w, s[i][c]);
        }
      }
    }
  }

  const int klen = lengths ? min(lengths[b], S) : S;
  const float* mrow = mask ? mask + (long long)b * mask_bstride : nullptr;
  float sum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) sum[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxSeq / 32; ++c) {
    if (c < n_c) {
      const int j = lane + 32 * c;
      float e[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = ra + i;
        e[i] = 0.f;
        if (j < klen && j < kv_rows && !(causal && j > row)) {
          float x = s[i][c] * scale;
          if (mrow && row < S) x += mrow[(long long)row * S + j];
          e[i] = expf(fminf(x, 80.f));
        }
        sum[i] += e[i];
      }
      if (j < kv_rows) {
        PV pv;
#pragma unroll
        for (int i = 0; i < R; ++i) reinterpret_cast<float*>(&pv)[i] = e[i];
        *reinterpret_cast<PV*>(ps + j * LDP + R * w) = pv;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
  __syncthreads();

  // P . V: rows ra .. ra + R - 1 at head columns 2 * lane, 2 * lane + 1
  float acc[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = 0.f;
  const int j_end = causal ? min(kv_rows, ra + R) : kv_rows;
#pragma unroll 4
  for (int j = 0; j < j_end; ++j) {
    const PV pv = *reinterpret_cast<const PV*>(ps + j * LDP + R * w);
    const float* p = reinterpret_cast<const float*>(&pv);
    const float2 vv = *reinterpret_cast<const float2*>(vs + j * LDF + 2 * lane);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i][0] = fmaf(p[i], vv.x, acc[i][0]);
      acc[i][1] = fmaf(p[i], vv.y, acc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (ra + i >= S) continue;
    const float inv = 1.f / fmaxf(sum[i], 1e-30f);
    float* dst = o + base + (long long)(ra + i) * D + 2 * lane;
    const float x0 = acc[i][0] * inv, x1 = acc[i][1] * inv;
    if (vec) {
      *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
    } else {
      dst[0] = x0;
      dst[1] = x1;
    }
  }
}

cudaError_t set_smem(const void* kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim must be 64, 1 <= S <= 128.
// lengths: (B,) int32 or null; mask: fp32 with batch stride mask_bstride
// (0 for a shared (1, 1, S, S) mask) or null. bf16: warps_per_block (1-8)
// warps per block, `split` (1 or 4) of them on each 16 query rows. fp32:
// 8 warps, `split` (2 or 4) query rows a thread.
extern "C" int attention_small_fwd(const void* q, const void* k, const void* v, void* o,
                                   const void* lengths, const void* mask, long long mask_bstride,
                                   int B, int S, int H, int head_dim, float scale, int causal,
                                   int dtype, int warps_per_block, int split, void* stream) {
  if (head_dim != HD || S < 1 || S > kMaxSeq || B < 1 || H < 1 || warps_per_block < 1 ||
      warps_per_block > 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* m = static_cast<const float*>(mask);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (dtype == 0) {
    if (split != 2 && split != 4) return (int)cudaErrorInvalidValue;
    const int rows = 8 * split;
    const size_t smem =
        sizeof(float) * (2 * (size_t)S * LDF + rows * LDF + (size_t)S * (rows + 4));
    void (*kern)(const float*, const float*, const float*, float*, const int*, const float*,
                 long long, int, int, float, int, int) =
        split == 2 ? attention_small_f32_kernel<2> : attention_small_f32_kernel<4>;
    cudaError_t err = set_smem((const void*)kern, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B * H, (S + rows - 1) / rows);
    kern<<<grid, F_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), len, m, mask_bstride, S, H, scale, causal, aligned);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || (split != 1 && split != KSPLIT) || (split == KSPLIT && warps_per_block != KSPLIT))
    return (int)cudaErrorInvalidValue;
  const int rows_blk = 16 * warps_per_block / split;
  // K, V, the q rows, and with a key split the warps' partial outputs
  const size_t smem = sizeof(bf16) * LDB * (2 * (size_t)((S + 15) & ~15) + rows_blk) +
                      (split > 1 ? sizeof(float) * split * 16 * LDR : 0);
  dim3 grid(B * H, (S + rows_blk - 1) / rows_blk);
  // key steps bounded by 2, 4, 5 or 8 (S <= 32, 64, 80, 128: every CLIP length)
  const int nks = S <= 32 ? 2 : S <= 64 ? 4 : S <= 80 ? 5 : 8;
  void (*kern)(const bf16*, const bf16*, const bf16*, bf16*, const int*, const float*, long long,
               int, int, float, int, int) =
      split == 1 ? (nks == 2 ? attention_small_bf16_kernel<1, 2>
                    : nks == 4 ? attention_small_bf16_kernel<1, 4>
                    : nks == 5 ? attention_small_bf16_kernel<1, 5>
                               : attention_small_bf16_kernel<1, 8>)
                 : (nks == 2 ? attention_small_bf16_kernel<KSPLIT, 2>
                    : nks == 4 ? attention_small_bf16_kernel<KSPLIT, 4>
                    : nks == 5 ? attention_small_bf16_kernel<KSPLIT, 5>
                               : attention_small_bf16_kernel<KSPLIT, 8>);
  cudaError_t err = set_smem((const void*)kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, 32 * warps_per_block, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), len, m, mask_bstride, S, H, scale, causal, aligned);
  return (int)cudaGetLastError();
}
