// Blockwise (flash) attention with an online softmax and an optional additive mask.
//
// Replaces: clip_lora_match_tpu/ops/flash_attention.py (flash_attention: _kernel).
// Contract kept: q, k, v, o in the (B, S, H, 64) projection layout, no
//   transposes; all arithmetic in fp32 whatever the input type (the TPU
//   kernel casts q, k, v to fp32 and never rounds P); q is scaled before the
//   q.k product; an additive fp32 mask (B|1, 1, S, S) is added to the
//   scores; the softmax is the running-max form: per KV tile a row max m,
//   alpha = exp(m_old - m_new), p = exp(s - m_new), denominator and P.V
//   accumulator rescaled by alpha; the output is acc / denominator in the
//   input type. Keys past S contribute exactly 0 (the TPU kernel pads them
//   with finfo(float32).min); a key masked with finfo.min gives exp(-huge) = 0
//   as long as its row has an unmasked key, and a row masked everywhere
//   attends uniformly, as softmax(s + mask) does.
// What bounds it on the H100: operations. 4*S*S*64 FLOPs per (batch, head)
//   against 4*S*64 elements moved: at S = 577 that is ~290 FLOPs per fp32
//   byte, past the fp32 ridge (67 TF/s over 3.35 TB/s = 20). fp32 has no
//   tensor-core path short of TF32, which the contract rules out.
// Design: one block per (batch*head, tile of 64 query rows); 256 threads, each
//   owning 4 query rows x 4 key columns of the score tile and 4 rows x 4
//   head-dim columns of the output, so a row's 64 scores live in 16 lanes of
//   one half-warp and reduce with 4 xor shuffles. The query tile (scaled) and
//   each KV tile are staged in shared memory as fp32, q and k transposed, so
//   every inner step reads one 16-byte vector of each operand. The (S, S)
//   scores never leave registers except one 64 x 64 P tile in shared memory
//   for the P.V product. Nothing carries across blocks; the TPU grid's KV
//   axis is the loop inside the block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int HD = 64;        // head_dim
constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int LD = 68;        // shared row stride in floats: 16-byte aligned rows
constexpr int SMEM_FLOATS = 4 * HD * LD;  // qT, kT, vs, pT

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const float* __restrict__ mask, long long mask_bstride,
    int S, int H, int n_qtiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [HD][LD]: qT[d][r] = scale * q[r][d]
  float* kT = qT + HD * LD;     // [HD][LD]: kT[d][c] = k[c][d]
  float* vs = kT + HD * LD;     // [BKV][LD]: vs[c][d] = v[c][d]
  float* pT = vs + BKV * LD;    // [BKV][LD]: pT[c][r] = p[r][c]

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int b = bh / H, h = bh % H;
  const long long rs = (long long)H * HD;  // stride between sequence positions
  const long long base = (long long)b * S * rs + (long long)h * HD;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float* mrow = mask ? mask + (long long)b * mask_bstride : nullptr;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int gr = q0 + r;
    qT[d * LD + r] = gr < S ? scale * to_f(q[base + gr * rs + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BKV) {
    const int kn = min(BKV, S - k0);
    __syncthreads();  // the previous tile's kT / vs / pT are no longer read
    for (int idx = tid; idx < BKV * HD; idx += THREADS) {
      const int c = idx / HD, d = idx % HD;
      const bool ok = c < kn;
      const long long off = base + (long long)(k0 + c) * rs + d;
      kT[d * LD + c] = ok ? to_f(k[off]) : 0.f;
      vs[c * LD + d] = ok ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * LD + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(kT + d * LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a padded query row reads the last real row's mask; it is not stored
      const int row = min(q0 + ty * 4 + i, S - 1);
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (c < kn) {
          if (mrow) s[i][j] += mrow[(long long)row * S + k0 + c];
          tmax = fmaxf(tmax, s[i][j]);
        }
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      // a row whose scores so far are all -inf (an -inf mask) keeps p = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (tx * 4 + j < kn) ? expf(s[i][j] - m_use) : 0.f;
        s[i][j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pT + c * LD + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(vs + c * LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[base + (long long)row * rs + tx * 4 + j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const float* mask,
                   long long mask_bstride, int B, int S, int H, float scale,
                   cudaStream_t stream) {
  auto kern = flash_attention_kernel<T>;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (S + BQ - 1) / BQ;
  const long long blocks = (long long)B * H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), mask, mask_bstride, S, H, n_qtiles, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim must be 64. mask: fp32 with
// batch stride mask_bstride (0 for a shared (1, 1, S, S) mask) or null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const void* mask, long long mask_bstride, int B, int S,
                                   int H, int head_dim, float scale, int dtype,
                                   void* stream) {
  if (head_dim != HD || S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, m, mask_bstride, B, S, H, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, m, mask_bstride, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
