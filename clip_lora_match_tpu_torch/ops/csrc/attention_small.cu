// Whole-sequence multi-head attention for CLIP's short sequences (S <= 128).
//
// Replaces: clip_lora_match_tpu/ops/attention_small.py (attention_small:
//   _kernel_packed, _kernel_inkmask, _kernel / _kernel_nomask_adapter).
// Contract kept exactly: q, k, v, o in the (B, S, H*hd) projection layout, no
//   transposes; scores = (q . k) * scale in fp32; the max-free softmax
//   e = exp(min(s, 80)); P (rounded to the input type, as the TPU kernel casts
//   it before its P.V dot) times V in fp32; the result divided by
//   max(sum(e), 1e-30), so a fully masked row gives zeros. Three mask modes:
//   none; structural (causal and/or per-row key lengths, built in-kernel);
//   an additive fp32 (B|1, 1, S, S) mask.
// What bounds it on the H100: bytes. q, k, v and o are each read or written
//   once (B*S*H*hd elements each); the work is 4*S*S*hd FLOPs per (b, h), far
//   below the card's ridge point at S <= 80.
// Design: one block per (batch row, head, tile of 16 query rows), so even a
//   single request (B = 1) fills 48-60 blocks. The head's K (row stride hd+1,
//   so the lanes of a warp reading one column of 32 keys hit 32 banks) and V
//   are staged in shared memory as fp32 (keys past the tile's last causal row
//   are not staged); each warp walks query rows, each lane
//   scores keys lane, lane+32, ...; the probabilities go to a per-warp buffer
//   and each lane then accumulates two output columns of P.V. No cross-block
//   state. CUDA-core fp32 arithmetic; tensor cores are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxSeq = 128;
constexpr int kRowsPerBlock = 16;

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

template <typename T, int HD>
__global__ void attention_small_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const int* __restrict__ lengths,
    const float* __restrict__ mask, long long mask_bstride,
    int S, int H, float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;                         // S x (HD + 1)
  float* vs = ks + S * (HD + 1);            // S x HD
  float* qrow = vs + S * HD;                // kWarps x HD
  float* prob = qrow + kWarps * HD;         // kWarps x S

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * HD;
  const long long base = (long long)b * S * D + (long long)h * HD;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int row1 = min(S, row0 + kRowsPerBlock);
  // keys this tile can see: all S, or up to its last row when causal
  const int kv_rows = causal ? row1 : S;

  for (int idx = tid; idx < kv_rows * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD;
    const long long off = base + (long long)j * D + d;
    ks[j * (HD + 1) + d] = to_f(k[off]);
    vs[j * HD + d] = to_f(v[off]);
  }
  __syncthreads();

  const int klen = lengths ? min(lengths[b], S) : S;
  const float* mrow_base = mask ? mask + (long long)b * mask_bstride : nullptr;
  float* qw = qrow + warp * HD;
  float* pw = prob + warp * S;

  for (int i = row0 + warp; i < row1; i += kWarps) {
    for (int d = lane; d < HD; d += 32) qw[d] = to_f(q[base + (long long)i * D + d]);
    __syncwarp();
    float local_sum = 0.f;
    for (int j = lane; j < kv_rows; j += 32) {
      const float* kr = ks + j * (HD + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qw[d], kr[d], s);
      s *= scale;
      float e;
      if (j >= klen || (causal && j > i)) {
        e = 0.f;  // exp(s + finfo.min) underflows to exactly 0
      } else {
        if (mrow_base) s += mrow_base[(long long)i * S + j];
        e = expf(fminf(s, 80.f));
      }
      local_sum += e;
      pw[j] = to_f(from_f<T>(e));
    }
    for (int off = 16; off > 0; off >>= 1)
      local_sum += __shfl_xor_sync(0xffffffffu, local_sum, off);
    __syncwarp();
    const float inv = 1.f / fmaxf(local_sum, 1e-30f);
    for (int d = lane; d < HD; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < kv_rows; ++j) acc = fmaf(pw[j], vs[j * HD + d], acc);
      o[base + (long long)i * D + d] = from_f<T>(acc * inv);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, const float* mask, long long mask_bstride,
                   int B, int S, int H, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int HD = 64;
  const size_t smem =
      sizeof(float) * ((size_t)S * (HD + 1) + (size_t)S * HD + kWarps * HD + (size_t)kWarps * S);
  auto kern = attention_small_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B * H, (S + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lengths, mask, mask_bstride, S, H, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim must be 64, 1 <= S <= 128.
// lengths: (B,) int32 or null; mask: fp32 with batch stride mask_bstride
// (0 for a shared (1, 1, S, S) mask) or null.
extern "C" int attention_small_fwd(
    const void* q, const void* k, const void* v, void* o, const void* lengths,
    const void* mask, long long mask_bstride, int B, int S, int H, int head_dim,
    float scale, int causal, int dtype, void* stream) {
  if (head_dim != 64 || S < 1 || S > kMaxSeq || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, len, m, mask_bstride, B, S, H, scale, causal, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, len, m, mask_bstride, B, S, H, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
