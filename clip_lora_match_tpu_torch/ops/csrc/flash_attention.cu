// Blockwise (flash) attention with an online softmax and an optional additive mask.
//
// Replaces: clip_lora_match_tpu/ops/flash_attention.py (flash_attention: _kernel).
// Contract kept: q, k, v, o in the (B, S, H, 64) projection layout, no
//   transposes; all arithmetic at fp32 accuracy whatever the input type (the
//   TPU kernel casts q, k, v to fp32 and never rounds P); q is scaled before
//   the q.k product; an additive fp32 mask (B|1, 1, S, S) is added to the
//   scores; the softmax is the running-max form: per KV tile a row max m,
//   alpha = exp(m_old - m_new), p = exp(s - m_new), denominator and P.V
//   accumulator rescaled by alpha; the output is acc / denominator in the
//   input type. Keys past S contribute exactly 0 (the TPU kernel pads them
//   with finfo(float32).min); a key masked with finfo.min gives exp(-huge) = 0
//   as long as its row has an unmasked key, and a row masked everywhere
//   attends uniformly, as softmax(s + mask) does.
// What bounds it on the H100: operations. 4*S*S*64 FLOPs per (batch, head)
//   against 4*S*64 elements moved: at S = 577 ~290 FLOPs per fp32 byte. Both
//   products run on the tensor cores in TF32 with a split operand: x = hi +
//   lo, hi = x rounded to TF32, lo = x - hi, and a.b = hi.hi + hi.lo + lo.hi
//   (3xTF32), which keeps the product's error near fp32's (the dropped lo.lo
//   is ~2^-22 relative) at 495 / 3 = 165 dense TFLOP/s, against 67 for fp32
//   FMA on the CUDA cores. An operand that TF32 holds exactly drops its lo
//   products: bf16 k and v always, bf16 q when the scale is a power of two
//   (hd = 64: 1/8). So the bound is 3 x flops / 495e12 for fp32 inputs. In
//   practice the issue slots bound it: per warp and 64-key tile, 384 mma.sync
//   beside ~1,400 other instructions (288 operand splits, the softmax, the
//   fragment loads); wgmma, which frees them, takes TF32 only K-major and
//   would need V transposed in shared memory.
// Design (FA2-style): one block of 4 warps per (batch*head, 64 query rows);
//   each warp owns 16 query rows and runs mma.sync m16n8k8 TF32. The scaled
//   q fragments (hi and lo) stay in registers for the whole key sweep; the
//   scores, P and the output accumulator never leave registers. K and V
//   tiles of 64 keys are double-buffered in shared memory in their stored
//   type by cp.async (the next tile loads while this one computes) and
//   split into hi / lo in registers. Three blocks fit an SM (<= 168
//   registers a thread). Two index permutations remove every
//   shuffle and transpose: within each 16-wide slice of the head dim, the
//   k index t of a q.k step reads d = 4t + 2h (+1), so a thread reads 4
//   consecutive d of q and k with one vector load for two steps; within
//   each 8-key chunk, P.V's k index t reads key 2t (t + 4: key 2t + 1), so
//   the score accumulator is, register for register, P.V's A fragment, and
//   V's B fragment reads rows 2t and 2t + 1. Padded row strides keep both
//   K (vector) and V (scalar) fragment loads free of bank conflicts. Row
//   maxima reduce over the 4 lanes of a quad with 2 xor shuffles; the
//   denominator stays a per-lane partial sum until the end. Nothing carries
//   across blocks; the TPU grid's KV axis is the loop inside the block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 64;        // head_dim
constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Layout;
// row strides of the K and V tiles, in elements: K rows are read as one
// 16- (fp32) or 8-byte (bf16) vector per lane, V rows one element per lane
template <> struct Layout<float> { static constexpr int LDK = 80, LDV = 68; };
template <> struct Layout<__nv_bfloat16> { static constexpr int LDK = 80, LDV = 72; };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the 3xTF32 operand split and product, shared with retrieval_tilemax.cu; the
// split is integer arithmetic because 288 splits per warp and key tile made
// cvt.rna.tf32.f32 the limit
using hopper::mma_tf32;
using hopper::split;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 consecutive elements of a shared-memory row as fp32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// SPLIT_Q: the scaled q is not exact in TF32 (fp32 input, or a scale that is
// not a power of two); k and v split whenever T is fp32
template <typename T, bool SPLIT_Q>
__global__ void __launch_bounds__(THREADS, 3) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const float* __restrict__ mask, long long mask_bstride,
    int S, int H, int n_qtiles, float scale) {
  constexpr bool SPLIT_KV = sizeof(T) == 4;
  constexpr int LDK = Layout<T>::LDK, LDV = Layout<T>::LDV;
  constexpr int STAGE = BKV * (LDK + LDV);
  constexpr int CPR = HD * (int)sizeof(T) / 16, EPC = 16 / (int)sizeof(T);  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // 2 stages of [K: BKV x LDK][V: BKV x LDV]

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int b = bh / H, h = bh % H;
  const long long rs = (long long)H * HD;  // stride between sequence positions
  const long long base = (long long)b * S * rs + (long long)h * HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const float* mrow = mask ? mask + (long long)b * mask_bstride : nullptr;
  const int n_tiles = (S + BKV - 1) / BKV;

  auto load_tile = [&](int t) {
    T* ks = tiles + (t & 1) * STAGE;
    T* vs = ks + BKV * LDK;
    const int k0 = t * BKV;
    for (int ch = tid; ch < BKV * CPR; ch += THREADS) {
      const int c = ch / CPR, e = (ch % CPR) * EPC;
      const bool ok = k0 + c < S;
      const long long off = base + (long long)(ok ? k0 + c : 0) * rs + e;
      cp_async16(ks + c * LDK + e, k + off, ok);
      cp_async16(vs + c * LDV + e, v + off, ok);
    }
    cp_async_commit();
  };
  load_tile(0);

  // this warp's query rows r[0] = 16 warp + g and r[1] = r[0] + 8; q.k step
  // ks = 2 kp + hh reads d = 16 kp + 4 t4 + 2 hh (A column t4) and + 1 (t4 + 4)
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    float a[4], c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * kp + 4 * t4 + e;
      a[e] = r0 < S ? scale * to_f(q[base + r0 * rs + d]) : 0.f;
      c[e] = r1 < S ? scale * to_f(q[base + r1 * rs + d]) : 0.f;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float f[4] = {a[2 * hh], c[2 * hh], a[2 * hh + 1], c[2 * hh + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (SPLIT_Q) split(f[e], qh[2 * kp + hh][e], ql[2 * kp + hh][e]);
        else qh[2 * kp + hh][e] = __float_as_uint(f[e]);  // exact in TF32
      }
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);  // into the other stage, freed by the previous iteration's last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = tiles + (t & 1) * STAGE;
    const T* vs = ks + BKV * LDK;
    const int k0 = t * BKV;

    // s (16 x 64) = q . k^T; s[nt]: keys 8 nt + 2 t4 (+1), rows g (e < 2) and g + 8
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    // each step issues one product per key tile nt before the next product:
    // eight independent accumulators between two dependent mma
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      float kv[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) load4(ks + (8 * nt + g) * LDK + 16 * kp + 4 * t4, kv[nt]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int st = 2 * kp + hh;
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (SPLIT_KV) split(kv[nt][2 * hh + e], bh[nt][e], bl[nt][e]);
            else bh[nt][e] = __float_as_uint(kv[nt][2 * hh + e]);  // bf16: exact in TF32
          }
        if (SPLIT_KV)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma_tf32(s[nt], qh[st], bl[nt][0], bl[nt][1]);
        if (SPLIT_Q)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma_tf32(s[nt], ql[st], bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_tf32(s[nt], qh[st], bh[nt][0], bh[nt][1]);
      }
    }

    // mask, running max, p = exp(s - m), rescale
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // a padded query row reads the last real row's mask; it is not stored
      const int row = min(hf ? r1 : r0, S - 1);
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * nt + 2 * t4 + e;
          float sv = s[nt][2 * hf + e];
          if (key >= S) sv = -INFINITY;
          else if (mrow) sv += mrow[(long long)row * S + key];
          s[nt][2 * hf + e] = sv;
          tmax = fmaxf(tmax, sv);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[hf], tmax);
      // a row whose scores so far are all -inf (an -inf mask) keeps p = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f((m[hf] - m_use) * LOG2E);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f((s[nt][2 * hf + e] - m_use) * LOG2E);
          s[nt][2 * hf + e] = p;
          psum += p;
        }
      l[hf] = l[hf] * alpha + psum;  // this lane's share of the row's denominator
      m[hf] = m_new;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][2 * hf] *= alpha;
        acc[nt][2 * hf + 1] *= alpha;
      }
    }

    // acc (16 x 64) += P . V over 8-key chunks kc: P.V's k index t4 is key
    // 8 kc + 2 t4 and t4 + 4 is key 8 kc + 2 t4 + 1, so s[kc] is the A fragment
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      uint32_t ph[4], pl[4];
      split(s[kc][0], ph[0], pl[0]);
      split(s[kc][2], ph[1], pl[1]);
      split(s[kc][1], ph[2], pl[2]);
      split(s[kc][3], ph[3], pl[3]);
      const T* v0 = vs + (8 * kc + 2 * t4) * LDV + g;
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f = to_f(v0[e * LDV + 8 * nt]);
          if (SPLIT_KV) split(f, bh[nt][e], bl[nt][e]);
          else bh[nt][e] = __float_as_uint(f);
        }
      if (SPLIT_KV)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], ph, bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], pl, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], ph, bh[nt][0], bh[nt][1]);
    }
    __syncthreads();  // this stage is the target of the load two tiles on
  }

  // acc[nt]: head dims 8 nt + 2 t4 (+1), rows g (e < 2) and g + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float den = l[hf];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = hf ? r1 : r0;
    if (row >= S) continue;
    const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      store2<T>(o + base + (long long)row * rs + 8 * nt + 2 * t4, acc[nt][2 * hf] * inv,
                acc[nt][2 * hf + 1] * inv);
  }
}

template <typename T, bool SPLIT_Q>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const float* mask,
                   long long mask_bstride, int B, int S, int H, float scale,
                   cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, SPLIT_Q>;
  const int smem = 2 * BKV * (Layout<T>::LDK + Layout<T>::LDV) * (int)sizeof(T);
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

// dtype: 0 = float32, 1 = bfloat16. head_dim must be 64; q, k, v, o 16-byte
// aligned. mask: fp32 with batch stride mask_bstride (0 for a shared
// (1, 1, S, S) mask) or null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const void* mask, long long mask_bstride, int B, int S,
                                   int H, int head_dim, float scale, int dtype,
                                   void* stream) {
  if (head_dim != HD || S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0) return (int)launch<float, true>(q, k, v, o, m, mask_bstride, B, S, H, scale, st);
  if (dtype == 1) {
    // q * scale is exact in TF32 when the scale is a power of two (bf16 q has 8 bits)
    int e;
    const bool pow2 = scale > 0.f && frexpf(scale, &e) == 0.5f;
    if (pow2)
      return (int)launch<__nv_bfloat16, false>(q, k, v, o, m, mask_bstride, B, S, H, scale, st);
    return (int)launch<__nv_bfloat16, true>(q, k, v, o, m, mask_bstride, B, S, H, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
