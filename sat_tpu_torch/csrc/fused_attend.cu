// fused_attend: the 2-layer soft-attention step of the decoder, for Hopper.
//
// Replaces the TPU kernel `_make_kernel` (unmasked body) of
// sat_tpu/ops/pallas_attention.py, reached through `fused_attend`.  Per
// batch row b:
//
//   temp[n,k] = t1[b,n,k] + t2[b,k]                       fp32
//   logit[n]  = rnd(sum_k rnd(temp[n,k]) * rnd(w2[k]))     product and sum fp32
//   alpha     = softmax_n(logit)                           fp32
//   ctx[d]    = sum_n alpha[n] * contexts[b,n,d]           fp32
//
// where rnd() rounds through the model's compute dtype (bf16; identity
// for fp32), exactly where the Pallas kernel rounds.
//
// Bound: bytes.  The kernel must read t1 and contexts once each, B*N*(da+D)
// fp32 values (77.1 MB at B=96, N=196, da=D=512: 23 us at 3.35 TB/s), and
// does ~2 flops per byte read, far below the card's ridge point.
//
// Design: one block of 256 threads per row b.  Only the N logits (and the
// row's t2 and rounded w2) stay in shared memory; t1 and contexts are
// streamed from device memory exactly once, so no online softmax is
// needed.  Phase 1: warps take positions n in turn, lanes stride over da
// with 16-byte loads, a shuffle reduction gives logit[n].  Phase 2: a
// block-wide max, exp and sum, alpha written out.  Phase 3: threads own
// 16-byte column groups of D and loop over n with coalesced loads; when
// D/4 < 256 the threads split n into groups and combine the partial sums
// in shared memory.  Loops are bounded by N, da and D, never padded; the
// 16-byte path needs da and D to be multiples of 4 (else a scalar path).
//
// Known cost: B blocks for B rows, so at B=96 only 96 of the 132 SMs work.
//
// C interface (loaded with ctypes): fused_attend_launch() enqueues on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// compute-dtype rounding: 0 = float32, 1 = bfloat16
template <int MODE>
__device__ __forceinline__ float rnd(float x) {
  if (MODE == 1) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide reduction through `red` (kWarps floats); every thread gets it
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ float4 f4_add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 f4_fma(float s, float4 a, float4 c) {
  return make_float4(fmaf(s, a.x, c.x), fmaf(s, a.y, c.y), fmaf(s, a.z, c.z),
                     fmaf(s, a.w, c.w));
}

// VEC_DA: da % 4 == 0 (16-byte loads in phase 1)
// VEC_D:  D % 4 == 0  (16-byte loads in phase 3)
template <int MODE, bool VEC_DA, bool VEC_D>
__global__ void __launch_bounds__(kThreads)
fused_attend_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
                    const float* __restrict__ w2, const float* __restrict__ ctx,
                    float* __restrict__ out_ctx, float* __restrict__ out_alpha,
                    int N, int da, int D) {
  // shared layout (floats, each part a multiple of 4 for 16-byte access):
  //   t2s[da4] | w2s[da4] | part[4*kThreads] | red[32] | logit[N]
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int da4 = (da + 3) & ~3;
  float* t2s = smem;
  float* w2s = t2s + da4;
  float* part = w2s + da4;
  float* red = part + 4 * kThreads;
  float* logit = red + 32;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* t1b = t1 + (size_t)b * N * da;
  const float* t2b = t2 + (size_t)b * da;
  const float* cb = ctx + (size_t)b * N * D;

  for (int k = tid; k < da; k += kThreads) {
    t2s[k] = t2b[k];
    w2s[k] = rnd<MODE>(w2[k]);
  }
  __syncthreads();

  // ---- phase 1: logits ----
  for (int n = warp; n < N; n += kWarps) {
    const float* row = t1b + (size_t)n * da;
    float acc = 0.f;
    if (VEC_DA) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const float4* t24 = reinterpret_cast<const float4*>(t2s);
      const float4* w24 = reinterpret_cast<const float4*>(w2s);
#pragma unroll 4
      for (int k = lane; k < (da >> 2); k += 32) {
        const float4 x = __ldg(row4 + k);
        const float4 a = t24[k];
        const float4 w = w24[k];
        acc += rnd<MODE>(x.x + a.x) * w.x;
        acc += rnd<MODE>(x.y + a.y) * w.y;
        acc += rnd<MODE>(x.z + a.z) * w.z;
        acc += rnd<MODE>(x.w + a.w) * w.w;
      }
    } else {
      for (int k = lane; k < da; k += 32) {
        acc += rnd<MODE>(__ldg(row + k) + t2s[k]) * w2s[k];
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) logit[n] = rnd<MODE>(acc);
  }
  __syncthreads();

  // ---- phase 2: softmax over N ----
  float m = -CUDART_INF_F;
  for (int n = tid; n < N; n += kThreads) m = fmaxf(m, logit[n]);
  m = block_reduce<true>(m, red);
  float s = 0.f;
  for (int n = tid; n < N; n += kThreads) {
    const float e = expf(logit[n] - m);
    logit[n] = e;
    s += e;
  }
  s = block_reduce<false>(s, red);
  float* ab = out_alpha + (size_t)b * N;
  for (int n = tid; n < N; n += kThreads) {
    const float a = logit[n] / s;
    logit[n] = a;
    ab[n] = a;
  }
  __syncthreads();

  // ---- phase 3: ctx = alpha @ contexts ----
  float* ob = out_ctx + (size_t)b * D;
  if (VEC_D) {
    const int cols = D >> 2;  // float4 columns
    const float4* c4 = reinterpret_cast<const float4*>(cb);
    float4* part4 = reinterpret_cast<float4*>(part);
    if (cols >= kThreads) {
      for (int c = tid; c < cols; c += kThreads) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int n = 0; n < N; ++n) acc = f4_fma(logit[n], __ldg(c4 + (size_t)n * cols + c), acc);
        reinterpret_cast<float4*>(ob)[c] = acc;
      }
    } else {
      const int groups = kThreads / cols;
      const int g = tid / cols, c = tid % cols;
      if (g < groups) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int n = g; n < N; n += groups)
          acc = f4_fma(logit[n], __ldg(c4 + (size_t)n * cols + c), acc);
        part4[g * cols + c] = acc;
      }
      __syncthreads();
      if (tid < cols) {
        float4 acc = part4[tid];
        for (int gg = 1; gg < groups; ++gg) acc = f4_add(acc, part4[gg * cols + tid]);
        reinterpret_cast<float4*>(ob)[tid] = acc;
      }
    }
  } else {
    if (D >= kThreads) {
      for (int d = tid; d < D; d += kThreads) {
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(logit[n], __ldg(cb + (size_t)n * D + d), acc);
        ob[d] = acc;
      }
    } else {
      const int groups = kThreads / D;
      const int g = tid / D, d = tid % D;
      if (g < groups) {
        float acc = 0.f;
        for (int n = g; n < N; n += groups) acc = fmaf(logit[n], __ldg(cb + (size_t)n * D + d), acc);
        part[g * D + d] = acc;
      }
      __syncthreads();
      if (tid < D) {
        float acc = part[tid];
        for (int gg = 1; gg < groups; ++gg) acc += part[gg * D + tid];
        ob[tid] = acc;
      }
    }
  }
}

template <int MODE, bool VEC_DA, bool VEC_D>
cudaError_t launch(const float* t1, const float* t2, const float* w2, const float* ctx,
                   float* out_ctx, float* out_alpha, int B, int N, int da, int D,
                   size_t smem, cudaStream_t stream) {
  auto kernel = fused_attend_kernel<MODE, VEC_DA, VEC_D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, smem, stream>>>(t1, t2, w2, ctx, out_ctx, out_alpha, N, da, D);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_vec(const float* t1, const float* t2, const float* w2,
                         const float* ctx, float* out_ctx, float* out_alpha, int B,
                         int N, int da, int D, size_t smem, cudaStream_t stream) {
  const bool vda = (da % 4) == 0, vd = (D % 4) == 0;
  if (vda && vd)
    return launch<MODE, true, true>(t1, t2, w2, ctx, out_ctx, out_alpha, B, N, da, D, smem, stream);
  if (vda)
    return launch<MODE, true, false>(t1, t2, w2, ctx, out_ctx, out_alpha, B, N, da, D, smem, stream);
  if (vd)
    return launch<MODE, false, true>(t1, t2, w2, ctx, out_ctx, out_alpha, B, N, da, D, smem, stream);
  return launch<MODE, false, false>(t1, t2, w2, ctx, out_ctx, out_alpha, B, N, da, D, smem, stream);
}

// bytes of dynamic shared memory one block needs
size_t smem_bytes(int N, int da) {
  const int da4 = (da + 3) & ~3;
  return sizeof(float) * (size_t)(2 * da4 + 4 * kThreads + 32 + N);
}

}  // namespace

extern "C" {

// mode: 0 = float32, 1 = bfloat16 compute dtype.
// Returns a cudaError_t (0 = launched).
int fused_attend_launch(const float* t1, const float* t2, const float* w2,
                        const float* ctx, float* out_ctx, float* out_alpha, int B,
                        int N, int da, int D, int mode, void* stream) {
  if (B <= 0 || N <= 0 || da <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, da);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)dispatch_vec<0>(t1, t2, w2, ctx, out_ctx, out_alpha, B, N, da, D, smem, s);
    case 1: return (int)dispatch_vec<1>(t1, t2, w2, ctx, out_ctx, out_alpha, B, N, da, D, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fused_attend_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
