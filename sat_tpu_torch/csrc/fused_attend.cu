// fused_attend: the 2-layer soft-attention step of the decoder, for Hopper.
//
// Replaces both TPU kernels of sat_tpu/ops/pallas_attention.py, reached
// through `fused_attend`: the unmasked body `_make_kernel` (MASKED =
// false, the monolithic beam search) and the row-masked body
// `_make_masked_kernel` (MASKED = true, the slot pool's stepped decode).
// Per batch row b:
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
// does ~2 flops per byte read, far below the card's ridge point.  So the
// design's aim is bytes in flight on many SMs, and a short chain of
// dependent steps for a row, which is all a small batch waits on.
//
// Design: one thread-block cluster of S blocks per row (grid S*B, cluster
// S; S and every partition below come from the launch plan, which the
// wrapper computes from (N, da, D) alone: `attend_plan` in
// ops/fused_attend.py).  Block s of a row owns
//   positions [s*nb, (s+1)*nb) of N, which it scores, and
//   columns   [s*cw, (s+1)*cw) of D, whose weighted sum it computes.
// At the flagship shape (N=196, da=D=512, S=8) that is 25 positions and
// 64 columns: 51 KB of t1 and 50 KB of contexts a block, 768 blocks at
// B=96 (two an SM), 24 SMs instead of 3 at B=3.
//
//   Prologue: every thread requests its share of the block's bytes with
//     16-byte cp.async copies (4-byte ones when da or D is not a multiple
//     of 4) into a ring of kStages shared-memory stages, in one copy group
//     a chunk: t2, w2 and the t1 rows first, then the contexts slice.  At
//     the decode path's shapes each is one chunk, so all ~100 KB are
//     requested up front and the contexts arrive while the block scores.
//     Where a slice does not fit, the plan cuts it into chunks of rows and
//     the ring refills a stage as soon as it is consumed.  (t2 and w2 in
//     the first group matter: loaded by plain loads after the copies, they
//     came back only after the whole 100 KB, and scoring waited for it.)
//   Phase 1: a warp scores four positions at once from shared memory;
//     lanes stride over da in float4 and warp_sum adds them, each
//     position's sum in the order it would have alone.  Lanes q < S push
//     the logit into block q's shared memory (distributed shared memory).
//   Phase 2: one cluster barrier; then every warp of every block holds all
//     N logits and runs the same max and sum in the same order, so all S
//     blocks hold bitwise the same alpha.  Each block writes the alpha of
//     its own positions.
//   Phase 3: ctx for the block's columns over all N, from shared memory:
//     thread (u, g) sums column unit u over rows g, g + G, ...; the G
//     partial sums, lanes of one warp, are added by shuffles in a fixed
//     order.  Rows are padded to an odd number of 16-byte units, so the G
//     rows a warp reads at once fall in distinct banks.
//   No block reads a peer after the barrier, so none waits for its peers
//   before it exits; a barrier at the start (arrive early, wait just
//   before the first push) makes sure every peer has started.
//
// Tried on the H100 and not faster at the decode path's shapes (PERF.md):
// 16 blocks a row (a non-portable cluster size), 512 threads a block, TMA
// bulk copies instead of cp.async, and a split of the weighted sum over N
// (partial contexts combined after the barrier).
//
// Invariance: a row's outputs depend on that row's inputs and on
// (N, da, D, mode) only.  The plan, the chunking and every summation
// order are functions of the shapes; nothing depends on B, on the row's
// index, on the mask of other rows or on the SM count.  So a row decoded
// in the slot pool is bitwise the same row decoded in any batch.
//
// Masked body: row_mask[b] == 0 marks a dead pool slot, whose inputs may
// hold NaN or Inf.  The flag is uniform over the row's cluster: its S
// blocks split the +0.0 writes of alpha and ctx and return before any
// barrier or copy, without reading t1, t2 or contexts; a live row runs the
// unmasked code unchanged and comes out bitwise equal to it.  Bound:
// bytes of the live rows only, r*N*(da+D)*4 for r live rows (38.5 MB at
// 48 live rows of the flagship pool).
//
// C interface (loaded with ctypes): fused_attend_launch() enqueues on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the cluster launch's own error).  A null
// row_mask launches the unmasked body.  A plan that does not describe a
// valid launch for (N, da, D), or whose layout() takes more than 227 KB of
// shared memory, is refused with cudaErrorInvalidValue.  The shared-memory
// layout is layout() below; attend_plan's smem_bytes is the same sum, so
// that a shape that does not fit raises in Python: change both together.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // THREADS in ops/fused_attend.py
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;         // STAGES in ops/fused_attend.py
constexpr int kMaxCluster = 8;     // CLUSTER in ops/fused_attend.py: the portable limit
constexpr int kMaxSmem = 232448;   // 227 KB of dynamic shared memory a block
constexpr int kMaxDevices = 64;

// The launch plan (attend_plan in ops/fused_attend.py).
struct Plan {
  int cluster;         // S blocks per row
  int rows_per_block;  // nb: block s scores positions [s*nb, (s+1)*nb) of N
  int cols_per_block;  // cw: block s sums columns [s*cw, (s+1)*cw) of D
  int t1_chunk_rows;   // rows of t1 per ring stage
  int ctx_chunk_rows;  // rows of the contexts slice per ring stage
  int stage_floats;    // floats per ring stage, a multiple of 4
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Floats between two rows of a contexts chunk in shared memory: the
// block's cw columns, padded to an odd number of 16-byte (VEC_D) or
// 4-byte units, so that the rows phase 3 reads at once fall in distinct
// banks.
__host__ __device__ inline int ctx_stride(int cw, bool vec_d) {
  return vec_d ? 4 * ((cw / 4) | 1) : (cw | 1);
}

// Groups of rows phase 3 splits a column unit's sum into: a power of two
// up to 32, so each unit's groups are lanes of one warp.
__host__ __device__ inline int sum_groups(int units) {
  int g = 32;
  while (g > 1 && g * units > kThreads) g >>= 1;
  return g;
}

// Shared layout in floats, each part a multiple of 4 (16-byte aligned):
//   ring[kStages*stage] | t2s[da4] | w2s[da4] | la[N4] | al[N4]
// la: all N logits, pushed in by every block of the cluster; al: alpha.
struct Layout {
  int t2s, w2s, la, al, total;
};

__host__ __device__ inline Layout layout(const Plan& p, int N, int da) {
  Layout L;
  L.t2s = kStages * p.stage_floats;
  L.w2s = L.t2s + round4(da);
  L.la = L.w2s + round4(da);
  L.al = L.la + round4(N);
  L.total = L.al + round4(N);
  return L;
}

// compute-dtype rounding: 0 = float32, 1 = bfloat16
template <int MODE>
__device__ __forceinline__ float rnd(float x) {
  if (MODE == 1) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// rnd of two floats at once: one bf16x2 conversion (half the conversion
// instructions of two rnd calls), the same rounding
template <int MODE>
__device__ __forceinline__ float2 rnd2(float a, float b) {
  if (MODE == 1) return __bfloat1622float2(__floats2bfloat162_rn(a, b));
  return make_float2(a, b);
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

__device__ __forceinline__ float vzero(float) { return 0.f; }
__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float vfma(float s, float a, float c) { return fmaf(s, a, c); }
__device__ __forceinline__ float4 vfma(float s, float4 a, float4 c) {
  return make_float4(fmaf(s, a.x, c.x), fmaf(s, a.y, c.y), fmaf(s, a.z, c.z),
                     fmaf(s, a.w, c.w));
}
// v + the v of the lane o places away (xor), every lane of the warp taking part
__device__ __forceinline__ float vadd_xor(float v, int o) {
  return v + __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float4 vadd_xor(float4 v, int o) {
  return make_float4(vadd_xor(v.x, o), vadd_xor(v.y, o), vadd_xor(v.z, o), vadd_xor(v.w, o));
}

// asynchronous copy of one float (4 bytes) or float4 (16 bytes) into shared memory
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kStages - 1 of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kScoreRows = 4;  // positions a warp scores at once

// MASKED: row_mask[b] == 0 rows write zeros and return
// VEC_DA: da % 4 == 0 (16-byte copies and float4 scoring)
// VEC_D:  D % 4 == 0  (16-byte copies and float4 sums in phase 3)
template <int MODE, bool MASKED, bool VEC_DA, bool VEC_D>
__global__ void __launch_bounds__(kThreads)
fused_attend_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
                    const float* __restrict__ w2, const float* __restrict__ ctx,
                    const unsigned char* __restrict__ row_mask,
                    float* __restrict__ out_ctx, float* __restrict__ out_alpha,
                    int N, int da, int D, Plan p) {
  using VA = typename std::conditional<VEC_DA, float4, float>::type;
  using VD = typename std::conditional<VEC_D, float4, float>::type;
  constexpr int QA = VEC_DA ? 4 : 1, QD = VEC_D ? 4 : 1;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(p, N, da);
  float* ring = smem;
  float* t2s = smem + L.t2s;
  float* w2s = smem + L.w2s;
  float* la = smem + L.la;
  float* al = smem + L.al;

  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.cluster;
  const int s = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's positions [n0, n1) and columns [c0, c1); either may be empty
  const int n0 = min(N, s * p.rows_per_block), n1 = min(N, n0 + p.rows_per_block);
  const int c0 = min(D, s * p.cols_per_block), c1 = min(D, c0 + p.cols_per_block);

  if (MASKED && row_mask[b] == 0) {  // uniform over the cluster: no barrier is reached
    for (int n = n0 + tid; n < n1; n += kThreads) out_alpha[(size_t)b * N + n] = 0.f;
    for (int d = c0 + tid; d < c1; d += kThreads) out_ctx[(size_t)b * D + d] = 0.f;
    return;
  }
  cluster_arrive_relaxed();  // this block has started: peers may write to it
  const float* t1b = t1 + (size_t)b * N * da;
  const float* cb = ctx + (size_t)b * N * D;

  // the block's stream of chunks: t1 rows first, then contexts rows
  const int nv = n1 - n0, w = c1 - c0, units = w / QD;
  const int cs = ctx_stride(p.cols_per_block, VEC_D) / QD;  // VD units a contexts row
  const int t1_chunks = (nv + p.t1_chunk_rows - 1) / p.t1_chunk_rows;
  const int ctx_chunks = w > 0 ? (N + p.ctx_chunk_rows - 1) / p.ctx_chunk_rows : 0;
  const int chunks = t1_chunks + ctx_chunks;
  // a thread copies column unit cu of rows cr, cr + cstep, ... of each contexts chunk
  const int cu = units ? tid % units : 0, cr = units ? tid / units : 0;
  const int cstep = units ? kThreads / units : 0;
  auto stage = [&](int c) { return ring + (c % kStages) * p.stage_floats; };
  auto fetch = [&](int c) {  // one copy group per chunk, empty past the end
    if (c == 0 && nv > 0) {  // t2 and w2 come first, with the first t1 rows
      const VA* t2b = reinterpret_cast<const VA*>(t2 + (size_t)b * da);
      for (int i = tid; i < da / QA; i += kThreads) {
        cp_async(reinterpret_cast<VA*>(t2s) + i, t2b + i);
        cp_async(reinterpret_cast<VA*>(w2s) + i, reinterpret_cast<const VA*>(w2) + i);
      }
    }
    if (c < t1_chunks) {
      const int r0 = c * p.t1_chunk_rows;
      const int count = min(p.t1_chunk_rows, nv - r0) * da / QA;
      const VA* src = reinterpret_cast<const VA*>(t1b + (size_t)(n0 + r0) * da);
      VA* dst = reinterpret_cast<VA*>(stage(c));
      for (int i = tid; i < count; i += kThreads) cp_async(dst + i, src + i);
    } else if (c < chunks) {
      const int r0 = (c - t1_chunks) * p.ctx_chunk_rows;
      const int rows = min(p.ctx_chunk_rows, N - r0);
      VD* dst = reinterpret_cast<VD*>(stage(c)) + cu;
      const VD* src = reinterpret_cast<const VD*>(cb + (size_t)r0 * D + c0) + cu;
      if (cr < cstep)
        for (int r = cr; r < rows; r += cstep) cp_async(dst + r * cs, src + (size_t)r * (D / QD));
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < kStages; ++c) fetch(c);
  cluster_wait();  // every peer has started

  // ---- phase 1: the logits of positions [n0, n1), pushed to every peer ----
  for (int c = 0; c < t1_chunks; ++c) {
    cp_async_wait_stage();
    __syncthreads();
    if (MODE == 1 && c == 0) {  // w2 rounded once, where the Pallas kernel rounds it
      for (int k = tid; k < da; k += kThreads) w2s[k] = rnd<MODE>(w2s[k]);
      __syncthreads();
    }
    const float* buf = stage(c);
    const int r0 = c * p.t1_chunk_rows, rows = min(p.t1_chunk_rows, nv - r0);
    // a warp scores kScoreRows positions at once (rows past the chunk's end
    // read its last row and are not stored); each position's sum runs in
    // the same order as if it were scored alone
    for (int rw = warp; rw < rows; rw += kWarps * kScoreRows) {
      float acc[kScoreRows];
      const float* row[kScoreRows];
#pragma unroll
      for (int j = 0; j < kScoreRows; ++j) {
        acc[j] = 0.f;
        row[j] = buf + (size_t)min(rw + j * kWarps, rows - 1) * da;
      }
      if (VEC_DA) {
        const float4* t24 = reinterpret_cast<const float4*>(t2s);
        const float4* w24 = reinterpret_cast<const float4*>(w2s);
#pragma unroll 2
        for (int k = lane; k < (da >> 2); k += 32) {
          const float4 a = t24[k];
          const float4 wk = w24[k];
#pragma unroll
          for (int j = 0; j < kScoreRows; ++j) {
            const float4 x = reinterpret_cast<const float4*>(row[j])[k];
            const float2 lo = rnd2<MODE>(x.x + a.x, x.y + a.y);
            const float2 hi = rnd2<MODE>(x.z + a.z, x.w + a.w);
            acc[j] += lo.x * wk.x;
            acc[j] += lo.y * wk.y;
            acc[j] += hi.x * wk.z;
            acc[j] += hi.y * wk.w;
          }
        }
      } else {
        for (int k = lane; k < da; k += 32) {
#pragma unroll
          for (int j = 0; j < kScoreRows; ++j) acc[j] += rnd<MODE>(row[j][k] + t2s[k]) * w2s[k];
        }
      }
#pragma unroll
      for (int j = 0; j < kScoreRows; ++j) {
        const int r = rw + j * kWarps;
        const float v = rnd<MODE>(warp_sum(acc[j]));  // every lane holds the sum
        if (r < rows && lane < S) cluster.map_shared_rank(la, lane)[n0 + r0 + r] = v;
      }
    }
    __syncthreads();  // the stage is free again
    fetch(c + kStages);
  }

  // ---- phase 2: softmax over N, every warp of every block alike ----
  cluster_arrive();  // release: this block's logits are in every peer
  cluster_wait();    // acquire: every peer's are in this block; no peer is touched again
  float m = -CUDART_INF_F;
  for (int n = lane; n < N; n += 32) m = fmaxf(m, la[n]);
  m = warp_max(m);
  float sum = 0.f;
  for (int n = lane; n < N; n += 32) sum += expf(la[n] - m);
  sum = warp_sum(sum);
  float* ab = out_alpha + (size_t)b * N;
  for (int n = tid; n < N; n += kThreads) {
    const float a = expf(la[n] - m) / sum;
    al[n] = a;
    if (n >= n0 && n < n1) ab[n] = a;
  }
  __syncthreads();

  // ---- phase 3: ctx[c0:c1] = alpha @ contexts[:, c0:c1] ----
  // thread tid sums column unit tid / G over rows g, g + G, ... (g = tid % G);
  // the G partial sums of a unit, lanes of one warp, are added by shuffles
  if (w > 0) {
    const int G = sum_groups(units);
    const int u = tid / G, g = tid & (G - 1);
    VD acc = vzero(VD());
    for (int c = t1_chunks; c < chunks; ++c) {
      cp_async_wait_stage();
      __syncthreads();
      const VD* buf = reinterpret_cast<const VD*>(stage(c));
      const int r0 = (c - t1_chunks) * p.ctx_chunk_rows, rows = min(p.ctx_chunk_rows, N - r0);
      if (u < units) {
#pragma unroll 4
        for (int r = g; r < rows; r += G) acc = vfma(al[r0 + r], buf[r * cs + u], acc);
      }
      __syncthreads();
      fetch(c + kStages);
    }
    for (int o = G >> 1; o > 0; o >>= 1) acc = vadd_xor(acc, o);
    if (g == 0 && u < units) reinterpret_cast<VD*>(out_ctx + (size_t)b * D + c0)[u] = acc;
  }
}

template <int MODE, bool MASKED, bool VEC_DA, bool VEC_D>
cudaError_t launch(const float* t1, const float* t2, const float* w2, const float* ctx,
                   const unsigned char* mask, float* out_ctx, float* out_alpha, int B,
                   int N, int da, int D, const Plan& p, int smem, cudaStream_t stream) {
  auto kernel = fused_attend_kernel<MODE, MASKED, VEC_DA, VEC_D>;
  // once per instantiation and device (each setting costs more host time
  // than the launch): the most dynamic shared memory a block may take and
  // the largest carveout
  static std::atomic<bool> configured[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured[device].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.cluster) * static_cast<unsigned>(B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, t1, t2, w2, ctx, mask, out_ctx, out_alpha, N, da, D, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MODE, bool MASKED>
cudaError_t dispatch_vec(const float* t1, const float* t2, const float* w2,
                         const float* ctx, const unsigned char* mask, float* out_ctx,
                         float* out_alpha, int B, int N, int da, int D, const Plan& p,
                         int smem, cudaStream_t stream) {
  const bool vda = (da % 4) == 0, vd = (D % 4) == 0;
  if (vda && vd)
    return launch<MODE, MASKED, true, true>(t1, t2, w2, ctx, mask, out_ctx, out_alpha, B, N, da, D, p, smem, stream);
  if (vda)
    return launch<MODE, MASKED, true, false>(t1, t2, w2, ctx, mask, out_ctx, out_alpha, B, N, da, D, p, smem, stream);
  if (vd)
    return launch<MODE, MASKED, false, true>(t1, t2, w2, ctx, mask, out_ctx, out_alpha, B, N, da, D, p, smem, stream);
  return launch<MODE, MASKED, false, false>(t1, t2, w2, ctx, mask, out_ctx, out_alpha, B, N, da, D, p, smem, stream);
}

template <int MODE>
cudaError_t dispatch_mask(const float* t1, const float* t2, const float* w2,
                          const float* ctx, const unsigned char* mask, float* out_ctx,
                          float* out_alpha, int B, int N, int da, int D, const Plan& p,
                          int smem, cudaStream_t stream) {
  if (mask == nullptr)
    return dispatch_vec<MODE, false>(t1, t2, w2, ctx, mask, out_ctx, out_alpha, B, N, da, D, p, smem, stream);
  return dispatch_vec<MODE, true>(t1, t2, w2, ctx, mask, out_ctx, out_alpha, B, N, da, D, p, smem, stream);
}

// the plan covers every position and column, its chunks fit their stage,
// phase 3 has a thread for each column unit, and its layout fits in shared
// memory
bool plan_ok(const Plan& p, int N, int da, int D) {
  const bool vec_d = (D % 4) == 0;
  if (p.cluster < 1 || p.cluster > kMaxCluster) return false;
  if (p.rows_per_block < 1 || (long long)p.cluster * p.rows_per_block < N) return false;
  if (p.cols_per_block < 1 || (long long)p.cluster * p.cols_per_block < D) return false;
  if (vec_d && p.cols_per_block % 4 != 0) return false;
  if (p.cols_per_block / (vec_d ? 4 : 1) > kThreads) return false;
  if (p.stage_floats < 4 || p.stage_floats % 4 != 0) return false;
  if (p.t1_chunk_rows < 1 || (long long)p.t1_chunk_rows * da > p.stage_floats) return false;
  if (p.ctx_chunk_rows < 1 ||
      (long long)p.ctx_chunk_rows * ctx_stride(p.cols_per_block, vec_d) > p.stage_floats)
    return false;
  const long long floats = (long long)kStages * p.stage_floats + 2 * (((long long)da + 3) & ~3LL) +
                           2 * (((long long)N + 3) & ~3LL);  // layout().total, without overflow
  return floats * 4 <= kMaxSmem;
}

}  // namespace

extern "C" {

// mode: 0 = float32, 1 = bfloat16 compute dtype.  row_mask: [B] bytes,
// 0 = dead row, or null for the unmasked body.  The last six ints are
// the launch plan (attend_plan in ops/fused_attend.py, all but its
// smem_bytes, which is layout() here).
// Returns a cudaError_t (0 = launched).
int fused_attend_launch(const float* t1, const float* t2, const float* w2,
                        const float* ctx, const unsigned char* row_mask, float* out_ctx,
                        float* out_alpha, int B, int N, int da, int D, int mode,
                        void* stream, int cluster, int rows_per_block, int cols_per_block,
                        int t1_chunk_rows, int ctx_chunk_rows, int stage_floats) {
  if (B <= 0 || N <= 0 || da <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const Plan p{cluster, rows_per_block, cols_per_block, t1_chunk_rows, ctx_chunk_rows,
               stage_floats};
  if (!plan_ok(p, N, da, D)) return (int)cudaErrorInvalidValue;
  const int smem_bytes = layout(p, N, da).total * 4;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)dispatch_mask<0>(t1, t2, w2, ctx, row_mask, out_ctx, out_alpha, B, N, da, D, p, smem_bytes, s);
    case 1: return (int)dispatch_mask<1>(t1, t2, w2, ctx, row_mask, out_ctx, out_alpha, B, N, da, D, p, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fused_attend_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
