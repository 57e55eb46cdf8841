// Exact 1-nearest-neighbour search of brute correspondence, for sm_90a.
//
// Replaces the TPU kernel delora_tpu/ops/pallas/nn_search.py::_nn_kernel,
// launched by _nn_search_single and _nn_search_batched (nn_search_pallas and
// its vmap rule). For every source point s of batch b, over the valid targets
// t of the same batch:
//   d(s, t) = (|s|^2 + |t|^2) - 2 s.t,
// with |x|^2 = fma(z, z, fma(y, y, x * x)) and s.t = fma(sz, tz, fma(sy, ty,
// sx * tx)) in float32, each fma rounded once: the order in which the
// reference's kernel forms them (its cross term is a matmul whose CPU
// evaluation runs this fma chain; the plain PyTorch version in
// delora_tpu_torch/ops/cuda/nn_search.py repeats it with exact fmas). The
// running minimum starts at 1e30 with index 0 and takes a candidate on strict
// <, in target-index order, so ties go to the lower index and a source with
// no valid target gets (0, 1e30), as the reference's kernel (its chunk argmin
// then strict-< merge). Invalid targets (the reference's 1e30 bias row) never
// enter the search.
//
// Two passes:
//   1. compact: one block per batch packs that batch's valid targets, in
//      index order, as (x, y, z, |t|^2) with their original indices (a
//      block-wide prefix sum over warp ballots). At KITTI density at least
//      65% of the 131,072 target slots are padding or non-survivors, and
//      this pass lets the search skip them; it changes no output.
//   2. search: a block holds kSrcPerThread * kThreads sources in registers and
//      walks the batch's packed targets in shared-memory tiles of kTile;
//      every thread of a warp reads the same target (a broadcast).
//
// Bound: about 8 x 46,080 sources x (valid targets) pairs a train step, some
// 1.7e10 at KITTI density, each 8 float32 operations (the dot product's three
// multiplies and two adds, the two adds of the combination, the compare):
// about 2 ms at 67 TFLOP/s; the bytes (sources, targets, flags, outputs, some
// 21 MB) take 6 us. Operations set the bound. Each pair here issues five
// float32 instructions (one multiply, three fmas, one add) plus a compare and
// two selects, from registers and one shared-memory broadcast; the tensor
// cores, which would compute the cross term at a higher rate in TF32 or
// split bf16, are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCompactThreads = 1024;
constexpr int kThreads = 256;
constexpr int kSrcPerThread = 2;
constexpr int kTile = 1024;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__global__ void nn_compact_targets(const float* __restrict__ tgt,
                                   const unsigned char* __restrict__ valid,
                                   float4* __restrict__ packed, int* __restrict__ orig,
                                   int* __restrict__ count, int T) {
  __shared__ int warp_total[kCompactThreads / 32];
  __shared__ int running;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* tb = tgt + static_cast<long long>(b) * T * 3;
  const unsigned char* vb = valid + static_cast<long long>(b) * T;
  float4* pb = packed + static_cast<long long>(b) * T;
  int* ob = orig + static_cast<long long>(b) * T;
  if (threadIdx.x == 0) running = 0;
  __syncthreads();
  for (int base = 0; base < T; base += kCompactThreads) {
    const int j = base + threadIdx.x;
    const bool flag = j < T && vb[j] != 0;
    const unsigned int ballot = __ballot_sync(0xffffffffu, flag);
    const int lane_prefix = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the warp totals
      const int v = warp_total[lane];
      int incl = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += n;
      }
      warp_total[lane] = incl - v;
    }
    __syncthreads();
    const int dst = running + warp_total[warp] + lane_prefix;
    if (flag) {
      const float x = tb[3LL * j], y = tb[3LL * j + 1], z = tb[3LL * j + 2];
      pb[dst] = make_float4(x, y, z, sum_sq(x, y, z));
      ob[dst] = j;
    }
    __syncthreads();
    if (threadIdx.x == kCompactThreads - 1) running = dst + (flag ? 1 : 0);
    __syncthreads();
  }
  if (threadIdx.x == 0) count[b] = running;
}

__global__ void nn_search(const float* __restrict__ src, const float4* __restrict__ packed,
                          const int* __restrict__ orig, const int* __restrict__ count,
                          int* __restrict__ out_idx, float* __restrict__ out_sq, int S, int T) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const long long sbase = static_cast<long long>(b) * S;
  const float4* pb = packed + static_cast<long long>(b) * T;
  const int n = count[b];

  float sx[kSrcPerThread], sy[kSrcPerThread], sz[kSrcPerThread], ssq[kSrcPerThread];
  float best[kSrcPerThread];
  int best_j[kSrcPerThread];
#pragma unroll
  for (int k = 0; k < kSrcPerThread; ++k) {
    const int i = (blockIdx.x * kSrcPerThread + k) * kThreads + threadIdx.x;
    const float* s = src + (sbase + (i < S ? i : 0)) * 3;
    sx[k] = s[0];
    sy[k] = s[1];
    sz[k] = s[2];
    ssq[k] = sum_sq(sx[k], sy[k], sz[k]);
    best[k] = kBig;
    best_j[k] = -1;
  }
  for (int base = 0; base < n; base += kTile) {
    const int m = min(kTile, n - base);
    __syncthreads();
    for (int t = threadIdx.x; t < m; t += kThreads) tile[t] = pb[base + t];
    __syncthreads();
    for (int t = 0; t < m; ++t) {
      const float4 q = tile[t];
#pragma unroll
      for (int k = 0; k < kSrcPerThread; ++k) {
        const float cross = __fmaf_rn(sz[k], q.z, __fmaf_rn(sy[k], q.y, __fmul_rn(sx[k], q.x)));
        // (|s|^2 + |t|^2) - 2 cross, one rounding: 2 cross is exact.
        const float d = __fmaf_rn(-2.0f, cross, __fadd_rn(ssq[k], q.w));
        if (d < best[k]) {
          best[k] = d;
          best_j[k] = base + t;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSrcPerThread; ++k) {
    const int i = (blockIdx.x * kSrcPerThread + k) * kThreads + threadIdx.x;
    if (i >= S) continue;
    out_idx[sbase + i] = best_j[k] >= 0 ? orig[static_cast<long long>(b) * T + best_j[k]] : 0;
    out_sq[sbase + i] = best[k];
  }
}

}  // namespace

// src [batch, S, 3] f32, tgt [batch, T, 3] f32, valid [batch, T] bool (one
// byte each), all contiguous; packed [batch, T] float4, orig [batch, T]
// int32 and count [batch] int32 are scratch; out_idx [batch, S] int32,
// out_sq [batch, S] f32. All on the stream's device; T >= 1.
extern "C" int nn_search_launch(const void* src, const void* tgt, const void* valid,
                                void* packed, void* orig, void* count, void* out_idx,
                                void* out_sq, int batch, int S, int T, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch > 0 && S > 0) {
    nn_compact_targets<<<batch, kCompactThreads, 0, st>>>(
        static_cast<const float*>(tgt), static_cast<const unsigned char*>(valid),
        static_cast<float4*>(packed), static_cast<int*>(orig), static_cast<int*>(count), T);
    const int per_block = kThreads * kSrcPerThread;
    const dim3 grid((S + per_block - 1) / per_block, batch);
    nn_search<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(src), static_cast<const float4*>(packed),
        static_cast<const int*>(orig), static_cast<const int*>(count),
        static_cast<int*>(out_idx), static_cast<float*>(out_sq), S, T);
  }
  return static_cast<int>(cudaGetLastError());
}
