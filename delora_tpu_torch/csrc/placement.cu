// Dense winner placement of the range-image projection, for sm_90a.
//
// Replaces the TPU kernel delora_tpu/ops/pallas/placement.py::_placement_kernel
// (launched by placement_pallas). It computes the same image as the reference's
// compact-exact projection (delora_tpu/ops/projection.py::project_compact_exact):
// each pixel holds the payload and range of its winner, the point with the
// smallest range and, among equal ranges, the lowest index; empty pixels hold
// zeros. The TPU kernel's bf16 hi/mid/lo split, one-hot matmul and prefetched
// windows existed only to place values with the TPU's matrix unit and have no
// counterpart here.
//
// Three passes, each one thread per element:
//   1. init:   keys[b, p] = ~0 for every pixel,
//   2. select: each in-range point does atomicMin(&keys[b, pix], (ordered range
//              bits << 32) | index); the ordered bits compare like the floats,
//              so the minimum key is the (range, index) winner,
//   3. write:  each pixel copies its winner's payload and range, or zeros.
// Pass 3 copies floats without arithmetic, so the image is bit-equal to the
// plain PyTorch version (delora_tpu_torch/ops/cuda/placement.py). -0.0 orders
// before +0.0 here but ties with it in a sort; projection only places ranges
// > 0, where the two agree.
//
// Bound: the function must move pix and range of every point (8 B each), the
// payload of each winner only (C floats) and the image once ((C + 1) floats a
// pixel); the keys are scratch. For a 64x720 scan with N = 131072 points,
// C = 3 and 88% of pixels occupied that is about 2.27 MB, at 3.35 TB/s about
// 0.68 us, so the launch overhead of the three passes sets its time. Making it
// fast (one fused launch, fewer key bytes) is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int ordered_bits(float x) {
  // Monotonic map from float order to unsigned order (negatives reversed).
  const unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void init_keys(unsigned long long* __restrict__ keys, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i < total) keys[i] = kEmpty;
}

__global__ void select_winners(const int* __restrict__ pix, const float* __restrict__ r,
                               unsigned long long* __restrict__ keys, int n, int hw,
                               long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int p = pix[i];
  if (static_cast<unsigned int>(p) >= static_cast<unsigned int>(hw)) return;  // culled
  const long long b = i / n;
  const unsigned int idx = static_cast<unsigned int>(i - b * n);
  const unsigned long long key =
      (static_cast<unsigned long long>(ordered_bits(r[i])) << 32) | idx;
  atomicMin(&keys[b * hw + p], key);
}

__global__ void write_image(const float* __restrict__ r, const float* __restrict__ vals,
                            const unsigned long long* __restrict__ keys,
                            float* __restrict__ out, int n, int c, int hw,
                            long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  float* o = out + i * (c + 1);
  const unsigned long long key = keys[i];
  if (key == kEmpty) {
    for (int k = 0; k <= c; ++k) o[k] = 0.0f;
    return;
  }
  const long long b = i / hw;
  const long long src = b * n + static_cast<long long>(key & 0xffffffffull);
  const float* v = vals + src * c;
  for (int k = 0; k < c; ++k) o[k] = v[k];
  o[c] = r[src];
}

unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

// pix [batch, n] int32 (>= hw or < 0: culled), r [batch, n] f32,
// vals [batch, n, c] f32, keys [batch, hw] u64 scratch,
// out [batch, hw, c + 1] f32. All contiguous, on the stream's device.
extern "C" int placement_launch(const void* pix, const void* r, const void* vals,
                                void* keys, void* out, int batch, int n, int c,
                                int hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<unsigned long long*>(keys);
  const long long pixels = static_cast<long long>(batch) * hw;
  const long long points = static_cast<long long>(batch) * n;
  if (pixels > 0) {
    init_keys<<<blocks_for(pixels), kThreads, 0, s>>>(k, pixels);
  }
  if (pixels > 0 && points > 0) {
    select_winners<<<blocks_for(points), kThreads, 0, s>>>(
        static_cast<const int*>(pix), static_cast<const float*>(r), k, n, hw, points);
  }
  if (pixels > 0) {
    write_image<<<blocks_for(pixels), kThreads, 0, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(vals), k,
        static_cast<float*>(out), n, c, hw, pixels);
  }
  return static_cast<int>(cudaGetLastError());
}
