// Dense winner placement of the range-image projection, for sm_90a.
//
// Replaces the TPU kernel delora_tpu/ops/pallas/placement.py::_placement_kernel
// (launched by placement_pallas). Each pixel holds the payload (and, when
// asked, the range) of its winner; empty pixels hold zeros. Two winner rules,
// chosen by the caller:
//   exact  (delora_tpu/ops/projection.py::project_compact_exact): the point
//          with the smallest range and, among equal ranges, the lowest index;
//   packed (delora_tpu/ops/projection.py::project_image_packed, :319-322): the
//          reference sorts stably on pix << 16 | f32_bits(range) >> 16, so the
//          winner is the lowest index among the points whose ranges agree with
//          the smallest in the top 16 bits (ranges > 0 there, so the bits
//          order like the floats).
// The TPU kernel's bf16 hi/mid/lo split, one-hot matmul and prefetched
// windows existed only to place values with the TPU's matrix unit and have no
// counterpart here, and neither has its window overflow: no winner is ever
// dropped.
//
// Three passes, each one thread per element:
//   1. init:   keys[b, p] = ~0 for every pixel,
//   2. select: each in-range point does atomicMin(&keys[b, pix], (range key
//              << 32) | index), the range key being the order-preserving f32
//              bits (exact) or the top 16 bits of the f32 (packed); the
//              minimum key is the rule's winner,
//   3. write:  each pixel copies its winner's payload (and range), or zeros.
// Pass 3 copies floats without arithmetic, so the image is bit-equal to the
// plain PyTorch version (delora_tpu_torch/ops/cuda/placement.py). -0.0 orders
// before +0.0 here but ties with it in a sort; projection only places ranges
// > 0, where the two agree.
//
// Bound: the function must move pix and range of every point (8 B each), the
// payload of each winner only (C floats) and the image once (C or C + 1
// floats a pixel); the keys are scratch. For a 64x720 scan with N = 131072
// points, C = 3 and 88% of pixels occupied that is about 2.27 MB, 0.68 us at
// 3.35 TB/s; for the train step's re-projection (B = 8, N = 46,080, C = 7, no
// range channel) about 22 MB, 6.7 us. Launch overhead of the three passes
// sets the serving time. Making it fast (one fused launch, fewer key bytes)
// is later work.

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
                               int packed, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int p = pix[i];
  if (static_cast<unsigned int>(p) >= static_cast<unsigned int>(hw)) return;  // culled
  const long long b = i / n;
  const unsigned int idx = static_cast<unsigned int>(i - b * n);
  const unsigned int range_key =
      packed ? (__float_as_uint(r[i]) >> 16) : ordered_bits(r[i]);
  const unsigned long long key = (static_cast<unsigned long long>(range_key) << 32) | idx;
  atomicMin(&keys[b * hw + p], key);
}

__global__ void write_image(const float* __restrict__ r, const float* __restrict__ vals,
                            const unsigned long long* __restrict__ keys,
                            float* __restrict__ out, int n, int c, int hw,
                            int append_range, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  float* o = out + i * (c + append_range);
  const unsigned long long key = keys[i];
  if (key == kEmpty) {
    for (int k = 0; k < c + append_range; ++k) o[k] = 0.0f;
    return;
  }
  const long long b = i / hw;
  const long long src = b * n + static_cast<long long>(key & 0xffffffffull);
  const float* v = vals + src * c;
  for (int k = 0; k < c; ++k) o[k] = v[k];
  if (append_range) o[c] = r[src];
}

unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

// pix [batch, n] int32 (>= hw or < 0: culled), r [batch, n] f32,
// vals [batch, n, c] f32, keys [batch, hw] u64 scratch,
// out [batch, hw, c + append_range] f32. All contiguous, on the stream's
// device. packed: 0 for the exact rule, 1 for the packed rule.
extern "C" int placement_launch(const void* pix, const void* r, const void* vals,
                                void* keys, void* out, int batch, int n, int c,
                                int hw, int packed, int append_range, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<unsigned long long*>(keys);
  const long long pixels = static_cast<long long>(batch) * hw;
  const long long points = static_cast<long long>(batch) * n;
  if (pixels > 0) {
    init_keys<<<blocks_for(pixels), kThreads, 0, s>>>(k, pixels);
  }
  if (pixels > 0 && points > 0) {
    select_winners<<<blocks_for(points), kThreads, 0, s>>>(
        static_cast<const int*>(pix), static_cast<const float*>(r), k, n, hw, packed, points);
  }
  if (pixels > 0) {
    write_image<<<blocks_for(pixels), kThreads, 0, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(vals), k,
        static_cast<float*>(out), n, c, hw, append_range, pixels);
  }
  return static_cast<int>(cudaGetLastError());
}
