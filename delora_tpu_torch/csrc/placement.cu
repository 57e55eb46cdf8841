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
// Bound: the function must move pix and range of every point (8 B each), the
// payload of each winner only (C floats) and the image once (C or C + 1
// floats a pixel); the keys are scratch. For a 64x720 scan with N = 131072
// points, C = 3 and 88% of pixels occupied that is about 2.27 MB, 0.68 us at
// 3.35 TB/s; for the train step's re-projection (B = 8, N = 46,080, C = 7, no
// range channel) about 22 MB, 6.7 us.
//
// Two passes, at most two launches a call, on a key workspace that the
// caller keeps between calls (one per device and stream) and that holds only
// empty keys (all bits set) whenever no call is running:
//   1. select_winners, one thread per point: pix and range are read
//      coalesced; each in-range point does atomicMin(&keys[b, pix], key). The
//      packed rule with N <= 65536 takes a 32-bit key,
//      (f32_bits(range) >> 16) << 16 | index: ranges > 0 leave its top bit
//      clear, so it never equals the empty key. The exact rule (order-
//      preserving f32 bits << 32 | index) and the packed rule with more
//      points (top 16 bits << 32 | index) take 64-bit keys. The minimum key
//      is the rule's winner.
//   2. write_and_reset, one block a tile of kTile pixels of one batch row:
//      the block loads the tile's keys into shared memory as winner indices
//      and resets the non-empty ones to empty in global memory; after a
//      barrier its threads walk the tile's kTile * (C + append_range) output
//      floats in order, so stores are coalesced and neighbouring threads read
//      neighbouring floats of a winner's payload row; each thread issues up
//      to kUnroll of its gathers before it stores any. Staging the keys in
//      shared memory is what makes the reset safe: no thread reads a key from
//      global memory after another has reset it. The next call finds a clean
//      workspace, so no pass fills it.
// What this does about the earlier design's costs: no init pass (it wrote
// B*H*W*8 B of ~0 each call); half the atomic and key bytes for the main
// path's packed rule; one store instruction of a warp covers 128 contiguous
// bytes instead of 32 words C + append_range floats apart; one launch fewer.
// On the host, the wrapper (delora_tpu_torch/ops/cuda/placement.py) sets the
// ctypes argument types once, checks inputs with attribute tests, reads the
// raw stream without a device context and allocates only the output; this
// function makes the stream's device current only when it is not.
// Pass 2 copies payload bits without arithmetic, so the image is bit-equal
// to the plain PyTorch version (delora_tpu_torch/ops/cuda/placement.py).
// -0.0 orders before +0.0 under the exact key but ties with it in a sort;
// projection only places ranges > 0, where the two agree.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // select: points a block
constexpr int kTile = 256;          // write: pixels a block, one key a thread
constexpr int kUnroll = 8;          // write: output floats a thread gathers at once
constexpr int kMaxGridY = 65535;    // batch rows beyond it loop in the block

template <typename Key>
__device__ __forceinline__ Key empty_key() {
  return ~Key(0);
}

template <typename Key>
__device__ __forceinline__ int winner_index(Key key);

template <>
__device__ __forceinline__ int winner_index<unsigned int>(unsigned int key) {
  return static_cast<int>(key & 0xffffu);
}

template <>
__device__ __forceinline__ int winner_index<unsigned long long>(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffull);
}

__device__ __forceinline__ unsigned int ordered_bits(float x) {
  // Monotonic map from float order to unsigned order (negatives reversed).
  const unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <typename Key>
__device__ __forceinline__ Key make_key(float r, unsigned int idx, int packed);

template <>
__device__ __forceinline__ unsigned int make_key<unsigned int>(float r, unsigned int idx,
                                                              int /*packed*/) {
  return (__float_as_uint(r) & 0xffff0000u) | idx;
}

template <>
__device__ __forceinline__ unsigned long long make_key<unsigned long long>(
    float r, unsigned int idx, int packed) {
  const unsigned int range_key = packed ? (__float_as_uint(r) >> 16) : ordered_bits(r);
  return (static_cast<unsigned long long>(range_key) << 32) | idx;
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
select_winners(const int* __restrict__ pix, const float* __restrict__ r,
               Key* __restrict__ keys, int n, int hw, int batch, int packed) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long at = static_cast<long long>(b) * n + i;
    const int p = __ldg(pix + at);
    const float range = __ldg(r + at);    // loaded beside pix, not after it
    if (static_cast<unsigned int>(p) >= static_cast<unsigned int>(hw)) continue;  // culled
    atomicMin(keys + static_cast<long long>(b) * hw + p,
              make_key<Key>(range, static_cast<unsigned int>(i), packed));
  }
}

// Payload floats move as their bits.
template <typename Key>
__global__ void __launch_bounds__(kTile)
write_and_reset(const unsigned int* __restrict__ r, const unsigned int* __restrict__ vals,
                Key* __restrict__ keys, unsigned int* __restrict__ out, int n, int c,
                int cout, int hw, int batch) {
  __shared__ int winner[kTile];    // the pixel's winner within its row, or -1
  const int p0 = blockIdx.x * kTile;
  const int count = min(kTile, hw - p0);
  const long long total = static_cast<long long>(count) * cout;
  // Thread t starts at float t of the tile, pixel t / cout, channel t % cout,
  // and steps kTile floats at a time.
  const int p_first = cout > 0 ? threadIdx.x / cout : 0;
  const int k_first = cout > 0 ? threadIdx.x % cout : 0;
  const int p_step = cout > 0 ? kTile / cout : 0;
  const int k_step = cout > 0 ? kTile % cout : 0;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    if (threadIdx.x < count) {
      Key* key_at = keys + static_cast<long long>(b) * hw + p0 + threadIdx.x;
      const Key key = *key_at;
      const bool empty = key == empty_key<Key>();
      winner[threadIdx.x] = empty ? -1 : winner_index<Key>(key);
      if (!empty) *key_at = empty_key<Key>();
    }
    __syncthreads();
    const unsigned int* vb = vals + static_cast<long long>(b) * n * c;
    const unsigned int* rb = r + static_cast<long long>(b) * n;
    unsigned int* o = out + (static_cast<long long>(b) * hw + p0) * cout;
    int p = p_first, k = k_first;
    for (long long j0 = threadIdx.x; j0 < total; j0 += kUnroll * kTile) {
      // kUnroll independent gathers in flight before the first store.
      unsigned int v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = 0u;
        if (j0 + u * kTile < total) {
          const int w = winner[p];
          if (w >= 0) {
            v[u] = k < c ? __ldg(vb + static_cast<long long>(w) * c + k) : __ldg(rb + w);
          }
        }
        p += p_step;
        k += k_step;
        if (k >= cout) {
          k -= cout;
          ++p;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u * kTile < total) o[j0 + u * kTile] = v[u];
      }
    }
    __syncthreads();    // the tile's winners are read before the next row's
  }
}

template <typename Key>
void launch(const void* pix, const void* r, const void* vals, void* keys, void* out,
            int batch, int n, int c, int hw, int packed, int append_range,
            cudaStream_t s) {
  Key* k = static_cast<Key*>(keys);
  const unsigned int rows = static_cast<unsigned int>(batch < kMaxGridY ? batch : kMaxGridY);
  if (n > 0) {
    const dim3 grid(static_cast<unsigned int>((n + kThreads - 1) / kThreads), rows);
    select_winners<Key><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(pix), static_cast<const float*>(r), k, n, hw, batch, packed);
  }
  const dim3 grid(static_cast<unsigned int>((hw + kTile - 1) / kTile), rows);
  write_and_reset<Key><<<grid, kTile, 0, s>>>(
      static_cast<const unsigned int*>(r), static_cast<const unsigned int*>(vals), k,
      static_cast<unsigned int*>(out), n, c, c + append_range, hw, batch);
}

}  // namespace

// pix [batch, n] int32 (>= hw or < 0: culled), r [batch, n] f32,
// vals [batch, n, c] f32, keys: at least batch * hw * (key32 ? 4 : 8) bytes,
// every bit set (the kernel leaves them so), out [batch, hw, c +
// append_range] f32. All contiguous, on the stream's device. packed: 0 for
// the exact rule, 1 for the packed rule; key32: 32-bit keys (packed rule and
// n <= 65536 only). Launches on `stream` from `device`, which is made current
// for the call if it is not. Returns the CUDA error code, 0 on success.
extern "C" int placement_launch(const void* pix, const void* r, const void* vals,
                                void* keys, void* out, int batch, int n, int c,
                                int hw, int packed, int key32, int append_range,
                                int device, void* stream) {
  if (key32 && (!packed || n > 65536)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || hw <= 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key32) {
    launch<unsigned int>(pix, r, vals, keys, out, batch, n, c, hw, packed, append_range, s);
  } else {
    launch<unsigned long long>(pix, r, vals, keys, out, batch, n, c, hw, packed,
                               append_range, s);
  }
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
