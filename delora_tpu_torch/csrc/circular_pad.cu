// Circular width pad of channels-last (NHWC) activations, for sm_90a.
//
// Replaces no TPU kernel. The JAX reference pads azimuth with
// jnp.concatenate and rings with jnp.pad (delora_tpu/models/resnet.py:38,
// pad_circular_w), which XLA fuses into the operand of the next convolution.
// The port's eager equivalent was a torch.cat along W, the innermost NCHW
// dimension, then F.pad: narrow row copies, and in the backward two
// zero-filled tensors of the input's size, two column copies and two
// additions of the whole tensor. With the backbone's activations held NHWC on
// the card, one padded row is (W + 2 pad_w) * C contiguous elements, so the
// pad is one coalesced copy a row and its gradient one pass.
//
// Layouts: x [B, H, W, C] in memory (a channels-last [B, C, H, W] tensor),
// out [B, H + 2 pad_h, W + 2 pad_w, C]. Output pixel column j holds input
// column (j - pad_w) mod W; the pad_h rows above and below hold `fill`.
// Requires pad_w <= W.
//
// Bound: bytes. The forward reads the input once and writes the output once;
// the backward reads the output's gradient once (the halo columns are the
// only pixels read by a second thread, and each is read once) and writes the
// input's gradient once. The train step's largest pad is the max-pool's, B =
// 32 at 64x360 with 64 bfloat16 channels, padded to 66x362: 94.4 MB read and
// 97.9 MB written, 57.4 us at 3.35 TB/s.
//
// Design: one 2-D grid, blockIdx.y a row (b, h) of the array written,
// blockIdx.x * blockDim.x + threadIdx.x one vector of that row. A vector is
// 16 bytes where a pixel's C * element bytes and both pointers are multiples
// of 16, as for every layer of the model at its published widths (channel
// counts multiples of 8), and one element otherwise (models cut to fewer
// channels: factor_fewer_resnet_channels 16 leaves 4 bfloat16 channels, 8
// bytes a pixel). Since a pixel is a whole number of vectors, the wrap is a
// shift of the row by pad_w pixels with one conditional add or subtract of
// the row length: no division a vector, and consecutive threads read and
// write consecutive 16-byte words. The forward is a copy of bits (the fill's
// bytes come from the caller). The backward adds in the element type (float32 or bfloat16, the
// model's): the middle column's gradient, then the right halo's (the first
// pad_w columns' copies), then the left halo's (the last pad_w columns'),
// each sum rounded to the element type as PyTorch's additions round, so it
// matches the autograd of the plain version
// (delora_tpu_torch/ops/cuda/circular_pad.py), where a pixel has at most
// two terms (W >= 2 pad_w), bit for bit.

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;    // rows beyond it loop in the block

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return a + b;
}

template <>
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T, int N>
__device__ __forceinline__ void add_into(Pack<T, N>& acc, const Pack<T, N>& other) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc.v[i] = add(acc.v[i], other.v[i]);
}

// row_in = W * cv and row_out = (W + 2 pad_w) * cv vectors, shift = pad_w * cv.
template <typename Vec>
__global__ void __launch_bounds__(kThreads) wrap_pad_nhwc(
    const Vec* __restrict__ x, Vec* __restrict__ out, int rows_out, int height, int pad_h,
    int row_in, int row_out, int shift, uint4 fill_bytes) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= row_out) return;
  const Vec fill = *reinterpret_cast<const Vec*>(&fill_bytes);
  const int height_out = height + 2 * pad_h;
  for (int r = blockIdx.y; r < rows_out; r += gridDim.y) {
    const int b = r / height_out;
    const int h = r - b * height_out - pad_h;
    Vec* dst = out + static_cast<long long>(r) * row_out;
    if (h < 0 || h >= height) {
      dst[v] = fill;
      continue;
    }
    const Vec* src = x + (static_cast<long long>(b) * height + h) * row_in;
    int s = v - shift;
    if (s < 0) {
      s += row_in;
    } else if (s >= row_in) {
      s -= row_in;
    }
    dst[v] = src[s];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) wrap_pad_nhwc_grad(
    const Pack<T, N>* __restrict__ grad_out, Pack<T, N>* __restrict__ grad_in, int rows_in,
    int height, int pad_h, int row_in, int row_out, int shift) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= row_in) return;
  for (int r = blockIdx.y; r < rows_in; r += gridDim.y) {
    const int b = r / height;
    const int h = r - b * height;
    // The padded row of input row (b, h), from its first middle vector.
    const Pack<T, N>* src = grad_out
        + (static_cast<long long>(b) * (height + 2 * pad_h) + h + pad_h) * row_out + shift;
    Pack<T, N> acc = src[v];
    if (v < shift) add_into(acc, src[v + row_in]);            // right halo
    if (v >= row_in - shift) add_into(acc, src[v - row_in]);  // left halo
    grad_in[static_cast<long long>(r) * row_in + v] = acc;
  }
}

dim3 grid_of(int rows, int row_vectors) {
  return dim3(static_cast<unsigned int>((row_vectors + kThreads - 1) / kThreads),
              static_cast<unsigned int>(rows < kMaxGridY ? rows : kMaxGridY));
}

template <typename Vec>
void forward_as(const void* x, void* out, int rows_out, int height, int pad_h, int row_in,
                int row_out, int shift, uint4 fill, cudaStream_t s) {
  wrap_pad_nhwc<Vec><<<grid_of(rows_out, row_out), kThreads, 0, s>>>(
      static_cast<const Vec*>(x), static_cast<Vec*>(out), rows_out, height, pad_h, row_in,
      row_out, shift, fill);
}

template <typename T, int N>
void backward_as(const void* g, void* gx, int rows_in, int height, int pad_h, int row_in,
                 int row_out, int shift, cudaStream_t s) {
  wrap_pad_nhwc_grad<T, N><<<grid_of(rows_in, row_in), kThreads, 0, s>>>(
      static_cast<const Pack<T, N>*>(g), static_cast<Pack<T, N>*>(gx), rows_in, height, pad_h,
      row_in, row_out, shift);
}

// A 16-byte vector or one element of T a thread; false for another width.
template <typename T>
bool backward_typed(const void* g, void* gx, int vec_bytes, int rows_in, int height,
                    int pad_h, int row_in, int row_out, int shift, cudaStream_t s) {
  if (vec_bytes == 16) {
    backward_as<T, static_cast<int>(16 / sizeof(T))>(g, gx, rows_in, height, pad_h, row_in, row_out, shift, s);
    return true;
  }
  if (vec_bytes == static_cast<int>(sizeof(T))) {
    backward_as<T, 1>(g, gx, rows_in, height, pad_h, row_in, row_out, shift, s);
    return true;
  }
  return false;
}

// Vectors a row and the sizes in them; false if they do not fit in int.
bool row_vectors(int width, int pad_w, int pixel_bytes, int vec_bytes, int* row_in,
                 int* row_out, int* shift) {
  if (vec_bytes <= 0 || pixel_bytes % vec_bytes) return false;
  const long long cv = pixel_bytes / vec_bytes;
  const long long out = (static_cast<long long>(width) + 2 * pad_w) * cv;
  if (out > 0x7fffffffLL) return false;
  *row_in = static_cast<int>(width * cv);
  *row_out = static_cast<int>(out);
  *shift = static_cast<int>(pad_w * cv);
  return true;
}

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&current_);
    if (err_ == cudaSuccess && current_ != device) err_ = cudaSetDevice(device);
    device_ = device;
  }
  ~DeviceGuard() {
    if (current_ >= 0 && current_ != device_) cudaSetDevice(current_);
  }
  cudaError_t error() const { return err_; }

 private:
  int current_ = -1;
  int device_ = -1;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace

// x: [batch, height, width] pixels of pixel_bytes each (C elements of a
// channels-last tensor), contiguous; out: [batch, height + 2 pad_h,
// width + 2 pad_w] such pixels. fill: 16 bytes, the pad rows' element
// pattern repeated. vec_bytes: 16, where it divides pixel_bytes and both
// pointers' alignment, or the element's 4 (float32) or 2 (bfloat16) bytes. Launches on `stream` from `device`, made current for the call
// if it is not. Returns the CUDA error code, 0 on success.
extern "C" int circular_pad_forward(const void* x, void* out, int batch, int height, int width,
                                    int pixel_bytes, int pad_w, int pad_h, int vec_bytes,
                                    const void* fill, int device, void* stream) {
  int row_in, row_out, shift;
  if (pad_w < 0 || pad_h < 0 || pad_w > width
      || !row_vectors(width, pad_w, pixel_bytes, vec_bytes, &row_in, &row_out, &shift)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(batch) * (height + 2 * pad_h);
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || row_out == 0) return 0;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  uint4 fill_bytes;
  memcpy(&fill_bytes, fill, sizeof(fill_bytes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  switch (vec_bytes) {
    case 16: forward_as<uint4>(x, out, r, height, pad_h, row_in, row_out, shift, fill_bytes, s);
      break;
    case 4: forward_as<unsigned int>(x, out, r, height, pad_h, row_in, row_out, shift,
                                     fill_bytes, s);
      break;
    case 2: forward_as<unsigned short>(x, out, r, height, pad_h, row_in, row_out, shift,
                                       fill_bytes, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_out: [batch, height + 2 pad_h, width + 2 pad_w] pixels, grad_in:
// [batch, height, width] pixels, pixel_bytes each, contiguous. dtype: 0
// float32, 1 bfloat16. The other arguments as for the forward. Returns the
// CUDA error code, 0 on success.
extern "C" int circular_pad_backward(const void* grad_out, void* grad_in, int batch,
                                     int height, int width, int pixel_bytes, int pad_w,
                                     int pad_h, int dtype, int vec_bytes, int device,
                                     void* stream) {
  int row_in, row_out, shift;
  if (pad_w < 0 || pad_h < 0 || pad_w > width
      || !row_vectors(width, pad_w, pixel_bytes, vec_bytes, &row_in, &row_out, &shift)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(batch) * height;
  if (rows > 0x7fffffffLL
      || static_cast<long long>(batch) * (height + 2 * pad_h) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0 || row_in == 0) return 0;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  bool ok = false;
  switch (dtype) {
    case 0: ok = backward_typed<float>(grad_out, grad_in, vec_bytes, r, height, pad_h, row_in,
                                       row_out, shift, s);
      break;
    case 1: ok = backward_typed<__nv_bfloat16>(grad_out, grad_in, vec_bytes, r, height, pad_h,
                                               row_in, row_out, shift, s);
      break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
