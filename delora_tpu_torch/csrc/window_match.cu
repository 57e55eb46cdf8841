// Hard image-space window matcher of the training step, for sm_90a.
//
// Replaces the TPU kernels delora_tpu/ops/pallas/window_match.py::_match_kernel
// (window_match_pallas, hard branch of _match_body) and its W-tiled twin
// _match_kernel_tiled (_window_match_tiled): one kernel for any width and any
// odd window. Per pixel of the warped-source image it visits the wv * wu
// window offsets of the target image in dv-major, du-minor order and keeps the
// candidate with the smallest squared distance:
//   - rows beyond the image are empty (the reference pads them with empty
//     rows, correspondence.py:222-224), never clamped;
//   - the azimuth wraps: column (w + du) mod W;
//   - an unoccupied candidate (all of x, y, z == 0) counts as +inf;
//   - the comparison is strict <, so ties go to the first offset.
// Outputs: best_sq (+inf when no candidate is occupied) and the winner's
// target xyz and normal (zeros when none).
//
// The squared distance is fma(dz, dz, fma(dy, dy, dx * dx)), d = t - s, as
// the reference's compiled matcher forms it. Each fma is taken in float64 and
// rounded to float32 (the product of two floats is exact in float64), the
// same steps as the plain PyTorch version
// (delora_tpu_torch/ops/cuda/window_match.py::squared_distance), so winners
// and best_sq are bit-equal to it.
//
// Design: one thread per source pixel; the target is read through L1/L2
// (neighbouring threads read neighbouring pixels, and the window's rows are
// reused by the threads of the block). The TPU kernel's VMEM-resident slab,
// lane rolls and W tiles existed for the TPU's memory and have no counterpart.
//
// Bound: the function must read the source xyz (12 B a pixel) and the target
// xyz and normal (24 B a pixel; occupancy is derived from xyz) once and write
// 28 B a pixel: 64 B x 368,640 pixels = 23.6 MB at B = 8, 64x720, about
// 7.0 us at 3.35 TB/s. The arithmetic, about 45 offsets x 9 operations a pixel at
// (5,9), two of them float64 fmas, is 0.15 G operations: 2.2 us at the fp32
// rate of 67 TFLOP/s, 4.4 us if the 30 M fp64 fmas ran at the fp64 rate of
// 34 TFLOP/s (vector). Bytes set the bound.

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void window_match_hard(const float* __restrict__ src, long long src_sb,
                                  long long src_sp, const float* __restrict__ txyz,
                                  long long txyz_sb, long long txyz_sp,
                                  const float* __restrict__ tnrm, long long tnrm_sb,
                                  long long tnrm_sp, float* __restrict__ out_sq,
                                  float* __restrict__ out_xyz, float* __restrict__ out_nrm,
                                  int height, int width, int wv, int wu, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long hw = static_cast<long long>(height) * width;
  const long long b = i / hw;
  const int p = static_cast<int>(i - b * hw);
  const int h = p / width;
  const int w = p - h * width;

  const float* s = src + b * src_sb + p * src_sp;
  const float sx = s[0], sy = s[1], sz = s[2];
  const float* tb = txyz + b * txyz_sb;
  const int a = wv / 2;
  const int bu = wu / 2;

  float best = INFINITY;
  int best_pix = -1;
  for (int dv = 0; dv < wv; ++dv) {
    const int row = h + dv - a;
    if (row < 0 || row >= height) continue;  // empty padding row: every offset misses
    for (int k = 0; k < wu; ++k) {
      int col = (w + k - bu) % width;
      if (col < 0) col += width;
      const int q = row * width + col;
      const float* t = tb + q * txyz_sp;
      const float tx = t[0], ty = t[1], tz = t[2];
      if (tx == 0.0f && ty == 0.0f && tz == 0.0f) continue;  // unoccupied: +inf
      const float dx = __fsub_rn(tx, sx);
      const float dy = __fsub_rn(ty, sy);
      const float dz = __fsub_rn(tz, sz);
      const float xx = __fmul_rn(dx, dx);
      const float xy = __double2float_rn(
          __fma_rn(static_cast<double>(dy), static_cast<double>(dy), static_cast<double>(xx)));
      const float sq = __double2float_rn(
          __fma_rn(static_cast<double>(dz), static_cast<double>(dz), static_cast<double>(xy)));
      if (sq < best) {
        best = sq;
        best_pix = q;
      }
    }
  }
  out_sq[i] = best;
  float* ox = out_xyz + i * 3;
  float* on = out_nrm + i * 3;
  if (best_pix < 0) {
    ox[0] = ox[1] = ox[2] = 0.0f;
    on[0] = on[1] = on[2] = 0.0f;
    return;
  }
  const float* t = tb + best_pix * txyz_sp;
  const float* n = tnrm + b * tnrm_sb + best_pix * tnrm_sp;
  ox[0] = t[0];
  ox[1] = t[1];
  ox[2] = t[2];
  on[0] = n[0];
  on[1] = n[1];
  on[2] = n[2];
}

}  // namespace

// src, txyz, tnrm: [batch, height * width, >= 3] f32 channels-last views, the
// three channels read contiguous; *_sb and *_sp are the batch and pixel
// strides in floats. out_sq [batch, height * width], out_xyz and out_nrm
// [batch, height * width, 3], contiguous. All on the stream's device.
extern "C" int window_match_launch(const void* src, long long src_sb, long long src_sp,
                                   const void* txyz, long long txyz_sb, long long txyz_sp,
                                   const void* tnrm, long long tnrm_sb, long long tnrm_sp,
                                   void* out_sq, void* out_xyz, void* out_nrm, int batch,
                                   int height, int width, int wv, int wu, void* stream) {
  const long long total = static_cast<long long>(batch) * height * width;
  if (total > 0) {
    const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
    window_match_hard<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), src_sb, src_sp, static_cast<const float*>(txyz),
        txyz_sb, txyz_sp, static_cast<const float*>(tnrm), tnrm_sb, tnrm_sp,
        static_cast<float*>(out_sq), static_cast<float*>(out_xyz),
        static_cast<float*>(out_nrm), height, width, wv, wu, total);
  }
  return static_cast<int>(cudaGetLastError());
}
