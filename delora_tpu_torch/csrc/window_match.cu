// Image-space window matcher of the training step, for sm_90a: hard argmin
// (with the winner's offset index, for the reverse direction) and the soft
// blend.
//
// Replaces the TPU kernels delora_tpu/ops/pallas/window_match.py::_match_kernel
// (window_match_pallas; hard and soft branches of _match_body) and its W-tiled
// twin _match_kernel_tiled (_window_match_tiled): one kernel per branch for any
// width and any odd window. Per pixel of the query image it visits the
// wv * wu window offsets of the candidate image in dv-major, du-minor order:
//   - rows beyond the image are empty (the reference pads them with empty
//     rows, correspondence.py:222-224), never clamped;
//   - the azimuth wraps: column (w + du) mod W;
//   - an unoccupied candidate counts as +inf (weight 0 in the soft blend).
//     Occupancy is all of x, y, z != 0, or, where the caller passes an
//     occupancy plane, plane > 0.5 (the reverse direction's candidates,
//     delora_tpu/ops/correspondence.py::window_match_indices).
//
// Hard: strict <, so ties go to the first offset. Outputs best_sq (+inf when
// no candidate is occupied) and, each optional, the winner's xyz and normal
// (zeros when none) and its offset index k = dv * wu + du_idx (0 when none).
//
// Soft (delora_tpu/ops/correspondence.py:228-268): every occupied candidate
// weighs w = expf(-sq * inv_tau), inv_tau = 1 / sigma^2 rounded to f32 by the
// caller, unnormalised; acc_w, acc_xyz and acc_nrm are summed in visit order
// with __fmul_rn / __fadd_rn (no contraction into FMAs, as the plain PyTorch
// version's separate operations), best_sq = fminf over the window, +inf where
// acc_w < 1e-30; xyz = acc_xyz / fmaxf(acc_w, 1e-30) (__fdiv_rn), normals the
// same and not renormalised. Every weight, product, sum and quotient of the
// blend is flushed to +0 where it is subnormal, as the reference's arithmetic
// flushes subnormals (XLA on the CPU and the TPU): a weight past the smallest
// normal float must not leave a tiny non-zero blended normal.
//
// The squared distance is fma(dz, dz, fma(dy, dy, dx * dx)), d = t - s, in
// float32 with each fma rounded once, as the reference's compiled matcher
// forms it. The plain PyTorch version
// (delora_tpu_torch/ops/cuda/window_match.py::squared_distance) repeats the
// single roundings exactly, so winners, offsets and best_sq are bit-equal to
// it, and so are the soft blends where expf agrees with torch.exp on the card.
//
// Design: one thread per query pixel; the candidates are read through L1/L2
// (neighbouring threads read neighbouring pixels, and the window's rows are
// reused by the threads of the block). The TPU kernel's VMEM-resident slab,
// lane rolls and W tiles existed for the TPU's memory and have no counterpart.
//
// Bound, B = 8 at 64x720 (368,640 pixels): the hard forward matcher must read
// the query xyz (12 B a pixel) and the candidate xyz and normal (24 B) once and
// write 28 B a pixel: 64 B a pixel, 23.6 MB, about 7.0 us at 3.35 TB/s; its
// arithmetic at (5,9), about 45 offsets x 9 float32 operations a pixel (the
// fmas counted as two), is 0.15 G operations, 2.2 us at 67 TFLOP/s.
// The index search reads 12 + 12 + 4 B and writes 8 B a pixel (36 B, 3.9 us).
// The soft blend reads what the hard one reads and adds an exp and 7 multiply-
// adds a candidate: about 0.5 G operations at (5,9), 7.5 us, near its bytes.
// At (9,17) the operations set the bound of each branch (chip_smoke.py counts
// them from the run's occupancy).

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct View {  // a [batch, height * width, >= 3] f32 channels-last view
  const float* ptr;
  long long sb;  // batch stride, floats
  long long sp;  // pixel stride, floats
  __device__ __forceinline__ const float* at(long long b, int p) const {
    return ptr + b * sb + p * sp;
  }
};

__device__ __forceinline__ float squared_distance(float tx, float ty, float tz, float sx,
                                                  float sy, float sz) {
  const float dx = __fsub_rn(tx, sx);
  const float dy = __fsub_rn(ty, sy);
  const float dz = __fsub_rn(tz, sz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < 1.17549435e-38f ? 0.0f : x;  // subnormal -> +0
}

__global__ void window_match_hard(View src, View txyz, View tnrm, View occ,
                                  float* __restrict__ out_sq, float* __restrict__ out_xyz,
                                  float* __restrict__ out_nrm, int* __restrict__ out_k,
                                  int height, int width, int wv, int wu, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long hw = static_cast<long long>(height) * width;
  const long long b = i / hw;
  const int p = static_cast<int>(i - b * hw);
  const int h = p / width;
  const int w = p - h * width;

  const float* s = src.at(b, p);
  const float sx = s[0], sy = s[1], sz = s[2];
  const int a = wv / 2;
  const int bu = wu / 2;

  float best = INFINITY;
  int best_pix = -1;
  int best_k = 0;
  for (int dv = 0; dv < wv; ++dv) {
    const int row = h + dv - a;
    if (row < 0 || row >= height) continue;  // empty padding row: every offset misses
    for (int k = 0; k < wu; ++k) {
      int col = (w + k - bu) % width;
      if (col < 0) col += width;
      const int q = row * width + col;
      const float* t = txyz.at(b, q);
      const float tx = t[0], ty = t[1], tz = t[2];
      if (occ.ptr != nullptr) {
        if (!(occ.at(b, q)[0] > 0.5f)) continue;  // unoccupied: +inf
      } else if (tx == 0.0f && ty == 0.0f && tz == 0.0f) {
        continue;
      }
      const float sq = squared_distance(tx, ty, tz, sx, sy, sz);
      if (sq < best) {
        best = sq;
        best_pix = q;
        best_k = dv * wu + k;
      }
    }
  }
  out_sq[i] = best;
  if (out_k != nullptr) out_k[i] = best_k;
  if (out_xyz == nullptr) return;
  float* ox = out_xyz + i * 3;
  float* on = out_nrm + i * 3;
  if (best_pix < 0) {
    ox[0] = ox[1] = ox[2] = 0.0f;
    on[0] = on[1] = on[2] = 0.0f;
    return;
  }
  const float* t = txyz.at(b, best_pix);
  const float* n = tnrm.at(b, best_pix);
  ox[0] = t[0];
  ox[1] = t[1];
  ox[2] = t[2];
  on[0] = n[0];
  on[1] = n[1];
  on[2] = n[2];
}

__global__ void window_match_soft(View src, View txyz, View tnrm, float* __restrict__ out_sq,
                                  float* __restrict__ out_xyz, float* __restrict__ out_nrm,
                                  int height, int width, int wv, int wu, float inv_tau,
                                  long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long hw = static_cast<long long>(height) * width;
  const long long b = i / hw;
  const int p = static_cast<int>(i - b * hw);
  const int h = p / width;
  const int w = p - h * width;

  const float* s = src.at(b, p);
  const float sx = s[0], sy = s[1], sz = s[2];
  const int a = wv / 2;
  const int bu = wu / 2;

  float best = INFINITY;
  float acc_w = 0.0f;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  for (int dv = 0; dv < wv; ++dv) {
    const int row = h + dv - a;
    if (row < 0 || row >= height) continue;  // empty rows weigh 0
    for (int k = 0; k < wu; ++k) {
      int col = (w + k - bu) % width;
      if (col < 0) col += width;
      const int q = row * width + col;
      const float* t = txyz.at(b, q);
      const float tx = t[0], ty = t[1], tz = t[2];
      if (tx == 0.0f && ty == 0.0f && tz == 0.0f) continue;  // unoccupied: weight 0
      const float sq = squared_distance(tx, ty, tz, sx, sy, sz);
      best = fminf(best, sq);
      const float wgt = flush(expf(__fmul_rn(-sq, inv_tau)));
      const float* n = tnrm.at(b, q);
      acc_w = flush(__fadd_rn(acc_w, wgt));
      ax = flush(__fadd_rn(ax, flush(__fmul_rn(wgt, tx))));
      ay = flush(__fadd_rn(ay, flush(__fmul_rn(wgt, ty))));
      az = flush(__fadd_rn(az, flush(__fmul_rn(wgt, tz))));
      nx = flush(__fadd_rn(nx, flush(__fmul_rn(wgt, n[0]))));
      ny = flush(__fadd_rn(ny, flush(__fmul_rn(wgt, n[1]))));
      nz = flush(__fadd_rn(nz, flush(__fmul_rn(wgt, n[2]))));
    }
  }
  out_sq[i] = acc_w < 1e-30f ? INFINITY : best;  // an all-underflowed window misses
  const float den = fmaxf(acc_w, 1e-30f);
  float* ox = out_xyz + i * 3;
  float* on = out_nrm + i * 3;
  ox[0] = flush(__fdiv_rn(ax, den));
  ox[1] = flush(__fdiv_rn(ay, den));
  ox[2] = flush(__fdiv_rn(az, den));
  on[0] = flush(__fdiv_rn(nx, den));
  on[1] = flush(__fdiv_rn(ny, den));
  on[2] = flush(__fdiv_rn(nz, den));
}

unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

// src, txyz, tnrm: [batch, height * width, >= 3] f32 channels-last views, the
// three channels read contiguous; *_sb and *_sp are the batch and pixel
// strides in floats. occ (may be null): a [batch, height * width] f32 plane
// with its own strides; a candidate is occupied where it is > 0.5 (else where
// its xyz is not all zero). out_sq [batch, height * width]; out_xyz and
// out_nrm [batch, height * width, 3] (both null for an index-only search, and
// tnrm may then be null); out_k [batch, height * width] int32 (may be null).
// Outputs contiguous; all on the stream's device.
extern "C" int window_match_launch(const void* src, long long src_sb, long long src_sp,
                                   const void* txyz, long long txyz_sb, long long txyz_sp,
                                   const void* tnrm, long long tnrm_sb, long long tnrm_sp,
                                   const void* occ, long long occ_sb, long long occ_sp,
                                   void* out_sq, void* out_xyz, void* out_nrm, void* out_k,
                                   int batch, int height, int width, int wv, int wu,
                                   void* stream) {
  const long long total = static_cast<long long>(batch) * height * width;
  if (total > 0) {
    window_match_hard<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        View{static_cast<const float*>(src), src_sb, src_sp},
        View{static_cast<const float*>(txyz), txyz_sb, txyz_sp},
        View{static_cast<const float*>(tnrm), tnrm_sb, tnrm_sp},
        View{static_cast<const float*>(occ), occ_sb, occ_sp}, static_cast<float*>(out_sq),
        static_cast<float*>(out_xyz), static_cast<float*>(out_nrm), static_cast<int*>(out_k),
        height, width, wv, wu, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// The soft blend: arguments as window_match_launch without occ and out_k;
// inv_tau = 1 / sigma^2 rounded to f32.
extern "C" int window_match_soft_launch(const void* src, long long src_sb, long long src_sp,
                                        const void* txyz, long long txyz_sb, long long txyz_sp,
                                        const void* tnrm, long long tnrm_sb, long long tnrm_sp,
                                        void* out_sq, void* out_xyz, void* out_nrm, int batch,
                                        int height, int width, int wv, int wu, float inv_tau,
                                        void* stream) {
  const long long total = static_cast<long long>(batch) * height * width;
  if (total > 0) {
    window_match_soft<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        View{static_cast<const float*>(src), src_sb, src_sp},
        View{static_cast<const float*>(txyz), txyz_sb, txyz_sp},
        View{static_cast<const float*>(tnrm), tnrm_sb, tnrm_sp}, static_cast<float*>(out_sq),
        static_cast<float*>(out_xyz), static_cast<float*>(out_nrm), height, width, wv, wu,
        inv_tau, total);
  }
  return static_cast<int>(cudaGetLastError());
}
