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
// Design of the hard kernel: a block owns kTileH x kTileW query pixels of one
// batch image, two vertically adjacent ones a thread, and first stages the
// candidates of their windows, a (kTileH + wv - 1) x (kTileW + wu - 1) halo,
// in shared memory (sized at launch) as float4 (x, y, z, pixel index). The
// wrap, the empty rows and the occupancy test are applied once per halo
// element while it is staged: a column is wrapped with one modulo (so a width
// narrower than the halo repeats pixels, as the plain version's roll does),
// and an empty row or an unoccupied candidate is stored as (+inf, +inf,
// +inf), whose squared distance is +inf (or NaN) and so never wins the
// strict <. The inner loop then reads one float4 a window offset from shared
// memory, with no divide, no modulo and no global load, and keeps the
// winner's halo position. A thread's two pixels share all but one of their
// window rows, so each read serves both: at one float4 a pixel-offset the
// kernel would wait on shared memory's 128 bytes a cycle at large windows.
// The winner's xyz comes from the halo and its normal is read once from
// global memory. Each candidate is read from device memory by a few blocks
// (the halos overlap) instead of by every thread whose window covers it.
// The soft kernel is one thread per query pixel reading its candidates
// through L1/L2; its redesign is later work.
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

// The hard kernel's block: kTileH rows of kTileW query pixels, kRows
// vertically adjacent pixels a thread.
constexpr int kTileW = 64;
constexpr int kRows = 2;
constexpr int kTileH = 4 * kRows;
constexpr int kHardThreads = kTileW * kTileH / kRows;
constexpr int kMaxGridYZ = 65535;

// One candidate against one query pixel: the strict-< update.
__device__ __forceinline__ void visit(float4 c, int pos, float sx, float sy, float sz,
                                      float& best, int& best_pos) {
  const float sq = squared_distance(c.x, c.y, c.z, sx, sy, sz);
  if (sq < best) {
    best = sq;
    best_pos = pos;
  }
}

__global__ void __launch_bounds__(kHardThreads)
window_match_hard(View src, View txyz, View tnrm, View occ, float* __restrict__ out_sq,
                  float* __restrict__ out_xyz, float* __restrict__ out_nrm,
                  int* __restrict__ out_k, int height, int width, int wv, int wu, int batch) {
  static_assert(kRows == 2, "the row loops below are written for two pixels a thread");
  extern __shared__ float4 halo[];
  const int pitch = kTileW + wu - 1;
  const int cells = (kTileH + wv - 1) * pitch;
  const int a = wv / 2;
  const int bu = wu / 2;
  const int tx = threadIdx.x % kTileW;
  const int ty = threadIdx.x / kTileW;
  const int c0 = blockIdx.x * kTileW;
  const int r0 = blockIdx.y * kTileH;
  const int w = c0 + tx;
  const int hr0 = kRows * ty;           // the halo row of the first pixel's window top
  const long long hw = static_cast<long long>(height) * width;
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    // Stage the halo: wrap, empty rows and occupancy applied once a cell.
    for (int e = threadIdx.x; e < cells; e += kHardThreads) {
      const int hr = e / pitch;
      const int row = r0 + hr - a;
      float4 v = make_float4(INFINITY, INFINITY, INFINITY, __int_as_float(-1));
      if (row >= 0 && row < height) {
        int col = (c0 + (e - hr * pitch) - bu) % width;
        if (col < 0) col += width;
        const int q = row * width + col;
        const float* t = txyz.at(b, q);
        const float x = t[0], y = t[1], z = t[2];
        const bool occupied = occ.ptr != nullptr ? occ.at(b, q)[0] > 0.5f
                                                 : !(x == 0.0f && y == 0.0f && z == 0.0f);
        if (occupied) v = make_float4(x, y, z, __int_as_float(q));
      }
      halo[e] = v;
    }
    __syncthreads();
    // Two pixels, rows h and h + 1: halo row hr serves the first at offset
    // row dv = hr and the second at dv = hr - 1, so each float4 read from
    // shared memory serves both; each pixel still visits its offsets
    // dv-major, du-minor.
    float sx[kRows], sy[kRows], sz[kRows], best[kRows];
    int best_pos[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int h = r0 + hr0 + j;
      const bool live = h < height && w < width;
      const float* s = src.at(b, live ? h * width + w : 0);
      sx[j] = s[0];
      sy[j] = s[1];
      sz[j] = s[2];
      best[j] = INFINITY;
      best_pos[j] = -1;
    }
    {
      int row = hr0 * pitch + tx;
      for (int k = 0; k < wu; ++k) visit(halo[row + k], row + k, sx[0], sy[0], sz[0], best[0],
                                         best_pos[0]);
      for (int hr = 1; hr < wv; ++hr) {
        row += pitch;
        for (int k = 0; k < wu; ++k) {
          const float4 c = halo[row + k];
          visit(c, row + k, sx[0], sy[0], sz[0], best[0], best_pos[0]);
          visit(c, row + k, sx[1], sy[1], sz[1], best[1], best_pos[1]);
        }
      }
      row += pitch;
      for (int k = 0; k < wu; ++k) visit(halo[row + k], row + k, sx[1], sy[1], sz[1], best[1],
                                         best_pos[1]);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int h = r0 + hr0 + j;
      if (h >= height || w >= width) continue;
      const long long i = b * hw + static_cast<long long>(h) * width + w;
      out_sq[i] = best[j];
      if (out_k != nullptr) {
        // The offset index dv * wu + du_idx of the winner's halo position
        // (0 if none).
        const int dv = best_pos[j] / pitch - hr0 - j;
        out_k[i] = best_pos[j] >= 0 ? dv * wu + (best_pos[j] - (dv + hr0 + j) * pitch - tx) : 0;
      }
      if (out_xyz == nullptr) continue;
      float4 win = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float nx = 0.0f, ny = 0.0f, nz = 0.0f;
      if (best_pos[j] >= 0) {
        win = halo[best_pos[j]];
        const float* n = tnrm.at(b, __float_as_int(win.w));
        nx = n[0];
        ny = n[1];
        nz = n[2];
      }
      float* ox = out_xyz + i * 3;
      float* on = out_nrm + i * 3;
      ox[0] = win.x;
      ox[1] = win.y;
      ox[2] = win.z;
      on[0] = nx;
      on[1] = ny;
      on[2] = nz;
    }
    __syncthreads();  // the halo is read before the next image's is staged
  }
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

// Makes `device` current if it is not; -> the device to restore, or -1.
cudaError_t enter(int device, int* previous) {
  *previous = -1;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    if ((err = cudaSetDevice(device)) != cudaSuccess) return err;
    *previous = current;
  }
  return cudaSuccess;
}

int leave(int previous) {
  const cudaError_t err = cudaGetLastError();
  if (previous >= 0) cudaSetDevice(previous);
  return static_cast<int>(err);
}

cudaError_t launch_hard(View src, View txyz, View tnrm, View occ, void* out_sq, void* out_xyz,
                        void* out_nrm, void* out_k, int batch, int height, int width, int wv,
                        int wu, cudaStream_t st) {
  const size_t bytes =
      static_cast<size_t>(kTileH + wv - 1) * (kTileW + wu - 1) * sizeof(float4);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_match_hard, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned int>((width + kTileW - 1) / kTileW),
                  static_cast<unsigned int>((height + kTileH - 1) / kTileH),
                  static_cast<unsigned int>(batch < kMaxGridYZ ? batch : kMaxGridYZ));
  window_match_hard<<<grid, kHardThreads, bytes, st>>>(
      src, txyz, tnrm, occ, static_cast<float*>(out_sq), static_cast<float*>(out_xyz),
      static_cast<float*>(out_nrm), static_cast<int*>(out_k), height, width, wv, wu, batch);
  return cudaSuccess;
}

}  // namespace

// src, txyz, tnrm: [batch, height * width, >= 3] f32 channels-last views, the
// three channels read contiguous; *_sb and *_sp are the batch and pixel
// strides in floats. occ (may be null): a [batch, height * width] f32 plane
// with its own strides; a candidate is occupied where it is > 0.5 (else where
// its xyz is not all zero). out_sq [batch, height * width]; out_xyz and
// out_nrm [batch, height * width, 3] (both null for an index-only search, and
// tnrm may then be null); out_k [batch, height * width] int32 (may be null).
// The block's dynamic shared memory, (kTileH + wv - 1) * (kTileW + wu - 1) *
// 16 bytes, must fit a block (the wrapper checks);
// height <= kTileH * 65535. Outputs contiguous; all on the stream's device. Launches on `stream` from
// `device`, which is made current for the call if it is not. Returns the
// CUDA error code, 0 on success.
extern "C" int window_match_launch(const void* src, long long src_sb, long long src_sp,
                                   const void* txyz, long long txyz_sb, long long txyz_sp,
                                   const void* tnrm, long long tnrm_sb, long long tnrm_sp,
                                   const void* occ, long long occ_sb, long long occ_sp,
                                   void* out_sq, void* out_xyz, void* out_nrm, void* out_k,
                                   int batch, int height, int width, int wv, int wu,
                                   int device, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  int previous = -1;
  cudaError_t err = enter(device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  const View s{static_cast<const float*>(src), src_sb, src_sp};
  const View t{static_cast<const float*>(txyz), txyz_sb, txyz_sp};
  const View n{static_cast<const float*>(tnrm), tnrm_sb, tnrm_sp};
  const View o{static_cast<const float*>(occ), occ_sb, occ_sp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_hard(s, t, n, o, out_sq, out_xyz, out_nrm, out_k, batch, height, width, wv, wu,
                    st);
  if (err != cudaSuccess) {
    if (previous >= 0) cudaSetDevice(previous);
    return static_cast<int>(err);
  }
  return leave(previous);
}

// The soft blend: arguments as window_match_launch without occ and out_k;
// inv_tau = 1 / sigma^2 rounded to f32.
extern "C" int window_match_soft_launch(const void* src, long long src_sb, long long src_sp,
                                        const void* txyz, long long txyz_sb, long long txyz_sp,
                                        const void* tnrm, long long tnrm_sb, long long tnrm_sp,
                                        void* out_sq, void* out_xyz, void* out_nrm, int batch,
                                        int height, int width, int wv, int wu, float inv_tau,
                                        int device, void* stream) {
  const long long total = static_cast<long long>(batch) * height * width;
  if (total <= 0) return 0;
  int previous = -1;
  const cudaError_t err = enter(device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_match_soft<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const float*>(src), src_sb, src_sp},
      View{static_cast<const float*>(txyz), txyz_sb, txyz_sp},
      View{static_cast<const float*>(tnrm), tnrm_sb, tnrm_sp}, static_cast<float*>(out_sq),
      static_cast<float*>(out_xyz), static_cast<float*>(out_nrm), height, width, wv, wu,
      inv_tau, total);
  return leave(previous);
}
