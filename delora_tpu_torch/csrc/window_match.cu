// Image-space window matcher of the training step, for sm_90a: hard argmin
// (with the winner's offset index, for the reverse direction) and the soft
// blend.
//
// Replaces the TPU kernels delora_tpu/ops/pallas/window_match.py::_match_kernel
// (window_match_pallas; hard and soft branches of _match_body) and its W-tiled
// twin _match_kernel_tiled (_window_match_tiled): one hard kernel and one soft
// halo kernel for any width and any odd window whose halo fits a block, and a
// soft global kernel for larger windows. Per pixel of the query image each
// visits the wv * wu window offsets of the candidate image in dv-major,
// du-minor order:
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
// caller, unnormalised; acc_w, acc_xyz and acc_nrm are summed in visit order,
// each product and sum rounded once (no contraction into FMAs, as the plain
// PyTorch version's separate operations), best_sq = fminf over the window,
// +inf where acc_w < 1e-30; xyz = acc_xyz / fmaxf(acc_w, 1e-30) (__fdiv_rn),
// normals the same and not renormalised. The reference's arithmetic flushes
// subnormals to zero (XLA on the CPU and the TPU), and the plain version
// flushes every weight, product, sum and quotient of the blend to +0 where it
// is subnormal: a weight past the smallest normal float must not leave a tiny
// non-zero blended normal.
//
// The squared distance is fma(dz, dz, fma(dy, dy, dx * dx)), d = t - s, in
// float32 with each fma rounded once, as the reference's compiled matcher
// forms it. The plain PyTorch version
// (delora_tpu_torch/ops/cuda/window_match.py::squared_distance) repeats the
// single roundings exactly, so winners, offsets and best_sq are bit-equal to
// it, and so are the soft blends where expf agrees with torch.exp on the card.
//
// Design of the halo kernels: a block owns kTileH x kTileW query pixels of
// one batch image, two vertically adjacent ones a thread, and first stages
// the candidates of their windows, a (kTileH + wv - 1) x (kTileW + wu - 1)
// halo, in shared memory (sized at launch) as float4: (x, y, z, pixel index)
// for the hard kernel; (x, y, z, a term added to |d|^2) and a second float4
// plane of normals for the soft blend (32 B a cell). One loader (stage_halo)
// serves both. The wrap, the empty rows and the
// occupancy test are applied once per halo cell while it is staged: a column
// is wrapped with one modulo (so a width narrower than the halo repeats
// pixels, as the plain version's roll does), and an empty row or an
// unoccupied candidate is stored so that its squared distance is +inf: as
// (+inf, +inf, +inf) for the hard kernel, whose strict < it never wins, and
// as a zero xyz and normal with a +inf term in |d|^2 for the soft kernel,
// where it leaves fminf as it was and weighs expf(-inf) = 0 (see (c)).
// The inner loop then reads one float4 a window offset (two for the soft
// blend) from shared memory, with no divide, no modulo and no global load.
// A thread's two pixels share all but one of their window rows, so each read
// serves both; each pixel keeps its own best (and, soft, its own eight sums)
// and visits its own offsets dv-major, du-minor. The hard kernel keeps the
// winner's halo position; the winner's xyz comes from the halo and its normal
// is read once from global memory. Each candidate is read from device memory
// by a few blocks (the halos overlap) instead of by every thread whose window
// covers it.
//
// The soft blend's arithmetic, and why its outputs stay bit-equal to the
// plain version's. It has no branch a candidate. Per candidate the kernel
// forms sq, then w = expf(x), x = __fmul_rn(-sq, inv_tau) (the accurate
// expf: __expf or ex2.approx of a rescaled x move w by up to ~5e-6 relative
// near |x| = 87), and:
//   (a) flushes w with mul.rn.ftz.f32 w, w, 1.0: a subnormal input is
//       flushed to a zero of its sign, +0 for w >= 0, and a normal w times 1
//       is w exactly, so this is the plain version's flush(w) in one
//       instruction. A zero weight then adds exactly nothing: every product
//       is +-0, and acc + (+-0) is acc in value.
//   (b) forms each product with __fmul_rn, unflushed, and each sum with
//       add.rn.ftz.f32, which flushes subnormal inputs and results to a zero
//       of the same sign. A sum of two floats that is subnormal is exact (both
//       are multiples of 2^-149), so "subnormal result" means the same before
//       and after rounding, and the flushed input p of acc + p adds what the
//       plain version's flushed product adds: +-0 against +0. By induction
//       every sum equals the plain version's under ==, and differs at most in
//       the sign of a zero. (A product is never flushed in hardware: whether a
//       product just below FLT_MIN that rounds up to FLT_MIN is "subnormal"
//       would depend on when the hardware tests it.)
//   (c) an empty halo cell holds xyz 0 and the term +inf, which enters
//       |d|^2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, pen))): sq = +inf, w = 0,
//       products 0 * 0, no NaN (with the hard layout's +inf xyz, w * x would
//       be 0 * inf). An occupied cell holds pen = +0, and fma(dx, dx, +0) is
//       dx * dx rounded once (dx * dx >= 0, so the sum with +0 is exact and
//       never -0): sq is the plain version's.
//   acc_w sums non-negative normal weights, so it equals the plain version's
//   bit for bit; so do best_sq, the miss test and the divisor. The quotients
//   are __fdiv_rn and flushed explicitly, which maps -0 / d to +0: every
//   output is bit-equal to the plain version's, save where expf and
//   torch.exp differ (measured equal on the card). The CPU tests replay (a)
//   to (c) against the plain version (tests/test_torch_matcher_wrapper.py).
//
// A window whose soft halo does not fit a block's shared memory takes the
// global kernel, one thread per query pixel reading its candidates through
// L1/L2, with the same blend; the wrapper chooses by shape before the launch.
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
// them from the run's occupancy). The expf alone is ~8 instructions, so the
// soft kernel is held against an issue-slot floor too: the SASS instructions
// a candidate of its loop times the occupied candidates over 132 SMs x 128
// lanes x the SM clock (chip_smoke.py reads them from the built library).

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

// The halo kernels' block: kTileH rows of kTileW query pixels, kRows
// vertically adjacent pixels a thread.
constexpr int kTileW = 64;
constexpr int kRows = 2;
constexpr int kTileH = 4 * kRows;
constexpr int kHaloThreads = kTileW * kTileH / kRows;
constexpr int kMaxGridYZ = 65535;

// Stages the candidate halo of the tile whose first query pixel is (r0, c0)
// of batch image b: cell e = hr * pitch + hc holds candidate row r0 + hr - a,
// column (c0 + hc - bu) mod width. Hard layout: (x, y, z, pixel index), or
// (+inf, +inf, +inf, -1) where that row lies beyond the image or the
// candidate is unoccupied. Soft layout (kSoft): (x, y, z, +0) and nrm[e] its
// normal, or (0, 0, 0, +inf) and a zero normal where empty; the fourth
// component is the term the soft blend adds to |d|^2.
template <bool kSoft>
__device__ __forceinline__ void stage_halo(float4* halo, float4* nrm, const View& txyz,
                                           const View& tnrm, const View& occ, int b,
                                           int r0, int c0, int a, int bu, int pitch, int cells,
                                           int height, int width) {
  for (int e = threadIdx.x; e < cells; e += kHaloThreads) {
    const int hr = e / pitch;
    const int row = r0 + hr - a;
    float4 v = kSoft ? make_float4(0.0f, 0.0f, 0.0f, INFINITY)
                     : make_float4(INFINITY, INFINITY, INFINITY, __int_as_float(-1));
    float4 n = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row >= 0 && row < height) {
      int col = (c0 + (e - hr * pitch) - bu) % width;
      if (col < 0) col += width;
      const int q = row * width + col;
      const float* t = txyz.at(b, q);
      const float x = t[0], y = t[1], z = t[2];
      const bool occupied = occ.ptr != nullptr ? occ.at(b, q)[0] > 0.5f
                                               : !(x == 0.0f && y == 0.0f && z == 0.0f);
      if (occupied) {
        v = make_float4(x, y, z, kSoft ? 0.0f : __int_as_float(q));
        if (kSoft) {
          const float* m = tnrm.at(b, q);
          n = make_float4(m[0], m[1], m[2], 0.0f);
        }
      }
    }
    halo[e] = v;
    if (kSoft) nrm[e] = n;
  }
}

// One candidate against one query pixel: the strict-< update.
__device__ __forceinline__ void visit(float4 c, int pos, float sx, float sy, float sz,
                                      float& best, int& best_pos) {
  const float sq = squared_distance(c.x, c.y, c.z, sx, sy, sz);
  if (sq < best) {
    best = sq;
    best_pos = pos;
  }
}

__global__ void __launch_bounds__(kHaloThreads)
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
    stage_halo<false>(halo, nullptr, txyz, tnrm, occ, b, r0, c0, a, bu, pitch, cells, height,
                      width);
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

// a + b rounded once, subnormal inputs and result flushed to a zero of the
// same sign (the header's (b)).
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// flush(x) for x >= 0 in one instruction: a subnormal input becomes +0, a
// normal one is multiplied by 1 exactly (the header's (a)).
__device__ __forceinline__ float flush_nonnegative(float x) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, 0f3F800000;" : "=f"(r) : "f"(x));
  return r;
}

// One query pixel's soft sums: the window's least squared distance, the sum
// of weights, and the weighted sums of xyz and of normals.
struct Blend {
  float best, w, x, y, z, nx, ny, nz;
};

__device__ __forceinline__ Blend blend_start() {
  return Blend{INFINITY, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
}

// One candidate (xyz c, normal n, the term pen added to |d|^2: +0, or +inf
// for an empty halo cell, see (c)) into pixel s's sums, in visit order.
__device__ __forceinline__ void blend(float cx, float cy, float cz, float pen, float nx,
                                      float ny, float nz, float sx, float sy, float sz,
                                      float inv_tau, Blend& acc) {
  const float dx = __fsub_rn(cx, sx);
  const float dy = __fsub_rn(cy, sy);
  const float dz = __fsub_rn(cz, sz);
  const float sq = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, pen)));
  acc.best = fminf(acc.best, sq);
  const float w = flush_nonnegative(expf(__fmul_rn(-sq, inv_tau)));
  acc.w = add_ftz(acc.w, w);
  acc.x = add_ftz(acc.x, __fmul_rn(w, cx));
  acc.y = add_ftz(acc.y, __fmul_rn(w, cy));
  acc.z = add_ftz(acc.z, __fmul_rn(w, cz));
  acc.nx = add_ftz(acc.nx, __fmul_rn(w, nx));
  acc.ny = add_ftz(acc.ny, __fmul_rn(w, ny));
  acc.nz = add_ftz(acc.nz, __fmul_rn(w, nz));
}

__device__ __forceinline__ void blend(float4 c, float4 n, float sx, float sy, float sz,
                                      float inv_tau, Blend& acc) {
  blend(c.x, c.y, c.z, c.w, n.x, n.y, n.z, sx, sy, sz, inv_tau, acc);
}

// Pixel i's outputs from its sums: best_sq (+inf where every weight
// underflowed) and the blends, each quotient flushed.
__device__ __forceinline__ void blend_store(const Blend& acc, long long i,
                                            float* __restrict__ out_sq,
                                            float* __restrict__ out_xyz,
                                            float* __restrict__ out_nrm) {
  out_sq[i] = acc.w < 1e-30f ? INFINITY : acc.best;
  const float den = fmaxf(acc.w, 1e-30f);
  float* ox = out_xyz + i * 3;
  float* on = out_nrm + i * 3;
  ox[0] = flush(__fdiv_rn(acc.x, den));
  ox[1] = flush(__fdiv_rn(acc.y, den));
  ox[2] = flush(__fdiv_rn(acc.z, den));
  on[0] = flush(__fdiv_rn(acc.nx, den));
  on[1] = flush(__fdiv_rn(acc.ny, den));
  on[2] = flush(__fdiv_rn(acc.nz, den));
}

// The soft blend from a shared-memory halo of xyz and normals; the block
// walks tiles (tile row, batch image) with a stride of gridDim.y, so any
// height and batch fit the grid.
__global__ void __launch_bounds__(kHaloThreads)
window_match_soft_halo(View src, View txyz, View tnrm, float* __restrict__ out_sq,
                       float* __restrict__ out_xyz, float* __restrict__ out_nrm, int height,
                       int width, int wv, int wu, float inv_tau, int batch) {
  static_assert(kRows == 2, "the row loops below are written for two pixels a thread");
  extern __shared__ float4 smem[];
  const int pitch = kTileW + wu - 1;
  const int cells = (kTileH + wv - 1) * pitch;
  float4* halo = smem;
  float4* nrm = smem + cells;
  const int a = wv / 2;
  const int bu = wu / 2;
  const int tx = threadIdx.x % kTileW;
  const int hr0 = kRows * (threadIdx.x / kTileW);
  const int c0 = blockIdx.x * kTileW;
  const int w = c0 + tx;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const long long tiles = static_cast<long long>(tiles_y) * batch;
  const long long hw = static_cast<long long>(height) * width;
  const View none{nullptr, 0, 0};
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    const long long b = t / tiles_y;
    const int r0 = static_cast<int>(t - b * tiles_y) * kTileH;
    stage_halo<true>(halo, nrm, txyz, tnrm, none, static_cast<int>(b), r0, c0, a, bu, pitch,
                     cells, height, width);
    __syncthreads();
    float sx[kRows], sy[kRows], sz[kRows];
    Blend acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int h = r0 + hr0 + j;
      const bool live = h < height && w < width;
      const float* s = src.at(b, live ? h * width + w : 0);
      sx[j] = s[0];
      sy[j] = s[1];
      sz[j] = s[2];
      acc[j] = blend_start();
    }
    // As the hard kernel: halo row hr serves the first pixel at dv = hr and
    // the second at dv = hr - 1; each pixel's sums take its offsets in order.
    // A thread whose pixels all lie beyond the image only stages.
    if (w < width && r0 + hr0 < height) {
      int row = hr0 * pitch + tx;
      for (int k = 0; k < wu; ++k) blend(halo[row + k], nrm[row + k], sx[0], sy[0], sz[0],
                                         inv_tau, acc[0]);
      for (int hr = 1; hr < wv; ++hr) {
        row += pitch;
#pragma unroll 8
        for (int k = 0; k < wu; ++k) {
          const float4 c = halo[row + k];
          const float4 n = nrm[row + k];
          blend(c, n, sx[0], sy[0], sz[0], inv_tau, acc[0]);
          blend(c, n, sx[1], sy[1], sz[1], inv_tau, acc[1]);
        }
      }
      row += pitch;
      for (int k = 0; k < wu; ++k) blend(halo[row + k], nrm[row + k], sx[1], sy[1], sz[1],
                                         inv_tau, acc[1]);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int h = r0 + hr0 + j;
        if (h < height)
          blend_store(acc[j], b * hw + static_cast<long long>(h) * width + w, out_sq, out_xyz,
                      out_nrm);
      }
    }
    __syncthreads();  // the halo is read before the next tile's is staged
  }
}

// The soft blend for windows whose halo does not fit a block: one thread a
// query pixel, candidates read from global memory.
__global__ void window_match_soft_global(View src, View txyz, View tnrm,
                                         float* __restrict__ out_sq, float* __restrict__ out_xyz,
                                         float* __restrict__ out_nrm, int height, int width,
                                         int wv, int wu, float inv_tau, long long total) {
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
  Blend acc = blend_start();
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
      const float* n = tnrm.at(b, q);
      blend(tx, ty, tz, 0.0f, n[0], n[1], n[2], sx, sy, sz, inv_tau, acc);
    }
  }
  blend_store(acc, i, out_sq, out_xyz, out_nrm);
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
  window_match_hard<<<grid, kHaloThreads, bytes, st>>>(
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
// inv_tau = 1 / sigma^2 rounded to f32. halo != 0 takes the halo kernel,
// whose block needs (kTileH + wv - 1) * (kTileW + wu - 1) * 32 bytes of
// shared memory (the wrapper chooses it where that fits a block); halo == 0
// the global kernel, which takes any window.
extern "C" int window_match_soft_launch(const void* src, long long src_sb, long long src_sp,
                                        const void* txyz, long long txyz_sb, long long txyz_sp,
                                        const void* tnrm, long long tnrm_sb, long long tnrm_sp,
                                        void* out_sq, void* out_xyz, void* out_nrm, int batch,
                                        int height, int width, int wv, int wu, int halo,
                                        float inv_tau, int device, void* stream) {
  const long long total = static_cast<long long>(batch) * height * width;
  if (total <= 0) return 0;
  int previous = -1;
  cudaError_t err = enter(device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  const View s{static_cast<const float*>(src), src_sb, src_sp};
  const View t{static_cast<const float*>(txyz), txyz_sb, txyz_sp};
  const View n{static_cast<const float*>(tnrm), tnrm_sb, tnrm_sp};
  float* sq = static_cast<float*>(out_sq);
  float* xyz = static_cast<float*>(out_xyz);
  float* nrm = static_cast<float*>(out_nrm);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (halo) {
    const size_t bytes =
        static_cast<size_t>(kTileH + wv - 1) * (kTileW + wu - 1) * 2 * sizeof(float4);
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(window_match_soft_halo,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) {
        if (previous >= 0) cudaSetDevice(previous);
        return static_cast<int>(err);
      }
    }
    const long long tiles = static_cast<long long>((height + kTileH - 1) / kTileH) * batch;
    const dim3 grid(static_cast<unsigned int>((width + kTileW - 1) / kTileW),
                    static_cast<unsigned int>(tiles < kMaxGridYZ ? tiles : kMaxGridYZ));
    window_match_soft_halo<<<grid, kHaloThreads, bytes, st>>>(s, t, n, sq, xyz, nrm, height,
                                                             width, wv, wu, inv_tau, batch);
  } else {
    window_match_soft_global<<<blocks_for(total), kThreads, 0, st>>>(
        s, t, n, sq, xyz, nrm, height, width, wv, wu, inv_tau, total);
  }
  return leave(previous);
}
