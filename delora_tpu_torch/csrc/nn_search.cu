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
// Four launches:
//   1. count: one block per chunk of kChunk target slots counts the valid
//      ones;
//   2. pack: the same blocks pack their valid targets, in index order, as
//      (x, y, z, |t|^2) with their original indices, each at the sum of the
//      counts of the chunks before it. At KITTI density at least 65% of the
//      131,072 slots are padding or non-survivors, and the search skips them;
//   3. search: a block takes kSrcPerBlock sources (kSrcPerThread in each
//      thread's registers) and one of `splits` contiguous ranges of the
//      batch's packed targets, so the grid fills the card at B = 1 as at
//      B = 8. The range streams through shared memory in tiles of kTile
//      targets, double-buffered with cp.async 16-byte copies: the next tile
//      lands while this one is searched. Every thread of a warp reads the same
//      target (a broadcast), which serves its kSrcPerThread sources. Each
//      block merges its per-source winner into a key workspace with one
//      64-bit atomicMin;
//   4. finish: each key becomes (original index, d), and the key is reset to
//      empty (all bits set), so the workspace is clean for the next call and
//      no call pays an init pass.
//
// Why the merge is exact. A block's winner for a source is the pair (d, j) of
// its range that the sequential strict-< scan would keep: the least d, and
// among equal d the least packed index j. The key is (ord(d) << 32) | j, with
// ord the order-preserving map of float bits (negative values bit-inverted,
// non-negative ones with the sign bit set), so unsigned key order is the
// lexicographic order of (d, j) for every non-NaN d but -0. d is never -0:
// |s|^2 + |t|^2 is a sum of squares, >= +0, and fma(-2, cross, sum) that
// cancels exactly rounds to +0. NaN never wins (NaN < best is false) and so
// never enters a key. The atomicMin over all blocks is therefore the
// lexicographic minimum over the whole batch, which is what the sequential
// scan keeps, and its high word holds the winner's own d bits. Packing keeps
// index order, so the least packed index is the least original index. A
// source no block found a candidate for (all d >= 1e30, or no valid target)
// keeps the empty key and gets (0, 1e30).
//
// The inner loop. Per (source, target) pair the distance takes five float32
// instructions (a multiply, three fmas, an add). The sequential strict-<
// update adds a compare and two selects (eight a pair). Here each of a
// thread's sources runs one fminf chain, seeded with its best, over a group
// of kGroup targets (six instructions a pair), and keeps the start of the
// last group that lowered its best strictly (two instructions a group): a
// strict-< scan over groups, so among equal minima the earliest group is
// kept. At the end of each shared-memory tile the lanes whose best group lies
// in that tile find the group's first target whose d, the same rounded
// arithmetic, equals the best: bit-identical, and the sequential winner.
// Nothing is rescanned inside the loop: an earlier version that rescanned a
// sub-chunk each time it lowered a best took about a quarter longer on the
// train shape, and the compare-and-select form about half as long again
// (PERF.md, section 6).
//
// Bound: about 8 x 46,080 sources x (valid targets) pairs a train step, some
// 1.7e10 at KITTI density, each 8 float32 operations (the dot product's three
// multiplies and two adds, the two adds of the combination, the compare):
// about 2 ms at 67 TFLOP/s; the bytes (sources, targets, flags, outputs, some
// 21 MB) take 6 us. Operations set the bound. Counted in scheduler slots
// instead (one warp instruction a cycle on each of the 4 x 132 schedulers),
// the six instructions a pair of the fminf loop need about 3 ms at 1.98 GHz:
// the floor for this fma order. The tensor cores would compute the cross term
// faster in TF32 or split bf16, but not in this order: an approximate filter
// with an exact re-check is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 2048;           // target slots a count/pack block covers
constexpr int kCompactThreads = 256;
constexpr int kThreads = 128;          // search block
constexpr int kSrcPerThread = 8;
constexpr int kSrcPerWarp = 32 * kSrcPerThread;
constexpr int kSrcPerBlock = kThreads * kSrcPerThread;
constexpr int kTile = 1024;            // targets in one shared-memory buffer
constexpr int kGroup = 16;             // targets one fminf chain covers
constexpr int kMinBlocksPerSm = 4;     // resident blocks the registers allow
constexpr int kMaxGridYZ = 65535;
constexpr int kFinishThreads = 256;
constexpr float kBig = 1e30f;
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// d(s, t) in the reference's order; (q.x, q.y, q.z) = t, q.w = |t|^2.
__device__ __forceinline__ float dist(float sx, float sy, float sz, float ssq, float4 q) {
  const float cross = __fmaf_rn(sz, q.z, __fmaf_rn(sy, q.y, __fmul_rn(sx, q.x)));
  // (|s|^2 + |t|^2) - 2 cross, one rounding: 2 cross is exact.
  return __fmaf_rn(-2.0f, cross, __fadd_rn(ssq, q.w));
}

__device__ __forceinline__ unsigned int ordered_bits(float d) {
  const unsigned int u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The sum over a block of kCompactThreads; every thread gets it.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kCompactThreads / 32; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kCompactThreads)
nn_count_targets(const unsigned char* __restrict__ valid, int* __restrict__ chunk_count,
                 int T, int chunks, int batch) {
  __shared__ int scratch[kCompactThreads / 32];
  const int lo = blockIdx.x * kChunk;
  const int hi = min(T, lo + kChunk);
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const unsigned char* vb = valid + static_cast<long long>(b) * T;
    int n = 0;
    for (int j = lo + threadIdx.x; j < hi; j += kCompactThreads) n += vb[j] != 0;
    n = block_sum(n, scratch);
    if (threadIdx.x == 0) chunk_count[static_cast<long long>(b) * chunks + blockIdx.x] = n;
  }
}

__global__ void __launch_bounds__(kCompactThreads)
nn_pack_targets(const float* __restrict__ tgt, const unsigned char* __restrict__ valid,
                const int* __restrict__ chunk_count, float4* __restrict__ packed,
                int* __restrict__ orig, int* __restrict__ count, int T, int chunks, int batch) {
  __shared__ int scratch[kCompactThreads / 32];
  __shared__ int warp_total[kCompactThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int lo = c * kChunk;
  const int hi = min(T, lo + kChunk);
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long bT = static_cast<long long>(b) * T;
    const int* cb = chunk_count + static_cast<long long>(b) * chunks;
    int part = 0;
    for (int i = threadIdx.x; i < c; i += kCompactThreads) part += cb[i];
    int base = block_sum(part, scratch);
    for (int j0 = lo; j0 < hi; j0 += kCompactThreads) {
      const int j = j0 + threadIdx.x;
      const bool flag = j < hi && valid[bT + j] != 0;
      const unsigned int ballot = __ballot_sync(0xffffffffu, flag);
      if (lane == 0) warp_total[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kCompactThreads / 32; ++w) {
        const int t = warp_total[w];
        before += w < warp ? t : 0;
        total += t;
      }
      if (flag) {
        const int dst = base + before + __popc(ballot & ((1u << lane) - 1u));
        const float* t = tgt + (bT + j) * 3;
        const float x = t[0], y = t[1], z = t[2];
        packed[bT + dst] = make_float4(x, y, z, sum_sq(x, y, z));
        orig[bT + dst] = j;
      }
      base += total;
      __syncthreads();  // warp_total is read before the next round writes it
    }
    if (c == chunks - 1 && threadIdx.x == 0) count[b] = base;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
nn_search(const float* __restrict__ src, const float4* __restrict__ packed,
          const int* __restrict__ count, unsigned long long* __restrict__ keys, int S, int T,
          int splits, int batch) {
  __shared__ __align__(16) float4 tile[2][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kSrcPerBlock + warp * kSrcPerWarp + lane;
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    const int n = count[b];
    const int lo = static_cast<int>(static_cast<long long>(n) * blockIdx.y / splits);
    const int hi = static_cast<int>(static_cast<long long>(n) * (blockIdx.y + 1) / splits);
    if (lo >= hi) continue;  // uniform over the block
    const float4* pb = packed + static_cast<long long>(b) * T;
    const long long sbase = static_cast<long long>(b) * S;

    float sx[kSrcPerThread], sy[kSrcPerThread], sz[kSrcPerThread], ssq[kSrcPerThread];
    float best[kSrcPerThread];
    int best_g[kSrcPerThread];   // packed index of the group that set best
    int best_j[kSrcPerThread];   // packed index of the winner, once resolved
#pragma unroll
    for (int k = 0; k < kSrcPerThread; ++k) {
      const int i = min(first + 32 * k, S - 1);
      const float* s = src + (sbase + i) * 3;
      sx[k] = s[0];
      sy[k] = s[1];
      sz[k] = s[2];
      ssq[k] = sum_sq(sx[k], sy[k], sz[k]);
      best[k] = kBig;
      best_g[k] = -1;
      best_j[k] = -1;
    }

    const int tiles = (hi - lo + kTile - 1) / kTile;
    auto fetch = [&](int it) {
      const int base = lo + it * kTile;
      const int m = min(kTile, hi - base);
      float4* dst = tile[it & 1];
      for (int t = threadIdx.x; t < m; t += kThreads) cp_async16(dst + t, pb + base + t);
    };
    fetch(0);
    cp_async_commit();
    for (int it = 0; it < tiles; ++it) {
      if (it + 1 < tiles) fetch(it + 1);
      cp_async_commit();   // an empty group on the last tile keeps the count
      cp_async_wait_one();
      const int base = lo + it * kTile;
      const int m = min(kTile, hi - base);
      const float4* q = tile[it & 1];
      // Pad the last tile to whole groups with targets that never win:
      // d = +inf or NaN.
      const int mr = (m + kGroup - 1) / kGroup * kGroup;
      for (int t = m + threadIdx.x; t < mr; t += kThreads) {
        tile[it & 1][t] = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
      }
      __syncthreads();
      for (int g0 = 0; g0 < mr; g0 += kGroup) {
        float run[kSrcPerThread];
#pragma unroll
        for (int k = 0; k < kSrcPerThread; ++k) run[k] = best[k];
#pragma unroll 8
        for (int t = 0; t < kGroup; ++t) {
          const float4 qt = q[g0 + t];
#pragma unroll
          for (int k = 0; k < kSrcPerThread; ++k) {
            run[k] = fminf(run[k], dist(sx[k], sy[k], sz[k], ssq[k], qt));
          }
        }
#pragma unroll
        for (int k = 0; k < kSrcPerThread; ++k) {
          best_g[k] = run[k] < best[k] ? base + g0 : best_g[k];
          best[k] = run[k];
        }
      }
      // Resolve the groups this tile set: the first target of the group
      // whose d, the same rounded arithmetic, equals the best.
#pragma unroll
      for (int k = 0; k < kSrcPerThread; ++k) {
        const bool mine = best_g[k] >= base;
        if (__any_sync(0xffffffffu, mine)) {
          const int g = mine ? best_g[k] - base : 0;
          int j = kGroup;
          for (int t = kGroup - 1; t >= 0; --t) {
            if (dist(sx[k], sy[k], sz[k], ssq[k], q[g + t]) == best[k]) j = t;
          }
          if (mine) best_j[k] = best_g[k] + j;
        }
      }
      __syncthreads();  // the buffer is read before the copy two tiles on
    }
#pragma unroll
    for (int k = 0; k < kSrcPerThread; ++k) {
      const int i = first + 32 * k;
      if (i < S && best_j[k] >= 0) {
        const unsigned long long key =
            (static_cast<unsigned long long>(ordered_bits(best[k])) << 32) |
            static_cast<unsigned int>(best_j[k]);
        atomicMin(keys + sbase + i, key);
      }
    }
  }
}

__global__ void __launch_bounds__(kFinishThreads)
nn_finish(unsigned long long* __restrict__ keys, const int* __restrict__ orig,
          int* __restrict__ out_idx, float* __restrict__ out_sq, int S, int T,
          long long total) {
  const long long i = blockIdx.x * static_cast<long long>(kFinishThreads) + threadIdx.x;
  if (i >= total) return;
  const unsigned long long key = keys[i];
  keys[i] = kEmpty;
  if (key == kEmpty) {
    out_idx[i] = 0;
    out_sq[i] = kBig;
    return;
  }
  const long long b = i / S;
  out_sq[i] = from_ordered_bits(static_cast<unsigned int>(key >> 32));
  out_idx[i] = orig[b * T + static_cast<unsigned int>(key)];
}

// The number of target ranges a batch's search is split into. The blocks of
// one call do equal work and an SM runs `slots / SMs` of them at a time, so a
// call takes about ceil(blocks / slots) rounds of one block's time; a round
// that leaves SMs with fewer resident blocks runs them below the SM's rate.
// Of the counts that give at least one full round and ranges of at least one
// tile of slots, take the one with the least rounds times block time, with a
// small cost a block for its set-up.
int choose_splits(long long per_split, int T, long long slots) {
  const long long most = (T + kTile - 1) / kTile;
  long long lo = (slots + per_split - 1) / per_split;
  lo = lo < 1 ? 1 : (lo > most ? most : lo);
  long long hi = 8 * lo < most ? 8 * lo : most;
  hi = hi > kMaxGridYZ ? kMaxGridYZ : hi;
  lo = lo > hi ? hi : lo;
  long long pick = lo;
  double pick_cost = 0.0;
  for (long long s = lo; s <= hi; ++s) {
    const double rounds = static_cast<double>((per_split * s + slots - 1) / slots);
    const double cost = rounds * (1.0 / s + 1.0 / 512);
    if (s == lo || cost < pick_cost) {
      pick = s;
      pick_cost = cost;
    }
  }
  return static_cast<int>(pick);
}

// Search blocks the card runs at once: SMs times resident blocks an SM.
long long search_slots(int device) {
  static long long cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms <= 0) {
    sms = 132;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_search, kThreads, 0) !=
          cudaSuccess || per_sm <= 0) {
    per_sm = 1;
  }
  const long long slots = static_cast<long long>(sms) * per_sm;
  if (device >= 0 && device < 64) cached[device] = slots;
  return slots;
}

}  // namespace

// src [batch, S, 3] f32, tgt [batch, T, 3] f32, valid [batch, T] bool (one
// byte each), all contiguous, T >= 1; keys [batch * S] uint64, every bit set
// (the finishing pass leaves them so); scratch, 16-byte aligned: packed
// targets (16 B a slot), their original indices (4 B a slot), a count a row
// and one a chunk of kChunk slots, batch * (20 T + 4 + 4 ceil(T / kChunk))
// bytes; out_idx [batch, S] int32, out_sq [batch, S] f32. Launches on
// `stream` from `device`, which is made current for the call if it is not.
// Returns the CUDA error code, 0 on success.
extern "C" int nn_search_launch(const void* src, const void* tgt, const void* valid,
                                void* keys, void* scratch, void* out_idx, void* out_sq,
                                int batch, int S, int T, int device, void* stream) {
  if (batch <= 0 || S <= 0) return 0;
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (T + kChunk - 1) / kChunk;
  char* base = static_cast<char*>(scratch);
  float4* packed = reinterpret_cast<float4*>(base);
  int* orig = reinterpret_cast<int*>(base + static_cast<long long>(batch) * T * 16);
  int* count = orig + static_cast<long long>(batch) * T;
  int* chunk_count = count + batch;
  const unsigned int rows = static_cast<unsigned int>(batch < kMaxGridYZ ? batch : kMaxGridYZ);
  const dim3 cgrid(static_cast<unsigned int>(chunks), rows);
  nn_count_targets<<<cgrid, kCompactThreads, 0, st>>>(static_cast<const unsigned char*>(valid),
                                                      chunk_count, T, chunks, batch);
  nn_pack_targets<<<cgrid, kCompactThreads, 0, st>>>(
      static_cast<const float*>(tgt), static_cast<const unsigned char*>(valid), chunk_count,
      packed, orig, count, T, chunks, batch);
  const long long tiles = (S + kSrcPerBlock - 1) / kSrcPerBlock;
  const int splits = choose_splits(tiles * rows, T, search_slots(device));
  const dim3 sgrid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(splits), rows);
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  nn_search<<<sgrid, kThreads, 0, st>>>(static_cast<const float*>(src), packed, count, k, S, T,
                                        splits, batch);
  const long long total = static_cast<long long>(batch) * S;
  nn_finish<<<static_cast<unsigned int>((total + kFinishThreads - 1) / kFinishThreads),
              kFinishThreads, 0, st>>>(k, orig, static_cast<int*>(out_idx),
                                       static_cast<float*>(out_sq), S, T, total);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
