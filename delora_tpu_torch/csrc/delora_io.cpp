// delora_io: the host IO runtime of the PyTorch port.
//
// The port's own copy of native/delora_io.cpp: a C++ threaded reader and
// packer that turns on-disk scans (.npy pairs written by preprocessing, or
// raw KITTI .bin) into fixed-shape padded batch buffers without holding the
// Python GIL (the role of the original DeLORA's DataLoader worker processes).
//
// One change from the original: finished batches are kept in a map keyed by
// their ticket, so dio_loader_next delivers ticket next_deliver whatever
// order the workers finish in. The original kept them in a FIFO queue and
// waited for its front to hold the next ticket, which never happened when a
// later, smaller request finished first.
//
// C ABI (ctypes):
//   dio_read_velodyne(path, out, capacity)           raw KITTI .bin -> xyzi
//   dio_read_npy_f32(path, out, capacity, cols)      .npy [N, cols] float32
//   dio_project_scan(...)                            host spherical projection
//   dio_loader_create / request / next / destroy     threaded pair batcher
//
// Build (delora_tpu_torch/ops/cuda/build.py::build_host, at first use):
//   c++ -O3 -std=c++17 -shared -fPIC -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// File readers
// ---------------------------------------------------------------------------

// Raw KITTI velodyne .bin: flat float32 (x, y, z, intensity) rows.
int read_velodyne(const char* path, float* out, int capacity_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (bytes < 0 || bytes % 16 != 0) {
    std::fclose(f);
    return -1;
  }
  long n = bytes / 16;
  if (n > capacity_points) n = capacity_points;
  size_t got = std::fread(out, 16, static_cast<size_t>(n), f);
  std::fclose(f);
  return static_cast<int>(got);
}

// Minimal .npy parser for little-endian float32 C-order arrays [N, cols].
// Returns row count or -1. Only the format preprocessing writes is supported.
int read_npy_f32(const char* path, float* out, int capacity_rows, int cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return -1;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t len16;
    if (std::fread(&len16, 2, 1, f) != 1) { std::fclose(f); return -1; }
    header_len = len16;
  } else {
    if (std::fread(&header_len, 4, 1, f) != 1) { std::fclose(f); return -1; }
  }
  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, f) != header_len) {
    std::fclose(f);
    return -1;
  }
  if (header.find("'descr': '<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    std::fclose(f);
    return -1;
  }
  size_t sp = header.find("'shape': (");
  if (sp == std::string::npos) { std::fclose(f); return -1; }
  long rows = 0, file_cols = 1;
  int parsed = std::sscanf(header.c_str() + sp, "'shape': (%ld, %ld", &rows,
                           &file_cols);
  if (parsed < 1) { std::fclose(f); return -1; }
  if (parsed == 1) file_cols = 1;
  if (file_cols != cols) { std::fclose(f); return -1; }
  if (rows > capacity_rows) rows = capacity_rows;
  size_t got = std::fread(out, sizeof(float) * cols,
                          static_cast<size_t>(rows), f);
  std::fclose(f);
  return static_cast<int>(got);
}

// ---------------------------------------------------------------------------
// Host-side spherical projection (target-image cache builder)
// ---------------------------------------------------------------------------
// The original's twin of the numpy host projection: (u, v) via atan2,
// round-half-to-even pixel snap, per-pixel closest-point winner by a
// sequential scatter-min (strict '<' keeps the smallest point index on exact
// range ties, as the stable sorts of the numpy route do). Its mean range sums
// in double in point order, one ulp away from the numpy route's float32 sum
// at times; the port's artifacts stay on the numpy route
// (ops/projection_host.py).

int project_scan(const float* points, const uint8_t* valid, int n_points,
                 int height, int width, float fov_up, float fov_down,
                 float fov_left, float fov_right, float* image_out,
                 int32_t* point_index_out, float* mean_range_out) {
  const int num_pix = height * width;
  std::memset(image_out, 0, sizeof(float) * 4 * static_cast<size_t>(num_pix));
  for (int p = 0; p < num_pix; ++p) point_index_out[p] = -1;
  std::vector<float> best_r(static_cast<size_t>(num_pix), 0.0f);

  // Keep the numpy implementation's exact operation order (subtract,
  // divide by the FoV span, then scale) so boundary pixels round the same.
  const float u_span = fov_right - fov_left;
  const float v_span = fov_up - fov_down;
  double range_sum = 0.0;
  long n_valid = 0;
  int winners = 0;

  for (int i = 0; i < n_points; ++i) {
    const float x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
    const float r = std::sqrt(x * x + y * y + z * z);
    if (valid[i]) {
      range_sum += r;
      ++n_valid;
    }
    if (!valid[i] || r <= 0.0f) continue;
    // nearbyintf under the default FE_TONEAREST rounds half-to-even —
    // matching np.round / jnp.round exactly.
    const float uf = std::nearbyint(
        (std::atan2(y, x) - fov_left) / u_span * (width - 1));
    const float vf = std::nearbyint(
        (std::atan2(z, std::sqrt(x * x + y * y)) - fov_down) / v_span *
        (height - 1));
    if (uf < 0.0f || uf > width - 1 || vf < 0.0f || vf > height - 1) continue;
    const int pix = static_cast<int>(vf) * width + static_cast<int>(uf);
    if (point_index_out[pix] >= 0 && best_r[pix] <= r) continue;
    if (point_index_out[pix] < 0) ++winners;
    best_r[pix] = r;
    point_index_out[pix] = i;
    float* cell = image_out + 4 * static_cast<size_t>(pix);
    cell[0] = x;
    cell[1] = y;
    cell[2] = z;
    cell[3] = r;
  }
  *mean_range_out =
      static_cast<float>(range_sum / static_cast<double>(std::max(n_valid, 1L)));
  return winners;
}

// ---------------------------------------------------------------------------
// Threaded pair batcher
// ---------------------------------------------------------------------------

struct PairSlot {
  // One scan's padded data inside a batch buffer set.
  std::vector<float> pts1, nrm1, pts2, nrm2;
  std::vector<uint8_t> val1, val2;
  int batch_size = 0;
};

struct Loader {
  std::vector<std::string> scan_paths;     // flat scan index -> file
  std::vector<std::string> normal_paths;
  int max_points = 0;

  // Work queue of batch requests; results delivered in request order.
  struct Request {
    std::vector<int> first_scan;           // pair = (i, i+1) per element
    uint64_t ticket;
  };
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::queue<Request> work;
  std::map<uint64_t, PairSlot*> done;      // finished batches by ticket
  uint64_t next_ticket = 0, next_deliver = 0;
  std::atomic<bool> stop{false};
  std::vector<std::thread> threads;

  ~Loader() {
    stop.store(true);
    cv_work.notify_all();
    for (auto& t : threads) t.join();
    std::lock_guard<std::mutex> lk(mu);
    for (auto& entry : done) delete entry.second;
    done.clear();
  }

  void load_scan(int index, float* pts, float* nrm, uint8_t* val) {
    const int cap = max_points;
    std::memset(pts, 0, sizeof(float) * 3 * cap);
    std::memset(nrm, 0, sizeof(float) * 3 * cap);
    std::memset(val, 0, cap);
    int n = read_npy_f32(scan_paths[index].c_str(), pts, cap, 3);
    int m = read_npy_f32(normal_paths[index].c_str(), nrm, cap, 3);
    if (n < 0) n = 0;
    if (m >= 0 && m < n) n = m;  // keep arrays row-aligned
    std::memset(val, 1, static_cast<size_t>(n));
  }

  void worker() {
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop.load() || !work.empty(); });
        if (stop.load()) return;
        req = std::move(work.front());
        work.pop();
      }
      const int B = static_cast<int>(req.first_scan.size());
      auto* slot = new PairSlot();
      slot->batch_size = B;
      const size_t per = static_cast<size_t>(max_points) * 3;
      slot->pts1.resize(per * B);
      slot->nrm1.resize(per * B);
      slot->pts2.resize(per * B);
      slot->nrm2.resize(per * B);
      slot->val1.resize(static_cast<size_t>(max_points) * B);
      slot->val2.resize(static_cast<size_t>(max_points) * B);
      for (int b = 0; b < B; ++b) {
        int i = req.first_scan[b];
        load_scan(i, slot->pts1.data() + per * b, slot->nrm1.data() + per * b,
                  slot->val1.data() + static_cast<size_t>(max_points) * b);
        load_scan(i + 1, slot->pts2.data() + per * b,
                  slot->nrm2.data() + per * b,
                  slot->val2.data() + static_cast<size_t>(max_points) * b);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done[req.ticket] = slot;
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int dio_read_velodyne(const char* path, float* out, int capacity_points) {
  return read_velodyne(path, out, capacity_points);
}

int dio_read_npy_f32(const char* path, float* out, int capacity_rows, int cols) {
  return read_npy_f32(path, out, capacity_rows, cols);
}

int dio_project_scan(const float* points, const uint8_t* valid, int n_points,
                     int height, int width, float fov_up, float fov_down,
                     float fov_left, float fov_right, float* image_out,
                     int32_t* point_index_out, float* mean_range_out) {
  return project_scan(points, valid, n_points, height, width, fov_up,
                      fov_down, fov_left, fov_right, image_out,
                      point_index_out, mean_range_out);
}

void* dio_loader_create(const char** scan_paths, const char** normal_paths,
                        int n_scans, int max_points, int n_threads) {
  auto* loader = new Loader();
  loader->scan_paths.assign(scan_paths, scan_paths + n_scans);
  loader->normal_paths.assign(normal_paths, normal_paths + n_scans);
  loader->max_points = max_points;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    loader->threads.emplace_back([loader] { loader->worker(); });
  return loader;
}

// Enqueue one batch of pairs (each given by its first-scan flat index).
// Returns the request ticket (>= 0).
long dio_loader_request(void* handle, const int* first_scan_indices, int count) {
  auto* loader = static_cast<Loader*>(handle);
  Loader::Request req;
  req.first_scan.assign(first_scan_indices, first_scan_indices + count);
  long ticket;
  {
    std::lock_guard<std::mutex> lk(loader->mu);
    ticket = static_cast<long>(loader->next_ticket);
    req.ticket = loader->next_ticket++;
    loader->work.push(std::move(req));
  }
  loader->cv_work.notify_one();
  return ticket;
}

// Blocks until the NEXT batch (in request order) is ready; copies into the
// caller's buffers ([B, max_points, 3] floats / [B, max_points] uint8).
// Returns the batch size, or -1 on shutdown.
int dio_loader_next(void* handle, float* pts1, float* nrm1, uint8_t* val1,
                    float* pts2, float* nrm2, uint8_t* val2) {
  auto* loader = static_cast<Loader*>(handle);
  PairSlot* slot = nullptr;
  {
    std::unique_lock<std::mutex> lk(loader->mu);
    loader->cv_done.wait(lk, [&] {
      return loader->stop.load() || loader->done.count(loader->next_deliver) > 0;
    });
    if (loader->stop.load()) return -1;
    auto found = loader->done.find(loader->next_deliver);
    slot = found->second;
    loader->done.erase(found);
    loader->next_deliver++;
  }
  const size_t fb = slot->pts1.size();
  std::memcpy(pts1, slot->pts1.data(), fb * sizeof(float));
  std::memcpy(nrm1, slot->nrm1.data(), fb * sizeof(float));
  std::memcpy(pts2, slot->pts2.data(), fb * sizeof(float));
  std::memcpy(nrm2, slot->nrm2.data(), fb * sizeof(float));
  std::memcpy(val1, slot->val1.data(), slot->val1.size());
  std::memcpy(val2, slot->val2.data(), slot->val2.size());
  int B = slot->batch_size;
  delete slot;
  return B;
}

void dio_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
