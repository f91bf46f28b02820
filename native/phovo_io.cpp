// phovo_io — native TUM RGB-D dataset streaming runtime.
//
// Re-design of the reference's C++ data-source stack
// (CCameraRecord.h:63-113 index parsing, CImageReader.h:43-83 grayscale /
// 16-bit decode, CMultiSensorDataSource.h:74-91 paired pulling): a
// multi-threaded decode-ahead pipeline so PNG decode overlaps device
// compute. The reference pulls and decodes synchronously on the caller's
// thread; here a worker pool decodes frames ahead of the consumer into a
// bounded reorder buffer, delivering frames strictly in order.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (phovo_tpu/datasets/native_loader.py). Build: `make` in native/.

#include <png.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image8 {
  int h = 0, w = 0;
  std::vector<uint8_t> data;
};
struct ImageF {
  int h = 0, w = 0;
  std::vector<float> data;
};

// BT.601 luma with rounding — matches cv2.IMREAD_GRAYSCALE's RGB->gray.
inline uint8_t luma(uint8_t r, uint8_t g, uint8_t b) {
  return (uint8_t)std::lround(0.299 * r + 0.587 * g + 0.114 * b);
}

bool decode_png_gray8(const char* path, Image8& out, std::string& err) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    err = std::string("cannot open ") + path;
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    err = std::string("png decode failed for ") + path;
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  int w = png_get_image_width(png, info);
  int h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  std::vector<uint8_t> row((size_t)w * channels);
  out.h = h;
  out.w = w;
  out.data.resize((size_t)h * w);
  for (int y = 0; y < h; y++) {
    png_read_row(png, row.data(), nullptr);
    uint8_t* dst = &out.data[(size_t)y * w];
    if (channels == 1) {
      std::memcpy(dst, row.data(), w);
    } else if (channels >= 3) {
      for (int x = 0; x < w; x++)
        dst[x] = luma(row[(size_t)x * channels], row[(size_t)x * channels + 1],
                      row[(size_t)x * channels + 2]);
    } else {  // gray+alpha
      for (int x = 0; x < w; x++) dst[x] = row[(size_t)x * channels];
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

bool decode_png_depth(const char* path, double scale, ImageF& out, std::string& err) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    err = std::string("cannot open ") + path;
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    err = std::string("png decode failed for ") + path;
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  int w = png_get_image_width(png, info);
  int h = png_get_image_height(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  out.h = h;
  out.w = w;
  out.data.resize((size_t)h * w);
  if (depth == 16) {
    std::vector<uint8_t> row((size_t)w * channels * 2);
    for (int y = 0; y < h; y++) {
      png_read_row(png, row.data(), nullptr);
      float* dst = &out.data[(size_t)y * w];
      for (int x = 0; x < w; x++) {
        // PNG 16-bit is big-endian
        uint16_t v = (uint16_t)((row[(size_t)x * channels * 2] << 8) |
                                row[(size_t)x * channels * 2 + 1]);
        dst[x] = (float)(v * scale);
      }
    }
  } else {
    std::vector<uint8_t> row((size_t)w * channels);
    for (int y = 0; y < h; y++) {
      png_read_row(png, row.data(), nullptr);
      float* dst = &out.data[(size_t)y * w];
      for (int x = 0; x < w; x++) dst[x] = (float)(row[(size_t)x * channels] * scale);
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

struct IndexEntry {
  double ts;
  std::string path;
};

std::string dirname_of(const std::string& p) {
  auto pos = p.find_last_of('/');
  return pos == std::string::npos ? std::string(".") : p.substr(0, pos);
}

bool read_index(const char* index_file, std::vector<IndexEntry>& out, std::string& err) {
  FILE* f = std::fopen(index_file, "r");
  if (!f) {
    err = std::string("cannot open record file ") + index_file;
    return false;
  }
  std::string base = dirname_of(index_file);
  char line[4096];
  while (std::fgets(line, sizeof(line), f)) {
    char* s = line;
    while (*s && std::isspace((unsigned char)*s)) s++;
    if (*s == '\0' || *s == '#') continue;
    double ts;
    char fname[4000];
    if (std::sscanf(s, "%lf %3999s", &ts, fname) == 2)
      out.push_back({ts, base + "/" + fname});
  }
  std::fclose(f);
  return true;
}

// Greedy nearest-timestamp association (TUM associate.py semantics,
// mirroring phovo_tpu/datasets/tum.py).
void associate(const std::vector<IndexEntry>& a, const std::vector<IndexEntry>& b,
               double max_dt, std::vector<std::pair<int, int>>& pairs) {
  struct Cand {
    double dt;
    int i, j;
  };
  std::vector<Cand> cands;
  for (int i = 0; i < (int)a.size(); i++)
    for (int j = 0; j < (int)b.size(); j++) {
      double dt = std::fabs(a[i].ts - b[j].ts);
      if (dt <= max_dt) cands.push_back({dt, i, j});
    }
  std::sort(cands.begin(), cands.end(), [](const Cand& x, const Cand& y) {
    if (x.dt != y.dt) return x.dt < y.dt;
    if (x.i != y.i) return x.i < y.i;
    return x.j < y.j;
  });
  std::vector<char> ua(a.size(), 0), ub(b.size(), 0);
  for (auto& c : cands)
    if (!ua[c.i] && !ub[c.j]) {
      ua[c.i] = ub[c.j] = 1;
      pairs.push_back({c.i, c.j});
    }
  std::sort(pairs.begin(), pairs.end());
}

struct Frame {
  double ts_rgb = 0, ts_depth = 0;
  Image8 intensity;
  ImageF depth;
  bool ok = false;
  std::string err;
};

struct Loader {
  std::vector<IndexEntry> rgb, dep;
  std::vector<std::pair<int, int>> pairs;
  double depth_scale = 1.0 / 5000.0;
  int prefetch = 4;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::map<int, Frame> ready;   // decoded frames awaiting consumption
  std::atomic<int> next_to_assign{0};
  int next_to_consume = 0;
  bool stopping = false;
  std::string error;

  void worker() {
    for (;;) {
      int idx = next_to_assign.fetch_add(1);
      if (idx >= (int)pairs.size()) return;
      // bound how far ahead of the consumer we run
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [&] { return stopping || idx < next_to_consume + prefetch; });
        if (stopping) return;
      }
      Frame f;
      f.ts_rgb = rgb[pairs[idx].first].ts;
      f.ts_depth = dep[pairs[idx].second].ts;
      std::string e1, e2;
      bool ok1 = decode_png_gray8(rgb[pairs[idx].first].path.c_str(), f.intensity, e1);
      bool ok2 = decode_png_depth(dep[pairs[idx].second].path.c_str(), depth_scale, f.depth, e2);
      f.ok = ok1 && ok2;
      if (!f.ok) f.err = ok1 ? e2 : e1;
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(idx, std::move(f));
      }
      cv_consume.notify_all();
    }
  }

  void start(int n_threads) {
    for (int i = 0; i < n_threads; i++) workers.emplace_back([this] { worker(); });
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_produce.notify_all();
    // also wake any consumer blocked in phovo_loader_next waiting for a
    // frame that will now never be decoded — it returns end-of-stream
    cv_consume.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

}  // namespace

extern "C" {

void* phovo_loader_open(const char* rgb_index, const char* depth_index,
                        double depth_scale, int lockstep, double max_dt,
                        int prefetch, int n_threads, char* err_buf, int err_len) {
  auto* L = new Loader();
  L->depth_scale = depth_scale;
  L->prefetch = prefetch > 0 ? prefetch : 4;
  std::string err;
  if (!read_index(rgb_index, L->rgb, err) || !read_index(depth_index, L->dep, err)) {
    std::snprintf(err_buf, err_len, "%s", err.c_str());
    delete L;
    return nullptr;
  }
  if (lockstep) {
    int n = (int)std::min(L->rgb.size(), L->dep.size());
    for (int i = 0; i < n; i++) L->pairs.push_back({i, i});
  } else {
    associate(L->rgb, L->dep, max_dt, L->pairs);
  }
  L->start(n_threads > 0 ? n_threads : 2);
  return L;
}

int phovo_loader_len(void* h) { return (int)((Loader*)h)->pairs.size(); }

// Fetch the next frame in order. Returns 0 on success, 1 at end-of-stream,
// -1 on decode error (err_buf filled). Buffers must hold cap bytes/floats;
// actual dims written to H/W. Frames larger than cap fail with -1.
int phovo_loader_next(void* h, uint8_t* intensity, float* depth, int cap,
                      double* ts_rgb, double* ts_depth, int* H, int* W,
                      char* err_buf, int err_len) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_consume >= (int)L->pairs.size()) return 1;
  int idx = L->next_to_consume;
  L->cv_consume.wait(
      lk, [&] { return L->stopping || L->ready.count(idx) > 0; });
  // stop() aborts a blocked consumer as a clean end-of-stream (the frame
  // it was waiting on will never be decoded)
  if (L->ready.count(idx) == 0) return 1;
  Frame f = std::move(L->ready[idx]);
  L->ready.erase(idx);
  L->next_to_consume++;
  lk.unlock();
  L->cv_produce.notify_all();
  if (!f.ok) {
    std::snprintf(err_buf, err_len, "%s", f.err.c_str());
    return -1;
  }
  int n = f.intensity.h * f.intensity.w;
  if (n > cap || f.depth.h * f.depth.w > cap) {
    std::snprintf(err_buf, err_len, "frame %dx%d exceeds buffer capacity %d",
                  f.intensity.h, f.intensity.w, cap);
    return -1;
  }
  std::memcpy(intensity, f.intensity.data.data(), n);
  std::memcpy(depth, f.depth.data.data(), (size_t)f.depth.h * f.depth.w * sizeof(float));
  *ts_rgb = f.ts_rgb;
  *ts_depth = f.ts_depth;
  *H = f.intensity.h;
  *W = f.intensity.w;
  return 0;
}

// Stop decode workers and unblock any consumer waiting in
// phovo_loader_next (it sees end-of-stream), WITHOUT freeing the loader.
// Callers tearing down from another thread call this first, let their
// consumers drain, then call phovo_loader_close — destroying the mutex
// while a thread is blocked on it is undefined behavior.
void phovo_loader_stop(void* h) { ((Loader*)h)->stop(); }

void phovo_loader_close(void* h) {
  auto* L = (Loader*)h;
  L->stop();
  delete L;
}

// Single-image decode helpers (the CImageReader analogs).
int phovo_decode_gray8(const char* path, uint8_t* out, int cap, int* H, int* W,
                       char* err_buf, int err_len) {
  Image8 img;
  std::string err;
  if (!decode_png_gray8(path, img, err)) {
    std::snprintf(err_buf, err_len, "%s", err.c_str());
    return -1;
  }
  if (img.h * img.w > cap) {
    std::snprintf(err_buf, err_len, "image exceeds buffer capacity");
    return -1;
  }
  std::memcpy(out, img.data.data(), (size_t)img.h * img.w);
  *H = img.h;
  *W = img.w;
  return 0;
}

int phovo_decode_depth16(const char* path, float* out, int cap, double scale,
                         int* H, int* W, char* err_buf, int err_len) {
  ImageF img;
  std::string err;
  if (!decode_png_depth(path, scale, img, err)) {
    std::snprintf(err_buf, err_len, "%s", err.c_str());
    return -1;
  }
  if (img.h * img.w > cap) {
    std::snprintf(err_buf, err_len, "image exceeds buffer capacity");
    return -1;
  }
  std::memcpy(out, img.data.data(), (size_t)img.h * img.w * sizeof(float));
  *H = img.h;
  *W = img.w;
  return 0;
}

}  // extern "C"
