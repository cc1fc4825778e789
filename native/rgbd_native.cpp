// Native data-path for the RGB-D engine.
//
// The reference library leans on OpenCV's C++ image I/O for its loader
// (SURVEY.md §2.1 "TUM dataset loader", L4); this is the same component
// here: a small C++ decode/prefetch core (libpng + zlib, no OpenCV
// dependency) exposed through a C ABI that Python binds with ctypes
// (data/native_loader.py). Decoding 16-bit depth PNGs is the host-side
// cost of the odometry pipeline; doing it here keeps the Python thread
// free to drive the device.
//
// Exported ABI (all return 0 on success, negative on error):
//   rgbd_png_dims(path, &w, &h, &channels, &bit_depth)
//   rgbd_decode_depth16(path, out_u16, capacity_px)   // 16-bit gray PNG
//   rgbd_decode_gray8(path, out_u8, capacity_px)      // any PNG -> 8-bit luma
//   rgbd_loader_create(rgb_paths, depth_paths, n, w, h, depth_slots, threads)
//   rgbd_loader_next(handle, gray_out, depth_out)     // blocks; -> frame idx
//   rgbd_loader_destroy(handle)
//   rgbd_version()
//
// The loader is the multi-threaded prefetch runtime: a pool of decode
// threads fills a bounded ring of frame slots strictly ahead of the
// consumer, so PNG inflate (the host-side cost of the odometry pipeline)
// overlaps device compute and is itself parallel across frames — the
// native equivalent of the reference's OpenCV-backed loader, without the
// Python GIL in the decode path.

#include <png.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PngReader {
  FILE* f = nullptr;
  png_structp png = nullptr;
  png_infop info = nullptr;

  ~PngReader() {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    if (f) fclose(f);
  }

  int open(const char* path) {
    f = fopen(path, "rb");
    if (!f) return -1;
    unsigned char sig[8];
    if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) return -2;
    png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return -3;
    info = png_create_info_struct(png);
    if (!info) return -3;
    if (setjmp(png_jmpbuf(png))) return -4;
    png_init_io(png, f);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);
    return 0;
  }
};

}  // namespace

extern "C" {
int rgbd_decode_depth16(const char* path, uint16_t* out, int64_t capacity_px);
int rgbd_decode_gray8(const char* path, uint8_t* out, int64_t capacity_px);
}

namespace {

// Bounded-ring prefetching loader. Slot i%depth may only hold frame i once
// the consumer has drained frame i-depth, so memory is depth*(W*H*3) bytes
// regardless of sequence length. Workers claim frame indices from a shared
// counter; the consumer releases slots strictly in order.
class Loader {
 public:
  Loader(std::vector<std::string> rgb, std::vector<std::string> dep, int w,
         int h, int depth_slots, int n_threads)
      : rgb_(std::move(rgb)),
        dep_(std::move(dep)),
        w_(w),
        h_(h),
        slots_(depth_slots) {
    for (auto& s : slots_) {
      s.gray.resize(static_cast<size_t>(w) * h);
      s.depth.resize(static_cast<size_t>(w) * h);
      s.frame = -1;
    }
    const int n = static_cast<int>(std::max<size_t>(1, n_threads));
    for (int t = 0; t < n; ++t)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Loader() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_producer_.notify_all();
    cv_consumer_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Blocks until the next sequential frame is decoded; copies it out.
  // Returns the frame index, -1 past the end, or -100-rc on decode error.
  int64_t Next(uint8_t* gray_out, uint16_t* depth_out) {
    std::unique_lock<std::mutex> lk(mu_);
    const int64_t want = consumed_;
    if (want >= static_cast<int64_t>(rgb_.size())) return -1;
    Slot& s = slots_[want % slots_.size()];
    cv_consumer_.wait(lk, [&] { return s.frame == want || stop_; });
    if (stop_ && s.frame != want) return -2;
    if (s.error) return -100 + s.error;  // error already negative
    std::memcpy(gray_out, s.gray.data(), s.gray.size());
    std::memcpy(depth_out, s.depth.data(), s.depth.size() * sizeof(uint16_t));
    s.frame = -1;
    ++consumed_;
    lk.unlock();
    cv_producer_.notify_all();
    return want;
  }

 private:
  struct Slot {
    std::vector<uint8_t> gray;
    std::vector<uint16_t> depth;
    int64_t frame = -1;   // index currently stored, -1 = free
    int error = 0;
  };

  void WorkerLoop() {
    for (;;) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        idx = next_claim_;
        if (stop_ || idx >= static_cast<int64_t>(rgb_.size())) return;
        ++next_claim_;
        // Wait until our slot is drained (ring back-pressure).
        cv_producer_.wait(lk, [&] {
          return stop_ ||
                 idx - consumed_ < static_cast<int64_t>(slots_.size());
        });
        if (stop_) return;
      }
      // Decode outside the lock: this is the parallel hot path.
      Slot& s = slots_[idx % slots_.size()];
      int rc = rgbd_decode_gray8(rgb_[idx].c_str(), s.gray.data(),
                                 static_cast<int64_t>(w_) * h_);
      if (rc == 0)
        rc = rgbd_decode_depth16(dep_[idx].c_str(), s.depth.data(),
                                 static_cast<int64_t>(w_) * h_);
      {
        std::unique_lock<std::mutex> lk(mu_);
        s.error = rc;
        s.frame = idx;
      }
      cv_consumer_.notify_all();
    }
  }

  std::vector<std::string> rgb_, dep_;
  const int w_, h_;
  std::vector<Slot> slots_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_producer_, cv_consumer_;
  int64_t next_claim_ = 0;
  int64_t consumed_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

int rgbd_version() { return 2; }

void* rgbd_loader_create(const char** rgb_paths, const char** depth_paths,
                         int n_frames, int width, int height, int depth_slots,
                         int n_threads) {
  if (n_frames <= 0 || depth_slots <= 0 || width <= 0 || height <= 0)
    return nullptr;
  std::vector<std::string> rgb(rgb_paths, rgb_paths + n_frames);
  std::vector<std::string> dep(depth_paths, depth_paths + n_frames);
  return new Loader(std::move(rgb), std::move(dep), width, height, depth_slots,
                    n_threads);
}

int64_t rgbd_loader_next(void* handle, uint8_t* gray_out, uint16_t* depth_out) {
  return static_cast<Loader*>(handle)->Next(gray_out, depth_out);
}

void rgbd_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int rgbd_png_dims(const char* path, int* w, int* h, int* channels, int* bit_depth) {
  PngReader r;
  int rc = r.open(path);
  if (rc) return rc;
  *w = png_get_image_width(r.png, r.info);
  *h = png_get_image_height(r.png, r.info);
  *channels = png_get_channels(r.png, r.info);
  *bit_depth = png_get_bit_depth(r.png, r.info);
  return 0;
}

// 16-bit grayscale PNG (TUM depth) -> uint16 row-major, native endianness.
int rgbd_decode_depth16(const char* path, uint16_t* out, int64_t capacity_px) {
  PngReader r;
  int rc = r.open(path);
  if (rc) return rc;
  if (setjmp(png_jmpbuf(r.png))) return -4;
  const int w = png_get_image_width(r.png, r.info);
  const int h = png_get_image_height(r.png, r.info);
  if (png_get_bit_depth(r.png, r.info) != 16 ||
      png_get_channels(r.png, r.info) != 1)
    return -5;
  if (static_cast<int64_t>(w) * h > capacity_px) return -6;
  png_set_swap(r.png);  // PNG is big-endian; host is little-endian.
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y)
    rows[y] = reinterpret_cast<png_bytep>(out + static_cast<int64_t>(y) * w);
  png_read_image(r.png, rows.data());
  return 0;
}

// Any PNG -> 8-bit luma (BT.601 integer approximation), row-major.
int rgbd_decode_gray8(const char* path, uint8_t* out, int64_t capacity_px) {
  PngReader r;
  int rc = r.open(path);
  if (rc) return rc;
  if (setjmp(png_jmpbuf(r.png))) return -4;
  png_set_expand(r.png);          // palettes / low-bit gray -> 8-bit
  png_set_strip_16(r.png);        // 16-bit -> 8-bit
  png_set_strip_alpha(r.png);
  png_read_update_info(r.png, r.info);
  const int w = png_get_image_width(r.png, r.info);
  const int h = png_get_image_height(r.png, r.info);
  const int ch = png_get_channels(r.png, r.info);
  if (static_cast<int64_t>(w) * h > capacity_px) return -6;
  if (ch != 1 && ch != 3) return -5;
  std::vector<uint8_t> buf(static_cast<size_t>(w) * h * ch);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y)
    rows[y] = buf.data() + static_cast<size_t>(y) * w * ch;
  png_read_image(r.png, rows.data());
  if (ch == 1) {
    std::memcpy(out, buf.data(), static_cast<size_t>(w) * h);
  } else {
    const uint8_t* p = buf.data();
    for (int64_t i = 0, n = static_cast<int64_t>(w) * h; i < n; ++i, p += 3) {
      // TUM rgb files are RGB order; integer BT.601 luma.
      out[i] = static_cast<uint8_t>((77 * p[0] + 150 * p[1] + 29 * p[2]) >> 8);
    }
  }
  return 0;
}

}  // extern "C"
