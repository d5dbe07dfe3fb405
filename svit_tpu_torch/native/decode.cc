// Native data-plane: threaded JPEG file decoding for the input pipeline.
//
// The reference leans on OpenCV/PyAV (C++/C) for its decode path
// (slowfast/datasets/utils.py:20-48); this is the host-side equivalent:
// libjpeg decode with a persistent worker pool, exposed through a C ABI
// consumed via ctypes (svit_tpu_torch/native/jpeg.py).  Decoding a batch of
// frames releases the Python GIL for the whole batch instead of per image.

#include <cstdio>    // jpeglib.h needs FILE declared first

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG from memory into RGB8.  Returns malloc'd buffer or null.
uint8_t* decode_mem(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  size_t stride = static_cast<size_t>(*w) * 3;
  uint8_t* out = static_cast<uint8_t*>(malloc(stride * (*h)));
  if (!out) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out;
}

uint8_t* read_file(const char* path, size_t* len) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    fclose(f);
    return nullptr;
  }
  uint8_t* buf = static_cast<uint8_t*>(malloc(size));
  if (!buf || fread(buf, 1, size, f) != static_cast<size_t>(size)) {
    free(buf);
    fclose(f);
    return nullptr;
  }
  fclose(f);
  *len = size;
  return buf;
}

// ---------------------------------------------------------------------------
// Persistent worker pool
// ---------------------------------------------------------------------------
class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

Pool* pool() {
  static Pool p(std::max(2u, std::thread::hardware_concurrency() / 2));
  return &p;
}

}  // namespace

extern "C" {

// Decode one file; returns RGB8 buffer (caller frees with svit_free).
uint8_t* svit_decode_jpeg_file(const char* path, int* w, int* h) {
  size_t len;
  uint8_t* data = read_file(path, &len);
  if (!data) return nullptr;
  uint8_t* out = decode_mem(data, len, w, h);
  free(data);
  return out;
}

// Decode a batch of files in parallel.  outs[i] get malloc'd RGB8 buffers
// (or null on failure); ws/hs receive dimensions.  Returns #successes.
int svit_decode_jpeg_batch(const char** paths, int n, uint8_t** outs,
                           int* ws, int* hs) {
  std::atomic<int> ok{0};
  std::atomic<int> done{0};
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    pool()->submit([&, i] {
      outs[i] = svit_decode_jpeg_file(paths[i], &ws[i], &hs[i]);
      if (outs[i]) ok.fetch_add(1);
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return ok.load();
}

void svit_free(void* p) { free(p); }

}  // extern "C"
