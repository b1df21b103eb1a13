// pislam-tpu native runtime: PNG I/O + prefetching frame streamer.
//
// Role: the host-side data path around the device compute. The reference's
// equivalent is the demo driver's libpng read/write (demo.cpp:141-276); here
// it is a reusable shared library with a background decode thread and a ring
// buffer so PNG decode overlaps device extraction (the reference's "Pi GPU
// does the preprocessing" split becomes "CPU thread feeds the device").
//
// C ABI, consumed from Python via ctypes (pislam_tpu/io/native.py).
//
// Build: g++ -O2 -shared -fPIC pislam_io.cpp -o libpislam_io.so -lpng -lz -lpthread

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PNG read/write (8-bit grayscale; color inputs are converted).
// ---------------------------------------------------------------------------

// Returns 0 on success. Caller frees *data with pio_free.
int pio_read_png(const char *path, uint8_t **data, uint32_t *width,
                 uint32_t *height) {
  FILE *fp = fopen(path, "rb");
  if (!fp) return -1;

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { fclose(fp); return -2; }
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); fclose(fp); return -2; }

  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -3;
  }

  png_init_io(png, fp);
  png_read_info(png, info);

  const png_uint_32 w = png_get_image_width(png, info);
  const png_uint_32 h = png_get_image_height(png, info);
  const int color = png_get_color_type(png, info);
  const int depth = png_get_bit_depth(png, info);

  // normalise everything to 8-bit gray
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  uint8_t *buf = (uint8_t *)malloc((size_t)w * h);
  if (!buf) { png_destroy_read_struct(&png, &info, nullptr); fclose(fp); return -4; }

  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = buf + (size_t)y * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  *data = buf;
  *width = w;
  *height = h;
  return 0;
}

// Returns 0 on success. stride >= width (row pitch of the source buffer).
int pio_write_png(const char *path, const uint8_t *data, uint32_t width,
                  uint32_t height, uint32_t stride) {
  FILE *fp = fopen(path, "wb");
  if (!fp) return -1;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { fclose(fp); return -2; }
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_write_struct(&png, nullptr); fclose(fp); return -2; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_set_IHDR(png, info, width, height, 8, PNG_COLOR_TYPE_GRAY,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  std::vector<png_bytep> rows(height);
  for (uint32_t y = 0; y < height; ++y)
    rows[y] = const_cast<png_bytep>(data + (size_t)y * stride);
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

void pio_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// Prefetching frame streamer: background thread decodes PNG frames into a
// fixed ring buffer of (height, width) uint8 images (resize NOT done here --
// frames must already match the configured size; mismatches are errors).
// ---------------------------------------------------------------------------

struct PioStream {
  std::vector<std::string> paths;
  uint32_t w = 0, h = 0;
  size_t capacity = 0;

  std::vector<uint8_t> ring;        // capacity * w * h
  std::vector<int> status;          // per-slot: 0 empty, 1 full, <0 error
  size_t head = 0, tail = 0, count = 0;
  size_t next_file = 0;

  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::thread worker;
  std::atomic<bool> stop{false};

  void run() {
    while (!stop.load()) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_empty.wait(lk, [&] { return stop.load() || count < capacity; });
        if (stop.load()) return;
        if (next_file >= paths.size()) return;  // finished
        idx = next_file++;
      }
      uint8_t *data = nullptr;
      uint32_t fw = 0, fh = 0;
      int rc = pio_read_png(paths[idx].c_str(), &data, &fw, &fh);
      if (rc == 0 && (fw != w || fh != h)) { rc = -5; }
      {
        std::unique_lock<std::mutex> lk(mu);
        size_t slot = head % capacity;
        if (rc == 0) {
          memcpy(ring.data() + slot * (size_t)w * h, data, (size_t)w * h);
        }
        status[slot] = rc == 0 ? 1 : rc;
        head++;
        count++;
        cv_full.notify_one();
      }
      if (data) free(data);
    }
  }
};

// paths: '\n'-separated file list. Returns handle or null.
void *pio_stream_open(const char *paths_joined, uint32_t width,
                      uint32_t height, uint32_t capacity) {
  auto *s = new PioStream();
  s->w = width;
  s->h = height;
  s->capacity = capacity ? capacity : 4;
  const char *p = paths_joined;
  while (*p) {
    const char *e = strchr(p, '\n');
    if (!e) e = p + strlen(p);
    if (e > p) s->paths.emplace_back(p, e - p);
    p = *e ? e + 1 : e;
  }
  if (s->paths.empty()) { delete s; return nullptr; }
  s->ring.resize(s->capacity * (size_t)width * height);
  s->status.assign(s->capacity, 0);
  s->worker = std::thread([s] { s->run(); });
  return s;
}

int pio_stream_len(void *handle) {
  return (int)((PioStream *)handle)->paths.size();
}

// Blocking next frame into `out` (width*height bytes).
// Returns 0 ok, 1 end-of-stream, <0 decode error for this frame.
int pio_stream_next(void *handle, uint8_t *out) {
  auto *s = (PioStream *)handle;
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->tail >= s->paths.size()) return 1;
  s->cv_full.wait(lk, [&] { return s->count > 0 || s->stop.load(); });
  if (s->count == 0) return 1;
  size_t slot = s->tail % s->capacity;
  int st = s->status[slot];
  if (st == 1) {
    memcpy(out, s->ring.data() + slot * (size_t)s->w * s->h,
           (size_t)s->w * s->h);
    st = 0;
  }
  s->status[slot] = 0;
  s->tail++;
  s->count--;
  s->cv_empty.notify_one();
  return st;
}

void pio_stream_close(void *handle) {
  auto *s = (PioStream *)handle;
  s->stop.store(true);
  s->cv_empty.notify_all();
  s->cv_full.notify_all();
  if (s->worker.joinable()) s->worker.join();
  delete s;
}

}  // extern "C"
