// framepump: host-side JPEG and frame-queue runtime of the demo server.
//
// A copy of live2diff_tpu/serve/framepump.cpp for the PyTorch/CUDA port:
//
//   * JPEG encode/decode via libjpeg (no PIL round-trips in the MJPEG
//     fan-out path),
//   * a mutex-light MPMC frame ring with drop-oldest semantics, shared
//     between network threads and the pipeline thread.
//
// C ABI only; built with g++ and loaded from python with ctypes
// (framepump.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

#include <jpeglib.h>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG encode (RGB8 HWC -> baseline JFIF)
// ---------------------------------------------------------------------------

// Returns malloc'd buffer in *out (caller frees with fp_free), size as return
// value; 0 on failure.
long fp_encode_jpeg(const uint8_t* rgb, int height, int width, int quality,
                    uint8_t** out) {
  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);

  unsigned char* mem = nullptr;
  unsigned long mem_size = 0;
  jpeg_mem_dest(&cinfo, &mem, &mem_size);

  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);

  const int stride = width * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb + cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = mem;
  return static_cast<long>(mem_size);
}

// Decode JPEG -> RGB8 HWC. Returns malloc'd buffer + dims; 0 on failure.
long fp_decode_jpeg(const uint8_t* data, long size, uint8_t** out,
                    int* height, int* width) {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int stride = w * 3;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(h) * stride));
  while (static_cast<int>(cinfo.output_scanline) < h) {
    JSAMPROW row = buf + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *height = h;
  *width = w;
  return static_cast<long>(h) * stride;
}

void fp_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// frame ring: fixed-capacity, drop-oldest, blocking pop with timeout
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<uint8_t> data;
  uint64_t seq = 0;
};

struct FrameRing {
  explicit FrameRing(int capacity) : cap(capacity), buf(capacity) {}
  const int cap;
  std::vector<Frame> buf;
  std::mutex mu;
  std::condition_variable cv;
  uint64_t head = 0;  // next write slot (monotonic seq)
  uint64_t tail = 0;  // next read slot
  std::atomic<uint64_t> dropped{0};
};

void* fp_ring_create(int capacity) { return new FrameRing(capacity); }

void fp_ring_destroy(void* ring) { delete static_cast<FrameRing*>(ring); }

// Push a frame; drops the oldest when full (real-time semantics).
void fp_ring_push(void* ring, const uint8_t* data, long size) {
  auto* r = static_cast<FrameRing*>(ring);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    if (r->head - r->tail == static_cast<uint64_t>(r->cap)) {
      ++r->tail;  // drop oldest
      r->dropped.fetch_add(1, std::memory_order_relaxed);
    }
    Frame& f = r->buf[r->head % r->cap];
    f.data.assign(data, data + size);
    f.seq = r->head;
    ++r->head;
  }
  r->cv.notify_one();
}

// Pop into caller buffer (max_size). Blocks up to timeout_ms.
// Returns size, 0 on timeout, -1 if caller buffer too small.
long fp_ring_pop(void* ring, uint8_t* out, long max_size, int timeout_ms) {
  auto* r = static_cast<FrameRing*>(ring);
  std::unique_lock<std::mutex> lk(r->mu);
  if (!r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [&] { return r->tail < r->head; })) {
    return 0;
  }
  Frame& f = r->buf[r->tail % r->cap];
  if (static_cast<long>(f.data.size()) > max_size) return -1;
  std::memcpy(out, f.data.data(), f.data.size());
  ++r->tail;
  return static_cast<long>(f.data.size());
}

long fp_ring_size(void* ring) {
  auto* r = static_cast<FrameRing*>(ring);
  std::lock_guard<std::mutex> lk(r->mu);
  return static_cast<long>(r->head - r->tail);
}

long fp_ring_dropped(void* ring) {
  return static_cast<long>(
      static_cast<FrameRing*>(ring)->dropped.load(std::memory_order_relaxed));
}

}  // extern "C"
