// fastloader — native multi-threaded JPEG/PNG decode + resize + normalize
// batch pipeline, the C++ side of data/native_loader.py.
//
// Worker threads decode images with libjpeg (libpng for PNG), resize them
// bilinearly to exactly SxS (both sides, as Resize([S, S]) does), map them
// to [-1,1] float32 NHWC, and assemble whole batches into a bounded ring of
// buffers that the host thread copies out and hands to the card. A corrupt
// file is replaced by resampling another index, so every batch keeps its
// shape; an item that fails 10 times ends the epoch with an error.
//
// C API (ctypes-friendly); see data/native_loader.py for the wrapper.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#ifndef SGFR_NO_PNG
#include <png.h>
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto *err = reinterpret_cast<JpegErrorMgr *>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// decode a JPEG file into RGB8; returns false on any error.
// min_dim > 0 enables DCT-domain downscaling (libjpeg scale_denom): the
// image is decoded at the coarsest 1/2^k scale whose BOTH sides still
// cover min_dim, then bilinear-resized to the exact target. This skips
// most of the IDCT + color-convert work for large sources feeding a
// small training resolution — the host input pipeline must outrun the
// training step or the card starves. Opt-in (fast_decode) because the pixels
// differ slightly from the full-res-decode-then-resize parity path the
// Python loader (PIL) uses.
bool decode_jpeg(const std::string &path, std::vector<uint8_t> &rgb,
                 int &width, int &height, int min_dim) {
  FILE *f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (min_dim > 0) {
    int iw = cinfo.image_width, ih = cinfo.image_height;
    int denom = 1;
    for (int d = 2; d <= 8; d *= 2) {
      if (iw / d >= min_dim && ih / d >= min_dim) denom = d;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  width = cinfo.output_width;
  height = cinfo.output_height;
  rgb.resize(static_cast<size_t>(width) * height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *row = rgb.data() +
                   static_cast<size_t>(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// decode a PNG file into RGB8 via the libpng simplified API; returns false
// on any error (FacesDataset globs *.png too — dataset.py:28-41 accepts
// both, so the native path must as well). Compiled out with -DSGFR_NO_PNG
// on hosts lacking the libpng dev library — the wrapper then routes
// PNG-bearing datasets to the Python loader via fl_has_png().
#ifdef SGFR_NO_PNG
bool decode_png(const std::string &, std::vector<uint8_t> &, int &, int &) {
  return false;
}
#else
bool decode_png(const std::string &path, std::vector<uint8_t> &rgb,
                int &width, int &height) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path.c_str())) return false;
  image.format = PNG_FORMAT_RGB;
  rgb.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, rgb.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  width = static_cast<int>(image.width);
  height = static_cast<int>(image.height);
  return width > 0 && height > 0;
}
#endif  // SGFR_NO_PNG

// dispatch on magic bytes (extensions lie; the reference's PIL open does
// content sniffing too)
bool decode_image(const std::string &path, std::vector<uint8_t> &rgb,
                  int &width, int &height, int min_dim) {
  FILE *f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, sizeof(magic), f);
  fclose(f);
  if (got >= 8 && magic[0] == 0x89 && magic[1] == 'P' && magic[2] == 'N' &&
      magic[3] == 'G')
    return decode_png(path, rgb, width, height);  // no DCT scaling for PNG
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
    return decode_jpeg(path, rgb, width, height, min_dim);
  return false;
}

// bilinear sample with half-pixel centers (matches PIL/torch
// align_corners=False up-path used by the python loader)
inline float lerp_sample(const uint8_t *img, int w, int h, int c, float fx,
                         float fy, int ch) {
  int x0 = static_cast<int>(std::floor(fx));
  int y0 = static_cast<int>(std::floor(fy));
  float ax = fx - x0, ay = fy - y0;
  auto clampi = [](int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
  };
  int x0c = clampi(x0, 0, w - 1), x1c = clampi(x0 + 1, 0, w - 1);
  int y0c = clampi(y0, 0, h - 1), y1c = clampi(y0 + 1, 0, h - 1);
  auto at = [&](int yy, int xx) {
    return static_cast<float>(img[(static_cast<size_t>(yy) * w + xx) * 3 +
                                  ch]);
  };
  float top = at(y0c, x0c) * (1 - ax) + at(y0c, x1c) * ax;
  float bot = at(y1c, x0c) * (1 - ax) + at(y1c, x1c) * ax;
  return top * (1 - ay) + bot * ay;
}

// exact SxS bilinear resize (aspect-distorting, matching the reference's
// transforms.Resize([S, S]) — a LIST argument resizes both sides exactly,
// train.py:110), then normalize to [-1, 1]
void resize_normalize(const std::vector<uint8_t> &rgb, int w, int h, int S,
                      float *out) {
  float sx = static_cast<float>(w) / S, sy = static_cast<float>(h) / S;
  for (int y = 0; y < S; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    for (int x = 0; x < S; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      for (int c = 0; c < 3; ++c) {
        float v = lerp_sample(rgb.data(), w, h, 3, fx, fy, c) / 255.0f;
        out[(static_cast<size_t>(y) * S + x) * 3 + c] = (v - 0.5f) / 0.5f;
      }
    }
  }
}

struct Batch {
  size_t index = 0;
  size_t valid = 0;  // real item count (< batch_size only for the tail)
  size_t bad = 0;    // items that exhausted their 10 decode attempts
  std::vector<float> images;
  std::vector<int32_t> labels;
};

struct BatchOrder {
  bool operator()(const Batch *a, const Batch *b) const {
    return a->index > b->index;  // min-heap by index
  }
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<int32_t> labels;
  int batch_size = 0;
  int out_size = 0;
  int n_threads = 4;
  bool shuffle = true;
  bool drop_last = true;
  uint32_t seed = 0;
  // fast_decode: DCT-domain downscale for JPEG sources much larger than
  // out_size (0 = parity with the Python loader's full-res decode)
  int fast_decode = 0;

  std::vector<uint32_t> order;
  std::atomic<size_t> next_batch{0};
  size_t n_batches = 0;

  std::priority_queue<Batch *, std::vector<Batch *>, BatchOrder> ready;
  std::mutex mu;
  std::condition_variable cv_ready;
  size_t max_ready = 8;
  std::vector<std::thread> workers;
  std::atomic<bool> stop_flag{false};
  std::atomic<size_t> produced{0};
  size_t next_expected = 0;

  void build_order() {
    order.resize(paths.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    if (shuffle) {
      std::mt19937 rng(seed);
      std::shuffle(order.begin(), order.end(), rng);
    }
    n_batches = drop_last ? paths.size() / batch_size
                          : (paths.size() + batch_size - 1) / batch_size;
  }

  // returns false when 10 consecutive decodes failed — the caller must
  // surface the error (silently training on a zero image with a real
  // class label would skew the head toward a random identity; the
  // Python DataLoader raises '10 consecutive corrupt samples' here)
  bool fill_item(uint32_t idx, float *img_out, int32_t *label_out,
                 std::mt19937 &rng) {
    std::vector<uint8_t> rgb;
    int w, h;
    for (int attempt = 0; attempt < 10; ++attempt) {
      // two tries per index: a transient open/decode failure (EMFILE or
      // ENOMEM under host pressure) must not flip this slot to a random
      // OTHER identity — that silently corrupts the epoch's label
      // sequence (observed as a one-element label mismatch vs the
      // Python loader under a loaded 1-core host)
      for (int t = 0; t < 2; ++t) {
        if (decode_image(paths[idx], rgb, w, h,
                         fast_decode ? out_size : 0) &&
            w > 0 && h > 0) {
          resize_normalize(rgb, w, h, out_size, img_out);
          *label_out = labels[idx];
          return true;
        }
      }
      idx = rng() % paths.size();  // corrupt: resample (static shapes)
    }
    std::memset(img_out, 0,
                sizeof(float) * 3 * out_size * out_size);
    *label_out = 0;
    return false;
  }

  void worker(int wid) {
    std::mt19937 rng(seed * 9973u + wid);
    while (!stop_flag.load()) {
      size_t b = next_batch.fetch_add(1);
      if (b >= n_batches) break;
      auto *batch = new Batch;
      batch->index = b;
      size_t start = b * static_cast<size_t>(batch_size);
      size_t count = std::min(static_cast<size_t>(batch_size),
                              paths.size() - start);
      batch->images.resize(static_cast<size_t>(batch_size) * out_size *
                           out_size * 3);
      batch->labels.resize(batch_size);
      for (size_t i = 0; i < count; ++i) {
        if (!fill_item(order[start + i],
                       batch->images.data() +
                           i * static_cast<size_t>(out_size) * out_size * 3,
                       &batch->labels[i], rng))
          batch->bad++;
      }
      batch->valid = count;
      for (size_t i = count; i < static_cast<size_t>(batch_size); ++i) {
        // ragged tail (drop_last=false): pad the buffer so it is fully
        // defined, but report `valid` so the wrapper trims — the Python
        // DataLoader yields a smaller final batch and the two loaders
        // must keep the same iteration contract
        std::memcpy(batch->images.data() +
                        i * static_cast<size_t>(out_size) * out_size * 3,
                    batch->images.data(),
                    sizeof(float) * out_size * out_size * 3);
        batch->labels[i] = batch->labels[0];
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        // window by index (not queue size): the batch holding
        // next_expected must always be admittable or the in-order
        // consumer deadlocks behind later batches
        cv_ready.wait(lk, [&] {
          return batch->index < next_expected + max_ready ||
                 stop_flag.load();
        });
        if (stop_flag.load()) {
          delete batch;
          break;
        }
        ready.push(batch);
      }
      cv_ready.notify_all();
    }
  }

  void start() {
    stop_flag = false;
    produced = 0;
    next_expected = 0;
    next_batch = 0;
    build_order();
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this, i] { worker(i); });
  }

  void join() {
    {
      // setting stop_flag under mu closes the lost-wakeup window: a
      // worker that just evaluated the wait predicate (false) while
      // holding mu cannot miss this notify and sleep forever
      std::unique_lock<std::mutex> lk(mu);
      stop_flag = true;
    }
    cv_ready.notify_all();
    for (auto &t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    std::unique_lock<std::mutex> lk(mu);
    while (!ready.empty()) {
      delete ready.top();
      ready.pop();
    }
  }
};

}  // namespace

extern "C" {

// 1 when PNG decoding is compiled in; the python wrapper checks this and
// falls back to the Python loader for PNG-bearing file lists otherwise
int fl_has_png(void) {
#ifdef SGFR_NO_PNG
  return 0;
#else
  return 1;
#endif
}

void *fl_create(const char **paths, int n_paths, const int32_t *labels,
                int batch_size, int out_size, int n_threads, int shuffle,
                uint32_t seed, int drop_last, int fast_decode) {
  auto *l = new Loader;
  l->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) l->paths.emplace_back(paths[i]);
  l->labels.assign(labels, labels + n_paths);
  l->batch_size = batch_size;
  l->out_size = out_size;
  l->n_threads = n_threads;
  l->shuffle = shuffle != 0;
  l->seed = seed;
  l->drop_last = drop_last != 0;
  l->fast_decode = fast_decode;
  l->start();
  return l;
}

int fl_num_batches(void *handle) {
  return static_cast<int>(static_cast<Loader *>(handle)->n_batches);
}

// blocking: copy the next ready batch into caller buffers.
// returns the number of REAL items in the batch (== batch_size except for
// a ragged drop_last=false tail), 0 when the epoch is exhausted, or -1
// when an item exhausted its 10 decode attempts (the wrapper raises).
int fl_next(void *handle, float *images_out, int32_t *labels_out) {
  auto *l = static_cast<Loader *>(handle);
  Batch *batch = nullptr;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    // deliver strictly in batch-index order
    l->cv_ready.wait(lk, [&] {
      if (l->produced.load() >= l->n_batches) return true;
      return !l->ready.empty() && l->ready.top()->index == l->next_expected;
    });
    if (l->produced.load() >= l->n_batches) return 0;
    batch = l->ready.top();
    l->ready.pop();
    l->next_expected++;
    l->produced.fetch_add(1);
  }
  l->cv_ready.notify_all();
  std::memcpy(images_out, batch->images.data(),
              batch->images.size() * sizeof(float));
  std::memcpy(labels_out, batch->labels.data(),
              batch->labels.size() * sizeof(int32_t));
  int valid = static_cast<int>(batch->valid);
  bool bad = batch->bad != 0;
  delete batch;
  return bad ? -1 : valid;
}

void fl_reset(void *handle, uint32_t seed) {
  auto *l = static_cast<Loader *>(handle);
  l->join();
  l->seed = seed;
  l->start();
}

void fl_destroy(void *handle) {
  auto *l = static_cast<Loader *>(handle);
  l->join();
  delete l;
}

}  // extern "C"
