// The port's native host decode pool: fused JPEG / PNG decode -> resize ->
// normalize (or uint8) -> pad, plus a pthread worker pool that decodes a
// batch's images concurrently.
//
// The port's own copy of cpm_tpu/native/imageops.cpp, with the same
// arithmetic, so that both packages' loaders make the same batches bit for
// bit: libjpeg / libpng decodes, PIL's antialiased bilinear taps (train),
// cv2's INTER_LINEAR resize with its 2x INTER_AREA switch (eval), and the
// pool. It stands in for the reference's DataLoader worker processes. The
// loaders (cpm_tpu_torch/data/loader.py) use it whenever it builds, and
// PIL otherwise.
//
// Exposed C ABI (ctypes, cpm_tpu_torch/native/__init__.py):
//   imgops_decode_resize_normalize / imgops_decode_resize_u8  one image
//   pool_create / pool_submit[_u8] / pool_wait_any[_u8] / pool_destroy
//
// Build: cpm_tpu_torch/native/__init__.py (g++ -O3 -shared -ljpeg -lpng
// -lpthread, into build/cpm_tpu_torch/).

#include <csetjmp>
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------

// libjpeg's default error_exit() terminates the process; route fatal
// errors through setjmp instead so a bad byte stream returns an error code.
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_error_longjmp(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

static void jpeg_silent_output(j_common_ptr) {}

// Decode a JPEG byte buffer to RGB8. Returns 0 on success.
static int decode_jpeg_rgb(const uint8_t* data, size_t len,
                           std::vector<uint8_t>* out, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_longjmp;
  jerr.mgr.output_message = jpeg_silent_output;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

static void png_read_cb(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  size_t take = std::min(n, s->len - s->pos);
  memcpy(out, s->data + s->pos, take);
  s->pos += take;
}

static int decode_png_rgb(const uint8_t* data, size_t len,
                          std::vector<uint8_t>* out, int* w, int* h) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_cb);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  out->resize(size_t(*w) * (*h) * 3);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y)
    rows[y] = out->data() + size_t(y) * (*w) * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---------------------------------------------------------------------
// resize (PIL-style triangle/antialias bilinear)
// ---------------------------------------------------------------------

struct FilterTaps {
  std::vector<int> lo;          // first source index per output px
  std::vector<int> n;           // tap count per output px
  std::vector<float> weights;   // max_taps per output px
  int max_taps;
};

// PIL "BILINEAR" = triangle filter with support scaled by the downscale
// ratio (antialiasing). Matches PIL.Image.resize semantics.
static FilterTaps make_taps(int in_size, int out_size) {
  FilterTaps t;
  double scale = double(in_size) / out_size;
  double support = std::max(1.0, scale);
  t.max_taps = int(ceil(support * 2)) + 2;
  t.lo.resize(out_size);
  t.n.resize(out_size);
  t.weights.assign(size_t(out_size) * t.max_taps, 0.f);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(0, int(center - support + 0.5));
    int hi = std::min(in_size, int(center + support + 0.5));
    t.lo[i] = lo;
    t.n[i] = hi - lo;
    double total = 0;
    for (int j = lo; j < hi; ++j) {
      double x = (j + 0.5 - center) / std::max(1.0, scale);
      double wgt = std::max(0.0, 1.0 - std::fabs(x));
      t.weights[size_t(i) * t.max_taps + (j - lo)] = float(wgt);
      total += wgt;
    }
    if (total > 0)
      for (int j = 0; j < t.n[i]; ++j)
        t.weights[size_t(i) * t.max_taps + j] /= float(total);
  }
  return t;
}

// RGB8 [ih, iw] -> float RGB [oh, ow] (separable)
static void resize_bilinear(const uint8_t* src, int ih, int iw, float* dst,
                            int oh, int ow) {
  FilterTaps tx = make_taps(iw, ow);
  FilterTaps ty = make_taps(ih, oh);
  // horizontal pass: [ih, ow, 3]
  std::vector<float> tmp(size_t(ih) * ow * 3);
  for (int y = 0; y < ih; ++y) {
    const uint8_t* srow = src + size_t(y) * iw * 3;
    float* trow = tmp.data() + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      float r = 0, g = 0, b = 0;
      const float* w = &tx.weights[size_t(x) * tx.max_taps];
      const uint8_t* s = srow + size_t(tx.lo[x]) * 3;
      for (int j = 0; j < tx.n[x]; ++j) {
        r += w[j] * s[j * 3 + 0];
        g += w[j] * s[j * 3 + 1];
        b += w[j] * s[j * 3 + 2];
      }
      trow[x * 3 + 0] = r;
      trow[x * 3 + 1] = g;
      trow[x * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int y = 0; y < oh; ++y) {
    const float* w = &ty.weights[size_t(y) * ty.max_taps];
    float* drow = dst + size_t(y) * ow * 3;
    memset(drow, 0, sizeof(float) * ow * 3);
    for (int j = 0; j < ty.n[y]; ++j) {
      const float* trow = tmp.data() + size_t(ty.lo[y] + j) * ow * 3;
      float wj = w[j];
      for (int k = 0; k < ow * 3; ++k) drow[k] += wj * trow[k];
    }
  }
}

// ---------------------------------------------------------------------
// resize (cv2 INTER_LINEAR, no antialias) — the reference's EVAL-time
// resize semantics (the reference's pet/rcnn/core/test.py:353-354:
// cv2.resize(im_f32, None, None, fx=s, fy=s, INTER_LINEAR)).
//
// cv2 maps dst->src at (dst+0.5)*scale-0.5 with scale = 1/f (the scale
// FACTOR, not dsize/ssize), clamps the 2-tap window to the image, and —
// a documented cv2 quirk — silently switches to the fast INTER_AREA
// path when both scale factors are exactly 1/2 (imgproc/resize.cpp:
// is_area_fast && iscale==2). Tail blocks of that path average only the
// in-bounds samples. Input is treated as float32 (the reference casts
// to f32 before resizing), so we interpolate the u8 source in f32.
// ---------------------------------------------------------------------

struct LinTaps {
  std::vector<int> s0, s1;
  std::vector<float> a;  // weight of s1; s0 gets (1-a)
};

static LinTaps make_cv2_taps(int in_size, int out_size, double scale) {
  LinTaps t;
  t.s0.resize(out_size);
  t.s1.resize(out_size);
  t.a.resize(out_size);
  for (int i = 0; i < out_size; ++i) {
    float f = float((i + 0.5) * scale - 0.5);
    int s = int(std::floor(f));
    float a = f - s;
    if (s < 0) {
      s = 0;
      a = 0.f;
    }
    if (s >= in_size - 1) {
      s = in_size - 1;
      a = 0.f;
    }
    t.s0[i] = s;
    t.s1[i] = std::min(s + 1, in_size - 1);
    t.a[i] = a;
  }
  return t;
}

// RGB8 [ih, iw] -> float RGB [oh, ow], cv2-INTER_AREA fast 2x path
// (count-normalized tail blocks).
static void resize_cv2_area2x(const uint8_t* src, int ih, int iw, float* dst,
                              int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    int sy0 = 2 * y;
    float* drow = dst + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      int sx0 = 2 * x;
      float sum[3] = {0.f, 0.f, 0.f};
      int count = 0;
      for (int sy = sy0; sy < std::min(sy0 + 2, ih); ++sy) {
        const uint8_t* srow = src + size_t(sy) * iw * 3;
        for (int sx = sx0; sx < std::min(sx0 + 2, iw); ++sx) {
          sum[0] += srow[sx * 3 + 0];
          sum[1] += srow[sx * 3 + 1];
          sum[2] += srow[sx * 3 + 2];
          ++count;
        }
      }
      float inv = count > 0 ? 1.f / count : 0.f;
      drow[x * 3 + 0] = sum[0] * inv;
      drow[x * 3 + 1] = sum[1] * inv;
      drow[x * 3 + 2] = sum[2] * inv;
    }
  }
}

// RGB8 [ih, iw] -> float RGB [oh, ow] with cv2 INTER_LINEAR semantics.
// scale_x/scale_y are the dst->src mapping scales (1/f).
static void resize_cv2_linear(const uint8_t* src, int ih, int iw, float* dst,
                              int oh, int ow, double scale_x,
                              double scale_y) {
  int isx = int(scale_x), isy = int(scale_y);
  if (std::fabs(scale_x - isx) < 1e-12 && std::fabs(scale_y - isy) < 1e-12 &&
      isx == 2 && isy == 2) {
    resize_cv2_area2x(src, ih, iw, dst, oh, ow);
    return;
  }
  LinTaps tx = make_cv2_taps(iw, ow, scale_x);
  LinTaps ty = make_cv2_taps(ih, oh, scale_y);
  // horizontal pass on every source row, then vertical 2-tap blend
  // (cv2's HResize-then-VResize order, float math throughout)
  std::vector<float> tmp(size_t(ih) * ow * 3);
  for (int y = 0; y < ih; ++y) {
    const uint8_t* srow = src + size_t(y) * iw * 3;
    float* trow = tmp.data() + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      float a = tx.a[x];
      const uint8_t* p0 = srow + size_t(tx.s0[x]) * 3;
      const uint8_t* p1 = srow + size_t(tx.s1[x]) * 3;
      trow[x * 3 + 0] = p0[0] * (1.f - a) + p1[0] * a;
      trow[x * 3 + 1] = p0[1] * (1.f - a) + p1[1] * a;
      trow[x * 3 + 2] = p0[2] * (1.f - a) + p1[2] * a;
    }
  }
  for (int y = 0; y < oh; ++y) {
    float b = ty.a[y];
    const float* r0 = tmp.data() + size_t(ty.s0[y]) * ow * 3;
    const float* r1 = tmp.data() + size_t(ty.s1[y]) * ow * 3;
    float* drow = dst + size_t(y) * ow * 3;
    for (int k = 0; k < ow * 3; ++k)
      drow[k] = r0[k] * (1.f - b) + r1[k] * b;
  }
}

// interp dispatch: 0 = PIL triangle/antialias (train parity),
// 1 = cv2 INTER_LINEAR (eval parity). scale_x/scale_y only matter for
// interp=1 (cv2 maps through the scale factor, not the size ratio).
static void resize_dispatch(const uint8_t* src, int ih, int iw, float* dst,
                            int oh, int ow, int interp, double scale_x,
                            double scale_y) {
  if (interp == 1)
    resize_cv2_linear(src, ih, iw, dst, oh, ow, scale_x, scale_y);
  else
    resize_bilinear(src, ih, iw, dst, oh, ow);
}

// ---------------------------------------------------------------------
// fused op
// ---------------------------------------------------------------------

// Decode (jpeg or png) -> resize to (rh, rw) -> normalize (optional
// RGB->BGR, x255-range kept, subtract mean / std) -> write into the
// top-left of a zeroed padded [ph, pw, 3] float32 buffer.
// Returns 0 on success; fills orig_h/orig_w.
int imgops_decode_resize_normalize(
    const uint8_t* bytes, int64_t len, int rh, int rw, int ph, int pw,
    const float* mean, const float* std_, int to_bgr, int interp,
    double scale_x, double scale_y, float* out, int* orig_h, int* orig_w) {
  std::vector<uint8_t> rgb;
  int iw = 0, ihh = 0;
  int rc = decode_jpeg_rgb(bytes, size_t(len), &rgb, &iw, &ihh);
  if (rc != 0) rc = decode_png_rgb(bytes, size_t(len), &rgb, &iw, &ihh);
  if (rc != 0) return rc;
  *orig_h = ihh;
  *orig_w = iw;

  std::vector<float> resized(size_t(rh) * rw * 3);
  resize_dispatch(rgb.data(), ihh, iw, resized.data(), rh, rw, interp,
                  scale_x, scale_y);

  memset(out, 0, sizeof(float) * size_t(ph) * pw * 3);
  for (int y = 0; y < rh; ++y) {
    const float* s = resized.data() + size_t(y) * rw * 3;
    float* d = out + size_t(y) * pw * 3;
    for (int x = 0; x < rw; ++x) {
      float r = s[x * 3 + 0], g = s[x * 3 + 1], b = s[x * 3 + 2];
      if (to_bgr) {
        d[x * 3 + 0] = (b - mean[0]) / std_[0];
        d[x * 3 + 1] = (g - mean[1]) / std_[1];
        d[x * 3 + 2] = (r - mean[2]) / std_[2];
      } else {
        d[x * 3 + 0] = (r / 255.f - mean[0]) / std_[0];
        d[x * 3 + 1] = (g / 255.f - mean[1]) / std_[1];
        d[x * 3 + 2] = (b / 255.f - mean[2]) / std_[2];
      }
    }
  }
  return 0;
}

// Decode -> resize -> optional RGB->BGR swap -> round to uint8 -> pad.
// The uint8 output is the device-side-normalization data path: the host
// ships 1/4 the bytes and the model applies the (x*a + b) input affine on
// chip (the reference ships BGR blobs and normalizes in-model through
// AffineChannel2d, pet/rcnn/modeling/model_builder.py:24-28,164).
// Rounding to uint8 after the bilinear resize matches PIL semantics
// (PIL.Image.resize returns a uint8 image that the reference normalizes).
int imgops_decode_resize_u8(
    const uint8_t* bytes, int64_t len, int rh, int rw, int ph, int pw,
    int to_bgr, int interp, double scale_x, double scale_y, uint8_t* out,
    int* orig_h, int* orig_w) {
  std::vector<uint8_t> rgb;
  int iw = 0, ihh = 0;
  int rc = decode_jpeg_rgb(bytes, size_t(len), &rgb, &iw, &ihh);
  if (rc != 0) rc = decode_png_rgb(bytes, size_t(len), &rgb, &iw, &ihh);
  if (rc != 0) return rc;
  *orig_h = ihh;
  *orig_w = iw;

  std::vector<float> resized(size_t(rh) * rw * 3);
  resize_dispatch(rgb.data(), ihh, iw, resized.data(), rh, rw, interp,
                  scale_x, scale_y);

  auto q = [](float v) {
    int i = int(v + 0.5f);
    return (uint8_t)(i < 0 ? 0 : (i > 255 ? 255 : i));
  };
  memset(out, 0, size_t(ph) * pw * 3);
  for (int y = 0; y < rh; ++y) {
    const float* s = resized.data() + size_t(y) * rw * 3;
    uint8_t* d = out + size_t(y) * pw * 3;
    for (int x = 0; x < rw; ++x) {
      float r = s[x * 3 + 0], g = s[x * 3 + 1], b = s[x * 3 + 2];
      if (to_bgr) {
        d[x * 3 + 0] = q(b);
        d[x * 3 + 1] = q(g);
        d[x * 3 + 2] = q(r);
      } else {
        d[x * 3 + 0] = q(r);
        d[x * 3 + 1] = q(g);
        d[x * 3 + 2] = q(b);
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// worker-pool prefetcher
// ---------------------------------------------------------------------

struct Task {
  int64_t id;
  std::string path;
  int rh, rw, ph, pw, to_bgr;
  int u8_mode = 0;  // 1: decode into out8 (no normalization)
  int interp = 0;   // 0 = PIL antialias, 1 = cv2 INTER_LINEAR
  double scale_x = 1.0, scale_y = 1.0;
  float mean[3], std_[3];
  std::vector<float> out;
  std::vector<uint8_t> out8;
  int orig_h = 0, orig_w = 0, status = -1;
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Task*> pending;
  std::deque<Task*> done;
  std::mutex mu;
  std::condition_variable cv_pending, cv_done;
  std::atomic<bool> stop{false};
};

static void worker_main(Pool* p) {
  for (;;) {
    Task* t = nullptr;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_pending.wait(
          lk, [&] { return p->stop.load() || !p->pending.empty(); });
      if (p->stop.load() && p->pending.empty()) return;
      t = p->pending.front();
      p->pending.pop_front();
    }
    // read file
    std::vector<uint8_t> bytes;
    FILE* f = fopen(t->path.c_str(), "rb");
    if (f) {
      fseek(f, 0, SEEK_END);
      long n = ftell(f);
      fseek(f, 0, SEEK_SET);
      bytes.resize(n);
      size_t got = fread(bytes.data(), 1, n, f);
      fclose(f);
      if ((long)got == n) {
        if (t->u8_mode) {
          t->out8.resize(size_t(t->ph) * t->pw * 3);
          t->status = imgops_decode_resize_u8(
              bytes.data(), bytes.size(), t->rh, t->rw, t->ph, t->pw,
              t->to_bgr, t->interp, t->scale_x, t->scale_y, t->out8.data(),
              &t->orig_h, &t->orig_w);
        } else {
          t->out.resize(size_t(t->ph) * t->pw * 3);
          t->status = imgops_decode_resize_normalize(
              bytes.data(), bytes.size(), t->rh, t->rw, t->ph, t->pw,
              t->mean, t->std_, t->to_bgr, t->interp, t->scale_x,
              t->scale_y, t->out.data(), &t->orig_h, &t->orig_w);
        }
      }
    }
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->done.push_back(t);
    }
    p->cv_done.notify_all();
  }
}

void* pool_create(int n_workers) {
  Pool* p = new Pool();
  for (int i = 0; i < n_workers; ++i)
    p->workers.emplace_back(worker_main, p);
  return p;
}

void pool_submit(void* pool, int64_t id, const char* path, int rh, int rw,
                 int ph, int pw, const float* mean, const float* std_,
                 int to_bgr, int interp, double scale_x, double scale_y) {
  Pool* p = static_cast<Pool*>(pool);
  Task* t = new Task();
  t->id = id;
  t->path = path;
  t->rh = rh;
  t->rw = rw;
  t->ph = ph;
  t->pw = pw;
  t->to_bgr = to_bgr;
  t->interp = interp;
  t->scale_x = scale_x;
  t->scale_y = scale_y;
  memcpy(t->mean, mean, sizeof(t->mean));
  memcpy(t->std_, std_, sizeof(t->std_));
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->pending.push_back(t);
  }
  p->cv_pending.notify_one();
}

// uint8-mode submit: no mean/std (the model normalizes on device).
void pool_submit_u8(void* pool, int64_t id, const char* path, int rh,
                    int rw, int ph, int pw, int to_bgr, int interp,
                    double scale_x, double scale_y) {
  Pool* p = static_cast<Pool*>(pool);
  Task* t = new Task();
  t->id = id;
  t->path = path;
  t->rh = rh;
  t->rw = rw;
  t->ph = ph;
  t->pw = pw;
  t->to_bgr = to_bgr;
  t->interp = interp;
  t->scale_x = scale_x;
  t->scale_y = scale_y;
  t->u8_mode = 1;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->pending.push_back(t);
  }
  p->cv_pending.notify_one();
}

// Blocks until one finished task is available; copies its buffer into out
// (must hold ph*pw*3 floats) and returns its id. status/orig sizes via
// out-params. Returns -1 if the pool is stopping and empty.
// A pool carries ONE task mode: mixing pool_submit and pool_submit_u8 in
// the same pool yields status -4 from the mismatched wait.
int64_t pool_wait_any(void* pool, float* out, int* status, int* orig_h,
                      int* orig_w) {
  Pool* p = static_cast<Pool*>(pool);
  Task* t = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return p->stop.load() || !p->done.empty(); });
    if (p->done.empty()) return -1;
    t = p->done.front();
    p->done.pop_front();
  }
  *status = t->u8_mode ? -4 : t->status;
  *orig_h = t->orig_h;
  *orig_w = t->orig_w;
  if (*status == 0)
    memcpy(out, t->out.data(), t->out.size() * sizeof(float));
  int64_t id = t->id;
  delete t;
  return id;
}

int64_t pool_wait_any_u8(void* pool, uint8_t* out, int* status, int* orig_h,
                         int* orig_w) {
  Pool* p = static_cast<Pool*>(pool);
  Task* t = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return p->stop.load() || !p->done.empty(); });
    if (p->done.empty()) return -1;
    t = p->done.front();
    p->done.pop_front();
  }
  *status = t->u8_mode ? t->status : -4;
  *orig_h = t->orig_h;
  *orig_w = t->orig_w;
  if (*status == 0) memcpy(out, t->out8.data(), t->out8.size());
  int64_t id = t->id;
  delete t;
  return id;
}

void pool_destroy(void* pool) {
  Pool* p = static_cast<Pool*>(pool);
  p->stop.store(true);
  p->cv_pending.notify_all();
  p->cv_done.notify_all();
  for (auto& w : p->workers) w.join();
  for (auto* t : p->pending) delete t;
  for (auto* t : p->done) delete t;
  delete p;
}

}  // extern "C"
