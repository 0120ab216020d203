// yolo_host: native host-side runtime kernels for the TPU detection stack.
//
// The reference leans on native code inside its dependencies for every host
// hot spot (OpenCV resize/warp, torchvision NMS, torch DataLoader workers —
// SURVEY §2.1). This library provides this framework's own native
// equivalents, exposed C-ABI for ctypes:
//
//   - bilinear uint8 resize (cv2.resize INTER_LINEAR semantics)
//   - letterbox: aspect-preserving resize + constant pad 114
//   - HSV LUT augmentation (BGR in-place, cv2-equivalent full-swing HSV)
//   - mosaic tile blit (bounds-checked copy into the 2s x 2s canvas)
//
// NMS is NOT here: it runs on-device (ops/nms.py scan + Pallas kernel);
// a host greedy NMS had no product call site and was removed.
//
// Build: make -C native   (g++ -O3 -shared; no external dependencies)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// --------------------------------------------------------------------------
// Bilinear resize, uint8 HWC. Matches cv2 INTER_LINEAR (half-pixel centers).
// --------------------------------------------------------------------------
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int channels,
                        uint8_t* dst, int dh, int dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    y0 = std::min(std::max(y0, 0), sh - 1);
    y1 = std::min(std::max(y1, 0), sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      x0 = std::min(std::max(x0, 0), sw - 1);
      x1 = std::min(std::max(x1, 0), sw - 1);
      const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const float w10 = wy * (1 - wx), w11 = wy * wx;
      const uint8_t* p00 = src + (y0 * sw + x0) * channels;
      const uint8_t* p01 = src + (y0 * sw + x1) * channels;
      const uint8_t* p10 = src + (y1 * sw + x0) * channels;
      const uint8_t* p11 = src + (y1 * sw + x1) * channels;
      uint8_t* out = dst + (y * dw + x) * channels;
      for (int c = 0; c < channels; ++c) {
        float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
        out[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// --------------------------------------------------------------------------
// Letterbox: resize keeping aspect, pad to (out_h, out_w) with `pad_value`.
// Returns ratio and pads through out params. Matches reference
// src/yolo/data/augment.py:40-94 (auto=False, scale_fill=False).
// --------------------------------------------------------------------------
void letterbox_u8(const uint8_t* src, int sh, int sw, int channels,
                  uint8_t* dst, int out_h, int out_w, uint8_t pad_value,
                  int scaleup, float* ratio_out, float* pad_out) {
  float r = std::min(static_cast<float>(out_h) / sh,
                     static_cast<float>(out_w) / sw);
  if (!scaleup) r = std::min(r, 1.0f);
  int new_w = static_cast<int>(std::lround(sw * r));
  int new_h = static_cast<int>(std::lround(sh * r));
  float dw = (out_w - new_w) / 2.0f;
  float dh = (out_h - new_h) / 2.0f;
  int top = static_cast<int>(std::lround(dh - 0.1f));
  int left = static_cast<int>(std::lround(dw - 0.1f));

  std::memset(dst, pad_value, static_cast<size_t>(out_h) * out_w * channels);

  // Resize into a temp row region directly inside dst (no extra alloc):
  // resize into the sub-rectangle [top:top+new_h, left:left+new_w].
  if (new_h == sh && new_w == sw) {
    for (int y = 0; y < new_h; ++y)
      std::memcpy(dst + ((top + y) * out_w + left) * channels,
                  src + y * sw * channels,
                  static_cast<size_t>(new_w) * channels);
  } else {
    // Resize row-by-row into the destination window.
    const float scale_y = static_cast<float>(sh) / new_h;
    const float scale_x = static_cast<float>(sw) / new_w;
    for (int y = 0; y < new_h; ++y) {
      float fy = (y + 0.5f) * scale_y - 0.5f;
      int y0 = static_cast<int>(std::floor(fy));
      float wy = fy - y0;
      int y1 = y0 + 1;
      y0 = std::min(std::max(y0, 0), sh - 1);
      y1 = std::min(std::max(y1, 0), sh - 1);
      uint8_t* out_row = dst + ((top + y) * out_w + left) * channels;
      for (int x = 0; x < new_w; ++x) {
        float fx = (x + 0.5f) * scale_x - 0.5f;
        int x0 = static_cast<int>(std::floor(fx));
        float wx = fx - x0;
        int x1 = x0 + 1;
        x0 = std::min(std::max(x0, 0), sw - 1);
        x1 = std::min(std::max(x1, 0), sw - 1);
        const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
        const float w10 = wy * (1 - wx), w11 = wy * wx;
        const uint8_t* p00 = src + (y0 * sw + x0) * channels;
        const uint8_t* p01 = src + (y0 * sw + x1) * channels;
        const uint8_t* p10 = src + (y1 * sw + x0) * channels;
        const uint8_t* p11 = src + (y1 * sw + x1) * channels;
        uint8_t* out = out_row + x * channels;
        for (int c = 0; c < channels; ++c) {
          float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
          out[c] = static_cast<uint8_t>(v + 0.5f);
        }
      }
    }
  }
  ratio_out[0] = r;
  ratio_out[1] = r;
  pad_out[0] = dw;
  pad_out[1] = dh;
}

// --------------------------------------------------------------------------
// HSV LUT augmentation on BGR uint8, in place. Gains are the sampled r
// values (already drawn by the caller): h_mul multiplies hue (mod 180),
// s_mul/v_mul scale saturation/value (clipped). cv2-equivalent math with
// OpenCV's 0..180 hue quantization.
// --------------------------------------------------------------------------
void hsv_augment_u8(uint8_t* img, int h, int w, float h_mul, float s_mul,
                    float v_mul) {
  uint8_t lut_h[256], lut_s[256], lut_v[256];
  for (int i = 0; i < 256; ++i) {
    lut_h[i] = static_cast<uint8_t>(
        static_cast<int>(std::lround(i * h_mul)) % 180);
    lut_s[i] = static_cast<uint8_t>(
        std::min(std::max(std::lround(i * s_mul), 0L), 255L));
    lut_v[i] = static_cast<uint8_t>(
        std::min(std::max(std::lround(i * v_mul), 0L), 255L));
  }
  const int n = h * w;
  for (int p = 0; p < n; ++p) {
    uint8_t* px = img + p * 3;
    float b = px[0], g = px[1], r = px[2];
    float mx = std::max({b, g, r}), mn = std::min({b, g, r});
    float diff = mx - mn;
    // BGR -> HSV (OpenCV 8-bit convention: H in 0..180)
    float hh = 0.0f;
    if (diff > 0) {
      if (mx == r) hh = 30.0f * (g - b) / diff;
      else if (mx == g) hh = 60.0f + 30.0f * (b - r) / diff;
      else hh = 120.0f + 30.0f * (r - g) / diff;
      if (hh < 0) hh += 180.0f;
    }
    float ss = mx > 0 ? 255.0f * diff / mx : 0.0f;
    uint8_t H = lut_h[static_cast<uint8_t>(std::lround(hh))];
    uint8_t S = lut_s[static_cast<uint8_t>(std::lround(ss))];
    uint8_t V = lut_v[static_cast<uint8_t>(std::lround(mx))];
    // HSV -> BGR
    float Hf = H * 2.0f;  // back to degrees 0..360
    float Sf = S / 255.0f, Vf = V / 255.0f;
    float C = Vf * Sf;
    float X = C * (1 - std::fabs(std::fmod(Hf / 60.0f, 2.0f) - 1));
    float m = Vf - C;
    float rf, gf, bf;
    if (Hf < 60)       { rf = C; gf = X; bf = 0; }
    else if (Hf < 120) { rf = X; gf = C; bf = 0; }
    else if (Hf < 180) { rf = 0; gf = C; bf = X; }
    else if (Hf < 240) { rf = 0; gf = X; bf = C; }
    else if (Hf < 300) { rf = X; gf = 0; bf = C; }
    else               { rf = C; gf = 0; bf = X; }
    px[0] = static_cast<uint8_t>(std::lround((bf + m) * 255.0f));
    px[1] = static_cast<uint8_t>(std::lround((gf + m) * 255.0f));
    px[2] = static_cast<uint8_t>(std::lround((rf + m) * 255.0f));
  }
}

// --------------------------------------------------------------------------
// Copy a source tile into a mosaic canvas region (bounds-checked blit).
// canvas (ch x cw x 3), src (sh x sw x 3).
// --------------------------------------------------------------------------
void blit_u8(uint8_t* canvas, int ch_, int cw, const uint8_t* src, int sh,
             int sw, int y1a, int x1a, int y2a, int x2a, int y1b, int x1b) {
  // Clamp BOTH rect origins (shifting the other side to keep alignment)
  // and bound the extent by all four buffers' edges, so no argument
  // combination can read or write out of bounds.
  if (y1a < 0) { y1b -= y1a; y1a = 0; }
  if (x1a < 0) { x1b -= x1a; x1a = 0; }
  if (y1b < 0) { y1a -= y1b; y1b = 0; }
  if (x1b < 0) { x1a -= x1b; x1b = 0; }
  const int rows = std::min(std::min(y2a, ch_) - y1a, sh - y1b);
  const int cols = std::min(std::min(x2a, cw) - x1a, sw - x1b);
  if (rows <= 0 || cols <= 0) return;
  for (int y = 0; y < rows; ++y) {
    const uint8_t* s = src + ((y1b + y) * static_cast<size_t>(sw) + x1b) * 3;
    uint8_t* d = canvas + ((y1a + y) * static_cast<size_t>(cw) + x1a) * 3;
    std::memcpy(d, s, static_cast<size_t>(cols) * 3);
  }
}

}  // extern "C"
