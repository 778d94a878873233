// Host-side image pipeline of the training data loader (C ABI, loaded with
// ctypes): the per-item CPU work of `personalized.py:426-511` (NEAREST
// resize, horizontal flip, scale-into-canvas, roll shift, normalize) as tight
// C++ loops, so that the prefetch thread's numpy overhead is off the input
// path; and one pass of Pillow's fixed-point resample, which the face
// parser's BILINEAR resizes run twice an item. Built with `decode.cpp` into
// one library at first use (`adaface_tpu_torch/native/__init__.py`).
//
// Two changes from the JAX package's copy. The shrunken mask lies past the
// mask lane: at buf1 + ns*ns*3 it ran into the lane it is resized from once
// ns > 0.866 S (scales in (0.866, 0.999), about a fifth of the default
// draws). And `normalize_to_pm1` divides by 127.5 as the numpy path does
// (`data.personalized.augment_numpy`), so the two give the same bits; a
// multiplication by the reciprocal differs in the last bit for 111 of the
// 256 values.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// NEAREST resize, HWC uint8. Matches PIL Image.NEAREST / torch 'nearest'
// convention: src = floor(dst * scale).
void resize_nearest_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {  // the identity: one copy
    std::memcpy(dst, src, (size_t)dh * dw * c);
    return;
  }
  for (int y = 0; y < dh; ++y) {
    const int sy = (int)((int64_t)y * sh / dh);
    const uint8_t* srow = src + (size_t)sy * sw * c;
    uint8_t* drow = dst + (size_t)y * dw * c;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* s = srow + (size_t)((int64_t)x * sw / dw) * c;
      uint8_t* d = drow + (size_t)x * c;
      for (int k = 0; k < c; ++k) d[k] = s[k];
    }
  }
}

// In-place horizontal flip, HWC uint8.
void hflip_u8(uint8_t* img, int h, int w, int c) {
  for (int y = 0; y < h; ++y) {
    uint8_t* row = img + (size_t)y * w * c;
    for (int x = 0; x < w / 2; ++x) {
      uint8_t* a = row + (size_t)x * c;
      uint8_t* b = row + (size_t)(w - 1 - x) * c;
      for (int k = 0; k < c; ++k) std::swap(a[k], b[k]);
    }
  }
}

// Circular roll by (dy, dx), HWC uint8, out-of-place.
void roll_u8(const uint8_t* src, uint8_t* dst, int h, int w, int c,
             int dy, int dx) {
  dy = ((dy % h) + h) % h;
  dx = ((dx % w) + w) % w;
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + (size_t)y * w * c;
    uint8_t* drow = dst + (size_t)((y + dy) % h) * w * c;
    const size_t tail = (size_t)(w - dx) * c;
    std::memcpy(drow + (size_t)dx * c, srow, tail);
    std::memcpy(drow, srow + tail, (size_t)dx * c);
  }
}

// Paste `src` (sh x sw) centered into a zeroed (dh x dw) canvas and write
// a {0,1} coverage mask (the scale-into-canvas augmentation).
void paste_center_u8(const uint8_t* src, int sh, int sw, int c,
                     uint8_t* dst, float* cover, int dh, int dw) {
  std::memset(dst, 0, (size_t)dh * dw * c);
  std::memset(cover, 0, (size_t)dh * dw * sizeof(float));
  const int oy = (dh - sh) / 2, ox = (dw - sw) / 2;
  for (int y = 0; y < sh; ++y) {
    std::memcpy(dst + ((size_t)(y + oy) * dw + ox) * c,
                src + (size_t)y * sw * c, (size_t)sw * c);
    float* crow = cover + (size_t)(y + oy) * dw + ox;
    for (int x = 0; x < sw; ++x) crow[x] = 1.0f;
  }
}

// uint8 HWC -> float32 HWC in [-1, 1].
void normalize_to_pm1(const uint8_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = (float)src[i] / 127.5f - 1.0f;
}

// Fused whole-item pipeline: resize -> optional flip -> optional
// scale-into-canvas -> roll -> normalize, emitting the image (f32 [-1,1]),
// the coverage (aug) mask and a nearest-resized fg mask in one pass chain.
// scale_num/scale_den encode the shrink ratio (e.g. 3/4); pass equal
// values for no scaling. Returns 0 on success.
int prepare_item(const uint8_t* src, int sh, int sw,
                 const uint8_t* fg_mask_src /* nullable, sh x sw */,
                 int out_size, int do_flip, int scale_num, int scale_den,
                 int dy, int dx,
                 float* out_img, float* out_fg, float* out_aug,
                 uint8_t* scratch /* >= 3 * out_size*out_size*3 bytes */) {
  const int S = out_size;
  uint8_t* buf0 = scratch;                       // resized image
  uint8_t* buf1 = scratch + (size_t)S * S * 3;   // canvas
  uint8_t* mbuf = scratch + (size_t)2 * S * S * 3;  // mask lane

  resize_nearest_u8(src, sh, sw, 3, buf0, S, S);
  if (do_flip) hflip_u8(buf0, S, S, 3);

  // fg mask lane follows the same geometry
  if (fg_mask_src) {
    resize_nearest_u8(fg_mask_src, sh, sw, 1, mbuf, S, S);
    if (do_flip) hflip_u8(mbuf, S, S, 1);
  } else {
    std::memset(mbuf, 255, (size_t)S * S);
  }

  float* cover = out_aug;  // reuse output buffer as staging
  if (scale_num < scale_den) {
    const int ns = std::max(8, S * scale_num / scale_den);
    uint8_t* small_img = buf1;                // ns*ns*3
    uint8_t* small_m = mbuf + (size_t)S * S;  // ns*ns, past the mask lane
    resize_nearest_u8(buf0, S, S, 3, small_img, ns, ns);
    resize_nearest_u8(mbuf, S, S, 1, small_m, ns, ns);
    paste_center_u8(small_img, ns, ns, 3, buf0, cover, S, S);
    std::memset(mbuf, 0, (size_t)S * S);
    const int oy = (S - ns) / 2, ox = (S - ns) / 2;
    for (int y = 0; y < ns; ++y)
      std::memcpy(mbuf + (size_t)(y + oy) * S + ox,
                  small_m + (size_t)y * ns, ns);
  } else {
    for (int64_t i = 0; i < (int64_t)S * S; ++i) cover[i] = 1.0f;
  }

  if (dy != 0 || dx != 0) {
    roll_u8(buf0, buf1, S, S, 3, dy, dx);
    std::swap(buf0, buf1);
    // roll the mask + coverage lanes
    uint8_t* m2 = buf1;  // reuse
    roll_u8(mbuf, m2, S, S, 1, dy, dx);
    std::memcpy(mbuf, m2, (size_t)S * S);
    // coverage as bytes via mask lane trick
    for (int64_t i = 0; i < (int64_t)S * S; ++i)
      m2[i] = (uint8_t)(cover[i] > 0.5f ? 1 : 0);
    uint8_t* m3 = m2 + (size_t)S * S;
    roll_u8(m2, m3, S, S, 1, dy, dx);
    for (int64_t i = 0; i < (int64_t)S * S; ++i) cover[i] = (float)m3[i];
  }

  normalize_to_pm1(buf0, out_img, (int64_t)S * S * 3);
  for (int64_t i = 0; i < (int64_t)S * S; ++i)
    out_fg[i] = mbuf[i] > 127 ? 1.0f : 0.0f;
  return 0;
}

// One pass of Pillow's `ImagingResample` on HWC uint8 (its 8-bit
// `ImagingResampleHorizontal_8bpc` / `Vertical_8bpc`): along the width
// (axis 1) or the height (axis 0), output index i reads taps first[i] + k,
// k < ksize, with fixed-point weights w[i * ksize + k] in 1/2^22, summed
// from 1/2 in int32 as Pillow sums them, shifted down and clamped to 0..255.
// The weights come from `utils.image._pil_coeffs` (any of Pillow's filters;
// negative lobes too); a tap past the source weighs 0 and is skipped.
void resample_pass_u8(const uint8_t* src, int h, int w, int c, int axis,
                      const int32_t* first, const int32_t* weights, int ksize,
                      int n_out, uint8_t* dst) {
  const int bits = 22;
  const int32_t half = 1 << (bits - 1);
  auto clip8 = [bits](int32_t v) { return (uint8_t)std::clamp(v >> bits, 0, 255); };
  if (axis == 1) {
    int32_t acc[4];
    for (int y = 0; y < h; ++y) {
      const uint8_t* srow = src + (size_t)y * w * c;
      uint8_t* drow = dst + (size_t)y * n_out * c;
      for (int x = 0; x < n_out; ++x) {
        const int32_t* k = weights + (size_t)x * ksize;
        const uint8_t* s = srow + (size_t)first[x] * c;
        const int taps = std::min(ksize, w - first[x]);
        for (int ch = 0; ch < c; ++ch) acc[ch] = half;
        for (int t = 0; t < taps; ++t)
          for (int ch = 0; ch < c; ++ch) acc[ch] += (int32_t)s[(size_t)t * c + ch] * k[t];
        for (int ch = 0; ch < c; ++ch) drow[(size_t)x * c + ch] = clip8(acc[ch]);
      }
    }
    return;
  }
  const size_t row = (size_t)w * c;
  int32_t* acc = new int32_t[row];
  for (int y = 0; y < n_out; ++y) {
    const int32_t* k = weights + (size_t)y * ksize;
    const int taps = std::min(ksize, h - first[y]);
    for (size_t i = 0; i < row; ++i) acc[i] = half;
    for (int t = 0; t < taps; ++t) {
      const uint8_t* srow = src + (size_t)(first[y] + t) * row;
      const int32_t wt = k[t];
      for (size_t i = 0; i < row; ++i) acc[i] += (int32_t)srow[i] * wt;
    }
    uint8_t* drow = dst + (size_t)y * row;
    for (size_t i = 0; i < row; ++i) drow[i] = clip8(acc[i]);
  }
  delete[] acc;
}

}  // extern "C"
