"""The uint8 image operations of the face path, in numpy.

The JAX package's host code calls OpenCV: `cv2.resize(INTER_CUBIC)` to
224² before CLIP (`face_id_to_ada_prompt.py:54-64`), and
`cvtColor(RGB2GRAY)` with `cv2.resize` (bilinear) to 128² before ArcFace
(`face_backends.py:88-89`). The port depends on neither OpenCV nor PIL, so
these follow OpenCV's (5.0) arithmetic on uint8:
- grey: (9798·R + 19235·G + 3735·B + 2^14) >> 15;
- resize: half-pixel centres, source index clamped at the borders, no
  antialias, saturated to 0..255. Bicubic (a = −0.75): float32 tap weights
  from float64 fractions, a float32 horizontal then vertical pass, rounded
  to nearest. Bilinear: tap weights rounded to 1/2048, an exact integer
  horizontal pass, then OpenCV's vector form of the vertical pass,
  `((row0 >> 4)·w0 >> 16) + ((row1 >> 4)·w1 >> 16)` rounded by 2 bits; a
  2× reduction is the mean of 2×2 blocks, as OpenCV switches to area
  averaging there.
"""

from __future__ import annotations

import numpy as np

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB → [H, W] uint8."""
    rgb = img.astype(np.int32)
    y = 9798 * rgb[..., 0] + 19235 * rgb[..., 1] + 3735 * rgb[..., 2]
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


def _cubic_coeffs(f: np.ndarray) -> np.ndarray:
    """[N] float64 fractions → [N, 4] tap weights (OpenCV's
    `interpolateCubic`), computed in float64 and rounded to float32."""
    a = -0.75
    x1, g = f + 1.0, 1.0 - f
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * f - (a + 3)) * f * f + 1
    c2 = ((a + 2) * g - (a + 3)) * g * g + 1
    return np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], axis=-1).astype(np.float32)


def _taps(n_in: int, n_out: int, cubic: bool) -> tuple[np.ndarray, np.ndarray]:
    """(source indices [n_out, K] clamped to the input, weights [n_out, K]) of
    one axis: K = 4 float32 weights (bicubic) or 2 weights in 1/2048
    (bilinear)."""
    f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    if cubic:
        s = np.floor(f).astype(np.int64)
        return np.clip(s[:, None] + np.arange(-1, 3), 0, n_in - 1), _cubic_coeffs(f - s)
    f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    w = np.stack([np.float32(1.0) - f, f], axis=-1)
    idx = np.clip(s[:, None] + np.arange(2), 0, n_in - 1)
    return idx, np.rint(w * np.float32(COEF_SCALE)).astype(np.int64)


def _weighted(src: np.ndarray, idx: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """Σ_k src[idx[:, k]] · w[:, k] along `axis`, summed in tap order."""
    shape = [1] * src.ndim
    shape[axis] = -1
    acc = None
    for k in range(idx.shape[1]):
        term = np.take(src, idx[:, k], axis=axis) * w[:, k].reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def _resize(img: np.ndarray, size: tuple[int, int], cubic: bool) -> np.ndarray:
    """[H, W] or [H, W, C] uint8 → (W', H') = `size`, uint8."""
    out_w, out_h = size
    h, w = img.shape[:2]
    if cubic:  # float32 passes, then rounded to nearest
        xi, xw = _taps(w, out_w, True)
        yi, yw = _taps(h, out_h, True)
        rows = _weighted(img.astype(np.float32), xi, xw, axis=1)
        val = np.rint(_weighted(rows, yi, yw, axis=0))
        return np.clip(val, 0, 255).astype(np.uint8)
    if h == 2 * out_h and w == 2 * out_w:
        s = img.astype(np.int64)
        s = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    xi, xw = _taps(w, out_w, False)
    yi, yw = _taps(h, out_h, False)
    rows = _weighted(img.astype(np.int64), xi, xw, axis=1)  # exact, in 1/2048
    parts = [((np.take(rows, yi[:, k], axis=0) >> 4)
              * yw[:, k].reshape((-1,) + (1,) * (img.ndim - 1))) >> 16 for k in (0, 1)]
    return np.clip((parts[0] + parts[1] + 2) >> 2, 0, 255).astype(np.uint8)


def resize_cubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=INTER_CUBIC) on uint8; size is
    (width, height)."""
    return _resize(img, size, cubic=True)


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size) (INTER_LINEAR) on uint8; size is (width, height)."""
    return _resize(img, size, cubic=False)
