"""Virtual-makeup recolor over BiSeNet face-parsing maps.

A numpy copy of `adaface_tpu/utils/makeup.py` (the reference's
`face_parsing/makeup.py:26-48`): a parsed region's hue (hair) or hue and
saturation (lips) replaced by a target colour's, recoloured hair
unsharp-sharpened (`makeup.py:7-23`); vectorized RGB↔HSV and a separable
gaussian, no cv2 or skimage. A host tool for demos and data preparation.

Colours are RGB triples. Part ids follow the 19-class CelebAMask-HQ
convention of `models/bisenet.py`: 1 face, 10 nose, 11 teeth, 12 upper
lip, 13 lower lip, 17 hair. Pixels outside the recoloured part keep the
input's values.
"""

from __future__ import annotations

import numpy as np

MAKEUP_PARTS = {"hair": 17, "upper_lip": 12, "lower_lip": 13}


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """[...,3] float in [0,1] → HSV with H,S,V in [0,1]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    spread = maxc - minc
    s = np.where(maxc > 0, spread / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(spread, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(spread > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian over H and W of [..., H, W, C] float arrays with
    edge-replicate padding (matches skimage's default 'nearest' mode)."""
    radius = max(int(round(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()

    def conv_axis(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (radius, radius)
        ap = np.pad(a, pad, mode="edge")
        out = np.zeros_like(a, dtype=np.float64)
        for j, w in enumerate(k):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(j, j + a.shape[axis])
            out += w * ap[tuple(sl)]
        return out

    return conv_axis(conv_axis(img.astype(np.float64), 0), 1)


def sharpen(img: np.ndarray, sigma: float = 5.0,
            alpha: float = 1.5) -> np.ndarray:
    """Unsharp mask (`makeup.py:7-23`): (img − gauss)·α + img, clipped."""
    img = img.astype(np.float64)
    out = (img - _gaussian_blur(img, sigma)) * alpha + img
    return np.clip(out / 255.0, 0.0, 1.0) * 255.0


def recolor_part(
    image: np.ndarray,  # [H,W,3] uint8 RGB
    parsing: np.ndarray,  # [H,W] int part labels
    part: int,
    color: tuple[int, int, int],
) -> np.ndarray:
    """Replace the region's hue (hue+saturation for lips 12/13) with the
    target color's; recolored hair (17) is sharpened (`makeup.py:26-48`)."""
    img_hsv = rgb_to_hsv(image.astype(np.float64) / 255.0)
    tar_hsv = rgb_to_hsv(np.asarray(color, np.float64)[None, None] / 255.0)
    if part in (12, 13):
        img_hsv[..., 0:2] = tar_hsv[..., 0:2]
    else:
        img_hsv[..., 0:1] = tar_hsv[..., 0:1]
    changed = hsv_to_rgb(img_hsv) * 255.0
    if part == 17:
        changed = sharpen(changed)
    changed = changed.astype(np.uint8)
    keep = parsing != part
    changed[keep] = image[keep]
    return changed


def apply_makeup(
    image: np.ndarray,
    parsing: np.ndarray,
    spec: dict[str | int, tuple[int, int, int]],
) -> np.ndarray:
    """Apply a {part-name-or-id: RGB color} makeup spec sequentially
    (`makeup.py:99-103`)."""
    out = image.copy()
    for part, color in spec.items():
        pid = MAKEUP_PARTS[part] if isinstance(part, str) else int(part)
        out = recolor_part(out, parsing, pid, color)
    return out
