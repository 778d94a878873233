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

The training data path's PIL calls (`adaface_tpu/data/personalized.py`
and `train/face_parsing_train.py`: `Image.open(...).convert("RGB" or "L")`,
padding to a square, NEAREST and BILINEAR resizes, `Image.new` + `paste`)
are here too: `read_image` (PNG on stdlib `zlib`: every colour type and bit
depth, Adam7, all five row filters; JPEG, BMP, WebP and a GIF's first
frame through the port's host library; any other file raises with its
path),
`read_gif_frames` (a GIF's frames as Pillow composites them), `write_png`, `to_rgb` /
`to_grey` as PIL converts, `pad_to_square`, `resize_nearest_pil`, which
samples where PIL's NEAREST does, `resize_pil` (Pillow's fixed-point
resample with its BILINEAR, BICUBIC or LANCZOS filter) and `paste_pad`. `write_gif` writes an animated GIF (the video pipeline's
`to_gif`, which PIL writes in the JAX package) on a fixed palette.
"""

from __future__ import annotations

import math
import struct
import zlib

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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
GIF_SIGNATURES = (b"GIF87a", b"GIF89a")
# colour type → (samples a pixel, the bit depths the PNG specification allows)
PNG_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                    4: (2, (8, 16)), 6: (4, (8, 16))}
# the seven Adam7 passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _unfilter_row(ft: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One PNG scanline's bytes from its filtered bytes and the row above."""
    if ft == 0:
        return line.copy()
    if ft == 1:  # Sub: a running sum per channel, modulo 256
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ft == 2:  # Up
        return line + prev
    if ft not in (3, 4):
        raise ValueError(f"PNG row filter {ft}")
    cur, up = bytearray(line.tobytes()), prev.tobytes()
    n = len(cur)
    if ft == 3:  # Average
        for i in range(bpp):
            cur[i] = (cur[i] + (up[i] >> 1)) & 255
        for i in range(bpp, n):
            cur[i] = (cur[i] + ((cur[i - bpp] + up[i]) >> 1)) & 255
    else:  # Paeth
        for i in range(bpp):
            cur[i] = (cur[i] + up[i]) & 255
        for i in range(bpp, n):
            a, b, c = cur[i - bpp], up[i], up[i - bpp]
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path) -> np.ndarray:
    """A PNG file → uint8 [H, W] or [H, W, 3 or 4] (`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _png_samples(raw: bytes, off: int, width: int, height: int, depth: int,
                 samples: int) -> tuple[np.ndarray, int]:
    """One (sub)image's filtered scanlines at `raw[off:]` → its samples,
    uint16 [height, width, samples], and the offset past them."""
    stride = (width * samples * depth + 7) // 8
    if width == 0 or height == 0:
        return np.zeros((height, width, samples), np.uint16), off
    if len(raw) < off + height * (stride + 1):
        raise ValueError(f"PNG data of {len(raw)} bytes ends inside the pixels")
    rows, prev = np.empty((height, stride), np.uint8), np.zeros(stride, np.uint8)
    bpp = max(1, samples * depth // 8)  # the filters' byte distance
    for y in range(height):
        o = off + y * (stride + 1)
        prev = rows[y] = _unfilter_row(raw[o], np.frombuffer(raw, np.uint8, stride, o + 1),
                                       prev, bpp)
    n = width * samples
    if depth == 16:
        vals = rows.view(">u2")[:, :n]
    elif depth == 8:
        vals = rows[:, :n]
    else:  # 1, 2 or 4 bits a sample, the first in the byte's high bits
        bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(height, n, depth)
        vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            axis=2, dtype=np.uint8)
    return vals.astype(np.uint16).reshape(height, width, samples), off + height * (stride + 1)


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """A PNG file's bytes → uint8 [H, W] or [H, W, 3 or 4], the pixels
    Pillow's `convert("RGB")` / `convert("L")` give through `to_rgb` /
    `to_grey`, for every colour type and bit depth of the PNG
    specification, non-interlaced or Adam7: grey at 1, 2 or 4 bits scaled
    to 0..255 (×255, ×85, ×17, as Pillow's modes "1" and "L" hold them),
    16-bit grey clipped to 255 (Pillow's "I;16" converts so), 16-bit RGB,
    RGBA and grey + alpha by their high byte, grey + alpha as its grey
    (alpha dropped: both conversions ignore it), a palette image as its
    palette's RGB (an index past the palette is black, as in Pillow;
    `to_grey` of that RGB is Pillow's P → L). `tRNS` changes neither
    conversion and is ignored. Errors name `path`."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: PNG IHDR of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if colour not in PNG_COLOUR_TYPES or depth not in PNG_COLOUR_TYPES[colour][1] \
            or interlace > 1:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}, which the PNG specification does not define")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    if not 0 < width * height <= 1 << 28:
        raise ValueError(f"{path}: PNG of {width}x{height}")
    samples = PNG_COLOUR_TYPES[colour][0]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG data does not inflate ({e})") from e
    try:
        if not interlace:
            px, _ = _png_samples(raw, 0, width, height, depth, samples)
        else:
            passes = [(x0, y0, dx, dy, max(0, -(-(width - x0) // dx)),
                       max(0, -(-(height - y0) // dy))) for x0, y0, dx, dy in ADAM7]
            need = sum(ph * ((pw * samples * depth + 7) // 8 + 1) for *_, pw, ph in passes
                       if pw and ph)
            if len(raw) < need:
                raise ValueError(f"PNG data of {len(raw)} bytes ends inside the pixels")
            px, off = np.zeros((height, width, samples), np.uint16), 0
            for x0, y0, dx, dy, pw, ph in passes:
                sub, off = _png_samples(raw, off, pw, ph, depth, samples)
                px[y0::dy, x0::dx] = sub
    except ValueError as e:
        raise ValueError(f"{path}: {e} ({width}x{height}, colour type {colour}, "
                         f"{depth}-bit)") from None
    if colour == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:min(len(palette), 256)] = palette[:256]
        return table[px[..., 0]]
    if depth == 16:
        px = np.minimum(px, 255) if colour == 0 else px >> 8
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    px = px.astype(np.uint8)
    if colour in (0, 4):
        return px[..., 0]
    return px


def read_image(path) -> np.ndarray:
    """An image file → uint8 [H, W] (grey) or [H, W, 3 or 4], by its magic
    bytes (`decode_image_bytes`). `to_rgb` / `to_grey` then give Pillow's
    convert("RGB") / convert("L")."""
    with open(path, "rb") as f:
        return decode_image_bytes(f.read(), path)


def read_gif_frames(path) -> np.ndarray:
    """A GIF file → its frames, uint8 [F, H, W, 3] RGB, each composited onto
    the logical screen as Pillow's `seek(i)` then `convert("RGB")` gives it
    (the port's host library, `adaface_tpu_torch.native.decode_gif`).
    Another file, or a GIF the decoder does not take, raises a ValueError
    naming `path`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in GIF_SIGNATURES:
        raise ValueError(f"{path}: magic bytes {data[:6]!r}; not a GIF file")
    from adaface_tpu_torch.native import decode_gif

    return decode_gif(data, path)


def decode_image_bytes(data: bytes, path="<bytes>") -> np.ndarray:
    """An image file's bytes → uint8 [H, W] (grey) or [H, W, 3 or 4], by
    its magic bytes: PNG (`decode_png`), JPEG or BMP (the port's host
    library, `adaface_tpu_torch.native.decode_image`), GIF (its first frame,
    RGB, as Pillow's convert("RGB") gives it), WebP (the host library's
    `decode_webp`: RGB, or RGBA where the file has alpha). Where Pillow's
    mode cannot be told from the shape, the array holds what `convert`
    gives: a CMYK or YCCK JPEG, a palette PNG or BMP are RGB, a 16-bit grey
    PNG is clipped to 255 (Pillow's "I;16" converts so). Another format, or
    a variant the decoders do not take (arithmetic-coded, 12-bit, lossless
    or hierarchical JPEGs among them), raises a ValueError naming `path`."""
    head = data[:12]
    if head[:8] == PNG_SIGNATURE:
        return decode_png(data, path)
    if head[:2] in (b"\xff\xd8", b"BM"):
        from adaface_tpu_torch.native import decode_image

        return decode_image(data, path)
    if head[:6] in GIF_SIGNATURES:
        from adaface_tpu_torch.native import decode_gif

        return decode_gif(data, path, max_frames=1)[0]
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        from adaface_tpu_torch.native import decode_webp

        return decode_webp(data, path)
    raise ValueError(f"{path}: magic bytes {head[:4]!r}; the port reads PNG, JPEG, BMP, GIF "
                     "and WebP")


def write_png(path, img: np.ndarray) -> None:
    """`encode_png(img)` written to the file `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) → an 8-bit
    PNG's bytes, every row unfiltered."""
    img = np.ascontiguousarray(img, np.uint8)
    bpp = 1 if img.ndim == 2 else img.shape[2]
    colour = {1: 0, 3: 2, 4: 6}[bpp]
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * bpp)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB"): grey replicated, alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


def to_grey(img: np.ndarray) -> np.ndarray:
    """PIL's convert("L"): (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.int64)
    y = 19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
    return ((y + (1 << 15)) >> 16).astype(np.uint8)


def pad_to_square(img: np.ndarray) -> np.ndarray:
    """Pad the shorter side with zeros on both sides, the image centred
    (`pad_image_obj_to_square`)."""
    h, w = img.shape[:2]
    if h == w:
        return img
    s = max(h, w)
    out = np.zeros((s, s) + img.shape[2:], img.dtype)
    y0, x0 = (s - h) // 2, (s - w) // 2
    out[y0:y0 + h, x0:x0 + w] = img
    return out


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index: the centre x + 0.5 scaled by in/out, as
    its fast scaling path accumulates it (one float64 addition a pixel),
    truncated."""
    step = n_in / n_out
    centres = np.cumsum(np.concatenate([[step * 0.5], np.full(n_out - 1, step)]))
    return np.minimum(centres.astype(np.int64), n_in - 1)


def resize_nearest_pil(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`Image.resize((w, h), Image.NEAREST)` on [H, W(, C)]; size is (w, h)."""
    w, h = size
    return img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)]


PIL_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point bits of a resample weight


def _pil_triangle(x: np.ndarray) -> np.ndarray:
    """Pillow's `bilinear_filter`."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's `bicubic_filter` (a = −0.5), in its order of operations."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x  # libm's sin, as Pillow's C calls it


def _pil_lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's `lanczos_filter`: sinc(x)·sinc(x/3) on [−3, 3)."""
    return np.asarray([_pil_sinc(v) * _pil_sinc(v / 3) if -3.0 <= v < 3.0 else 0.0
                       for v in x.ravel().tolist()], np.float64).reshape(x.shape)


# Pillow's resample filters (`Resample.c`): the filter and its support
PIL_FILTERS = {"bilinear": (_pil_triangle, 1.0), "bicubic": (_pil_bicubic, 2.0),
               "lanczos": (_pil_lanczos, 3.0)}


def _pil_coeffs(n_in: int, n_out: int, resample: str) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's `precompute_coeffs` with filter `resample` along one axis →
    (first source index [n_out], int64 weights [n_out, K] in 1/2^22, zero
    past each window). The support widens by the reduction factor when
    shrinking; each window's float64 weights are normalised to sum 1, then
    rounded half away from zero to fixed point (`normalize_coeffs_8bpc`)."""
    if resample not in PIL_FILTERS:
        raise ValueError(f"resample {resample!r}: the port has Pillow's {sorted(PIL_FILTERS)}")
    fn, support = PIL_FILTERS[resample]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    centre = (np.arange(n_out) + 0.5) * scale
    # C's (int) truncates toward zero, then the bounds are clamped
    xmin = np.maximum(np.trunc(centre - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(centre + support + 0.5), n_in).astype(np.int64) - xmin
    taps = np.arange(ksize)
    inside = taps[None, :] < xmax[:, None]
    x = ((taps[None, :] + xmin[:, None]) - centre[:, None] + 0.5) * (1.0 / filterscale)
    w = np.zeros((n_out, ksize))
    w[inside] = fn(x[inside])
    ww = np.zeros(n_out)
    for k in range(ksize):  # summed in tap order, as the C loop does
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * float(1 << PIL_PRECISION_BITS)
    return xmin, np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)


def _pil_pass(img: np.ndarray, first: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """One uint8 resample pass along `axis`: Σ_k src[first + k]·w_k from
    1/2 in fixed point, shifted down, clamped to 0..255."""
    n = img.shape[axis]
    shape = [1] * img.ndim
    shape[axis] = -1
    acc = np.full(1, 1 << (PIL_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for k in range(w.shape[1]):
        idx = np.minimum(first + k, n - 1)  # taps past the window weigh 0
        acc = acc + np.take(src, idx, axis=axis) * w[:, k].reshape(shape)
    return np.clip(acc >> PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_pil(img: np.ndarray, size: tuple[int, int], resample: str = "bilinear") -> np.ndarray:
    """`Image.resize((w, h), Image.BILINEAR | BICUBIC | LANCZOS)` on uint8
    [H, W] or [H, W, 3] (Pillow's `ImagingResample`; `resample` names the
    filter, `PIL_FILTERS`): a horizontal pass rounded to uint8, then a
    vertical one; an axis of unchanged size is not resampled. Not OpenCV's
    bilinear or bicubic (`resize_linear`, `resize_cubic`): Pillow's filters
    widen with the reduction factor, and its bicubic has a = −0.5."""
    out_w, out_h = size
    h, w = img.shape[:2]
    if out_w != w:
        img = _pil_pass(img, *_pil_coeffs(w, out_w, resample), axis=1)
    if out_h != h:
        img = _pil_pass(img, *_pil_coeffs(h, out_h, resample), axis=0)
    return img.copy() if (out_w, out_h) == (w, h) else img


def paste_pad(img: np.ndarray, size: tuple[int, int], fill: int = 0) -> np.ndarray:
    """`Image.new(mode, (w, h), fill)` with `img` pasted at (0, 0): the
    image padded right and below to `size` (w, h) with `fill`."""
    w, h = size
    out = np.full((h, w) + img.shape[2:], fill, np.uint8)
    out[:img.shape[0], :img.shape[1]] = img
    return out


# the GIF palette: a 6 x 7 x 6 cube of R, G, B levels (252 colours, 4 unused)
GIF_LEVELS = (6, 7, 6)
GIF_LITERALS = 254  # codes between clear codes: the LZW code width stays 9 bits


def gif_palette() -> np.ndarray:
    """[256, 3] uint8: entry (r · 7 + g) · 6 + b holds the levels' values."""
    axes = [np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8) for n in GIF_LEVELS]
    cube = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return np.concatenate([cube, np.zeros((256 - len(cube), 3), np.uint8)])


def _gif_indices(frame: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] → the palette index of each pixel's nearest levels."""
    levels = np.array(GIF_LEVELS)
    q = np.rint(frame.astype(np.float32) * ((levels - 1) / 255.0)).astype(np.int64)
    return ((q[..., 0] * levels[1] + q[..., 1]) * levels[2] + q[..., 2]).astype(np.uint16)


def _gif_lzw(indices: np.ndarray) -> bytes:
    """Uncompressed 9-bit LZW of the pixel indices: a clear code before every
    GIF_LITERALS literals, so that the decoder's table never reaches 512
    codes, then end-of-information; packed LSB first into sub-blocks of at
    most 255 bytes."""
    clear, end = 256, 257
    flat = indices.ravel()
    chunks = -(-flat.size // GIF_LITERALS)
    padded = np.full(chunks * GIF_LITERALS, -1, np.int64)
    padded[:flat.size] = flat
    codes = np.concatenate([np.full((chunks, 1), clear), padded.reshape(chunks, GIF_LITERALS)],
                           axis=1).ravel()
    codes = np.append(codes[codes >= 0], end)
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    data = np.packbits(bits.ravel(), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def write_gif(path, frames: np.ndarray, fps: int = 8) -> None:
    """uint8 [F, H, W, 3] → an animated GIF89a that loops forever, each frame
    shown int(1000 / fps) ms (to the GIF's 10 ms), its pixels on the nearest
    colour of `gif_palette()`."""
    frames = np.asarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    delay = int(1000 / fps) // 10
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for frame in frames:
        out.append(b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_gif_lzw(_gif_indices(frame)))
    out.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(out))
