"""Make the image fixtures of `tests/data/images/` with Pillow, and record
the SHA-256 of Pillow's decoded pixels beside them (`digests.json`).

    python tests/make_image_fixtures.py

The port decodes these files without Pillow: `tests/test_torch_image_io.py`
holds its decoder to the digests and to Pillow, and `chip_smoke.py` holds it
to the digests on a machine that has no Pillow. Where Pillow does not write
a variant, the script's own writers do: `encode_jpeg` (a baseline encoder
in numpy, with the Huffman and quantization tables of a Pillow file) for
4:4:0, 4:1:1 and 1x4 chroma, SOF1 frames and RGB, CMYK and YCCK colour;
`encode_png` for Adam7, 16-bit RGB, RGBA and grey + alpha and `tRNS`;
`encode_bmp` for RLE8, RLE4, bit fields and 4- and 16-bit pixels;
`webp_container` for an animation whose first frame is offset (its frames
encoded by Pillow); and `libwebp_encode`, libwebp's advanced encoder
through the library Pillow ships, for token partitions, the simple loop
filter, sharpness and filter level 0, which Pillow's `save` does not set.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "images")

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _segments(data: bytes):
    """(marker, body) of each header segment up to the first scan."""
    pos = 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            return
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        yield marker, data[pos + 4:pos + 2 + length]
        pos += 2 + length


def pil_tables(quality: int):
    """The quantization tables (natural order) and the Huffman tables
    ({(class, id): (counts, symbols)}) Pillow writes at `quality`."""
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (16, 16)).save(buf, format="JPEG", quality=quality, subsampling=0)
    qt, huff = {}, {}
    for marker, body in _segments(buf.getvalue()):
        i = 0
        while marker == 0xDB and i < len(body):
            tid = body[i] & 15
            q = np.zeros(64, np.int64)
            q[ZIGZAG] = np.frombuffer(body[i + 1:i + 65], np.uint8)
            qt[tid] = q.reshape(8, 8)
            i += 65
        while marker == 0xC4 and i < len(body):
            tc = body[i]
            counts = list(body[i + 1:i + 17])
            n = sum(counts)
            huff[(tc >> 4, tc & 15)] = (counts, list(body[i + 17:i + 17 + n]))
            i += 17 + n
    return qt, huff


def _codes(counts, symbols) -> dict:
    """Canonical Huffman codes: symbol → (code, length)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _dct_matrix() -> np.ndarray:
    c = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                   for x in range(8)] for u in range(8)])
    return c


def _ycc(img: np.ndarray) -> list:
    r, g, b = (img[..., i].astype(np.float64) for i in range(3))
    return [0.299 * r + 0.587 * g + 0.114 * b, -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


def encode_jpeg(img: np.ndarray, sampling=((1, 1), (1, 1), (1, 1)), quality: int = 75,
                sof: int = 0xC0, restart: int = 0, colour: str = "ycc", adobe: int | None = None,
                ids: bytes | None = None) -> bytes:
    """A baseline (or SOF1) Huffman JPEG of uint8 [H, W], [H, W, 3] or
    [H, W, 4] with each component's sampling factors in `sampling`, the
    tables Pillow uses at `quality`, and a restart marker every `restart`
    MCUs. `colour` "ycc" converts RGB to YCbCr in a JFIF file; "rgb" and
    "cmyk" write the samples as they are, "ycck" converts the first three
    to YCbCr and keeps the fourth, in a file without a JFIF segment, with an
    Adobe segment of transform `adobe` where it is not None; `ids` names the
    components (1, 2, ... by default)."""
    qt, huff = pil_tables(quality)
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes, factors = [img.astype(np.float64)], [(1, 1)]
    else:
        planes = (_ycc(img) if colour in ("ycc", "ycck") else
                  [img[..., i].astype(np.float64) for i in range(3)])
        if img.shape[2] == 4:
            planes.append(img[..., 3].astype(np.float64))
        factors = list(sampling)[:len(planes)]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    dct = _dct_matrix()
    comps = []
    for ci, (plane, (fh, fv)) in enumerate(zip(planes, factors)):
        sh, sv = hmax // fh, vmax // fv
        # box downsampling of edge-padded planes, then padding to whole MCUs
        ph, pw = -(-h // sv) * sv, -(-w // sh) * sh
        p = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
        p = p.reshape(ph // sv, sv, pw // sh, sh).mean(axis=(1, 3))
        p = np.pad(p, ((0, mcuy * fv * 8 - p.shape[0]), (0, mcux * fh * 8 - p.shape[1])),
                   mode="edge")
        q = qt[min(ci, 1)]
        blocks = p.reshape(mcuy * fv, 8, mcux * fh, 8).transpose(0, 2, 1, 3) - 128.0
        coef = np.rint(np.einsum("ux,abxy,vy->abuv", dct, blocks, dct) / q).astype(np.int64)
        comps.append((fh, fv, coef.reshape(*coef.shape[:2], 64)[..., ZIGZAG], min(ci, 1)))

    codes = {k: _codes(*v) for k, v in huff.items()}
    bits, preds = _Bits(), [0] * len(comps)

    def put_block(zz, ci, table):
        diff = int(zz[0]) - preds[ci]
        preds[ci] = int(zz[0])
        size = int(abs(diff)).bit_length()
        bits.put(*codes[(0, table)][size])
        bits.put(diff if diff >= 0 else diff + (1 << size) - 1, size)
        run = 0
        last = max([k for k in range(1, 64) if zz[k]] or [0])
        for k in range(1, last + 1):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*codes[(1, table)][0xF0])
                run -= 16
            size = abs(v).bit_length()
            bits.put(*codes[(1, table)][(run << 4) | size])
            bits.put(v if v >= 0 else v + (1 << size) - 1, size)
            run = 0
        if last < 63:
            bits.put(*codes[(1, table)][0x00])

    units = ([(by, bx) for by in range(-(-h // 8)) for bx in range(-(-w // 8))]
             if len(comps) == 1 else [(my, mx) for my in range(mcuy) for mx in range(mcux)])
    for n, (uy, ux) in enumerate(units):
        if restart and n and n % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            preds = [0] * len(comps)
        if len(comps) == 1:
            put_block(comps[0][2][uy, ux], 0, 0)
            continue
        for ci, (fh, fv, coef, table) in enumerate(comps):
            for y in range(fv):
                for x in range(fh):
                    put_block(coef[uy * fv + y, ux * fh + x], ci, table)
    bits.flush()

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    ids = ids or bytes(range(1, len(comps) + 1))
    out = b"\xff\xd8"
    if colour == "ycc":
        out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    for tid in sorted({c[3] for c in comps}):
        out += seg(0xDB, bytes([tid]) + bytes(qt[tid].reshape(-1)[ZIGZAG].astype(np.uint8)))
    frame = struct.pack(">BHHB", 8, h, w, len(comps))
    for ci, (fh, fv, _, table) in enumerate(comps):
        frame += bytes([ids[ci], (fh << 4) | fv, table])
    out += seg(sof, frame)
    for (cls, tid), (counts, symbols) in sorted(huff.items()):
        if tid in {c[3] for c in comps}:
            out += seg(0xC4, bytes([(cls << 4) | tid] + counts + symbols))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    scan = bytes([len(comps)]) + b"".join(bytes([ids[ci], (c[3] << 4) | c[3]])
                                         for ci, c in enumerate(comps)) + bytes([0, 63, 0])
    return out + seg(0xDA, scan) + bytes(bits.out) + b"\xff\xd9"


def smooth_image(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """A smooth uint8 image: a few random low-frequency waves per channel."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    out = np.zeros((h, w, channels))
    for c in range(channels):
        for _ in range(4):
            fy, fx, ph = rs.uniform(0.5, 4) / h, rs.uniform(0.5, 4) / w, rs.uniform(0, 6.3)
            out[..., c] += rs.uniform(20, 45) * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
    out = np.clip(out + 128, 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def face_label(h: int, w: int, seed: int) -> np.ndarray:
    """A synthetic face-parsing label map: background 0, ellipses of a few
    of the 19 classes."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    lbl = np.zeros((h, w), np.uint8)
    for cls, (cy, cx, ry, rx) in ((1, (0.5, 0.5, 0.38, 0.3)), (2, (0.42, 0.38, 0.04, 0.07)),
                                  (3, (0.42, 0.62, 0.04, 0.07)), (10, (0.55, 0.5, 0.08, 0.05)),
                                  (11, (0.7, 0.5, 0.04, 0.1)), (17, (0.2, 0.5, 0.12, 0.32))):
        cy, cx = (cy + rs.uniform(-0.03, 0.03)) * h, (cx + rs.uniform(-0.03, 0.03)) * w
        lbl[((yy - cy) / (ry * h)) ** 2 + ((xx - cx) / (rx * w)) ** 2 < 1] = cls
    return lbl


def bmp_top_down(img: np.ndarray) -> bytes:
    """An uncompressed 24-bit BMP with a negative height (rows top first),
    which Pillow does not write."""
    h, w, _ = img.shape
    row = -(-w * 3 // 4) * 4
    px = np.zeros((h, row), np.uint8)
    px[:, :w * 3] = img[..., ::-1].reshape(h, w * 3)
    header = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, px.size, 2835, 2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 14 + 40 + px.size, 0, 0, 54) + header
            + px.tobytes())


def pil_pixels(path: str) -> np.ndarray:
    """Pillow's pixels as the data path reads them: grey where Pillow opens
    the file as "L", else converted to RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L" if im.mode == "L" else "RGB"))

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png_filtered(rows: np.ndarray, bpp: int, seed: int) -> bytes:
    """Packed scanlines [h, stride] → each row behind a filter byte, the
    five filters drawn in turn from `seed`."""
    rs = np.random.RandomState(seed)
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        ft = int(rs.randint(5))
        left = np.concatenate([np.zeros(bpp, np.int64), row])[:row.size]
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev])[:row.size]
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            pa, pb, pc = (np.abs(prev - up_left), np.abs(left - up_left),
                          np.abs(left + prev - 2 * up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(bytes([ft]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def encode_png(samples: np.ndarray, colour: int, depth: int, interlace: int = 0,
               plte: bytes | None = None, trns: bytes | None = None, seed: int = 0) -> bytes:
    """A PNG of samples [H, W, C] (integers below 2^depth) of colour type
    `colour` at bit depth `depth`, non-interlaced or Adam7, its rows behind
    filters drawn from `seed`, with `PLTE` and `tRNS` bodies where given."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)

    def scanlines(px: np.ndarray) -> bytes:
        if px.shape[0] == 0 or px.shape[1] == 0:
            return b""
        vals = px.reshape(px.shape[0], -1).astype(np.int64)
        if depth == 16:
            packed = vals.astype(">u2").view(np.uint8).reshape(vals.shape[0], -1)
        elif depth == 8:
            packed = vals.astype(np.uint8)
        else:
            bits = (vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            packed = np.packbits(bits.reshape(vals.shape[0], -1).astype(np.uint8), axis=1)
        return _png_filtered(packed, bpp, seed + px.shape[0] * 131 + px.shape[1])

    raw = (scanlines(samples) if not interlace else
           b"".join(scanlines(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7))
    out = PNG_SIGNATURE + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                                         interlace))
    if plte is not None:
        out += _png_chunk(b"PLTE", plte)
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    return out + _png_chunk(b"IDAT", zlib.compress(raw, 9)) + _png_chunk(b"IEND", b"")


def encode_bmp(img: np.ndarray, bits: int, palette: np.ndarray | None = None,
               compression: int = 0, masks: tuple | None = None, header: int = 40) -> bytes:
    """A bottom-up BMP of `img`: palette indices [H, W] at 1, 4 or 8 bits
    (uncompressed, or RLE8 / RLE4 with `compression` 1 / 2) with `palette`
    [N, 3] RGB; or 16-bit pixel values [H, W] (5-5-5, or BI_BITFIELDS with
    `masks`); or 32-bit values [H, W] with `masks`."""
    h, w = img.shape[:2]
    if compression in (1, 2):
        px = _bmp_rle(img, compression == 2)
    else:
        stride = -(-w * bits // 32) * 4
        if bits <= 8:
            b = (img[..., None].astype(np.int64) >> np.arange(bits - 1, -1, -1)) & 1
            rows = np.packbits(b.reshape(h, -1).astype(np.uint8), axis=1)
        else:
            rows = img.astype("<u2" if bits == 16 else "<u4").view(np.uint8).reshape(h, -1)
        px = np.zeros((h, stride), np.uint8)
        px[:, :rows.shape[1]] = rows
        px = px[::-1].tobytes()
    extra = b""
    if masks is not None:
        extra = struct.pack("<%dI" % len(masks), *masks)
    info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bits, compression, len(px), 2835, 2835,
                       0 if palette is None else len(palette), 0)
    if header > 40:  # the masks inside the header
        info = (info + extra).ljust(header, b"\x00")
        extra = b""
    pal = b"" if palette is None else np.concatenate(
        [palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)], axis=1).astype(np.uint8).tobytes()
    off = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(px), 0, 0, off) + info + extra + pal + px


def _bmp_rle(idx: np.ndarray, rle4: bool) -> bytes:
    """RLE8 / RLE4 rows, bottom row first: runs of three or more equal
    pixels encoded (a run of one colour in both nibbles for RLE4), others in
    absolute runs of an even length of at least 4 (RLE4's odd absolute runs
    lose a pixel in Pillow) or short encoded runs; each row ends with an
    end-of-line, the image with end-of-bitmap."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 4:
                out += bytes([run, row[x] * 17 if rle4 else row[x]])
                x += run
                continue
            lit = 4
            while x + lit + 2 <= w and lit + 2 <= 254 and not (
                    row[x + lit] == row[x + lit + 1]):
                lit += 2
            seg = row[x:x + lit]
            body = bytes((seg[i] << 4) | seg[i + 1] for i in range(0, lit, 2)) if rle4 \
                else bytes(seg)
            out += bytes([0, lit]) + body
            if len(body) % 2:
                out += b"\x00"
            x += lit
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _riff_chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\x00" if len(body) & 1 else b"")


def _le24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def webp_image_chunks(data: bytes) -> bytes:
    """A still WebP's image chunks (ALPH, VP8, VP8L), without its header and
    VP8X chunk."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            out.append(_riff_chunk(tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return b"".join(out)


def webp_container(frames, canvas: tuple[int, int], alpha: bool) -> bytes:
    """An animated WebP of `canvas` (w, h): frames (x, y, w, h, still WebP
    bytes, flags) at even offsets, each frame's image chunks in an ANMF."""
    w, h = canvas
    body = _riff_chunk(b"VP8X", bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0])
                       + _le24(w - 1) + _le24(h - 1))
    body += _riff_chunk(b"ANIM", struct.pack("<IH", 0xFF204060, 0))
    for x, y, fw, fh, data, flags in frames:
        body += _riff_chunk(b"ANMF", _le24(x // 2) + _le24(y // 2) + _le24(fw - 1)
                            + _le24(fh - 1) + _le24(80) + bytes([flags])
                            + webp_image_chunks(data))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


class _WebPConfig(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int)
                for n in ("lossless", "quality", "method", "image_hint", "target_size",
                          "target_PSNR", "segments", "sns_strength", "filter_strength",
                          "filter_sharpness", "filter_type", "autofilter",
                          "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
                          "show_compressed", "preprocessing", "partitions", "partition_limit",
                          "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless",
                          "exact", "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")]


_P, _U32 = ctypes.c_void_p, ctypes.c_uint32


class _WebPPicture(ctypes.Structure):
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int), ("y", _P), ("u", _P),
                ("v", _P), ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int), ("a", _P),
                ("a_stride", ctypes.c_int), ("pad1", _U32 * 2), ("argb", _P),
                ("argb_stride", ctypes.c_int), ("pad2", _U32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", ctypes.c_int), ("extra_info", _P),
                ("stats", _P), ("error_code", ctypes.c_int), ("progress_hook", _P),
                ("user_data", _P), ("pad3", _U32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", _U32 * 8), ("memory_", _P), ("memory_argb_", _P), ("pad7", _P * 2)]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", _U32)]


def libwebp_encode(img: np.ndarray, **config) -> bytes:
    """uint8 [H, W, 3 or 4] → a WebP from libwebp's advanced encoder (the
    library Pillow ships, loaded with ctypes), `config` setting fields of
    its WebPConfig (encoder ABI 0x020f) over the defaults at quality 75."""
    import PIL
    from PIL import _webp  # noqa: F401  (loads the library's own dependencies)

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                  "pillow.libs", "libwebp-*.so*"))
    lib = ctypes.CDLL(libs[0])
    cfg = _WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(config.pop("quality", 75.0)), 0x020F):
        raise RuntimeError("WebPConfigInit failed")
    for k, v in config.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses {config}")
    pic = _WebPPicture()
    lib.WebPPictureInitInternal(ctypes.byref(pic), 0x020F)
    img = np.ascontiguousarray(img, np.uint8)
    pic.height, pic.width = img.shape[:2]
    pic.use_argb = int(cfg.lossless)
    imp = lib.WebPPictureImportRGBA if img.shape[2] == 4 else lib.WebPPictureImportRGB
    if not imp(ctypes.byref(pic), ctypes.c_void_p(img.ctypes.data),
               ctypes.c_int(img.shape[1] * img.shape[2])):
        raise RuntimeError("WebPPictureImport failed")
    writer = _WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P).value
    pic.custom_ptr = ctypes.addressof(writer)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    lib.WebPPictureFree(ctypes.byref(pic))
    try:
        if not ok:
            raise RuntimeError(f"WebPEncode failed ({pic.error_code})")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def make(out: str = OUT) -> dict:
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    files: dict[str, bytes] = {}

    def pil_save(name, img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, **kw)
        files[name] = buf.getvalue()

    rgb = smooth_image(45, 61, 1)
    grey = smooth_image(45, 61, 2, channels=1)
    for name, sub in (("444", 0), ("422", 1), ("420", 2)):
        pil_save(f"baseline_{name}.jpg", rgb, format="JPEG", quality=85, subsampling=sub)
        pil_save(f"progressive_{name}.jpg", rgb, format="JPEG", quality=85, subsampling=sub,
                 progressive=True)
    pil_save("baseline_grey.jpg", grey, format="JPEG", quality=85)
    pil_save("progressive_grey.jpg", grey, format="JPEG", quality=85, progressive=True)
    pil_save("restart_420.jpg", rgb, format="JPEG", quality=60, subsampling=2,
             restart_marker_blocks=2)
    pil_save("restart_progressive.jpg", rgb, format="JPEG", quality=60, subsampling=2,
             progressive=True, restart_marker_rows=1)
    odd = smooth_image(37, 53, 3)
    pil_save("odd_q30_420.jpg", odd, format="JPEG", quality=30, subsampling=2)
    files["baseline_440.jpg"] = encode_jpeg(rgb, ((1, 2), (1, 1), (1, 1)), quality=85)
    files["sof1_420.jpg"] = encode_jpeg(rgb, ((2, 2), (1, 1), (1, 1)), quality=85, sof=0xC1,
                                        restart=3)
    # the face-parser folder: smooth 512² photos with their labels
    for i in range(4):
        pil_save(f"face_parser/images/{i}.jpg", smooth_image(512, 512, 10 + i),
                 format="JPEG", quality=75)
        pil_save(f"face_parser/labels/{i}.png", face_label(512, 512, 20 + i), format="PNG")
    # BMP: Pillow writes 24-bit bottom-up, 32-bit from RGBA, 8-bit paletted
    # and 8-bit grey (a grey palette)
    small = smooth_image(21, 33, 4)
    pil_save("rgb24.bmp", small, format="BMP")
    files["rgb24_top_down.bmp"] = bmp_top_down(small)
    rgba = np.concatenate([small, smooth_image(21, 33, 5, channels=1)[..., None]], axis=2)
    pil_save("rgba32.bmp", rgba, format="BMP")
    pal = Image.fromarray(small).quantize(colors=37, method=Image.Quantize.MEDIANCUT)
    buf = io.BytesIO()
    pal.save(buf, format="BMP")
    files["paletted8.bmp"] = buf.getvalue()
    pil_save("grey8.bmp", smooth_image(21, 33, 6, channels=1), format="BMP")
    # CMYK, YCCK and RGB JPEGs, and sampling factors past 2
    buf = io.BytesIO()
    Image.fromarray(small).convert("CMYK").save(buf, format="JPEG", quality=80)
    files["cmyk.jpg"] = buf.getvalue()  # Pillow's: an Adobe segment, inverted samples
    cmyk = np.concatenate([small, smooth_image(21, 33, 7, channels=1)[..., None]], axis=2)
    files["cmyk_no_adobe.jpg"] = encode_jpeg(cmyk, ((1, 1),) * 4, quality=85, colour="cmyk")
    files["ycck_2x2.jpg"] = encode_jpeg(cmyk, ((2, 2), (1, 1), (1, 1), (2, 2)), quality=85,
                                        colour="ycck", adobe=2)
    files["rgb_adobe.jpg"] = encode_jpeg(odd, quality=85, colour="rgb", adobe=0)
    files["rgb_ids_420.jpg"] = encode_jpeg(odd, ((2, 2), (1, 1), (1, 1)), quality=85,
                                           colour="rgb", ids=b"RGB")
    files["sampling_411.jpg"] = encode_jpeg(odd, ((4, 1), (1, 1), (1, 1)), quality=85)
    files["sampling_1x4.jpg"] = encode_jpeg(odd, ((1, 4), (1, 1), (1, 1)), quality=85)
    files["sampling_4x2.jpg"] = encode_jpeg(odd, ((4, 2), (1, 1), (1, 1)), quality=85)
    files["sampling_4x1_2x1.jpg"] = encode_jpeg(odd, ((4, 1), (2, 1), (1, 1)), quality=85)
    # PNG: Pillow's palette (1, 2, 4, 8 bits, with and without tRNS), LA,
    # I;16 and mode 1 files; the script's writer for the rest
    tiny = smooth_image(19, 27, 8)
    for bits in (1, 2, 4, 8):
        pal_im = Image.fromarray(tiny).quantize(colors=1 << bits)
        for trns in (False, True):
            buf = io.BytesIO()
            pal_im.save(buf, format="PNG", bits=bits, **({"transparency": 0} if trns else {}))
            files[f"palette{bits}{'_trns' if trns else ''}.png"] = buf.getvalue()
    pil_save("la.png", np.stack([tiny[..., 0], tiny[..., 1]], axis=2), format="PNG")
    pil_save("grey16.png", (smooth_image(19, 27, 9, channels=1).astype(np.uint16) * 3),
             format="PNG")
    buf = io.BytesIO()
    Image.fromarray(tiny[..., 2]).convert("1").save(buf, format="PNG")
    files["mode1.png"] = buf.getvalue()
    rs = np.random.RandomState(5)
    grey_lvls = smooth_image(19, 27, 11, channels=1)
    files["rgb16.png"] = encode_png(rs.randint(0, 1 << 16, (19, 27, 3)), 2, 16, seed=1)
    files["rgba16.png"] = encode_png(rs.randint(0, 1 << 16, (19, 27, 4)), 6, 16, seed=2)
    files["la16.png"] = encode_png(rs.randint(0, 1 << 16, (19, 27, 2)), 4, 16, seed=3)
    files["grey_trns.png"] = encode_png(grey_lvls[..., None], 0, 8,
                                        trns=struct.pack(">H", int(grey_lvls[0, 0])), seed=4)
    files["rgb_trns.png"] = encode_png(tiny, 2, 8, trns=struct.pack(">3H", *tiny[0, 0]), seed=5)
    files["adam7_rgb8.png"] = encode_png(tiny, 2, 8, interlace=1, seed=6)
    files["adam7_grey2.png"] = encode_png(grey_lvls[..., None] >> 6, 0, 2, interlace=1, seed=7)
    files["adam7_palette4.png"] = encode_png(
        rs.randint(0, 16, (19, 27, 1)), 3, 4, interlace=1,
        plte=rs.randint(0, 256, 3 * 11).astype(np.uint8).tobytes(), seed=8)
    files["adam7_rgba16.png"] = encode_png(rs.randint(0, 1 << 16, (19, 27, 4)), 6, 16,
                                           interlace=1, seed=9)
    files["adam7_grey16.png"] = encode_png(rs.randint(0, 600, (19, 27, 1)), 0, 16,
                                           interlace=1, seed=10)
    # WebP: Pillow's lossy (three qualities, with and without alpha),
    # lossless, an animation with an offset first frame; libwebp's encoder
    # for the options Pillow does not set
    alpha = smooth_image(21, 33, 12, channels=1)[..., None]
    for q in (30, 80, 95):
        pil_save(f"lossy_q{q}.webp", small, format="WEBP", quality=q)
    pil_save("lossy_alpha.webp", np.concatenate([small, alpha], axis=2), format="WEBP",
             quality=70)
    pil_save("lossless.webp", small, format="WEBP", lossless=True)
    pil_save("lossless_alpha.webp", np.concatenate([small, alpha], axis=2), format="WEBP",
             lossless=True)
    frames = []
    for i, (q, shape) in enumerate(((60, (11, 15)), (60, (21, 33)))):
        buf = io.BytesIO()
        Image.fromarray(smooth_image(*shape, 13 + i)).save(buf, format="WEBP", quality=q)
        frames.append(buf.getvalue())
    files["anim_offset.webp"] = webp_container(
        [(6, 4, 15, 11, frames[0], 0), (0, 0, 33, 21, frames[1], 2)], (33, 21), alpha=False)
    files["vp8_partitions4_simple.webp"] = libwebp_encode(
        odd, quality=50, partitions=2, filter_type=0, filter_sharpness=5, filter_strength=60)
    files["vp8_nofilter_1seg.webp"] = libwebp_encode(odd, quality=40, filter_strength=0,
                                                     segments=1)
    files["vp8_raw_alpha.webp"] = libwebp_encode(
        np.concatenate([odd, smooth_image(37, 53, 14, channels=1)[..., None]], axis=2),
        quality=60, alpha_compression=0, alpha_filtering=2)
    # BMP: RLE8, RLE4, bit fields, 16-bit 5-5-5, 1- and 4-bit palettes
    pal16 = rs.randint(0, 256, (16, 3)).astype(np.uint8)
    idx16 = (smooth_image(21, 33, 15, channels=1) // 16).astype(np.uint8)
    pal256 = rs.randint(0, 256, (256, 3)).astype(np.uint8)
    idx256 = (smooth_image(21, 33, 16, channels=1) // 8 * 8).astype(np.uint8)
    files["rle8.bmp"] = encode_bmp(idx256, 8, pal256, compression=1)
    files["rle4.bmp"] = encode_bmp(idx16, 4, pal16, compression=2)
    files["pal4.bmp"] = encode_bmp(idx16, 4, pal16)
    files["pal1.bmp"] = encode_bmp(idx16 & 1, 1, pal16[:2])
    px16 = rs.randint(0, 1 << 16, (21, 33))
    files["rgb555.bmp"] = encode_bmp(px16, 16)
    files["bitfields565.bmp"] = encode_bmp(px16, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    files["bitfields_xbgr32.bmp"] = encode_bmp(
        rs.randint(0, 1 << 32, (21, 33), dtype=np.uint64), 32, compression=3,
        masks=(0xFF000000, 0xFF0000, 0xFF00, 0x0), header=56)
    # for timing on the card, and the subject photos of its request from
    # files: a 512x512 lossy WebP, palette PNG and CMYK JPEG
    face = smooth_image(512, 512, 17)
    pil_save("timing_512_q80.webp", face, format="WEBP", quality=80)
    buf = io.BytesIO()
    Image.fromarray(face).quantize(colors=256).save(buf, format="PNG")
    files["timing_512_palette.png"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(smooth_image(512, 512, 18)).convert("CMYK").save(buf, format="JPEG",
                                                                     quality=75)
    files["timing_512_cmyk.jpg"] = buf.getvalue()

    digests = {}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        px = pil_pixels(path)
        digests[name] = {"shape": list(px.shape),
                         "sha256": hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()}
    with open(os.path.join(out, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


if __name__ == "__main__":
    d = make()
    total = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(OUT) for f in fs)
    print(f"{len(d)} fixtures, {total} bytes in {OUT}")
