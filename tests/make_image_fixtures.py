"""Make the image fixtures of `tests/data/images/` with Pillow, and record
the SHA-256 of Pillow's decoded pixels beside them (`digests.json`).

    python tests/make_image_fixtures.py

The port decodes these files without Pillow: `tests/test_torch_image_io.py`
holds its decoder to the digests and to Pillow, and `chip_smoke.py` holds it
to the digests on a machine that has no Pillow. Pillow writes neither 4:4:0
chroma nor SOF1 frames, so `encode_jpeg` (a baseline encoder in numpy, with
the Huffman and quantization tables of a Pillow file) writes those.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct

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


def encode_jpeg(img: np.ndarray, sampling=((1, 1), (1, 1), (1, 1)), quality: int = 75,
                sof: int = 0xC0, restart: int = 0) -> bytes:
    """A baseline (or SOF1) Huffman JPEG of uint8 [H, W] or [H, W, 3] with
    the luma's sampling factors `sampling[0]` (the chroma's 1x1), the tables
    Pillow uses at `quality`, and a restart marker every `restart` MCUs."""
    qt, huff = pil_tables(quality)
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes, factors = [img.astype(np.float64)], [(1, 1)]
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        factors = list(sampling)
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

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tid in sorted({c[3] for c in comps}):
        out += seg(0xDB, bytes([tid]) + bytes(qt[tid].reshape(-1)[ZIGZAG].astype(np.uint8)))
    frame = struct.pack(">BHHB", 8, h, w, len(comps))
    for ci, (fh, fv, _, table) in enumerate(comps):
        frame += bytes([ci + 1, (fh << 4) | fv, table])
    out += seg(sof, frame)
    for (cls, tid), (counts, symbols) in sorted(huff.items()):
        if tid in {c[3] for c in comps}:
            out += seg(0xC4, bytes([(cls << 4) | tid] + counts + symbols))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    scan = bytes([len(comps)]) + b"".join(bytes([ci + 1, (c[3] << 4) | c[3]])
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
    # refused: WebP and CMYK
    pil_save("reject.webp", small, format="WEBP", quality=80)
    buf = io.BytesIO()
    Image.fromarray(small).convert("CMYK").save(buf, format="JPEG", quality=80)
    files["reject_cmyk.jpg"] = buf.getvalue()

    digests = {}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        if name.startswith("reject"):
            digests[name] = {"rejected": True}
            continue
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
