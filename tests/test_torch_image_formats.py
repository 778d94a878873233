"""The image files the JAX package opens through Pillow, read by the port.

Each format's variants, encoded here from seeded numpy images, decode to
Pillow's `convert("RGB")` and `convert("L")` bit for bit through
`utils.image.decode_image_bytes` (`to_rgb` / `to_grey`): PNG at every
colour type and bit depth, with `tRNS` and Adam7; WebP lossy, lossless,
with alpha and animated, and with the libwebp options Pillow's `save` does
not set; CMYK, YCCK and RGB JPEGs and sampling factors up to 4; RLE8, RLE4,
bit-field, 16-, 4- and 1-bit BMPs, with Pillow's quirks. Files Pillow
refuses are refused. Then the JAX package's subject dataset and face-parser
reader against the port's on folders of such files, item for item.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch.utils.image import decode_image_bytes, to_grey, to_rgb
from tests.make_image_fixtures import (encode_bmp, encode_jpeg, encode_png, libwebp_encode,
                                       smooth_image, webp_container)
from tests.test_torch_models import one_torch_thread  # noqa: F401  (autouse)

SIZES = ((1, 1), (7, 13), (16, 16), (33, 21))


def pil_opens(data: bytes):
    """Pillow's (RGB, L) pixels of `data`, or None where it refuses."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB")), np.asarray(im.convert("L"))
    except Exception:  # noqa: BLE001  (Pillow raises several kinds)
        return None


def assert_as_pillow(data: bytes, what) -> None:
    want = pil_opens(data)
    if want is None:
        with pytest.raises(ValueError):
            decode_image_bytes(data, str(what))
        return
    px = decode_image_bytes(data, str(what))
    for conv, w, mode in ((to_rgb, want[0], "RGB"), (to_grey, want[1], "L")):
        got = conv(px)
        assert got.shape == w.shape, (what, mode)
        np.testing.assert_array_equal(got, w, err_msg=f"{what} {mode}")


def saved(img: np.ndarray, fmt: str, mode: str | None = None, **kw) -> bytes:
    im = Image.fromarray(img) if mode is None else Image.fromarray(img).convert(mode)
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def images(seed: int, channels: int = 3):
    """Noise and smooth uint8 images at odd, even and one-pixel sizes."""
    rs = np.random.RandomState(seed)
    for h, w in SIZES:
        yield (h, w), rs.randint(0, 256, (h, w, channels)).astype(np.uint8)
        yield (h, w), smooth_image(h, w, seed + h * w, channels).reshape(h, w, channels)


# ---------------------------------------------------------------- PNG
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "1", "P1", "P2", "P4", "P8",
                                  "I;16"])
def test_png_pillow_modes(mode):
    for size, img in images(1):
        if mode.startswith("P"):
            bits = int(mode[1:])
            im = Image.fromarray(img).quantize(colors=1 << bits)
            for kw in ({}, {"transparency": 0}):
                buf = io.BytesIO()
                im.save(buf, format="PNG", bits=bits, **kw)
                assert_as_pillow(buf.getvalue(), (mode, size, kw))
        elif mode == "I;16":
            v = img[..., 0].astype(np.uint16) * 7 + img[..., 1]
            assert_as_pillow(saved(v, "PNG"), (mode, size))
        else:
            for kw in ({}, {"optimize": True}):
                assert_as_pillow(saved(img, "PNG", mode, **kw), (mode, size, kw))


PNG_TYPES = [(colour, depth) for colour, depths in
             ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
             for depth in depths]


@pytest.mark.parametrize("colour,depth", PNG_TYPES)
def test_png_every_type_depth_adam7_trns(colour, depth):
    """The script's writer: every colour type at every bit depth, plain and
    Adam7, every row filter, a short palette (indices past it), `tRNS`."""
    rs = np.random.RandomState(colour * 17 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    for h, w in SIZES + ((9, 2), (2, 9)):
        samples = rs.randint(0, 1 << depth, (h, w, channels))
        plte = (rs.randint(0, 256, 3 * rs.randint(1, (1 << depth) + 1)).astype(np.uint8)
                .tobytes()[:768] if colour == 3 else None)
        trns = (struct.pack(">H", int(samples[0, 0, 0])) if colour == 0 else
                struct.pack(">3H", *map(int, samples[0, 0])) if colour == 2 else
                bytes([0, 128]) if colour == 3 else None)
        for interlace in (0, 1):
            for t in (None, trns):
                data = encode_png(samples, colour, depth, interlace, plte=plte, trns=t,
                                  seed=h * w + interlace)
                assert_as_pillow(data, (colour, depth, h, w, interlace, t is not None))


# --------------------------------------------------------------- WebP
@pytest.mark.parametrize("kw", [{"quality": 5}, {"quality": 50}, {"quality": 90},
                                {"quality": 100, "method": 6}, {"quality": 75, "method": 0},
                                {"lossless": True}, {"lossless": True, "exact": True},
                                {"quality": 60, "alpha_quality": 30}],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_webp_pillow(kw):
    for channels in (3, 4):
        for size, img in images(2, channels):
            assert_as_pillow(saved(img, "WEBP", **kw), (channels, size))


LIBWEBP_OPTIONS = [dict(partitions=p) for p in (1, 2, 3)] + [
    dict(filter_type=0, filter_sharpness=s, filter_strength=f) for s in (0, 4, 7)
    for f in (20, 90)] + [
    dict(filter_type=1, filter_sharpness=s, filter_strength=f) for s in (3, 6)
    for f in (0, 50)] + [
    dict(segments=1), dict(segments=4, sns_strength=100), dict(use_sharp_yuv=1),
    dict(alpha_compression=0, alpha_filtering=1), dict(alpha_filtering=2),
    dict(preprocessing=2), dict(lossless=1, method=6, quality=100)]


@pytest.mark.parametrize("opts", LIBWEBP_OPTIONS,
                         ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_webp_libwebp_options(opts):
    """Token partitions, the simple filter, sharpness, filter level 0,
    segments, raw and filtered alpha: libwebp's advanced encoder."""
    rs = np.random.RandomState(len(opts))
    img = np.concatenate([smooth_image(37, 45, 3), rs.randint(0, 256, (37, 22, 3))],
                         axis=1).astype(np.uint8)
    for im in (img, np.concatenate([img, rs.randint(0, 256, (37, 67, 1)).astype(np.uint8)],
                                   axis=2)):
        assert_as_pillow(libwebp_encode(im, **dict(opts)), (opts, im.shape))


def test_webp_animations():
    """Pillow's animations (the first frame), and offset first frames with
    each blend and dispose flag, lossy and lossless, with and without
    alpha."""
    rs = np.random.RandomState(4)
    for kw in ({}, {"lossless": True}, {"quality": 30}):
        frames = [Image.fromarray(rs.randint(0, 256, (17, 23, 3)).astype(np.uint8))
                  for _ in range(3)]
        buf = io.BytesIO()
        frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:],
                       duration=90, **kw)
        assert_as_pillow(buf.getvalue(), ("pillow animation", kw))
        for alpha in (False, True):
            first = saved(np.concatenate([rs.randint(0, 256, (9, 13, 3)),
                                          np.full((9, 13, 1), 150)], axis=2).astype(np.uint8)
                          [..., :4 if alpha else 3], "WEBP", **kw)
            second = saved(rs.randint(0, 256, (5, 5, 3)).astype(np.uint8), "WEBP", **kw)
            for flags in range(4):
                data = webp_container([(4, 6, 13, 9, first, flags), (0, 0, 5, 5, second, 0)],
                                      (21, 17), alpha)
                assert_as_pillow(data, ("offset", kw, alpha, flags))


def test_webp_metadata_chunks_leave_pixels():
    img = smooth_image(19, 29, 5)
    data = saved(img, "WEBP", quality=70, icc_profile=b"\x00" * 64,
                 exif=b"Exif\x00\x00" + b"\x01" * 20)
    assert b"ICCP" in data and b"EXIF" in data
    assert_as_pillow(data, "icc exif")


# --------------------------------------------------------------- JPEG
def test_jpeg_cmyk_pillow():
    """Pillow's CMYK files: an Adobe segment, samples stored inverted."""
    for q in (30, 90):
        for progressive in (False, True):
            for size, img in images(5, 4):
                assert_as_pillow(_cmyk(img, q, progressive), (q, progressive, size))


def _cmyk(img: np.ndarray, quality: int, progressive: bool) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, format="JPEG", quality=quality,
                                      progressive=progressive)
    return buf.getvalue()


@pytest.mark.parametrize("colour,adobe", [("cmyk", 0), ("cmyk", None), ("ycck", 2),
                                          ("ycck", 1), ("rgb", 0), ("rgb", None)])
def test_jpeg_colour_spaces(colour, adobe):
    """CMYK with and without an Adobe segment, YCCK (transform 2, and 1,
    which libjpeg takes as YCCK for four components), RGB by the Adobe
    transform or by component ids R, G, B."""
    ids = b"RGB" if colour == "rgb" and adobe is None else None
    channels = 3 if colour == "rgb" else 4
    for size, img in images(6, channels):
        for sampling in (((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2)),
                         ((2, 1), (1, 2), (1, 1), (1, 1))):
            data = encode_jpeg(img, sampling, 80, colour=colour, adobe=adobe, ids=ids)
            assert_as_pillow(data, (colour, adobe, sampling, size))


SAMPLINGS = [((4, 1), (1, 1), (1, 1)), ((1, 4), (1, 1), (1, 1)), ((4, 2), (1, 1), (1, 1)),
             ((2, 4), (1, 1), (1, 1)), ((3, 1), (1, 1), (1, 1)), ((1, 3), (1, 1), (1, 1)),
             ((4, 1), (2, 1), (1, 1)), ((2, 4), (1, 2), (1, 1)), ((4, 2), (2, 2), (1, 1)),
             ((1, 1), (2, 2), (1, 1)), ((2, 2), (1, 2), (2, 1)), ((3, 3), (1, 1), (1, 1)),
             ((4, 2), (2, 1), (2, 1))]


@pytest.mark.parametrize("sampling", SAMPLINGS, ids=str)
def test_jpeg_sampling_factors(sampling):
    """Ratios of 2 upsampled "fancy" as libjpeg-turbo does, other integral
    ratios replicated; an MCU of more than 10 blocks refused as Pillow
    refuses it."""
    for size, img in images(7):
        assert_as_pillow(encode_jpeg(img, sampling, 75), (sampling, size))


# ---------------------------------------------------------------- BMP
def test_bmp_palettes_and_pixels():
    """1-, 4- and 8-bit palettes (short ones too, and grey-level palettes,
    which Pillow reads as "L" or "1"), 16-bit 5-5-5 and the bit fields
    Pillow accepts, refusing the others."""
    rs = np.random.RandomState(8)
    for h, w in SIZES + ((5, 40),):
        for bits in (1, 4, 8):
            idx = rs.randint(0, 1 << bits, (h, w))
            pal = rs.randint(0, 256, ((1 << bits), 3)).astype(np.uint8)
            assert_as_pillow(encode_bmp(idx, bits, pal), ("pal", bits, h, w))
            assert_as_pillow(encode_bmp(idx, bits, pal[:2]), ("short pal", bits, h, w))
            grey = np.repeat(np.arange(1 << bits, dtype=np.uint8)[:, None], 3, axis=1)
            assert_as_pillow(encode_bmp(idx, bits, grey), ("grey pal", bits, h, w))
            bw = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
            assert_as_pillow(encode_bmp(idx & 1, bits, bw), ("bw pal", bits, h, w))
        px16 = rs.randint(0, 1 << 16, (h, w))
        assert_as_pillow(encode_bmp(px16, 16), ("555", h, w))
        for masks in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F), (0xF00, 0xF0, 0xF)):
            for header in (40, 56):
                assert_as_pillow(encode_bmp(px16, 16, compression=3, masks=masks, header=header),
                                 ("bitfields16", masks, header, h, w))
        px32 = rs.randint(0, 1 << 32, (h, w), dtype=np.uint64)
        for masks in ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                      (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0, 0, 0, 0),
                      (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0xFF, 0xFF00, 0xFF0000, 0)):
            for header in (40, 108):
                m = masks[:3] if header == 40 else masks
                assert_as_pillow(encode_bmp(px32, 32, compression=3, masks=m, header=header),
                                 ("bitfields32", masks, header, h, w))


def test_bmp_rle():
    """RLE8 and RLE4 from the script's encoder on random and smooth index
    images; Pillow's delta (two bytes skipped before right and up), an odd
    RLE4 absolute run (its last pixel dropped), runs past the row's end,
    and data that ends before the image is full (refused)."""
    rs = np.random.RandomState(9)
    for h, w in SIZES + ((6, 41),):
        for rle4, bits in ((False, 8), (True, 4)):
            pal = rs.randint(0, 256, (1 << bits, 3)).astype(np.uint8)
            for idx in (rs.randint(0, 1 << bits, (h, w)),
                        smooth_image(h, w, h + w, 1) >> (8 - bits)):
                assert_as_pillow(encode_bmp(np.asarray(idx), bits, pal,
                                            compression=2 if rle4 else 1), (bits, h, w))
    pal = rs.randint(0, 256, (256, 3)).astype(np.uint8)

    def raw_rle(body: bytes, w: int, h: int, bits: int) -> bytes:
        data = encode_bmp(np.zeros((h, w), np.int64), bits, pal[:1 << bits],
                          compression=1 if bits == 8 else 2)
        off = struct.unpack("<I", data[10:14])[0]
        return data[:off] + body

    for body in (bytes([3, 7, 0, 2, 9, 9, 1, 1, 2, 5, 0, 0, 0, 3, 1, 2, 3, 0, 0, 0, 0, 0, 1]),
                 bytes([9, 4, 0, 0, 0, 4, 1, 2, 3, 4, 0, 0, 2, 8, 0, 1]),
                 bytes([2, 7, 0, 2, 1, 1, 1, 0, 0, 1]),
                 bytes([4, 1, 4, 2, 0, 0, 0, 5, 1, 2, 3, 4, 5, 0, 0, 0, 1])):
        assert_as_pillow(raw_rle(body, 4, 3, 8), ("rle8", body))
    for body in (bytes([0, 5, 0x12, 0x34, 0x50, 0, 0, 0, 4, 0x67, 0, 0, 0, 1]),
                 bytes([3, 0x12, 0, 3, 0x34, 0x50, 0, 0, 0, 0, 4, 0x78, 0, 1]),
                 bytes([7, 0x9A, 0, 0, 0, 4, 0x12, 0x34, 0, 1])):
        assert_as_pillow(raw_rle(body, 5, 2, 4), ("rle4", body))


# ---------------------------------------------- the JAX package's readers
@pytest.fixture()
def formats_root(tmp_path):
    """A subject folder of a lossy WebP, a palette PNG, a CMYK JPEG and an
    RLE8 BMP photo, the PNG with a palette-PNG mask."""
    subj = tmp_path / "subj"
    subj.mkdir()
    photo = smooth_image(48, 40, 21)
    (subj / "a.webp").write_bytes(saved(photo, "WEBP", quality=70))
    buf = io.BytesIO()
    Image.fromarray(smooth_image(44, 52, 22)).quantize(colors=64).save(buf, format="PNG")
    (subj / "b.png").write_bytes(buf.getvalue())
    (subj / "c.jpg").write_bytes(_cmyk(np.concatenate(
        [smooth_image(40, 40, 23), smooth_image(40, 40, 24, 1)[..., None]], axis=2), 85, False))
    pal = Image.fromarray(smooth_image(36, 50, 25)).quantize(colors=200)
    (subj / "d.bmp").write_bytes(encode_bmp(
        np.asarray(pal), 8, np.asarray(pal.getpalette()[:600], np.uint8).reshape(-1, 3),
        compression=1))
    mask = (smooth_image(44, 52, 26, 1) > 128).astype(np.uint8)
    buf = io.BytesIO()
    m = Image.fromarray(mask, "P")
    m.putpalette([0, 0, 0, 255, 255, 255])
    m.save(buf, format="PNG", bits=1)
    (subj / "b_mask.png").write_bytes(buf.getvalue())
    return str(tmp_path)


def test_subject_dataset_matches_jax(formats_root):
    """`PersonalizedBase` against the JAX package's (its numpy path: the
    port's item pipeline gives those bits) over two epochs, bit for bit."""
    from adaface_tpu.data.personalized import PersonalizedBase as JaxBase

    from adaface_tpu_torch.data.personalized import PersonalizedBase

    port = PersonalizedBase(formats_root, size=64, seed=7)
    ref = JaxBase(formats_root, size=64, seed=7, use_native=False)
    assert len(port) == len(ref) == 4
    assert [os.path.basename(p) for p in port.subjects[0].image_paths] == \
        [os.path.basename(p) for p in ref.subjects[0].image_paths]
    assert sum(m is not None for m in port.subjects[0].mask_paths) == 1
    for i in range(2 * len(port)):
        a, b = port[i], ref[i]
        for key in ("image", "fg_mask", "aug_mask"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{i} {key}")
        assert a["subj_single_prompt"] == b["subj_single_prompt"]


def test_face_parser_reader_matches_jax(tmp_path):
    """The face parser's items and eval pairs from WebP, CMYK-JPEG and
    palette-PNG photos with palette-PNG labels, against JAX's dataset."""
    from adaface_tpu.train import face_parsing_train as jtrain

    from adaface_tpu_torch.train import face_parsing_train as ttrain
    from tests.make_image_fixtures import face_label

    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    photo = smooth_image(96, 80, 31)
    (tmp_path / "images" / "0.webp").write_bytes(saved(photo, "WEBP", quality=75))
    (tmp_path / "images" / "1.jpg").write_bytes(_cmyk(np.concatenate(
        [photo, smooth_image(96, 80, 32, 1)[..., None]], axis=2), 80, True))
    buf = io.BytesIO()
    Image.fromarray(photo).quantize(colors=100).save(buf, format="PNG")
    (tmp_path / "images" / "2.png").write_bytes(buf.getvalue())
    for i in range(3):
        lbl = Image.fromarray(face_label(96, 80, 40 + i), "P")
        lbl.putpalette(list(np.random.RandomState(i).randint(0, 256, 57)))
        lbl.save(tmp_path / "labels" / f"{i}.png", bits=8)
    dt = ttrain.FaceMaskDataset(str(tmp_path), crop_size=64, seed=3)
    dj = jtrain.FaceMaskDataset(str(tmp_path), crop_size=64, seed=3)
    for i in (0, 1, 2, 0):
        for u, v in zip(dt[i], dj[i]):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
    for i in range(3):
        for u, v in zip(dt.get_eval(i), dj.get_eval(i)):
            np.testing.assert_array_equal(u, v)
