"""The port's image decoding and PIL-free image operations against Pillow.

`adaface_tpu_torch.native.decode_image` (JPEG, BMP) and
`utils.image.read_image` (PNG, JPEG, BMP, GIF, WebP) are held bit for bit
to what Pillow decodes: the
committed fixtures of `tests/data/images/` (remade by
`tests/make_image_fixtures.py`) against their recorded digests and against
Pillow, and JPEGs Pillow encodes here from seeded numpy images. The numpy
counterparts of the face parser's Pillow calls are held to Pillow, and the
port's `augment_face_parsing` and `FaceMaskDataset` to the JAX package's.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pathlib
import re
import struct

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch import native
from adaface_tpu_torch.native import decode_image
from adaface_tpu_torch.train import face_parsing_train as ttrain
from adaface_tpu_torch.utils.image import (decode_image_bytes, paste_pad, read_image, read_png,
                                           resize_pil, resize_nearest_pil, to_grey, to_rgb)
from tests.make_image_fixtures import encode_bmp, encode_jpeg, smooth_image

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "images")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
DECODED = sorted(k for k, v in DIGESTS.items() if "sha256" in v)


def pil_pixels(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("L" if im.mode == "L" else "RGB"))


def as_read(path, grey: bool) -> np.ndarray:
    px = read_image(path)
    return to_grey(px) if grey else to_rgb(px)


def jpeg_bytes(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def webp_bytes(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("name", DECODED)
def test_fixture_matches_digest_and_pil(name):
    path = os.path.join(FIXTURES, name)
    want = DIGESTS[name]
    px = as_read(path, grey=len(want["shape"]) == 2)
    assert list(px.shape) == want["shape"]
    assert hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(px, pil_pixels(path))


def test_fixture_digests_are_current(tmp_path):
    """The fixture script run again writes the same digests."""
    from tests.make_image_fixtures import make

    assert make(str(tmp_path)) == DIGESTS


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """`data` with the byte at `offset` into the first `marker` segment's body
    replaced."""
    i = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[i + 4 + offset] = value
    return bytes(out)


def _rejects():
    rgb = smooth_image(24, 40, 1)
    base = jpeg_bytes(rgb, quality=80, subsampling=2)
    # a lossy WebP whose frame tag says "inter frame"; a lossless one cut
    # short inside its pixels, its RIFF and chunk sizes made to agree
    vp8 = bytearray(webp_bytes(rgb, quality=80))
    vp8[20] |= 1
    vp8l = webp_bytes(rgb, lossless=True)
    cut = len(vp8l) * 2 // 3
    vp8l = bytearray(vp8l[:cut])
    vp8l[4:8] = struct.pack("<I", cut - 8)
    vp8l[16:20] = struct.pack("<I", cut - 20)
    return {
        "lossless": (base.replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless"),
        "arithmetic": (base.replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic"),
        "12-bit": (_patched(base, 0xC0, 0, 12), "12-bit"),
        "gif": (b"GIF89a" + bytes(20), "empty logical screen"),
        "vp8 inter frame": (bytes(vp8), "not a key frame"),
        "truncated vp8l": (bytes(vp8l), "truncated"),
    }


@pytest.mark.parametrize("name", list(_rejects()))
def test_refused_formats_raise_naming_the_path(name, tmp_path):
    data, what = _rejects()[name]
    path = tmp_path / "image.bin"
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        read_image(path)
    assert str(path) in str(e.value) and what in str(e.value)


def _formerly_refused():
    """The kinds of file the port refused before it read WebP, CMYK and RGB
    JPEGs, sampling past 2 and RLE and 16-bit BMPs: the WebP and CMYK
    fixtures, a 4:1:1 JPEG, an RGB JPEG (no JFIF segment, components named
    R, G, B, scanned by those names), an RLE8 BMP and a 24-bit BMP whose
    header says 16 bits."""
    rgb = smooth_image(24, 40, 1)
    bmp = io.BytesIO()
    Image.fromarray(rgb).save(bmp, format="BMP")
    bmp = bytearray(bmp.getvalue())
    bits16 = bytes(bmp[:28]) + struct.pack("<H", 16) + bytes(bmp[30:])
    rgb_ids = encode_jpeg(rgb, quality=80, colour="rgb", ids=b"RGB")
    pal = Image.fromarray(rgb).quantize(colors=40)
    rle = encode_bmp(np.asarray(pal), 8, np.asarray(pal.getpalette()[:120], np.uint8).reshape(
        -1, 3), compression=1)

    def fixture(name):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            return f.read()

    return {"reject.webp": fixture("lossy_q80.webp"), "reject_cmyk.jpg": fixture("cmyk.jpg"),
            "4:1:1": encode_jpeg(rgb, ((4, 1), (1, 1), (1, 1))), "rgb": rgb_ids, "rle": rle,
            "16-bit bmp": bits16}


@pytest.mark.parametrize("name", list(_formerly_refused()))
def test_formerly_refused_decode_as_pillow(name):
    data = _formerly_refused()[name]
    px = decode_image_bytes(data)
    with Image.open(io.BytesIO(data)) as im:
        for mode, conv in (("RGB", to_rgb), ("L", to_grey)):
            np.testing.assert_array_equal(conv(px), np.asarray(im.convert(mode)), err_msg=mode)


JPEG_CASES = [(q, sub, prog) for q in (30, 75, 95) for sub in (0, 1, 2) for prog in (False, True)]


@pytest.mark.parametrize("quality,subsampling,progressive", JPEG_CASES)
def test_pil_encoded_jpegs(quality, subsampling, progressive):
    """Noise and smooth images at even, odd and sub-MCU sizes."""
    rs = np.random.RandomState(quality * 10 + subsampling * 2 + progressive)
    for h, w in ((64, 64), (67, 93), (5, 3), (17, 2), (2, 17), (9, 31)):
        for img in (rs.randint(0, 256, (h, w, 3)).astype(np.uint8), smooth_image(h, w, h + w)):
            data = jpeg_bytes(img, quality=quality, subsampling=subsampling,
                              progressive=progressive)
            np.testing.assert_array_equal(decode_image(data), pil_decode(data),
                                          err_msg=f"{h}x{w}")


@pytest.mark.parametrize("progressive", [False, True])
def test_grey_and_restart_jpegs(progressive):
    rs = np.random.RandomState(7)
    for h, w in ((48, 40), (37, 53)):
        grey = rs.randint(0, 256, (h, w)).astype(np.uint8)
        for kw in ({}, {"restart_marker_blocks": 1}, {"restart_marker_blocks": 5},
                   {"restart_marker_rows": 2}):
            for img, sub in ((grey, -1), (rs.randint(0, 256, (h, w, 3)).astype(np.uint8), 2)):
                data = jpeg_bytes(img, quality=70, subsampling=sub, progressive=progressive, **kw)
                np.testing.assert_array_equal(decode_image(data), pil_decode(data))


@pytest.mark.parametrize("sampling", [((1, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)),
                                      ((2, 2), (1, 1), (1, 1))])
def test_own_encoder_jpegs(sampling):
    """4:4:0 (which Pillow does not write), SOF1 frames and restarts."""
    rs = np.random.RandomState(sum(sum(s) for s in sampling))
    for h, w, restart, sof in ((33, 47, 0, 0xC0), (16, 16, 2, 0xC1), (9, 3, 1, 0xC0)):
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        data = encode_jpeg(img, sampling, quality=60, sof=sof, restart=restart)
        np.testing.assert_array_equal(decode_image(data), pil_decode(data))


def test_bmps(tmp_path):
    rs = np.random.RandomState(3)
    for h, w in ((7, 5), (16, 13)):
        rgb = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ims = {"rgb": Image.fromarray(rgb),
               "rgba": Image.fromarray(np.concatenate(
                   [rgb, rs.randint(0, 256, (h, w, 1)).astype(np.uint8)], axis=2)),
               "p": Image.fromarray(rgb).quantize(colors=200),
               "l": Image.fromarray(rgb[..., 0])}
        for name, im in ims.items():
            path = tmp_path / f"{name}{h}.bmp"
            im.save(path)
            for grey in (False, True):
                with Image.open(path) as ref:
                    want = np.asarray(ref.convert("L" if grey else "RGB"))
                np.testing.assert_array_equal(as_read(path, grey), want, err_msg=f"{name} {grey}")


def test_png_through_read_image(tmp_path):
    img = np.random.RandomState(1).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    np.testing.assert_array_equal(read_image(tmp_path / "a.png"), read_png(tmp_path / "a.png"))


def test_pillow_operations():
    """BILINEAR (numpy and the host library's) and NEAREST resizes,
    `Image.new` + `paste`, on sizes that shrink, grow and keep an axis."""
    rs = np.random.RandomState(2)
    for shape in ((100, 120, 3), (37, 91), (5, 3, 3), (1, 7, 3), (300, 280, 3)):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        for size in ((75, 90), (448, 448), (13, 200), (1, 1), (shape[1], 60), (3, shape[0])):
            want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
            np.testing.assert_array_equal(resize_pil(img, size), want,
                                          err_msg=f"{shape} -> {size}")
            np.testing.assert_array_equal(native.resize_pil(img, size), want,
                                          err_msg=f"native {shape} -> {size}")
            np.testing.assert_array_equal(
                resize_nearest_pil(img, size),
                np.asarray(Image.fromarray(img).resize(size, Image.NEAREST)))
        size = (shape[1] + 5, shape[0] + 2)
        mode, fill = ("RGB", 0) if img.ndim == 3 else ("L", 255)
        canvas = Image.new(mode, size, fill)
        canvas.paste(Image.fromarray(img), (0, 0))
        np.testing.assert_array_equal(paste_pad(img, size, fill), np.asarray(canvas))


@pytest.fixture(scope="module")
def face_parser_root():
    return os.path.join(FIXTURES, "face_parser")


def test_face_parser_dataset_matches_jax(face_parser_root):
    """`__getitem__` (the augmentation from the same generator) and
    `get_eval` on the JPEG fixtures with PNG labels, against the JAX
    dataset, bit for bit."""
    from adaface_tpu.train import face_parsing_train as jtrain

    for crop in (448, 640):  # plain crops, and padded ones
        dt = ttrain.FaceMaskDataset(face_parser_root, crop_size=crop, seed=3)
        dj = jtrain.FaceMaskDataset(face_parser_root, crop_size=crop, seed=3)
        for i in (0, 1, 2, 3):
            for u, v in zip(dt[i], dj[i]):
                assert u.dtype == v.dtype and u.shape == v.shape
                np.testing.assert_array_equal(u, v)
        for u, v in zip(dt.get_eval(2), dj.get_eval(2)):
            np.testing.assert_array_equal(u, v)


def test_face_parser_batches_match_jax(face_parser_root):
    """`batches` (items prepared on a pool of threads, the draws in item
    order) and `eval_batches` against the JAX dataset's, bit for bit."""
    from adaface_tpu.train import face_parsing_train as jtrain

    dt = ttrain.FaceMaskDataset(face_parser_root, crop_size=448, seed=4)
    dj = jtrain.FaceMaskDataset(face_parser_root, crop_size=448, seed=4)
    for (u, ul), (v, vl) in zip(dt.batches(5, 2), dj.batches(5, 2)):
        assert u.shape == (5, 3, 448, 448) and u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
        np.testing.assert_array_equal(ul, vl)
    got = list(dt.eval_batches(3))
    want = list(dj.eval_batches(3))
    assert [u.shape[0] for u, _ in got] == [3, 1]
    for (u, ul), (v, vl) in zip(got, want):
        np.testing.assert_array_equal(u, v)
        np.testing.assert_array_equal(ul, vl)


def test_augment_face_parsing_matches_jax():
    from adaface_tpu.train import face_parsing_train as jtrain

    rs = np.random.RandomState(11)
    for shape, crop in (((97, 131), 64), ((512, 512), 448), ((40, 50), 96)):
        img = rs.randint(0, 256, (*shape, 3)).astype(np.uint8)
        lbl = rs.randint(0, 19, shape).astype(np.uint8)
        for seed in range(3):
            a = ttrain.augment_face_parsing(img, lbl, np.random.default_rng(seed), crop_size=crop)
            b = jtrain.augment_face_parsing(img, lbl, np.random.default_rng(seed), crop_size=crop)
            for u, v in zip(a, b):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


PORT_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|adaface_tpu|optax|PIL)\b(?!_torch)",
                         re.MULTILINE)


def port_files() -> list[pathlib.Path]:
    repo = pathlib.Path(FIXTURES).parent.parent.parent
    return (sorted((repo / "adaface_tpu_torch").rglob("*.py"))
            + [repo / n for n in ("chip_smoke.py", "chip_compare.py", "train_torch.py",
                                  "bench_torch.py", "app_torch.py")]
            + sorted((repo / "scripts").glob("*_torch.py")))


CV2_IMPORT = re.compile(r"^\s*(?:import|from)\s+cv2\b", re.MULTILINE)
# the optional Haar-cascade detector of the training losses, the one use of
# OpenCV in the port (`train/face_losses.py`, `train/face_detect.py`)
CV2_ALLOWED = {"face_losses.py", "face_detect.py"}


def test_port_imports_no_pil_or_jax():
    """No port file, `chip_smoke.py`, `chip_compare.py`, `train_torch.py`,
    `bench_torch.py`, `app_torch.py` or `scripts/*_torch.py` imports PIL,
    JAX, optax or the JAX package, at the top or inside a function (the
    card's machine has none of them), none but the training losses' optional
    face detector imports OpenCV (the card's machine has none: the
    evaluation package, the ViT, the makeup copy, the tool twins and the
    demo among them), every entry point runs on the card unless asked for
    the CPU, and the shell twins (`scripts/*_torch.sh`) call no script but
    the port's."""
    files = port_files()
    assert len(files) > 80
    names = {f.relative_to(files[0].parents[1]).as_posix() for f in files}
    assert {"app_torch.py", "adaface_tpu_torch/models/vit.py",
            "adaface_tpu_torch/utils/makeup.py", "adaface_tpu_torch/evaluation/clip_eval.py",
            "scripts/txt2img_eval_torch.py", "scripts/gen_face_masks_torch.py",
            "scripts/make_toy_dataset_torch.py", "scripts/bench_quality_torch.py",
            "scripts/profile_pipeline_torch.py", "scripts/test_img_prompt_model_torch.py",
            "scripts/dev_verify_comp_torch.py", "scripts/bench_train_torch.py"} <= names
    cv2 = {f.name for f in files if CV2_IMPORT.search(f.read_text())}
    assert cv2 <= CV2_ALLOWED, cv2 - CV2_ALLOWED
    bad = {f.name: PORT_IMPORT.findall(f.read_text()) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}
    defaults = {f.name: re.findall(r'"--device",\s*default="(\w+)"', f.read_text())
                for f in files}
    assert {k: v for k, v in defaults.items() if v and set(v) != {"cuda"}} == {}
    # the shell twins call the port's scripts only
    shells = sorted((files[0].parents[1] / "scripts").glob("*_torch.sh"))
    assert [f.name for f in shells] == ["infer_every_n_min_torch.sh"]
    calls = {f.name: [c for line in f.read_text().splitlines()
                      if not line.lstrip().startswith("#")
                      for c in re.findall(r"([\w/.-]+\.(?:py|sh))\b", line)] for f in shells}
    assert all(calls.values()), calls
    assert {k: [c for c in v if not re.search(r"_torch\.(?:py|sh)$", c)]
            for k, v in calls.items()} == {k: [] for k in calls}
