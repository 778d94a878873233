"""GIF clips on the port: the host library's decoder and the video twins.

`utils.image.read_gif_frames` (`native/decode.cpp`'s `Gif`) is held bit for
bit to Pillow's `seek(i)` + `convert("RGB")` on the committed fixtures of
`tests/data/images/` (remade by `tests/make_gif_fixtures.py`: the port's
own `write_gif` output, local palettes, transparency with disposal 2 and
3, interlace, LZW codes of 12 bits) against their recorded digests, and on
GIFs Pillow writes here from seeded numpy frames (frame rectangles smaller
than the screen where Pillow optimizes, each disposal method). The twins
`scripts/eval_videos_torch.py` and `extract_frames_torch.py` are held to
the JAX scripts, which read with OpenCV, on the fixtures OpenCV decodes as
Pillow does (all but the transparent one: FFmpeg composites transparent
frames otherwise, and the port follows Pillow).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch.utils.image import read_gif_frames, read_image, read_png
from tests.make_gif_fixtures import DIGESTS, check, make, pil_frames

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "images"
with open(FIXTURES / DIGESTS) as _f:
    GIF_DIGESTS = json.load(_f)
# the fixtures OpenCV's FFmpeg backend decodes to Pillow's frames
CV2_AGREES = sorted(set(GIF_DIGESTS) - {"transparency_disposal.gif"})


@pytest.fixture(scope="module")
def twins():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import eval_videos
        import eval_videos_torch
        import extract_frames
        import extract_frames_torch
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return eval_videos, eval_videos_torch, extract_frames, extract_frames_torch


@pytest.mark.parametrize("name", sorted(GIF_DIGESTS))
def test_fixture_matches_digest_and_pil(name):
    path = FIXTURES / name
    frames = read_gif_frames(path)
    want = GIF_DIGESTS[name]
    assert list(frames.shape) == want["shape"] and frames.dtype == np.uint8
    assert hashlib.sha256(frames.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(frames, pil_frames(str(path)))
    with Image.open(path) as im:  # read_image: the first frame, as Pillow's convert("RGB")
        np.testing.assert_array_equal(read_image(path), np.asarray(im.convert("RGB")))


def test_fixtures_hold_what_they_test_and_are_current(tmp_path):
    """Local palettes after frame 0, transparency with disposal 2 and 3,
    interlace and 12-bit codes are in the files; the script run again
    writes the same digests."""
    check(str(FIXTURES))
    assert make(str(tmp_path)) == GIF_DIGESTS


def _pil_gif(frames: list[np.ndarray], **kw) -> bytes:
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, format="GIF", save_all=True, append_images=ims[1:], duration=50, loop=0,
                **kw)
    return buf.getvalue()


@pytest.mark.parametrize("disposal", [0, 1, 2, 3])
@pytest.mark.parametrize("optimize", [False, True])
def test_pil_written_gifs(disposal, optimize, tmp_path):
    """A moving square on a still background (Pillow crops the later frames
    to what changed where it optimizes), noise, and a P sprite whose index 0
    is transparent, at each disposal method."""
    rs = np.random.RandomState(disposal * 2 + optimize)
    h, w = 23, 31
    bg = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    moving = []
    for i in range(4):
        f = bg.copy()
        f[3 + 2 * i:9 + 2 * i, 4 + 3 * i:12 + 3 * i] = rs.randint(0, 256, 3)
        moving.append(f)
    cases = {"moving": _pil_gif(moving, optimize=optimize, disposal=disposal),
             "noise": _pil_gif([rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
                                for _ in range(3)], optimize=optimize, disposal=disposal)}
    ims = []
    for i in range(4):
        idx = np.zeros((h, w), np.uint8)
        idx[2 + i:12 + i, 5 * i:5 * i + 9] = 1 + i
        im = Image.fromarray(idx, "P")
        im.putpalette(rs.randint(0, 256, 96).tolist())
        ims.append(im)
    buf = io.BytesIO()
    ims[0].save(buf, format="GIF", save_all=True, append_images=ims[1:], transparency=0,
                disposal=disposal, optimize=optimize)
    cases["sprite"] = buf.getvalue()
    for name, data in cases.items():
        path = tmp_path / f"{name}.gif"
        path.write_bytes(data)
        np.testing.assert_array_equal(read_gif_frames(path), pil_frames(str(path)),
                                      err_msg=name)


def cv2_frames(path) -> np.ndarray:
    import cv2

    cap, out = cv2.VideoCapture(str(path)), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(out)


@pytest.mark.parametrize("name", CV2_AGREES)
def test_twins_match_the_jax_scripts(name, twins, tmp_path):
    """The JAX scripts read the fixture with OpenCV, the twins with the
    port's decoder: the same frames, the same motion-ratio picks, the same
    PNGs under the same names, and both refuse a clip that is too short."""
    eval_videos, eval_videos_torch, extract_frames, extract_frames_torch = twins
    path = str(FIXTURES / name)
    np.testing.assert_array_equal(read_gif_frames(path), cv2_frames(path))
    for n in (1, 3, 8):
        want, got = eval_videos.sample_frames(path, n), eval_videos_torch.sample_frames(path, n)
        assert len(got) == len(want) >= 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    total = GIF_DIGESTS[name]["shape"][0]
    for n in sorted({1, min(total, 4), total, total + 1}):
        (tmp_path / f"j{n}").mkdir()
        (tmp_path / f"t{n}").mkdir()
        ok_j = extract_frames.extract_frames(path, str(tmp_path / f"j{n}" / "f"), n)
        ok_t = extract_frames_torch.extract_frames(path, str(tmp_path / f"t{n}" / "f"), n)
        assert ok_j == ok_t == (n <= total)
        names = sorted(os.listdir(tmp_path / f"j{n}"))
        assert names == sorted(os.listdir(tmp_path / f"t{n}")) == sorted(
            f"f_{i}.png" for i in range(n if ok_j else 0))
        for f in names:
            np.testing.assert_array_equal(read_png(tmp_path / f"t{n}" / f),
                                          read_png(tmp_path / f"j{n}" / f))


def test_refusals_name_the_path(twins, tmp_path):
    """A clip in another video format raises naming it; a truncated GIF, or
    one cut inside a frame's data, raises a ValueError with its path."""
    _, eval_videos_torch, _, extract_frames_torch = twins
    mp4 = tmp_path / "clip.mp4"
    mp4.write_bytes(b"\x00\x00\x00\x18ftypmp42" + bytes(32))
    for fn in (lambda p: eval_videos_torch.sample_frames(p, 4),
               lambda p: extract_frames_torch.extract_frames(p, str(tmp_path / "x"), 2)):
        with pytest.raises(ValueError, match=r"\.mp4") as e:
            fn(str(mp4))
        assert str(mp4) in str(e.value)
    data = (FIXTURES / "port_video.gif").read_bytes()
    for cut in (8, 400, len(data) // 2):
        bad = tmp_path / f"cut{cut}.gif"
        bad.write_bytes(data[:cut])
        for fn in (read_gif_frames, read_image):
            with pytest.raises(ValueError) as e:
                fn(bad)
            assert str(bad) in str(e.value) and "GIF" in str(e.value)


def test_twins_import_no_jax_pil_or_cv2():
    """The twins and the decoder run where none of JAX, the JAX package,
    PIL or OpenCV is installed."""
    code = ("import sys\n"
            f"sys.path.insert(0, {str(REPO / 'scripts')!r})\n"
            "import eval_videos_torch, extract_frames_torch\n"
            f"eval_videos_torch.sample_frames({str(FIXTURES / 'port_video.gif')!r}, 4)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'adaface_tpu', 'cv2', 'PIL'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=REPO)
