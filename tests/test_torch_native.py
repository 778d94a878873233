"""The port's native item pipeline (`adaface_tpu_torch.native.prepare_item`)
against its numpy reference and against the JAX package's native library.

The port's `imgops.cpp` is the JAX package's with two changes. It divides by
127.5 where JAX's copy multiplies by the reciprocal, so that it gives the
numpy path's bits: against JAX's library the images agree to one float32
rounding (their uint8 pixels are equal). And its shrunken mask lies past the
lane it is resized from: JAX's copy writes it over that lane and corrupts the
fg mask for scales in (0.866, 0.999), so the comparison with JAX's library
takes only scales outside that range (the numpy comparison takes 0.9985 and
0.999 too); there the masks agree exactly.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from adaface_tpu_torch import native
from adaface_tpu_torch.data import personalized
from adaface_tpu_torch.data.personalized import PersonalizedBase, augment_numpy
from adaface_tpu_torch.utils.image import resize_nearest_pil

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "images")


CASES = [(False, 1.0, 0, 0), (True, 1.0, 0, 0), (False, 0.5, 0, 0), (True, 0.75, 5, -3),
         (True, 0.4, -8, 8), (False, 0.9985, 3, 1), (True, 0.999, 0, 7), (False, 0.12, 1, 1)]


@pytest.mark.parametrize("size", [64, 120, 512])
@pytest.mark.parametrize("with_fg", [True, False])
def test_prepare_item_equals_numpy_path(size, with_fg):
    rs = np.random.RandomState(size)
    img = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
    fg = (rs.rand(size, size) > 0.5).astype(np.float32) if with_fg else None
    for do_flip, scale, dy, dx in CASES:
        got = native.prepare_item(img, fg, size, do_flip, scale, dy, dx)
        want = augment_numpy(img.copy(), None if fg is None else fg.copy(), size, do_flip,
                             scale, dy, dx)
        for g, w, what in zip(got, want, ("image", "fg", "aug")):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {do_flip} {scale} {dy} {dx}")


def test_prepare_item_matches_jax_native():
    """The cases of `tests/test_native.py` through both libraries."""
    from PIL import Image

    from adaface_tpu.native import load_imgops, prepare_item_native

    if load_imgops() is None:
        pytest.fail("the JAX package's native library did not build")
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, (100, 100, 3), np.uint8)
    fg = (rs.rand(100, 100) > 0.5).astype(np.float32)
    s = 64
    img64 = resize_nearest_pil(img, (s, s))
    np.testing.assert_array_equal(img64, np.asarray(Image.fromarray(img).resize((s, s),
                                                                               Image.NEAREST)))
    fg64 = (resize_nearest_pil((fg * 255).astype(np.uint8), (s, s)) > 127).astype(np.float32)
    for do_flip, scale, dy, dx in [(False, 1.0, 0, 0), (True, 1.0, 0, 0), (False, 0.5, 0, 0),
                                   (True, 0.75, 5, -3)]:
        j_img, j_fg, j_aug = prepare_item_native(img64, (fg64 * 255).astype(np.uint8), s,
                                                 do_flip, scale, dy, dx)
        t_img, t_fg, t_aug = native.prepare_item(img64, fg64, s, do_flip, scale, dy, dx)
        np.testing.assert_array_equal(t_fg, j_fg)
        np.testing.assert_array_equal(t_aug, j_aug)
        np.testing.assert_allclose(t_img, j_img, rtol=0, atol=np.finfo(np.float32).eps)
        np.testing.assert_array_equal(np.rint((t_img + 1) * 127.5), np.rint((j_img + 1) * 127.5))


@pytest.fixture()
def mixed_root(tmp_path):
    """A subject folder of PNG, JPEG and BMP photos, one with a mask; item 0
    is the PNG."""
    subj = tmp_path / "subj"
    subj.mkdir()
    for name in ("baseline_420.jpg", "progressive_444.jpg", "rgb24.bmp", "paletted8.bmp"):
        shutil.copy(os.path.join(FIXTURES, name), subj / name)
    shutil.copy(os.path.join(FIXTURES, "face_parser", "labels", "0.png"), subj / "a_label.png")
    shutil.copy(os.path.join(FIXTURES, "face_parser", "labels", "1.png"),
                subj / "rgb24_mask.png")
    return str(tmp_path)


def test_dataset_native_equals_numpy(mixed_root, monkeypatch):
    """Items of a folder that mixes formats, native against the numpy
    reference put in its place, the same draws from the same seed."""
    a = PersonalizedBase(mixed_root, size=96, seed=5)
    b = PersonalizedBase(mixed_root, size=96, seed=5)
    assert len(a) == 5
    items_a = [a[i] for i in range(2 * len(a))]
    monkeypatch.setattr(personalized.native, "prepare_item", augment_numpy)
    items_b = [b[i] for i in range(2 * len(b))]
    for i, (ea, eb) in enumerate(zip(items_a, items_b)):
        for key in ("image", "fg_mask", "aug_mask"):
            np.testing.assert_array_equal(ea[key], eb[key], err_msg=f"{i} {key}")
        assert ea["subj_single_prompt"] == eb["subj_single_prompt"]


def test_dataset_refuses_a_webp(tmp_path):
    subj = tmp_path / "subj"
    subj.mkdir()
    shutil.copy(os.path.join(FIXTURES, "reject.webp"), subj / "a.webp")
    ds = PersonalizedBase(str(tmp_path), size=32, seed=0)
    with pytest.raises(ValueError, match="a.webp"):
        ds[0]


def test_use_native_raises_when_the_build_fails(mixed_root, tmp_path, monkeypatch):
    """No silent fallback to numpy: a compiler that cannot run makes the
    item raise, also for a PNG, which the port's reader decodes without the
    library."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load_library.cache_clear()
    try:
        ds = PersonalizedBase(mixed_root, size=32, seed=0)
        assert ds.subjects[0].image_paths[0].endswith(".png")
        with pytest.raises(RuntimeError, match="could not be built"):
            ds[0]
        with pytest.raises(RuntimeError, match="could not be built"):
            native.resize_bilinear_pil(np.zeros((4, 4, 3), np.uint8), (8, 8))
    finally:
        native.load_library.cache_clear()
