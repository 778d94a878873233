"""Pillow's BILINEAR, BICUBIC and LANCZOS resizes in the port without PIL:
`utils.image.resize_pil` (numpy) and `native.resize_pil` (the host
library's passes) against the installed Pillow, bit for bit, on RGB and L
images that shrink (by up to 9×, where the filters widen), grow, keep an
axis, or reach a side of 1."""

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch import native
from adaface_tpu_torch.utils.image import PIL_FILTERS, _pil_coeffs, resize_pil
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

FILTERS = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}
SHAPES = ((100, 120, 3), (37, 91), (5, 3, 3), (1, 7, 3), (300, 280, 3), (512, 512))


def sizes(shape) -> list:
    return [(75, 90), (448, 448), (13, 200), (1, 1), (shape[1], 60), (3, shape[0]),
            (max(shape[1] // 9, 1), max(shape[0] // 7, 1)), (224, 224)]


@pytest.mark.parametrize("resample", sorted(FILTERS))
def test_resize_pil_equals_pillow(resample):
    rs = np.random.RandomState(3)
    for shape in SHAPES:
        img = rs.randint(0, 256, shape).astype(np.uint8)
        for size in sizes(shape):
            want = np.asarray(Image.fromarray(img).resize(size, FILTERS[resample]))
            np.testing.assert_array_equal(resize_pil(img, size, resample), want,
                                          err_msg=f"{resample} {shape} -> {size}")
            np.testing.assert_array_equal(native.resize_pil(img, size, resample), want,
                                          err_msg=f"native {resample} {shape} -> {size}")


def test_default_filter_is_pillows_bicubic():
    """`Image.resize` without a filter is BICUBIC in Pillow 12 (the mask
    tool's resize); the port names its filter, and its default stays the
    face parser's BILINEAR."""
    img = np.random.RandomState(4).randint(0, 256, (130, 70, 3)).astype(np.uint8)
    np.testing.assert_array_equal(native.resize_pil(img, (64, 64), "bicubic"),
                                  np.asarray(Image.fromarray(img).resize((64, 64))))
    np.testing.assert_array_equal(native.resize_pil(img, (64, 64)),
                                  np.asarray(Image.fromarray(img).resize((64, 64), Image.BILINEAR)))


def test_filters_have_negative_lobes_and_refuse_others():
    """Bicubic and Lanczos weights go below 0 (the passes clamp), the
    triangle's do not; a filter Pillow has and the port does not is refused
    by name."""
    for name in PIL_FILTERS:
        _, w = _pil_coeffs(64, 29, name)
        assert (w.sum(axis=1) - (1 << 22)).__abs__().max() <= w.shape[1]
        assert (w.min() < 0) == (name != "bilinear")
    with pytest.raises(ValueError, match="hamming"):
        resize_pil(np.zeros((4, 4), np.uint8), (2, 2), "hamming")
