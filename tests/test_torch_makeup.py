"""The port's copy of the makeup recolor (`adaface_tpu_torch/utils/
makeup.py`) and the face parser's overlay helpers (`train/
face_parsing_train.py`: `parsing_palette`, `colorize_parsing`,
`overlay_parsing`) against the JAX package's, bit for bit on seeded
arrays."""

import numpy as np
import pytest

from adaface_tpu.train import face_parsing_train as jtrain
from adaface_tpu.utils import makeup as jmakeup
from adaface_tpu_torch.train import face_parsing_train as ttrain
from adaface_tpu_torch.utils import makeup as tmakeup
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)


def face(seed: int, hw=(48, 40)):
    rs = np.random.RandomState(seed)
    image = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    parsing = rs.randint(0, 19, hw)
    parsing[:8] = 17  # a band of hair, lips below it
    parsing[-6:, :10] = 12
    parsing[-6:, 10:20] = 13
    return image, parsing


def test_color_spaces_and_sharpen_equal_jax():
    rs = np.random.RandomState(0)
    rgb = rs.rand(7, 9, 3)
    rgb[0, 0] = 0.0  # black, grey and saturated corners
    rgb[0, 1] = 0.5
    rgb[0, 2] = (1.0, 0.0, 0.0)
    np.testing.assert_array_equal(tmakeup.rgb_to_hsv(rgb), jmakeup.rgb_to_hsv(rgb))
    hsv = tmakeup.rgb_to_hsv(rgb)
    np.testing.assert_array_equal(tmakeup.hsv_to_rgb(hsv), jmakeup.hsv_to_rgb(hsv))
    img = rs.randint(0, 256, (30, 22, 3)).astype(np.float64)
    for sigma, alpha in ((5.0, 1.5), (1.0, 0.5)):
        np.testing.assert_array_equal(tmakeup.sharpen(img, sigma, alpha),
                                      jmakeup.sharpen(img, sigma, alpha))


@pytest.mark.parametrize("part, color", [(17, (100, 200, 100)), (12, (230, 50, 20)),
                                         (13, (10, 10, 240)), (1, (200, 150, 120))])
def test_recolor_part_equals_jax(part, color):
    image, parsing = face(part)
    out = tmakeup.recolor_part(image, parsing, part, color)
    np.testing.assert_array_equal(out, jmakeup.recolor_part(image, parsing, part, color))
    keep = parsing != part
    np.testing.assert_array_equal(out[keep], image[keep])


def test_apply_makeup_equals_jax():
    image, parsing = face(7)
    spec = {"hair": (100, 200, 100), "upper_lip": (230, 50, 20), 13: (170, 20, 60)}
    out = tmakeup.apply_makeup(image, parsing, spec)
    np.testing.assert_array_equal(out, jmakeup.apply_makeup(image, parsing, spec))
    untouched = ~np.isin(parsing, [17, 12, 13])
    np.testing.assert_array_equal(out[untouched], image[untouched])
    assert tmakeup.MAKEUP_PARTS == jmakeup.MAKEUP_PARTS


def test_parsing_overlays_equal_jax():
    for n in (19, 5):
        np.testing.assert_array_equal(ttrain.parsing_palette(n), jtrain.parsing_palette(n))
    image, parsing = face(3)
    parsing[0, 0], parsing[0, 1] = -4, 40  # clipped to the palette
    np.testing.assert_array_equal(ttrain.colorize_parsing(parsing),
                                  jtrain.colorize_parsing(parsing))
    for alpha in (0.6, 0.25):
        np.testing.assert_array_equal(ttrain.overlay_parsing(image, parsing, alpha),
                                      jtrain.overlay_parsing(image, parsing, alpha))
