"""The port's numpy target encoding against the JAX package's gaussian
helpers, and ``encode_targets`` against the data pipeline's encoding of
one box worked by hand."""

import numpy as np
import pytest

from centernet_uda_tpu.ops import gaussian as jg
from centernet_uda_torch.ops import gaussian as tg


@pytest.mark.parametrize("size", [(3.0, 5.0), (17.0, 9.5), (40.0, 41.0)])
def test_gaussian_radius_and_patch(size):
    assert tg.gaussian_radius(size) == jg.gaussian_radius(size)
    r = max(0, int(tg.gaussian_radius(size)))
    d = 2 * r + 1
    np.testing.assert_array_equal(tg.gaussian_2d((d, d), d / 6),
                                  jg.gaussian_2d((d, d), d / 6))


def test_draw_gaussian_clips_at_the_border():
    a = np.zeros((12, 10), np.float32)
    b = np.zeros((12, 10), np.float32)
    for center, radius in (((0, 0), 3), ((9, 11), 4), ((5, 6), 2)):
        tg.draw_gaussian(a, center, radius)
        jg.draw_gaussian(b, center, radius)
    np.testing.assert_array_equal(a, b)


def test_encode_targets_one_box():
    boxes = np.array([[2.0, 3.0, 10.0, 7.0], [5.0, 5.0, 5.0, 9.0]],
                     np.float32)  # the second has zero width: skipped
    t = tg.encode_targets(boxes, [1, 0], 16, 20, 3, 5)
    assert t["hm"].shape == (3, 16, 20)
    ct = np.array([6.0, 5.0])
    assert t["ind"][0] == 5 * 20 + 6
    np.testing.assert_allclose(t["wh"][0], [8.0, 4.0])
    np.testing.assert_allclose(t["reg"][0], ct - ct.astype(int))
    assert t["hm"][1, 5, 6] == 1.0 and t["hm"][0].max() == 0.0
    np.testing.assert_allclose(t["gt_dets"][0], [2, 3, 10, 7, 1, 1])
    assert t["gt_areas"][0] == 32.0
    np.testing.assert_array_equal(t["reg_mask"], [1, 0, 0, 0, 0])
    r = int(jg.gaussian_radius((4.0, 8.0)))
    want = np.zeros((16, 20), np.float32)
    jg.draw_gaussian(want, (6, 5), r)
    np.testing.assert_array_equal(t["hm"][1], want)
