"""The port's decode against the JAX package's (CPU, float32), on heatmaps
with distinct scores: top-k tie order differs between frameworks by design
(PARITY.md "Known deviations"), distinct scores define it on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.ops import decode as jd
from centernet_uda_torch.ops import decode as td

torch.set_num_threads(2)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def distinct_scores(rng, b, h, w, c):
    vals = rng.permutation(b * h * w * c).astype(np.float32)
    return (vals / vals.size).reshape(b, h, w, c) * 0.98 + 0.01


def test_nms_peaks_matches_jax():
    heat = distinct_scores(np.random.RandomState(0), 2, 12, 10, 3)
    want = np.asarray(jd.nms_peaks(jnp.asarray(heat)))
    got = np.moveaxis(td.nms_peaks(nchw(heat)).numpy(), 1, -1)
    np.testing.assert_array_equal(got, want)


def test_top_k_peaks_matches_jax():
    scores = distinct_scores(np.random.RandomState(1), 2, 12, 10, 3)
    want = [np.asarray(v) for v in jd.top_k_peaks(jnp.asarray(scores), 15)]
    got = [v.numpy() for v in td.top_k_peaks(nchw(scores), 15)]
    for name, a, b in zip(("score", "inds", "classes", "ys", "xs"), got,
                          want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("with_reg", [True, False])
def test_decode_detections_matches_jax(with_reg):
    rng = np.random.RandomState(2)
    b, h, w, c, k = 2, 16, 16, 4, 20
    hm = rng.randn(b, h, w, c).astype(np.float32)
    wh = (rng.rand(b, h, w, 2) * 8).astype(np.float32)
    reg = rng.rand(b, h, w, 2).astype(np.float32) if with_reg else None
    want = np.asarray(jd.decode_detections(
        jnp.asarray(hm), jnp.asarray(wh),
        None if reg is None else jnp.asarray(reg), k=k, apply_sigmoid=True))
    assert all(len(np.unique(want[i, :, 4])) == k for i in range(b))
    got = td.decode_detections(nchw(hm), nchw(wh),
                               None if reg is None else nchw(reg), k=k,
                               apply_sigmoid=True).numpy()
    assert got.shape == (b, k, 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_top_k_beyond_map_raises():
    with pytest.raises(ValueError):
        td.top_k_peaks(torch.rand(1, 2, 3, 3), 10)
