"""Image augmentation with an imgaug-compatible YAML registry.

A copy of ``centernet_uda_tpu/data/augment.py``. The reference instantiates
``imgaug.augmenters.<Name>(**params)`` by reflection from the experiment
YAML (utils/helper.py:53-71) and composes them with ``iaa.Sequential``;
this module implements the augmenters the reference configs use — same
names, same parameter spellings, same range-sampling semantics (a 2-list in
YAML is a uniform range) — in numpy + OpenCV, and draws from the numpy
``RandomState`` passed in, in the JAX package's order, so one seed gives
the same images and boxes in both packages.

OpenCV is imported by each augmenter that calls it (``_cv2``), not when this
module is imported: ``Fliplr``, ``Flipud``, ``AdditiveGaussianNoise`` and
the other pure-numpy augmenters run without it.

Geometry is tracked jointly: every augmenter transforms the image and the
attached boxes (N, 4 as x1y1x2y2) / keypoints (M, 2) consistently; affine
ops transform box corners and re-fit the axis-aligned envelope exactly like
imgaug's BoundingBox behavior.

Registry entry point: ``instantiate_augmenters(list_cfg) -> Sequential``
(twin of utils/helper.py:53-71).
"""

from __future__ import annotations

import functools
import logging
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

log = logging.getLogger(__name__)

Range = Union[float, int, Tuple[float, float], List[float]]


@functools.lru_cache(maxsize=None)
def _cv2():
    """OpenCV, with its own thread pool off: the loader's workers already
    run augmenters in parallel (datasets/coco.py:19)."""
    import cv2

    cv2.setNumThreads(0)
    return cv2


def _sample(param: Range, rng: np.random.RandomState) -> float:
    """imgaug-style stochastic parameter: scalar = deterministic, 2-seq = uniform."""
    if isinstance(param, (tuple, list)):
        lo, hi = float(param[0]), float(param[1])
        return float(rng.uniform(lo, hi))
    return float(param)


def _sample_int(param: Range, rng: np.random.RandomState) -> int:
    if isinstance(param, (tuple, list)):
        lo, hi = int(param[0]), int(param[1])
        return int(rng.randint(lo, hi + 1))
    return int(param)


class Augmenter:
    """Base: ``__call__(image, boxes, keypoints, rng)`` -> transformed triple."""

    def __call__(
        self,
        image: np.ndarray,
        boxes: Optional[np.ndarray] = None,
        keypoints: Optional[np.ndarray] = None,
        rng: Optional[np.random.RandomState] = None,
    ):
        rng = rng or np.random
        return self.apply(image, boxes, keypoints, rng)

    def apply(self, image, boxes, keypoints, rng):  # pragma: no cover
        raise NotImplementedError


class Sequential(Augmenter):
    def __init__(self, children: Sequence[Augmenter]):
        self.children = list(children)

    def apply(self, image, boxes, keypoints, rng):
        for child in self.children:
            image, boxes, keypoints = child.apply(image, boxes, keypoints, rng)
        return image, boxes, keypoints


class Sometimes(Augmenter):
    """Apply ``then_list`` with probability ``p`` (imgaug.Sometimes)."""

    def __init__(self, p: float = 0.5, then_list: Sequence[Augmenter] = ()):
        self.p = float(p)
        self.then = Sequential(then_list)

    def apply(self, image, boxes, keypoints, rng):
        if rng.rand() < self.p:
            return self.then.apply(image, boxes, keypoints, rng)
        return image, boxes, keypoints


class _AffineBase(Augmenter):
    """Shared machinery: apply a 2x3 matrix to image + boxes + keypoints."""

    @staticmethod
    def warp(image, boxes, keypoints, m: np.ndarray, out_wh=None):
        cv2 = _cv2()
        h, w = image.shape[:2]
        out_w, out_h = out_wh if out_wh is not None else (w, h)
        image = cv2.warpAffine(
            image, m, (out_w, out_h), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )

        def tx(pts):  # (N, 2) points
            ones = np.ones((pts.shape[0], 1), pts.dtype)
            return np.concatenate([pts, ones], axis=1) @ m.T

        if boxes is not None and len(boxes):
            corners = np.stack(
                [
                    boxes[:, [0, 1]], boxes[:, [2, 1]],
                    boxes[:, [2, 3]], boxes[:, [0, 3]],
                ],
                axis=1,
            ).reshape(-1, 2)
            corners = tx(corners.astype(np.float64)).reshape(-1, 4, 2)
            boxes = np.concatenate(
                [corners.min(axis=1), corners.max(axis=1)], axis=1
            ).astype(np.float32)
        if keypoints is not None and len(keypoints):
            keypoints = tx(keypoints.astype(np.float64)).astype(np.float32)
        return image, boxes, keypoints


class Affine(_AffineBase):
    """imgaug.Affine subset: translate_percent, scale, rotate, shear.

    Scale and rotation are about the image center; translation is a fraction
    of the image size (imgaug semantics for the reference config at
    configs/defaults.yaml:49-52).
    """

    def __init__(self, translate_percent: Range = 0.0, scale: Range = 1.0,
                 rotate: Range = 0.0, shear: Range = 0.0):
        self.translate_percent = translate_percent
        self.scale = scale
        self.rotate = rotate
        self.shear = shear

    def apply(self, image, boxes, keypoints, rng):
        h, w = image.shape[:2]
        s = _sample(self.scale, rng)
        r = math.radians(_sample(self.rotate, rng))
        sh = math.radians(_sample(self.shear, rng))
        # imgaug samples ONE translate fraction per image and applies it to
        # both axes when given a scalar/range; a dict gives per-axis ranges
        if isinstance(self.translate_percent, dict):
            tx = _sample(self.translate_percent.get("x", 0.0), rng) * w
            ty = _sample(self.translate_percent.get("y", 0.0), rng) * h
        else:
            frac = _sample(self.translate_percent, rng)
            tx = frac * w
            ty = frac * h

        cx, cy = w / 2.0, h / 2.0
        cos_r, sin_r = math.cos(r), math.sin(r)
        # rotate+shear+scale about center, then translate
        a = s * cos_r
        b = s * -math.sin(r + sh)
        c = s * sin_r
        d = s * math.cos(r + sh)
        m = np.array(
            [
                [a, b, cx - a * cx - b * cy + tx],
                [c, d, cy - c * cx - d * cy + ty],
            ],
            np.float64,
        )
        return self.warp(image, boxes, keypoints, m)


class Fliplr(Augmenter):
    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def apply(self, image, boxes, keypoints, rng):
        if rng.rand() >= self.p:
            return image, boxes, keypoints
        w = image.shape[1]
        image = np.ascontiguousarray(image[:, ::-1])
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            x1 = w - boxes[:, 2]
            x2 = w - boxes[:, 0]
            boxes[:, 0], boxes[:, 2] = x1, x2
        if keypoints is not None and len(keypoints):
            keypoints = keypoints.copy()
            keypoints[:, 0] = w - keypoints[:, 0]
        return image, boxes, keypoints


class Flipud(Augmenter):
    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def apply(self, image, boxes, keypoints, rng):
        if rng.rand() >= self.p:
            return image, boxes, keypoints
        h = image.shape[0]
        image = np.ascontiguousarray(image[::-1])
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            y1 = h - boxes[:, 3]
            y2 = h - boxes[:, 1]
            boxes[:, 1], boxes[:, 3] = y1, y2
        if keypoints is not None and len(keypoints):
            keypoints = keypoints.copy()
            keypoints[:, 1] = h - keypoints[:, 1]
        return image, boxes, keypoints


class Crop(_AffineBase):
    """imgaug.Crop(percent=...): crop each side by an independently sampled
    percentage, then resize back to the original size (keep_size=True)."""

    def __init__(self, percent: Range = 0.0, sample_independently: bool = True):
        self.percent = percent
        self.sample_independently = sample_independently

    def apply(self, image, boxes, keypoints, rng):
        h, w = image.shape[:2]
        if self.sample_independently:
            fracs = [_sample(self.percent, rng) for _ in range(4)]
        else:
            fracs = [_sample(self.percent, rng)] * 4
        top, right, bottom, left = fracs
        t, r_, b, l_ = (int(top * h), int(right * w), int(bottom * h), int(left * w))
        new_h, new_w = max(h - t - b, 1), max(w - l_ - r_, 1)

        sx, sy = w / new_w, h / new_h
        m = np.array([[sx, 0, -l_ * sx], [0, sy, -t * sy]], np.float64)
        return self.warp(image, boxes, keypoints, m, out_wh=(w, h))


class Resize(_AffineBase):
    """Deterministic resize to (height, width) — the reference wraps its
    square input_size in iaa.Resize (datasets/coco.py:64-67)."""

    def __init__(self, size):
        if isinstance(size, (int, float)):
            size = (int(size), int(size))
        self.height, self.width = int(size[0]), int(size[1])

    def apply(self, image, boxes, keypoints, rng):
        h, w = image.shape[:2]
        if (h, w) == (self.height, self.width):
            # what cv2.resize gives at the same size: a copy
            return image, boxes, keypoints
        cv2 = _cv2()
        sx, sy = self.width / w, self.height / h
        image = cv2.resize(image, (self.width, self.height),
                           interpolation=cv2.INTER_LINEAR)
        if boxes is not None and len(boxes):
            boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
        if keypoints is not None and len(keypoints):
            keypoints = keypoints * np.array([sx, sy], np.float32)
        return image, boxes, keypoints

    def scale_points(self, points: np.ndarray, src_hw) -> np.ndarray:
        """Rescale points alone (the reference's resize_out on targets,
        datasets/coco.py:186-189)."""
        sy, sx = self.height / src_hw[0], self.width / src_hw[1]
        return points * np.array([sx, sy], np.float32)


class AddToHue(Augmenter):
    def __init__(self, value: Range = (-20, 20)):
        self.value = value

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        v = _sample(self.value, rng)
        hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV_FULL).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(v)) % 256
        image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB_FULL)
        return image, boxes, keypoints


class AddToBrightness(Augmenter):
    def __init__(self, add: Range = (-30, 30)):
        self.add = add

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        v = _sample(self.add, rng)
        hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.int16)
        hsv[..., 2] = np.clip(hsv[..., 2] + int(v), 0, 255)
        image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return image, boxes, keypoints


def _apply_pointwise_u8(image, fn):
    """Apply a scalar float map to a uint8 image via a 256-entry LUT —
    identical output to the float-convert/clip/truncate path (the LUT
    precomputes exactly that per value), one pass instead of three."""
    cv2 = _cv2()
    if image.dtype == np.uint8:
        lut = np.clip(fn(np.arange(256, dtype=np.float32)),
                      0, 255).astype(np.uint8)
        return cv2.LUT(image, lut)
    return np.clip(fn(image.astype(np.float32)), 0, 255).astype(np.uint8)


class Multiply(Augmenter):
    def __init__(self, mul: Range = (0.8, 1.2)):
        self.mul = mul

    def apply(self, image, boxes, keypoints, rng):
        m = _sample(self.mul, rng)
        return _apply_pointwise_u8(image, lambda v: v * m), boxes, keypoints


class LinearContrast(Augmenter):
    def __init__(self, alpha: Range = (0.9, 1.1)):
        self.alpha = alpha

    def apply(self, image, boxes, keypoints, rng):
        a = _sample(self.alpha, rng)
        return (_apply_pointwise_u8(image, lambda v: (v - 127) * a + 127),
                boxes, keypoints)


class MotionBlur(Augmenter):
    def __init__(self, k: Range = 5, angle: Range = (0, 360)):
        self.k = k
        self.angle = angle

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        k = max(_sample_int(self.k, rng), 3)
        angle = _sample(self.angle, rng)
        kernel = np.zeros((k, k), np.float32)
        kernel[k // 2, :] = 1.0
        m = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), angle, 1.0)
        kernel = cv2.warpAffine(kernel, m, (k, k))
        kernel /= max(kernel.sum(), 1e-8)
        image = cv2.filter2D(image, -1, kernel)
        return image, boxes, keypoints


class GaussianBlur(Augmenter):
    def __init__(self, sigma: Range = (0.0, 2.0)):
        self.sigma = sigma

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        s = _sample(self.sigma, rng)
        if s > 1e-3:
            image = cv2.GaussianBlur(image, (0, 0), sigmaX=s)
        return image, boxes, keypoints


class AdditiveGaussianNoise(Augmenter):
    def __init__(self, scale: Range = (0, 10), per_channel: bool = False):
        self.scale = scale
        self.per_channel = per_channel

    def apply(self, image, boxes, keypoints, rng):
        s = _sample(self.scale, rng)
        noise = rng.randn(*image.shape).astype(np.float32) * s
        image = np.clip(image.astype(np.float32) + noise, 0, 255).astype(np.uint8)
        return image, boxes, keypoints


class Grayscale(Augmenter):
    def __init__(self, alpha: Range = 1.0):
        self.alpha = alpha

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        a = _sample(self.alpha, rng)
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)[..., None].astype(np.float32)
        image = np.clip(
            image.astype(np.float32) * (1 - a) + gray * a, 0, 255
        ).astype(np.uint8)
        return image, boxes, keypoints


class Rotate(Affine):
    def __init__(self, rotate: Range = (-30, 30)):
        super().__init__(rotate=rotate)


class Add(Augmenter):
    """imgaug.Add: add a (possibly per-channel) constant to all pixels."""

    def __init__(self, value: Range = (-20, 20), per_channel: bool = False):
        self.value = value
        self.per_channel = per_channel

    def apply(self, image, boxes, keypoints, rng):
        if self.per_channel and image.ndim == 3:
            v = np.array([_sample(self.value, rng)
                          for _ in range(image.shape[2])], np.float32)
            image = np.clip(image.astype(np.float32) + v, 0, 255)
            return image.astype(np.uint8), boxes, keypoints
        v = _sample(self.value, rng)
        return _apply_pointwise_u8(image, lambda q: q + v), boxes, keypoints


class AddToSaturation(Augmenter):
    def __init__(self, value: Range = (-30, 30)):
        self.value = value

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        v = _sample(self.value, rng)
        hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.int16)
        hsv[..., 1] = np.clip(hsv[..., 1] + int(v), 0, 255)
        image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return image, boxes, keypoints


class Sharpen(Augmenter):
    """imgaug.Sharpen: blend the image with a sharpening kernel response.

    kernel = (1-alpha)*identity + alpha*[[-1,-1,-1],[-1,8+lightness,-1],
    [-1,-1,-1]] — matching imgaug's matrix construction, so YAML params
    (``alpha``, ``lightness``) carry over unchanged."""

    def __init__(self, alpha: Range = (0.0, 0.2),
                 lightness: Range = (0.8, 1.2)):
        self.alpha = alpha
        self.lightness = lightness

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        a = _sample(self.alpha, rng)
        light = _sample(self.lightness, rng)
        ident = np.zeros((3, 3), np.float32)
        ident[1, 1] = 1.0
        effect = np.full((3, 3), -1.0, np.float32)
        effect[1, 1] = 8.0 + light
        kernel = (1.0 - a) * ident + a * effect
        image = cv2.filter2D(image, -1, kernel)
        return np.clip(image, 0, 255).astype(np.uint8), boxes, keypoints


class Dropout(Augmenter):
    """imgaug.Dropout: zero each pixel independently with probability p."""

    def __init__(self, p: Range = (0.0, 0.05), per_channel: bool = False):
        self.p = p
        self.per_channel = per_channel

    def apply(self, image, boxes, keypoints, rng):
        p = _sample(self.p, rng)
        if p <= 0:
            return image, boxes, keypoints
        shape = image.shape if self.per_channel else image.shape[:2]
        keep = (rng.rand(*shape) >= p)
        if not self.per_channel and image.ndim == 3:
            keep = keep[..., None]
        return (image * keep).astype(np.uint8), boxes, keypoints


class CoarseDropout(Augmenter):
    """imgaug.CoarseDropout: drop rectangular regions by sampling the
    per-pixel dropout mask at ``size_percent`` of the image resolution and
    upscaling it (nearest), so dropped cells form coarse blocks."""

    def __init__(self, p: Range = 0.1, size_percent: Range = (0.02, 0.1),
                 per_channel: bool = False):
        self.p = p
        self.size_percent = size_percent
        self.per_channel = per_channel

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        p = _sample(self.p, rng)
        sp = _sample(self.size_percent, rng)
        if p <= 0 or sp <= 0:
            return image, boxes, keypoints
        h, w = image.shape[:2]
        mh, mw = max(int(h * sp), 1), max(int(w * sp), 1)
        n_ch = image.shape[2] if (self.per_channel and image.ndim == 3) else 1
        keep = (rng.rand(mh, mw, n_ch) >= p).astype(np.uint8)
        keep = cv2.resize(keep, (w, h), interpolation=cv2.INTER_NEAREST)
        if keep.ndim == 2:
            keep = keep[..., None] if image.ndim == 3 else keep
        return (image * keep).astype(np.uint8), boxes, keypoints


class GammaContrast(Augmenter):
    """imgaug.GammaContrast: v' = 255 * (v/255)^gamma."""

    def __init__(self, gamma: Range = (0.7, 1.7)):
        self.gamma = gamma

    def apply(self, image, boxes, keypoints, rng):
        g = _sample(self.gamma, rng)
        return (_apply_pointwise_u8(
            image, lambda v: np.power(v / 255.0, g) * 255.0),
            boxes, keypoints)


class SigmoidContrast(Augmenter):
    """imgaug.SigmoidContrast: v' = 255/(1+exp(gain*(cutoff - v/255)))."""

    def __init__(self, gain: Range = (5, 20), cutoff: Range = (0.25, 0.75)):
        self.gain = gain
        self.cutoff = cutoff

    def apply(self, image, boxes, keypoints, rng):
        gain = _sample(self.gain, rng)
        cut = _sample(self.cutoff, rng)
        return (_apply_pointwise_u8(
            image, lambda v: 255.0 / (1.0 + np.exp(gain * (cut - v / 255.0)))),
            boxes, keypoints)


class AverageBlur(Augmenter):
    def __init__(self, k: Range = (1, 7)):
        self.k = k

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        k = _sample_int(self.k, rng)
        if k > 1:
            image = cv2.blur(image, (k, k))
        return image, boxes, keypoints


class MedianBlur(Augmenter):
    def __init__(self, k: Range = (1, 7)):
        self.k = k

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        k = _sample_int(self.k, rng)
        if k > 1:
            image = cv2.medianBlur(image, k | 1)  # cv2 needs odd k
        return image, boxes, keypoints


class SaltAndPepper(Augmenter):
    """imgaug.SaltAndPepper: replace each pixel with 0 or 255 (equal odds)
    with probability p."""

    def __init__(self, p: Range = (0.0, 0.03), per_channel: bool = False):
        self.p = p
        self.per_channel = per_channel

    def apply(self, image, boxes, keypoints, rng):
        p = _sample(self.p, rng)
        if p <= 0:
            return image, boxes, keypoints
        shape = image.shape if (self.per_channel and image.ndim == 3
                                ) else image.shape[:2]
        u = rng.rand(*shape)
        hit = u < p
        salt = u < p / 2.0
        if shape == image.shape[:2] and image.ndim == 3:
            hit, salt = hit[..., None], salt[..., None]
        out = np.where(hit, np.where(salt, 255, 0), image)
        return out.astype(np.uint8), boxes, keypoints


class Invert(Augmenter):
    """imgaug.Invert(p): per-image probability of v' = 255 - v."""

    def __init__(self, p: float = 1.0, per_channel: bool = False):
        self.p = float(p)
        self.per_channel = per_channel

    def apply(self, image, boxes, keypoints, rng):
        if self.per_channel and image.ndim == 3:
            flip = rng.rand(image.shape[2]) < self.p
            out = image.copy()
            out[..., flip] = 255 - out[..., flip]
            return out, boxes, keypoints
        if rng.rand() < self.p:
            image = (255 - image.astype(np.int16)).astype(np.uint8)
        return image, boxes, keypoints


class Solarize(Augmenter):
    """imgaug.Solarize(p, threshold): invert pixels >= threshold, applied
    per image with probability p."""

    def __init__(self, p: float = 1.0, threshold: Range = 128):
        self.p = float(p)
        self.threshold = threshold

    def apply(self, image, boxes, keypoints, rng):
        if rng.rand() >= self.p:
            return image, boxes, keypoints
        t = _sample(self.threshold, rng)
        inv = (255 - image.astype(np.int16)).astype(np.uint8)
        return np.where(image >= t, inv, image), boxes, keypoints


class Posterize(Augmenter):
    """imgaug.Posterize: quantize to ``nb_bits`` bits per channel."""

    def __init__(self, nb_bits: Range = (1, 8)):
        self.nb_bits = nb_bits

    def apply(self, image, boxes, keypoints, rng):
        bits = int(np.clip(_sample_int(self.nb_bits, rng), 1, 8))
        if bits >= 8:
            return image, boxes, keypoints
        mask = np.uint8((0xFF << (8 - bits)) & 0xFF)
        return image & mask, boxes, keypoints


class JpegCompression(Augmenter):
    """imgaug.JpegCompression: encode/decode at quality 100-compression."""

    def __init__(self, compression: Range = (70, 99)):
        self.compression = compression

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        c = int(np.clip(_sample(self.compression, rng), 0, 100))
        quality = 100 - c
        ok, buf = cv2.imencode(
            ".jpg", image[..., ::-1] if image.ndim == 3 else image,
            [cv2.IMWRITE_JPEG_QUALITY, max(quality, 1)])
        if not ok:
            return image, boxes, keypoints
        dec = cv2.imdecode(buf, cv2.IMREAD_COLOR if image.ndim == 3
                           else cv2.IMREAD_GRAYSCALE)
        if image.ndim == 3:
            dec = dec[..., ::-1]
        return np.ascontiguousarray(dec), boxes, keypoints


class AddToHueAndSaturation(Augmenter):
    """imgaug.AddToHueAndSaturation: one sampled value added to H (imgaug's
    angular wrap) and S (clipped)."""

    def __init__(self, value: Range = (-30, 30), per_channel: bool = False):
        self.value = value
        self.per_channel = per_channel

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        vh = _sample(self.value, rng)
        vs = _sample(self.value, rng) if self.per_channel else vh
        hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.int16)
        # OpenCV hue is [0, 180); imgaug's value is in 256-hue units
        hsv[..., 0] = (hsv[..., 0] + int(round(vh * 180.0 / 255.0))) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + int(vs), 0, 255)
        image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return image, boxes, keypoints


class MultiplySaturation(Augmenter):
    def __init__(self, mul: Range = (0.5, 1.5)):
        self.mul = mul

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        m = _sample(self.mul, rng)
        hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * m, 0, 255)
        image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return image, boxes, keypoints


class MultiplyBrightness(Augmenter):
    def __init__(self, mul: Range = (0.7, 1.3)):
        self.mul = mul

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        m = _sample(self.mul, rng)
        hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 2] = np.clip(hsv[..., 2] * m, 0, 255)
        image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return image, boxes, keypoints


class ContrastNormalization(LinearContrast):
    """Deprecated imgaug alias of LinearContrast (older reference configs
    in the wild use it)."""


class TranslateX(Affine):
    def __init__(self, percent: Range = 0.0, px: Range = None):
        if px is not None:
            self._px = px
            super().__init__()
        else:
            self._px = None
            super().__init__(translate_percent={"x": percent})

    def apply(self, image, boxes, keypoints, rng):
        if self._px is not None:
            t = _sample(self._px, rng)
            m = np.array([[1, 0, t], [0, 1, 0]], np.float64)
            return self.warp(image, boxes, keypoints, m)
        return super().apply(image, boxes, keypoints, rng)


class TranslateY(Affine):
    def __init__(self, percent: Range = 0.0, px: Range = None):
        if px is not None:
            self._px = px
            super().__init__()
        else:
            self._px = None
            super().__init__(translate_percent={"y": percent})

    def apply(self, image, boxes, keypoints, rng):
        if self._px is not None:
            t = _sample(self._px, rng)
            m = np.array([[1, 0, 0], [0, 1, t]], np.float64)
            return self.warp(image, boxes, keypoints, m)
        return super().apply(image, boxes, keypoints, rng)


class ShearX(Affine):
    def __init__(self, shear: Range = (-20, 20)):
        super().__init__(shear=shear)


class ShearY(_AffineBase):
    """imgaug.ShearY: vertical shear about the image center."""

    def __init__(self, shear: Range = (-20, 20)):
        self.shear = shear

    def apply(self, image, boxes, keypoints, rng):
        sh = math.tan(math.radians(_sample(self.shear, rng)))
        h, w = image.shape[:2]
        cx, cy = w / 2.0, h / 2.0
        m = np.array([[1, 0, 0], [sh, 1, -sh * cx]], np.float64)
        return self.warp(image, boxes, keypoints, m)


class PerspectiveTransform(Augmenter):
    """imgaug.PerspectiveTransform(scale): jitter the four image corners by
    normal(0, scale)*size and warp; boxes map through the homography as
    corner envelopes, keypoints exactly (keep_size semantics)."""

    def __init__(self, scale: Range = (0.0, 0.06), keep_size: bool = True):
        self.scale = scale
        self.keep_size = bool(keep_size)

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        s = _sample(self.scale, rng)
        h, w = image.shape[:2]
        src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
        jit = rng.randn(4, 2).astype(np.float32) * s
        dst = src + jit * np.array([w, h], np.float32)
        m = cv2.getPerspectiveTransform(dst, src)  # sample from jittered
        image = cv2.warpPerspective(
            image, m, (w, h), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0)

        def tx(pts):
            # cv2.warpPerspective (without WARP_INVERSE_MAP) moves a source
            # point p to m @ p in the output
            ones = np.ones((pts.shape[0], 1), np.float64)
            q = np.concatenate([pts.astype(np.float64), ones], 1) @ m.T
            return (q[:, :2] / q[:, 2:3]).astype(np.float32)

        if boxes is not None and len(boxes):
            corners = np.stack(
                [boxes[:, [0, 1]], boxes[:, [2, 1]],
                 boxes[:, [2, 3]], boxes[:, [0, 3]]], axis=1).reshape(-1, 2)
            corners = tx(corners).reshape(-1, 4, 2)
            boxes = np.concatenate(
                [corners.min(axis=1), corners.max(axis=1)], axis=1
            ).astype(np.float32)
        if keypoints is not None and len(keypoints):
            keypoints = tx(keypoints)
        return image, boxes, keypoints


class ElasticTransformation(Augmenter):
    """imgaug.ElasticTransformation(alpha, sigma): smoothed random
    displacement field. Boxes/keypoints move by the field's displacement
    sampled at their coordinates (the same first-order approximation
    imgaug applies to keypoints; exact inversion of the field is not
    defined)."""

    def __init__(self, alpha: Range = (0.0, 40.0), sigma: Range = (4.0, 8.0)):
        self.alpha = alpha
        self.sigma = sigma

    def apply(self, image, boxes, keypoints, rng):
        cv2 = _cv2()
        a = _sample(self.alpha, rng)
        sig = max(_sample(self.sigma, rng), 0.5)
        if a <= 0:
            return image, boxes, keypoints
        h, w = image.shape[:2]
        dx = cv2.GaussianBlur(
            (rng.rand(h, w).astype(np.float32) * 2 - 1), (0, 0), sig) * a
        dy = cv2.GaussianBlur(
            (rng.rand(h, w).astype(np.float32) * 2 - 1), (0, 0), sig) * a
        gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        image = cv2.remap(image, gx + dx, gy + dy, cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0)

        def move(pts):
            xi = np.clip(pts[:, 0].round().astype(int), 0, w - 1)
            yi = np.clip(pts[:, 1].round().astype(int), 0, h - 1)
            # output pixel p shows input p + d(p): points move by -d
            return pts - np.stack([dx[yi, xi], dy[yi, xi]], 1)

        if boxes is not None and len(boxes):
            corners = np.stack(
                [boxes[:, [0, 1]], boxes[:, [2, 1]],
                 boxes[:, [2, 3]], boxes[:, [0, 3]]], axis=1).reshape(-1, 2)
            corners = move(corners.astype(np.float32)).reshape(-1, 4, 2)
            boxes = np.concatenate(
                [corners.min(axis=1), corners.max(axis=1)], axis=1
            ).astype(np.float32)
        if keypoints is not None and len(keypoints):
            keypoints = move(keypoints.astype(np.float32))
        return image, boxes, keypoints


_REGISTRY = {
    "Sequential": Sequential,
    "Sometimes": Sometimes,
    "Affine": Affine,
    "Fliplr": Fliplr,
    "Flipud": Flipud,
    "Crop": Crop,
    "Resize": Resize,
    "AddToHue": AddToHue,
    "AddToBrightness": AddToBrightness,
    "Multiply": Multiply,
    "LinearContrast": LinearContrast,
    "MotionBlur": MotionBlur,
    "GaussianBlur": GaussianBlur,
    "AdditiveGaussianNoise": AdditiveGaussianNoise,
    "Grayscale": Grayscale,
    "Rotate": Rotate,
    "Add": Add,
    "AddToSaturation": AddToSaturation,
    "Sharpen": Sharpen,
    "Dropout": Dropout,
    "CoarseDropout": CoarseDropout,
    "GammaContrast": GammaContrast,
    "SigmoidContrast": SigmoidContrast,
    "AverageBlur": AverageBlur,
    "MedianBlur": MedianBlur,
    "SaltAndPepper": SaltAndPepper,
    "Invert": Invert,
    "Solarize": Solarize,
    "Posterize": Posterize,
    "JpegCompression": JpegCompression,
    "AddToHueAndSaturation": AddToHueAndSaturation,
    "MultiplySaturation": MultiplySaturation,
    "MultiplyBrightness": MultiplyBrightness,
    "ContrastNormalization": ContrastNormalization,
    "TranslateX": TranslateX,
    "TranslateY": TranslateY,
    "ShearX": ShearX,
    "ShearY": ShearY,
    "PerspectiveTransform": PerspectiveTransform,
    "ElasticTransformation": ElasticTransformation,
}


def instantiate_augmenters(augmentation_list) -> List[Augmenter]:
    """Instantiate augmenters from the YAML list format.

    Twin of utils/helper.py:53-71: each list item is ``{Name: {params}}``;
    ``Sometimes.then_list`` recurses; 2-element lists act as uniform ranges.
    """
    methods: List[Augmenter] = []
    for item in augmentation_list:
        if hasattr(item, "to_dict"):
            item = item.to_dict()
        name = list(item)[0]
        params = dict(item[name] or {})
        if hasattr(params, "to_dict"):
            params = params.to_dict()

        if name == "Sometimes":
            params["then_list"] = instantiate_augmenters(params["then_list"])

        for key, value in params.items():
            if isinstance(value, list) and key != "then_list":
                params[key] = tuple(value)

        if name not in _REGISTRY:
            raise KeyError(
                f"unknown augmenter '{name}'; available: {sorted(_REGISTRY)}"
            )
        methods.append(_REGISTRY[name](**params))
        log.debug("registered augmenter %s", name)
    return methods
