"""COCO-format detection dataset with CenterNet target encoding.

The port's copy of ``centernet_uda_tpu/data/coco.py`` in the port's layout:
``input`` is CHW float32 (3, H, W) and ``hm`` (num_classes, h, w), where the
JAX package returns HWC and (h, w, num_classes). Every other key (``ind``,
``reg_mask``, ``wh``, ``reg``, ``gt_dets``, ``gt_areas``, ``kps``,
``gt_kps``, ``kp_reg_mask``, ``id``, ``target_domain_input``) is the JAX
package's, byte for byte, for the same seed. Axis-aligned targets are
encoded and images normalised by the host library (``native``, built with
g++ at first use; the JAX package's ``native`` is its counterpart), or,
with ``CENTERNET_DISABLE_NATIVE`` set (which an explicit
``use_native_encoder`` overrides) or ``use_native_encoder=False``, by
their plain versions, ``ops/gaussian.py:encode_targets`` and
``normalize_image``, which give the same arrays. Rotated boxes and keypoint
targets are encoded in numpy, as in the JAX package.

Images: binary PPM/PGM (``P6``/``P5``, 8 bits) is read with numpy alone;
every other format through OpenCV, then PIL, imported where an image is
read. The rotated-box path needs OpenCV (``cv2.minAreaRect``).
"""

from __future__ import annotations

import logging
from glob import glob
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np

from centernet_uda_torch import native
from centernet_uda_torch.data import augment as aug
from centernet_uda_torch.data.box import (get_annotation_with_angle,
                                          rotate_bbox_float)
from centernet_uda_torch.data.coco_api import COCO
from centernet_uda_torch.ops.gaussian import (draw_gaussian, encode_targets,
                                              gaussian_radius)

log = logging.getLogger(__name__)


def _ppm_header(f):
    """(magic, width, height, maxval) of a binary PNM file, leaving ``f``
    at the first pixel byte; None when the file is not P5/P6."""
    if f.read(2) not in (b"P5", b"P6"):
        return None
    f.seek(0)
    fields = []
    while len(fields) < 4:
        c = f.read(1)
        if not c:
            return None
        if c == b"#":
            f.readline()
        elif c.isspace():
            continue
        else:
            token = c
            while True:
                c = f.read(1)
                if not c or c.isspace():
                    break
                token += c
            fields.append(token)
            if c == b"#":
                f.readline()
    # one whitespace byte (already consumed) separates maxval from the data
    return fields[0], int(fields[1]), int(fields[2]), int(fields[3])


def read_ppm(path) -> Optional[np.ndarray]:
    """An 8-bit binary PPM (``P6``) or PGM (``P5``) as an (H, W, 3) uint8
    RGB array (grey replicated, as ``cv2.IMREAD_COLOR`` does); None for any
    other file."""
    with open(path, "rb") as f:
        header = _ppm_header(f)
        if header is None or header[3] != 255:
            return None
        magic, w, h, _ = header
        channels = 3 if magic == b"P6" else 1
        data = np.frombuffer(f.read(w * h * channels), np.uint8)
    if data.size != w * h * channels:
        raise ValueError(f"{path}: truncated PNM data")
    img = data.reshape(h, w, channels)
    return img if channels == 3 else np.repeat(img, 3, axis=2)


def write_ppm(path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB array as binary PPM."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def normalize_image(img: np.ndarray, mean, std) -> np.ndarray:
    """``(img / 255 - mean) / std`` of an (H, W, 3) uint8 image as a
    contiguous float32 (3, H, W) array: the plain version of
    ``native.normalize_image``."""
    img = img.astype(np.float32) / 255.0
    mean = np.asarray(mean, np.float32).reshape(1, 1, 3)
    std = np.asarray(std, np.float32).reshape(1, 1, 3)
    return np.ascontiguousarray(((img - mean) / std).transpose(2, 0, 1))


def load_image(path) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB.

    PPM/PGM: numpy. Otherwise OpenCV (EXIF orientation ignored, as PIL and
    the reference read the stored pixel grid), then PIL for what OpenCV
    cannot read; the library is imported here, when it is needed."""
    img = read_ppm(path)
    if img is not None:
        return img
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(
            str(path), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        if cv2 is None:
            raise ImportError(
                f"reading {path} needs OpenCV (cv2) or PIL, and neither "
                "imports; binary PPM/PGM needs neither") from None
        raise
    return np.array(Image.open(path).convert("RGB"))


class Dataset:
    def __init__(
        self,
        image_folder: str,
        annotation_file: str,
        input_size=(512, 512),
        target_domain_glob: Union[None, str, Sequence[str]] = None,
        num_classes: int = 80,
        num_keypoints: int = 0,
        rotated_boxes: bool = False,
        mean=(0.40789654, 0.44719302, 0.47026115),
        std=(0.28863828, 0.27408164, 0.27809835),
        augmentation=None,
        augment_target_domain: bool = False,
        max_detections: int = 150,
        down_ratio: int = 4,
        seed: Optional[int] = None,
        use_native_encoder: Optional[bool] = None,
    ):
        self.image_folder = Path(image_folder)
        self.coco = COCO(annotation_file)
        self.images = self.coco.getImgIds()
        self.use_rotated_boxes = bool(rotated_boxes)
        self.max_detections = int(max_detections)
        self.down_ratio = int(down_ratio)
        self.input_size = tuple(int(v) for v in input_size)  # (W, H)
        self.mean = np.array(mean, np.float32).reshape(1, 1, 3)
        self.std = np.array(std, np.float32).reshape(1, 1, 3)
        self.num_classes = int(num_classes)
        self.num_keypoints = int(num_keypoints)
        self.augment_target_domain = bool(augment_target_domain)
        self.string_id_mapping: Dict[str, int] = {}
        self.rng = np.random.RandomState(seed)
        # unset, it follows CENTERNET_DISABLE_NATIVE, as the evaluator does
        if use_native_encoder is None:
            use_native_encoder = native.enabled()
        elif not use_native_encoder:
            log.info("use_native_encoder=False: the numpy target encoder "
                     "and normalisation run")
        if use_native_encoder:
            native.load()  # built here, in the caller, on the first use
            self._encode_boxes = native.encode_targets
            self._normalize_hwc = native.normalize_image
        else:
            self._encode_boxes = encode_targets
            self._normalize_hwc = normalize_image

        # contiguous category remap, 1..num_classes -> 0..num_classes-1
        # (datasets/coco.py:45-48)
        self.cat_mapping = {v: i for i, v in enumerate(range(1, num_classes + 1))}
        self.classes = {
            y: self.coco.cats[x] if x in self.coco.cats else ""
            for x, y in self.cat_mapping.items()
        }
        assert len(self.input_size) == 2

        if isinstance(target_domain_glob, str):
            self.target_domain_files = sorted(glob(target_domain_glob))
        elif isinstance(target_domain_glob, (list, tuple)):
            self.target_domain_files = []
            for pattern in target_domain_glob:
                self.target_domain_files.extend(sorted(glob(str(pattern))))
        else:
            self.target_domain_files = []

        self.augmentation: Optional[aug.Sequential] = None
        if augmentation:
            self.augmentation = aug.Sequential(
                aug.instantiate_augmenters(augmentation)
            )

        self.resize = aug.Resize((self.input_size[1], self.input_size[0]))

        log.info(
            "found %d samples for target domain", len(self.target_domain_files)
        )

    def __len__(self) -> int:
        return len(self.images)

    # ------------------------------------------------------------------
    def _normalize(self, img: np.ndarray) -> np.ndarray:
        """uint8 HWC -> normalised float32 CHW."""
        return self._normalize_hwc(img, self.mean, self.std)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img_id = self.images[index]
        file_name = self.coco.loadImgs(ids=[img_id])[0]["file_name"]
        ann_ids = self.coco.getAnnIds(imgIds=[img_id])
        anns = self.coco.loadAnns(ids=ann_ids)
        num_objs = min(len(anns), self.max_detections)
        img = load_image(self.image_folder / file_name)

        if self.use_rotated_boxes:
            ret = self._get_rotated(img, anns, num_objs)
        else:
            ret = self._get_default(img, anns, num_objs)

        if isinstance(img_id, str):
            mapped = self.string_id_mapping.setdefault(
                img_id, 1 + len(self.string_id_mapping)
            )
            img_id = mapped
        ret["id"] = np.int64(img_id)

        if self.target_domain_files:
            tfile = self.target_domain_files[
                self.rng.randint(len(self.target_domain_files))
            ]
            timg = load_image(tfile)
            if self.augmentation is not None and self.augment_target_domain:
                timg, _, _ = self.augmentation(timg, rng=self.rng)
            timg, _, _ = self.resize(timg, rng=self.rng)
            ret["target_domain_input"] = self._normalize(timg)

        return ret

    # ------------------------------------------------------------------
    def _output_hw(self):
        return (self.input_size[1] // self.down_ratio,
                self.input_size[0] // self.down_ratio)

    def _encode_keypoints(self, t, anns, kp_out, output_w, output_h):
        """Center-relative keypoint offsets + validity of every encoded
        object (datasets/coco.py:217-228); its integer center is its
        ``ind``."""
        k_max, n_kp = self.max_detections, self.num_keypoints
        t["kps"] = np.zeros((k_max, n_kp * 2), np.float32)
        t["gt_kps"] = np.zeros((k_max, n_kp, 2), np.float32)
        t["kp_reg_mask"] = np.zeros((k_max, n_kp * 2), np.uint8)
        for k in np.flatnonzero(t["reg_mask"]):
            ct_int = (int(t["ind"][k] % output_w), int(t["ind"][k] // output_w))
            kpts_obj = kp_out[k * n_kp: (k + 1) * n_kp]
            valid = np.array(anns[k]["keypoints"]).reshape(-1, 3)[:, -1]
            for i in range(n_kp):
                p = kpts_obj[i]
                t["kps"][k, i * 2] = p[0] - ct_int[0]
                t["kps"][k, i * 2 + 1] = p[1] - ct_int[1]
                # NOTE: the reference checks is_out_of_image((output_w,
                # output_w)) — width twice (datasets/coco.py:224-225); both
                # packages check both axes.
                inside = 0 <= p[0] < output_w and 0 <= p[1] < output_h
                is_valid = valid[i] == 2 and inside
                t["kp_reg_mask"][k, i * 2] = int(is_valid)
                t["kp_reg_mask"][k, i * 2 + 1] = int(is_valid)
                t["gt_kps"][k, i] = p[0], p[1]

    def _get_default(self, img, anns, num_objs):
        boxes = []
        kpts = []
        for k in range(num_objs):
            ann = anns[k]
            x, y, w, h = ann["bbox"]
            boxes.append([x, y, x + w, y + h])
            if self.num_keypoints > 0:
                if "keypoints" not in ann:
                    ann["keypoints"] = np.zeros((3 * self.num_keypoints,))
                kp = np.array(ann["keypoints"], np.float32).reshape(-1, 3)[:, :2]
                kpts.append(kp)

        boxes = (
            np.array(boxes, np.float32) if boxes else np.zeros((0, 4), np.float32)
        )
        kp_flat = (
            np.concatenate(kpts, axis=0)
            if kpts
            else np.zeros((0, 2), np.float32)
        )

        if self.augmentation is not None:
            img, boxes, kp_flat = self.augmentation(
                img, boxes, kp_flat, rng=self.rng
            )
        img, boxes, kp_flat = self.resize(img, boxes, kp_flat, rng=self.rng)

        inp = self._normalize(img)

        if len(boxes):
            scale = 1.0 / self.down_ratio
            boxes_out = boxes * scale
            kp_out = kp_flat * scale if len(kp_flat) else kp_flat
        else:
            boxes_out = boxes
            kp_out = kp_flat

        output_h, output_w = self._output_hw()
        t = self._encode_boxes(
            boxes_out.reshape(-1, 4),
            [self.cat_mapping[anns[k]["category_id"]] for k in range(num_objs)],
            output_h, output_w, self.num_classes, self.max_detections,
            areas=[anns[k].get("area") for k in range(num_objs)])
        if self.num_keypoints > 0:
            self._encode_keypoints(t, anns, kp_out, output_w, output_h)
        t["input"] = inp
        return t

    def _get_rotated(self, img, anns, num_objs):
        """Rotated-box path (datasets/coco.py:261-401): boxes ride through the
        augmentation as 4 corner points and are re-fit with cv2.minAreaRect."""
        import cv2

        corner_pts = []
        obj_kpts = []
        for k in range(num_objs):
            ann = anns[k]
            ann_rot = get_annotation_with_angle(ann)
            corners = rotate_bbox_float(*ann_rot)  # (4, 2) float
            corner_pts.append(corners)
            if self.num_keypoints > 0:
                if "keypoints" not in ann:
                    ann["keypoints"] = np.zeros((3 * self.num_keypoints,))
                kp = np.array(ann["keypoints"], np.float32).reshape(-1, 3)[:, :2]
                obj_kpts.append(kp)

        pts = (
            np.concatenate(corner_pts, axis=0).astype(np.float32)
            if corner_pts
            else np.zeros((0, 2), np.float32)
        )
        n_box_pts = len(pts)
        if obj_kpts:
            pts = np.concatenate([pts] + obj_kpts, axis=0)

        if self.augmentation is not None:
            img, _, pts = self.augmentation(img, None, pts, rng=self.rng)
        img, _, pts = self.resize(img, None, pts, rng=self.rng)

        inp = self._normalize(img)

        output_h, output_w = self._output_hw()
        k_max = self.max_detections
        t = {
            "hm": np.zeros((self.num_classes, output_h, output_w), np.float32),
            "wh": np.zeros((k_max, 3), np.float32),
            "reg": np.zeros((k_max, 2), np.float32),
            "ind": np.zeros((k_max,), np.int64),
            "reg_mask": np.zeros((k_max,), np.uint8),
            "gt_dets": np.zeros((k_max, 7), np.float32),
            "gt_areas": np.zeros((k_max,), np.float32),
        }

        pts_out = pts * (1.0 / self.down_ratio) if len(pts) else pts
        box_pts, kp_pts = pts_out[:n_box_pts], pts_out[n_box_pts:]
        assert num_objs == len(box_pts) // 4

        for k in range(num_objs):
            ann = anns[k]
            corners = box_pts[k * 4 : k * 4 + 4].copy()
            corners[:, 0] = np.clip(corners[:, 0], 0, output_w - 1)
            corners[:, 1] = np.clip(corners[:, 1], 0, output_h - 1)
            (cv_cx, cv_cy), (cv_w, cv_h), cv_angle = cv2.minAreaRect(
                corners.astype(np.float32)
            )
            if cv_w == 0 or cv_h == 0:
                continue

            cx, cy, w, h, angle = get_annotation_with_angle(
                {"rbbox": np.array([cv_cx, cv_cy, cv_w, cv_h, cv_angle])}
            )
            ct = np.array((cx, cy))
            cls_id = int(self.cat_mapping[ann["category_id"]])

            if h > 0 and w > 0:
                radius = max(0, int(gaussian_radius((np.ceil(h), np.ceil(w)))))
                ct_int = ct.astype(np.int32)
                draw_gaussian(t["hm"][cls_id], ct_int, radius)
                t["wh"][k] = w, h, angle
                t["ind"][k] = ct_int[1] * output_w + ct_int[0]
                t["reg"][k] = ct - ct_int
                t["reg_mask"][k] = 1
                t["gt_dets"][k] = (ct[0], ct[1], w, h, angle, 1, cls_id)
                t["gt_areas"][k] = ann.get("area", w * h)

        if self.num_keypoints > 0:
            self._encode_keypoints(t, anns, kp_pts, output_w, output_h)
        t["input"] = inp
        return t
