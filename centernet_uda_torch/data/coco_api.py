"""Minimal COCO annotation-file API.

A copy of ``centernet_uda_tpu/data/coco_api.py``: the small slice of
``pycocotools.coco.COCO`` that the dataset consumes (``getImgIds``,
``loadImgs``, ``getAnnIds``, ``loadAnns``, ``.cats``), as pure-Python JSON
indexing, so the port needs no pycocotools.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Union


class COCO:
    def __init__(self, annotation_file: Optional[str] = None):
        self.dataset: Dict[str, Any] = {}
        self.anns: Dict[Any, Dict] = {}
        self.imgs: Dict[Any, Dict] = {}
        self.cats: Dict[Any, Dict] = {}
        self.img_to_anns: Dict[Any, List[Dict]] = defaultdict(list)

        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self.create_index()

    def create_index(self) -> None:
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_to_anns = defaultdict(list)

        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    # pycocotools-compatible accessors -------------------------------------
    def getImgIds(self) -> List[Any]:
        return list(self.imgs.keys())

    def loadImgs(self, ids: Union[Sequence, Any]) -> List[Dict]:
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds: Union[Sequence, Any] = None) -> List[Any]:
        if imgIds is None:
            return list(self.anns.keys())
        if not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        out = []
        for img_id in imgIds:
            out.extend(a["id"] for a in self.img_to_anns[img_id])
        return out

    def loadAnns(self, ids: Union[Sequence, Any]) -> List[Dict]:
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def getCatIds(self) -> List[Any]:
        return list(self.cats.keys())
