"""Concatenation of multiple COCO datasets by cumulative index intervals.

A copy of ``centernet_uda_tpu/data/coco_merger.py`` (the reference's
``datasets/coco_merger.py:8-35``): each child dataset is built from
the shared defaults merged with its own params; ``__getitem__`` dispatches on
cumulative-length intervals. Used by the merged multi-dataset experiment
(configs/experiment/coco_merged.yaml).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


class Dataset:
    def __init__(self, datasets, max_samples: Optional[int] = None, **defaults):
        from centernet_uda_torch import data as data_registry

        self.max_samples = max_samples
        self.datasets = {}
        self.num_samples = 0

        for ds in datasets:
            if hasattr(ds, "to_dict"):
                ds = ds.to_dict()
            params = {**defaults, **(ds.get("params") or {})}
            child = data_registry.build(ds["name"], **params)
            self.num_samples += len(child)
            self.datasets[self.num_samples] = child

        self.intervals = np.array(list(self.datasets.keys()))
        log.info(
            "merged %d datasets with a total number of %d samples",
            len(self.datasets), self.num_samples,
        )

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, index: int):
        interval_idx = int(np.argmax(index < self.intervals))
        interval = self.intervals[interval_idx]
        offset = self.intervals[interval_idx - 1] if interval_idx > 0 else 0
        return self.datasets[int(interval)][index - int(offset)]

    @property
    def classes(self):
        first = self.datasets[int(self.intervals[0])]
        return first.classes
