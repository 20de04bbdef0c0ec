"""Custom-video dataset loader.

Counterpart of `gsavatar/data/mydataset.py`: a ZJU-format tree made by the
dataset-building pipeline, read as ZJU-MoCap is, from frames captured at
1080x1920."""
from __future__ import annotations

from .zjumocap import ZJUMoCapDataset


class MyDataset(ZJUMoCapDataset):
    RAW_HW = (1080, 1920)
