"""Live-capture stand-in dataset.

Counterpart of `gsavatar/data/dummy.py`: the synthetic dataset over a
prebuilt pose track of 570 frames. With `use_camera=True` it tries to open
the webcam through `motion/streams.CameraStream`; where that fails (no
OpenCV, no video device) it serves the synthetic track as it is, and where
it opens, each camera's image is a webcam frame scaled to [0, 1] and
cropped to the camera's size."""
from __future__ import annotations

import numpy as np
import torch

from .synthetic import SyntheticDataset


class DummyDataset(SyntheticDataset):
    N_PREBUILT = 570

    def __init__(self, cfg: dict, split: str = 'train', gt_device=None):
        if 'train_frames' not in cfg:
            cfg['train_frames'] = [0, self.N_PREBUILT, 1]
        super().__init__(cfg, split, gt_device=gt_device)
        self.use_camera = bool(cfg.get('use_camera', False))
        self._stream = None
        self._live = {}
        if self.use_camera:
            try:
                from gsavatar_torch.motion.streams import CameraStream
                self._stream = CameraStream()
            except Exception:
                self._stream = None

    def __getitem__(self, idx: int):
        """The synthetic camera of record `idx`; with a webcam, carrying a
        webcam frame: the one taken when the record was first asked for
        (`preload`, the default), else a new one each time."""
        if self._stream is None:
            return super().__getitem__(idx)
        if idx in self._live:
            return self._live[idx]
        cam = super().__getitem__(idx)
        frame = next(iter(self._stream))
        img = frame.astype(np.float32) / 255.0
        cam = cam.replace(image=torch.as_tensor(
            img[:cam.height, :cam.width], device=self.gt_device or 'cpu'))
        if self.cfg.get('preload', True):
            self._live[idx] = cam
        return cam
