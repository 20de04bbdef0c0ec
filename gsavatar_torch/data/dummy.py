"""Live-capture stand-in dataset.

Counterpart of `gsavatar/data/dummy.py`: without a camera, the synthetic
dataset over a prebuilt pose track of 570 frames. Its webcam mode reads
frames through `motion/streams.py`, which the port does not have yet
(ROADMAP item 15), so `use_camera=True` raises."""
from __future__ import annotations

from .synthetic import SyntheticDataset


class DummyDataset(SyntheticDataset):
    N_PREBUILT = 570

    def __init__(self, cfg: dict, split: str = 'train', gt_device=None):
        if cfg.get('use_camera', False):
            raise NotImplementedError(
                "dummy_dataset with use_camera=True needs the webcam stream "
                "of motion/streams.py, which is not ported yet (ROADMAP "
                "item 15)")
        if 'train_frames' not in cfg:
            cfg['train_frames'] = [0, self.N_PREBUILT, 1]
        super().__init__(cfg, split, gt_device=gt_device)
