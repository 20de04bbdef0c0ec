"""Dataset factory: counterpart of `gsavatar/data/__init__.py`.

`load_dataset(cfg, split, device, ground_truth)` builds the loader that
`cfg['name']` names. `device` is where the cameras' frames and masks live:
for the real loaders the decoded, undistorted and resized frame; for the
synthetic one the rendered ground truth. With `ground_truth=False` the
cameras carry neither: the real loaders read no image file and the
synthetic one renders nothing."""
from __future__ import annotations


def load_dataset(cfg: dict, split: str = 'train', device='cpu',
                 ground_truth: bool = True):
    name = cfg['name']
    if name in ('synthetic', 'dummy_dataset'):
        if name == 'synthetic':
            from .synthetic import SyntheticDataset as cls
        else:
            from .dummy import DummyDataset as cls
        return cls(cfg, split, gt_device=device if ground_truth else None)
    if name == 'zjumocap':
        from .zjumocap import ZJUMoCapDataset as cls
    elif name == 'people_snapshot':
        from .people_snapshot import PeopleSnapshotDataset as cls
    elif name == 'mydataset':
        from .mydataset import MyDataset as cls
    else:
        raise ValueError(f"unknown dataset: {name}")
    return cls(cfg, split, device=device, ground_truth=ground_truth)
