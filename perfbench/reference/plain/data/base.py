# Frozen copy of gsavatar_torch/data/base.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Dataset helpers: canonicalization, the per-frame pose recipe and the
base class of the loaders.

The port's own copy of `gsavatar/data/base.py`."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.spatial.transform import Rotation

from perfbench.reference.plain.smpl.body_model import SMPLAssets
from perfbench.reference.plain.smpl.vitruvian import get_02v_bone_transforms
from perfbench.reference.plain.utils.aabb import AABB

# ZJU-MoCap's scene extent, which every dataset of the JAX package reports
ZJU_CAMERAS_EXTENT = 3.469298553466797


def fix_symmetry(arr: np.ndarray) -> np.ndarray:
    """A float16 canonical shape as float32 with a 1e-4 normal jitter from
    `default_rng(0)`, which breaks its exact symmetries; any other dtype is
    only cast."""
    if arr.dtype == np.float16:
        rng = np.random.default_rng(0)
        return arr.astype(np.float32) + 1e-4 * rng.standard_normal(arr.shape)
    return arr.astype(np.float32)


def padding_ratio(cfg):
    """The AABB padding of a dataset config: a scalar, or a per-axis
    [px, py, pz] list (zjumocap_387_mono sets one)."""
    p = cfg.get('padding', 0.1)
    try:
        return np.asarray([float(v) for v in p], dtype=np.float32)
    except TypeError:
        return float(p)


def canonicalize(minimal_shape: np.ndarray, assets: SMPLAssets,
                 padding=0.1) -> dict:
    """Star-pose canonicalization of a minimally clothed shape: the
    metadata dict the model stack consumes."""
    Jtr = assets.J_regressor @ minimal_shape
    skinning_weights = assets.skinning_weights
    tf_02v = get_02v_bone_transforms(Jtr)
    T = (skinning_weights @ tf_02v.reshape(-1, 16)).reshape(-1, 4, 4)
    verts = (T[:, :3, :3] @ minimal_shape[..., None])[..., 0] + T[:, :3, 3]
    verts = verts.astype(np.float32)
    aabb = AABB.from_points(verts, padding=padding)
    return {
        'gender': assets.gender,
        'smpl_verts': verts,
        'minimal_shape': minimal_shape,
        'Jtr': Jtr,
        'skinning_weights': skinning_weights.astype(np.float32),
        'bone_transforms_02v': tf_02v,
        'faces': assets.faces,
        'coord_min': aabb.coord_min.numpy(),
        'coord_max': aabb.coord_max.numpy(),
        'aabb': aabb,
    }


def normalize_Jtr(Jtr: np.ndarray, minimal_shape: np.ndarray) -> np.ndarray:
    """Joint normalization: centre, min-max scale with 5% padding, /1.1,
    then map to [-1, 1]."""
    center = np.mean(minimal_shape, axis=0)
    centered = minimal_shape - center
    cano_max = centered.max()
    cano_min = centered.min()
    padding = (cano_max - cano_min) * 0.05
    Jn = Jtr - center
    Jn = (Jn - cano_min + padding) / (cano_max - cano_min) / 1.1
    Jn -= 0.5
    Jn *= 2.0
    return Jn.astype(np.float32)


def pose_to_rots(root_orient, pose_body, pose_hand) -> np.ndarray:
    """(24, 9) flattened rotation matrices with the root set to identity."""
    pose = np.concatenate([root_orient, pose_body, pose_hand], axis=-1)
    mats = Rotation.from_rotvec(pose.reshape(-1, 3)).as_matrix()
    rots = np.concatenate([np.eye(3)[None], mats[1:]], axis=0)
    return rots.reshape(-1, 9).astype(np.float32)


def compose_bone_transforms(bone_transforms: np.ndarray, tf_02v: np.ndarray,
                            trans: np.ndarray) -> np.ndarray:
    """Final canonical (star pose) -> posed transforms."""
    bt = bone_transforms @ np.linalg.inv(tf_02v)
    bt = bt.astype(np.float32)
    bt[:, :3, 3] += trans
    return bt


def frame_slice(frames_cfg: List[int], n_total: int):
    start, end, step = frames_cfg
    if end == 0:
        end = n_total
    return slice(start, end, step)


class BaseDataset:
    """An indexable dataset of camera records. With `preload` (the
    default) each record is built once and kept; `device` is where its
    image and mask tensors live, and without `ground_truth` it has
    neither."""

    def __init__(self, cfg: dict, split: str, device='cpu',
                 ground_truth: bool = True):
        self.cfg = cfg
        self.split = split
        self.device = device
        self.ground_truth = ground_truth
        self._cache: Dict[int, object] = {}

    def __len__(self) -> int:
        raise NotImplementedError

    def _get_camera(self, idx: int):
        raise NotImplementedError

    def __getitem__(self, idx: int):
        if self.cfg.get('preload', True):
            if idx not in self._cache:
                self._cache[idx] = self._get_camera(idx)
            return self._cache[idx]
        return self._get_camera(idx)
