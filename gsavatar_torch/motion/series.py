"""Motion-series playback: drive the avatar with an estimated SMPL sequence.

Counterpart of `gsavatar/motion/series.py` (motion_display/
motion_series.py of the original code). A CLIFF-style npz holds `pose`
(F, 72) and optionally `shape` (F, 10), `global_t` (F, 3) and `focal_l`
(default 1000); the root orientation and translation can be fixed, or
the translation advanced by a delta on every parse (accumulate mode).
`parse` runs the port's SMPL LBS on the series' device (the GPU unless
the caller asks for the CPU); `camera_pose_fields` turns one frame into
the (rots, Jtrs, bone_transforms) of a camera with the subject's
canonical metadata.

One difference from the JAX package: `camera_pose_fields` takes the
parameters a caller has parsed already, so that a frame is parsed once
(the JAX `capture_and_record` parses each frame twice, which advances
the accumulated translation twice)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from gsavatar_torch import tracing
from gsavatar_torch.data import base as data_base
from gsavatar_torch.device import resolve_device
from gsavatar_torch.smpl import lbs as smpl_lbs
from gsavatar_torch.smpl.body_model import SMPLAssets


@dataclass
class SMPLParameters:
    """One frame of SMPL state (motion_series.py:24-41)."""
    root_orient: np.ndarray  # (3,)
    pose_body: np.ndarray    # (63,)
    pose_hand: np.ndarray    # (6,)
    trans: np.ndarray        # (3,)
    betas: np.ndarray        # (10,)
    bone_transforms: np.ndarray  # (24, 4, 4) raw (not 02v-relative)
    verts: Optional[np.ndarray] = None
    joints: Optional[np.ndarray] = None

    def export(self) -> dict:
        """The ZJU-format model npz's payload."""
        return {
            'root_orient': self.root_orient, 'pose_body': self.pose_body,
            'pose_hand': self.pose_hand, 'trans': self.trans,
            'betas': self.betas.reshape(1, -1),
            'bone_transforms': self.bone_transforms,
        }


class MotionSeries:
    """SMPL parameters of each frame of a motion npz (or a dict of its
    arrays)."""

    def __init__(self, path_or_arrays, assets: SMPLAssets, *,
                 root_orient=None, trans=None, accumulate: bool = False,
                 trans_delta=None, device=None):
        if isinstance(path_or_arrays, str):
            data = dict(np.load(path_or_arrays))
        else:
            data = dict(path_or_arrays)
        self.pose = np.asarray(data['pose'], np.float32)
        self.shape = np.asarray(data.get('shape',
                                         np.zeros((len(self.pose), 10))),
                                np.float32)
        self.global_t = np.asarray(
            data.get('global_t', np.zeros((len(self.pose), 3))), np.float32)
        self.focal_l = np.asarray(data.get('focal_l', 1000.0), np.float32)
        self.assets = assets
        self.root_orient_override = root_orient
        self.trans_override = trans
        self.accumulate = accumulate
        self.trans_delta = trans_delta
        self._acc_trans = np.zeros(3, np.float32)
        self.device = resolve_device(device)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                      device=self.device)
        self._smpl = (t(assets.v_template)[None], t(assets.shapedirs),
                      t(assets.posedirs), t(assets.J_regressor),
                      [int(p) for p in assets.parents],
                      t(assets.skinning_weights))

    def __len__(self):
        return len(self.pose)

    @torch.inference_mode()
    def parse(self, idx: int) -> SMPLParameters:
        pose = self.pose[idx].copy()
        trans = self.global_t[idx].copy()
        if self.root_orient_override is not None:
            pose[:3] = self.root_orient_override
        if self.trans_override is not None:
            trans = np.asarray(self.trans_override, np.float32).copy()
        if self.accumulate and self.trans_delta is not None:
            self._acc_trans += np.asarray(self.trans_delta, np.float32)
            trans = trans + self._acc_trans

        betas = self.shape[idx]
        v_template, shapedirs, posedirs, J_regressor, parents, weights = \
            self._smpl
        dev = self.device
        verts, J_posed, _J, A, _, _, _, _ = smpl_lbs.lbs(
            torch.as_tensor(betas, device=dev)[None],
            torch.as_tensor(pose, device=dev)[None], v_template, shapedirs,
            posedirs, J_regressor, parents, weights)
        read = tracing.device_read
        return SMPLParameters(
            root_orient=pose[:3], pose_body=pose[3:66], pose_hand=pose[66:72],
            trans=trans, betas=betas, bone_transforms=read(A[0]).numpy(),
            verts=read(verts[0]).numpy(), joints=read(J_posed[0]).numpy())

    def camera_pose_fields(self, idx: int, metadata: dict,
                           params: Optional[SMPLParameters] = None):
        """(rots (1, 24, 9), Jtrs (1, 24, 3), bone_transforms (24, 4, 4))
        of frame `idx` for a camera, with the subject's canonical metadata
        (motion_series.py:225-269). `params`, when given, are frame idx's
        parsed parameters, and the frame is not parsed again."""
        with tracing.span('motion/pose'):
            p = self.parse(idx) if params is None else params
            rots = data_base.pose_to_rots(p.root_orient, p.pose_body,
                                          p.pose_hand)
            Jtr_norm = data_base.normalize_Jtr(metadata['Jtr'],
                                               metadata['minimal_shape'])
            bt = data_base.compose_bone_transforms(
                p.bone_transforms, metadata['bone_transforms_02v'], p.trans)
        return rots[None], Jtr_norm[None], bt

    def __iter__(self) -> Iterator[SMPLParameters]:
        for i in range(len(self)):
            yield self.parse(i)
