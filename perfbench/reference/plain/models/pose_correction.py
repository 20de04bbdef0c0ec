# Frozen copy of gsavatar_torch/models/pose_correction.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Per-frame SMPL pose refinement: none, or direct optimisation.

Counterpart of `gsavatar/models/pose_correction.py`. `NoPoseCorrection`
passes the camera through and adds no regularizer. `DirectPoseOptimization`:
per-frame tables of root_orient / pose_body / pose_hand / trans plus shared
betas; SMPL LBS and the star-pose transform give updated (rots, Jtrs,
bone_transforms) for the camera. The delay gate and the "frame not in
frame_dict" skip are one blend `gate * new + (1 - gate) * old` with
`gate = in_frame_dict * (iteration >= delay)`, as in the JAX package."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from perfbench.reference.plain.smpl import lbs as smpl_lbs
from perfbench.reference.plain.smpl.vitruvian import get_02v_bone_transforms_torch


class NoPoseCorrection(nn.Module):
    def forward(self, camera, iteration: int):
        return camera, {}


class DirectPoseOptimization(nn.Module):
    def __init__(self, assets, init_root_orient, init_pose_body,
                 init_pose_hand, init_trans, init_betas, delay: int = 0):
        super().__init__()
        self.delay = delay
        self.parents = [int(p) for p in assets.parents]

        def param(x):
            return nn.Parameter(torch.as_tensor(np.asarray(x, np.float32)))

        self.root_orients = param(init_root_orient)
        self.pose_bodys = param(init_pose_body)
        self.pose_hands = param(init_pose_hand)
        self.trans = param(init_trans)
        self.betas = param(np.asarray(init_betas).reshape(1, -1))
        for name, value in (('v_template', assets.v_template[None]),
                            ('shapedirs', assets.shapedirs),
                            ('posedirs', assets.posedirs),
                            ('J_regressor', assets.J_regressor),
                            ('lbs_weights', assets.skinning_weights)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(value, np.float32)), persistent=False)

    def _forward_smpl(self, betas, root_orient, pose_body, pose_hand, trans):
        full_pose = torch.cat([root_orient, pose_body, pose_hand], dim=-1)
        (verts, Jtrs_posed, Jtrs, A, _absA, v_posed, v_shaped,
         rot_mats) = smpl_lbs.lbs(
            betas, full_pose, self.v_template, self.shapedirs, self.posedirs,
            self.J_regressor, self.parents, self.lbs_weights)

        eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        rots = torch.cat([eye.reshape(1, 1, 3, 3), rot_mats[:, 1:]], dim=1)
        rots = rots.reshape(1, -1, 9)

        tf_02v = get_02v_bone_transforms_torch(Jtrs[0])
        # inv_ex: no error check, so no device sync on the GPU
        bone_transforms = A[0] @ torch.linalg.inv_ex(tf_02v).inverse
        offset = torch.zeros_like(bone_transforms[0])
        offset[:3, 3] = trans[0]
        bone_transforms = bone_transforms + offset

        v_shaped = v_shaped.detach()
        center = v_shaped.mean(dim=1)
        centered = v_shaped - center
        cano_max = centered.max()
        cano_min = centered.min()
        padding = (cano_max - cano_min) * 0.05
        Jn = Jtrs - center
        Jn = (Jn - cano_min + padding) / (cano_max - cano_min) / 1.1
        Jn = (Jn - 0.5) * 2.0
        return rots, Jn, bone_transforms

    def forward(self, camera, iteration: int):
        idx = camera.pose_idx
        rots, Jtrs, bone_transforms = self._forward_smpl(
            self.betas, self.root_orients[idx][None],
            self.pose_bodys[idx][None], self.pose_hands[idx][None],
            self.trans[idx][None])
        gate = float(iteration >= self.delay) * camera.in_frame_dict
        loss_pose = gate * ((camera.rots - rots) ** 2).mean()

        def blend(new, old):
            return gate * new + (1.0 - gate) * old

        updated = camera.replace(
            rots=blend(rots, camera.rots), Jtrs=blend(Jtrs, camera.Jtrs),
            bone_transforms=blend(bone_transforms, camera.bone_transforms))
        return updated, {'pose': loss_pose}


def get_pose_correction(cfg: dict, metadata: dict, assets):
    name = cfg['name']
    if name == 'none':
        return NoPoseCorrection()
    if name == 'direct':
        return DirectPoseOptimization(
            assets, init_root_orient=metadata['root_orient'],
            init_pose_body=metadata['pose_body'],
            init_pose_hand=metadata['pose_hand'],
            init_trans=metadata['trans'], init_betas=metadata['betas'],
            delay=cfg.get('delay', 0))
    raise ValueError(f"unknown pose correction: {name}")
