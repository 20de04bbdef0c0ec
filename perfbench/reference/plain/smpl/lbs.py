# Frozen copy of gsavatar_torch/smpl/lbs.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""SMPL linear blend skinning on tensors.

Counterpart of `gsavatar/smpl/lbs.py`. The walk over the 24 fixed parents
is a Python loop over the static tree."""
from __future__ import annotations

import torch

from perfbench.reference.plain.utils.transforms import rodrigues


def blend_shapes(betas, shape_disps):
    """betas (B, nb), shape_disps (V, 3, nb) -> (B, V, 3)."""
    return torch.einsum('bl,mkl->bmk', betas, shape_disps)


def vertices_to_joints(J_regressor, vertices):
    """J_regressor (J, V), vertices (B, V, 3) -> (B, J, 3)."""
    return torch.einsum('bik,ji->bjk', vertices, J_regressor)


def _transform_mat(R, t):
    """R (..., 3, 3), t (..., 3, 1) -> (..., 4, 4)."""
    pad_R = torch.cat([R, torch.zeros_like(R[..., :1, :])], dim=-2)
    pad_t = torch.cat([t, torch.ones_like(t[..., :1, :])], dim=-2)
    return torch.cat([pad_R, pad_t], dim=-1)


def batch_rigid_transform(rot_mats, joints, parents):
    """rot_mats (B, J, 3, 3), joints (B, J, 3), parents: ints.
    Returns (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4),
    abs_transforms (B, J, 4, 4))."""
    parents = [int(p) for p in parents]
    # one select per joint: a list index would backpropagate by scatter
    rel_joints = joints - torch.stack(
        [torch.zeros_like(joints[:, 0])] + [joints[:, p] for p in parents[1:]],
        dim=1)
    transforms_mat = _transform_mat(rot_mats, rel_joints[..., None])

    chain = [transforms_mat[:, 0]]
    for i in range(1, len(parents)):
        chain.append(chain[parents[i]] @ transforms_mat[:, i])
    transforms = torch.stack(chain, dim=1)

    posed_joints = transforms[:, :, :3, 3]
    joints_h = torch.cat([joints[..., None],
                          torch.zeros_like(joints[..., :1, None])], dim=-2)
    init_bone = transforms @ joints_h
    init_bone = torch.cat([torch.zeros(transforms.shape[:-1] + (3,),
                                       dtype=transforms.dtype,
                                       device=transforms.device),
                           init_bone], dim=-1)
    return posed_joints, transforms - init_bone, transforms


def lbs(betas, pose, v_template, shapedirs, posedirs, J_regressor, parents,
        lbs_weights):
    """Full SMPL LBS. betas (B, nb); pose (B, J*3) axis-angle; v_template
    (B|1, V, 3); shapedirs (V, 3, nb); posedirs (P, V*3) or None;
    J_regressor (J, V); lbs_weights (V, J).

    Returns (verts, J_posed, J_rest, rel_A, abs_A, v_posed, v_shaped,
    rot_mats) as the JAX `lbs` does."""
    B = betas.shape[0]
    v_shaped = v_template + blend_shapes(betas, shapedirs)
    J = vertices_to_joints(J_regressor, v_shaped)

    rot_mats = rodrigues(pose.reshape(-1, 3)).reshape(B, -1, 3, 3)

    if posedirs is not None:
        ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
        pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)
        v_posed = pose_offsets + v_shaped
    else:
        v_posed = v_shaped

    J_transformed, A, abs_A = batch_rigid_transform(rot_mats, J, parents)

    num_joints = J_regressor.shape[0]
    T = (lbs_weights[None] @ A.reshape(B, num_joints, 16)).reshape(
        B, -1, 4, 4)
    v_posed_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])],
                          dim=-1)
    verts = (T @ v_posed_h[..., None])[:, :, :3, 0]
    return verts, J_transformed, J, A, abs_A, v_posed, v_shaped, rot_mats
