"""Rigid (forward LBS) deformer: the learned skinning field.

Counterpart of `gsavatar/models/rigid.py:SkinningField` (without the voxel
distillation), `hierarchical_softmax` and `_apply_fwd_transform`: an MLP
R^3 -> 25 logits, a hierarchical softmax over the SMPL tree, per-point
T_fwd = sum_j w_j B_j, which moves xyz, premultiplies the rotation (kept as
`rotation_precomp`) and is kept, detached, for the canonical view
directions. `skinning_loss` is the training-time distillation of the field
toward the SMPL weights. The identity, nearest-SMPL and distilled variants
come with a later slice."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gsavatar_torch.core.gaussians import Gaussians
from gsavatar_torch.utils import transforms as T
from gsavatar_torch.utils.aabb import AABB
from .mlp import VanillaCondMLP

# (child, parent) sigmoid splits after the root's softmax, in order
_SPLITS_LOWER = ((4, 1), (5, 2), (6, 3), (7, 4), (8, 5), (9, 6),
                 (10, 7), (11, 8))
_SPLITS_UPPER = ((16, 13), (17, 14), (18, 16), (19, 17), (20, 18), (21, 19),
                 (22, 20), (23, 21))


def hierarchical_softmax(x):
    """(N, 25) logits -> (N, 24) probabilities walking the SMPL tree: the
    same products of sigmoids and softmaxes along each chain."""
    sig = torch.sigmoid(x)

    def smax(first):
        # three adjacent logits, a slice: its backward is no scatter
        return torch.softmax(x[:, first:first + 3], dim=-1)

    p = {}
    base123 = sig[:, 0:1] * smax(1)
    p[0] = 1.0 - sig[:, 0]
    p[1], p[2], p[3] = base123[:, 0], base123[:, 1], base123[:, 2]
    for child, parent in _SPLITS_LOWER:
        p[child] = p[parent] * sig[:, child]
        p[parent] = p[parent] * (1 - sig[:, child])
    up = p[9] * sig[:, 24]
    s121314 = smax(12)
    p[12], p[13], p[14] = (up * s121314[:, 0], up * s121314[:, 1],
                           up * s121314[:, 2])
    p[9] = p[9] * (1 - sig[:, 24])
    p[15] = p[12] * sig[:, 15]
    p[12] = p[12] * (1 - sig[:, 15])
    for child, parent in _SPLITS_UPPER:
        p[child] = p[parent] * sig[:, child]
        p[parent] = p[parent] * (1 - sig[:, child])
    return torch.stack([p[j] for j in range(24)], dim=1)


def _apply_fwd_transform(gaussians: Gaussians, T_fwd) -> Gaussians:
    x_bar = T.matvec3(T_fwd[:, :3, :3], gaussians.get_xyz) + T_fwd[:, :3, 3]
    rotation_hat = T.quat_to_rotmat(gaussians.params.rotation)
    rotation_bar = T.matmul3(T_fwd[:, :3, :3], rotation_hat)
    return gaussians.replace(
        params=gaussians.params.replace(xyz=x_bar),
        rotation_precomp=rotation_bar, fwd_transform=T_fwd.detach())


class SkinningField(nn.Module):
    def __init__(self, aabb: AABB, d_out: int = 25, soft_blend: float = 20.0,
                 n_neurons: int = 128, n_hidden_layers: int = 4,
                 multires: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aabb = aabb.copy()
        self.soft_blend = soft_blend
        self.lbs_network = VanillaCondMLP(
            dim_in=3, dim_cond=0, dim_out=d_out, n_neurons=n_neurons,
            n_hidden_layers=n_hidden_layers, multires=multires,
            generator=generator)

    def query_weights(self, xyz_norm):
        """(N, 3) normalized coordinates -> (N, 24) skinning weights."""
        logits = self.lbs_network(xyz_norm) * self.soft_blend
        if logits.shape[-1] == 25:
            return hierarchical_softmax(logits)
        return torch.softmax(logits, dim=-1)

    def forward(self, gaussians: Gaussians, camera, iteration) -> Gaussians:
        pts_W = self.query_weights(
            self.aabb.normalize(gaussians.get_xyz, sym=True))
        B = camera.bone_transforms.reshape(-1, 16)
        T_fwd = (pts_W @ B).reshape(-1, 4, 4)
        return _apply_fwd_transform(gaussians, T_fwd)

    def skinning_loss(self, pts_norm, gt_weights):
        """Squared error between the field and the SMPL weights at surface
        samples: summed over joints, averaged over points."""
        pred = self.query_weights(pts_norm)
        return ((pred - gt_weights) ** 2).sum(-1).mean()


def get_rigid(cfg: dict, metadata: dict, generator=None):
    if cfg['name'] != 'skinning_field' or cfg.get('distill', False):
        raise ValueError(f"rigid deformer {cfg['name']!r} (distill="
                         f"{cfg.get('distill', False)}) is not part of the "
                         "render path's configuration (skinning_field)")
    net = cfg['skinning_network']
    return SkinningField(
        aabb=metadata['aabb'], d_out=cfg.get('d_out', 25),
        soft_blend=cfg.get('soft_blend', 20), n_neurons=net['n_neurons'],
        n_hidden_layers=net['n_hidden_layers'],
        multires=net.get('multires', 0), generator=generator)
