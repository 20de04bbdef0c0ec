# Frozen copy of gsavatar_torch/models/rigid.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Rigid (forward LBS) deformers: canonical space -> posed space.

Counterpart of `gsavatar/models/rigid.py`, selected by `cfg['name']`:
* `identity`: no deformation; it leaves no `fwd_transform` and no
  `rotation_precomp`, so the texture's view directions stay posed and the
  covariance takes the quaternion;
* `smpl_nn`: the skinning weights of the nearest SMPL template vertex
  (`ops/knn.py:nn_index`);
* `skinning_field`: an MLP R^3 -> 25 logits and a hierarchical softmax
  over the SMPL tree; with `distill`, the MLP is evaluated over a
  (res / z_ratio, res, res) grid of [-1, 1]^3 on every call and the
  weights are sampled from that voxel (`ops/interp.py:grid_sample_3d`).
  `skinning_loss` is the training-time distillation of the field toward
  the SMPL weights.
Every deforming variant builds per-point T_fwd = sum_j w_j B_j, which moves
xyz, premultiplies the rotation (kept as `rotation_precomp`) and is kept,
detached, for the canonical view directions. The template vertices, their
skinning weights and the AABB are float buffers: the JAX package keeps them
as 'subject' constants, whose gradients (the skinning weights get one
through the nearest-vertex gather) count in the converter optimizer's clip
norm."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from perfbench.reference.plain.core.gaussians import Gaussians
from perfbench.reference.plain.ops import knn
from perfbench.reference.plain.ops.interp import grid_sample_3d
from perfbench.reference.plain.utils import transforms as T
from perfbench.reference.plain.utils.aabb import AABB
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


def _lbs(gaussians: Gaussians, camera, pts_W) -> Gaussians:
    B = camera.bone_transforms.reshape(-1, 16)
    T_fwd = (pts_W @ B).reshape(-1, 4, 4)
    return _apply_fwd_transform(gaussians, T_fwd)


class IdentityRigid(nn.Module):
    def forward(self, gaussians: Gaussians, camera, iteration) -> Gaussians:
        return gaussians


class SMPLNN(nn.Module):
    """Skinning weights copied from the nearest template vertex."""

    def __init__(self, smpl_verts, skinning_weights):
        super().__init__()
        for name, value in (('smpl_verts', smpl_verts),
                            ('skinning_weights', skinning_weights)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(value, np.float32)), persistent=False)

    def forward(self, gaussians: Gaussians, camera, iteration) -> Gaussians:
        idx = knn.nn_index(gaussians.get_xyz, self.smpl_verts)
        return _lbs(gaussians, camera, self.skinning_weights[idx.long()])


class SkinningField(nn.Module):
    def __init__(self, aabb: AABB, d_out: int = 25, soft_blend: float = 20.0,
                 distill: bool = False, res: int = 64, z_ratio: int = 4,
                 n_neurons: int = 128, n_hidden_layers: int = 4,
                 multires: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aabb = aabb.copy()
        self.soft_blend = soft_blend
        self.distill = distill
        self.res = res
        self.z_ratio = z_ratio
        self.lbs_network = VanillaCondMLP(
            dim_in=3, dim_cond=0, dim_out=d_out, n_neurons=n_neurons,
            n_hidden_layers=n_hidden_layers, multires=multires,
            generator=generator)

    def _softmax(self, logits):
        if logits.shape[-1] == 25:
            return hierarchical_softmax(logits)
        return torch.softmax(logits, dim=-1)

    def _voxel(self):
        """The field over the (res / z_ratio, res, res) grid of [-1, 1]^3:
        (24, d, h, w) weights, rebuilt on every call (it follows the
        MLP's weights)."""
        d, h, w = self.res // self.z_ratio, self.res, self.res
        dev = self.aabb.coord_max.device
        axes = [torch.linspace(-1, 1, n, device=dev) for n in (d, h, w)]
        Z, Y, X = torch.meshgrid(*axes, indexing='ij')
        grid = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)
        wts = self._softmax(self.lbs_network(grid) * self.soft_blend)
        return wts.T.reshape(-1, d, h, w)

    def _voxel_key(self):
        """What the voxel depends on: the grad mode and the MLP's
        parameters, each by identity and in-place version (an optimizer
        step or a load bumps the version)."""
        return (torch.is_grad_enabled(),) + tuple(
            (id(p), p._version) for p in self.lbs_network.parameters())

    def query_weights(self, xyz_norm, voxel=None):
        """(N, 3) normalized coordinates -> (N, 24) skinning weights; the
        distilled field samples `voxel`, by default a fresh one."""
        if self.distill:
            return grid_sample_3d(self._voxel() if voxel is None else voxel,
                                  xyz_norm)
        return self._softmax(self.lbs_network(xyz_norm) * self.soft_blend)

    def forward(self, gaussians: Gaussians, camera, iteration) -> Gaussians:
        voxel = None
        if self.distill:
            # built once per step: the step's skinning loss samples the
            # same voxel (as XLA merges the JAX package's two identical
            # builds), so autograd keeps one voxel graph, not two
            voxel = self._voxel()
            self._kept_voxel = (self._voxel_key(), voxel)
        return _lbs(gaussians, camera, self.query_weights(
            self.aabb.normalize(gaussians.get_xyz, sym=True), voxel))

    def skinning_loss(self, pts_norm, gt_weights):
        """Squared error between the field and the SMPL weights at surface
        samples: summed over joints, averaged over points. The distilled
        field samples the voxel of the last forward when the MLP has not
        changed since, and a fresh one otherwise."""
        voxel = None
        kept = getattr(self, '_kept_voxel', None)
        if kept is not None and kept[0] == self._voxel_key():
            voxel = kept[1]
        pred = self.query_weights(pts_norm, voxel)
        return ((pred - gt_weights) ** 2).sum(-1).mean()


def get_rigid(cfg: dict, metadata: dict, generator=None):
    name = cfg['name']
    if name == 'identity':
        return IdentityRigid()
    if name == 'smpl_nn':
        return SMPLNN(metadata['smpl_verts'], metadata['skinning_weights'])
    if name == 'skinning_field':
        net = cfg['skinning_network']
        return SkinningField(
            aabb=metadata['aabb'], d_out=cfg.get('d_out', 25),
            soft_blend=cfg.get('soft_blend', 20),
            distill=cfg.get('distill', False), res=cfg.get('res', 64),
            z_ratio=cfg.get('z_ratio', 4), n_neurons=net['n_neurons'],
            n_hidden_layers=net['n_hidden_layers'],
            multires=net.get('multires', 0), generator=generator)
    raise ValueError(f"unknown rigid deformer: {name}")
