"""Pose-conditioned non-rigid deformer: the hash-grid variant.

Counterpart of `gsavatar/models/non_rigid.py:HashGridNonRigid` with its
helpers `_apply_deltas` and `_reg`. Offsets: xyz additive; scale 'logit'
(additive on log-scale); rotation 'mult' (quaternion product with the
delta's w pinned to 1), the hash-grid config's modes. Before `delay` the
deltas are multiplied by a zero gate, which is the identity for both. The
other offset modes and the MLP, pose-encoder and identity variants come
with a later slice."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gsavatar_torch.core.gaussians import Gaussians
from gsavatar_torch.utils import transforms as T
from gsavatar_torch.utils.aabb import AABB
from .hashgrid import HashGrid
from .mlp import cond_mlp_from_cfg
from .pose_encoder import HierarchicalPoseEncoder


def _apply_deltas(gaussians: Gaussians, delta_xyz, delta_scale, delta_rot,
                  scale_offset: str, rot_offset: str, gate: float):
    if (scale_offset, rot_offset) != ('logit', 'mult'):
        raise ValueError(f"offset modes {scale_offset!r}/{rot_offset!r} are "
                         "not part of the render path's configuration "
                         "(logit/mult)")
    p = gaussians.params
    delta_xyz = gate * delta_xyz
    new_xyz = p.xyz + delta_xyz
    delta_scale = gate * delta_scale
    new_scaling = p.scaling + delta_scale
    # gate == 0 gives the identity quaternion [1, 0, 0, 0]
    q1 = torch.cat([torch.ones_like(delta_rot[:, :1]),
                    gate * delta_rot[:, 1:]], dim=1)
    delta_rot = q1[:, 1:]
    new_rotation = T.quat_multiply(q1, p.rotation)

    out = gaussians.replace(params=p.replace(
        xyz=new_xyz, scaling=new_scaling, rotation=new_rotation))
    return out, delta_xyz, delta_scale, delta_rot


def _reg(delta_xyz, delta_scale, delta_rot, alive):
    """Means over alive slots. The L2 norm carries an epsilon so that its
    gradient is defined at exactly-zero deltas."""
    n = torch.clamp_min(alive.sum(), 1.0)
    l2 = torch.sqrt((delta_xyz * delta_xyz).sum(1) + 1e-20)
    return {
        'nr_xyz': (alive * l2).sum() / n,
        'nr_scale': (alive * delta_scale.abs().sum(1)).sum() / n,
        'nr_rot': (alive * delta_rot.abs().sum(1)).sum() / n,
    }


def make_hashgrid(hg: dict, generator=None) -> HashGrid:
    return HashGrid(
        n_levels=hg.get('n_levels', 16),
        n_features_per_level=hg.get('n_features_per_level', 2),
        log2_hashmap_size=hg.get('log2_hashmap_size', 16),
        base_resolution=hg.get('base_resolution', 16),
        max_resolution=hg.get('max_resolution', 2048),
        per_level_scale=hg.get('per_level_scale', 0.0),
        generator=generator)


class HashGridNonRigid(nn.Module):
    def __init__(self, aabb: AABB, mlp_cfg: dict, hashgrid_cfg: dict,
                 latent_dim: int = 0, n_frames: int = 1, feature_dim: int = 0,
                 delay: int = 0, scale_offset: str = 'logit',
                 rot_offset: str = 'mult',
                 pose_encoder_cfg: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aabb = aabb.copy()
        self.latent_dim = latent_dim
        self.feature_dim = feature_dim
        self.delay = delay
        self.scale_offset = scale_offset
        self.rot_offset = rot_offset
        pe = pose_encoder_cfg or {}
        self.pose_encoder = HierarchicalPoseEncoder(
            num_joints=pe.get('num_joints', 24),
            rel_joints=pe.get('rel_joints', False),
            dim_per_joint=pe.get('dim_per_joint', 6),
            out_dim=pe.get('out_dim', -1), generator=generator)
        if latent_dim > 0:
            self.latent = nn.Embedding(n_frames, latent_dim)
            with torch.no_grad():
                nn.init.normal_(self.latent.weight, 0.0, 1.0,
                                generator=generator)
        self.hashgrid = make_hashgrid(hashgrid_cfg, generator)
        self.mlp = cond_mlp_from_cfg(
            self.hashgrid.n_output_dims,
            self.pose_encoder.n_output_dims + latent_dim, 10 + feature_dim,
            mlp_cfg, generator)

    def encode(self, xyz):
        """Hash-grid features of canonical positions (N, 3) -> (N, L*F)."""
        return self.hashgrid(self.aabb.normalize(xyz, sym=True))

    def _pose_feat(self, camera, latent_idx: int):
        feat = self.pose_encoder(camera.rots, camera.Jtrs)     # (1, D)
        if self.latent_dim > 0:
            feat = torch.cat([feat, self.latent.weight[latent_idx][None]],
                             dim=1)
        return feat

    def forward(self, gaussians: Gaussians, camera, iteration: int,
                latent_idx: int, nr_cache=None):
        """`nr_cache` is `encode` of the canonical positions, which are
        frozen outside training: the render path computes it once per
        avatar (converter.compute_nr_cache) and skips the table gathers."""
        pose_feat = self._pose_feat(camera, latent_idx)
        feature = nr_cache if nr_cache is not None \
            else self.encode(gaussians.get_xyz)
        deltas = self.mlp(feature, cond=pose_feat)
        gate = float(iteration >= self.delay)
        out, dx, ds, dr = _apply_deltas(
            gaussians, deltas[:, :3], deltas[:, 3:6], deltas[:, 6:10],
            self.scale_offset, self.rot_offset, gate)
        if self.feature_dim > 0:
            out = out.replace(non_rigid_feature=gate * deltas[:, 10:])
        return out, _reg(dx, ds, dr, gaussians.alive.float())


def get_non_rigid(cfg: dict, metadata: dict, generator=None):
    if cfg['name'] != 'hashgrid':
        raise ValueError(f"non-rigid deformer {cfg['name']!r} is not part "
                         "of the render path's configuration (hashgrid)")
    n_frames = max(len(metadata.get('frame_dict') or {}), 1)
    return HashGridNonRigid(
        aabb=metadata['aabb'], mlp_cfg=dict(cfg['mlp']),
        hashgrid_cfg=dict(cfg['hashgrid']),
        latent_dim=cfg.get('latent_dim', 0), n_frames=n_frames,
        feature_dim=cfg.get('feature_dim', 0), delay=cfg.get('delay', 0),
        scale_offset=cfg['scale_offset'], rot_offset=cfg['rot_offset'],
        pose_encoder_cfg=dict(cfg.get('pose_encoder', {}) or {}),
        generator=generator)
